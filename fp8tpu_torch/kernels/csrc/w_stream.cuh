// The weight-streaming GEMMs K3 (dequant_matmul.cu), K5 (int4_matmul.cu),
// T2 (fp8_linear_study.cu) and P1 (w8a8.cu), at decode (M <= 64) and, for
// K3, K5 and P1, at prefill (M > 64):
//   out[M, N] = x[M, K] bf16 @ convert(W[K, N]) (* a scale per column)
// with W in device memory as fp8 / int8 bytes, packed int4 or bf16; for P1
// x is e4m3 codes and W e4m3 / e5m2 bytes, multiplied on the fp8 tensor
// cores without a convert (the FP8 kind, below).
//
// What bounds it on an H100: at decode the bytes of W, each read once (45
// MB for an e4m3 4096 x 11008 projection: 13.5 us at 3.35 TB/s); the
// products are a few GFLOP.  So the loop has to keep the memory system
// busy and do as little else per weight byte as it can.  At prefill the
// bf16 tensor-core rate (2 M N K / 989 TFLOP/s: 46.7 us for that
// projection at M = 512).  The design:
//
// * The operands are swapped: out^T = W^T x^T.  The converted weight is
//   wgmma's A operand, in registers (m64: 64 output columns a tile), and
//   x^T its B operand, read from shared memory as it lies (x's rows are
//   contiguous along K, wgmma's K-major B) with n = M rounded up to 8,
//   16, 32 or 64 (decode) or 128 tokens of a token tile (prefill).  Every
//   weight element is converted once a block, by one thread, straight
//   from the raw stage into A fragments: no second pass through shared
//   memory, no block-wide barrier.
// * Decode: a block is one consumer warpgroup (MT m64 tiles: 64 MT output
//   columns) and one producer warp, two blocks an SM.  The producer keeps
//   a ring of stages in flight with TMA (cp.async.bulk.tensor over
//   CUtensorMaps of the (K, N) payload, of x and, for grouped int4, of the
//   scales); each stage completes on an mbarrier and the consumers release
//   it with an arrive.  The ring has as many stages of 128 K rows (bf16:
//   64) as two blocks an SM leave room for, 3-8, so 32-192 KB of payload
//   is in flight on an SM, at least Little's law's 32 KB (25 B/ns an SM
//   times ~1.3 us).
// * Prefill (the prefill route, launch_prefill): a block is 128 output
//   columns x 128 tokens, two consumer warpgroups on 64 columns each
//   (MT = 1) sharing the stage's x tile, and the producer warp; one block
//   an SM, four stages of 48 KB (int4: five).  The tile is set by the
//   registers: promotion keeps a second f32 sum the size of the
//   accumulator, and m64 x n128 is 64 + 64 registers a thread; n256 (or
//   MT = 2 at n128) would need 256 and does not fit in 255.  Two
//   warpgroups on other columns read one x tile, so a stage of 128 K rows
//   moves 16 KB of payload and 32 KB of x for 2 M MACs.  The launch order
//   walks the token tiles fastest, so the blocks that read one column
//   tile's payload run together and it comes from device memory once, and
//   x (4 MB at M = 512) stays in the 50 MB L2.
// * A thread owns 2 MT adjacent output columns (A rows g and g + 8 of
//   m64 tile t are its columns 2t and 2t + 1), so it reads its payload
//   bytes of a K row as one 2- or 4-byte word (bf16: 4 or 8) from a
//   swizzled stage, conflict-free; the epilogue writes each accumulator
//   row to its true column.  Decode: MT = 2 where N has enough 128-column
//   tiles to fill the card, else 1 (N = 1024: 16 tiles of 64).
// * The tensor cores accumulate at most PROMOTE = 512 K rows (the JAX
//   kernel's tk tile); each chunk is then added into an f32 register sum
//   with ordinary adds, since the tensor cores' own f32 accumulation
//   truncates (PERF.md, trap 27).  The products are the exact bf16 x bf16
//   products of x @ convert(W); only the order of the sums differs.
// * Split-K over gridDim.z, deterministic (split_k.cuh): partials are
//   added in split order by the tile's last block.  At prefill only
//   outputs of fewer tiles than SMs split (qmatmul.py::prefill_plan: k/v
//   at M = 512 is 32 tiles, 4 splits).  The kernel allocates nothing and
//   never synchronises the host, so it can be captured in a CUDA graph.
//
// * FP8 (P1): wgmma.m64nNk32 with the weight bytes as the register A
//   operand and x's e4m3 bytes as the K-major B (a 128-byte TMA row is one
//   stage's 128 K rows, so a stage's x is BK NP bytes).  The PTX ISA has no
//   transpose for 8-bit shared-memory operands and the artifact holds W with
//   N contiguous, so the weight can only be A: ldmatrix.trans gathers a
//   thread's two columns of four K rows and two byte permutes a register
//   make the fragment (fp8_loads, fp8_frags).  The fp8 tensor cores keep
//   13 bits below a k32 step's largest addend and drop the rest toward
//   zero (chip_smoke.py's w8a8_probe; DeepSeek-V3 §3.3.2 reports about
//   14), so the chunk promoted into the f32 sum is the wrapper's
//   (qmatmul.py::W8A8_PROMOTE): whole stages at runtime, or SUB k32 steps
//   inside a stage for the probe.
//
// * F16 (K3's int8 route, W8A8): x is the e4m3 activation codes' exact f16
//   values (P2 writes them), read by TMA in bf16's 2-byte boxes, and the
//   int8 weight bytes become f16 A fragments by a magic number:
//   0x6400 | (v ^ 0x80) is the f16 of 1024 + (v + 128), exact in f16's 11
//   significant bits, and one f16x2 subtract of 1152 leaves v (one prmt,
//   one lop3 and one subtract a register of two: int8_f16).  The
//   MMA is wgmma .f32.f16.f16 at the bf16 rate; every code and byte is
//   exact in f16 and every product exact in f32, so the sums are f32-grade
//   as bf16's.
//
// A payload policy P gives KIND (BYTE8, NIB4, HALF16 or FP8), GROUPED (int4
// scales per K group, multiplied into the weights in bf16), F16 (true:
// f16 x and int8 bytes to f16 fragments, K3's int8 route; false: bf16 x
// or fp8 codes), for BYTE8 with F16 false cvt2(two bytes of one column at
// K rows k, k + 1) -> one bf16x2 register, and for FP8 E5M2 (the
// weight's format) and SUB.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"
#include "split_k.cuh"

namespace ws {

enum Kind { BYTE8 = 0, NIB4 = 1, HALF16 = 2, FP8 = 3 };

constexpr int WARPGROUP = 128;       // threads of a consumer warpgroup
constexpr int PROMOTE = 512;         // K rows the tensor cores sum alone
constexpr int PREFILL_NP = 128;      // tokens a block of the prefill route
constexpr int PREFILL_ROUTE = 3;     // the entry points' code for it
constexpr int MAX_SPLITS = 8;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;

// Shapes of one stage of payload policy P in a block of WGS consumer
// warpgroups of MT m64 tiles each (64 MT WGS output columns) at n = NP.
template <class P, int MT, int NP, int WGS>
struct Shape {
    static constexpr int BK = P::KIND == HALF16 ? 64 : 128;  // K rows
    static constexpr int KSTEP = P::KIND == FP8 ? 32 : 16;  // K rows a wgmma
    static constexpr int KSTEPS = BK / KSTEP;
    static constexpr int ROWS = P::KIND == NIB4 ? BK / 2 : BK;
    static constexpr int COLS = 64 * MT * WGS;           // a block's
    // the stage's payload: BOXES TMA boxes of RB-byte rows
    static constexpr int RB = P::KIND == HALF16 ? 128 : COLS;
    static constexpr int BOXES = P::KIND == HALF16 ? COLS / 64 : 1;
    static_assert(RB <= 128, "a payload row spans at most one swizzle");
    static constexpr int W_BYTES = BOXES * ROWS * RB;
    // x's boxes of 128-byte rows: BK / 64 of bf16, one of e4m3
    static constexpr int X_BOX_K = P::KIND == FP8 ? 128 : 64;
    static constexpr int X_BOXES = BK / X_BOX_K;
    static constexpr int X_BYTES = X_BOXES * NP * 128;
    static constexpr int S_BYTES = P::GROUPED ? (BK / 16) * COLS * 4 : 0;
    static constexpr int STAGE = W_BYTES + X_BYTES + S_BYTES;
    static_assert(STAGE % 1024 == 0, "stages keep the 1024-byte alignment");
    static constexpr int CONSUMERS = WARPGROUP * WGS;
    static constexpr int THREADS = CONSUMERS + 32;
    static constexpr int BLOCKS = WGS == 1 ? 2 : 1;      // an SM
    static constexpr int BUDGET = SMEM_LIMIT / BLOCKS - 4096;
    static constexpr int STAGES =
        BUDGET / STAGE > MAX_STAGES ? MAX_STAGES : BUDGET / STAGE;
    static_assert(STAGES >= 2, "at least two stages");
    static constexpr int SMEM = STAGES * STAGE + 1024 + 16 * STAGES;
    // a thread loads a whole stage's raw words at once (load_stage) except
    // at MT = 2, NP = 64: 32 more registers beside 128 of f32 sums, two
    // blocks an SM
    static constexpr bool STAGE_LOADS = MT == 1 || NP <= 32;
};

struct Args {
    const float* col_scale;  // (N,) f32, or null: no scale
    const float* row_scale;  // (M,) f32, or null: no scale (W8A8: K3, P1)
    void* out;               // (M, N) bf16 or f32
    float* ws;               // (splits, M, N) partials, splits > 1 only
    int* counters;           // one per output tile, zero between launches
    int m, n, k;
    int mtiles;              // token tiles (of NP rows)
    int splits, kper;        // K rows a split, a whole number of stages
    int group;               // grouped scales: K rows a group, else 0
    int scale_rows;          // scale rows a stage (grouped)
    int out_f32;
    int chunk;               // stages a promoted chunk (FP8 only)
};

// -- device helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// Until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// One TMA tile (box) of a 2-d tensor map into shared memory; completes
// ``bar``'s transaction bytes.  c0 is the inner (contiguous) coordinate.
__device__ __forceinline__ void tma2d(uint32_t dst, const CUtensorMap* map,
                                      int c0, int c1, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" :: : "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" :: : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Orders the compiler's use of registers that wgmma reads or writes
// asynchronously against the fences and waits above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// A K-major B operand in a 128-byte-swizzled tile (TMA's SWIZZLE_128B):
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32)
           | (1ull << 62);
}

// The operand lists of wgmma with A in registers, by N (the accumulator's
// N / 2 registers, then A's four, the B descriptor and scale_d).
#define WS_D4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define WS_D8 WS_D4, "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define WS_D16 WS_D8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WS_D32 WS_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31])
#define WS_D64 WS_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
    "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
    "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
    "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WS_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), \
    "r"(scale_d)
#define WS_RS(OP, TAIL, P, DREGS, REST, DOPS) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n" \
                 "wgmma.mma_async.sync.aligned." OP " " DREGS ", " REST \
                 ", p, " TAIL ";\n}\n" : DOPS : WS_IN)
#define WS_RS8(OP, TAIL) WS_RS(OP, TAIL, "%9", "{%0, %1, %2, %3}", \
    "{%4, %5, %6, %7}, %8", WS_D4)
#define WS_RS16(OP, TAIL) WS_RS(OP, TAIL, "%13", \
    "{%0, %1, %2, %3, %4, %5, %6, %7}", "{%8, %9, %10, %11}, %12", WS_D8)
#define WS_RS32(OP, TAIL) WS_RS(OP, TAIL, "%21", \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
    "%15}", "{%16, %17, %18, %19}, %20", WS_D16)
#define WS_RS64(OP, TAIL) WS_RS(OP, TAIL, "%37", \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
    "%28, %29, %30, %31}", "{%32, %33, %34, %35}, %36", WS_D32)
#define WS_RS128(OP, TAIL) WS_RS(OP, TAIL, "%69", \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
    "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
    "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}", \
    "{%64, %65, %66, %67}, %68", WS_D64)
// bf16 (T = 0) and f16 (T = 3): m64nNk16, A 64 x 16; fp8 (T = 1: e4m3,
// 2: e5m2 weights): m64nNk32, A 64 x 32 bytes, B always e4m3 (the PTX ISA
// takes no transpose arguments for 8-bit types).
#define WS_RS_T(MAC, NS) \
    if constexpr (T == 0) MAC("m64n" NS "k16.f32.bf16.bf16", "1, 1, 0"); \
    else if constexpr (T == 3) MAC("m64n" NS "k16.f32.f16.f16", "1, 1, 0"); \
    else if constexpr (T == 1) MAC("m64n" NS "k32.f32.e4m3.e4m3", "1, 1"); \
    else MAC("m64n" NS "k32.f32.e5m2.e4m3", "1, 1");

// D (64 x N, f32) (+)= A (64 x K, registers) * B (K x N, shared memory);
// scale_d = 0 starts a new sum.
template <int N, int T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
    if constexpr (N == 8) { WS_RS_T(WS_RS8, "8") }
    else if constexpr (N == 16) { WS_RS_T(WS_RS16, "16") }
    else if constexpr (N == 32) { WS_RS_T(WS_RS32, "32") }
    else if constexpr (N == 64) { WS_RS_T(WS_RS64, "64") }
    else { static_assert(N == 128, "n = 8, 16, 32, 64 or 128");
           WS_RS_T(WS_RS128, "128") }
}

// The wgmma type of policy P (WS_RS_T's T).
template <class P>
__host__ __device__ constexpr int mma_type() {
    if constexpr (P::KIND == FP8) return P::E5M2 ? 2 : 1;
    else if constexpr (P::F16) return 3;
    else return 0;
}

// k32 steps a tensor-core chunk inside a stage: an FP8 policy's SUB, else
// the stage's KSTEPS (chunks of whole stages).
template <class P, int KSTEPS>
__host__ __device__ constexpr int sub_steps() {
    if constexpr (P::KIND == FP8) return P::SUB;
    else return KSTEPS;
}

// -- converts ----------------------------------------------------------------

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
    return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t sub_f16x2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// int8 to f16: byte v flipped by 0x80 (v + 128), under 0x64 in the high
// byte of its half, is the f16 of 1024 + (v + 128); the subtract of
// I8F16_BIAS (1152 in both halves) is exact and leaves v.
constexpr uint32_t I8F16_BIAS = 0x64806480u;

// The int8 bytes that selector ``sel`` picks from (x, y) into bytes 0 and
// 2 (bytes 1 and 3 are dropped) as an f16x2 register: one prmt, one lop3
// (the mask, the flip and the 0x64 at once), one subtract.  (Flipping a
// whole word first and taking 0x64 from a second prmt operand is fewer
// instructions, and slower at the prefill route: PERF.md §6.)
__device__ __forceinline__ uint32_t int8_f16(uint32_t x, uint32_t y,
                                             uint32_t sel) {
    return sub_f16x2((__byte_perm(x, y, sel) & 0x00FF00FFu) ^ 0x64806480u,
                     I8F16_BIAS);
}

// Two signed nibbles, in bits 0-3 (low half) and 16-19 (high half) of x, to
// their exact bf16 values by bit operations: 0x4300 | (u ^ 8) is the bf16
// of 128 + (u ^ 8), and subtracting 136 (one fma, exact) leaves the signed
// value of u.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t x) {
    return fma_bf16x2((x & 0x000F000Fu) ^ 0x43084308u, 0x3F803F80u,
                      0xC308C308u);
}

// The scale: a nibble times a bf16 scale is exact in f32 (4 by 8
// significant bits), so one fma with -0 (the product rounded once to bf16,
// the sign of a zero product kept) gives the bits of the plain version's
// bf16 multiply, subnormal scales included.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, uint32_t s2) {
    return fma_bf16x2(w, s2, 0x80008000u);
}

// Byte offset of byte c of row r of a TMA box whose rows are RB bytes and
// whose swizzle spans RB bytes (128: SWIZZLE_128B, 64: SWIZZLE_64B): the
// 16-byte piece index is XORed with address bits 7 and up.
template <int RB>
__device__ __forceinline__ int swz(int r, int c) {
    const int off = r * RB + c;
    return off ^ (((off >> 7) & (RB / 16 - 1)) << 4);
}


template <int MT>
__device__ __forceinline__ uint32_t load_cols(const unsigned char* p) {
    // the 2 MT payload bytes of a thread's columns in one row
    if constexpr (MT == 2) return *reinterpret_cast<const uint32_t*>(p);
    else return *reinterpret_cast<const uint16_t*>(p);
}

// A thread's raw payload words of one k16 step, loaded from the stage,
// then converted into its A fragments.  Bytes at MT = 1: two words, rows
// (2q, 2q + 1) and (2q + 8, 2q + 9), each (row k col c, row k col c + 1,
// row k + 1 col c, row k + 1 col c + 1), as ldmatrix.trans gives them.
// fp8 at any MT: four ldmatrix.trans words a tile (fp8_loads).
template <class P, int MT>
struct Raw {
    static constexpr int N =
        P::KIND == BYTE8 ? (MT == 1 ? 2 : 4) : P::KIND == NIB4 ? 2 : 4 * MT;
    uint32_t w[N];
};

// fp8: the stage's K row that lane ``lane`` addresses for ldmatrix.trans.
// ldmatrix.trans (b16 elements: columns c, c + 1 of one K row) gives thread
// (g, q) rows 2q and 2q + 1 of each matrix at columns 2g, 2g + 1.  Matrix
// i of the four holds, as those rows, K rows 16 (i >> 1) + 4q + 2h + (0,
// 1) with h = (i & 1) ^ (q >> 1): with the matrices i and i ^ 1 a thread
// has all four of its K rows 4q .. 4q + 3, and each matrix's eight rows
// are eight distinct rows mod 8, which the 64- and 128-byte swizzles put
// on distinct banks.  (h = i & 1 alone would put rows 0 and 8 of matrix 0
// on one bank.)
__device__ __forceinline__ int fp8_lane_row(int lane) {
    const int i = lane >> 3, r = lane & 7;
    return 16 * (i >> 1) + 4 * (r >> 1) + 2 * ((i & 1) ^ (r >> 2)) + (r & 1);
}

// fp8: k32 step ks's raw words of the thread's MT tiles; tile t is the
// 16 columns at byte 16 MT w + 16 t of the stage's rows.
template <int MT, class S>
__device__ __forceinline__ void fp8_loads(const unsigned char* stage, int ks,
                                          int w, int lane,
                                          uint32_t (&raw)[4 * MT]) {
    const int row = 32 * ks + fp8_lane_row(lane);
#pragma unroll
    for (int t = 0; t < MT; ++t) {
        uint32_t v[4];
        frag::ldsm4_trans(v, stage + swz<S::RB>(row, 16 * MT * w + 16 * t));
#pragma unroll
        for (int i = 0; i < 4; ++i) raw[4 * t + i] = v[i];
    }
}

// fp8: A fragments from fp8_loads' words.  Register 0 (1) of the
// .m64nNk32 8-bit A layout holds K rows 4q .. 4q + 3 of A row g (g + 8),
// the thread's column 2g (2g + 1) of the tile; registers 2 and 3 the same
// 16 K rows on.  A word holds (row k col c, row k col c + 1, row k + 1
// col c, row k + 1 col c + 1) of its two K rows, and of words 0 and 1
// (2 and 3) one holds rows 4q, 4q + 1, the other 4q + 2, 4q + 3, so one
// permute of the pair gives a register: ``lo`` / ``hi`` select columns
// c / c + 1 (0x6420 / 0x7531 where word 0 holds rows 4q, 4q + 1, else
// 0x2064 / 0x3175; no sign mode is needed, trap 37).
template <int MT>
__device__ __forceinline__ void fp8_frags(const uint32_t (&raw)[4 * MT],
                                          uint32_t lo, uint32_t hi,
                                          uint32_t (&a)[MT][4]) {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
        a[t][0] = __byte_perm(raw[4 * t], raw[4 * t + 1], lo);
        a[t][1] = __byte_perm(raw[4 * t], raw[4 * t + 1], hi);
        a[t][2] = __byte_perm(raw[4 * t + 2], raw[4 * t + 3], lo);
        a[t][3] = __byte_perm(raw[4 * t + 2], raw[4 * t + 3], hi);
    }
}

// Thread (warp w, lane g * 4 + q) owns the block's columns
// c = 16 MT w + 2 MT g .. c + 2 MT - 1 and reads K rows 16 ks + 2q,
// +1, +8, +9 (packed rows 8 ks + q and +4 for int4).  fp8: columns
// 16 MT w + 16 t + 2g, + 1 of tile t, K rows 32 ks + 4q .. + 3 and
// + 16 .. + 19.
template <class P, int MT, class S>
__device__ __forceinline__ void load_step(const unsigned char* stage, int ks,
                                          int w, int g, int q,
                                          Raw<P, MT>& raw) {
    const int c = 16 * MT * w + 2 * MT * g;
    if constexpr (P::KIND == FP8) {
        fp8_loads<MT, S>(stage, ks, w, 4 * g + q, raw.w);
    } else if constexpr (P::KIND == BYTE8) {
        static_assert(MT == 2, "bytes at MT = 1 come through ldmatrix");
        const int r = 16 * ks + 2 * q;
        raw.w[0] = load_cols<MT>(stage + swz<S::RB>(r, c));
        raw.w[1] = load_cols<MT>(stage + swz<S::RB>(r + 1, c));
        raw.w[2] = load_cols<MT>(stage + swz<S::RB>(r + 8, c));
        raw.w[3] = load_cols<MT>(stage + swz<S::RB>(r + 9, c));
    } else if constexpr (P::KIND == NIB4) {
        const int r = 8 * ks + q;
        raw.w[0] = load_cols<MT>(stage + swz<S::RB>(r, c));
        raw.w[1] = load_cols<MT>(stage + swz<S::RB>(r + 4, c));
    } else {
        // bf16: 4 MT bytes a row, in box c / 64 of 128-byte rows
        const int r = 16 * ks + 2 * q;
        const unsigned char* box = stage + (c >> 6) * (S::ROWS * 128);
        const int cb = (c & 63) * 2;
        const int rows[4] = {r, r + 1, r + 8, r + 9};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const unsigned char* p = box + swz<128>(rows[i], cb);
            if constexpr (MT == 2) {
                const uint2 u = *reinterpret_cast<const uint2*>(p);
                raw.w[2 * i] = u.x;
                raw.w[2 * i + 1] = u.y;
            } else {
                raw.w[i] = *reinterpret_cast<const uint32_t*>(p);
            }
        }
    }
}

// A thread's raw words of a whole stage, loaded once the stage has landed,
// so that no load waits inside the chain of converts and wgmmas (where
// S::STAGE_LOADS; else the loop loads them a step at a time).
// Bytes at MT = 1 come through ldmatrix.trans: lane l names row 16 ks + l
// of the warp's 16-byte column chunk, and matrix i of the four holds rows
// (2q, 2q + 1) (i = 0) or (2q + 8, 2q + 9) (i = 1) of step ks, then of
// step ks + 1, at the thread's columns 2g, 2g + 1: one instruction for
// what takes eight 2-byte loads.  Packed int4 at MT = 1 likewise, one
// matrix a step: its rows are the step's packed rows 0, 4, 1, 5, 2, 6,
// 3, 7, so that matrix rows 2q and 2q + 1 are the packed rows q and
// q + 4 the thread converts: one instruction for eight 2-byte loads.
template <class P, int MT, class S>
__device__ __forceinline__ void load_stage(const unsigned char* stage,
                                           int w, int g, int q, int lane,
                                           Raw<P, MT> (&raw)[S::KSTEPS]) {
    if constexpr (P::KIND == FP8) {
#pragma unroll
        for (int ks = 0; ks < S::KSTEPS; ++ks)
            fp8_loads<MT, S>(stage, ks, w, lane, raw[ks].w);
    } else if constexpr (P::KIND == BYTE8 && MT == 1) {
#pragma unroll
        for (int ks = 0; ks < S::KSTEPS; ks += 2) {
            uint32_t v[4];
            frag::ldsm4_trans(v, stage + swz<S::RB>(16 * ks + lane, 16 * w));
            raw[ks].w[0] = v[0];
            raw[ks].w[1] = v[1];
            raw[ks + 1].w[0] = v[2];
            raw[ks + 1].w[1] = v[3];
        }
    } else if constexpr (P::KIND == NIB4 && MT == 1) {
        const int i = lane & 7;
#pragma unroll
        for (int ks = 0; ks < S::KSTEPS; ks += 4) {
            uint32_t v[4];
            const int row = 8 * (ks + (lane >> 3)) + (i >> 1) + 4 * (i & 1);
            frag::ldsm4_trans(v, stage + swz<S::RB>(row, 16 * w));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                raw[ks + j].w[0] = v[j] & 0xFFFFu;
                raw[ks + j].w[1] = v[j] >> 16;
            }
        }
    } else {
#pragma unroll
        for (int ks = 0; ks < S::KSTEPS; ++ks)
            load_step<P, MT, S>(stage, ks, w, g, q, raw[ks]);
    }
}

// The A fragments a[t] of m64 tile t from one step's raw words: the
// fragment's rows g and g + 8 of tile t are the thread's columns 2t and
// 2t + 1; registers 0 and 1 hold K rows (2q, 2q + 1), 2 and 3 rows
// (2q + 8, 2q + 9).  sc: bf16x2 scale pairs of the thread's columns
// (grouped int4).
template <class P, int MT>
__device__ __forceinline__ void convert_step(const Raw<P, MT>& raw,
                                             const uint32_t (&sc)[2 * MT],
                                             uint32_t (&a)[MT][4]) {
    if constexpr (P::F16 && MT == 1) {
        // int8 to f16: a word holds (row k col c, row k col c + 1, row
        // k + 1 col c, row k + 1 col c + 1); bytes 0, 2 are column c's pair
        a[0][0] = int8_f16(raw.w[0], 0u, 0x3230u);
        a[0][1] = int8_f16(raw.w[0], 0u, 0x3331u);
        a[0][2] = int8_f16(raw.w[1], 0u, 0x3230u);
        a[0][3] = int8_f16(raw.w[1], 0u, 0x3331u);
    } else if constexpr (P::F16) {
        // int8 to f16 at MT = 2: words of one K row's four columns; the
        // pair of column j is byte j of rows k and k + 1
#pragma unroll
        for (int t = 0; t < MT; ++t) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t j = 2 * t + h;
                const uint32_t sel = j | (j << 4) | ((4 + j) << 8)
                                     | ((4 + j) << 12);
                a[t][h] = int8_f16(raw.w[0], raw.w[1], sel);
                a[t][2 + h] = int8_f16(raw.w[2], raw.w[3], sel);
            }
        }
    } else if constexpr (P::KIND == BYTE8 && MT == 1) {
        // (row k, row k + 1) pairs of columns c and c + 1
        const uint32_t lo = __byte_perm(raw.w[0], 0, 0x3120);
        const uint32_t hi = __byte_perm(raw.w[1], 0, 0x3120);
        a[0][0] = P::cvt2(lo & 0xFFFFu);
        a[0][1] = P::cvt2(lo >> 16);
        a[0][2] = P::cvt2(hi & 0xFFFFu);
        a[0][3] = P::cvt2(hi >> 16);
    } else if constexpr (P::KIND == BYTE8) {
#pragma unroll
        for (int t = 0; t < MT; ++t) {
            // (row k byte, row k + 1 byte) pairs of columns 2t and 2t + 1
            const uint32_t sel = t == 0 ? 0x5140u : 0x7362u;
            const uint32_t lo = __byte_perm(raw.w[0], raw.w[1], sel);
            const uint32_t hi = __byte_perm(raw.w[2], raw.w[3], sel);
            a[t][0] = P::cvt2(lo & 0xFFFFu);
            a[t][1] = P::cvt2(lo >> 16);
            a[t][2] = P::cvt2(hi & 0xFFFFu);
            a[t][3] = P::cvt2(hi >> 16);
        }
    } else if constexpr (P::KIND == NIB4) {
        const uint32_t p0 = raw.w[0], p4 = raw.w[1];
        const uint32_t p0h = p0 >> 4, p4h = p4 >> 4;
#pragma unroll
        for (int i = 0; i < 2 * MT; ++i) {
            // byte i's low nibble to bits 0-3, its high nibble to 16-19
            const uint32_t sel = i | (i << 4) | ((4 + i) << 8)
                                 | ((4 + i) << 12);
            uint32_t v0 = nibbles_bf16x2(__byte_perm(p0, p0h, sel));
            uint32_t v4 = nibbles_bf16x2(__byte_perm(p4, p4h, sel));
            if constexpr (P::GROUPED) {
                v0 = scale_bf16x2(v0, sc[i]);
                v4 = scale_bf16x2(v4, sc[i]);
            }
            a[i >> 1][i & 1] = v0;
            a[i >> 1][2 + (i & 1)] = v4;
        }
    } else {
#pragma unroll
        for (int t = 0; t < MT; ++t) {
            const uint32_t r0 = raw.w[t], r1 = raw.w[MT + t];
            const uint32_t r8 = raw.w[2 * MT + t], r9 = raw.w[3 * MT + t];
            a[t][0] = __byte_perm(r0, r1, 0x5410);
            a[t][1] = __byte_perm(r0, r1, 0x7632);
            a[t][2] = __byte_perm(r8, r9, 0x5410);
            a[t][3] = __byte_perm(r8, r9, 0x7632);
        }
    }
}
// -- the kernel --------------------------------------------------------------

// Block (blockIdx.x, blockIdx.z): token tile x % mtiles (tokens NP of
// them), column tile x / mtiles (COLS columns), over split z's K rows;
// the token tiles of one column tile are neighbours in launch order.
// Warps 0 .. 4 WGS - 1 consume, the last warp produces.
template <class P, int MT, int NP, int WGS>
__global__ void __launch_bounds__(Shape<P, MT, NP, WGS>::THREADS,
                                  Shape<P, MT, NP, WGS>::BLOCKS)
stream_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap ts, const Args A) {
    using S = Shape<P, MT, NP, WGS>;
    constexpr int ST = S::STAGES, CHUNK = PROMOTE / S::BK;
    extern __shared__ unsigned char smem_raw[];
    __shared__ int is_last;
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t full = smem_u32(smem + ST * S::STAGE);   // ST barriers
    const uint32_t empty = full + 8 * ST;                     // ST barriers

    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int m0 = (blockIdx.x % A.mtiles) * NP;
    const int n0 = (blockIdx.x / A.mtiles) * S::COLS;
    const int kbeg = blockIdx.z * A.kper;
    const int kend = min(A.k, kbeg + A.kper);
    const int nst = (kend - kbeg + S::BK - 1) / S::BK;

    if (t == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, S::CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == S::CONSUMERS / 32) {
        // the producer: one thread keeps the ring full
        if (lane == 0) {
            const int tx_bytes = S::W_BYTES + S::X_BYTES
                + (P::GROUPED ? A.scale_rows * S::COLS * 4 : 0);
            for (int st = 0; st < nst; ++st) {
                const int s = st % ST;
                if (st >= ST) mbar_wait(empty + 8 * s, (st / ST - 1) & 1);
                const uint32_t bar = full + 8 * s;
                const uint32_t dst = smem_u32(smem + s * S::STAGE);
                const int k0 = kbeg + st * S::BK;
                mbar_expect_tx(bar, tx_bytes);
#pragma unroll
                for (int b = 0; b < S::BOXES; ++b)
                    tma2d(dst + b * S::ROWS * S::RB, &tw, n0 + 64 * b,
                          P::KIND == NIB4 ? k0 / 2 : k0, bar);
#pragma unroll
                for (int j = 0; j < S::X_BOXES; ++j)
                    tma2d(dst + S::W_BYTES + j * NP * 128, &tx,
                          k0 + S::X_BOX_K * j, m0, bar);
                if constexpr (P::GROUPED)
                    tma2d(dst + S::W_BYTES + S::X_BYTES, &ts, n0,
                          k0 / A.group, bar);
            }
        }
        return;
    }

    // the consumer warpgroups
    constexpr bool F8 = P::KIND == FP8;
    // fp8 at SUB < KSTEPS (the accumulation probe): the tensor cores' chunk
    // is SUB k32 steps, promoted inside the stage
    constexpr int SUB = sub_steps<P, S::KSTEPS>();
    constexpr bool SUBSTAGE = SUB < S::KSTEPS;
    static_assert(S::KSTEPS % SUB == 0, "SUB divides a stage's steps");
    const int chunk = F8 ? A.chunk : CHUNK;     // stages a promoted chunk
    const int g = lane >> 2, q = lane & 3;
    uint32_t a[2][MT][4];
    uint32_t sc[2 * MT];
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) sc[i] = 0;
    // fp8_frags' selectors: which of a pair of words holds rows 4q, 4q + 1
    const uint32_t sel_lo = (q >> 1) ? 0x2064u : 0x6420u;
    const uint32_t sel_hi = (q >> 1) ? 0x3175u : 0x7531u;
    // the thread's first column in the block; fp8 tile i lies 16 i on
    // (TSTEP), the other kinds' 2 i, so those write 2 MT adjacent columns
    constexpr int TSTEP = F8 ? 16 : 2;
    const int cc = 16 * MT * warp + (F8 ? 2 : 2 * MT) * g;
    float acc[MT][NP / 2], sum[MT][NP / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < NP / 2; ++e) acc[i][e] = sum[i][e] = 0.f;

    // A chunk of ``chunk`` stages (PROMOTE K rows for the bf16 kinds,
    // fewer at a split's end) is summed by the tensor cores, then added
    // into the f32 sum.  Each stage is released as soon as its wgmmas
    // are done (holding it longer costs the decode form a stage of its
    // shallow ring).
    for (int c0 = 0; c0 < nst; c0 += chunk) {
        for (int st = c0; st < min(nst, c0 + chunk); ++st) {
            const int s = st % ST;
            mbar_wait(full + 8 * s, (st / ST) & 1);
            const unsigned char* stage = smem + s * S::STAGE;
            const uint32_t xst = smem_u32(stage + S::W_BYTES);
            Raw<P, MT> r[S::KSTEPS];
            if constexpr (S::STAGE_LOADS)
                load_stage<P, MT, S>(stage, warp, g, q, lane, r);
#pragma unroll
            for (int ks = 0; ks < S::KSTEPS; ++ks) {
                if constexpr (!S::STAGE_LOADS)
                    load_step<P, MT, S>(stage, ks, warp, g, q, r[ks]);
                if constexpr (P::GROUPED) {
                    if (ks == 0 || (16 * ks) % A.group == 0) {
                        const int row =
                            A.group < S::BK ? 16 * ks / A.group : 0;
                        const float* sp = reinterpret_cast<const float*>(
                            stage + S::W_BYTES + S::X_BYTES)
                            + row * S::COLS + cc;
#pragma unroll
                        for (int j = 0; j < 2 * MT; ++j)
                            sc[j] = bf16x2_bits(sp[j], sp[j]);
                    }
                }
                if constexpr (F8)
                    fp8_frags<MT>(r[ks].w, sel_lo, sel_hi, a[ks & 1]);
                else
                    convert_step<P, MT>(r[ks], sc, a[ks & 1]);
                wgmma_fence();
                // 32 bytes of x's 128-byte rows a step
                const uint64_t desc =
                    desc_b(xst + (ks >> 2) * NP * 128 + (ks & 3) * 32);
                const bool fresh = SUBSTAGE ? ks % SUB == 0
                                            : (st == c0 && ks == 0);
#pragma unroll
                for (int j = 0; j < MT; ++j)
                    wgmma_rs<NP, mma_type<P>()>(acc[j], a[ks & 1][j], desc,
                                                fresh ? 0 : 1);
                wgmma_commit();
                if (SUBSTAGE && ks % SUB == SUB - 1) {
                    // (ks is unrolled: no runtime condition in the loop)
                    wgmma_wait<0>();
#pragma unroll
                    for (int j = 0; j < MT; ++j) fence_regs(acc[j]);
#pragma unroll
                    for (int j = 0; j < MT; ++j)
#pragma unroll
                        for (int e = 0; e < NP / 2; ++e)
                            sum[j][e] = __fadd_rn(sum[j][e], acc[j][e]);
                } else if (ks > 0) {
                    // step ks - 1 is done, so its A registers may be
                    // written again
                    wgmma_wait<1>();
                }
            }
            wgmma_wait<0>();
            mbar_arrive(empty + 8 * s);
        }
        if constexpr (!SUBSTAGE) {
            // promote the chunk into the f32 sum
#pragma unroll
            for (int j = 0; j < MT; ++j) fence_regs(acc[j]);
#pragma unroll
            for (int j = 0; j < MT; ++j)
#pragma unroll
                for (int e = 0; e < NP / 2; ++e)
                    sum[j][e] = __fadd_rn(sum[j][e], acc[j][e]);
        }
    }

    // The epilogue.  Accumulator element 4j + 2h + e of tile i is the
    // thread's column cc + TSTEP i + h and token m0 + 8j + 2q + e.  Its V
    // values of a token are NG groups of GV adjacent columns: one group of
    // 2 MT (cc ..), or for fp8 MT groups of 2 (cc + 16 i ..).
    constexpr int V = 2 * MT;
    constexpr int NG = TSTEP == 2 ? 1 : MT, GV = V / NG;
    const int cb = n0 + cc;
    bool col_ok[NG];     // N % 16 == 0: all of a group's columns or none
#pragma unroll
    for (int i = 0; i < NG; ++i) col_ok[i] = cb + 16 * i < A.n;
    // the column of value i
    auto col_of = [&](int i) { return cb + 16 * (i / GV) + i % GV; };
    auto values = [&](int j, int e, float (&v)[V]) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            v[2 * i] = sum[i][4 * j + e];
            v[2 * i + 1] = sum[i][4 * j + 2 + e];
        }
    };
    // group gi of v to p, GV f32 / bf16 values
    auto store_f32 = [&](float* p, const float (&v)[V], int gi) {
        const float* u = v + GV * gi;
        if constexpr (GV == 4)
            *reinterpret_cast<float4*>(p) = make_float4(u[0], u[1], u[2],
                                                        u[3]);
        else
            *reinterpret_cast<float2*>(p) = make_float2(u[0], u[1]);
    };
    auto load_f32 = [&](const float* p, float (&v)[V], int gi) {
        float* u = v + GV * gi;
        if constexpr (GV == 4) {
            const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
            u[0] = f.x; u[1] = f.y; u[2] = f.z; u[3] = f.w;
        } else {
            const float2 f = __ldcg(reinterpret_cast<const float2*>(p));
            u[0] = f.x; u[1] = f.y;
        }
    };
    if (A.splits > 1) {
        const size_t plane = (size_t)A.m * A.n;
        float* mine = A.ws + blockIdx.z * plane;
#pragma unroll
        for (int j = 0; j < NP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int m = m0 + 8 * j + 2 * q + e;
                if (m >= A.m) continue;
                float v[V];
                values(j, e, v);
#pragma unroll
                for (int gi = 0; gi < NG; ++gi)
                    if (col_ok[gi])
                        store_f32(mine + (size_t)m * A.n + col_of(GV * gi),
                                  v, gi);
            }
        if (!splitk::last_of_tile_bar<S::CONSUMERS>(A.counters, A.splits,
                                                    &is_last))
            return;
        // the tile's last block: the partials in split order, all of a
        // token's loads started before the first add
#pragma unroll
        for (int j = 0; j < NP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int m = m0 + 8 * j + 2 * q + e;
                if (m >= A.m) continue;
                float u[MAX_SPLITS][V];
#pragma unroll
                for (int z = 0; z < MAX_SPLITS; ++z) {
                    if (z >= A.splits) break;
#pragma unroll
                    for (int gi = 0; gi < NG; ++gi)
                        if (col_ok[gi])
                            load_f32(A.ws + z * plane + (size_t)m * A.n
                                     + col_of(GV * gi), u[z], gi);
                }
                float v[V];
#pragma unroll
                for (int i = 0; i < V; ++i) v[i] = u[0][i];
#pragma unroll
                for (int z = 1; z < MAX_SPLITS; ++z)
                    if (z < A.splits)
#pragma unroll
                        for (int i = 0; i < V; ++i)
                            v[i] = __fadd_rn(v[i], u[z][i]);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    sum[i][4 * j + e] = v[2 * i];
                    sum[i][4 * j + 2 + e] = v[2 * i + 1];
                }
            }
        splitk::release_tile(A.counters);
    }
    float scale[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
        scale[i] = (A.col_scale != nullptr && col_ok[i / GV])
                       ? A.col_scale[col_of(i)] : 1.0f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * j + 2 * q + e;
            if (m >= A.m) continue;
            float v[V];
            values(j, e, v);
            if (A.row_scale != nullptr) {
                // the W8A8 epilogue: acc * (xs[m] * s[n]), the JAX order
                const float rs = A.row_scale[m];
#pragma unroll
                for (int i = 0; i < V; ++i)
                    v[i] = __fmul_rn(v[i], __fmul_rn(rs, scale[i]));
            } else {
#pragma unroll
                for (int i = 0; i < V; ++i)
                    v[i] = __fmul_rn(v[i], scale[i]);
            }
#pragma unroll
            for (int gi = 0; gi < NG; ++gi) {
                if (!col_ok[gi]) continue;
                const size_t at = (size_t)m * A.n + col_of(GV * gi);
                if (A.out_f32) {
                    store_f32(reinterpret_cast<float*>(A.out) + at, v, gi);
                } else {
                    const float* u = v + GV * gi;
                    __nv_bfloat16* o =
                        reinterpret_cast<__nv_bfloat16*>(A.out) + at;
                    if constexpr (GV == 4)
                        *reinterpret_cast<uint2*>(o) = make_uint2(
                            bf16x2_bits(u[0], u[1]),
                            bf16x2_bits(u[2], u[3]));
                    else
                        *reinterpret_cast<uint32_t*>(o) =
                            bf16x2_bits(u[0], u[1]);
                }
            }
        }
}

// -- the host side -----------------------------------------------------------

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found);
#endif
        if (found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A row-major (rows, cols) tensor of ``type`` read in (box_rows, box_cols)
// boxes; whatever lies outside the tensor reads as zeros.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int elt,
                   const void* base, long long rows, long long cols,
                   int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)(cols * elt)};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Launch {
    const void* x;              // (m, k) bf16 (FP8: e4m3 bytes; F16: f16)
    const void* w;              // the payload: (k, n) bytes or bf16, or
                                // (k / 2, n) packed int4
    const float* col_scale;     // (n,) or null
    const float* row_scale = nullptr;   // (m,) or null
    const float* group_scale;   // (k / group, n) for grouped policies
    void* out;
    float* ws;
    int* counters;
    int m, n, k, splits, kper, group, out_f32;
    int chunk = 0;              // FP8: stages a promoted chunk (>= 1)
};

template <class P, int MT, int NP, int WGS>
cudaError_t launch_tiles(const Launch& L, cudaStream_t stream) {
    using S = Shape<P, MT, NP, WGS>;
    static bool configured = false;     // per instance; the attribute sticks
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            stream_kernel<P, MT, NP, WGS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    CUtensorMap tw, tx, ts;
    bool ok;
    if constexpr (P::KIND == HALF16)
        ok = encode(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, L.w, L.k, L.n,
                    S::ROWS, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    else
        ok = encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, L.w,
                    P::KIND == NIB4 ? L.k / 2 : L.k, L.n, S::ROWS, S::RB,
                    S::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B);
    if constexpr (P::KIND == FP8)
        ok = ok && encode(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, L.x, L.m,
                          L.k, NP, 128, CU_TENSOR_MAP_SWIZZLE_128B);
    else
        ok = ok && encode(&tx, P::F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          2, L.x, L.m, L.k, NP, 64,
                          CU_TENSOR_MAP_SWIZZLE_128B);
    Args A;
    A.col_scale = L.col_scale;
    A.row_scale = L.row_scale;
    A.out = L.out;
    A.ws = L.ws;
    A.counters = L.counters;
    A.m = L.m; A.n = L.n; A.k = L.k;
    A.mtiles = (L.m + NP - 1) / NP;
    A.splits = L.splits; A.kper = L.kper;
    A.group = L.group;
    A.scale_rows = 0;
    A.out_f32 = L.out_f32;
    A.chunk = L.chunk;
    if (P::KIND == FP8 && A.chunk < 1) return cudaErrorInvalidValue;
    if constexpr (P::GROUPED) {
        A.scale_rows = L.group < S::BK ? S::BK / L.group : 1;
        ok = ok && encode(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                          L.group_scale, L.k / L.group, L.n, A.scale_rows,
                          S::COLS, CU_TENSOR_MAP_SWIZZLE_NONE);
    } else {
        ts = tx;                        // unused
    }
    if (!ok) return cudaErrorInvalidValue;
    const long long tiles =
        (long long)A.mtiles * ((L.n + S::COLS - 1) / S::COLS);
    if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
    dim3 grid((unsigned)tiles, 1, L.splits);
    stream_kernel<P, MT, NP, WGS><<<grid, S::THREADS, S::SMEM, stream>>>(
        tw, tx, ts, A);
    return cudaGetLastError();
}

template <class P, int MT>
cudaError_t launch_np(const Launch& L, cudaStream_t stream) {
    if (L.m <= 8) return launch_tiles<P, MT, 8, 1>(L, stream);
    if (L.m <= 16) return launch_tiles<P, MT, 16, 1>(L, stream);
    if (L.m <= 32) return launch_tiles<P, MT, 32, 1>(L, stream);
    return launch_tiles<P, MT, 64, 1>(L, stream);
}

// What the loop takes, checked by the caller (kernels/qmatmul.py::
// streams / prefills and their plans, w8a8_matmul) and again here:
// k % 8 == 0 (FP8: k % 32 == 0), n % 16 == 0, 16-byte aligned operands,
// kper a multiple of the stage's K rows, splits <= MAX_SPLITS, grouped
// scales with group % 16 == 0 dividing or divided by 128.
template <class P>
bool loop_takes(const Launch& L) {
    constexpr int BK = P::KIND == HALF16 ? 64 : 128;
    if (L.m < 1 || L.k % (P::KIND == FP8 ? 32 : 8) || L.n % 16
        || L.splits < 1 || L.splits > MAX_SPLITS || L.kper % BK
        || (L.splits - 1) * (long long)L.kper >= L.k
        || (long long)L.splits * L.kper < L.k)
        return false;
    return !P::GROUPED || (L.group > 0 && L.group % 16 == 0
                           && (BK % L.group == 0 || L.group % BK == 0)
                           && L.k % L.group == 0);
}

// The decode form: m <= 64, ``mt`` (1 or 2) m64 tiles a block
// (qmatmul.py::stream_plan).
template <class P>
cudaError_t launch(const Launch& L, int mt, cudaStream_t stream) {
    if (L.m > 64 || !loop_takes<P>(L)) return cudaErrorInvalidValue;
    if (mt == 1) return launch_np<P, 1>(L, stream);
    if (mt == 2) return launch_np<P, 2>(L, stream);
    return cudaErrorInvalidValue;
}

// The prefill route: m > 64, blocks of 128 columns x PREFILL_NP tokens on
// two consumer warpgroups (qmatmul.py::prefill_plan).
template <class P>
cudaError_t launch_prefill(const Launch& L, cudaStream_t stream) {
    if (L.m <= 64 || !loop_takes<P>(L)) return cudaErrorInvalidValue;
    return launch_tiles<P, 1, PREFILL_NP, 2>(L, stream);
}

}  // namespace ws
