// K2: the fused fake-quant GEMM, out = qdq(x; sx) @ qdq(w; sw[N]).
//
// Replaces fp8tpu/kernels/qmatmul.py::_qdq_matmul_kernel, the Pallas
// kernel that every hw-patched Conv / Dense / Matmul runs, forward and
// backward.  x is (M, K) with one per-tensor scale, w is (K, N) with one
// scale per output column; either operand may be left unquantized.  Casts
// are bit for bit the plain ones: the bit pipeline ("bitexact",
// cast.cuh::cast_elem) or the hardware-convert route ("hw", cast.cuh::
// hw_qdq / hw_sr), rounding to nearest or stochastically.
//
// What bounds it on the H100: the contraction, 2*M*N*K multiply-adds that
// must come out within the f32 summation-order bound of the exact product
// of the cast operands (chip_smoke.py::k2_reference), and before that the
// cast's 50-100 integer operations an element.  The earlier design cast
// each operand tile in the GEMM's loader (an activation 9 times over in a
// 3x3 im2col, and again for every column block) and contracted on the SIMT
// f32 pipes at about half of cuBLAS's f32 rate.  This one (measured on an
// H100 80GB HBM3 at 700 W, PERF.md): the bitexact pre-pass is bound by the
// cast's integer work (0.051 ms for ResNet-50's first-stage activation,
// 0.012 ms of bytes), and the GEMM runs its MMAs at about a fifth of the
// bf16 peak, bound by fixed costs a block and the weight planes re-read
// from L2 by every row of tiles.
//
// * A cast pre-pass (k2_prepass) casts each operand element once and
//   writes its *scaled grid value*: the cast with its last descale left
//   out (mul_ftz(g, 1/s) of the bit pipeline, div_ftz(y, s) of hw).  On
//   every format with at most 7 mantissa bits that value is exact in
//   bf16: one plane.  An uncast f32 (and a float16 grid) is split exactly
//   into three bf16 planes, hi + mid + lo, by truncation (hi = the top 16
//   bits, mid the top 16 of the exact remainder, lo the rest; exact for
//   every finite |v| >= 2^-110 and for 0, NaN and inf kept in hi).  The
//   epilogue applies the descale to the sum, as the cast's own last
//   operation, and the per-column factor of a cast w, as the JAX
//   package's _qdq_matmul_hw_xla does.  The pre-pass reads its operand
//   through strides (the backward's transposed operands in place, an
//   NCHW activation or gradient as (pixels, channels)) and writes K-major
//   planes.  Stochastic operands draw the counter hash of the salt over
//   the element's row-major index in the operand (numerics/cast.py::
//   sr_bits_from_salt), the stream of the JAX package's CPU route; an
//   operand that is a rank's block of a split tensor hashes each
//   element's global index instead (fp8::BlockRuns, as K1's block route).
// * The GEMM (k2_gemm) multiplies bf16 planes on the tensor cores with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), keeping the plane
//   products whose indices sum to at most 2: 1 MMA for two 1-plane
//   operands, 3 for a cast activation against an uncast weight, 6 for
//   two uncast operands.  The dropped products are below 2^-24 of the
//   term.  The tensor cores' f32 accumulation is not IEEE round to
//   nearest (it truncates), so each k-chunk of ``promote`` slabs (128
//   deep) is summed on the tensor cores into zeroed registers and then
//   added into a separate f32 accumulator with ordinary adds
//   (chip_smoke.py's k2_probe phase measures what that buys).  Tiles of
//   128 x 64 for 8 warps of 32 x 32, k slabs of 32, a ring of 3-4
//   cp.async stages, rows XOR-swizzled so that ldmatrix reads hit
//   distinct banks.  An uncast A stored with M contiguous (the backward's
//   transposed im2col) is read as f32, split as it is staged and read
//   back with ldmatrix.trans: its planes never reach device memory.
// * A conv is an implicit GEMM: the loader gathers the im2col tile from
//   the NHWC grid of the activation (K ordered (kh, kw, c), the weight's
//   rows permuted to match), out-of-image taps are zero-filled by
//   cp.async, and the epilogue writes NCHW.  No im2col and no output
//   permute exist in device memory.
// * An output with few tiles and a long K (the backward's weight
//   gradient: 576 x 64 over K = 100352 at ResNet-50's first stage) splits
//   K over grid.z (split_k.cuh: the last block of a tile to finish adds
//   the partials in split order 0..S-1, so one launch gives the same bits
//   every time); the descale comes after that sum.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cast.cuh"
#include "split_k.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNone = -1;      // operand not cast
constexpr int kRuntime = -2;   // cast variant chosen at run time
constexpr int kE4m3Rne = fp8::code_of(fp8::E4M3, fp8::RNE, 0);
constexpr int kHwE4m3 = fp8::hw_code(fp8::E4M3, false);
constexpr int kHwE5m2 = fp8::hw_code(fp8::E5M2, false);

// -- the cast pre-pass ---------------------------------------------------------

// Element (r, c) of an f32 operand lies at (r / rg) * r1 + (r % rg) * r0
// plus the same of c; rg = 0 means one group (offset r * r0).
struct View {
  const float* p;
  long long rows, cols;
  long long rg, r0, r1, cg, c0, c1;
  long long ir, ic;            // the SR index of (r, c): r * ir + c * ic
  int blocked;                 // the SR index is then blk's global one
  fp8::BlockRuns blk;
};

__device__ __forceinline__ long long view_off(long long i, long long g,
                                              long long s0, long long s1) {
  return g ? (i / g) * s1 + (i % g) * s0 : i * s0;
}

template <int CODE>
__device__ __forceinline__ float grid_value(float v, float s, int code,
                                            long long salt, long long idx) {
  if constexpr (CODE == kNone) {
    return v;
  } else if constexpr (CODE == kRuntime) {
    const uint32_t rb = salt < 0 ? 0u
        : fp8::sr_hash(static_cast<uint32_t>(salt),
                       static_cast<uint32_t>(idx));
    return code < 0 ? v : fp8::grid_code(code, v, s, rb);
  } else if constexpr (CODE == kHwE4m3) {
    return fp8::hw_qdq<fp8::E4M3>(v, s, false);
  } else if constexpr (CODE == kHwE5m2) {
    return fp8::hw_qdq<fp8::E5M2>(v, s, false);
  } else {
    return fp8::cast_elem<CODE / 16, (CODE % 16) / 2, (CODE % 2) != 0>(
        v, s, 1.0f, 0u, true);
  }
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return static_cast<uint16_t>(__float_as_uint(v) >> 16);
}

// v = hi + mid + lo exactly (see the file's note); inf and NaN (quieted)
// go to hi whole.
__device__ __forceinline__ void split3(float v, uint16_t& h, uint16_t& m,
                                       uint16_t& l) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7F800000u) == 0x7F800000u) {
    h = static_cast<uint16_t>((u >> 16) | ((u & 0x7FFFFFu) ? 0x40u : 0u));
    m = l = 0;
    return;
  }
  const float hi = __uint_as_float(u & 0xFFFF0000u);
  const float r = __fsub_rn(v, hi);
  const float mid = __uint_as_float(__float_as_uint(r) & 0xFFFF0000u);
  h = bf16_bits(hi);
  m = bf16_bits(mid);
  const bf16 lo = __float2bfloat16_rn(__fsub_rn(r, mid));
  l = *reinterpret_cast<const uint16_t*>(&lo);
}

constexpr int kPrepRows = 64, kPrepCols = 64, kPrepThreads = 256;

// Planes out[p][r][c] (p < planes, row pitch ld >= cols, zero past cols)
// of the cast operand's grid values.  One block casts a 64 x 64 tile: the
// f32 reads go along whichever of r and c is contiguous (row_fast: r),
// through shared memory, and each thread then casts and writes runs of 8
// along c (16 bytes a plane).
template <int CODE>
__global__ void __launch_bounds__(kPrepThreads)
k2_prepass(View V, bf16* out, long long ld, long long plane, int planes,
           int code, const float* scale, int per_row, long long salt,
           int row_fast) {
  __shared__ float tile[kPrepRows][kPrepCols + 1];
  const int t = threadIdx.x;
  const long long r_base = static_cast<long long>(blockIdx.y) * kPrepRows;
  const long long c_base = static_cast<long long>(blockIdx.x) * kPrepCols;
  if (row_fast) {
    const int rr = t % kPrepRows;
    const long long r = r_base + rr;
    const long long ro = r < V.rows ? view_off(r, V.rg, V.r0, V.r1) : 0;
#pragma unroll 4
    for (int cc = t / kPrepRows; cc < kPrepCols;
         cc += kPrepThreads / kPrepRows) {
      const long long c = c_base + cc;
      tile[rr][cc] = (r < V.rows && c < V.cols)
          ? V.p[ro + view_off(c, V.cg, V.c0, V.c1)] : 0.0f;
    }
  } else {
    const int cc = t % kPrepCols;
    const long long c = c_base + cc;
    const long long co = c < V.cols ? view_off(c, V.cg, V.c0, V.c1) : 0;
#pragma unroll 4
    for (int rr = t / kPrepCols; rr < kPrepRows;
         rr += kPrepThreads / kPrepCols) {
      const long long r = r_base + rr;
      tile[rr][cc] = (r < V.rows && c < V.cols)
          ? V.p[view_off(r, V.rg, V.r0, V.r1) + co] : 0.0f;
    }
  }
  __syncthreads();

  float s = 1.0f;
  if (CODE != kNone && !per_row) s = scale[0];
  for (int job = t; job < kPrepRows * kPrepCols / 8; job += kPrepThreads) {
    const int rr = job / (kPrepCols / 8), cc0 = (job % (kPrepCols / 8)) * 8;
    const long long r = r_base + rr, c0 = c_base + cc0;
    if (r >= V.rows || c0 >= ld) continue;
    if (CODE != kNone && per_row) s = scale[r];
    uint16_t h[8], m[8], l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long c = c0 + i;
      float g = 0.0f;
      if (c < V.cols) {
        long long idx = r * V.ir + c * V.ic;
        if constexpr (CODE == kRuntime) {
          if (V.blocked) idx = fp8::block_index(idx, V.blk);
        }
        g = grid_value<CODE>(tile[rr][cc0 + i], s, code, salt, idx);
      }
      split3(g, h[i], m[i], l[i]);
    }
    uint16_t* dst = reinterpret_cast<uint16_t*>(out) + r * ld + c0;
    auto put = [&](uint16_t* d, const uint16_t (&v)[8]) {
      uint4 w;
      w.x = v[0] | (static_cast<uint32_t>(v[1]) << 16);
      w.y = v[2] | (static_cast<uint32_t>(v[3]) << 16);
      w.z = v[4] | (static_cast<uint32_t>(v[5]) << 16);
      w.w = v[6] | (static_cast<uint32_t>(v[7]) << 16);
      *reinterpret_cast<uint4*>(d) = w;
    };
    put(dst, h);
    if (planes > 1) {
      put(dst + plane, m);
      put(dst + 2 * plane, l);
    }
  }
}

// -- the GEMM --------------------------------------------------------------------

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kWarpsM = 4, kWarpsN = 2, kThreads = 32 * kWarpsM * kWarpsN;
constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;  // a warp's tile
constexpr int MT = WM / 16, NT = WN / 8;             // its m16 / n8 tiles
// Rows of the A and B tiles each thread copies, kRowStep apart (4 threads
// a row, one 16-byte chunk each).
constexpr int kRowStep = kThreads / 4;
constexpr int RA = BM / kRowStep, RB = BN / kRowStep;

// cp.async stages: 4, or 3 where A has three planes, so that two blocks
// fit on an SM.
__host__ __device__ constexpr int stages_of(int pa) { return pa == 3 ? 3 : 4; }

// How the GEMM reads A: pre-passed planes, the implicit im2col of a
// conv's NHWC grid, or an uncast f32 operand stored with M contiguous (the
// backward's transposed im2col), split into its planes as it is staged.
enum AMode : int { kAPlanes = 0, kAConv = 1, kAF32T = 2 };

struct Gemm {
  const bf16* a;             // A planes [PA][M][lda], or the NHWC grid
  long long a_plane;         //   [PA][B*H*W][cp] of a conv's activation
  int lda;
  const float* a32;          // kAF32T: A[m][k] at a32[k * lda + m]
  int k;                     // kAF32T: K (the planes are zero-padded)
  const bf16* b;             // B planes [PB][N][ldb]: row n holds column n
  long long b_plane;         //   of w along K
  int ldb;
  float* out;
  int m, n, k_tiles;
  // implicit conv (CONV instances): input H x W with cp channels a pixel,
  // kernel kh x kw, strides, top / left padding, output oh x ow
  int ih, iw, cp, kh, kw, sh, sw, pt, pl, oh, ow;
  int dx, dw;                // descale of x / w: 0 none, 1 mul_ftz by
  const float* sx;           //   recip_ftz(s), 2 div_ftz by s
  const float* sws;
  int splits, tiles_per_split;
  float* ws;                 // (splits, M, N) partials when splits > 1
  int* counters;             // one per output tile, zero between launches
  int promote;               // k slabs a chunk on the tensor cores; 0: all
};

// Element offset of (row, 16-byte chunk) in a tile of 32-wide rows: the
// chunk is XORed with bits 1-2 of the row, so the 8 rows that one
// ldmatrix phase reads fall in 8 distinct bank groups.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ ((row >> 1) & 3)) << 3);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// The same, transposed: a row-major A fragment from a tile stored [k][m].
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// Element offset of (k, 16-byte chunk of m) in an A tile stored [BK][BM]
// (rows of 256 bytes): the chunk is XORed with the row's low 3 bits, so
// the 8 rows that one ldmatrix.trans phase reads hit 8 bank groups.
__device__ __forceinline__ int swz_t(int k, int chunk) {
  return k * BM + ((chunk ^ (k & 7)) << 3);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int PA, int PB>
constexpr int smem_bytes() {
  return stages_of(PA) * (PA * BM + PB * BN) * BK * 2;
}

template <int PA, int PB, int AM>
__global__ void __launch_bounds__(kThreads) k2_gemm(Gemm G) {
  constexpr bool CONV = AM == kAConv, AF32T = AM == kAF32T;
  static_assert(!AF32T || PA == 3, "an f32 A is split into 3 planes");
  constexpr int kStages = stages_of(PA);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);        // [stage][PA][BM*BK]
  bf16* Bs = As + kStages * PA * BM * BK;          // [stage][PB][BN*BK]
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * G.tiles_per_split;
  const int kt1 = min(G.k_tiles, kt0 + G.tiles_per_split);

  // Each thread copies the same 16-byte chunk column of rows tid / 4 +
  // kRowStep i: RA rows of an A tile, RB of a B tile.
  const int lc = tid & 3, lr = tid >> 2;
  const bf16* a_src[RA];
  int a_pix[RA], a_y[RA], a_x[RA];
  bool a_ok[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = row0 + lr + kRowStep * i;
    a_ok[i] = r < G.m;
    if constexpr (CONV) {
      const int ohw = G.oh * G.ow;
      const int img = r / ohw, o = r % ohw;
      a_pix[i] = img * G.ih * G.iw;
      a_y[i] = (o / G.ow) * G.sh - G.pt;
      a_x[i] = (o % G.ow) * G.sw - G.pl;
      a_src[i] = G.a;
    } else {
      a_src[i] = G.a + static_cast<long long>(a_ok[i] ? r : 0) * G.lda
               + lc * 8;
    }
  }
  const bf16* b_src[RB];
  bool b_ok[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int c = col0 + lr + kRowStep * i;
    b_ok[i] = c < G.n;
    b_src[i] = G.b + static_cast<long long>(b_ok[i] ? c : 0) * G.ldb + lc * 8;
  }

  auto load = [&](int kt, int stage) {
    bf16* as = As + stage * PA * BM * BK;
    bf16* bs = Bs + stage * PB * BN * BK;
    const int k = kt * BK + lc * 8;
    if constexpr (CONV) {
      const int tap = k / G.cp, c = k % G.cp;
      const int ky = tap / G.kw, kx = tap % G.kw;
      const bool tap_ok = tap < G.kh * G.kw;
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int y = a_y[i] + ky, x = a_x[i] + kx;
        const bool ok = a_ok[i] && tap_ok && y >= 0 && y < G.ih && x >= 0
                        && x < G.iw;
        const long long at = ok
            ? static_cast<long long>(a_pix[i] + y * G.iw + x) * G.cp + c : 0;
#pragma unroll
        for (int p = 0; p < PA; ++p)
          cp16(as + p * BM * BK + swz(lr + kRowStep * i, lc),
               a_src[i] + p * G.a_plane + at, ok);
      }
    } else if constexpr (!AF32T) {
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int p = 0; p < PA; ++p)
          cp16(as + p * BM * BK + swz(lr + kRowStep * i, lc),
               a_src[i] + p * G.a_plane + kt * BK, a_ok[i]);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int p = 0; p < PB; ++p)
        cp16(bs + p * BN * BK + swz(lr + kRowStep * i, lc),
             b_src[i] + p * G.b_plane + kt * BK, b_ok[i]);
  };

  // kAF32T: each thread fetches 16 floats of an A tile (k row tid / 8,
  // m from 16 (tid % 8)) one tile ahead into registers, then splits them
  // into the planes of the tile's stage, [BK][BM] with m contiguous.
  float4 ra[4];
  const int fk = tid >> 3, fm = (tid & 7) * 16;
  auto fetch_a = [&](int kt) {
    const int k = kt * BK + fk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = row0 + fm + 4 * j;
      ra[j] = (k < G.k && m < G.m)
          ? __ldg(reinterpret_cast<const float4*>(
                G.a32 + static_cast<long long>(k) * G.lda + m))
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put_a = [&](int stage) {
    bf16* as = As + stage * PA * BM * BK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v[4] = {ra[j].x, ra[j].y, ra[j].z, ra[j].w};
      uint16_t h[4], m[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(v[e], h[e], m[e], l[e]);
      const int at = swz_t(fk, (fm + 4 * j) >> 3) + (j & 1) * 4;
      const uint16_t* planes[3] = {h, m, l};
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(as + p * BM * BK + at) = make_uint2(
            planes[p][0] | (static_cast<uint32_t>(planes[p][1]) << 16),
            planes[p][2] | (static_cast<uint32_t>(planes[p][3]) << 16));
    }
  };

  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (kt0 + s < kt1) load(kt0 + s, s);
    cp_commit();
  }
  if constexpr (AF32T) {
    if (kt0 < kt1) fetch_a(kt0);
  }
  int in_chunk = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int stage = (kt - kt0) % kStages;
    if constexpr (AF32T) put_a(stage);
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt1) load(next, (next - kt0) % kStages);
    cp_commit();
    if constexpr (AF32T) {
      if (kt + 1 < kt1) fetch_a(kt + 1);
    }
    const bf16* as = As + stage * PA * BM * BK;
    const bf16* bs = Bs + stage * PB * BN * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t bfr[PB][NT][2];
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          const int nrow = wn * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm4(r, bs + p * BN * BK + swz(nrow, ks * 2 + ((lane >> 3) & 1)));
          bfr[p][2 * np][0] = r[0];
          bfr[p][2 * np][1] = r[1];
          bfr[p][2 * np + 1][0] = r[2];
          bfr[p][2 * np + 1][1] = r[3];
        }
#pragma unroll
      for (int pa = 0; pa < PA; ++pa) {
        uint32_t afr[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (AF32T) {
            const int m = wm * WM + mt * 16 + ((lane >> 3) & 1) * 8;
            ldsm4_t(afr[mt], as + pa * BM * BK
                    + swz_t(ks * 16 + (lane & 7) + ((lane >> 4) << 3),
                            m >> 3));
          } else {
            ldsm4(afr[mt], as + pa * BM * BK
                  + swz(wm * WM + mt * 16 + (lane & 15),
                        ks * 2 + (lane >> 4)));
          }
        }
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) {
          if (pa + pb > 2) continue;   // a product below 2^-24 of the term
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma(part[mt][nt], afr[mt], bfr[pb][nt][0], bfr[pb][nt][1]);
        }
      }
    }
    // Promotion: the chunk's tensor-core sum into the f32 accumulator.
    if (++in_chunk == G.promote || kt + 1 == kt1) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
            part[i][j][e] = 0.0f;
          }
      in_chunk = 0;
    }
  }
  cp_wait<0>();

  // Epilogue.  The tile goes through shared memory (the stages are free
  // now): every later step is a rolled loop over it, which keeps the code
  // small (an unrolled per-register epilogue with its descales and split-K
  // sums runs to tens of kilobytes, fetched anew by every block), and the
  // stores coalesce: 16 bytes along a row of out, or for NCHW along the
  // pixels of one channel.  acc[mt][nt][2h + e] is row wm*WM + mt*16 +
  // g + 8h, column wn*WN + nt*8 + 2q + e of the tile.
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem);
  constexpr int LDR = BN + 8, LDC = BM + 4;   // [BM][LDR] or [BN][LDC]
  auto at = [](int r, int c) { return CONV ? c * LDC + r : r * LDR + c; };
  {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            cs[at(wm * WM + mt * 16 + g + 8 * h, wn * WN + nt * 8 + 2 * q
                  + e)] = acc[mt][nt][2 * h + e];
  }
  __syncthreads();
  if (G.splits > 1) {
    // Park this split's partial; the tile's last block adds all partials
    // in split order.
    const long long plane = static_cast<long long>(G.m) * G.n;
    float* mine = G.ws + blockIdx.z * plane;
#pragma unroll 1
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      if (row0 + r < G.m && col0 + c < G.n)
        mine[static_cast<long long>(row0 + r) * G.n + col0 + c] = cs[at(r, c)];
    }
    if (!splitk::last_of_tile(G.counters, G.splits, &is_last)) return;
#pragma unroll 1
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      if (row0 + r < G.m && col0 + c < G.n)
        cs[at(r, c)] = splitk::ordered_sum(
            G.ws, plane, static_cast<long long>(row0 + r) * G.n + col0 + c,
            G.splits);
    }
    splitk::release_tile(G.counters);
    __syncthreads();
  }
  float s_x = 1.0f, inv_x = 1.0f;
  if (G.dx) {
    s_x = G.sx[0];
    inv_x = fp8::recip_ftz(s_x);
  }
  // The casts' last operations, on the sum.
  auto descale = [&](float v, int col) {
    if (G.dx == 1) v = fp8::mul_ftz(v, inv_x);
    else if (G.dx == 2) v = fp8::div_ftz(v, s_x);
    if (G.dw == 1) v = fp8::mul_ftz(v, fp8::recip_ftz(G.sws[col]));
    else if (G.dw == 2) v = fp8::div_ftz(v, G.sws[col]);
    return v;
  };
  if constexpr (CONV) {
    // A thread keeps one row (kThreads is a multiple of BM), so its
    // image and pixel are divided out once.
    static_assert(kThreads % BM == 0, "one row a thread");
    const int ohw = G.oh * G.ow;
    const int r = tid % BM, row = row0 + r;
    if (row < G.m) {
      float* base = G.out + static_cast<long long>(row / ohw) * G.n * ohw
                  + row % ohw;
#pragma unroll 1
      for (int c = tid / BM; c < BN; c += kThreads / BM) {
        const int col = col0 + c;
        if (col < G.n)
          base[static_cast<long long>(col) * ohw] = descale(cs[at(r, c)], col);
      }
    }
  } else {
    const bool vec = G.n % 4 == 0;
#pragma unroll 1
    for (int idx = tid; idx < BM * BN / 4; idx += kThreads) {
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const int row = row0 + r, col = col0 + c;
      if (row >= G.m || col >= G.n) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = col + e < G.n ? descale(cs[at(r, c + e)], col + e) : 0.0f;
      float* dst = G.out + static_cast<long long>(row) * G.n + col;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int e = 0; e < 4 && col + e < G.n; ++e) dst[e] = v[e];
      }
    }
  }
}

template <int PA, int PB, int AM>
int launch_gemm(const Gemm& g, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<PA, PB>();
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        k2_gemm<PA, PB, AM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const dim3 grid((g.n + BN - 1) / BN, (g.m + BM - 1) / BM, g.splits);
  k2_gemm<PA, PB, AM><<<grid, kThreads, bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cast pre-pass: ``planes`` (1 or 3) bf16 planes [planes][rows][ld] of
// the view's grid values (cast ``code``, -1 uncast; ``scale`` one value,
// or one per row when ``per_row``; ``salt`` < 0: zero random bits), zero
// past ``cols``.  ``blk``: null, or the operand is a block of a larger
// tensor and its SR index (r * ir + c * ic, row-major in the operand) is
// mapped to the global one by the 7 values of fp8::block_runs.  Returns
// the launch's cudaError_t.
extern "C" int fp8_k2_prepass(const float* p, long long rows, long long cols,
                              long long rg, long long r0, long long r1,
                              long long cg, long long c0, long long c1,
                              long long ir, long long ic, void* out,
                              long long ld, int planes, int code,
                              const float* scale, int per_row,
                              long long salt, const long long* blk,
                              void* stream) {
  if (rows == 0 || ld == 0) return 0;
  if (blk != nullptr && (blk[0] < 1 || blk[1] < 1 || salt < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const View v{p, rows, cols, rg, r0, r1, cg, c0, c1, ir, ic,
               blk != nullptr,
               blk != nullptr ? fp8::block_runs(blk) : fp8::BlockRuns{1, 1}};
  const dim3 grid(static_cast<unsigned>((ld + kPrepCols - 1) / kPrepCols),
                  static_cast<unsigned>((rows + kPrepRows - 1) / kPrepRows));
  const int row_fast = r0 == 1 && c0 != 1;
  const long long plane = rows * ld;
  bf16* o = static_cast<bf16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_PREPASS(C) \
  k2_prepass<C><<<grid, kPrepThreads, 0, s>>>(v, o, ld, plane, planes, \
                                              code, scale, per_row, salt, \
                                              row_fast)
  if (code < 0) K2_PREPASS(kNone);
  else if (code == kE4m3Rne) K2_PREPASS(kE4m3Rne);
  else if (code == kHwE4m3) K2_PREPASS(kHwE4m3);
  else if (code == kHwE5m2) K2_PREPASS(kHwE5m2);
  else K2_PREPASS(kRuntime);  // any other cast variant: its runtime switch
#undef K2_PREPASS
  return static_cast<int>(cudaGetLastError());
}

// The GEMM over pre-passed planes: out (m, n) = descale(A @ B), A planes
// [pa][m][lda] (or, with ``conv``, the NHWC grid [pa][B*ih*iw][cp] read as
// the implicit im2col with K ordered (kh, kw, c); or, with ``a32``, an
// uncast f32 A[m][k] at a32[k * lda + m], m a multiple of 4 and 16-byte
// aligned, K = ``k``), B planes [pb][n][ldb]; ``k_tiles`` slabs of 32
// along K; a conv writes out as (m / (oh*ow), n, oh*ow).  dx / dw: 0 no
// descale, 1 mul_ftz by recip_ftz(s), 2 div_ftz by s (sx one value, sw
// one per column).  ``splits`` > 1 splits K in ``tiles_per_split`` slabs
// over grid.z with ``ws`` (splits, m, n) floats and ``counters`` one
// zeroed int per tile.  ``promote``: slabs a tensor-core chunk holds
// before it is added into the f32 sum (0: all).
extern "C" int fp8_k2_gemm(const void* a, long long a_plane, int lda, int pa,
                           const float* a32, int k, const void* b,
                           long long b_plane, int ldb, int pb, float* out,
                           int m, int n, int k_tiles, const int* conv,
                           int dx, int dw, const float* sx,
                           const float* sws, int splits, int tiles_per_split,
                           float* ws, int* counters, int promote,
                           void* stream) {
  if (m == 0 || n == 0) return 0;
  Gemm g{static_cast<const bf16*>(a), a_plane, lda, a32, k,
         static_cast<const bf16*>(b), b_plane, ldb, out, m, n, k_tiles,
         1, 1, 0, 1, 1, 1, 1, 0, 0, 1, 1, dx, dw, sx, sws, splits,
         tiles_per_split, ws, counters, promote};
  if (conv) {
    g.ih = conv[0]; g.iw = conv[1]; g.cp = conv[2]; g.kh = conv[3];
    g.kw = conv[4]; g.sh = conv[5]; g.sw = conv[6]; g.pt = conv[7];
    g.pl = conv[8]; g.oh = conv[9]; g.ow = conv[10];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a32 && pb == 3) return launch_gemm<3, 3, kAF32T>(g, s);
  if (a32) return static_cast<int>(cudaErrorInvalidValue);
  if (conv && pa == 1 && pb == 3) return launch_gemm<1, 3, kAConv>(g, s);
  if (conv && pa == 3 && pb == 3) return launch_gemm<3, 3, kAConv>(g, s);
  if (conv) return static_cast<int>(cudaErrorInvalidValue);
  if (pa == 1 && pb == 1) return launch_gemm<1, 1, kAPlanes>(g, s);
  if (pa == 1 && pb == 3) return launch_gemm<1, 3, kAPlanes>(g, s);
  if (pa == 3 && pb == 1) return launch_gemm<3, 1, kAPlanes>(g, s);
  if (pa == 3 && pb == 3) return launch_gemm<3, 3, kAPlanes>(g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
