// The W8A8 serving linear (matmul_impl="direct"): two kernels of the port
// that have no TPU counterpart.  The JAX package computes both functions as
// XLA ops (fp8tpu/serve/model.py::fp8_linear's "direct" branch and
// ::_quantize_act); the port gives them hand-written kernels because every
// serving linear of the port is one, and because W8A8 is only worth having
// on this card through the fp8 tensor cores.
//
// P2, quantize_rows:  xq[m, :] = fp8(clip(x[m, :] / s[m])),
//                     s[m] = amax_m > 0 ? amax_m / max_normal : 1
// x (M, K) bf16, xq (M, K) e4m3 (or e5m2) bytes, s (M,) f32.  One block a
// row: a max-reduction over the row, then an elementwise pass over it
// again (the row comes from L1 / L2 the second time).  Bound: its bytes,
// 3 K bytes a row.  The arithmetic is cast.cuh's, bit for bit the plain
// version (kernels/qmatmul.py::quantize_rows_plain): the amax flushed
// (XLA's DAZ: a row of f32 subnormals takes scale 1), the scale a
// correctly rounded divide (never a multiply by a reciprocal), x flushed
// before its divide, the host's NaN rules, RNE onto the grid after the
// clip.  One rule is the port's own: a row whose amax lies in
// (0, max_normal 2^-126) keeps its subnormal scale, where XLA flushes the
// quotient to 0 and stores +-max and NaN codes (ROADMAP §3).
//
// P1, w8a8_gemm:  out[M, N] = round((sum_k xq[m, k] w8[k, n]) (xs[m] s[n]))
// xq (M, K) e4m3, w8 (K, N) e4m3 or e5m2 with N contiguous (the serving
// artifact's layout, unchanged), xs (M,) and s (N,) f32, out bf16 or f32.
// Bound on an H100: the bytes of w8 at decode (M <= 64: 45 MB for the gate
// projection, 13.5 us at 3.35 TB/s), the fp8 tensor-core rate at prefill
// (2 M N K / 1979 TFLOP/s: 93 us for the gate projection at M = 2048).
// The design, a first version that is right (ROADMAP §2 names the speed
// steps):
//
// * mma.sync.m16n8k32 with e4m3 x e4m3 (or e4m3 x e5m2) operands and an
//   f32 accumulator.  xq is the row-major A operand, read from a padded
//   shared tile as 32-bit words (four K bytes of one row).  The weight is
//   the column-major B operand, which wants four consecutive K bytes of one
//   column in a register, while the artifact holds N contiguous.  A thread
//   reads the 32-bit words of four K rows at its four columns (each word
//   four N bytes of one K row) and transposes the 4 x 4 bytes in registers
//   with eight byte permutes: no transposed copy of the weight exists
//   anywhere.  Its four columns become its column of four n8 tiles, so a
//   warp's 32 columns are four tiles whose column j is physical column
//   4 j + t; a thread's accumulators then cover 8 adjacent columns of a
//   row, stored as one 16-byte (bf16) or two 16-byte (f32) writes.
// * A cp.async ring of 3 stages of 128 K rows: 128 x 128 weight bytes
//   (16-byte chunks swizzled by row) and BM x 128 activation bytes (rows
//   padded) a stage, so that the fragment reads are free of bank
//   conflicts.  (Stages of 64 rows, 4 deep, took 15% longer at M = 2048
//   on an H100: fp8tpu_torch/tools/bench_w8a8.py.)
// * Blocks of 128 columns: four warps (BM = 16, 32 or 64: one warp column
//   of MT m16 tiles each) at decode, eight warps as 2 x 4 (BM = 128) at
//   prefill, the token tiles of a column tile launched together.
// * The fp8 tensor cores do not keep an f32 sum (DeepSeek-V3 §3.3.2
//   measured about 14 bits).  Every ``promote`` k32 steps the chunk's
//   accumulator is added into an f32 register sum with ordinary adds;
//   chip_smoke.py's w8a8_probe measures the chunk length (the wrapper's
//   W8A8_PROMOTE) and every launch is held to the f64 random-walk bound
//   over those promotion edges.
// * Split-K over gridDim.z, deterministic (split_k.cuh): partials are added
//   in split order by the tile's last block.  No allocation, no host
//   synchronisation: a launch can be captured in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cast.cuh"
#include "split_k.cuh"

namespace {

// -- P2 ------------------------------------------------------------------------

constexpr int Q_THREADS = 256;

// a / s with a already flushed and s left as it is (a subnormal s is the
// port's tiny-amax rule), the host's NaN rules.
__device__ __forceinline__ float div_row(float a, float s) {
    if (isnan(a)) return fp8::quiet(a);
    const float r = __fdiv_rn(a, s);
    return isnan(r) ? __uint_as_float(0xFFC00000u) : r;
}

// A finite or NaN f32 to the format's byte: NaN keeps its sign (e4m3 0x7F,
// e5m2 0x7E with the quiet bit, as XLA's convert and the plain version's
// fp8_payload write them), else clip, RNE onto the grid, and the exact
// value's code.
template <int F>
__device__ __forceinline__ uint8_t to_code(float v) {
    const uint8_t sign = (__float_as_uint(v) >> 24) & 0x80u;
    if (isnan(v)) return sign | (F == fp8::E4M3 ? 0x7Fu : 0x7Eu);
    const float g = fp8::round_grid<F>(fp8::flush(fp8::clip_hw<F>(v)));
    return (uint8_t)__nv_cvt_float_to_fp8(
        g, __NV_SATFINITE, F == fp8::E4M3 ? __NV_E4M3 : __NV_E5M2);
}

template <int F>
__global__ void __launch_bounds__(Q_THREADS)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     uint8_t* __restrict__ q, float* __restrict__ s, int k,
                     int vec) {
    __shared__ float red[Q_THREADS / 32];
    const int t = threadIdx.x;
    const __nv_bfloat16* row = x + (size_t)blockIdx.x * k;
    uint8_t* out = q + (size_t)blockIdx.x * k;

    float amax = 0.0f;
    if (vec) {                            // k % 8 == 0, 16-byte aligned
        for (int i = 8 * t; i < k; i += 8 * Q_THREADS) {
            const uint4 v = *reinterpret_cast<const uint4*>(row + i);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                amax = fp8::nanmax(fabsf(__uint_as_float(w[e] << 16)), amax);
                amax = fp8::nanmax(
                    fabsf(__uint_as_float(w[e] & 0xFFFF0000u)), amax);
            }
        }
    } else {
        for (int i = t; i < k; i += Q_THREADS)
            amax = fp8::nanmax(fabsf(__bfloat162float(row[i])), amax);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        amax = fp8::nanmax(__shfl_xor_sync(0xFFFFFFFFu, amax, o), amax);
    if ((t & 31) == 0) red[t >> 5] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int w = 1; w < Q_THREADS / 32; ++w) amax = fp8::nanmax(red[w], amax);
    amax = fp8::flush(amax);                 // XLA's DAZ on the max
    const float sc = amax > 0.0f ? __fdiv_rn(amax, fp8::Hw<F>::top) : 1.0f;
    if (t == 0) s[blockIdx.x] = sc;

    if (vec) {
        for (int i = 8 * t; i < k; i += 8 * Q_THREADS) {
            const uint4 v = *reinterpret_cast<const uint4*>(row + i);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            uint32_t o[2] = {0u, 0u};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float lo = __uint_as_float(w[e] << 16);
                const float hi = __uint_as_float(w[e] & 0xFFFF0000u);
                const uint32_t b0 = to_code<F>(div_row(fp8::flush(lo), sc));
                const uint32_t b1 = to_code<F>(div_row(fp8::flush(hi), sc));
                o[e >> 1] |= (b0 | (b1 << 8)) << (16 * (e & 1));
            }
            *reinterpret_cast<uint2*>(out + i) = make_uint2(o[0], o[1]);
        }
    } else {
        for (int i = t; i < k; i += Q_THREADS)
            out[i] = to_code<F>(div_row(fp8::flush(__bfloat162float(row[i])),
                                        sc));
    }
}

// -- P1 ------------------------------------------------------------------------

constexpr int BN = 128;             // output columns a block
constexpr int BK = 128;             // K rows a stage (four k32 steps)
constexpr int STAGES = 3;
constexpr int WROW = BN;           // bytes a weight row (swizzled chunks)
constexpr int XROW = BK + 16;       // bytes an activation row: conflict-free
constexpr int MAX_SPLITS = 16;

struct Args {
    const uint8_t* xq;      // (M, K) e4m3
    const uint8_t* w;       // (K, N) e4m3 / e5m2, N contiguous
    const float* xs;        // (M,)
    const float* s;         // (N,)
    void* out;              // (M, N) bf16 or f32
    float* ws;              // (splits, M, N) partials, splits > 1 only
    int* counters;          // one per output tile, zero between launches
    int m, n, k;
    int splits, kper;       // K rows a split, a multiple of BK
    int promote;            // k32 steps a tensor-core chunk
    int out_f32;
};

template <int WARPS_M, int MT>
struct Tile {
    static constexpr int WARPS = 4 * WARPS_M;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int BM = 16 * MT * WARPS_M;
    static constexpr int W_BYTES = BK * WROW;
    static constexpr int X_BYTES = BM * XROW;
    static constexpr int STAGE = W_BYTES + X_BYTES;
    static constexpr int SMEM = STAGES * STAGE;
};

// The weight stage's 16-byte chunk c of K row r lies at chunk
// c ^ wswz(r): the eight lanes of a fragment read that share a K row
// read two adjacent chunks, and the four rows a read spans (4 apart) take
// the four even offsets, so one read touches all 32 banks once.
__device__ __forceinline__ int wswz(int r) { return ((r >> 2) & 3) << 1; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <bool E5M2_W>
__device__ __forceinline__ void mma_fp8(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    if constexpr (E5M2_W) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e5m2.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
}

// Four words w[r] = bytes (c, c+1, c+2, c+3) of K row r to four words
// out[t] = bytes (row 0, 1, 2, 3) of column c + t.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&out)[4]) {
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    out[0] = __byte_perm(lo01, lo23, 0x5410);
    out[1] = __byte_perm(lo01, lo23, 0x7632);
    out[2] = __byte_perm(hi01, hi23, 0x5410);
    out[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <int WARPS_M, int MT, bool E5M2_W>
__global__ void __launch_bounds__(Tile<WARPS_M, MT>::THREADS)
w8a8_gemm_kernel(const Args A) {
    using T = Tile<WARPS_M, MT>;
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int is_last;

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int wm = (warp / 4) * (16 * MT), wn = (warp % 4) * 32;
    const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * BN;
    const int kbeg = blockIdx.z * A.kper;
    const int kend = min(A.k, kbeg + A.kper);
    const int stages = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

    // one stage: 64 weight rows of 8 x 16 bytes, BM activation rows of
    // 4 x 16 bytes; rows past kend, columns past n and rows past m read as
    // zeros
    auto load = [&](int st) {
        uint8_t* base = smem + (st % STAGES) * T::STAGE;
        const int k0 = kbeg + st * BK;
        for (int c = t; c < BK * (BN / 16); c += T::THREADS) {
            const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
            const bool ok = k0 + r < kend && n0 + col < A.n;
            const uint8_t* src = ok ? A.w + (size_t)(k0 + r) * A.n + n0 + col
                                    : A.w;
            cp_async16(base + r * WROW + ((col >> 4) ^ wswz(r)) * 16, src,
                       ok);
        }
        uint8_t* xb = base + T::W_BYTES;
        for (int c = t; c < T::BM * (BK / 16); c += T::THREADS) {
            const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
            const bool ok = m0 + r < A.m && k0 + kc < kend;
            const uint8_t* src = ok ? A.xq + (size_t)(m0 + r) * A.k + k0 + kc
                                    : A.xq;
            cp_async16(xb + r * XROW + kc, src, ok);
        }
    };

    float acc[MT][4][4], sum[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = sum[i][j][e] = 0.0f;

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < stages) load(st);
        cp_async_commit();
    }
    int chunk = 0;                       // k32 steps in the open chunk
    for (int st = 0; st < stages; ++st) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (st + STAGES - 1 < stages) load(st + STAGES - 1);
        cp_async_commit();
        const uint8_t* wb = smem + (st % STAGES) * T::STAGE;
        const uint8_t* xb = wb + T::W_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            uint32_t a[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const uint8_t* r0 = xb + (wm + 16 * i + g) * XROW + kk + 4 * q;
                a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
                a[i][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * XROW);
                a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
                a[i][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * XROW + 16);
            }
            uint32_t b0[4], b1[4];
            {
                // K rows kk + 4 q + r (b0) and kk + 16 + 4 q + r (b1) at
                // columns wn + 4 g .. + 3
                const int chunk = (wn + 4 * g) >> 4, word = (4 * g) & 15;
                uint32_t w[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int row = kk + 4 * q + r;
                    w[r] = *reinterpret_cast<const uint32_t*>(
                        wb + row * WROW + ((chunk ^ wswz(row)) << 4) + word);
                }
                transpose4(w, b0);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int row = kk + 16 + 4 * q + r;
                    w[r] = *reinterpret_cast<const uint32_t*>(
                        wb + row * WROW + ((chunk ^ wswz(row)) << 4) + word);
                }
                transpose4(w, b1);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma_fp8<E5M2_W>(acc[i][j], a[i], b0[j], b1[j]);
            if (++chunk == A.promote) {
                chunk = 0;
#pragma unroll
                for (int i = 0; i < MT; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            sum[i][j][e] = __fadd_rn(sum[i][j][e],
                                                     acc[i][j][e]);
                            acc[i][j][e] = 0.0f;
                        }
            }
        }
    }
    cp_async_wait<0>();
    if (chunk) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    sum[i][j][e] = __fadd_rn(sum[i][j][e], acc[i][j][e]);
    }

    // Thread (g, q) holds, for m16 tile i and row half h (row g + 8 h),
    // the 8 adjacent columns n0 + wn + 8 q + 4 c + j (c = 0, 1; j the n8
    // tile) in sum[i][j][2 h + c].
    const int col = n0 + wn + 8 * q;
    const bool col_ok = col < A.n;           // n % 16 == 0: all 8 or none
    auto row_vals = [&](int i, int h, float (&v)[8]) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[4 * c + j] = sum[i][j][2 * h + c];
    };
    auto set_vals = [&](int i, int h, const float (&v)[8]) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j) sum[i][j][2 * h + c] = v[4 * c + j];
    };
    if (A.splits > 1) {
        const size_t plane = (size_t)A.m * A.n;
        float* mine = A.ws + blockIdx.z * plane;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + wm + 16 * i + g + 8 * h;
                if (row >= A.m || !col_ok) continue;
                float v[8];
                row_vals(i, h, v);
                float4* p = reinterpret_cast<float4*>(
                    mine + (size_t)row * A.n + col);
                p[0] = make_float4(v[0], v[1], v[2], v[3]);
                p[1] = make_float4(v[4], v[5], v[6], v[7]);
            }
        if (!splitk::last_of_tile(A.counters, A.splits, &is_last)) return;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + wm + 16 * i + g + 8 * h;
                if (row >= A.m || !col_ok) continue;
                float v[8];
                for (int z = 0; z < A.splits; ++z) {
                    const float4* p = reinterpret_cast<const float4*>(
                        A.ws + z * plane + (size_t)row * A.n + col);
                    const float4 u0 = __ldcg(p), u1 = __ldcg(p + 1);
                    const float u[8] = {u0.x, u0.y, u0.z, u0.w,
                                        u1.x, u1.y, u1.z, u1.w};
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        v[e] = z == 0 ? u[e] : __fadd_rn(v[e], u[e]);
                }
                set_vals(i, h, v);
            }
        splitk::release_tile(A.counters);
    }
    if (!col_ok) return;
    float cs[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) cs[e] = A.s[col + e];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm + 16 * i + g + 8 * h;
            if (row >= A.m) continue;
            const float rs = A.xs[row];
            float v[8];
            row_vals(i, h, v);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                v[e] = __fmul_rn(v[e], __fmul_rn(rs, cs[e]));   // the JAX order
            const size_t at = (size_t)row * A.n + col;
            if (A.out_f32) {
                float4* o = reinterpret_cast<float4*>(
                    reinterpret_cast<float*>(A.out) + at);
                o[0] = make_float4(v[0], v[1], v[2], v[3]);
                o[1] = make_float4(v[4], v[5], v[6], v[7]);
            } else {
                uint32_t p[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * e],
                                                             v[2 * e + 1]);
                    p[e] = *reinterpret_cast<uint32_t*>(&b);
                }
                *reinterpret_cast<uint4*>(
                    reinterpret_cast<__nv_bfloat16*>(A.out) + at) =
                    make_uint4(p[0], p[1], p[2], p[3]);
            }
        }
}

template <int WARPS_M, int MT, bool E5M2_W>
cudaError_t launch_tile(const Args& A, cudaStream_t stream) {
    using T = Tile<WARPS_M, MT>;
    static bool configured = false;      // per instance; the attribute sticks
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            w8a8_gemm_kernel<WARPS_M, MT, E5M2_W>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    // token tiles fastest: the blocks that read one column tile's weights
    // run together, so each weight byte comes from device memory once
    const long long ntiles = (A.n + BN - 1) / BN;
    if (ntiles > 65535) return cudaErrorInvalidValue;
    dim3 grid((unsigned)((A.m + T::BM - 1) / T::BM), (unsigned)ntiles,
              A.splits);
    w8a8_gemm_kernel<WARPS_M, MT, E5M2_W>
        <<<grid, T::THREADS, T::SMEM, stream>>>(A);
    return cudaGetLastError();
}

// The row tile: 16, 32 or 64 rows on four warps (one warp column of MT
// m16 tiles each) up to M = 64, 128 rows on eight warps above.
template <bool E5M2_W>
cudaError_t launch(const Args& A, int tile_rows, cudaStream_t stream) {
    switch (tile_rows) {
        case 16: return launch_tile<1, 1, E5M2_W>(A, stream);
        case 32: return launch_tile<1, 2, E5M2_W>(A, stream);
        case 64: return launch_tile<1, 4, E5M2_W>(A, stream);
        case 128: return launch_tile<2, 4, E5M2_W>(A, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// P2.  fmt: 0 e4m3, 1 e5m2.  x (m, k) bf16, q (m, k) bytes, s (m,) f32.
extern "C" int fp8_quantize_rows(const void* x, void* q, void* s, int m,
                                 int k, int fmt, void* stream) {
    if (m < 1 || m > 2147483647 || k < 1) return (int)cudaErrorInvalidValue;
    const int vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                    && reinterpret_cast<uintptr_t>(q) % 8 == 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    auto* qb = reinterpret_cast<uint8_t*>(q);
    auto* sf = reinterpret_cast<float*>(s);
    if (fmt == 0)
        quantize_rows_kernel<fp8::E4M3><<<m, Q_THREADS, 0, st>>>(xb, qb, sf,
                                                                k, vec);
    else if (fmt == 1)
        quantize_rows_kernel<fp8::E5M2><<<m, Q_THREADS, 0, st>>>(xb, qb, sf,
                                                                k, vec);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// P1.  w_fmt: 0 e4m3, 1 e5m2.  k % 32 == 0, n % 16 == 0, 16-byte aligned
// xq and w8 (checked by kernels/qmatmul.py::w8a8_matmul and here);
// tile_rows 16, 32, 64 or 128; kper a multiple of 128; promote >= 1 k32
// steps.  ws / counters as for K3 (split_k.cuh) when splits > 1.
extern "C" int fp8_w8a8_gemm(const void* xq, const void* w8, const void* xs,
                             const void* s, void* out, int m, int n, int k,
                             int w_fmt, int out_f32, int tile_rows,
                             int splits, int kper, int promote, void* ws,
                             void* counters, void* stream) {
    if (m < 1 || n < 1 || k < 1 || k % 32 || n % 16 || promote < 1
        || splits < 1 || splits > MAX_SPLITS || kper % BK
        || (long long)splits * kper < k
        || (long long)(splits - 1) * kper >= k
        || reinterpret_cast<uintptr_t>(xq) % 16
        || reinterpret_cast<uintptr_t>(w8) % 16
        || reinterpret_cast<uintptr_t>(out) % 16
        || (splits > 1 && (ws == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    Args A;
    A.xq = reinterpret_cast<const uint8_t*>(xq);
    A.w = reinterpret_cast<const uint8_t*>(w8);
    A.xs = reinterpret_cast<const float*>(xs);
    A.s = reinterpret_cast<const float*>(s);
    A.out = out;
    A.ws = reinterpret_cast<float*>(ws);
    A.counters = reinterpret_cast<int*>(counters);
    A.m = m; A.n = n; A.k = k;
    A.splits = splits; A.kper = kper; A.promote = promote;
    A.out_f32 = out_f32;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (w_fmt == 0) return (int)launch<false>(A, tile_rows, st);
    if (w_fmt == 1) return (int)launch<true>(A, tile_rows, st);
    return (int)cudaErrorInvalidValue;
}
