// The general main loop of the weight-only-quantized GEMMs K3
// (dequant_matmul.cu) and K5 (int4_matmul.cu):  out[M,N] = (x[M,K] bf16 @
// W[K,N]) with W held in device memory as 8-bit or packed 4-bit payloads.
//
// What bounds it on an H100: at decode (M <= 64) the bytes of W, read once;
// at prefill (M in the thousands) the bf16 tensor-core rate.  The design:
//
// * One block of 128 threads owns a BM x 64 output tile and walks K in slabs
//   of 64.  Each thread fetches 16 payload bytes of two adjacent K rows (one
//   16-byte load per row), converts them to bf16 IN REGISTERS and stores the
//   pair (w[k][n], w[k+1][n]) as one 32-bit word of shared memory, which is
//   exactly one B operand register of mma.sync.m16n8k16.  No bf16 copy of W
//   ever exists in device memory and each payload byte is converted once.
// * The next slab's global loads are started before the current slab's MMAs
//   and held in registers across them.
// * Ragged M, N and K are handled with predicates (zero fill), never with
//   padded copies of the operands.
// * Shapes that TMA can address (K % 8 == 0, N % 16 == 0, 16-byte aligned
//   operands) take the streaming loop of w_stream.cuh instead, decode and
//   prefill (TMA ring, wgmma with the converted weight as the A operand);
//   this kernel serves the rest (qmatmul.py::weight_gemm_plan decides
//   before the launch).
// * Split-K: when the output has fewer tiles than the card has SMs (decode
//   with N = 1024), gridDim.z blocks share one tile's K range.  Each writes
//   its f32 partial to a workspace; the block that arrives last at the
//   tile's counter (split_k.cuh) adds the partials in split order 0..S-1
//   (so the result does not depend on which block was last), applies the
//   epilogue and resets the counter.  One launch, deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_k.cuh"

namespace wg {

constexpr int BN = 64;         // output columns per block
constexpr int BK = 64;         // K rows per slab
constexpr int THREADS = 128;   // 4 warps
constexpr int XS = BK + 8;     // bf16 per row of the x tile (conflict-free)
constexpr int WS = BN + 8;     // words per row of the packed W tile

struct Args {
    const __nv_bfloat16* x;    // (M, K) row-major (f16 bits for W8F16)
    const void* w;             // payload, row-major, N columns
    const float* s;            // (N,) or (K/group, N) scales
    const float* rs = nullptr; // (M,) row scales (W8A8), or null
    void* out;                 // (M, N) bf16 or f32
    float* ws;                 // (splits, M, N) partials, splits > 1 only
    int* counters;             // one per output tile, zero between launches
    int m, n, k;
    int splits, kper;          // K rows per split, a multiple of BK
    int group;                 // K rows per scale group; 0: per column
    int vec_x, vec_w;          // 16-byte loads are legal for x / w
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
    return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_out(void* out, bool f32, size_t i,
                                          float v) {
    if (f32) reinterpret_cast<float*>(out)[i] = v;
    else reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

constexpr int MAX_SPLITS = 8;

// The tail of both kernels.  Elements 2h, 2h + 1 of acc[i][j] are row
// row0 + 16 i + g + 8 h, columns col0 + 8 j + 2 q and the next.  With
// split-K the block first parks its partial, and the last block to arrive
// sums the partials in split order; all of a thread's partial loads are
// started before the first sum, so the fix-up costs one round trip to the
// L2, not one per split.
template <class W, int MT, int NT, bool OUT_F32>
__device__ __forceinline__ void epilogue(const Args& A, float (&acc)[MT][NT][4],
                                         int row0, int col0, int* is_last) {
    const int t = threadIdx.x, lane = t & 31;
    const int g = lane >> 2, q = lane & 3;
    // fn(v0, v1, index of v0, row, column of v0, whether v1's column
    // exists)
    auto for_each = [&](auto&& fn) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + i * 16 + g + 8 * h;
                    const int col = col0 + j * 8 + q * 2;
                    if (row < A.m && col < A.n)
                        fn(acc[i][j][2 * h], acc[i][j][2 * h + 1],
                           (size_t)row * A.n + col, row, col,
                           col + 1 < A.n);
                }
    };

    if (A.splits > 1) {
        const size_t plane = (size_t)A.m * A.n;
        float* mine = A.ws + blockIdx.z * plane;
        for_each([&](float& v0, float& v1, size_t at, int, int, bool two) {
            mine[at] = v0;
            if (two) mine[at + 1] = v1;
        });
        if (!splitk::last_of_tile(A.counters, A.splits, is_last)) return;
        for_each([&](float& v0, float& v1, size_t at, int, int, bool two) {
            float2 part[MAX_SPLITS];
#pragma unroll
            for (int z = 0; z < MAX_SPLITS; ++z) {
                part[z] = make_float2(0.f, 0.f);
                if (z < A.splits) {
                    const float* p = A.ws + z * plane + at;
                    part[z].x = __ldcg(p);
                    if (two) part[z].y = __ldcg(p + 1);
                }
            }
            v0 = part[0].x;
            v1 = part[0].y;
#pragma unroll
            for (int z = 1; z < MAX_SPLITS; ++z)
                if (z < A.splits) {
                    v0 += part[z].x;
                    v1 += part[z].y;
                }
        });
        splitk::release_tile(A.counters);
    }
    for_each([&](float& v0, float& v1, size_t at, int row, int col,
                 bool two) {
        float s0 = W::epilogue_scale(A, col);
        float s1 = two ? W::epilogue_scale(A, col + 1) : 0.f;
        if (A.rs != nullptr) {      // W8A8: acc * (xs[m] * s[n])
            s0 = __fmul_rn(A.rs[row], s0);
            s1 = __fmul_rn(A.rs[row], s1);
        }
        const float r0 = v0 * s0;
        const float r1 = two ? v1 * s1 : 0.f;
        store_out(A.out, OUT_F32, at, r0);
        if (two) store_out(A.out, OUT_F32, at + 1, r1);
    });
}

// W is a policy with
//   F16                                            f16 x and weight pairs
//                                                  (mma.sync f16), else bf16
//   struct Regs;                                   one thread's payload
//   static void fetch(Regs&, const Args&, int k0, int kend, int n0, int t);
//   static void stash(const Regs&, const Args&, int k0, int n0, int t,
//                     uint32_t (*wp)[WS]);         convert, pair, store
//   static float epilogue_scale(const Args&, int col);
template <class W, int BM, int WARPS_M, bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
w_gemm_kernel(const Args A) {
    constexpr int WARPS_N = 4 / WARPS_M;
    constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
    constexpr int MT = WTM / 16, NT = WTN / 8;
    constexpr int XV = BM * (BK / 8) / THREADS;    // 16-byte x loads a thread
    static_assert(MT >= 1 && NT >= 1 && XV >= 1, "tile too small");

    __shared__ __align__(16) __nv_bfloat16 xs[BM][XS];
    __shared__ __align__(16) uint32_t wp[BK / 2][WS];
    __shared__ int is_last;

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int kbeg = blockIdx.z * A.kper;
    const int kend = min(A.k, kbeg + A.kper);

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    uint4 xr[XV];
    typename W::Regs wr;

    auto fetch_x = [&](int k0) {
#pragma unroll
        for (int i = 0; i < XV; ++i) {
            const int v = t + i * THREADS;
            const int row = m0 + v / (BK / 8), kc = k0 + (v % (BK / 8)) * 8;
            uint4 val = make_uint4(0, 0, 0, 0);
            if (row < A.m) {
                const __nv_bfloat16* p = A.x + (size_t)row * A.k + kc;
                if (A.vec_x && kc + 8 <= kend) {
                    val = *reinterpret_cast<const uint4*>(p);
                } else {
                    unsigned short h[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        h[e] = (kc + e < kend)
                            ? reinterpret_cast<const unsigned short*>(p)[e]
                            : (unsigned short)0;
                    val.x = h[0] | ((uint32_t)h[1] << 16);
                    val.y = h[2] | ((uint32_t)h[3] << 16);
                    val.z = h[4] | ((uint32_t)h[5] << 16);
                    val.w = h[6] | ((uint32_t)h[7] << 16);
                }
            }
            xr[i] = val;
        }
    };
    auto stash_x = [&]() {
#pragma unroll
        for (int i = 0; i < XV; ++i) {
            const int v = t + i * THREADS;
            *reinterpret_cast<uint4*>(&xs[v / (BK / 8)][(v % (BK / 8)) * 8]) =
                xr[i];
        }
    };

    if (kbeg < kend) {
        fetch_x(kbeg);
        W::fetch(wr, A, kbeg, kend, n0, t);
    }
    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        stash_x();
        W::stash(wr, A, k0, n0, t, wp);
        __syncthreads();
        if (k0 + BK < kend) {
            fetch_x(k0 + BK);
            W::fetch(wr, A, k0 + BK, kend, n0, t);
        }
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int r = wm + i * 16 + g;
                a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + q * 2]);
                a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + q * 2]);
                a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 8 + q * 2]);
                a[i][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 8 + q * 2]);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int c = wn + j * 8 + g;
                const uint32_t b0 = wp[kk / 2 + q][c];
                const uint32_t b1 = wp[kk / 2 + 4 + q][c];
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    if constexpr (W::F16)
                        mma_f16(acc[i][j], a[i], b0, b1);
                    else
                        mma_bf16(acc[i][j], a[i], b0, b1);
                }
            }
        }
        __syncthreads();
    }

    epilogue<W, MT, NT, OUT_F32>(A, acc, m0 + wm, n0 + wn, &is_last);
}

// cp.async helpers (the convert study T1, kexp_convert.cu, streams with them).

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
    // 16 bytes global -> shared; with pred false nothing is read and the
    // 16 bytes are zero-filled
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    const int bytes = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Launch the general kernel with the row tile that fits M: 16 rows for
// M <= 16, 64 up to 64, 128 beyond.  grid.y * BM covers M; the caller has
// checked grid limits.
template <class W, bool OUT_F32>
cudaError_t launch(const Args& A, cudaStream_t stream) {
    const int tiles_n = (A.n + BN - 1) / BN;
    if (A.m <= 16) {
        dim3 grid(tiles_n, 1, A.splits);
        w_gemm_kernel<W, 16, 1, OUT_F32><<<grid, THREADS, 0, stream>>>(A);
    } else if (A.m <= 64) {
        dim3 grid(tiles_n, 1, A.splits);
        w_gemm_kernel<W, 64, 2, OUT_F32><<<grid, THREADS, 0, stream>>>(A);
    } else {
        dim3 grid(tiles_n, (A.m + 127) / 128, A.splits);
        w_gemm_kernel<W, 128, 2, OUT_F32><<<grid, THREADS, 0, stream>>>(A);
    }
    return cudaGetLastError();
}

}  // namespace wg
