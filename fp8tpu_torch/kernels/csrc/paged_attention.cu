// K4, decode attention over the paged KV pool: flash partials of one query
// token per slot against the slot's mapped pages, read where they lie.
//
// Replaces fp8tpu/kernels/paged_attention.py::_kernel.
//
//   q      (B, KV*G, D)      bf16, pre-scaled by 1/sqrt(D), head h = kv*G + g
//   pool   (P, 2, L, R, D)   int8 / e4m3 / e5m2 / bf16 payloads, R = page*KV,
//                            row r = t*KV + kv (token-major), k at 0, v at 1
//   sc     (P, 2, L, R)      f32 scale of each (token, kv head) vector
//   table  (B, MP)           int32 physical page of each logical page, -1 =
//                            unmapped
//   lens   (B,)              int32 valid tokens of each slot
//
// and returns the UNNORMALISED partials acc (B, KV*G, D), m (B, KV*G),
// l (B, KV*G), all f32, which the caller merges with the fresh token and the
// chunk's side buffer.  Per token t < lens[b] of slot b and kv head:
//
//   s = (sum_d bf16(K[t, d]) * q[g, d]) * ks[t]          f32, scale after the dot
//   m = max(m, max_t s);  alpha = exp(m_old - m_new)
//   p = exp(s - m_new), exactly 0 for t >= lens[b]
//   pv = bf16(p * vs[t])                                  rounded before the dot
//   l = l * alpha + sum_t p;  acc = acc * alpha + sum_t pv * bf16(V[t, :])
//
// An empty slot gives m = -1e30, l = 0, acc = 0.
//
// Design.  The TPU kernel's grid is (slot, page) with the pages in sequence,
// and folds all KV*G heads into one masked (R x KVG) dot per page.  Here a
// block owns one (slot, kv head) and a contiguous share of that slot's
// tokens, in tiles of 128: it reads only that head's rows of a page (D
// payload bytes every KV*D), never the other heads', and nothing at or past
// lens[b].  Page ids are read in the kernel and clamped to [0, P-1], so a
// row of -1 (a retired slot that keeps decoding) reads page 0 and no id
// leads outside the pool; lens is clamped to [0, MP*page].  Nothing is read
// on the host, so a launch can be captured in a CUDA graph.
//
// Bound on an H100: bytes.  A head's tile is 16 KB of K, 16 KB of V and 1 KB
// of scales for 2 * 128 * G * D multiply-adds, about 8 operations a byte at
// G = 4.  K and V rows arrive by cp.async into shared memory (K of the next
// tile while V of this one is multiplied, V of this tile while its K is
// scored), are upcast in registers and multiplied on the SIMT pipes in f32:
// the score phase gives each thread one token (a D-long dot against the G
// queries, broadcast from shared memory), the context phase gives each
// thread one column d (a tile-long dot for each of the G queries), so neither
// needs a reduction across threads beyond the tile's max and exp-sum.
//
// Splits.  With few slots there are fewer (slot, kv head) pairs than SMs, so
// gridDim.x blocks share one pair's tokens.  Each writes its partial to a
// workspace; the block that arrives last at the pair's counter merges the
// partials in split order 0..S-1, so the result does not depend on which
// block was last and a second launch gives the same bits.  The counters are
// zero between launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;          // tokens per tile: one per thread when scored
constexpr int MAX_SPLITS = 16;
constexpr int MAX_D = 128;
constexpr float NEG = -1e30f;

enum Payload { E4M3 = 0, E5M2 = 1, INT8 = 2, BF16 = 3 };

struct Args {
    const __nv_bfloat16* q;
    const unsigned char* pool;
    const float* sc;
    const int* table;
    const int* lens;
    float* acc;
    float* m;
    float* l;
    float* ws_acc;             // (B*KV, splits, G, D), splits > 1 only
    float* ws_m;               // (B*KV, splits, G)
    float* ws_l;               // (B*KV, splits, G)
    int* counters;             // one per (slot, kv head), zero between launches
    int kv, d, p, layers, mp, page, layer, splits;
};

template <int FMT>
__host__ __device__ constexpr int elem_bytes() { return FMT == BF16 ? 2 : 1; }

// element e of a run of payload elements -> f32 (exact for every type)
template <int FMT>
__device__ __forceinline__ float upcast(const unsigned char* run, int e) {
    if constexpr (FMT == INT8) {
        return (float)(signed char)run[e];
    } else if constexpr (FMT == BF16) {
        return __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(run)[e]);
    } else {
        const __half_raw h = __nv_cvt_fp8_to_halfraw(
            (__nv_fp8_storage_t)run[e], FMT == E4M3 ? __NV_E4M3 : __NV_E5M2);
        return __half2float(*reinterpret_cast<const __half*>(&h));
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The pool row (in units of one (token, kv head) vector) that holds logical
// position pos of slot b, for k (sel 0) or v (sel 1).
__device__ __forceinline__ size_t pool_row(const Args& A, int b, int kvh,
                                           int sel, int pos) {
    const int lp = pos / A.page;
    const int t = pos - lp * A.page;
    int pg = A.table[(size_t)b * A.mp + lp];
    pg = min(max(pg, 0), A.p - 1);
    return (((size_t)pg * 2 + sel) * A.layers + A.layer)
               * ((size_t)A.page * A.kv)
           + (size_t)t * A.kv + kvh;
}

// Start the copy of one tile's rows of this head into shared memory: the
// tokens tile0 .. tile0 + n - 1, each row D payload elements, 16 bytes a
// copy; rows lie row_stride bytes apart in shared memory.
template <int FMT>
__device__ __forceinline__ void load_tile(unsigned char* dst, const Args& A,
                                          int b, int kvh, int sel, int tile0,
                                          int n, int tid) {
    const int row_bytes = A.d * elem_bytes<FMT>();
    const int cpr = row_bytes >> 4;               // 16-byte chunks per row
    const int row_stride = row_bytes + 16;
    for (int i = tid; i < n * cpr; i += THREADS) {
        const int t = i / cpr, c = i - t * cpr;
        const size_t r = pool_row(A, b, kvh, sel, tile0 + t);
        cp_async16(dst + t * row_stride + c * 16,
                   A.pool + r * row_bytes + c * 16);
    }
}

template <int FMT, int G>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const Args A) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int ES = elem_bytes<FMT>();
    constexpr int EPC = 16 / ES;                  // elements per 16-byte chunk
    const int D = A.d;
    const int row_stride = D * ES + 16;
    float* qs = reinterpret_cast<float*>(smem);               // [D][G]
    float* pvs = qs + D * G;                                  // [TILE][G]
    float* red_max = pvs + TILE * G;                          // [WARPS][G]
    float* red_sum = red_max + WARPS * G;                     // [WARPS][G]
    unsigned char* kbuf = reinterpret_cast<unsigned char*>(red_sum + WARPS * G);
    unsigned char* vbuf = kbuf + TILE * row_stride;
    __shared__ int is_last;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int len = min(max(A.lens[b], 0), A.mp * A.page);
    const int ntiles = (len + TILE - 1) / TILE;
    const int per = (ntiles + A.splits - 1) / A.splits;
    const int t_begin = split * per;
    const int t_end = min(ntiles, t_begin + per);

    // queries of this kv head as f32, [d][g]
    const __nv_bfloat16* qb =
        A.q + ((size_t)b * A.kv + kvh) * G * D;
    for (int i = tid; i < G * D; i += THREADS) {
        const int g = i / D, d = i - g * D;
        qs[d * G + g] = __bfloat162float(qb[i]);
    }

    float m_run[G], l_run[G], acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        m_run[g] = NEG;
        l_run[g] = 0.f;
        acc[g] = 0.f;
    }

    if (t_begin < t_end)
        load_tile<FMT>(kbuf, A, b, kvh, 0, t_begin * TILE,
                       min(TILE, len - t_begin * TILE), tid);
    cp_async_commit();

    for (int tile = t_begin; tile < t_end; ++tile) {
        const int tile0 = tile * TILE;
        const int n = min(TILE, len - tile0);     // valid tokens, >= 1
        load_tile<FMT>(vbuf, A, b, kvh, 1, tile0, n, tid);
        cp_async_commit();

        // this thread's token: its two scales, then its G scores
        const bool valid = tid < n;
        float ks = 0.f, vs = 0.f;
        if (valid) {
            const size_t rk = pool_row(A, b, kvh, 0, tile0 + tid);
            const size_t rv = pool_row(A, b, kvh, 1, tile0 + tid);
            ks = A.sc[rk];
            vs = A.sc[rv];
        }
        cp_async_wait<1>();                       // K of this tile has landed
        __syncthreads();

        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
        if (valid) {
            const unsigned char* row = kbuf + tid * row_stride;
            for (int c = 0; c < D / EPC; ++c) {
                const uint4 raw = *reinterpret_cast<const uint4*>(row + c * 16);
                const unsigned char* run =
                    reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
                for (int e = 0; e < EPC; ++e) {
                    const float k = upcast<FMT>(run, e);
                    const float* qd = qs + (c * EPC + e) * G;
#pragma unroll
                    for (int g = 0; g < G; ++g) s[g] = fmaf(k, qd[g], s[g]);
                }
            }
        }
        float mx[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            s[g] = valid ? s[g] * ks : NEG;
            mx[g] = s[g];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
            if (lane == 0) red_max[warp * G + g] = mx[g];
        }
        __syncthreads();

        float alpha[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float m_new = m_run[g];
#pragma unroll
            for (int w = 0; w < WARPS; ++w)
                m_new = fmaxf(m_new, red_max[w * G + g]);
            alpha[g] = expf(m_run[g] - m_new);
            m_run[g] = m_new;
            // an explicit 0 for a masked token: with every token masked
            // m_new is still the sentinel and exp(s - m_new) would be 1
            const float p = valid ? expf(s[g] - m_new) : 0.f;
            pvs[tid * G + g] =
                __bfloat162float(__float2bfloat16_rn(p * vs));
            float sum = p;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) red_sum[warp * G + g] = sum;
        }
        __syncthreads();                          // K buffer is free again

        if (tile + 1 < t_end)
            load_tile<FMT>(kbuf, A, b, kvh, 0, tile0 + TILE,
                           min(TILE, len - tile0 - TILE), tid);
        cp_async_commit();
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float sum = red_sum[g];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) sum += red_sum[w * G + g];
            l_run[g] = l_run[g] * alpha[g] + sum;
        }
        cp_async_wait<1>();                       // V of this tile has landed
        __syncthreads();

        if (tid < D) {
            float c[G];
#pragma unroll
            for (int g = 0; g < G; ++g) c[g] = 0.f;
            const unsigned char* col = vbuf + tid * ES;
            for (int t = 0; t < n; ++t) {
                const float v = upcast<FMT>(col + t * row_stride, 0);
                const float* pt = pvs + t * G;
#pragma unroll
                for (int g = 0; g < G; ++g) c[g] = fmaf(pt[g], v, c[g]);
            }
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g] = acc[g] * alpha[g] + c[g];
        }
        __syncthreads();                          // V buffer, pvs, red_* free
    }
    cp_async_wait<0>();

    const size_t pair = (size_t)b * A.kv + kvh;
    if (A.splits == 1) {
        if (tid < D) {
#pragma unroll
            for (int g = 0; g < G; ++g)
                A.acc[(pair * G + g) * D + tid] = acc[g];
        }
        if (tid == 0) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
                A.m[pair * G + g] = m_run[g];
                A.l[pair * G + g] = l_run[g];
            }
        }
        return;
    }

    // this split's partial, then the last block of the pair merges all
    const size_t part = pair * A.splits + split;
    if (tid < D) {
#pragma unroll
        for (int g = 0; g < G; ++g)
            A.ws_acc[(part * G + g) * D + tid] = acc[g];
    }
    if (tid == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            A.ws_m[part * G + g] = m_run[g];
            A.ws_l[part * G + g] = l_run[g];
        }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
        is_last = atomicAdd(&A.counters[pair], 1) == A.splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();

    const size_t first = pair * A.splits;
    float m_tot[G], l_tot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        m_tot[g] = NEG;
        for (int z = 0; z < A.splits; ++z)
            m_tot[g] = fmaxf(m_tot[g], __ldcg(&A.ws_m[(first + z) * G + g]));
        l_tot[g] = 0.f;
        acc[g] = 0.f;
    }
    for (int z = 0; z < A.splits; ++z) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const float w =
                expf(__ldcg(&A.ws_m[(first + z) * G + g]) - m_tot[g]);
            l_tot[g] += __ldcg(&A.ws_l[(first + z) * G + g]) * w;
            if (tid < D)
                acc[g] += __ldcg(&A.ws_acc[((first + z) * G + g) * D + tid])
                          * w;
        }
    }
    if (tid < D) {
#pragma unroll
        for (int g = 0; g < G; ++g)
            A.acc[(pair * G + g) * D + tid] = acc[g];
    }
    if (tid == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            A.m[pair * G + g] = m_tot[g];
            A.l[pair * G + g] = l_tot[g];
        }
        A.counters[pair] = 0;
    }
}

template <int FMT, int G>
cudaError_t launch(const Args& A, int batch, cudaStream_t stream) {
    const int row_stride = A.d * elem_bytes<FMT>() + 16;
    const size_t smem = (size_t)(A.d * G + TILE * G + 2 * WARPS * G)
                            * sizeof(float)
                        + 2 * (size_t)TILE * row_stride;
    if (smem > 48 * 1024) {
        // the most this instantiation can ask for (D = MAX_D)
        static const cudaError_t attr = cudaFuncSetAttribute(
            paged_attention_kernel<FMT, G>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)((MAX_D * G + TILE * G + 2 * WARPS * G) * sizeof(float)
                  + 2 * TILE * (MAX_D * elem_bytes<FMT>() + 16)));
        if (attr != cudaSuccess) return attr;
    }
    const dim3 grid(A.splits, A.kv, batch);
    paged_attention_kernel<FMT, G><<<grid, THREADS, smem, stream>>>(A);
    return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_g(const Args& A, int batch, int g, cudaStream_t stream) {
    switch (g) {
        case 1: return launch<FMT, 1>(A, batch, stream);
        case 2: return launch<FMT, 2>(A, batch, stream);
        case 4: return launch<FMT, 4>(A, batch, stream);
        case 8: return launch<FMT, 8>(A, batch, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// payload: 0 e4m3, 1 e5m2, 2 int8, 3 bf16.  g (query heads per kv head) is
// 1, 2, 4 or 8; d a multiple of 16 up to 128.  ws_* and counters are used
// when splits > 1 (at most 16): counters holds one zeroed int per (slot, kv
// head).
extern "C" int fp8_paged_attention(const void* q, const void* pool,
                                   const void* sc, const void* table,
                                   const void* lens, void* acc, void* m,
                                   void* l, int batch, int kv, int g, int d,
                                   int p, int layers, int mp, int page,
                                   int layer, int payload, int splits,
                                   void* ws_acc, void* ws_m, void* ws_l,
                                   void* counters, void* stream) {
    if (batch < 1 || batch > 65535 || kv < 1 || kv > 65535 || d < 16
            || d > MAX_D || d % 16 != 0 || p < 1 || mp < 1 || page < 1
            || layer < 0 || layer >= layers || splits < 1
            || splits > MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    Args A;
    A.q = reinterpret_cast<const __nv_bfloat16*>(q);
    A.pool = reinterpret_cast<const unsigned char*>(pool);
    A.sc = reinterpret_cast<const float*>(sc);
    A.table = reinterpret_cast<const int*>(table);
    A.lens = reinterpret_cast<const int*>(lens);
    A.acc = reinterpret_cast<float*>(acc);
    A.m = reinterpret_cast<float*>(m);
    A.l = reinterpret_cast<float*>(l);
    A.ws_acc = reinterpret_cast<float*>(ws_acc);
    A.ws_m = reinterpret_cast<float*>(ws_m);
    A.ws_l = reinterpret_cast<float*>(ws_l);
    A.counters = reinterpret_cast<int*>(counters);
    A.kv = kv; A.d = d; A.p = p; A.layers = layers; A.mp = mp;
    A.page = page; A.layer = layer; A.splits = splits;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (payload) {
        case E4M3: return (int)launch_g<E4M3>(A, batch, g, st);
        case E5M2: return (int)launch_g<E5M2>(A, batch, g, st);
        case INT8: return (int)launch_g<INT8>(A, batch, g, st);
        case BF16: return (int)launch_g<BF16>(A, batch, g, st);
    }
    return (int)cudaErrorInvalidValue;
}
