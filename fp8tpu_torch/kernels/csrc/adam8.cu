// P3: one parameter leaf's whole 8-bit AdamW update, in place.
//
// No TPU counterpart: the JAX package's 8-bit optimizer
// (fp8tpu/training/opt8.py) is XLA ops fused into its jitted train step.
// Run eagerly it would be ~20 elementwise launches a leaf, each a pass over
// the state; this kernel is one pass.  The function, per leaf of n
// elements, its moments (nblocks, 256) int8 m / e4m3 v payloads and
// (nblocks,) f32 scales, flat in the leaf's order and zero-padded:
//
//   m   = b1 * m_q * m_s + (1 - b1) * g
//   v   = b2 * v_q * v_s + (1 - b2) * g * g
//   upd = (m / bc1) / (sqrt(v / bc2) + eps)
//   m_s = max(amax|m|, 1e-30) / 127,  m_q = round_half_even(clip(m / m_s))
//   v_s = max(amax|v|, 1e-30) / 448,  v_q = e4m3(clip(v / v_s))
//   mode 0: p = p + (-lr) * upd
//   mode 1: p = p + (-lr) * (upd + wd * p)
//   mode 2: p = upd                      (the functional form's output)
//
// bound on an H100: its bytes, 16 an element with f32 p and g (p read and
// written, g read, one byte each of m and v read and written), 3.35 TB/s.
//
// Design, simple first: one warp a block of 256 elements; the block's
// absmax by a warp max over the magnitudes' bits (a max is exact in any
// order, so the scales are the plain version's bits); a grid-stride loop
// over the leaf's blocks.  On an aligned contiguous leaf lane l holds
// elements 8l .. 8l + 7 (two 16-byte loads of p and g, one 8-byte load of
// each payload, the same stores); otherwise lane l holds l + 32 k, so each
// 4-byte access of the warp is one contiguous run.  The padded tail reads
// as a zero gradient and writes no parameter.  A leaf may come as a 2-D
// strided view (a Dense weight updated in the JAX package's (in, out)
// order): element i is read at (i / cols) * s0 + (i % cols) * s1.
//
// The rounding is XLA's on the CPU, op by op, as in the plain version
// (kernels/adam8.py::adam8_update_plain): every product, sum, quotient and
// root rounded once (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn: nvcc
// would otherwise contract b1 * x + c * g into an fma), every f32
// subnormal input and result flushed (XLA's DAZ / FTZ; (1 - b2) g g of a
// small gradient is one), the int8 code by __float2int_rn (half to even,
// as jnp.round), the clip before the e4m3 convert, cast.cuh's RNE onto the
// e4m3 grid, NaNs by the host's rules.  bc1 and bc2 come from the host.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cast.cuh"

namespace {

constexpr int BLOCK = 256;          // elements a block (one warp)
constexpr int PER_LANE = BLOCK / 32;
constexpr int THREADS = 256;        // 8 warps, 8 blocks of the leaf at a time

struct Args {
    float b1, omb1, b2, omb2, eps, bc1, bc2, wd, neg_lr;
};

// a + b under DAZ / FTZ with the host's NaN rules
__device__ __forceinline__ float add_ftz(float a, float b) {
    if (isnan(a)) return fp8::quiet(a);
    if (isnan(b)) return fp8::quiet(b);
    const float r = __fadd_rn(fp8::flush(a), fp8::flush(b));
    return isnan(r) ? __uint_as_float(0xFFC00000u) : fp8::flush(r);
}

__device__ __forceinline__ float sqrt_ftz(float a) {
    if (isnan(a)) return fp8::quiet(a);
    const float r = __fsqrt_rn(fp8::flush(a));
    return isnan(r) ? __uint_as_float(0xFFC00000u) : fp8::flush(r);
}

// the block's absmax over the warp: magnitudes' bits order as integers
// (a NaN above +inf, as torch.amax and jnp.max propagate it)
__device__ __forceinline__ float warp_amax(const float (&x)[PER_LANE]) {
    uint32_t mx = 0u;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k)
        mx = max(mx, __float_as_uint(x[k]) & 0x7FFFFFFFu);
    return __uint_as_float(__reduce_max_sync(0xFFFFFFFFu, mx));
}

// max(amax, 1e-30) / gmax as XLA computes it (DAZ on the amax)
__device__ __forceinline__ float block_scale(float amax, float gmax) {
    const float a = fp8::flush(amax);
    return fp8::div_ftz(isnan(a) ? a : fmaxf(a, 1e-30f), gmax);
}

__device__ __forceinline__ float clip(float v, float top) {
    return isnan(v) ? v : fminf(fmaxf(v, -top), top);
}

__device__ __forceinline__ int8_t int8_code(float y) {
    return (int8_t)__float2int_rn(clip(y, 127.0f));
}

__device__ __forceinline__ uint8_t e4m3_code(float y) {
    const uint8_t sign = (__float_as_uint(y) >> 24) & 0x80u;
    if (isnan(y)) return sign | 0x7Fu;
    const float g = fp8::round_grid<fp8::E4M3>(fp8::flush(clip(y, 448.0f)));
    return (uint8_t)__nv_cvt_float_to_fp8(g, __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ float e4m3_value(uint8_t c) {
    __nv_fp8_e4m3 v;
    v.__x = c;
    return static_cast<float>(v);
}

// How a warp's lanes hold the 256 elements of a block, and how element i
// of the leaf's order is found in memory.
enum Walk : int {
    VECTOR = 0,      // lane l holds elements 8l .. 8l + 7: 16-byte loads
    STRIDED = 1,     // lane l holds l + 32 k: 4-byte loads, any alignment;
                     // element i at (i / cols) s0 + (i % cols) s1
};

template <int W>
__device__ __forceinline__ int elem(int lane, int k) {
    return W == VECTOR ? 8 * lane + k : lane + 32 * k;
}

template <int W>
__device__ __forceinline__ long long offset(long long i, long long cols,
                                            long long s0, long long s1) {
    return W == STRIDED ? (i / cols) * s0 + (i % cols) * s1 : i;
}

template <int W>
__global__ void __launch_bounds__(THREADS)
adam8_kernel(float* __restrict__ p, const float* __restrict__ g,
             int8_t* __restrict__ mq, float* __restrict__ ms,
             uint8_t* __restrict__ vq, float* __restrict__ vs, long long n,
             long long cols, long long s0, long long s1, Args a, int mode) {
    const int lane = threadIdx.x & 31;
    const long long nb = (n + BLOCK - 1) / BLOCK;
    const long long warps = (long long)gridDim.x * (THREADS / 32);
    for (long long b = (long long)blockIdx.x * (THREADS / 32)
                       + (threadIdx.x >> 5);
         b < nb; b += warps) {
        const long long base = b * BLOCK;
        // a whole chunk of 8 inside the leaf: vector loads and stores
        const bool whole = W == VECTOR && base + 8 * lane + 8 <= n;
        const float sm = fp8::flush(ms[b]), sv = fp8::flush(vs[b]);
        int8_t cm[PER_LANE];
        uint8_t cv[PER_LANE];
        float gi[PER_LANE], pi[PER_LANE];
        if constexpr (W == VECTOR) {
            const uint2 wm = *reinterpret_cast<const uint2*>(
                mq + base + 8 * lane);
            const uint2 wv = *reinterpret_cast<const uint2*>(
                vq + base + 8 * lane);
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                const uint32_t w = k < 4 ? wm.x : wm.y;
                const uint32_t u = k < 4 ? wv.x : wv.y;
                cm[k] = (int8_t)((w >> (8 * (k & 3))) & 0xFFu);
                cv[k] = (uint8_t)((u >> (8 * (k & 3))) & 0xFFu);
            }
        } else {
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                cm[k] = mq[base + elem<W>(lane, k)];
                cv[k] = vq[base + elem<W>(lane, k)];
            }
        }
        if (whole) {
            const float4* gv = reinterpret_cast<const float4*>(
                g + base + 8 * lane);
            const float4* pv = reinterpret_cast<const float4*>(
                p + base + 8 * lane);
            const float4 g0 = gv[0], g1 = gv[1];
            gi[0] = g0.x; gi[1] = g0.y; gi[2] = g0.z; gi[3] = g0.w;
            gi[4] = g1.x; gi[5] = g1.y; gi[6] = g1.z; gi[7] = g1.w;
            if (mode != 2) {
                const float4 p0 = pv[0], p1 = pv[1];
                pi[0] = p0.x; pi[1] = p0.y; pi[2] = p0.z; pi[3] = p0.w;
                pi[4] = p1.x; pi[5] = p1.y; pi[6] = p1.z; pi[7] = p1.w;
            }
        } else {
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                const long long i = base + elem<W>(lane, k);
                const long long o = offset<W>(i, cols, s0, s1);
                gi[k] = i < n ? g[o] : 0.0f;
                pi[k] = i < n && mode != 2 ? p[o] : 0.0f;
            }
        }
        float m[PER_LANE], v[PER_LANE], out[PER_LANE];
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const float dm = fp8::mul_ftz((float)cm[k], sm);
            const float dv = fp8::mul_ftz(e4m3_value(cv[k]), sv);
            m[k] = add_ftz(fp8::mul_ftz(a.b1, dm), fp8::mul_ftz(a.omb1, gi[k]));
            v[k] = add_ftz(fp8::mul_ftz(a.b2, dv),
                           fp8::mul_ftz(fp8::mul_ftz(a.omb2, gi[k]), gi[k]));
            // the parameter (or the update), from the unquantized moments
            const float u = fp8::div_ftz(
                fp8::div_ftz(m[k], a.bc1),
                add_ftz(sqrt_ftz(fp8::div_ftz(v[k], a.bc2)), a.eps));
            if (mode == 2) {
                out[k] = u;
            } else {
                const float d = mode == 1
                    ? add_ftz(u, fp8::mul_ftz(a.wd, pi[k])) : u;
                out[k] = add_ftz(pi[k], fp8::mul_ftz(a.neg_lr, d));
            }
        }
        if (whole) {
            float4* pv = reinterpret_cast<float4*>(p + base + 8 * lane);
            pv[0] = make_float4(out[0], out[1], out[2], out[3]);
            pv[1] = make_float4(out[4], out[5], out[6], out[7]);
        } else {
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                const long long i = base + elem<W>(lane, k);
                if (i < n) p[offset<W>(i, cols, s0, s1)] = out[k];
            }
        }
        // requantize per block
        const float sm2 = block_scale(warp_amax(m), 127.0f);
        const float sv2 = block_scale(warp_amax(v), 448.0f);
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            cm[k] = int8_code(fp8::div_ftz(m[k], sm2));
            cv[k] = e4m3_code(fp8::div_ftz(v[k], sv2));
        }
        if constexpr (W == VECTOR) {
            uint32_t w[2] = {0u, 0u}, u[2] = {0u, 0u};
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                w[k >> 2] |= (uint32_t)(uint8_t)cm[k] << (8 * (k & 3));
                u[k >> 2] |= (uint32_t)cv[k] << (8 * (k & 3));
            }
            *reinterpret_cast<uint2*>(mq + base + 8 * lane) =
                make_uint2(w[0], w[1]);
            *reinterpret_cast<uint2*>(vq + base + 8 * lane) =
                make_uint2(u[0], u[1]);
        } else {
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                mq[base + elem<W>(lane, k)] = cm[k];
                vq[base + elem<W>(lane, k)] = cv[k];
            }
        }
        if (lane == 0) {
            ms[b] = sm2;
            vs[b] = sv2;
        }
    }
}

}  // namespace

// n elements of p and g (f32); mq, vq (ceil(n / 256), 256) int8 / e4m3
// bytes; ms, vs (ceil(n / 256),) f32.  cols, s0, s1: s0 == 0 for a
// contiguous leaf, else the strides of a 2-D view with rows of ``cols``.
// mode 0 apply, 1 apply with weight decay, 2 store the update into p.
extern "C" int adam8_update(void* p, const void* g, void* mq, void* ms,
                            void* vq, void* vs, long long n, long long cols,
                            long long s0, long long s1, float b1, float omb1,
                            float b2, float omb2, float eps, float bc1,
                            float bc2, float wd, float neg_lr, int mode,
                            void* stream) {
    if (n < 1 || cols < 1 || mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    const Args a{b1, omb1, b2, omb2, eps, bc1, bc2, wd, neg_lr};
    const long long nb = (n + BLOCK - 1) / BLOCK;
    const long long want = (nb + THREADS / 32 - 1) / (THREADS / 32);
    const long long cap = (long long)fp8::sm_count() * 16;
    const dim3 grid((unsigned)(want < cap ? want : cap));
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    auto* pf = reinterpret_cast<float*>(p);
    const auto* gf = reinterpret_cast<const float*>(g);
    auto* mqb = reinterpret_cast<int8_t*>(mq);
    auto* msf = reinterpret_cast<float*>(ms);
    auto* vqb = reinterpret_cast<uint8_t*>(vq);
    auto* vsf = reinterpret_cast<float*>(vs);
    // 16-byte accesses need p and g 16-byte aligned (the payloads are
    // whole (nblocks, 256) arrays, aligned by their allocation)
    const bool aligned = (reinterpret_cast<uintptr_t>(p)
                          | reinterpret_cast<uintptr_t>(g)
                          | reinterpret_cast<uintptr_t>(mq)
                          | reinterpret_cast<uintptr_t>(vq)) % 16 == 0;
    if (s0 == 0 && aligned) {
        adam8_kernel<VECTOR><<<grid, THREADS, 0, st>>>(
            pf, gf, mqb, msf, vqb, vsf, n, cols, s0, s1, a, mode);
    } else {
        if (s0 == 0) {          // contiguous but unaligned: one row
            cols = n;
            s0 = n;
            s1 = 1;
        }
        adam8_kernel<STRIDED><<<grid, THREADS, 0, st>>>(
            pf, gf, mqb, msf, vqb, vsf, n, cols, s0, s1, a, mode);
    }
    return (int)cudaGetLastError();
}
