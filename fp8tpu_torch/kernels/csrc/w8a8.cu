// The W8A8 serving linear (matmul_impl="direct"): two kernels of the port
// that have no TPU counterpart.  The JAX package computes both functions as
// XLA ops (fp8tpu/serve/model.py::fp8_linear's "direct" branch and
// ::_quantize_act); the port gives them hand-written kernels because every
// serving linear of the port is one, and because W8A8 is only worth having
// on this card through the fp8 tensor cores.
//
// P2, quantize_rows:  xq[m, :] = fp8(clip(x[m, :] / s[m])),
//                     s[m] = amax_m > 0 ? amax_m / max_normal : 1
// x (M, K) bf16, xq (M, K) e4m3 (or e5m2) bytes, s (M,) f32; or xq the
// codes' exact values as f16, written where the byte would be:
// the codes in the type the int8 route's GEMM reads (K3's int8 route,
// dequant_matmul.cu), so that no convert launch lies between the two.
// Bound: its bytes, 3 K bytes a row (4 K with 2-byte codes).  One pass:
// each row is loaded once into
// registers with 16-byte loads (8 bf16 a chunk, at most Q_MAX_CHUNKS a
// thread), its amax taken as the largest magnitude's bits by a warp
// reduction (and, where a row spans several warps, one exchange through
// shared memory), then quantized and written from the registers.  The host
// sizes the block to the row and to M: gw warps a row (the fewest that
// hold it, more while M is too small to fill the card) and 8 / gw rows a
// block.  Rows wider than the registers hold, or not in whole aligned
// chunks, take the looped path of the same kernel (C = 0: one block a
// row, the amax over the row, then the quantize reading it again).  The
// results are bit for bit the plain version's
// (kernels/qmatmul.py::quantize_rows_plain): the amax flushed (XLA's DAZ: a
// row of f32 subnormals takes scale 1), the scale a correctly rounded
// divide (never a multiply by a reciprocal), x flushed before its divide,
// the host's NaN rules, cast.cuh's RNE onto the grid after the clip.  A
// row without NaNs with a finite scale of at least 2^-60 (every row of a
// served model) takes a fast path with the same results: no NaN or
// infinity can occur in it, and each element's divide is a product and two
// corrections of two fmas each (quot_fast), correctly rounded for every
// divisor.  Others take cast.cuh's rules element by element.  A code's
// f16 value is the hardware convert of two codes (cvt.rn.f16x2.e4m3x2);
// a NaN code's is the sign and the quiet NaN 0x7E00, as XLA's convert
// writes it.  One
// rule is the port's own: a row whose amax lies in (0, max_normal 2^-126)
// keeps its subnormal scale, where XLA flushes the quotient to 0 and stores
// +-max and NaN codes (ROADMAP §3).
//
// P1, w8a8_gemm:  out[M, N] = round((sum_k xq[m, k] w8[k, n]) (xs[m] s[n]))
// xq (M, K) e4m3, w8 (K, N) e4m3 or e5m2 with N contiguous (the serving
// artifact's layout, unchanged), xs (M,) and s (N,) f32, out bf16 or f32.
// Bound on an H100: the bytes of w8 at decode (M <= 64: 45 MB for the gate
// projection, 13.5 us at 3.35 TB/s), the fp8 tensor-core rate at prefill
// (2 M N K / 1979 TFLOP/s: 93 us for the gate projection at M = 2048).
// P1 is the FP8 payload kind of the streaming loop (w_stream.cuh), in both
// of its forms: the decode form at M <= 64 (one consumer warpgroup, n = M
// rounded up to 8-64, two blocks an SM) and the prefill route above (128
// columns x 128 tokens on two warpgroups, one block an SM), a producer
// warp keeping a TMA ring of raw weight bytes and xq rows on mbarriers.
// The operands are swapped (out^T = W^T xq^T): wgmma.m64nNk32 takes the
// weight bytes as its register A operand, gathered from the stage by
// ldmatrix.trans and two byte permutes a register (no convert, no
// transposed copy of the weight anywhere: 8-bit shared-memory operands
// must be K-major), and xq's e4m3 bytes as the K-major B operand straight
// from the stage (one 128-byte swizzled TMA row a token and stage).  The
// fp8 tensor cores keep 13 bits below a k32 step's largest addend
// (chip_smoke.py's w8a8_probe; DeepSeek-V3 §3.3.2 reports about 14), so
// every ``promote`` k32 steps (qmatmul.py::W8A8_PROMOTE = 4: 128 K rows)
// the chunk is added into an f32 register sum with ordinary adds, and
// every launch is held to an f64 bound over those promotion edges that
// allows for the tensor cores' truncation.  Shorter chunks (1 or 2 steps,
// built only for the probes) leave a decode step's layers as far from the
// f32 plain version (the truncation inside one step dominates) and cost
// the prefill route 6-32% (chip_smoke.py's w8a8_p1probe).  The f32 sums are cuBLASLt's
// fp8 GEMM's bit for bit (chip_smoke.py's w8a8 phase).  Split-K over
// gridDim.z, deterministic (split_k.cuh).  No allocation, no host
// synchronisation: a launch can be captured in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cast.cuh"
#include "w_stream.cuh"

namespace {

// -- P2 ----------------------------------------------------------------------

constexpr int Q_THREADS = 256;
constexpr int Q_WARPS = Q_THREADS / 32;
constexpr int Q_MAX_CHUNKS = 8;     // 16-byte chunks a thread holds

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

// The row's largest |x| as bf16 magnitude bits (above 0x7F80: a NaN):
// magnitudes order as integers, the two elements of a word apart.
__device__ __forceinline__ void chunk_max(const uint4& v, uint32_t& lo,
                                          uint32_t& hi) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        lo = max(lo, w[e] & 0x7FFFu);
        hi = max(hi, w[e] & 0x7FFF0000u);
    }
}

// the 8 codes of a chunk of 8 bf16 at scale sc, cast.cuh's rules element
// by element (any row)
template <int F>
__device__ __forceinline__ uint2 chunk_codes(const uint4& v, float sc) {
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
    return make_uint2(o[0], o[1]);
}

// The fast path, for a row without NaNs whose scale lies in [2^-60,
// FLT_MAX] (so no element is infinite either): the same codes with less
// work an element.
// |x| / s rounded once from y = RN(1 / s): q0 = RN(a y), then two
// corrections q' = RN(q + RN(a - s q) y), as P3's divides (adam8.cu's
// header has the proof): q0 lies within 2 ulp of a / s, the first
// correction makes it faithful, and from a faithful quotient the second
// is Markstein's theorem (the remainder a - s q exact, RN(q + r y) =
// RN(a / s)).  One correction needs q0 faithful, which RN(a y) is not for
// every divisor (trap 73).  No step underflows wherever the quotient is at
// least 2^-20 (a >= 2^-80); smaller quotients, and those of bf16
// subnormals (a flushed divide's zeros), take the code 0 either way.
// Then the clip, cast.cuh's RNE onto the grid and the convert of |x|'s
// quotient; the sign goes onto the code.
__device__ __forceinline__ float quot_fast(float a, float s, float y) {
    const float q0 = __fmul_rn(a, y);
    const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, a), y, q0);
    return __fmaf_rn(__fmaf_rn(-q1, s, a), y, q1);
}

// the two codes of a word's two bf16, in its low 16 bits
template <int F>
__device__ __forceinline__ uint32_t codes2_fast(uint32_t w, float s,
                                                float y) {
    constexpr float top = fp8::Hw<F>::top;
    const float g0 = fp8::round_grid<F>(fminf(
        quot_fast(__uint_as_float((w << 16) & 0x7FFFFFFFu), s, y), top));
    const float g1 = fp8::round_grid<F>(fminf(
        quot_fast(__uint_as_float(w & 0x7FFF0000u), s, y), top));
    const uint32_t c = __nv_cvt_float2_to_fp8x2(
        make_float2(g0, g1), __NV_SATFINITE,
        F == fp8::E4M3 ? __NV_E4M3 : __NV_E5M2);     // g0 in the low byte
    return c | ((w >> 8) & 0x80u) | ((w >> 16) & 0x8000u);
}

template <int F>
__device__ __forceinline__ uint2 chunk_codes_fast(const uint4& v, float s,
                                                  float y) {
    return make_uint2(codes2_fast<F>(v.x, s, y)
                          | (codes2_fast<F>(v.y, s, y) << 16),
                      codes2_fast<F>(v.z, s, y)
                          | (codes2_fast<F>(v.w, s, y) << 16));
}

// What P2 writes a code as: its byte, or its exact value as f16.
enum Codes : int { Q_BYTES = 0, Q_F16 = 1 };

// Two codes (the low one in bits 0-7) as an f16x2 word of their values, by
// the hardware convert (no NaN code).
template <int F>
__device__ __forceinline__ uint32_t widen2(uint32_t two) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(two & 0xFFFFu),
        F == fp8::E4M3 ? __NV_E4M3 : __NV_E5M2);
    return (uint32_t)h.x | ((uint32_t)h.y << 16);
}

// One code's f16 value, a NaN code as XLA's convert writes it (the code's
// sign on the quiet NaN).
template <int F>
__device__ __forceinline__ uint16_t widen1(uint32_t code) {
    const bool nan = F == fp8::E4M3 ? (code & 0x7Fu) == 0x7Fu
                                    : (code & 0x7Fu) > 0x7Cu;
    if (nan) return (uint16_t)(((code & 0x80u) << 8) | 0x7E00u);
    return (uint16_t)(widen2<F>(code) & 0xFFFFu);
}

// Stores the 8 codes of a chunk (``c``: byte 0 the first) at element i of
// row ``out``; ``nan`` where a code may be a NaN (the slow path).
template <int F, int OUT>
__device__ __forceinline__ void store_chunk(void* out, int i, uint2 c,
                                           bool nan) {
    if constexpr (OUT == Q_BYTES) {
        *reinterpret_cast<uint2*>(reinterpret_cast<uint8_t*>(out) + i) = c;
    } else {
        uint32_t w[4];
        if (nan) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const uint32_t two = (e < 2 ? c.x : c.y) >> (16 * (e & 1));
                w[e] = widen1<F>(two & 0xFFu)
                       | ((uint32_t)widen1<F>((two >> 8) & 0xFFu) << 16);
            }
        } else {
            w[0] = widen2<F>(c.x);
            w[1] = widen2<F>(c.x >> 16);
            w[2] = widen2<F>(c.y);
            w[3] = widen2<F>(c.y >> 16);
        }
        *reinterpret_cast<uint4*>(reinterpret_cast<uint16_t*>(out) + i) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// Rows of ``gw`` warps (1, 2, 4 or 8), Q_WARPS / gw rows a block.  C > 0:
// the register path, C chunks of 8 bf16 a thread (k % 8 == 0, x 16-byte
// and q 8-byte (2-byte codes: 16-byte) aligned, k <= 8 C 32 gw).  C == 0:
// the looped path, gw = 8 (one row a block), vec choosing 16-byte or
// scalar accesses.  The amax is the largest magnitude's bits (for a row
// with NaNs of several payloads the largest payload, where a float max
// keeps the first it meets).
template <int F, int C, int OUT>
__global__ void __launch_bounds__(Q_THREADS)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     void* __restrict__ q, float* __restrict__ s, int m,
                     int k, int gw, int vec) {
    __shared__ uint32_t red[Q_WARPS];
    constexpr int QB = OUT == Q_BYTES ? 1 : 2;      // bytes a code
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const long long row = (long long)blockIdx.x * (Q_WARPS / gw) + warp / gw;
    const int tr = (warp % gw) * 32 + lane, nt = 32 * gw;
    const bool live = row < m;
    const __nv_bfloat16* in = x + (live ? row : 0) * (size_t)k;
    void* out = reinterpret_cast<uint8_t*>(q)
                + (live ? row : 0) * (size_t)k * QB;
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(in);

    uint32_t lo = 0u, hi = 0u;
    uint4 v[C > 0 ? C : 1];
    if constexpr (C > 0) {
        // every load issued before the first max
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int i = 8 * (c * nt + tr);
            v[c] = live && i < k
                ? __ldg(reinterpret_cast<const uint4*>(in + i))
                : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) chunk_max(v[c], lo, hi);
    } else if (vec) {
        for (int i = 8 * tr; i < k; i += 8 * nt)
            chunk_max(*reinterpret_cast<const uint4*>(in + i), lo, hi);
    } else {
        for (int i = tr; i < k; i += nt) lo = max(lo, bits[i] & 0x7FFFu);
    }
    uint32_t mx = __reduce_max_sync(0xFFFFFFFFu, max(lo, hi >> 16));
    if (gw > 1) {
        if (lane == 0) red[warp] = mx;
        __syncthreads();
        const int w0 = warp - warp % gw;
        for (int i = 0; i < gw; ++i) mx = max(mx, red[w0 + i]);
    }
    const float amax = fp8::flush(__uint_as_float(mx << 16));   // XLA's DAZ
    const float sc = amax > 0.0f ? __fdiv_rn(amax, fp8::Hw<F>::top) : 1.0f;
    if (!live) return;
    if (tr == 0) s[row] = sc;
    // (a row holding a NaN has scale 1: its NaN amax compares false)
    const bool fast = mx <= 0x7F80u && sc >= 0x1p-60f && sc <= 3.40282347e38f;
    const float y = __frcp_rn(sc);

    if constexpr (C > 0) {
        if (fast) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int i = 8 * (c * nt + tr);
                if (i < k)
                    store_chunk<F, OUT>(out, i,
                                        chunk_codes_fast<F>(v[c], sc, y),
                                        false);
            }
        } else {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int i = 8 * (c * nt + tr);
                if (i < k)
                    store_chunk<F, OUT>(out, i, chunk_codes<F>(v[c], sc),
                                        true);
            }
        }
    } else if (vec) {
        for (int i = 8 * tr; i < k; i += 8 * nt) {
            const uint4 u = *reinterpret_cast<const uint4*>(in + i);
            store_chunk<F, OUT>(out, i,
                                fast ? chunk_codes_fast<F>(u, sc, y)
                                     : chunk_codes<F>(u, sc), !fast);
        }
    } else {
        for (int i = tr; i < k; i += nt) {
            const uint8_t code = to_code<F>(
                div_row(fp8::flush(__bfloat162float(in[i])), sc));
            if constexpr (OUT == Q_BYTES)
                reinterpret_cast<uint8_t*>(out)[i] = code;
            else
                reinterpret_cast<uint16_t*>(out)[i] = widen1<F>(code);
        }
    }
}

template <int F, int OUT>
cudaError_t quantize_launch(const __nv_bfloat16* x, void* q, float* s,
                            int m, int k, bool vec, cudaStream_t st) {
    const long long chunks = k / 8;
    int gw = Q_WARPS, c = 0;
    if (vec && chunks <= (long long)Q_THREADS * Q_MAX_CHUNKS) {
        // the fewest warps that hold the row, more while M rows of them
        // are fewer than 1024 warps (8 an SM)
        gw = 1;
        while (chunks > 32LL * gw * Q_MAX_CHUNKS) gw *= 2;
        while (gw < Q_WARPS && (long long)m * gw < 1024) gw *= 2;
        const long long per = (chunks + 32 * gw - 1) / (32 * gw);
        c = 1;
        while (c < per) c *= 2;
    }
    const long long blocks = ((long long)m * gw + Q_WARPS - 1) / Q_WARPS;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks);
    switch (c) {
#define Q_CASE(C) case C: quantize_rows_kernel<F, C, OUT><<<grid, Q_THREADS, \
                      0, st>>>(x, q, s, m, k, gw, vec); break;
        Q_CASE(0) Q_CASE(1) Q_CASE(2) Q_CASE(4) Q_CASE(8)
#undef Q_CASE
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

template <int F>
cudaError_t quantize_codes(const __nv_bfloat16* x, void* q, float* s, int m,
                           int k, int codes, bool vec, cudaStream_t st) {
    switch (codes) {
        case Q_BYTES:
            return quantize_launch<F, Q_BYTES>(x, q, s, m, k, vec, st);
        case Q_F16:
            return quantize_launch<F, Q_F16>(x, q, s, m, k, vec, st);
    }
    return cudaErrorInvalidValue;
}

// The probe of quot_fast (chip_smoke.py's w8a8 phase): for every f32
// significand of a (2^23 values, exponent ``a_exp``) and each divisor s of
// ``div`` (with y = RN(1 / s)), quot_fast's quotient against __fdiv_rn,
// and the e4m3 code
// of |a| / s on the fast path's rules against cast.cuh's path (to_code of
// div_row).  counts[0] += differing quotients, counts[1] += differing
// codes; the first 16 pairs (a, s bits) of differing quotients go to
// ``pairs``, counts[2] counting them.
__global__ void quot_probe_kernel(const float* __restrict__ div, int nd,
                                  int a_exp, unsigned long long* counts,
                                  uint32_t* pairs) {
    const float s = div[blockIdx.y];
    const float y = __frcp_rn(s);
    constexpr float top = fp8::Hw<fp8::E4M3>::top;
    unsigned dq = 0, dc = 0;
    for (uint32_t m = blockIdx.x * blockDim.x + threadIdx.x; m < (1u << 23);
         m += gridDim.x * blockDim.x) {
        const float a = __uint_as_float(((uint32_t)(a_exp + 127) << 23) | m);
        const float q = quot_fast(a, s, y);
        const float want = __fdiv_rn(a, s);
        if (__float_as_uint(q) != __float_as_uint(want)) {
            ++dq;
            const unsigned slot = (unsigned)atomicAdd(counts + 2, 1ull);
            if (slot < 16) {
                pairs[2 * slot] = __float_as_uint(a);
                pairs[2 * slot + 1] = __float_as_uint(s);
            }
        }
        const uint32_t fast = __nv_cvt_float_to_fp8(
            fp8::round_grid<fp8::E4M3>(fminf(q, top)), __NV_SATFINITE,
            __NV_E4M3);
        if (fast != to_code<fp8::E4M3>(div_row(a, s))) ++dc;
    }
    if (dq) atomicAdd(counts, (unsigned long long)dq);
    if (dc) atomicAdd(counts + 1, (unsigned long long)dc);
}

// -- P1 ----------------------------------------------------------------------

// The streaming loop's fp8 payload: e4m3 codes of x times e4m3 (E5 false)
// or e5m2 weight bytes; SUB k32 steps a tensor-core chunk inside a stage
// (4: whole stages, the launch's ``chunk`` of them).
template <bool E5, int SUB_>
struct P1Fp8 {
    static constexpr int KIND = ws::FP8;
    static constexpr bool GROUPED = false;
    static constexpr bool F16 = false;
    static constexpr bool E5M2 = E5;
    static constexpr int SUB = SUB_;
};

constexpr int STAGE_STEPS = 4;      // k32 steps a stage of 128 K rows

template <bool E5, int SUB>
cudaError_t p1_route(const ws::Launch& L, int route, cudaStream_t stream) {
    return route == ws::PREFILL_ROUTE
        ? ws::launch_prefill<P1Fp8<E5, SUB>>(L, stream)
        : ws::launch<P1Fp8<E5, SUB>>(L, route, stream);
}

template <bool E5>
cudaError_t p1_launch(const ws::Launch& L, int route, int sub,
                      cudaStream_t stream) {
    if (sub == STAGE_STEPS) return p1_route<E5, STAGE_STEPS>(L, route, stream);
#ifdef P1_CHUNK_PROBE
    // chunks of 1 or 2 k32 steps, promoted inside the stage: only in the
    // probes' build of this file (kernels/_build.py::VARIANTS), e4m3
    if constexpr (!E5) {
        if (sub == 1) return p1_route<false, 1>(L, route, stream);
        if (sub == 2) return p1_route<false, 2>(L, route, stream);
    }
#endif
    return cudaErrorInvalidValue;
}

}  // namespace

// P2.  fmt: 0 e4m3, 1 e5m2.  x (m, k) bf16, s (m,) f32, q (m, k): codes 0
// the codes' bytes, 1 their values as f16.
extern "C" int fp8_quantize_rows(const void* x, void* q, void* s, int m,
                                 int k, int fmt, int codes, void* stream) {
    if (m < 1 || k < 1) return (int)cudaErrorInvalidValue;
    const bool vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && reinterpret_cast<uintptr_t>(q) % (codes ? 16 : 8)
                        == 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    auto* sf = reinterpret_cast<float*>(s);
    if (fmt == 0)
        return (int)quantize_codes<fp8::E4M3>(xb, q, sf, m, k, codes, vec, st);
    if (fmt == 1)
        return (int)quantize_codes<fp8::E5M2>(xb, q, sf, m, k, codes, vec, st);
    return (int)cudaErrorInvalidValue;
}

// quot_fast's probe (quot_probe_kernel): divisors div (nd,) f32 normal,
// a's exponent a_exp; counts (3,) u64 and pairs (32,) u32 zeroed by the
// caller.
extern "C" int fp8_quot_probe(const void* div, int nd, int a_exp,
                              void* counts, void* pairs, void* stream) {
    if (nd < 1 || nd > 65535 || a_exp < -126 || a_exp > 127)
        return (int)cudaErrorInvalidValue;
    quot_probe_kernel<<<dim3(256, nd), 256, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float*>(div), nd, a_exp,
        reinterpret_cast<unsigned long long*>(counts),
        reinterpret_cast<uint32_t*>(pairs));
    return (int)cudaGetLastError();
}

// P1.  w_fmt: 0 e4m3, 1 e5m2.  k % 32 == 0, n % 16 == 0, 16-byte aligned
// xq, w8 and out (checked by kernels/qmatmul.py::w8a8_matmul and here).
// route: 1 or 2 the decode form with that many m64 tiles a block (m <= 64,
// qmatmul.py::stream_plan), 3 the prefill route (m > 64, prefill_plan);
// kper a multiple of 128; promote: k32 steps a tensor-core chunk, a
// multiple of 4 (whole stages), or in the probes' build (P1_CHUNK_PROBE)
// 1 or 2 with e4m3 weights.  ws / counters as for K3 (split_k.cuh) when
// splits > 1.
extern "C" int fp8_w8a8_gemm(const void* xq, const void* w8, const void* xs,
                             const void* s, void* out, int m, int n, int k,
                             int w_fmt, int out_f32, int route, int splits,
                             int kper, int promote, void* ws, void* counters,
                             void* stream) {
    if (m < 1 || n < 1 || k < 1 || promote < 1
        || reinterpret_cast<uintptr_t>(xq) % 16
        || reinterpret_cast<uintptr_t>(w8) % 16
        || reinterpret_cast<uintptr_t>(out) % 16
        || (splits > 1 && (ws == nullptr || counters == nullptr))
        || (route == ws::PREFILL_ROUTE) != (m > 64))
        return (int)cudaErrorInvalidValue;
    const int sub = promote % STAGE_STEPS == 0 ? STAGE_STEPS : promote;
    ws::Launch L;
    L.x = xq; L.w = w8;
    L.col_scale = reinterpret_cast<const float*>(s);
    L.row_scale = reinterpret_cast<const float*>(xs);
    L.group_scale = nullptr;
    L.out = out;
    L.ws = reinterpret_cast<float*>(ws);
    L.counters = reinterpret_cast<int*>(counters);
    L.m = m; L.n = n; L.k = k;
    L.splits = splits; L.kper = kper; L.group = 0;
    L.out_f32 = out_f32;
    L.chunk = sub == STAGE_STEPS ? promote / STAGE_STEPS : 1;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (w_fmt == 0) return (int)p1_launch<false>(L, route, sub, st);
    if (w_fmt == 1) return (int)p1_launch<true>(L, route, sub, st);
    return (int)cudaErrorInvalidValue;
}
