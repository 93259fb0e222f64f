// P3: the 8-bit AdamW update, in place: every leaf of a table in one launch
// (kernels/adam8.py::adam8_update_many), or one leaf (adam8_update).
//
// No TPU counterpart: the JAX package's 8-bit optimizer
// (fp8tpu/training/opt8.py) is XLA ops fused into its jitted train step.
// Run eagerly it would be ~20 elementwise launches a leaf, each a pass over
// the state; this kernel is one pass over all leaves.  The function, per
// leaf of n elements, its moments (nblocks, 256) int8 m / e4m3 v payloads
// and (nblocks,) f32 scales, flat in the leaf's order and zero-padded:
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
// Bound on an H100: its bytes, 16 an element with f32 p and g (p read and
// written, g read, one byte each of m and v read and written), 3.35 TB/s.
//
// The rounding is XLA's on the CPU, op by op, as in the plain version
// (kernels/adam8.py::adam8_update_plain): every product, sum, quotient and
// root rounded once (__fmul_rn / __fadd_rn: nvcc would otherwise contract
// b1 * x + c * g into an fma), every f32 subnormal input and result flushed
// (XLA's DAZ / FTZ), the int8 code half to even (jnp.round), the clip
// before the e4m3 convert, NaNs by the host's rules (a NaN code of v
// decodes to XLA's NaN, 0x7FC00000 with its sign, as the plain version's
// dequant_blocks makes it).  bc1 and bc2 come from the host.  Two routes
// give those bits; a block takes one by a warp vote.
//
// Work: a warp a block of 256 elements; a CTA of 8 warps takes a unit of 32
// blocks (4 a warp).  The grid covers the units of every leaf of a table
// built by the host (kernels/adam8.py::leaf_table); a CTA finds its leaf by
// a binary search of the leaves' first units (a single leaf comes by
// value), so small leaves share waves with large ones and a step is one
// launch.  The block's absmax is a warp max over the magnitudes' bits (a
// max is exact in any order).  Three walks of a leaf (the host picks one per leaf):
// - VECTOR, an aligned contiguous leaf: lane l holds elements 8l .. 8l + 7
//   (two 16-byte loads of p and g, one 8-byte load of each payload);
// - TILE, a Dense weight stored (out, in) and blocked in the JAX package's
//   (in, out) order, as a view with rows of a multiple of 256 out-elements
//   and a multiple of 32 in-columns: a block is one storage column of 256
//   storage rows, so the CTA stages 256 storage rows x 32 columns of p and g
//   (64 KB) in shared memory by 16-byte cp.async copies, all in flight
//   together, in two halves of 16 columns: the warps work the first half's
//   blocks (two each) while the second half loads, and store the first
//   half's p while they work the second's.  Lane l holds rows 8l .. 8l + 7
//   of a column (an XOR of each 16-byte chunk's place by row / 8 spreads a
//   column over 8 banks); a block's payload words load beside the block
//   before it;
// - STRIDED, any other view or an unaligned leaf (as one row): lane l holds
//   elements l + 32 k, element i at (i / cols) s0 + (i % cols) s1, 4-byte
//   accesses (neighbouring lanes are neighbours in the leaf's order).
// The padded tail reads as a zero gradient and writes no parameter.  Three
// CTAs an SM (80 registers a thread, __launch_bounds__) measured fastest
// on the large decoder's leaves; four spill and slow the tile, two leave
// too few warps (PERF.md §6, P3): the fast route is bound by its
// instructions as much as by its bytes.
//
// The slow route is the arithmetic of cast.cuh's DAZ / FTZ helpers, with
// every NaN test: any block takes it correctly.  The fast route is taken by
// a block when (launch-wide, fast_args) b1, b2 are 0 or in [2^-4, 1],
// 1 - b1, 1 - b2 are 0 or normal in [0, 1], bc1, bc2 lie in [2^-20, 1], eps
// in [2^-126, FLT_MAX], and for modes 0 and 1 wd is 0 or of magnitude in
// [2^-126, 2^20] and lr of magnitude in [2^-126, FLT_MAX]; and (the vote)
// every |g| <= 2^60, every |p| <= 2^100 (modes 0 and 1), both old scales +0
// or in [2^-110, 2^90], and every old v code below 0x7F (no sign, no NaN).
// Then no NaN can arise: the dequantized moments' magnitudes are below
// 2^97 (m) and 2^99 (v), products of them by b1 / b2 normal or 0 (>=
// 2^-123); |m| < 2^97.1 and 0 <= v < 2^120.1, so m / bc1 is finite, v / bc2
// is +0 or more (+inf at worst), sqrt(.) + eps >= eps > 0, u is finite or
// +-inf, -lr * (u [+ wd p]) is never 0 * inf (lr != 0) and u + wd p never
// inf - inf (|wd p| < 2^120).  So the NaN tests and the host-NaN selects
// go.  Flushes stay on g and p (DAZ) and on each result that can be an f32
// subnormal: (1 - b1) g, m, (1 - b2) g, (1 - b2) g g, u, wd p, u + wd p,
// -lr d, p + that.  The others are normal or zero by the bounds above
// (v's sum of two terms >= +0, m / bc1 and v / bc2 of |a| >= 2^-96 with bc
// <= 1, the root of a normal, sqrt + eps).  Each flush is one FTZ product
// by 1.0 (fl), which flushes only its input; no op rounds under FTZ, so
// whether the card judges a result tiny before or after rounding never
// matters.
//
// Divides by a uniform divisor s (bc1, bc2 launch-wide; the block's new
// scales) on the fast route, from y = RN(1 / s) computed once: q0 = RN(a y),
// then two corrections q' = RN(q + RN(a - s q) y), two fmas each (quot_fast).
// That is RN(a / s) for every divisor wherever no step underflows or
// overflows:
// - |a y - a / s| <= |a / s| 2^-24 < ulp(a / s), so |q0 - a / s| < 2 ulp;
// - the first correction is a / s + (a / s - q0) e with |e| < 2^-22.9 (the
//   roundings of y and of the remainder), so q1 lies within 1/2 ulp +
//   2^-21.9 ulp of a / s: a faithful quotient;
// - from a faithful q1 the second is Markstein's theorem (IBM J. Res. Dev.
//   34(1), 1990; Muller et al., Handbook of Floating-Point Arithmetic): the
//   remainder a - s q1 is exact and RN(q1 + r y) = RN(a / s).
// One correction alone needs q0 faithful, which RN(a y) is not for every
// divisor (Brisebarre, Muller and Raina, IEEE Trans. Computers 53(8), 2004).
// Every remainder is a multiple of 2^(e_a - 48) (e_a the exponent of a), so
// it is exact, as a subnormal too, for |a| >= 2^-101.  m / bc1 and v / bc2
// take it for |a| in [2^-96, 2^100] (quotients in [2^-96, 2^120]) and div_ftz
// elsewhere (a zero kept as it is).  For the codes only the code matters: a
// block whose new scale is at least 2^-86 takes it for every element (the
// quotient is exact for |a| >= 2^-101; below, it is under 2^-15 and comes
// out within 2^-30 of it, and int8 codes need quotients >= 0.5, e4m3 codes
// quotients above 2^-10: code 0 either way; v >= +0 on this route so the
// e4m3 zero is +0), other blocks take div_ftz.  u = m^ / (sqrt(v^) + eps)
// keeps the correctly rounded __fdiv_rn and the root __fsqrt_rn.  The e4m3
// codes come from one RNE satfinite convert of two quotients
// (cvt.rn.satfinite.e4m3x2.f32; saturation is the clip), the sign put back
// for a NaN.  chip_smoke.py's p3 phase holds the divides, the convert and
// the flush to the slow route's functions over every f32 input, and the
// divide by every bc1 / bc2 a run with b1 0.9, b2 0.999 takes over every
// significand (adam8_probe).
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "cast.cuh"

namespace {

constexpr int BLOCK = 256;          // elements a block (one warp)
constexpr int PER_LANE = BLOCK / 32;
constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int UNIT = 32;            // blocks a CTA takes, UNIT / WARPS a warp
constexpr int TILE_COLS = UNIT;     // in-columns of a staged tile (a block each)
constexpr int TILE_FLOATS = BLOCK * TILE_COLS;
constexpr int TILE_SMEM = 2 * TILE_FLOATS * 4;   // p and g: 64 KB
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
    float b1, omb1, b2, omb2, eps, bc1, bc2, wd, neg_lr;
};

// How a warp's lanes hold the 256 elements of a block (see the header).
enum Walk : int { VECTOR = 0, STRIDED = 1, TILE = 2 };

// One leaf of a table: 12 int64 on the host (kernels/adam8.py::LeafTable).
struct Leaf {
    float* p;
    const float* g;
    int8_t* mq;
    float* ms;
    uint8_t* vq;
    float* vs;
    long long n, cols, s0, s1;
    long long first_unit;           // the leaf's first CTA unit in the grid
    int walk, mode;
};
static_assert(sizeof(Leaf) == 96, "the host packs a leaf as 12 int64");

// -- the slow route: cast.cuh's DAZ / FTZ arithmetic, every NaN rule ---------

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
    return __uint_as_float(__reduce_max_sync(FULL, mx));
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

// with a NaN code's value XLA's (0x7FC00000 with the code's sign), as the
// plain version dequantizes it (numerics/blockquant.py::dequant_blocks)
__device__ __forceinline__ float e4m3_value_nan(uint8_t c) {
    return (c & 0x7Fu) == 0x7Fu
        ? __uint_as_float(0x7FC00000u | ((uint32_t)(c & 0x80u) << 24))
        : e4m3_value(c);
}

__device__ __forceinline__ void slow_block(const float (&gi)[PER_LANE],
                           const float (&pi)[PER_LANE],
                           int8_t (&cm)[PER_LANE], uint8_t (&cv)[PER_LANE],
                           float ms_old, float vs_old, const Args& a,
                           int mode, float (&out)[PER_LANE], float& sm2,
                           float& sv2) {
    const float sm = fp8::flush(ms_old), sv = fp8::flush(vs_old);
    float m[PER_LANE], v[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
        const float dm = fp8::mul_ftz((float)cm[k], sm);
        const float dv = fp8::mul_ftz(e4m3_value_nan(cv[k]), sv);
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
    // requantize per block
    sm2 = block_scale(warp_amax(m), 127.0f);
    sv2 = block_scale(warp_amax(v), 448.0f);
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
        cm[k] = int8_code(fp8::div_ftz(m[k], sm2));
        cv[k] = e4m3_code(fp8::div_ftz(v[k], sv2));
    }
}

// One block's lane data for the slow route, copied in and out whole.
struct BlockIo {
    float g[PER_LANE], p[PER_LANE], out[PER_LANE];
    int8_t cm[PER_LANE];
    uint8_t cv[PER_LANE];
    float sm2, sv2;
};

// Not inlined, and given its data by value: the rare route's registers and
// arrays stay out of the fast route's (an array passed by reference to a
// call would live in local memory on both routes).
__device__ __noinline__ BlockIo slow_route(BlockIo io, float ms_old,
                                           float vs_old, Args a, int mode) {
    slow_block(io.g, io.p, io.cm, io.cv, ms_old, vs_old, a, mode, io.out,
               io.sm2, io.sv2);
    return io;
}

// -- the fast route ---------------------------------------------------------

// fp8::flush(x) for every x but NaN in one instruction: a product by 1.0
// under FTZ flushes a subnormal input to its signed zero and is exact
// otherwise, so no rounding's tininess is involved (adam8_probe, kind 4).
__device__ __forceinline__ float fl(float x) {
    float r;
    asm("mul.rn.ftz.f32 %0, %1, 0f3F800000;" : "=f"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ bool zero_or(float x, float lo, float hi) {
    return x == 0.0f || (fabsf(x) >= lo && fabsf(x) <= hi);
}

__device__ __forceinline__ bool plus_zero_or(float x, float lo, float hi) {
    return __float_as_uint(x) == 0u || (x >= lo && x <= hi);
}

// the launch-wide half of the fast route's condition (see the header)
__device__ __forceinline__ bool fast_args(const Args& a, int mode) {
    const bool adam = plus_zero_or(a.b1, 0x1p-4f, 1.0f)
        && plus_zero_or(a.b2, 0x1p-4f, 1.0f)
        && plus_zero_or(a.omb1, 0x1p-126f, 1.0f)
        && plus_zero_or(a.omb2, 0x1p-126f, 1.0f)
        && a.bc1 >= 0x1p-20f && a.bc1 <= 1.0f
        && a.bc2 >= 0x1p-20f && a.bc2 <= 1.0f
        && a.eps >= 0x1p-126f && a.eps <= FLT_MAX;
    return adam && (mode == 2
                    || (zero_or(a.wd, 0x1p-126f, 0x1p20f)
                        && fabsf(a.neg_lr) >= 0x1p-126f
                        && fabsf(a.neg_lr) <= FLT_MAX));
}

// an old block scale the fast route takes: +0, or in [2^-110, 2^90]
__device__ __forceinline__ bool scale_ok(float s) {
    return plus_zero_or(s, 0x1p-110f, 0x1p90f);
}

// RN(a / s) from y = RN(1 / s): a product and two corrections, the second
// Markstein's (see the header)
__device__ __forceinline__ float quot_fast(float a, float s, float y) {
    const float q0 = __fmul_rn(a, y);
    const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, a), y, q0);
    return __fmaf_rn(__fmaf_rn(-q1, s, a), y, q1);
}

// div_ftz(a, bc) for bc in [2^-20, 1] with y = RN(1 / bc)
__device__ __forceinline__ float quot_bc(float a, float bc, float y) {
    const float x = fabsf(a);
    if (x >= 0x1p-96f && x <= 0x1p100f) return quot_fast(a, bc, y);
    return x == 0.0f ? a : fp8::div_ftz(a, bc);
}

// the int8 code of a finite quotient
__device__ __forceinline__ int8_t int8_fast(float q) {
    return (int8_t)__float2int_rn(fminf(fmaxf(q, -127.0f), 127.0f));
}

// the e4m3 codes of two quotients (x0 in the low byte): one RNE satfinite
// convert, which saturates as the clip does; a NaN keeps its sign
__device__ __forceinline__ uint32_t e4m3_pair(float x0, float x1) {
    const uint32_t c = __nv_cvt_float2_to_fp8x2(make_float2(x0, x1),
                                                __NV_SATFINITE, __NV_E4M3);
    return c | ((__float_as_uint(x0) >> 24) & 0x80u)
             | ((__float_as_uint(x1) >> 16) & 0x8000u);
}

__device__ __forceinline__ void fast_block(const float (&gi)[PER_LANE],
                           const float (&pi)[PER_LANE],
                           int8_t (&cm)[PER_LANE], uint8_t (&cv)[PER_LANE],
                           float sm, float sv, const Args& a, float y1,
                           float y2, int mode, float (&out)[PER_LANE],
                           float& sm2, float& sv2) {
    float m[PER_LANE], v[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
        const float g = fl(gi[k]);
        const float dm = __fmul_rn((float)cm[k], sm);
        const float dv = __fmul_rn(e4m3_value(cv[k]), sv);
        m[k] = fl(__fadd_rn(__fmul_rn(a.b1, dm), fl(__fmul_rn(a.omb1, g))));
        v[k] = __fadd_rn(__fmul_rn(a.b2, dv),
                         fl(__fmul_rn(fl(__fmul_rn(a.omb2, g)), g)));
        const float u = fl(__fdiv_rn(
            quot_bc(m[k], a.bc1, y1),
            __fadd_rn(__fsqrt_rn(quot_bc(v[k], a.bc2, y2)), a.eps)));
        if (mode == 2) {
            out[k] = u;
        } else {
            const float p = fl(pi[k]);
            const float d = mode == 1
                ? fl(__fadd_rn(u, fl(__fmul_rn(a.wd, p)))) : u;
            out[k] = fl(__fadd_rn(p, fl(__fmul_rn(a.neg_lr, d))));
        }
    }
    sm2 = block_scale(warp_amax(m), 127.0f);
    sv2 = block_scale(warp_amax(v), 448.0f);
    if (sm2 >= 0x1p-86f) {
        const float y = __fdiv_rn(1.0f, sm2);
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k)
            cm[k] = int8_fast(quot_fast(m[k], sm2, y));
    } else {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k)
            cm[k] = int8_code(fp8::div_ftz(m[k], sm2));
    }
    if (sv2 >= 0x1p-86f) {
        const float y = __fdiv_rn(1.0f, sv2);
#pragma unroll
        for (int k = 0; k < PER_LANE; k += 2) {
            const uint32_t c = e4m3_pair(quot_fast(v[k], sv2, y),
                                         quot_fast(v[k + 1], sv2, y));
            cv[k] = (uint8_t)(c & 0xFFu);
            cv[k + 1] = (uint8_t)(c >> 8);
        }
    } else {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k)
            cv[k] = e4m3_code(fp8::div_ftz(v[k], sv2));
    }
}

// The route's launch-wide values, once a CTA.
struct Route {
    bool fast;                      // fast_args
    float y1, y2;                   // RN(1 / bc1), RN(1 / bc2)
};

// One block's update: the vote, then the route.  ``routes`` (may be null)
// counts the blocks of each route: [fast, slow].
__device__ __forceinline__ void update_block(
        const float (&gi)[PER_LANE], const float (&pi)[PER_LANE],
        int8_t (&cm)[PER_LANE], uint8_t (&cv)[PER_LANE], float ms_old,
        float vs_old, const Args& a, const Route& rt, int mode,
        float (&out)[PER_LANE], float& sm2, float& sv2,
        unsigned long long* routes) {
    bool ok = rt.fast && scale_ok(ms_old) && scale_ok(vs_old);
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k)
        ok = ok && fabsf(gi[k]) <= 0x1p60f && cv[k] < 0x7Fu
             && (mode == 2 || fabsf(pi[k]) <= 0x1p100f);
    const bool fast = __all_sync(FULL, ok);
    if (fast) {
        fast_block(gi, pi, cm, cv, ms_old, vs_old, a, rt.y1, rt.y2, mode,
                   out, sm2, sv2);
    } else {
        BlockIo io;
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            io.g[k] = gi[k];
            io.p[k] = pi[k];
            io.cm[k] = cm[k];
            io.cv[k] = cv[k];
        }
        io = slow_route(io, ms_old, vs_old, a, mode);
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            out[k] = io.out[k];
            cm[k] = io.cm[k];
            cv[k] = io.cv[k];
        }
        sm2 = io.sm2;
        sv2 = io.sv2;
    }
    if (routes != nullptr && (threadIdx.x & 31) == 0)
        atomicAdd(routes + (fast ? 0 : 1), 1ull);
}

// -- the walks -------------------------------------------------------------

template <int W>
__device__ __forceinline__ int elem(int lane, int k) {
    return W == STRIDED ? lane + 32 * k : 8 * lane + k;
}

// the 8 codes of a lane's two payload words
__device__ __forceinline__ void unpack_codes(uint2 wm, uint2 wv,
                                             int8_t (&cm)[PER_LANE],
                                             uint8_t (&cv)[PER_LANE]) {
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
        const uint32_t w = k < 4 ? wm.x : wm.y;
        const uint32_t u = k < 4 ? wv.x : wv.y;
        cm[k] = (int8_t)((w >> (8 * (k & 3))) & 0xFFu);
        cv[k] = (uint8_t)((u >> (8 * (k & 3))) & 0xFFu);
    }
}

// the payloads' codes of lane ``lane``'s elements of block b
template <int W>
__device__ __forceinline__ void load_codes(const Leaf& L, long long b,
                                           int lane, int8_t (&cm)[PER_LANE],
                                           uint8_t (&cv)[PER_LANE]) {
    const long long base = b * BLOCK;
    if constexpr (W == STRIDED) {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            cm[k] = L.mq[base + elem<W>(lane, k)];
            cv[k] = L.vq[base + elem<W>(lane, k)];
        }
    } else {
        unpack_codes(*reinterpret_cast<const uint2*>(L.mq + base + 8 * lane),
                     *reinterpret_cast<const uint2*>(L.vq + base + 8 * lane),
                     cm, cv);
    }
}

// a block's payload words (a lane's 8 codes of each) and old scales, loaded
// ahead of the block's arithmetic
struct Codes {
    uint2 wm, wv;
    float ms, vs;
};

__device__ __forceinline__ Codes fetch_codes(const Leaf& L, long long b,
                                             int lane) {
    const long long at = b * BLOCK + 8 * lane;
    return Codes{*reinterpret_cast<const uint2*>(L.mq + at),
                 *reinterpret_cast<const uint2*>(L.vq + at), L.ms[b],
                 L.vs[b]};
}

template <int W>
__device__ __forceinline__ void store_codes(const Leaf& L, long long b,
                                            int lane,
                                            const int8_t (&cm)[PER_LANE],
                                            const uint8_t (&cv)[PER_LANE],
                                            float sm2, float sv2) {
    const long long base = b * BLOCK;
    if constexpr (W == STRIDED) {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            L.mq[base + elem<W>(lane, k)] = cm[k];
            L.vq[base + elem<W>(lane, k)] = cv[k];
        }
    } else {
        uint32_t w[2] = {0u, 0u}, u[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            w[k >> 2] |= (uint32_t)(uint8_t)cm[k] << (8 * (k & 3));
            u[k >> 2] |= (uint32_t)cv[k] << (8 * (k & 3));
        }
        *reinterpret_cast<uint2*>(L.mq + base + 8 * lane) =
            make_uint2(w[0], w[1]);
        *reinterpret_cast<uint2*>(L.vq + base + 8 * lane) =
            make_uint2(u[0], u[1]);
    }
    if (lane == 0) {
        L.ms[b] = sm2;
        L.vs[b] = sv2;
    }
}

__device__ __forceinline__ long long offset(const Leaf& L, long long i) {
    return (i / L.cols) * L.s0 + (i % L.cols) * L.s1;
}

// Block b of a VECTOR or STRIDED leaf, read from and written to global memory.
template <int W>
__device__ __forceinline__ void flat_block(const Leaf& L, long long b,
                                           const Args& a, const Route& rt,
                                           unsigned long long* routes) {
    const int lane = threadIdx.x & 31;
    const long long base = b * BLOCK;
    const int mode = L.mode;
    // a whole chunk of 8 inside the leaf: vector loads and stores
    const bool whole = W == VECTOR && base + 8 * lane + 8 <= L.n;
    int8_t cm[PER_LANE];
    uint8_t cv[PER_LANE];
    float gi[PER_LANE], pi[PER_LANE], out[PER_LANE];
    load_codes<W>(L, b, lane, cm, cv);
    if (whole) {
        const float4* gv = reinterpret_cast<const float4*>(L.g + base
                                                           + 8 * lane);
        const float4* pv = reinterpret_cast<const float4*>(L.p + base
                                                           + 8 * lane);
        const float4 g0 = gv[0], g1 = gv[1];
        gi[0] = g0.x; gi[1] = g0.y; gi[2] = g0.z; gi[3] = g0.w;
        gi[4] = g1.x; gi[5] = g1.y; gi[6] = g1.z; gi[7] = g1.w;
        if (mode != 2) {
            const float4 p0 = pv[0], p1 = pv[1];
            pi[0] = p0.x; pi[1] = p0.y; pi[2] = p0.z; pi[3] = p0.w;
            pi[4] = p1.x; pi[5] = p1.y; pi[6] = p1.z; pi[7] = p1.w;
        } else {
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) pi[k] = 0.0f;
        }
    } else {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const long long i = base + elem<W>(lane, k);
            const long long o = W == STRIDED ? offset(L, i) : i;
            gi[k] = i < L.n ? L.g[o] : 0.0f;
            pi[k] = i < L.n && mode != 2 ? L.p[o] : 0.0f;
        }
    }
    float sm2, sv2;
    update_block(gi, pi, cm, cv, L.ms[b], L.vs[b], a, rt, mode, out, sm2,
                 sv2, routes);
    if (whole) {
        float4* pv = reinterpret_cast<float4*>(L.p + base + 8 * lane);
        pv[0] = make_float4(out[0], out[1], out[2], out[3]);
        pv[1] = make_float4(out[4], out[5], out[6], out[7]);
    } else {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const long long i = base + elem<W>(lane, k);
            if (i < L.n) L.p[W == STRIDED ? offset(L, i) : i] = out[k];
        }
    }
    store_codes<W>(L, b, lane, cm, cv, sm2, sv2);
}

// Element (row, col) of a staged tile sits in 16-byte chunk (col / 4) ^
// (row / 8 % 8) of its row, so that whole chunks move by cp.async (every
// load in flight at once, no registers held) and lane l's column reads
// (rows 8l + k) meet 8 banks, 4 lanes each.
__device__ __forceinline__ int tile_pos(int row, int col) {
    return row * TILE_COLS + ((((col >> 2) ^ ((row >> 3) & 7)) << 2)
                              | (col & 3));
}

// the tile's 16-byte chunks of columns 16h .. 16h + 15 into shared memory
// by cp.async, and back to global memory
__device__ __forceinline__ void half_in(float* t, const float* src,
                                        long long ld, int h) {
#pragma unroll
    for (int it = 0; it < TILE_FLOATS / 8 / THREADS; ++it) {
        const int idx = it * THREADS + threadIdx.x;
        const int row = idx >> 2, q = 4 * h + (idx & 3);
        const unsigned dst = (unsigned)__cvta_generic_to_shared(
            t + tile_pos(row, 4 * q));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(dst), "l"(src + (long long)row * ld + 4 * q));
    }
}

__device__ __forceinline__ void half_out(const float* t, float* dst,
                                         long long ld, int h) {
#pragma unroll
    for (int it = 0; it < TILE_FLOATS / 8 / THREADS; ++it) {
        const int idx = it * THREADS + threadIdx.x;
        const int row = idx >> 2, q = 4 * h + (idx & 3);
        *reinterpret_cast<float4*>(dst + (long long)row * ld + 4 * q) =
            *reinterpret_cast<const float4*>(t + tile_pos(row, 4 * q));
    }
}

// Unit u of a TILE leaf: view rows (in-columns of the storage) r0 .. r0 +
// 31 of the band of view columns (storage rows) c0 .. c0 + 255; view rows
// run fastest in u, so neighbouring CTAs read neighbouring 128-byte pieces
// of the same storage rows.  The tile comes in two halves of 16 columns,
// two cp.async groups: every warp takes two blocks of the first half while
// the second still loads, and the first half's p goes out while the
// second half's blocks are worked.
__device__ __forceinline__ void tile_unit(const Leaf& L, long long u,
                                          const Args& a, const Route& rt,
                                          float* smem,
                                          unsigned long long* routes) {
    const long long bands = L.cols / BLOCK, strips = (L.n / L.cols) / TILE_COLS;
    const long long r0 = (u % strips) * TILE_COLS, band = u / strips;
    const long long at = band * BLOCK * L.s1 + r0;  // storage (c0, r0)
    float* tp = smem;
    float* tg = smem + TILE_FLOATS;
    const int mode = L.mode;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the column of the warp's s-th block: half s / 2, two a warp in each
    auto column = [&](int s) { return 16 * (s >> 1) + 2 * warp + (s & 1); };
    // the warp's first block's codes load beside the tile, each next one's
    // beside the arithmetic of the one before
    Codes next = fetch_codes(L, (r0 + column(0)) * bands + band, lane);
    for (int h = 0; h < 2; ++h) {
        half_in(tg, L.g + at, L.s1, h);
        if (mode != 2) half_in(tp, L.p + at, L.s1, h);
        asm volatile("cp.async.commit_group;" ::: "memory");
    }
#pragma unroll 1
    for (int s = 0; s < TILE_COLS / WARPS; ++s) {
        if (s == 0) {
            asm volatile("cp.async.wait_group 1;" ::: "memory");
            __syncthreads();
        } else if (s == 2) {
            __syncthreads();
            half_out(tp, L.p + at, L.s1, 0);
            asm volatile("cp.async.wait_group 0;" ::: "memory");
            __syncthreads();
        }
        const int col = column(s);
        const long long b = (r0 + col) * bands + band;
        const Codes cur = next;
        if (s + 1 < TILE_COLS / WARPS)
            next = fetch_codes(L, (r0 + column(s + 1)) * bands + band, lane);
        int8_t cm[PER_LANE];
        uint8_t cv[PER_LANE];
        float gi[PER_LANE], pi[PER_LANE], out[PER_LANE];
        unpack_codes(cur.wm, cur.wv, cm, cv);
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const int at_k = tile_pos(8 * lane + k, col);
            gi[k] = tg[at_k];
            pi[k] = mode != 2 ? tp[at_k] : 0.0f;
        }
        float sm2, sv2;
        update_block(gi, pi, cm, cv, cur.ms, cur.vs, a, rt, mode, out,
                     sm2, sv2, routes);
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k)
            tp[tile_pos(8 * lane + k, col)] = out[k];
        store_codes<TILE>(L, b, lane, cm, cv, sm2, sv2);
    }
    __syncthreads();
    half_out(tp, L.p + at, L.s1, 1);
}

__device__ __forceinline__ void run_unit(const Leaf& L, long long u,
                                         const Args& a, float* smem,
                                         unsigned long long* routes) {
    const Route rt{fast_args(a, L.mode), __fdiv_rn(1.0f, a.bc1),
                   __fdiv_rn(1.0f, a.bc2)};
    if (L.walk == TILE) {
        tile_unit(L, u, a, rt, smem, routes);
        return;
    }
    const long long nb = (L.n + BLOCK - 1) / BLOCK;
    const int warp = threadIdx.x >> 5;
    // at each step the 8 warps take 8 neighbouring blocks
    const long long end = min(u * UNIT + UNIT, nb);
#pragma unroll 1
    for (long long b = u * UNIT + warp; b < end; b += WARPS) {
        if (L.walk == VECTOR)
            flat_block<VECTOR>(L, b, a, rt, routes);
        else
            flat_block<STRIDED>(L, b, a, rt, routes);
    }
}

// Three CTAs an SM (80 registers a thread): the fastest of two, three and
// four on the large decoder's leaves (see the header).
// ``table`` holds ``nleaves`` leaves on the device, or is null and the grid
// takes ``one``; a unit's leaf is the last whose first unit is at most the
// CTA's.
__global__ void __launch_bounds__(THREADS, 3)
adam8_kernel(const Leaf* __restrict__ table, int nleaves, const Leaf one,
             Args a, unsigned long long* routes) {
    extern __shared__ float4 smem4[];
    const long long u = blockIdx.x;
    Leaf L = one;
    if (table != nullptr) {
        int lo = 0, hi = nleaves - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (table[mid].first_unit <= u) lo = mid;
            else hi = mid - 1;
        }
        L = table[lo];
    }
    // one inlined copy of the update for both sources of the leaf (two
    // copies spill more in the tile walk)
    run_unit(L, u - L.first_unit, a, reinterpret_cast<float*>(smem4),
             routes);
}

// -- probes of the fast route against the slow route's functions ------------

// kind 0: quot_bc(x, s) vs div_ftz(x, s), the f32 bits, every x;
// kind 1: int8_fast(quot_fast(x, s)) vs int8_code(div_ftz(x, s)), every
//         finite x with |x| <= 512 s;
// kind 2: the e4m3 codes of quot_fast(x, s) (e4m3_pair) vs
//         e4m3_code(div_ftz(x, s)), every x in [+0, 512 s];
// kind 3: e4m3_pair(x) vs e4m3_code(x), every x;
// kind 4: fl(x) vs fp8::flush(x), the f32 bits, every x but NaNs;
// kind 5: kind 0 over every x of magnitude in [1, 2), both signs: every
//         significand, which for s in [2^-20, 1] stands for every x that
//         quot_bc divides (RN(2^k a / s) = 2^k RN(a / s), and each step of
//         quot_fast scales with a, in its range).
// Each kind runs over every divisor of ``divisors`` (ndiv floats on the
// device).  out[0] counts the inputs taken, out[1] those that differ, out[2]
// the smallest (divisor index << 32 | bit pattern) that differs (2^62 if
// none).
__global__ void probe_kernel(int kind, const float* __restrict__ divisors,
                             int ndiv,
                             unsigned long long* __restrict__ out) {
    const unsigned long long span = kind == 5 ? 1ull << 24 : 1ull << 32;
    const unsigned long long stride =
        (unsigned long long)gridDim.x * blockDim.x;
    unsigned long long taken = 0, bad = 0, first = 1ull << 62;
    for (int d = 0; d < ndiv; ++d) {
        const float s = divisors[d];
        const float y = __fdiv_rn(1.0f, s);
        for (unsigned long long i = blockIdx.x * (unsigned long long)
                                    blockDim.x + threadIdx.x;
             i < span; i += stride) {
            const uint32_t bits = kind == 5
                ? 0x3F800000u + (uint32_t)(i >> 1)
                  + ((uint32_t)(i & 1) << 31)
                : (uint32_t)i;
            const float x = __uint_as_float(bits);
            bool differ;
            if (kind == 0 || kind == 5) {
                ++taken;
                differ = __float_as_uint(quot_bc(x, s, y))
                         != __float_as_uint(fp8::div_ftz(x, s));
            } else if (kind == 1) {
                if (!(fabsf(x) <= 512.0f * s)) continue;
                ++taken;
                differ = int8_fast(quot_fast(x, s, y))
                         != int8_code(fp8::div_ftz(x, s));
            } else if (kind == 2) {
                if ((bits >> 31) || !(x <= 512.0f * s)) continue;
                ++taken;
                differ = (e4m3_pair(quot_fast(x, s, y), 0.0f) & 0xFFu)
                         != e4m3_code(fp8::div_ftz(x, s));
            } else if (kind == 3) {
                ++taken;
                differ = (e4m3_pair(0.0f, x) >> 8) != e4m3_code(x);
            } else {
                if (isnan(x)) continue;
                ++taken;
                differ = __float_as_uint(fl(x))
                         != __float_as_uint(fp8::flush(x));
            }
            if (differ) {
                ++bad;
                first = min(first, ((unsigned long long)d << 32) | bits);
            }
        }
    }
    atomicAdd(out, taken);
    if (bad) {
        atomicAdd(out + 1, bad);
        atomicMin(out + 2, first);
    }
}

// -- the split-block route: a rank's block of a leaf whose moment blocks
// cross ranks (a column shard of a tensor-parallel Dense kernel) ----------
//
// The moments' blocks are 256 elements of the GLOBAL flat leaf (the JAX
// package's layout), so a block of a column shard holds elements of every
// model rank, and its new scale is the max over the ranks of their partial
// absmax.  Two passes, with one MAX all-reduce of the partial absmax bits
// between them on the host: SPLIT_AMAX computes each local element's new
// m and v, maxes their magnitudes' bits (the order of a max never
// matters; a NaN above +inf, as warp_amax) over the lanes of a warp that
// share a block (a warp's 32 elements fall in one to three blocks, in
// runs of lanes: the global index grows with the local one), and the
// first lane of each run atomically maxes them into its block's slot;
// SPLIT_APPLY computes them again, quantizes them by the blocks' scales
// from the reduced absmax, and applies the update.  The rank's codes are
// its own elements', in the local view's row-major order; it holds every
// block's scale.  Element (r, c) of the local (rows, cols) view is global
// index (r0 + r) N + c0 + c of a leaf N wide.  The arithmetic is the slow
// route's, op for op (slow_block), one element a thread.

enum SplitPass : int { SPLIT_AMAX = 0, SPLIT_APPLY = 1 };

struct SplitLeaf {
    float* p;
    const float* g;
    int8_t* mq;
    uint8_t* vq;
    float* ms;                  // written by SPLIT_APPLY (every block's)
    float* vs;
    const float* ms_old;        // the scales before the step
    const float* vs_old;
    unsigned* amax;             // 2 nb: m's blocks, then v's
    long long n, cols, s0, s1, N, r0, c0, nb;
    int mode;
};

__device__ __forceinline__ void split_moments(const SplitLeaf& L, long long i,
                                              const Args& a, long long& blk,
                                              float& g, float& m, float& v) {
    const long long r = i / L.cols, c = i - r * L.cols;
    blk = ((L.r0 + r) * L.N + L.c0 + c) >> 8;
    g = L.g[r * L.s0 + c * L.s1];
    const float sm = fp8::flush(L.ms_old[blk]), sv = fp8::flush(L.vs_old[blk]);
    const float dm = fp8::mul_ftz((float)L.mq[i], sm);
    const float dv = fp8::mul_ftz(e4m3_value_nan(L.vq[i]), sv);
    m = add_ftz(fp8::mul_ftz(a.b1, dm), fp8::mul_ftz(a.omb1, g));
    v = add_ftz(fp8::mul_ftz(a.b2, dv),
                fp8::mul_ftz(fp8::mul_ftz(a.omb2, g), g));
}

// SPLIT_AMAX over one warp's elements i0 .. i0 + 31 (i0 a multiple of 32,
// the lanes past n idle): each block's max over its run of lanes, one
// atomicMax a run and moment.
__device__ __forceinline__ void split_amax_warp(const SplitLeaf& L,
                                                const Args& a, long long i0) {
    const int lane = threadIdx.x & 31;
    const long long i = i0 + lane;
    long long blk = -1 - lane;          // an idle lane shares no block
    unsigned bm = 0u, bv = 0u;
    if (i < L.n) {
        float g, m, v;
        split_moments(L, i, a, blk, g, m, v);
        bm = __float_as_uint(m) & 0x7FFFFFFFu;
        bv = __float_as_uint(v) & 0x7FFFFFFFu;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const long long ob = __shfl_down_sync(0xFFFFFFFFu, blk, off);
        const unsigned om = __shfl_down_sync(0xFFFFFFFFu, bm, off);
        const unsigned ov = __shfl_down_sync(0xFFFFFFFFu, bv, off);
        if (lane + off < 32 && ob == blk) {
            bm = max(bm, om);
            bv = max(bv, ov);
        }
    }
    const long long prev = __shfl_up_sync(0xFFFFFFFFu, blk, 1);
    if (blk >= 0 && (lane == 0 || prev != blk)) {
        atomicMax(L.amax + blk, bm);
        atomicMax(L.amax + L.nb + blk, bv);
    }
}

__global__ void __launch_bounds__(THREADS)
split_kernel(SplitLeaf L, Args a, int pass) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (pass == SPLIT_AMAX) {
        // warp-uniform trips: every lane of a warp takes each shuffle
        for (long long i0 = t0 & ~31LL; i0 < L.n; i0 += stride)
            split_amax_warp(L, a, i0);
        return;
    }
    for (long long b = t0; b < L.nb; b += stride) {
        L.ms[b] = block_scale(__uint_as_float(L.amax[b]), 127.0f);
        L.vs[b] = block_scale(__uint_as_float(L.amax[L.nb + b]), 448.0f);
    }
    for (long long i = t0; i < L.n; i += stride) {
        long long blk;
        float g, m, v;
        split_moments(L, i, a, blk, g, m, v);
        const float sm2 = block_scale(__uint_as_float(L.amax[blk]), 127.0f);
        const float sv2 = block_scale(__uint_as_float(L.amax[L.nb + blk]),
                                      448.0f);
        L.mq[i] = int8_code(fp8::div_ftz(m, sm2));
        L.vq[i] = e4m3_code(fp8::div_ftz(v, sv2));
        const float u = fp8::div_ftz(
            fp8::div_ftz(m, a.bc1),
            add_ftz(sqrt_ftz(fp8::div_ftz(v, a.bc2)), a.eps));
        const long long r = i / L.cols, c = i - r * L.cols;
        float* pp = L.p + r * L.s0 + c * L.s1;
        if (L.mode == 2) {
            *pp = u;
        } else {
            const float d = L.mode == 1
                ? add_ftz(u, fp8::mul_ftz(a.wd, *pp)) : u;
            *pp = add_ftz(*pp, fp8::mul_ftz(a.neg_lr, d));
        }
    }
}

Args make_args(float b1, float omb1, float b2, float omb2, float eps,
               float bc1, float bc2, float wd, float neg_lr) {
    return Args{b1, omb1, b2, omb2, eps, bc1, bc2, wd, neg_lr};
}

}  // namespace

// One launch over ``units`` CTA units: ``table`` nleaves Leaf entries on the
// device (12 int64 each, first units ascending from 0), or null and ``one``
// a leaf on the host (12 int64, its first unit 0).  A leaf: n elements of p
// and g (f32); mq, vq (ceil(n / 256), 256) int8 / e4m3 bytes; ms, vs
// (ceil(n / 256),) f32; walk 0 VECTOR (p, g, mq, vq 16-byte aligned,
// contiguous), 1 STRIDED (element i at (i / cols) s0 + (i % cols) s1), 2
// TILE (s0 == 1, cols % 256 == 0, n / cols % 32 == 0, s1 % 4 == 0, p and g
// 16-byte aligned), checked by the host (kernels/adam8.py::_geometry);
// mode 0 apply, 1 apply with weight decay, 2 store the update into p.
// ``tiles`` is nonzero if a leaf takes the TILE walk.  routes: null, or 2
// uint64 on the device that count the blocks of the fast and the slow route.
extern "C" int adam8_update(const void* table, int nleaves, const void* one,
                            long long units, int tiles, float b1, float omb1,
                            float b2, float omb2, float eps, float bc1,
                            float bc2, float wd, float neg_lr, void* routes,
                            void* stream) {
    if ((table == nullptr) == (one == nullptr) || nleaves < 0 || units < 1
        || units > 0x7FFFFFFFll)
        return (int)cudaErrorInvalidValue;
    Leaf L{};
    if (one != nullptr) L = *reinterpret_cast<const Leaf*>(one);
    const int smem = tiles ? TILE_SMEM : 0;
    if (smem) {
        static const cudaError_t attr = cudaFuncSetAttribute(
            adam8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            TILE_SMEM);
        if (attr != cudaSuccess) return (int)attr;
    }
    adam8_kernel<<<(unsigned)units, THREADS, smem,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const Leaf*>(table), nleaves, L,
        make_args(b1, omb1, b2, omb2, eps, bc1, bc2, wd, neg_lr),
        reinterpret_cast<unsigned long long*>(routes));
    return (int)cudaGetLastError();
}

// One probe (see probe_kernel) over ``ndiv`` divisors on the device into out
// (3 uint64 on the device, set by the caller to 0, 0, 2^62).
extern "C" int adam8_probe(int kind, const void* divisors, int ndiv,
                           void* out, void* stream) {
    if (kind < 0 || kind > 5 || ndiv < 1) return (int)cudaErrorInvalidValue;
    probe_kernel<<<fp8::sm_count() * 8, 256, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
        kind, reinterpret_cast<const float*>(divisors), ndiv,
        reinterpret_cast<unsigned long long*>(out));
    return (int)cudaGetLastError();
}

// The split-block route (see split_kernel): ``pass`` 0 maxes the partial
// absmax bits of the local elements' new moments into ``amax`` (2 nb
// uint32, zeroed by the caller, m's then v's), 1 quantizes them by the
// blocks' scales from the reduced ``amax`` (writing every block's scale
// into ms / vs, read from ms_old / vs_old, which must not alias them) and
// applies the update to p (mode 0, 1 or 2 as adam8_update).  p and g: the
// local (n / cols, cols) view, element (r, c) at r s0 + c s1; mq, vq: n
// codes; r0, c0, N place the view in the global leaf (N wide, nb blocks).
extern "C" int adam8_split(int pass, void* p, const void* g, void* mq,
                           void* vq, void* ms, void* vs, const void* ms_old,
                           const void* vs_old, void* amax, long long n,
                           long long cols, long long s0, long long s1,
                           long long N, long long r0, long long c0,
                           long long nb, int mode, float b1, float omb1,
                           float b2, float omb2, float eps, float bc1,
                           float bc2, float wd, float neg_lr, void* stream) {
    if (pass < 0 || pass > 1 || mode < 0 || mode > 2 || n < 1 || cols < 1
        || n % cols || nb < 1 || N < 1)
        return (int)cudaErrorInvalidValue;
    SplitLeaf L{reinterpret_cast<float*>(p), reinterpret_cast<const float*>(g),
                reinterpret_cast<int8_t*>(mq), reinterpret_cast<uint8_t*>(vq),
                reinterpret_cast<float*>(ms), reinterpret_cast<float*>(vs),
                reinterpret_cast<const float*>(ms_old),
                reinterpret_cast<const float*>(vs_old),
                reinterpret_cast<unsigned*>(amax), n, cols, s0, s1, N, r0,
                c0, nb, mode};
    long long blocks = (n + THREADS - 1) / THREADS;
    const long long cap = 8LL * fp8::sm_count();
    if (blocks > cap) blocks = cap;
    split_kernel<<<(unsigned)blocks, THREADS, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
        L, make_args(b1, omb1, b2, omb2, eps, bc1, bc2, wd, neg_lr), pass);
    return (int)cudaGetLastError();
}
