// The fake-quant cast pipeline as device functions, shared by the cast
// kernel (cast_kernel.cu) and the fused fake-quant GEMM's pre-pass
// (qmatmul.cu), the way fp8tpu/numerics/cast.py::cast_array is shared by
// both Pallas kernels.
//
// Bit-for-bit the pipeline of fp8tpu_torch/numerics/cast.py (the plain
// torch version): every format x rounding mode x DAZ of the mode-string
// ABI, fp32 -> fp16 bit pattern (RNE) -> per-format GRS rounding ->
// fp32.  uint32 arithmetic wraps here as it does in the JAX code.
//
// Subnormal f32 values: XLA flushes them in f32 arithmetic (DAZ on inputs,
// FTZ on results), and the plain version reproduces that explicitly.  This
// file does the same with explicit code (flush(), mul_ftz(), recip_ftz())
// or explicit instructions (mul.rn.ftz) instead of compiler flags, so it
// is built without --use_fast_math and without -ftz=true, and the
// multiplies use __fmul_rn so that they are never contracted into an FMA.
//
// Two routes to the same bits.  The emulation (HW = false) writes every
// step at the bit level, NaN rules included: about 120 instructions an
// element, most of them integer.  The hardware route (HW = true) runs the ends of the
// pipeline on the hardware: mul.rn.ftz.f32 for the scale, cvt.rn.f16.f32
// for the f32 -> f16 pattern and cvt.f32.f16 back, and a plain multiply
// by 1/scale.  It gives the emulation's bits whenever the scaled value is
// not NaN and 1/scale is finite with |1/scale| >= 2^-102 (fast_inv), so
// that the last product is never an f32 subnormal; it reports a NaN in
// ``bad``, and the caller then takes the emulation, which applies the
// host's (x86) NaN rules.  tests/test_torch_k1_pipeline.py holds a torch
// twin of the hardware route bit-equal to the plain version.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fp8 {

// Format and mode ids; the Python wrappers use the same numbers.
enum Fmt : int {
  E5M2 = 0, E4M3 = 1, E4M3_IEEE = 2, E3M4 = 3, FP4 = 4, BF16 = 5, F16 = 6,
  E5M2_NOINF = 7, E5M2_FLEX = 8, E4M3_V2 = 9,
};
enum Mode : int {
  RNE = 0, STOCHASTIC = 1, RNAZ = 2, RNTZ = 3, RPINF = 4, RNINF = 5, RTZ = 6,
};

// Variant code: what the host passes to select a template instance.
__host__ __device__ constexpr int code_of(int f, int m, int d) {
  return f * 16 + m * 2 + d;
}

// Streaming multiprocessors of the current device, for grid sizes.
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Every (format, mode, daz) instance that exists.  Formats that ignore a
// mode or DAZ are normalised by the wrapper (fp4 -> RNE; bfloat16 non-SR
// -> RNE; float16 non-RNE -> STOCHASTIC with the given or zero bits; DAZ
// kept only for e5m2 and float16 RNE).
#define FP8_NEAREST_MODES(X, F, D) \
  X(F, fp8::RNE, D) X(F, fp8::RNAZ, D) X(F, fp8::RNTZ, D) \
  X(F, fp8::RPINF, D) X(F, fp8::RNINF, D) X(F, fp8::RTZ, D)
#define FP8_ALL_MODES(X, F, D) \
  FP8_NEAREST_MODES(X, F, D) X(F, fp8::STOCHASTIC, D)
#define FP8_CAST_VARIANTS(X)                                            \
  FP8_ALL_MODES(X, fp8::E5M2, false) FP8_ALL_MODES(X, fp8::E5M2, true)  \
  FP8_ALL_MODES(X, fp8::E4M3, false)                                    \
  FP8_ALL_MODES(X, fp8::E4M3_IEEE, false)                               \
  FP8_ALL_MODES(X, fp8::E3M4, false)                                    \
  FP8_ALL_MODES(X, fp8::E4M3_V2, false)                                 \
  X(fp8::FP4, fp8::RNE, false)                                          \
  X(fp8::BF16, fp8::RNE, false) X(fp8::BF16, fp8::STOCHASTIC, false)    \
  X(fp8::F16, fp8::RNE, false) X(fp8::F16, fp8::RNE, true)              \
  X(fp8::F16, fp8::STOCHASTIC, false)                                   \
  X(fp8::E5M2_NOINF, fp8::RNE, false) X(fp8::E5M2_FLEX, fp8::RNE, false)

// Via-fp16 constants of the table in numerics/formats.py.
template <int F> struct Geo;
template <> struct Geo<E5M2> {
  static constexpr int lshift = 8, grs = 0x00FF, tie = 0x0180,
                       can_round = 0x7B00;
  static constexpr float headroom = 16384.0f;
};
template <> struct Geo<E4M3> {
  static constexpr int lshift = 7, grs = 0x007F, tie = 0x00C0,
                       can_round = 0x5F00, exp_sat = 8, sat_mant = 0x0300,
                       flush_exp = -9, min_norm_exp = -6;
  static constexpr float headroom = 8.0f;
};
template <> struct Geo<E4M3_IEEE> {
  static constexpr int lshift = 7, grs = 0x007F, tie = 0x00C0,
                       can_round = 0x5B80, exp_sat = 7, sat_mant = 0x0380,
                       flush_exp = -9, min_norm_exp = -6;
  static constexpr float headroom = 8.0f;
};
template <> struct Geo<E3M4> {
  static constexpr int lshift = 6, grs = 0x003F, tie = 0x0060,
                       can_round = 0x4F80, exp_sat = 4, sat_mant = 0x0380,
                       flush_exp = -6, min_norm_exp = -2;
  static constexpr float headroom = 1.0f;
};
template <> struct Geo<E4M3_V2> : Geo<E4M3> {};
template <> struct Geo<E5M2_NOINF> : Geo<E5M2> {};
template <> struct Geo<E5M2_FLEX> : Geo<E5M2> {};
template <> struct Geo<FP4> { static constexpr float headroom = 1.0f; };
template <> struct Geo<BF16> { static constexpr float headroom = 1.0f; };
template <> struct Geo<F16> { static constexpr float headroom = 1.0f; };

// -- DAZ/FTZ arithmetic ------------------------------------------------------
//
// NaNs follow the host's (x86) rules, so that results match the plain
// version on the CPU bit for bit: a NaN operand comes back quieted with its
// payload, and an invalid operation (inf * 0) gives the default NaN
// 0xFFC00000.  The GPU's own arithmetic would return 0x7FFFFFFF for both.

__device__ __forceinline__ float quiet(float v) {
  return __uint_as_float(__float_as_uint(v) | 0x00400000u);
}
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.0f, v) : v;
}
__device__ __forceinline__ float mul_ftz(float a, float b) {
  if (isnan(a)) return quiet(a);
  if (isnan(b)) return quiet(b);
  const float r = __fmul_rn(flush(a), flush(b));
  return isnan(r) ? __uint_as_float(0xFFC00000u) : flush(r);
}
__device__ __forceinline__ float recip_ftz(float s) {
  if (isnan(s)) return quiet(s);
  return flush(__fdiv_rn(1.0f, flush(s)));
}
// max that propagates NaN, like torch.amax and jnp.max.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// murmur3-finalizer counter hash: numerics/cast.py::sr_bits_from_salt.
__device__ __forceinline__ uint32_t sr_hash(uint32_t salt, uint32_t idx) {
  uint32_t h = idx * 0xCC9E2D51u + salt;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >> 16;
}

// A block of a larger row-major tensor as runs (parallel/data.py::Block.
// segments, padded to three): local flat index i = (i0 L1 + i1) L2 + i2 is
// the global index ((s0 + i0) G1 + s1 + i1) G2 + s2 + i2, mod 2^32 as
// sr_hash takes it.  Built from the 7 values (L1, L2, G1, G2, s0, s1, s2)
// of kernels/cast_kernel.py::block_args.
struct BlockRuns {
  long long L1, L2;
  uint32_t g1, g2, s0, s1, s2;
};

inline BlockRuns block_runs(const long long* a) {
  return BlockRuns{a[0], a[1], static_cast<uint32_t>(a[2]),
                   static_cast<uint32_t>(a[3]), static_cast<uint32_t>(a[4]),
                   static_cast<uint32_t>(a[5]), static_cast<uint32_t>(a[6])};
}

__device__ __forceinline__ uint32_t block_index(long long i,
                                                const BlockRuns& b) {
  const long long q = i / b.L2;
  const uint32_t i2 = static_cast<uint32_t>(i - q * b.L2);
  const long long i0 = q / b.L1;
  const uint32_t i1 = static_cast<uint32_t>(q - i0 * b.L1);
  return ((b.s0 + static_cast<uint32_t>(i0)) * b.g1 + b.s1 + i1) * b.g2
         + b.s2 + i2;
}

// -- fp32 <-> fp16 bit patterns ----------------------------------------------

__device__ __forceinline__ int f32_to_f16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  const int sign = (u >> 16) & 0x8000;
  const int absu = u & 0x7FFFFFFF;
  const int exp = absu >> 23;
  const int mant = absu & 0x7FFFFF;
  const int e = exp - 127;
  const int lsb = (mant >> 13) & 1;
  const int h_norm = (e + 15) * 1024 + ((mant + 0xFFF + lsb) >> 13);
  const int m24 = mant | 0x800000;
  const int rs = min(max(-e - 1, 1), 30);
  const int lsb_s = (m24 >> rs) & 1;
  const int h_sub = (m24 + ((1 << (rs - 1)) - 1) + lsb_s) >> rs;
  int h = e >= -14 ? h_norm : h_sub;
  if (e > 15) h = 0x7C00;
  if (exp == 0) h = 0;  // f32 subnormals underflow to zero
  if (exp == 255) h = 0x7C00 | (mant != 0 ? ((mant >> 13) | 0x200) : 0);
  return h | sign;
}

__device__ __forceinline__ float f16_bits_to_f32(int h) {
  h &= 0xFFFF;
  const uint32_t sign = (h >> 15) & 1;
  const uint32_t exp = (h >> 10) & 0x1F;
  const uint32_t mant = h & 0x3FF;
  if (exp == 0) {
    const float fs = __fmul_rn(static_cast<float>(mant), 5.9604644775390625e-08f);
    return sign ? -fs : fs;
  }
  const uint32_t bits = exp == 31
      ? ((sign << 31) | 0x7F800000u | (mant << 13))
      : ((sign << 31) | ((exp + 112) << 23) | (mant << 13));
  return __uint_as_float(bits);
}

// -- the ends of the pipeline, emulated or on the hardware -------------------

__device__ __forceinline__ float mul_hw_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ int f16_hw(float f) {
  unsigned short h;
  asm("cvt.rn.f16.f32 %0, %1;" : "=h"(h) : "f"(f));
  return h;
}
__device__ __forceinline__ float f32_of_f16_hw(int h) {
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(static_cast<unsigned short>(h)));
  return f;
}

// 1/scale with which the hardware route's last multiply is exact-equal to
// mul_ftz: finite, and large enough that a product with any nonzero f16
// value (>= 2^-24) is an f32 normal.
__device__ __forceinline__ bool fast_inv(float inv) {
  return fabsf(inv) >= 0x1p-102f && fabsf(inv) <= 3.40282347e38f;
}

// The f16 pattern of x * s.  HW: a NaN product sets ``bad`` (the pattern
// is then meaningless); an f32 subnormal product, flushed or not, is ±0
// in f16 either way.
template <bool HW>
__device__ __forceinline__ int scaled_f16(float x, float s, bool& bad) {
  if constexpr (HW) {
    const float r = mul_hw_ftz(x, s);
    bad |= r != r;
    return f16_hw(r);
  } else {
    return f32_to_f16_bits(mul_ftz(x, s));
  }
}
// f16 pattern h (never NaN on the hardware route) times 1/scale.
template <bool HW>
__device__ __forceinline__ float descaled(int h, float inv) {
  if constexpr (HW) return __fmul_rn(f32_of_f16_hw(h), inv);
  else return mul_ftz(f16_bits_to_f32(h), inv);
}

template <int M, int F>
__device__ __forceinline__ int nearest_incr(int rnmask, int rntie,
                                            bool positive) {
  constexpr int half = 1 << (Geo<F>::lshift - 1);
  bool up;
  if (M == RNE) up = rnmask > half || rntie == Geo<F>::tie;
  else if (M == RNAZ) up = rnmask >= half;
  else if (M == RNTZ) up = rnmask > half;
  else if (M == RPINF) up = positive && rnmask >= half;
  else if (M == RNINF) up = !positive && rnmask >= half;
  else up = false;  // RTZ
  return static_cast<int>(up) << Geo<F>::lshift;
}

// -- format bodies -----------------------------------------------------------

template <int M, bool DAZ, bool HW>
__device__ __forceinline__ float cast_e5m2(float x, float s, float inv,
                                           uint32_t rb, bool& bad) {
  using G = Geo<E5M2>;
  int h = scaled_f16<HW>(x, s, bad);
  const int exp_field = h & 0x7C00;
  const bool can_round = (h & 0x7F00) <= G::can_round;
  const bool is_normal = exp_field <= 0x7800 && exp_field >= 0x0400;
  const bool is_denorm = exp_field == 0;
  const bool is_naninf = exp_field == 0x7C00;
  const bool positive = (h & 0x8000) == 0;
  const int rnmask = h & G::grs, rntie = h & G::tie;
  int incr;
  if (M == STOCHASTIC) {
    const int rand = static_cast<int>(rb) & G::grs;
    incr = DAZ ? rand
               : (is_normal ? rand : 0)
                     + (is_denorm ? nearest_incr<RNE, E5M2>(rnmask, rntie,
                                                              positive)
                                  : 0);
  } else {
    incr = nearest_incr<M, E5M2>(rnmask, rntie, positive);
  }
  bool apply = !is_naninf && can_round;
  if (DAZ) apply = apply && is_normal;
  if (apply) h += incr;
  if (DAZ && is_denorm) h = 0;
  h &= (0xFFFF << G::lshift) & 0xFFFF;
  return descaled<HW>(h, inv);
}

template <int F, int M, bool HW>
__device__ __forceinline__ float cast_rebias(float x, float s, float inv,
                                             uint32_t rb, bool& bad) {
  using G = Geo<F>;
  const int h = scaled_f16<HW>(x, s, bad);
  int exp = ((h >> 10) & 0x1F) - 15;
  const int sign = h & 0x8000;
  int mant = h & 0x03FF;
  bool can_round = (h & 0x7FFF) < G::can_round;
  const bool is_denorm = (h & 0x7C00) == 0;
  const bool is_naninf = (h & 0x7C00) == 0x7C00;
  const bool positive = sign == 0;

  const bool sat = exp > G::exp_sat || !can_round;
  if (sat) { mant = G::sat_mant; exp = G::exp_sat; }
  can_round = can_round && !sat;
  const bool fl = !sat && exp < G::flush_exp;
  if (fl) { mant = 0; exp = -15; }
  if (!sat && !fl && exp < G::min_norm_exp) {
    const int dshift = G::min_norm_exp - exp;
    mant = (mant >> dshift) << dshift;
  }
  const int rnmask = mant & G::grs, rntie = mant & G::tie;
  int incr;
  if (M == STOCHASTIC) {
    const int rand = static_cast<int>(rb) & G::grs;
    const bool is_normal =
        (h & 0x7C00) <= 0x7800 && (h & 0x7C00) >= 0x0400;
    incr = (is_normal ? rand : 0)
         + (is_denorm ? nearest_incr<RNE, F>(rnmask, rntie, positive) : 0);
  } else {
    incr = nearest_incr<M, F>(rnmask, rntie, positive);
  }
  if (!is_naninf && can_round) mant += incr;
  mant &= (0xFFFF << G::lshift) & 0xFFFF;
  const int out = (mant + (exp + 15) * 1024) | sign;
  return descaled<HW>(out, inv);
}

template <int M, bool HW>
__device__ __forceinline__ float cast_e4m3_v2(float x, float s, float inv,
                                              uint32_t rb, bool& bad) {
  using G = Geo<E4M3>;
  const int h = scaled_f16<HW>(x, s, bad);
  int exp = ((h >> 10) & 0x1F) - 15;
  const int sign = h & 0x8000;
  int mant = h & 0x03FF;
  bool can_round = (h & 0x7FFF) < 0x4B80;  // |fp16| < 15.0
  const int exp_field = h & 0x7C00;
  const bool is_normal = exp_field <= 0x7800 && exp_field >= 0x0400;
  const bool is_denorm = exp_field == 0;
  const bool is_naninf = exp_field == 0x7C00;
  const bool positive = sign == 0;
  const bool sat = exp > -1;
  if (sat) { mant = 0x0380; exp = -1; }
  can_round = can_round && !sat;
  const int rnmask = mant & G::grs, rntie = mant & G::tie;
  int incr;
  if (M == STOCHASTIC) {
    const int rand = static_cast<int>(rb) & G::grs;
    incr = (is_normal ? rand : 0)
         + (is_denorm ? nearest_incr<RNE, E4M3>(rnmask, rntie, positive) : 0);
  } else {
    incr = nearest_incr<M, E4M3>(rnmask, rntie, positive);
  }
  if (can_round && !is_naninf) mant += incr;
  mant &= 0xFF80;
  const int out = (mant + (exp + 15) * 1024) | sign;
  return descaled<HW>(out, inv);
}

template <int M>
__device__ __forceinline__ float cast_bf16(float x, uint32_t rb) {
  uint32_t u = __float_as_uint(x);
  const bool naninf = (u & 0x7F800000u) == 0x7F800000u;
  const uint32_t incr = M == STOCHASTIC ? (rb & 0xFFFFu)
                                        : 0x7FFFu + ((u >> 16) & 1u);
  if (!naninf) u += incr;
  return __uint_as_float(u & 0xFFFF0000u);
}

template <int M, bool DAZ, bool HW>
__device__ __forceinline__ float cast_f16(float x, uint32_t rb, bool& bad) {
  if (M == RNE) {
    int bits;
    if constexpr (HW) {
      bad |= x != x;
      bits = f16_hw(x);
    } else {
      bits = f32_to_f16_bits(x);
    }
    if (DAZ && (bits & 0x7C00) == 0) bits = 0;
    return HW ? f32_of_f16_hw(bits) : f16_bits_to_f32(bits);
  }
  const uint32_t u = __float_as_uint(x);
  const int exp = static_cast<int>((u >> 23) & 0xFF) - 127;
  const uint32_t mant = u & 0x7FFFFFu;
  const uint32_t sign = u & 0x80000000u;
  const uint32_t nan_mant =
      (mant != 0 && (mant & 0x400000u) == 0) ? (mant | 0x400000u) : mant;
  int h;
  if (exp == 128) {
    h = ((0x1Fu << 23) | nan_mant | (sign >> 3)) >> 13;
  } else if (exp >= 16) {
    h = ((0x1Fu << 23) | (sign >> 3)) >> 13;
  } else if (exp < -14) {
    h = f32_to_f16_bits(x);
  } else {
    const uint32_t exp_bits = (static_cast<uint32_t>(exp + 15) & 0x1FFu) << 23;
    h = ((exp_bits | mant | (sign >> 3)) + (rb & 0x1FFFu)) >> 13;
  }
  return f16_bits_to_f32(h & 0xFFFF);
}

template <bool HW>
__device__ __forceinline__ float cast_e5m2_noinf(float x, float s,
                                                 float inv, bool& bad) {
  const int h = scaled_f16<HW>(x, s, bad);
  const bool naninf = (h & 0x7C00) == 0x7C00;
  const int tie = (h & 0x0100) == 0x0100;
  int enc = ((((h & 0x7C00) >> 10) + 1) << 10) | (h & 0x83FF);
  if (!naninf) enc = enc + 0x7F + tie;
  enc &= 0xFFFF;
  if ((h & 0x7FFF) > 0x7F00) enc = (enc & 0x8000) | 0x7F00;
  if (naninf) enc = 0x8000;
  const int d = ((enc >> 8) & 0xFF) << 8;
  const int dexp = ((((d & 0x7C00) >> 10) - 1) * 1024) & 0xFFFF;
  int out = (dexp | (d & 0x83FF)) & 0xFFFF;
  if (d == 0x8000) out = 0x7C00;
  return descaled<HW>(out, inv);
}

__device__ __forceinline__ float cast_e5m2_flex(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t expf = u & 0x7F800000u;
  const bool naninf = expf == 0x7F800000u;
  const uint32_t tie = (u & 0x00200000u) == 0x00200000u;
  const bool zflush = expf < 0x37800000u;
  const bool denorm = expf < 0x38800000u;
  const uint32_t sign = u & 0x80000000u;
  const uint32_t urne = naninf ? u : u + 0xFFFFFu + tie;
  const int exp = static_cast<int>((urne & 0x7F800000u) >> 23) - 127;
  const long long mant = urne & 0x7FFFFFu;
  const int shft = -15 - exp;
  const int rshft = denorm ? 21 + shft : 21;
  const int lshft = denorm ? 8 + shft : 8;
  const long long mant2 =
      rshft < 24 ? ((mant >> min(max(rshft, 0), 31)) << min(max(lshft, 0), 31))
                 : 0;
  long long out = (mant2 | (((exp + 15) * 1024) & 0xFFFF)
                   | (sign != 0 ? 0x8000 : 0)) & 0xFFFF;
  if (zflush) out = 0;
  return f16_bits_to_f32(static_cast<int>(out));
}

__device__ __forceinline__ float cast_fp4(float x, float s, float inv) {
  const float f = mul_ftz(x, s);
  const uint32_t u = __float_as_uint(f);
  const int exp = static_cast<int>((u >> 23) & 0xFF) - 127;
  const uint32_t sign = u & 0x80000000u;
  const bool odd_neg = exp < 0 && (exp % 2) != 0;
  const float f2 = odd_neg ? mul_ftz(f, 1.6f) : f;
  uint32_t u2 = __float_as_uint(f2);
  if (exp > 0) u2 = sign | (127u << 23);
  u2 &= 0xFF800000u;
  const int exp2 = static_cast<int>((u2 >> 23) & 0xFF) - 127;
  if (exp2 < 0 && (exp2 % 2) != 0)
    u2 = sign | (static_cast<uint32_t>(exp2 + 126) << 23);
  if (exp2 < -12) u2 = 0;  // the pre-adjustment exponent, as the reference
  return mul_ftz(__uint_as_float(u2), inv);
}

// Formats whose hardware route exists (the rest are integer work already,
// or fp4's few multiplies).
template <int F, int M>
__host__ __device__ constexpr bool has_hw_route() {
  return F == E5M2 || F == E4M3 || F == E4M3_IEEE || F == E3M4
      || F == E4M3_V2 || F == E5M2_NOINF || (F == F16 && M == RNE);
}

// One element on route HW: ``s`` its scale, ``inv`` = recip_ftz(s), ``rb``
// its 16 random bits (read only by STOCHASTIC instances and float16's
// non-RNE path).  HW needs fast_inv(inv) for formats that descale, and
// sets ``bad`` where the emulation must redo the element.
template <int F, int M, bool DAZ, bool HW>
__device__ __forceinline__ float cast_route(float x, float s, float inv,
                                            uint32_t rb, bool& bad) {
  constexpr bool hw = HW && has_hw_route<F, M>();
  if constexpr (F == E5M2) return cast_e5m2<M, DAZ, hw>(x, s, inv, rb, bad);
  else if constexpr (F == E4M3 || F == E4M3_IEEE || F == E3M4)
    return cast_rebias<F, M, hw>(x, s, inv, rb, bad);
  else if constexpr (F == E4M3_V2)
    return cast_e4m3_v2<M, hw>(x, s, inv, rb, bad);
  else if constexpr (F == FP4) return cast_fp4(x, s, inv);
  else if constexpr (F == BF16) return cast_bf16<M>(x, rb);
  else if constexpr (F == F16) return cast_f16<M, DAZ, hw>(x, rb, bad);
  else if constexpr (F == E5M2_NOINF)
    return cast_e5m2_noinf<hw>(x, s, inv, bad);
  else return cast_e5m2_flex(x);
}

// The emulation alone.
template <int F, int M, bool DAZ>
__device__ __forceinline__ float cast_emulated(float x, float s, float inv,
                                               uint32_t rb) {
  bool unused = false;
  return cast_route<F, M, DAZ, false>(x, s, inv, rb, unused);
}

// One element: the hardware route where it gives the emulation's bits,
// else the emulation.  ``fast`` = fast_inv(inv), decided once per scale.
template <int F, int M, bool DAZ>
__device__ __forceinline__ float cast_elem(float x, float s, float inv,
                                           uint32_t rb, bool fast) {
  if constexpr (has_hw_route<F, M>()) {
    if (fast || F == F16) {
      bool bad = false;
      const float y = cast_route<F, M, DAZ, true>(x, s, inv, rb, bad);
      if (!bad) return y;
    }
  }
  return cast_emulated<F, M, DAZ>(x, s, inv, rb);
}

// Per-block scale from the block's absmax (numerics/cast.py::block_scales):
// 2 * 2^floor(log2 amax) / headroom, or 1/amax for fp4; 1.0 for a block
// whose absmax is zero or NaN.
template <int F>
__device__ __forceinline__ float block_scale(float amax) {
  amax = flush(amax);
  if (!(amax > 0.0f)) return 1.0f;
  if constexpr (F == FP4) return recip_ftz(amax);
  const float p2 = __uint_as_float(__float_as_uint(amax) & 0x7F800000u);
  return flush(__fdiv_rn(__fmul_rn(2.0f, p2), Geo<F>::headroom));
}

// -- the hardware-convert route (cast_impl="hw") -----------------------------
//
// numerics/cast.py::hw_qdq and hw_sr for e4m3, e5m2 and bfloat16, the
// formats whose casts K2 runs in the "hw" route.  The convert is written at
// the bit level (RNE onto the format's grid, after the clip), so that it
// is the host's convert bit for bit, NaNs included (the sign and the quiet
// bit, as XLA's convert keeps them).

template <int F> struct Hw;
template <> struct Hw<E4M3> {
  static constexpr int mant = 3, emin = -6;
  static constexpr float top = 448.0f;
  static constexpr bool inf = false;
};
template <> struct Hw<E5M2> {
  static constexpr int mant = 2, emin = -14;
  static constexpr float top = 57344.0f;
  static constexpr bool inf = true;
};
template <> struct Hw<BF16> {
  static constexpr int mant = 7, emin = -126;
  static constexpr float top = 3.38953139e38f;
  static constexpr bool inf = true;
};

// a / b under DAZ/FTZ with the host's NaN rules (x86: the first NaN
// operand's payload, quieted; 0xFFC00000 for 0/0 and inf/inf).
__device__ __forceinline__ float div_ftz(float a, float b) {
  if (isnan(a)) return quiet(a);
  if (isnan(b)) return quiet(b);
  const float r = __fdiv_rn(flush(a), flush(b));
  return isnan(r) ? __uint_as_float(0xFFC00000u) : flush(r);
}

// Clamp to [-max, max]; NaN stays NaN (torch.clamp, jnp.clip).
template <int F>
__device__ __forceinline__ float clip_hw(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, -Hw<F>::top), Hw<F>::top);
}

// RNE onto F's grid of a finite value in [-max, max] that is not an f32
// subnormal: mantissa rounding above the format's normal range, a fixed
// grid of 2^(emin - mant) below it.
template <int F>
__device__ __forceinline__ float round_grid(float v) {
  using H = Hw<F>;
  const uint32_t u = __float_as_uint(v);
  const int e = static_cast<int>((u >> 23) & 0xFF) - 127;
  if (e >= H::emin) {
    constexpr int cut = 23 - H::mant;
    const uint32_t lsb = (u >> cut) & 1u;
    return __uint_as_float((u + ((1u << (cut - 1)) - 1u) + lsb)
                           & (0xFFFFFFFFu << cut));
  }
  if constexpr (H::mant - H::emin > 126) {
    return v;  // bf16: below its normal range lie only (flushed) zeros
  } else {
    constexpr float up = static_cast<float>(1u << (H::mant - H::emin));
    return __fmul_rn(rintf(__fmul_rn(v, up)), 1.0f / up);
  }
}

// hw_qdq: clip, RNE convert to F and back, descale (descale=false keeps
// the scaled grid value).
template <int F>
__device__ __forceinline__ float hw_qdq(float x, float s,
                                        bool descale = true) {
  const float xf = mul_ftz(x, s);
  float y;
  if (isnan(xf)) {
    y = __uint_as_float((__float_as_uint(xf) & 0x80000000u) | 0x7FC00000u);
  } else if (Hw<F>::inf && isinf(xf)) {
    y = xf;
  } else {
    y = round_grid<F>(clip_hw<F>(xf));
  }
  return descale ? div_ftz(y, s) : y;
}

// hw_sr with 16 random bits ``rb``: add below the cut and truncate in the
// normal range (the add wraps in 32 bits), floor(|x|/g + rb/2^16) * g on
// the subnormal grid (bf16: exact zero), saturate; NaN and (e5m2, bf16)
// ±inf pass through.
template <int F>
__device__ __forceinline__ float hw_sr(float x, float s, uint32_t rb,
                                       bool descale = true) {
  using H = Hw<F>;
  const float xs0 = mul_ftz(x, s);
  const uint32_t u = __float_as_uint(clip_hw<F>(xs0));
  const uint32_t sign = u & 0x80000000u, mag = u & 0x7FFFFFFFu;
  const int e = static_cast<int>(mag >> 23) - 127;
  rb &= 0xFFFFu;
  float y;
  if (e >= H::emin) {
    constexpr int cut = 23 - H::mant;
    const uint32_t radd = cut >= 16 ? rb << (cut - 16) : rb >> (16 - cut);
    y = __uint_as_float((mag + radd) & (0xFFFFFFFFu << cut));
  } else if constexpr (H::mant - H::emin > 126) {
    y = 0.0f;  // bf16: the subnormal grid is f32-subnormal, flushed to 0
  } else {
    constexpr float up = static_cast<float>(1u << (H::mant - H::emin));
    const float u01 = __fmul_rn(static_cast<float>(rb), 1.0f / 65536.0f);
    y = __fmul_rn(floorf(__fadd_rn(__fmul_rn(__uint_as_float(mag), up), u01)),
                  1.0f / up);
  }
  float out = clip_hw<F>(__uint_as_float(sign | __float_as_uint(y)));
  if (isnan(xs0) || (H::inf && isinf(xs0))) out = xs0;
  return descale ? div_ftz(out, s) : out;
}

// Variant codes of the hw route: bit 8 set, the format, bit 1 for SR.
__host__ __device__ constexpr int hw_code(int f, bool sr) {
  return 0x100 | (f << 4) | (sr ? 2 : 0);
}

// Runtime-selected cast onto the scaled grid, for K2's pre-pass: the cast
// with its last descale left out (the bit pipeline's mul_ftz(g, inv) and
// hw's div_ftz(y, s)), which K2's epilogue applies to the product.  ``rb``
// are the element's random bits (read by stochastic variants).  Returns x
// for an unknown code.
__device__ __forceinline__ float grid_code(int code, float x, float s,
                                           uint32_t rb) {
  switch (code) {
#define FP8_CAST_CASE(F, M, D) \
    case code_of(F, M, D): return cast_elem<F, M, D>(x, s, 1.0f, rb, true);
    FP8_CAST_VARIANTS(FP8_CAST_CASE)
#undef FP8_CAST_CASE
    case hw_code(E4M3, false): return hw_qdq<E4M3>(x, s, false);
    case hw_code(E5M2, false): return hw_qdq<E5M2>(x, s, false);
    case hw_code(BF16, false): return hw_qdq<BF16>(x, s, false);
    case hw_code(E4M3, true): return hw_sr<E4M3>(x, s, rb, false);
    case hw_code(E5M2, true): return hw_sr<E5M2>(x, s, rb, false);
    case hw_code(BF16, true): return hw_sr<BF16>(x, s, rb, false);
    default: return x;
  }
}

}  // namespace fp8
