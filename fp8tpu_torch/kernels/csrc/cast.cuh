// The fake-quant cast pipeline as device functions, shared by the cast
// kernel (cast_kernel.cu) and the fused fake-quant GEMM (qmatmul.cu), the
// way fp8tpu/numerics/cast.py::cast_array is shared by both Pallas kernels.
//
// Bit-for-bit the pipeline of fp8tpu_torch/numerics/cast.py (the plain
// torch version): every format x rounding mode x DAZ of the mode-string
// ABI, fp32 -> fp16 bit pattern (RNE) -> per-format GRS rounding ->
// fp32.  uint32 arithmetic wraps here as it does in the JAX code.
//
// Subnormal f32 values: XLA flushes them in f32 arithmetic (DAZ on inputs,
// FTZ on results), and the plain version reproduces that explicitly.  This
// file does the same with explicit code (flush(), mul_ftz(), recip_ftz())
// instead of compiler flags, so it is built without --use_fast_math and
// without -ftz=true, and the multiplies use __fmul_rn so that they are
// never contracted into an FMA.
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

template <int M, bool DAZ>
__device__ __forceinline__ float cast_e5m2(float x, float s, float inv,
                                           uint32_t rb) {
  using G = Geo<E5M2>;
  int h = f32_to_f16_bits(mul_ftz(x, s));
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
  return mul_ftz(f16_bits_to_f32(h), inv);
}

template <int F, int M>
__device__ __forceinline__ float cast_rebias(float x, float s, float inv,
                                             uint32_t rb) {
  using G = Geo<F>;
  const int h = f32_to_f16_bits(mul_ftz(x, s));
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
  return mul_ftz(f16_bits_to_f32(out), inv);
}

template <int M>
__device__ __forceinline__ float cast_e4m3_v2(float x, float s, float inv,
                                              uint32_t rb) {
  using G = Geo<E4M3>;
  const int h = f32_to_f16_bits(mul_ftz(x, s));
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
  return mul_ftz(f16_bits_to_f32(out), inv);
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

template <int M, bool DAZ>
__device__ __forceinline__ float cast_f16(float x, uint32_t rb) {
  if (M == RNE) {
    int bits = f32_to_f16_bits(x);
    if (DAZ && (bits & 0x7C00) == 0) bits = 0;
    return f16_bits_to_f32(bits);
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

__device__ __forceinline__ float cast_e5m2_noinf(float x, float s,
                                                 float inv) {
  const int h = f32_to_f16_bits(mul_ftz(x, s));
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
  return mul_ftz(f16_bits_to_f32(out), inv);
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

// One element: ``s`` its scale, ``inv`` = recip_ftz(s), ``rb`` its 16
// random bits (read only by STOCHASTIC instances and float16's non-RNE
// path).
template <int F, int M, bool DAZ>
__device__ __forceinline__ float cast_elem(float x, float s, float inv,
                                           uint32_t rb) {
  if constexpr (F == E5M2) return cast_e5m2<M, DAZ>(x, s, inv, rb);
  else if constexpr (F == E4M3 || F == E4M3_IEEE || F == E3M4)
    return cast_rebias<F, M>(x, s, inv, rb);
  else if constexpr (F == E4M3_V2) return cast_e4m3_v2<M>(x, s, inv, rb);
  else if constexpr (F == FP4) return cast_fp4(x, s, inv);
  else if constexpr (F == BF16) return cast_bf16<M>(x, rb);
  else if constexpr (F == F16) return cast_f16<M, DAZ>(x, rb);
  else if constexpr (F == E5M2_NOINF) return cast_e5m2_noinf(x, s, inv);
  else return cast_e5m2_flex(x);
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

// Runtime-selected cast for callers that take the variant as an argument
// (the GEMM's operand casts).  Returns x for an unknown code.
__device__ __forceinline__ float cast_code(int code, float x, float s,
                                           float inv) {
  switch (code) {
#define FP8_CAST_CASE(F, M, D) \
    case code_of(F, M, D): return cast_elem<F, M, D>(x, s, inv, 0u);
    FP8_CAST_VARIANTS(FP8_CAST_CASE)
#undef FP8_CAST_CASE
    default: return x;
  }
}

}  // namespace fp8
