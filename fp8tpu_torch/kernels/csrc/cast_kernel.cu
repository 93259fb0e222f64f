// K1: the fake-quant cast kernel.
//
// Replaces fp8tpu/kernels/cast_kernel.py::_kernel_body (the Pallas TPU
// kernel behind pallas_qdq).  One launch casts a whole tensor onto an FP8 /
// FP4 / bf16 / fp16 grid: every format x rounding mode x DAZ of the
// mode-string ABI, as template parameters; the pipeline itself is
// cast.cuh, shared with the GEMM (qmatmul.cu).
//
// Scales: a scalar, a tensor broadcast along one run of axes (element i
// reads scale[(i / inner) % nscale]), or per-block scales computed in the
// kernel from the block's absmax (one warp per block, shuffle reduction),
// following numerics/cast.py::qdq_blocked (1/amax for fp4) and not the
// Pallas body, whose fp4 block scale differs.
//
// Stochastic rounding: bits come from a tensor, or are hashed here from a
// 32-bit salt and the element's flat index (sr_hash), the same bits that
// numerics/cast.py::sr_bits gives, so SR is bit-exact against the plain
// torch version.  The block route (fp8_cast_block) casts a rank's block of
// a larger tensor split over data, sequence and model (a column block, a
// sequence chunk): it hashes each element's index in the global tensor,
// computed here from the block's runs (local extents L1, L2, global
// extents G1, G2, starts s0, s1, s2; element (i0, i1, i2) of the block is
// global ((s0 + i0) G1 + s1 + i1) G2 + s2 + i2, mod 2^32 as the hash takes
// it).  A contiguous block, s1 = s2 = 0 with L = G, is the salt's stream
// at offset s0 G1 G2: the SALT_BITS route's bits.
//
// Bound on the H100: bytes, 4 read and 4 written per element at 3.35 TB/s,
// once the work per element fits the SMs' issue rate: 0.62 SM cycles an
// element at (32, 256, 56, 56) (132 SMs at 1.98 GHz), about 80 issued
// instructions or 40 integer ones.  The first design (one element a thread
// per step, 64-bit indices, the bit-level emulation of every step) ran at
// 37% of HBM (165 µs at (32, 256, 56, 56) on an H100 80GB HBM3, 700 W).
// Its loads and stores alone took 84 µs, its cast alone on data made in
// registers 152 µs, a loop of 130 SASS instructions an element
// (fp8tpu_torch/tools/k1_probe.py): it was bound by instruction issue, not
// by bytes.  So:
//
// * the hardware route of cast.cuh (mul.rn.ftz, cvt.rn.f16.f32, cvt.f32.f16),
//   with the host's NaN rules left to the emulation, taken for a group of
//   elements only where the group holds a NaN product;
// * 16-byte loads and streaming stores, two groups of 4 elements a thread
//   in flight (64 KB a full SM), a contiguous range of groups a block,
//   32-bit indices (the wrapper takes this path for n < 2^31 with 16-byte
//   aligned x, y and bits); the ragged tail (n % 4) as scalars in the same
//   launch; unaligned tensors take the scalar grid-stride kernel;
// * the bits' source and the scale layout as template parameters, and a
//   broadcast scale's index by multiply-shift division.

#include <cstdint>
#include <cuda_runtime.h>

#include "cast.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;       // groups of 4 elements a thread has in flight

enum Bits { NO_BITS = 0, TENSOR_BITS = 1, SALT_BITS = 2, BLOCK_SALT = 3 };
enum Scale { SCALAR = 0, BROADCAST = 1 };

// floor(n / d) for n < 2^31: (n * m) >> shift, m = ceil(2^shift / d),
// shift = 31 + ceil(log2 d) (Granlund and Montgomery, Theorem 4.2).
struct FastDiv {
  uint32_t d, m, shift;
};

FastDiv make_div(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint32_t shift = 31 + l;
  const unsigned long long m = ((1ull << shift) + d - 1) / d;
  return {d, static_cast<uint32_t>(m), shift};
}

__device__ __forceinline__ uint32_t div(uint32_t n, const FastDiv& f) {
  return static_cast<uint32_t>(
      (static_cast<unsigned long long>(n) * f.m) >> f.shift);
}

struct Layout {                  // element i reads scale[(i / inner) % nscale]
  FastDiv inner, nscale;
};

// A block of a larger tensor (see the header, fp8::BlockRuns): local
// element i is (i0, i1, i2) with i = (i0 L1 + i1) L2 + i2.
struct BlockIdx {
  FastDiv l2, l1;                // the vector path's divisions (i < 2^31)
  fp8::BlockRuns r;              // the scalar path's
};

__device__ __forceinline__ uint32_t global_index(uint32_t i,
                                                 const BlockIdx& b) {
  const uint32_t q = div(i, b.l2);
  const uint32_t i2 = i - q * b.l2.d;
  const uint32_t i0 = div(q, b.l1);
  const uint32_t i1 = q - i0 * b.l1.d;
  return ((b.r.s0 + i0) * b.r.g1 + b.r.s1 + i1) * b.r.g2 + b.r.s2 + i2;
}

__device__ __forceinline__ uint32_t global_index(long long i,
                                                 const BlockIdx& b) {
  return fp8::block_index(i, b.r);
}

template <int RB, typename I>
__device__ __forceinline__ uint32_t rand_bits(const int* rbits, uint32_t salt,
                                              I i, const BlockIdx& blk) {
  if constexpr (RB == TENSOR_BITS) return static_cast<uint32_t>(rbits[i]);
  else if constexpr (RB == SALT_BITS)
    return fp8::sr_hash(salt, static_cast<uint32_t>(i));
  else if constexpr (RB == BLOCK_SALT)
    return fp8::sr_hash(salt, global_index(i, blk));
  else return 0u;
}

// The vector path: n < 2^31, x, y (and rbits) 16-byte aligned.  Block b
// casts groups [b * per, min((b + 1) * per, n / 4)); block 0 also the
// ragged tail.
template <int F, int M, bool D, int RB, int SC>
__global__ void __launch_bounds__(kThreads)
cast_vec(const float* __restrict__ x, float* __restrict__ y, uint32_t n,
         const float* __restrict__ scale, Layout lay, uint32_t per,
         const int* __restrict__ rbits, uint32_t salt, BlockIdx blk) {
  const uint32_t ng = n / 4;
  const uint32_t g0 = blockIdx.x * per;
  const uint32_t g1 = min(g0 + per, ng);
  float s = scale[0], inv = fp8::recip_ftz(s);
  bool fast = fp8::fast_inv(inv);
  auto scale_at = [&](uint32_t i) {
    if constexpr (SC == BROADCAST) {
      const uint32_t q = div(i, lay.inner);
      s = scale[q - div(q, lay.nscale) * lay.nscale.d];
      inv = fp8::recip_ftz(s);
      fast = fp8::fast_inv(inv);
    }
  };
  for (uint32_t g = g0 + threadIdx.x; g < g1; g += kGroups * kThreads) {
    float4 v[kGroups];
    int4 r[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const uint32_t gk = g + k * kThreads;
      if (gk < g1) {
        v[k] = __ldg(reinterpret_cast<const float4*>(x) + gk);
        if constexpr (RB == TENSOR_BITS)
          r[k] = __ldg(reinterpret_cast<const int4*>(rbits) + gk);
      }
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const uint32_t gk = g + k * kThreads;
      if (gk >= g1) break;
      const uint32_t i0 = 4 * gk;
      float in[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      uint32_t rb[4] = {0u, 0u, 0u, 0u};
      if constexpr (RB == TENSOR_BITS) {
        rb[0] = r[k].x; rb[1] = r[k].y; rb[2] = r[k].z; rb[3] = r[k].w;
      } else if constexpr (RB == SALT_BITS || RB == BLOCK_SALT) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rb[e] = rand_bits<RB>(rbits, salt, i0 + e, blk);
      }
      float out[4];
      bool bad = false;
      if constexpr (fp8::has_hw_route<F, M>()) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          scale_at(i0 + e);
          bad |= !(fast || F == fp8::F16);
          out[e] = fp8::cast_route<F, M, D, true>(in[e], s, inv, rb[e], bad);
        }
      } else {
        bad = true;
      }
      if (bad) {       // a NaN product, or a format without the route
#pragma unroll 1
        for (int e = 0; e < 4; ++e) {
          scale_at(i0 + e);
          out[e] = fp8::cast_elem<F, M, D>(in[e], s, inv, rb[e], fast);
        }
      }
      __stcs(reinterpret_cast<float4*>(y) + gk,
             make_float4(out[0], out[1], out[2], out[3]));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * ng) {
    const uint32_t i = 4 * ng + threadIdx.x;
    scale_at(i);
    y[i] = fp8::cast_elem<F, M, D>(x[i], s, inv,
                                   rand_bits<RB>(rbits, salt, i, blk), fast);
  }
}

// The scalar path: any alignment and size, one element a thread per step.
template <int F, int M, bool D, int RB, int SC>
__global__ void __launch_bounds__(kThreads)
cast_scalar(const float* __restrict__ x, float* __restrict__ y, long long n,
            const float* __restrict__ scale, long long inner,
            long long nscale, const int* __restrict__ rbits, uint32_t salt,
            BlockIdx blk) {
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  float s = scale[0], inv = fp8::recip_ftz(s);
  bool fast = fp8::fast_inv(inv);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x; i < n; i += nthreads) {
    if constexpr (SC == BROADCAST) {
      s = scale[(i / inner) % nscale];
      inv = fp8::recip_ftz(s);
      fast = fp8::fast_inv(inv);
    }
    y[i] = fp8::cast_elem<F, M, D>(x[i], s, inv,
                                   rand_bits<RB>(rbits, salt, i, blk), fast);
  }
}

// Per-block scales: one warp per block of block_size elements.
template <int F, int M, bool D, int RB>
__global__ void __launch_bounds__(kThreads)
cast_blocked(const float* __restrict__ x, float* __restrict__ y, long long n,
             int block_size, const int* __restrict__ rbits, uint32_t salt) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  const long long nblocks = (n + block_size - 1) / block_size;
  for (long long b = tid >> 5; b < nblocks; b += nthreads >> 5) {
    const long long lo = b * block_size;
    const long long hi = min(lo + block_size, n);
    float amax = 0.0f;
    for (long long i = lo + lane; i < hi; i += 32)
      amax = fp8::nanmax(amax, fabsf(x[i]));
    for (int off = 16; off > 0; off >>= 1)
      amax = fp8::nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = fp8::block_scale<F>(amax);
    const float inv = fp8::recip_ftz(s);
    const bool fast = fp8::fast_inv(inv);
    for (long long i = lo + lane; i < hi; i += 32)
      y[i] = fp8::cast_elem<F, M, D>(x[i], s, inv,
                                     rand_bits<RB>(rbits, salt, i,
                                                   BlockIdx{}), fast);
  }
}

unsigned grid_for(long long work) {
  const long long cap = 64LL * fp8::sm_count();
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

template <int F, int M, bool D, int RB, int SC>
void launch_elementwise(const float* x, float* y, long long n,
                        const float* scale, long long inner, long long nscale,
                        bool vec, const int* rbits, uint32_t salt,
                        const BlockIdx& blk, cudaStream_t stream) {
  if (!vec) {
    cast_scalar<F, M, D, RB, SC><<<grid_for(n), kThreads, 0, stream>>>(
        x, y, n, scale, inner, nscale, rbits, salt, blk);
    return;
  }
  // Enough blocks for 8 an SM, each a contiguous run of groups that its
  // threads walk kGroups * kThreads at a time.
  const uint32_t ng = static_cast<uint32_t>(n / 4);
  const uint32_t step = kGroups * kThreads;
  const uint32_t cap = 8u * fp8::sm_count();
  uint32_t blocks = (ng + step - 1) / step;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const uint32_t per = ((ng + blocks - 1) / blocks + step - 1) / step * step;
  blocks = per ? (ng + per - 1) / per : 1;
  if (blocks < 1) blocks = 1;
  Layout lay{make_div(static_cast<uint32_t>(inner)),
             make_div(static_cast<uint32_t>(nscale))};
  cast_vec<F, M, D, RB, SC><<<blocks, kThreads, 0, stream>>>(
      x, y, static_cast<uint32_t>(n), scale, lay, per, rbits, salt, blk);
}

template <int F, int M, bool D, int RB>
void launch_rb(const float* x, float* y, long long n, const float* scale,
               long long inner, long long nscale, int block_size, bool vec,
               const int* rbits, uint32_t salt, const BlockIdx& blk,
               cudaStream_t stream) {
  if constexpr (RB != BLOCK_SALT) {      // the block route has no blocks
    if (block_size > 0) {
      const long long work = ((n + block_size - 1) / block_size) * 32;
      cast_blocked<F, M, D, RB><<<grid_for(work), kThreads, 0, stream>>>(
          x, y, n, block_size, rbits, salt);
      return;
    }
  }
  if (nscale == 1) {
    launch_elementwise<F, M, D, RB, SCALAR>(x, y, n, scale, inner, nscale,
                                            vec, rbits, salt, blk, stream);
  } else {
    launch_elementwise<F, M, D, RB, BROADCAST>(x, y, n, scale, inner, nscale,
                                               vec, rbits, salt, blk, stream);
  }
}

template <int F, int M, bool D>
void launch(const float* x, float* y, long long n, const float* scale,
            long long inner, long long nscale, int block_size, bool vec,
            const int* rbits, int rb_mode, uint32_t salt,
            const BlockIdx& blk, cudaStream_t stream) {
  // Only the stochastic instances (and float16's non-RNE path, which is
  // one) read bits.
  if constexpr (M == fp8::STOCHASTIC) {
    if (rb_mode == TENSOR_BITS) {
      launch_rb<F, M, D, TENSOR_BITS>(x, y, n, scale, inner, nscale,
                                      block_size, vec, rbits, salt, blk,
                                      stream);
      return;
    }
    if (rb_mode == SALT_BITS) {
      launch_rb<F, M, D, SALT_BITS>(x, y, n, scale, inner, nscale,
                                    block_size, vec, rbits, salt, blk,
                                    stream);
      return;
    }
    if (rb_mode == BLOCK_SALT) {
      launch_rb<F, M, D, BLOCK_SALT>(x, y, n, scale, inner, nscale,
                                     block_size, vec, rbits, salt, blk,
                                     stream);
      return;
    }
  }
  launch_rb<F, M, D, NO_BITS>(x, y, n, scale, inner, nscale, block_size, vec,
                              rbits, salt, blk, stream);
}

int cast_entry(int code, const float* x, float* y, long long n,
               const float* scale, long long inner, long long nscale,
               int block_size, const int* rbits, int rb_mode,
               unsigned int salt, int vec, const BlockIdx& blk,
               void* stream) {
  if (n == 0) return 0;
  if (vec && (n >= (1LL << 31) || inner >= (1LL << 31)
              || nscale >= (1LL << 31)
              || reinterpret_cast<uintptr_t>(x) % 16
              || reinterpret_cast<uintptr_t>(y) % 16
              || (rb_mode == TENSOR_BITS
                  && reinterpret_cast<uintptr_t>(rbits) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code) {
#define FP8_LAUNCH_CASE(F, M, D)                                          \
    case fp8::code_of(F, M, D):                                           \
      launch<F, M, D>(x, y, n, scale, inner, nscale, block_size, vec != 0,\
                      rbits, rb_mode, salt, blk, s);                      \
      break;
    FP8_CAST_VARIANTS(FP8_LAUNCH_CASE)
#undef FP8_LAUNCH_CASE
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y[i] = cast(x[i]) for the variant ``code`` (fp8::code_of).  rb_mode: 0 no
// bits, 1 bits from ``rbits`` (int32, one per element), 2 hashed from
// ``salt``.  vec: 1 when n < 2^31 and x, y and rbits are 16-byte aligned
// (the wrapper decides), for 16-byte accesses.  Returns the launch's
// cudaError_t, or -1 for an unknown code.
extern "C" int fp8_cast(int code, const float* x, float* y, long long n,
                        const float* scale, long long inner, long long nscale,
                        int block_size, const int* rbits, int rb_mode,
                        unsigned int salt, int vec, void* stream) {
  if (rb_mode == BLOCK_SALT) return static_cast<int>(cudaErrorInvalidValue);
  return cast_entry(code, x, y, n, scale, inner, nscale, block_size, rbits,
                    rb_mode, salt, vec, BlockIdx{}, stream);
}

// The block route: fp8_cast with bits hashed from ``salt`` at each element's
// global index (rb_mode 2 asks for it; no per-block scales).  blk: L1, L2
// (local extents of the inner runs, L1 L2 dividing n), G1, G2 (global
// extents), s0, s1, s2 (starts), the last five mod 2^32 (see the header).
extern "C" int fp8_cast_block(int code, const float* x, float* y,
                              long long n, const float* scale,
                              long long inner, long long nscale,
                              int block_size, const int* rbits, int rb_mode,
                              unsigned int salt, int vec,
                              const long long* blk, void* stream) {
  if (rb_mode != SALT_BITS || block_size != 0 || blk[0] < 1 || blk[1] < 1
      || n % (blk[0] * blk[1]) != 0
      || (vec && blk[0] * blk[1] >= (1LL << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  BlockIdx b{};
  if (vec) {
    b.l1 = make_div(static_cast<uint32_t>(blk[0]));
    b.l2 = make_div(static_cast<uint32_t>(blk[1]));
  }
  b.r = fp8::block_runs(blk);
  return cast_entry(code, x, y, n, scale, inner, nscale, block_size, rbits,
                    BLOCK_SALT, salt, vec, b, stream);
}
