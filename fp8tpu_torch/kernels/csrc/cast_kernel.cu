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
// torch version.
//
// Bound on the H100: bytes.  It reads 4 bytes and writes 4 bytes per
// element (3.35 TB/s); its ~50-100 integer operations per element stay
// under the SMs' integer rate.  Simple first design: a grid-stride loop,
// one element per thread per step, no vector loads.
#include <cstdint>
#include <cuda_runtime.h>

#include "cast.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rand_bits(const int* rbits, int rb_mode,
                                              uint32_t salt, long long i) {
  if (rb_mode == 1) return static_cast<uint32_t>(rbits[i]);
  if (rb_mode == 2) return fp8::sr_hash(salt, static_cast<uint32_t>(i));
  return 0u;
}

template <int F, int M, bool D>
__global__ void cast_kernel(const float* __restrict__ x,
                            float* __restrict__ y, long long n,
                            const float* __restrict__ scale, long long inner,
                            long long nscale, int block_size,
                            const int* __restrict__ rbits, int rb_mode,
                            uint32_t salt) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  if (block_size > 0) {
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
      for (long long i = lo + lane; i < hi; i += 32)
        y[i] = fp8::cast_elem<F, M, D>(x[i], s, inv,
                                       rand_bits(rbits, rb_mode, salt, i));
    }
    return;
  }
  if (nscale == 1) {
    const float s = scale[0];
    const float inv = fp8::recip_ftz(s);
    for (long long i = tid; i < n; i += nthreads)
      y[i] = fp8::cast_elem<F, M, D>(x[i], s, inv,
                                     rand_bits(rbits, rb_mode, salt, i));
    return;
  }
  for (long long i = tid; i < n; i += nthreads) {
    const float s = scale[(i / inner) % nscale];
    y[i] = fp8::cast_elem<F, M, D>(x[i], s, fp8::recip_ftz(s),
                                   rand_bits(rbits, rb_mode, salt, i));
  }
}

template <int F, int M, bool D>
void launch(const float* x, float* y, long long n, const float* scale,
            long long inner, long long nscale, int block_size,
            const int* rbits, int rb_mode, uint32_t salt,
            cudaStream_t stream) {
  const long long work = block_size > 0
      ? ((n + block_size - 1) / block_size) * 32 : n;
  const long long cap = 64LL * fp8::sm_count();
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  cast_kernel<F, M, D><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(x, y, n, scale, inner, nscale, block_size,
                                   rbits, rb_mode, salt);
}

}  // namespace

// y[i] = cast(x[i]) for the variant ``code`` (fp8::code_of).  rb_mode: 0 no
// bits, 1 bits from ``rbits`` (int32, one per element), 2 hashed from
// ``salt``.  Returns the launch's cudaError_t, or -1 for an unknown code.
extern "C" int fp8_cast(int code, const float* x, float* y, long long n,
                        const float* scale, long long inner, long long nscale,
                        int block_size, const int* rbits, int rb_mode,
                        unsigned int salt, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code) {
#define FP8_LAUNCH_CASE(F, M, D)                                          \
    case fp8::code_of(F, M, D):                                           \
      launch<F, M, D>(x, y, n, scale, inner, nscale, block_size, rbits,   \
                      rb_mode, salt, s);                                  \
      break;
    FP8_CAST_VARIANTS(FP8_LAUNCH_CASE)
#undef FP8_LAUNCH_CASE
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
