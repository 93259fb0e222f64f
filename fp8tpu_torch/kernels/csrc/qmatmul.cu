// K2: the fused fake-quant GEMM, out = qdq(x; sx) @ qdq(w; sw[N]).
//
// Replaces fp8tpu/kernels/qmatmul.py::_qdq_matmul_kernel, the Pallas
// kernel that every hw-patched Conv / Dense / Matmul runs, forward and
// backward.  x is (M, K) with one per-tensor scale, w is (K, N) with one
// scale per output column; either operand may be left unquantized
// (code < 0).  Each tile is cast as it lands in shared memory, with the
// bit pipeline ("bitexact", cast.cuh::cast_elem) or the hardware-convert
// route ("hw", cast.cuh::hw_qdq / hw_sr), and the K loop runs inside the
// block: blocks run in parallel and carry nothing between each other,
// unlike the TPU's sequential k-grid with its scratch accumulator.
//
// Stochastic rounding: the TPU kernel draws per-tile bits from the TPU's
// PRNG, a stream no other device reproduces.  Here an operand's 16 bits
// are the murmur3 counter hash of its salt and the element's row-major
// index in the unpadded operand (numerics/cast.py::sr_bits_from_salt), the
// stream of the JAX package's CPU route (_qdq_matmul_jnp), so SR through
// K2 is bit-equal to it.
//
// Arithmetic: IEEE f32 products with f32 accumulation on the SIMT units,
// no TF32 and no tensor cores, as the TPU kernel contracts at
// Precision.HIGHEST.  Results differ from torch.matmul only by summation
// order.
//
// Bound on the H100: operations, 2*M*N*K f32 FMAs at the SIMT f32 peak
// (67 TFLOP/s), plus the integer cast work on each operand tile: an x tile
// is cast once per column block, so wider tiles cast less.
//
// Simple first design: 256 threads in a 16x16 grid, each with a TMxTN
// register tile read from shared memory as float4s; 128x128, 128x64 or
// 64x64 output tiles picked by shape so that small-M layers still fill
// the SMs; BK = 16 with the next tile's global loads held in registers
// during the current tile's FMAs.  The cast variant is a template
// parameter for the training and PTQ paths' variants (bitexact e4m3 RNE
// activations with uncast or e4m3 weights; hw e4m3 / e5m2 RNE activations
// with uncast weights; uncast x uncast, the backward's); every other
// variant runs one 64x64 instance with a runtime switch (k2_cast_path.py
// measures what that costs).  An output with few tiles and a long K (the
// backward's weight gradient: 576 x 64 over K = 100352 at ResNet-50's
// first stage) splits K over grid.z (split_k.cuh: the last block of a
// tile to finish adds the partials in split order 0..S-1, so one launch
// gives the same bits every time).  No wgmma, TMA or cp.async yet.
#include <cstdint>
#include <cuda_runtime.h>

#include "cast.cuh"
#include "split_k.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int BK = 16;
constexpr int kNone = -1;      // operand not cast
constexpr int kRuntime = -2;   // cast variant chosen at run time
constexpr int kE4m3Rne = fp8::code_of(fp8::E4M3, fp8::RNE, 0);
constexpr int kHwE4m3 = fp8::hw_code(fp8::E4M3, false);
constexpr int kHwE5m2 = fp8::hw_code(fp8::E5M2, false);

template <int CODE>
__device__ __forceinline__ float cast_operand(float v, float s, float inv,
                                              int code, uint32_t rb) {
  if constexpr (CODE == kNone) {
    return v;
  } else if constexpr (CODE == kRuntime) {
    return code < 0 ? v : fp8::cast_code(code, v, s, inv, rb);
  } else if constexpr (CODE == kHwE4m3) {
    return fp8::hw_qdq<fp8::E4M3>(v, s);
  } else if constexpr (CODE == kHwE5m2) {
    return fp8::hw_qdq<fp8::E5M2>(v, s);
  } else {
    return fp8::cast_elem<CODE / 16, (CODE % 16) / 2, (CODE % 2) != 0>(
        v, s, inv, 0u);
  }
}

// Random bits of the element at row-major ``idx`` of an operand: only the
// runtime instance casts stochastically; salt < 0 means zero bits.
template <int CODE>
__device__ __forceinline__ uint32_t bits_at(long long salt, long long idx) {
  if constexpr (CODE == kRuntime) {
    return salt < 0 ? 0u
                    : fp8::sr_hash(static_cast<uint32_t>(salt),
                                   static_cast<uint32_t>(idx));
  } else {
    return 0u;
  }
}

// Row (or column) of a thread's i-th accumulator: groups of 4 consecutive
// elements, 64 apart, so that a quarter-warp's float4 reads of shared
// memory hit distinct banks.
__device__ __forceinline__ int lane_index(int t, int i) {
  return (i >> 2) * 64 + t * 4 + (i & 3);
}

struct Args {
  const float* x;
  const float* w;
  float* out;
  int m, n, k;
  int code_x, code_w;
  const float* sx;
  const float* sw;
  long long salt_x, salt_w;
  int splits, kper;          // K split over grid.z, kper rows per split
  float* ws;                 // (splits, m, n) partials when splits > 1
  int* counters;             // one per output tile, zero between launches
};

template <int BM, int BN, int CX, int CW>
__global__ void __launch_bounds__(kThreads) qdq_matmul_kernel(Args A) {
  constexpr int TM = BM / 16, TN = BN / 16;
  // +4 floats per row: the transposed x stores of one warp spread over all
  // banks, and rows stay 16-byte aligned for the float4 reads.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int is_last;
  const int m = A.m, n = A.n, k = A.k;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * A.kper;
  const int k_end = min(k, k_begin + A.kper);

  float s_x = 1.0f, inv_x = 1.0f;
  if (CX != kNone && A.code_x >= 0) {
    s_x = A.sx[0];
    inv_x = fp8::recip_ftz(s_x);
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // Each thread stages LA x and LB w elements per k-tile.  The next tile's
  // global loads are issued before this tile's FMAs, so their latency
  // overlaps the compute; they are cast and stored after it.
  constexpr int LA = (BM * BK) / kThreads, LB = (BK * BN) / kThreads;
  float ra[LA], rb[LB];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * kThreads;
      const int gm = row0 + idx / BK, gk = k0 + idx % BK;
      ra[l] = (gm < m && gk < k_end)
                  ? A.x[static_cast<long long>(gm) * k + gk] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * kThreads;
      const int gk = k0 + idx / BN, gn = col0 + idx % BN;
      rb[l] = (gk < k_end && gn < n)
                  ? A.w[static_cast<long long>(gk) * n + gn] : 0.0f;
    }
  };

  load_tile(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // Elements outside m x k and k x n stay exact zeros, uncast.
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * kThreads;
      const int gm = row0 + idx / BK, gk = k0 + idx % BK;
      float v = 0.0f;
      if (gm < m && gk < k_end) {
        const long long at = static_cast<long long>(gm) * k + gk;
        v = cast_operand<CX>(ra[l], s_x, inv_x, A.code_x,
                             bits_at<CX>(A.salt_x, at));
      }
      As[idx % BK][idx / BK] = v;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * kThreads;
      const int gk = k0 + idx / BN, gn = col0 + idx % BN;
      float v = 0.0f;
      if (gk < k_end && gn < n) {
        v = rb[l];
        if (CW != kNone) {
          const float s = A.sw[gn];
          const long long at = static_cast<long long>(gk) * n + gn;
          v = cast_operand<CW>(v, s, fp8::recip_ftz(s), A.code_w,
                               bits_at<CW>(A.salt_w, at));
        }
      }
      Bs[idx / BN][idx % BN] = v;
    }
    __syncthreads();
    if (k0 + BK < k_end) load_tile(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            &As[kk][lane_index(ty, i)]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            &Bs[kk][lane_index(tx, j)]);
        b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (A.splits == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = row0 + lane_index(ty, i);
      if (gm >= m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = col0 + lane_index(tx, j);
        if (gn < n) A.out[static_cast<long long>(gm) * n + gn] = acc[i][j];
      }
    }
    return;
  }

  // Split K: publish this split's partial tile; the tile's last block
  // adds all partials in split order.
  const long long plane = static_cast<long long>(m) * n;
  float* part = A.ws + blockIdx.z * plane;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + lane_index(ty, i);
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + lane_index(tx, j);
      if (gn < n) part[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
  if (!splitk::last_of_tile(A.counters, A.splits, &is_last)) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + lane_index(ty, i);
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + lane_index(tx, j);
      if (gn >= n) continue;
      const long long at = static_cast<long long>(gm) * n + gn;
      A.out[at] = splitk::ordered_sum(A.ws, plane, at, A.splits);
    }
  }
  splitk::release_tile(A.counters);
}

template <int BM, int BN, int CX, int CW>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM, a.splits);
  qdq_matmul_kernel<BM, BN, CX, CW><<<grid, kThreads, 0, stream>>>(a);
}

// The tile for the shape: large tiles cast less and reuse more, but need
// enough blocks to fill the SMs twice over; small-M layers and split-K
// launches take 64x64.
template <int CX, int CW>
void launch_shaped(const Args& a, cudaStream_t stream) {
  const long long fill = 2LL * fp8::sm_count();
  const long long big_rows = (a.m + 127) / 128;
  if (a.splits == 1 && a.n <= 64 && big_rows >= fill)
    launch<128, 64, CX, CW>(a, stream);
  else if (a.splits == 1 && a.n > 64
           && big_rows * ((a.n + 127) / 128) >= fill)
    launch<128, 128, CX, CW>(a, stream);
  else
    launch<64, 64, CX, CW>(a, stream);
}

}  // namespace

// out (m, n) = cast(x (m, k); sx[0]) @ cast(w (k, n); sw[n]); a negative
// code leaves that operand uncast, a negative salt gives it zero random
// bits.  Row-major f32, contiguous.  ``splits`` > 1 splits K in ``kper``
// rows (a multiple of 16) over 64x64 tiles, with ``ws`` holding
// (splits, m, n) floats and ``counters`` one zeroed int per tile.
// Returns the launch's cudaError_t.
extern "C" int fp8_qdq_matmul(const float* x, const float* w, float* out,
                              int m, int n, int k, int code_x,
                              const float* sx, long long salt_x, int code_w,
                              const float* sw, long long salt_w, int splits,
                              int kper, float* ws, int* counters,
                              void* stream) {
  if (m == 0 || n == 0) return 0;
  const Args a{x, w, out, m, n, k, code_x, code_w, sx, sw, salt_x, salt_w,
               splits, kper, ws, counters};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_x < 0 && code_w < 0)
    launch_shaped<kNone, kNone>(a, s);
  else if (code_x == kE4m3Rne && code_w < 0)
    launch_shaped<kE4m3Rne, kNone>(a, s);
  else if (code_x == kE4m3Rne && code_w == kE4m3Rne)
    launch_shaped<kE4m3Rne, kE4m3Rne>(a, s);
  else if (code_x == kHwE4m3 && code_w < 0)
    launch_shaped<kHwE4m3, kNone>(a, s);
  else if (code_x == kHwE5m2 && code_w < 0)
    launch_shaped<kHwE5m2, kNone>(a, s);
  else  // any other cast variant: one 64x64 instance, its runtime switch
    launch<64, 64, kRuntime, kRuntime>(a, s);
  return static_cast<int>(cudaGetLastError());
}
