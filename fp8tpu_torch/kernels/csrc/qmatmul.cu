// K2: the fused fake-quant GEMM, out = qdq(x; sx) @ qdq(w; sw[N]).
//
// Replaces fp8tpu/kernels/qmatmul.py::_qdq_matmul_kernel (impl="bitexact"),
// the Pallas kernel that every hw-patched Conv / Dense / Matmul runs.
// x is (M, K) with one per-tensor scale, w is (K, N) with one scale per
// output column; either operand may be left unquantized (code < 0).  Each
// tile is cast with the shared pipeline (cast.cuh) as it lands in shared
// memory, and the K loop runs inside the block: blocks run in parallel and
// carry nothing between each other, unlike the TPU's sequential k-grid
// with its scratch accumulator.
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
// during the current tile's FMAs; the cast variant is a template
// parameter for the main path's variants (e4m3 RNE activations, uncast or
// e4m3 weights); every other variant runs one 64x64 instance with a
// runtime switch, which at the main path's tiles would cost up to 1.7x
// on the H100 (k2_cast_path.py measures it).  No wgmma, TMA, cp.async or
// split-K yet.
#include <cstdint>
#include <cuda_runtime.h>

#include "cast.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int BK = 16;
constexpr int kNone = -1;      // operand not cast
constexpr int kRuntime = -2;   // cast variant chosen at run time
constexpr int kE4m3Rne = fp8::code_of(fp8::E4M3, fp8::RNE, 0);

template <int CODE>
__device__ __forceinline__ float cast_operand(float v, float s, float inv,
                                              int code) {
  if constexpr (CODE == kNone) {
    return v;
  } else if constexpr (CODE == kRuntime) {
    return code < 0 ? v : fp8::cast_code(code, v, s, inv);
  } else {
    return fp8::cast_elem<CODE / 16, (CODE % 16) / 2, (CODE % 2) != 0>(
        v, s, inv, 0u);
  }
}

// Row (or column) of a thread's i-th accumulator: groups of 4 consecutive
// elements, 64 apart, so that a quarter-warp's float4 reads of shared
// memory hit distinct banks.
__device__ __forceinline__ int lane_index(int t, int i) {
  return (i >> 2) * 64 + t * 4 + (i & 3);
}

template <int BM, int BN, int CX, int CW>
__global__ void __launch_bounds__(kThreads)
qdq_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int m, int n, int k, int code_x,
                  const float* __restrict__ sx, int code_w,
                  const float* __restrict__ sw) {
  constexpr int TM = BM / 16, TN = BN / 16;
  // +4 floats per row: the transposed x stores of one warp spread over all
  // banks, and rows stay 16-byte aligned for the float4 reads.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float s_x = 1.0f, inv_x = 1.0f;
  if (CX != kNone && code_x >= 0) {
    s_x = sx[0];
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
      ra[l] = (gm < m && gk < k) ? x[static_cast<long long>(gm) * k + gk]
                                 : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * kThreads;
      const int gk = k0 + idx / BN, gn = col0 + idx % BN;
      rb[l] = (gk < k && gn < n) ? w[static_cast<long long>(gk) * n + gn]
                                 : 0.0f;
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
    // Elements outside m x k and k x n stay exact zeros, uncast.
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * kThreads;
      const bool in = row0 + idx / BK < m && k0 + idx % BK < k;
      As[idx % BK][idx / BK] =
          in ? cast_operand<CX>(ra[l], s_x, inv_x, code_x) : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * kThreads;
      const int gn = col0 + idx % BN;
      float v = 0.0f;
      if (k0 + idx / BN < k && gn < n) {
        v = rb[l];
        if (CW != kNone) {
          const float s = sw[gn];
          v = cast_operand<CW>(v, s, fp8::recip_ftz(s), code_w);
        }
      }
      Bs[idx / BN][idx % BN] = v;
    }
    __syncthreads();
    if (k0 + BK < k) load_tile(k0 + BK);
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
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + lane_index(ty, i);
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + lane_index(tx, j);
      if (gn < n) out[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
}

template <int BM, int BN, int CX, int CW>
void launch(const float* x, const float* w, float* out, int m, int n, int k,
            int code_x, const float* sx, int code_w, const float* sw,
            cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  qdq_matmul_kernel<BM, BN, CX, CW><<<grid, kThreads, 0, stream>>>(
      x, w, out, m, n, k, code_x, sx, code_w, sw);
}

// The tile for the shape: large tiles cast less and reuse more, but need
// enough blocks to fill the SMs twice over; small-M layers take 64x64.
template <int CX, int CW>
void launch_shaped(const float* x, const float* w, float* out, int m, int n,
                   int k, int code_x, const float* sx, int code_w,
                   const float* sw, cudaStream_t stream) {
  const long long fill = 2LL * fp8::sm_count();
  const long long big_rows = (m + 127) / 128;
  if (n <= 64 && big_rows >= fill)
    launch<128, 64, CX, CW>(x, w, out, m, n, k, code_x, sx, code_w, sw,
                            stream);
  else if (n > 64 && big_rows * ((n + 127) / 128) >= fill)
    launch<128, 128, CX, CW>(x, w, out, m, n, k, code_x, sx, code_w, sw,
                             stream);
  else
    launch<64, 64, CX, CW>(x, w, out, m, n, k, code_x, sx, code_w, sw,
                           stream);
}

}  // namespace

// out (m, n) = cast(x (m, k); sx[0]) @ cast(w (k, n); sw[n]); a negative
// code leaves that operand uncast.  Row-major f32, contiguous.  Returns the
// launch's cudaError_t.
extern "C" int fp8_qdq_matmul(const float* x, const float* w, float* out,
                              int m, int n, int k, int code_x,
                              const float* sx, int code_w, const float* sw,
                              void* stream) {
  if (m == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_x == kE4m3Rne && code_w < 0)
    launch_shaped<kE4m3Rne, kNone>(x, w, out, m, n, k, code_x, sx, code_w,
                                   sw, s);
  else if (code_x == kE4m3Rne && code_w == kE4m3Rne)
    launch_shaped<kE4m3Rne, kE4m3Rne>(x, w, out, m, n, k, code_x, sx,
                                      code_w, sw, s);
  else  // any other cast variant: one 64x64 instance, its 50-way switch
    launch<64, 64, kRuntime, kRuntime>(x, w, out, m, n, k, code_x, sx,
                                       code_w, sw, s);
  return static_cast<int>(cudaGetLastError());
}
