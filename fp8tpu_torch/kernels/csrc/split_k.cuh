// Deterministic split-K in one launch, shared by K2 (qmatmul.cu) and by the
// weight GEMMs K3, K5 and T2 (w_gemm.cuh, w_stream.cuh).  gridDim.z blocks
// share one output tile's K range; each parks its f32 partial in a
// workspace of (splits, m, n) floats, and the block that arrives last at
// the tile's counter adds the partials in split order 0..S-1, so the bits
// do not depend on which block was last, then resets the counter for the
// next launch.  The host side is kernels/qmatmul.py::plan_splits.
#pragma once

#include <cuda_runtime.h>

namespace splitk {

__device__ __forceinline__ int tile_index() {
  return blockIdx.y * gridDim.x + blockIdx.x;
}

// Called by every thread of the block once its partial is stored: whether
// this block is the tile's last, in which case every partial is visible to
// it.  ``flag`` is a __shared__ int of the block.
__device__ __forceinline__ bool last_of_tile(int* counters, int splits,
                                             int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(&counters[tile_index()], 1) == splits - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// The same for a block where only threads 0 .. NTHREADS - 1 take part (a
// warp-specialised block whose producer warp has left): they meet on the
// named barrier 1 instead of __syncthreads.
template <int NTHREADS>
__device__ __forceinline__ bool last_of_tile_bar(int* counters, int splits,
                                                 int* flag) {
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" :: "n"(NTHREADS) : "memory");
  if (threadIdx.x == 0)
    *flag = atomicAdd(&counters[tile_index()], 1) == splits - 1;
  asm volatile("bar.sync 1, %0;\n" :: "n"(NTHREADS) : "memory");
  if (!*flag) return false;
  __threadfence();
  return true;
}

// The last block, after its sums: the tile's counter back to zero.
__device__ __forceinline__ void release_tile(int* counters) {
  if (threadIdx.x == 0) counters[tile_index()] = 0;
}

// Element ``at`` of the partials summed in split order.  w_gemm.cuh and
// w_stream.cuh keep their own sums, which start every split's load before
// the first add.
__device__ __forceinline__ float ordered_sum(const float* ws, long long plane,
                                             long long at, int splits) {
  float sum = 0.0f;
  for (int z = 0; z < splits; ++z) sum += __ldcg(ws + z * plane + at);
  return sum;
}

}  // namespace splitk
