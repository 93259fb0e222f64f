// K6, the in-place dynamic row store:  buf[idx mod n] = slab
//
// Replaces fp8tpu/kernels/inplace.py::_store_kernel.  buf is (n, ...) of any
// 1-, 2- or 4-byte type, slab one row of it, idx a 32-bit integer in device
// memory.  The kernel reads idx itself, so the launch needs no host
// synchronisation and can be captured in a CUDA graph; it writes buf where
// it lies and copies nothing else.  A negative idx wraps to a non-negative
// row, as jnp's % does.
//
// Bound on an H100: the bytes of one row, read once and written once.  The
// copy uses 16-byte loads and stores when the destination row and the slab
// are 16-byte aligned, single bytes otherwise (and for the tail).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void dyn_store_kernel(unsigned char* buf, const unsigned char* slab,
                                 const int* idx, long long n,
                                 long long row_bytes) {
    long long r = (long long)(*idx) % n;
    if (r < 0) r += n;
    unsigned char* dst = buf + r * row_bytes;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long done = 0;
    if (((reinterpret_cast<uintptr_t>(dst)
          | reinterpret_cast<uintptr_t>(slab)) & 15) == 0) {
        const long long nvec = row_bytes / 16;
        const uint4* s4 = reinterpret_cast<const uint4*>(slab);
        uint4* d4 = reinterpret_cast<uint4*>(dst);
        for (long long i = tid; i < nvec; i += stride) d4[i] = s4[i];
        done = nvec * 16;
    }
    for (long long i = done + tid; i < row_bytes; i += stride)
        dst[i] = slab[i];
}

}  // namespace

extern "C" int fp8_dyn_store(void* buf, const void* slab, const void* idx,
                             long long n, long long row_bytes, int max_blocks,
                             void* stream) {
    if (row_bytes <= 0 || n <= 0) return (int)cudaSuccess;
    const int threads = 256;
    long long blocks = (row_bytes / 16 + threads - 1) / threads;
    if (blocks < 1) blocks = 1;
    if (blocks > max_blocks) blocks = max_blocks;
    dyn_store_kernel<<<(unsigned)blocks, threads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<unsigned char*>(buf),
        reinterpret_cast<const unsigned char*>(slab),
        reinterpret_cast<const int*>(idx), n, row_bytes);
    return (int)cudaGetLastError();
}
