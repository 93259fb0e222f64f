// K3, the serving linear:  out = (x @ upcast(w8)) * s[N]
//
// Replaces fp8tpu/kernels/qmatmul.py::_dequant_matmul_kernel.  x is (M, K)
// bf16, w8 a (K, N) payload of e4m3, e5m2 or int8 bytes, s one f32 scale
// per output column; the product accumulates in f32, is scaled in f32 and
// rounded once to bf16 or f32.  Every value of the three payload types is
// exact in bf16, and bf16 x bf16 products are exact in f32, so only the
// order of the f32 sums differs from the plain version.
//
// Bound on an H100: the bytes of w8 at decode (M <= 64), the bf16
// tensor-core rate at prefill.  The main loop, its tiling, the in-register
// upcast and the split-K scheme are in w_gemm.cuh.

#include "w8_policy.cuh"

namespace {

using w8::E4M3;
using w8::E5M2;
using w8::INT8;
using w8::W8;

template <int FMT>
cudaError_t launch_fmt(const wg::Args& A, int out_f32, cudaStream_t stream) {
    return out_f32 ? wg::launch<W8<FMT>, true>(A, stream)
                   : wg::launch<W8<FMT>, false>(A, stream);
}

}  // namespace

// payload: 0 e4m3, 1 e5m2, 2 int8.  ws / counters are used when splits > 1:
// ws holds splits * m * n floats, counters one zeroed int per output tile.
// stream_path: take the streaming kernel (needs m <= 64, k % 8 == 0,
// n % 16 == 0 and 16-byte aligned x and w8).
extern "C" int fp8_dequant_matmul(const void* x, const void* w8,
                                  const void* scales, void* out, int m, int n,
                                  int k, int payload, int out_f32, int splits,
                                  int kper, int stream_path, void* ws,
                                  void* counters, void* stream) {
    wg::Args A;
    A.x = reinterpret_cast<const __nv_bfloat16*>(x);
    A.w = w8;
    A.s = reinterpret_cast<const float*>(scales);
    A.out = out;
    A.ws = reinterpret_cast<float*>(ws);
    A.counters = reinterpret_cast<int*>(counters);
    A.m = m; A.n = n; A.k = k;
    A.splits = splits; A.kper = kper; A.group = 0;
    A.vec_x = (k % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    A.vec_w = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w8) % 16 == 0);
    A.stream_path = stream_path;
    if (stream_path && !(A.vec_x && A.vec_w && m <= 64))
        return (int)cudaErrorInvalidValue;
    if (splits < 1 || splits > wg::MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (payload) {
        case E4M3: return (int)launch_fmt<E4M3>(A, out_f32, st);
        case E5M2: return (int)launch_fmt<E5M2>(A, out_f32, st);
        case INT8: return (int)launch_fmt<INT8>(A, out_f32, st);
    }
    return (int)cudaErrorInvalidValue;
}
