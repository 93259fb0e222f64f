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

#include <cuda_fp8.h>

#include "w_gemm.cuh"

namespace {

enum Payload { E4M3 = 0, E5M2 = 1, INT8 = 2 };

template <int FMT>
__device__ __forceinline__ float2 upcast2(unsigned short two) {
    // two payload bytes -> two floats (low byte first)
    if constexpr (FMT == INT8) {
        return make_float2((float)(signed char)(two & 0xFF),
                           (float)(signed char)(two >> 8));
    } else {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            (__nv_fp8x2_storage_t)two, FMT == E4M3 ? __NV_E4M3 : __NV_E5M2);
        return __half22float2(*reinterpret_cast<const __half2*>(&h));
    }
}

template <int FMT>
struct W8 {
    // Thread t owns K rows (k0 + 2p, k0 + 2p + 1), p = t / 4, and the 16
    // columns from n0 + 16 * (t % 4).
    struct Regs { uint4 a, b; };

    static __device__ __forceinline__ uint4 row16(const wg::Args& A, int k,
                                                  int kend, int c) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k >= kend || c >= A.n) return v;
        const unsigned char* p =
            reinterpret_cast<const unsigned char*>(A.w) + (size_t)k * A.n + c;
        if (A.vec_w && c + 16 <= A.n)
            return *reinterpret_cast<const uint4*>(p);
        unsigned char* d = reinterpret_cast<unsigned char*>(&v);
#pragma unroll
        for (int e = 0; e < 16; ++e)
            if (c + e < A.n) d[e] = p[e];
        return v;
    }

    static __device__ __forceinline__ void fetch(Regs& r, const wg::Args& A,
                                                 int k0, int kend, int n0,
                                                 int t) {
        const int k = k0 + 2 * (t >> 2), c = n0 + 16 * (t & 3);
        r.a = row16(A, k, kend, c);
        r.b = row16(A, k + 1, kend, c);
    }

    static __device__ __forceinline__ void stash(const Regs& r,
                                                 const wg::Args&, int, int,
                                                 int t,
                                                 uint32_t (*wp)[wg::WS]) {
        const unsigned short* a =
            reinterpret_cast<const unsigned short*>(&r.a);
        const unsigned short* b =
            reinterpret_cast<const unsigned short*>(&r.b);
        uint32_t* dst = &wp[t >> 2][16 * (t & 3)];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
            uint4 o;
            float2 lo = upcast2<FMT>(a[e]), hi = upcast2<FMT>(b[e]);
            o.x = wg::pack_bf16(lo.x, hi.x);
            o.y = wg::pack_bf16(lo.y, hi.y);
            lo = upcast2<FMT>(a[e + 1]);
            hi = upcast2<FMT>(b[e + 1]);
            o.z = wg::pack_bf16(lo.x, hi.x);
            o.w = wg::pack_bf16(lo.y, hi.y);
            *reinterpret_cast<uint4*>(dst + 2 * e) = o;
        }
    }

    static __device__ __forceinline__ float epilogue_scale(const wg::Args& A,
                                                           int col) {
        return A.s[col];
    }

    // -- the streaming kernel: a slab is 64 rows of 128 payload bytes -------
    static constexpr int RAW_ROWS = wg::BK;

    static __device__ __forceinline__ void copy_in(unsigned char* raw,
                                                   const wg::Args& A, int k0,
                                                   int kend, int n0, int t) {
        const unsigned char* w = reinterpret_cast<const unsigned char*>(A.w);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int id = t + i * wg::FTHREADS;
            const int row = id >> 3, cc = (id & 7) * 16;
            const bool ok = k0 + row < kend && n0 + cc < A.n;
            wg::cp_async16(raw + row * wg::FBN + cc,
                           ok ? w + (size_t)(k0 + row) * A.n + n0 + cc : w,
                           ok);
        }
    }

    // Thread t pairs rows (2p, 2p + 1), p = t / 8, at the columns
    // 32 j + 4 (t % 8) .. + 3, j = 0..3: 4-byte reads and 16-byte stores
    // that are both conflict-free.
    static __device__ __forceinline__ void convert(const unsigned char* raw,
                                                   const wg::Args&, int, int,
                                                   int t,
                                                   uint32_t (*wp)[wg::FWS]) {
        const int p = t >> 3, c = (t & 7) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint32_t a = *reinterpret_cast<const uint32_t*>(
                raw + (2 * p) * wg::FBN + j * 32 + c);
            const uint32_t b = *reinterpret_cast<const uint32_t*>(
                raw + (2 * p + 1) * wg::FBN + j * 32 + c);
            const float2 a01 = upcast2<FMT>((unsigned short)(a & 0xFFFF));
            const float2 a23 = upcast2<FMT>((unsigned short)(a >> 16));
            const float2 b01 = upcast2<FMT>((unsigned short)(b & 0xFFFF));
            const float2 b23 = upcast2<FMT>((unsigned short)(b >> 16));
            *reinterpret_cast<uint4*>(&wp[p][j * 32 + c]) = make_uint4(
                wg::pack_bf16(a01.x, b01.x), wg::pack_bf16(a01.y, b01.y),
                wg::pack_bf16(a23.x, b23.x), wg::pack_bf16(a23.y, b23.y));
        }
    }
};

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
