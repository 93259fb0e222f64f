// K3's payload policy for the general kernel of w_gemm.cuh (see
// dequant_matmul.cu): e4m3, e5m2 or int8 bytes upcast to bf16 in registers
// by upcast2 (the hardware fp8 convert, then f16 -> f32).  upcast2 is also
// the hardware convert of the streaming loop's policies (dequant_matmul.cu,
// e4m3_convert.cuh).
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "w_gemm.cuh"

namespace w8 {

// I8_F16: int8 bytes against f16 x (W8A8's int8 route, W8F16)
enum Payload { E4M3 = 0, E5M2 = 1, INT8 = 2, I8_F16 = 3 };

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
    static constexpr bool F16 = false;      // bf16 x and weight pairs
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
};

// int8 bytes as f16 pairs against f16 x (mma.sync f16: W8A8's int8 route
// on shapes TMA cannot read); every int8 value is exact in f16.
struct W8F16 : W8<INT8> {
    static constexpr bool F16 = true;

    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        const __half2 h = __floats2half2_rn(lo, hi);    // .x = lo
        return *reinterpret_cast<const uint32_t*>(&h);
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
            float2 lo = upcast2<INT8>(a[e]), hi = upcast2<INT8>(b[e]);
            o.x = pack(lo.x, hi.x);
            o.y = pack(lo.y, hi.y);
            lo = upcast2<INT8>(a[e + 1]);
            hi = upcast2<INT8>(b[e + 1]);
            o.z = pack(lo.x, hi.x);
            o.w = pack(lo.y, hi.y);
            *reinterpret_cast<uint4*>(dst + 2 * e) = o;
        }
    }
};

}  // namespace w8
