// K5, the W4A16 unpack-GEMM:  out = x @ dequant_int4(wp)
//
// Replaces fp8tpu/kernels/int4_matmul.py::_int4_kernel.  wp is (K/2, N)
// uint8: byte r of a column holds w[2r] in its low nibble and w[2r + 1] in
// its high nibble, both signed.  Each packed byte is read once; both
// nibbles are sign-extended in registers and stored as one (w[2r], w[2r+1])
// bf16 pair, which is one B operand register of the MMA, so x is used as it
// lies in memory (the TPU kernel's de-interleave of x into even and odd
// columns is this indexing).  Scales: per column (N,), applied in f32 in
// the epilogue; or grouped (K/group, N), rounded to bf16 and multiplied
// into the unpacked weights in bf16 before the dot, as the TPU kernel does:
// that rounding is part of the function.
//
// Bound on an H100: the bytes of wp at decode, the bf16 tensor-core rate at
// prefill.  Main loop, tiling and split-K: w_gemm.cuh.

#include "w_gemm.cuh"

namespace {

struct W4 {
    // Thread t owns packed row k0/2 + t/4 (K rows k0 + 2p, k0 + 2p + 1) and
    // the 16 columns from n0 + 16 * (t % 4).
    struct Regs { uint4 a; };

    static __device__ __forceinline__ void fetch(Regs& r, const wg::Args& A,
                                                 int k0, int kend, int n0,
                                                 int t) {
        const int k = k0 + 2 * (t >> 2), c = n0 + 16 * (t & 3);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < kend && c < A.n) {
            const unsigned char* p =
                reinterpret_cast<const unsigned char*>(A.w)
                + (size_t)(k >> 1) * A.n + c;
            if (A.vec_w && c + 16 <= A.n) {
                v = *reinterpret_cast<const uint4*>(p);
            } else {
                unsigned char* d = reinterpret_cast<unsigned char*>(&v);
#pragma unroll
                for (int e = 0; e < 16; ++e)
                    if (c + e < A.n) d[e] = p[e];
            }
        }
        r.a = v;
    }

    static __device__ __forceinline__ void stash(const Regs& r,
                                                 const wg::Args& A, int k0,
                                                 int n0, int t,
                                                 uint32_t (*wp)[wg::WS]) {
        const unsigned char* b = reinterpret_cast<const unsigned char*>(&r.a);
        const int k = k0 + 2 * (t >> 2), c = n0 + 16 * (t & 3);
        uint32_t* dst = &wp[t >> 2][16 * (t & 3)];
        const float* srow = nullptr;
        if (A.group > 0 && k < A.k)
            srow = A.s + (size_t)(k / A.group) * A.n;
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
            uint32_t o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int byte = b[e + i];
                float lo = (float)(((byte & 0xF) ^ 8) - 8);
                float hi = (float)((int)(signed char)byte >> 4);
                if (srow != nullptr && c + e + i < A.n) {
                    // bf16(scale), then a bf16 multiply: the exact product
                    // of two bf16 values rounded once to bf16
                    const float s = __bfloat162float(
                        __float2bfloat16_rn(srow[c + e + i]));
                    lo *= s;
                    hi *= s;
                }
                o[i] = wg::pack_bf16(lo, hi);
            }
            *reinterpret_cast<uint4*>(dst + e) =
                make_uint4(o[0], o[1], o[2], o[3]);
        }
    }

    static __device__ __forceinline__ float epilogue_scale(const wg::Args& A,
                                                           int col) {
        return A.group > 0 ? 1.0f : A.s[col];
    }

    // -- the streaming kernel: a slab is 32 packed rows of 128 bytes --------
    static constexpr int RAW_ROWS = wg::BK / 2;

    static __device__ __forceinline__ void copy_in(unsigned char* raw,
                                                   const wg::Args& A, int k0,
                                                   int kend, int n0, int t) {
        const unsigned char* w = reinterpret_cast<const unsigned char*>(A.w);
        const int row = t >> 3, cc = (t & 7) * 16;
        const bool ok = k0 + 2 * row < kend && n0 + cc < A.n;
        wg::cp_async16(raw + row * wg::FBN + cc,
                       ok ? w + (size_t)((k0 >> 1) + row) * A.n + n0 + cc : w,
                       ok);
    }

    // Thread t unpacks packed row p = t / 8 at the columns
    // 32 j + 4 (t % 8) .. + 3, j = 0..3.
    static __device__ __forceinline__ void convert(const unsigned char* raw,
                                                   const wg::Args& A, int k0,
                                                   int n0, int t,
                                                   uint32_t (*wp)[wg::FWS]) {
        const int p = t >> 3, c = (t & 7) * 4;
        const int k = k0 + 2 * p;
        const float* srow = nullptr;
        if (A.group > 0 && k < A.k)
            srow = A.s + (size_t)(k / A.group) * A.n + n0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint32_t four = *reinterpret_cast<const uint32_t*>(
                raw + p * wg::FBN + j * 32 + c);
            float4 s = make_float4(1.f, 1.f, 1.f, 1.f);
            if (srow != nullptr && n0 + j * 32 + c < A.n)
                s = *reinterpret_cast<const float4*>(srow + j * 32 + c);
            const float sc[4] = {s.x, s.y, s.z, s.w};
            uint32_t o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int byte = (four >> (8 * i)) & 0xFF;
                float lo = (float)(((byte & 0xF) ^ 8) - 8);
                float hi = (float)((int)(signed char)byte >> 4);
                if (srow != nullptr) {
                    const float sb = __bfloat162float(
                        __float2bfloat16_rn(sc[i]));
                    lo *= sb;
                    hi *= sb;
                }
                o[i] = wg::pack_bf16(lo, hi);
            }
            *reinterpret_cast<uint4*>(&wp[p][j * 32 + c]) =
                make_uint4(o[0], o[1], o[2], o[3]);
        }
    }
};

}  // namespace

// group: K rows per scale group (even), 0 for per-column scales.  k is the
// unpacked contraction length (even).  ws / counters / stream_path as in
// K3; the streaming kernel also needs 16-byte aligned scales.
extern "C" int fp8_int4_matmul(const void* x, const void* wp,
                               const void* scales, void* out, int m, int n,
                               int k, int group, int out_f32, int splits,
                               int kper, int stream_path, void* ws,
                               void* counters, void* stream) {
    wg::Args A;
    A.x = reinterpret_cast<const __nv_bfloat16*>(x);
    A.w = wp;
    A.s = reinterpret_cast<const float*>(scales);
    A.out = out;
    A.ws = reinterpret_cast<float*>(ws);
    A.counters = reinterpret_cast<int*>(counters);
    A.m = m; A.n = n; A.k = k;
    A.splits = splits; A.kper = kper; A.group = group;
    A.vec_x = (k % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    A.vec_w = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(wp) % 16 == 0);
    A.stream_path = stream_path;
    if (stream_path && !(A.vec_x && A.vec_w && m <= 64
                         && reinterpret_cast<uintptr_t>(scales) % 16 == 0))
        return (int)cudaErrorInvalidValue;
    if (splits < 1 || splits > wg::MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    return (int)(out_f32 ? wg::launch<W4, true>(A, st)
                         : wg::launch<W4, false>(A, st));
}
