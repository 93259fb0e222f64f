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
// prefill.  Aligned shapes run the streaming loop of w_stream.cuh (a TMA
// ring of packed bytes and grouped scales, the nibbles turned into wgmma's
// A operand in registers with integer and bf16x2 operations, no float
// round trip): its decode form at M <= 64, its prefill route above; what
// TMA cannot address runs the general kernel of w_gemm.cuh.

#include "w_gemm.cuh"
#include "w_stream.cuh"

namespace {

struct W4 {
    static constexpr bool F16 = false;      // bf16 x and weight pairs
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
};

// The streaming loop's policy (w_stream.cuh): each packed byte is one
// bf16x2 A register, its nibbles sign-extended by bit operations; grouped
// scales are TMA'd with the stage and multiplied in bf16x2.
template <bool G>
struct W4S {
    static constexpr int KIND = ws::NIB4;
    static constexpr bool GROUPED = G;
    static constexpr bool F16 = false;
};

}  // namespace

// group: K rows per scale group (even), 0 for per-column scales.  k is the
// unpacked contraction length (even).  ws / counters / route as in K3; the
// streaming loop also needs 16-byte aligned scales and a group that is a
// multiple of 16 dividing or divided by 128.
extern "C" int fp8_int4_matmul(const void* x, const void* wp,
                               const void* scales, void* out, int m, int n,
                               int k, int group, int out_f32, int splits,
                               int kper, int route, void* ws,
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
    if (route && !(A.vec_x && A.vec_w
                   && reinterpret_cast<uintptr_t>(scales) % 16 == 0))
        return (int)cudaErrorInvalidValue;
    if (splits < 1 || splits > wg::MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (route) {
        ws::Launch L;
        L.x = x; L.w = wp; L.out = out; L.ws = A.ws; L.counters = A.counters;
        L.col_scale = group > 0 ? nullptr : A.s;
        L.group_scale = group > 0 ? A.s : nullptr;
        L.m = m; L.n = n; L.k = k; L.splits = splits; L.kper = kper;
        L.group = group; L.out_f32 = out_f32;
        if (route == ws::PREFILL_ROUTE)
            return (int)(group > 0 ? ws::launch_prefill<W4S<true>>(L, st)
                                   : ws::launch_prefill<W4S<false>>(L, st));
        return (int)(group > 0 ? ws::launch<W4S<true>>(L, route, st)
                               : ws::launch<W4S<false>>(L, route, st));
    }
    return (int)(out_f32 ? wg::launch<W4, true>(A, st)
                         : wg::launch<W4, false>(A, st));
}
