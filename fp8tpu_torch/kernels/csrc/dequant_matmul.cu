// K3, the serving linear:  out = (x @ upcast(w8)) * s[N]
// (with row scales, W8A8's int8 route: (x @ upcast(w8)) * (rs[M] * s[N]),
// x the e4m3 activation codes' exact f16 values that P2 writes)
//
// Replaces fp8tpu/kernels/qmatmul.py::_dequant_matmul_kernel.  x is (M, K)
// bf16, w8 a (K, N) payload of e4m3, e5m2 or int8 bytes, s one f32 scale
// per output column; the product accumulates in f32, is scaled in f32 and
// rounded once to bf16 or f32.  Every value of the three payload types is
// exact in bf16, and bf16 x bf16 products are exact in f32, so only the
// order of the f32 sums differs from the plain version.
//
// Bound on an H100: the bytes of w8 at decode (M <= 64), the bf16
// tensor-core rate at prefill.  Aligned shapes run the streaming loop of
// w_stream.cuh (a TMA ring of raw payload, each byte converted once in
// registers into wgmma's A operand, x as its B operand): its decode form
// at M <= 64, its prefill route (128 x 128 tiles on two warpgroups) above.
// Shapes that TMA cannot address run the general kernel of w_gemm.cuh.
// All split K deterministically (split_k.cuh).
//
// W8A8's int8 route (payload I8_F16) is its own policy of the streaming
// loop: x holds P2's f16 codes, the int8 bytes become f16 by a magic
// number (w_stream.cuh's F16), the MMA is wgmma .f32.f16.f16.  Every code
// and byte is exact in f16 and every product exact in f32, as in bf16, but
// the convert is 1.5 instructions an element where bf16's is 2.25 (and
// its bf16 fma is slow: the bf16 route was 0.43 ms at the gate's prefill,
// this one 0.32), and P2 hands the GEMM its codes with no convert launch
// between them.
// The general kernel takes f16 x on mma.sync (W8F16).

#include "w8_policy.cuh"
#include "w_stream.cuh"

namespace {

using w8::E4M3;
using w8::E5M2;
using w8::INT8;
using w8::W8;

// The streaming loop's policy: two bytes of one column at K rows k, k + 1
// (low byte first) to one bf16x2 A register.
template <int FMT>
struct S8 {
    static constexpr int KIND = ws::BYTE8;
    static constexpr bool GROUPED = false;
    static constexpr bool F16 = false;

    static __device__ __forceinline__ uint32_t cvt2(uint32_t two) {
        if constexpr (FMT == w8::INT8) {
            // each byte v to its half: 0x4300 | (v & 127) is the bf16 of
            // 128 + (v & 127), 0x4300 | (v & 128) that of 128 or 256 (v's
            // sign), and one exact bf16x2 subtract leaves v
            const uint32_t w = __byte_perm(two, 0, 0x4140);
            return ws::fma_bf16x2((w & 0x00800080u) | 0x43004300u,
                                  0xBF80BF80u,
                                  (w & 0x007F007Fu) | 0x43004300u);
        } else {
            const float2 f = w8::upcast2<FMT>((unsigned short)two);
            return ws::bf16x2_bits(f.x, f.y);
        }
    }
};

// W8A8's int8 route: f16 x, int8 bytes to f16 fragments (w_stream.cuh)
struct Int8F16 {
    static constexpr int KIND = ws::BYTE8;
    static constexpr bool GROUPED = false;
    static constexpr bool F16 = true;
};

// The streaming loop's policy and the general kernel's of a payload
template <int FMT>
struct Policies {
    using Stream = S8<FMT>;
    using General = W8<FMT>;
};
template <>
struct Policies<w8::I8_F16> {
    using Stream = Int8F16;
    using General = w8::W8F16;
};

template <int FMT>
cudaError_t launch_fmt(const wg::Args& A, const void* x, const void* w8,
                       int out_f32, int route, cudaStream_t stream) {
    using SP = typename Policies<FMT>::Stream;
    using GP = typename Policies<FMT>::General;
    if (route) {
        ws::Launch L;
        L.x = x; L.w = w8; L.col_scale = A.s; L.group_scale = nullptr;
        L.row_scale = A.rs;
        L.out = A.out; L.ws = A.ws; L.counters = A.counters;
        L.m = A.m; L.n = A.n; L.k = A.k;
        L.splits = A.splits; L.kper = A.kper; L.group = 0;
        L.out_f32 = out_f32;
        return route == ws::PREFILL_ROUTE
            ? ws::launch_prefill<SP>(L, stream)
            : ws::launch<SP>(L, route, stream);
    }
    return out_f32 ? wg::launch<GP, true>(A, stream)
                   : wg::launch<GP, false>(A, stream);
}

}  // namespace

// payload: 0 e4m3, 1 e5m2, 2 int8, 3 int8 with x f16 (W8A8's int8 route:
// x holds P2's f16 codes, row_scales its scales).  ws / counters are used
// when splits > 1:
// ws holds splits * m * n floats, counters one zeroed int per output tile.
// row_scales: null, or one f32 a row of x, multiplied into the column
// scale before the product (the W8A8 route of int8 weights, whose x holds
// e4m3 activation codes as f16, or as bf16 with payload 2: every product
// is still exact).
// route: 0 the general kernel; 1 or 2 the streaming loop's decode form
// with that many m64 tiles a block (qmatmul.py::stream_plan: m <= 64,
// k % 8 == 0, n % 16 == 0, 16-byte aligned x and w8); 3 its prefill
// route, the same conditions with m > 64 (qmatmul.py::prefill_plan).
extern "C" int fp8_dequant_matmul(const void* x, const void* w8,
                                  const void* scales, void* out, int m, int n,
                                  int k, int payload, int out_f32, int splits,
                                  int kper, int route, void* ws,
                                  void* counters, const void* row_scales,
                                  void* stream) {
    wg::Args A;
    A.rs = reinterpret_cast<const float*>(row_scales);
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
    if (route && !(A.vec_x && A.vec_w))
        return (int)cudaErrorInvalidValue;
    if (splits < 1 || splits > wg::MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (payload) {
        case E4M3:
            return (int)launch_fmt<E4M3>(A, x, w8, out_f32, route, st);
        case E5M2:
            return (int)launch_fmt<E5M2>(A, x, w8, out_f32, route, st);
        case INT8:
            return (int)launch_fmt<INT8>(A, x, w8, out_f32, route, st);
        case w8::I8_F16:
            return (int)launch_fmt<w8::I8_F16>(A, x, w8, out_f32, route, st);
    }
    return (int)cudaErrorInvalidValue;
}
