// T2, the fp8 convert study on K3's main loop:
//   out (M, N) bf16 = x (M, K) bf16 @ conv(w (K, N)), f32 accumulation, one
//   rounding to bf16, no scale.
//
// Replaces tools/bench_pallas_linear.py::pl_linear (its kernel from
// make_kernel).  The TPU study asked whether a hand kernel converting the
// fp8 weight in registers beats the library's operand convert at the
// decode MLP shape (M = 64, 4096 x 11008).  Here every mode runs K3's
// streaming kernel (w_gemm.cuh: cp.async stages, mma.sync bf16, the same
// deterministic split-K) with K3's tiles and thread mapping; only the
// policy's convert differs:
//
//   pl-astype  K3's policy W8<E4M3> itself (the hardware convert);
//   pl-bits    the tool's integer pipeline (e4m3_convert.cuh, BITS);
//   pl-magic   the tool's mag >= 8 select plus subnormal table (MAGIC);
//   pl-bf16    a bf16 payload, no convert: a slab is 64 rows of 256 bytes.
//
// Bound on an H100: the bytes of w (45.1 MB e4m3, 90.2 MB bf16 at the
// study's shape) plus x and out, at 3.35 TB/s; the products are 5.8 GFLOP,
// 5.8 us at the bf16 tensor-core rate.
//
// Reps: the tool re-streams the weight R times inside one grid to hide the
// TPU's dispatch cost.  Here the C entry launches the kernel R times on the
// stream, rep r reading w + r * rep_stride: stride 0 re-reads one copy
// (from L2 where it fits), a stride of K * N elements reads R real copies
// from HBM.  Every rep writes the same output.

#include "e4m3_convert.cuh"
#include "w8_policy.cuh"

namespace {

enum Mode { PL_BF16 = 0, PL_ASTYPE = 1, PL_BITS = 2, PL_MAGIC = 3 };

// K3's policy with no scale: multiplying by 1 changes no bit.
struct Astype : w8::W8<w8::E4M3> {
    static __device__ __forceinline__ float epilogue_scale(const wg::Args&,
                                                           int) {
        return 1.0f;
    }
};

// The integer converts: K3's copy_in and thread mapping (rows 2p, 2p + 1,
// p = t / 8, columns 32 j + 4 (t % 8) .. + 3); each byte becomes its bf16
// bit pattern and the (row 2p, row 2p + 1) pairs are put together with
// byte permutes.
template <int CONV>
struct Bits : Astype {
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
            const uint32_t a01 = e4m3::cvt2<CONV>(a & 0xFFFFu);
            const uint32_t a23 = e4m3::cvt2<CONV>(a >> 16);
            const uint32_t b01 = e4m3::cvt2<CONV>(b & 0xFFFFu);
            const uint32_t b23 = e4m3::cvt2<CONV>(b >> 16);
            *reinterpret_cast<uint4*>(&wp[p][j * 32 + c]) = make_uint4(
                __byte_perm(a01, b01, 0x5410), __byte_perm(a01, b01, 0x7632),
                __byte_perm(a23, b23, 0x5410), __byte_perm(a23, b23, 0x7632));
        }
    }
};

// A bf16 payload: the slab is 64 K rows of 128 bf16 (256 bytes); the same
// thread mapping, 8-byte reads, and the pairs put together without a
// convert.
struct Bf16 : Astype {
    static constexpr int RAW_ROWS = 2 * wg::BK;
    static constexpr int ROW_BYTES = 2 * wg::FBN;

    static __device__ __forceinline__ void copy_in(unsigned char* raw,
                                                   const wg::Args& A, int k0,
                                                   int kend, int n0, int t) {
        const unsigned char* w = reinterpret_cast<const unsigned char*>(A.w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int id = t + i * wg::FTHREADS;
            const int row = id >> 4, cc = (id & 15) * 16;
            const bool ok = k0 + row < kend && n0 + cc / 2 < A.n;
            wg::cp_async16(
                raw + row * ROW_BYTES + cc,
                ok ? w + ((size_t)(k0 + row) * A.n + n0) * 2 + cc : w, ok);
        }
    }

    static __device__ __forceinline__ void convert(const unsigned char* raw,
                                                   const wg::Args&, int, int,
                                                   int t,
                                                   uint32_t (*wp)[wg::FWS]) {
        const int p = t >> 3, c = (t & 7) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint2 a = *reinterpret_cast<const uint2*>(
                raw + (2 * p) * ROW_BYTES + (j * 32 + c) * 2);
            const uint2 b = *reinterpret_cast<const uint2*>(
                raw + (2 * p + 1) * ROW_BYTES + (j * 32 + c) * 2);
            *reinterpret_cast<uint4*>(&wp[p][j * 32 + c]) = make_uint4(
                __byte_perm(a.x, b.x, 0x5410), __byte_perm(a.x, b.x, 0x7632),
                __byte_perm(a.y, b.y, 0x5410), __byte_perm(a.y, b.y, 0x7632));
        }
    }
};

template <class W>
cudaError_t launch_reps(wg::Args A, int reps, long long rep_bytes,
                        cudaStream_t stream) {
    const unsigned char* w = reinterpret_cast<const unsigned char*>(A.w);
    for (int r = 0; r < reps; ++r) {
        A.w = w + r * rep_bytes;
        const cudaError_t err =
            A.m <= 16 ? wg::launch_stream<W, 16, false>(A, stream)
                      : wg::launch_stream<W, 64, false>(A, stream);
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// mode: 0 pl-bf16 (w bf16), 1 pl-astype, 2 pl-bits, 3 pl-magic (w e4m3
// bytes).  Needs m <= 64, k % 8 == 0, n % 16 == 0 and 16-byte aligned x and
// w (the streaming kernel); splits, kper, ws and counters as in K3.
extern "C" int fp8_linear_study(const void* x, const void* w, void* out,
                                int m, int n, int k, int mode, int reps,
                                long long rep_bytes, int splits, int kper,
                                void* ws, void* counters, void* stream) {
    wg::Args A;
    A.x = reinterpret_cast<const __nv_bfloat16*>(x);
    A.w = w;
    A.s = nullptr;
    A.out = out;
    A.ws = reinterpret_cast<float*>(ws);
    A.counters = reinterpret_cast<int*>(counters);
    A.m = m; A.n = n; A.k = k;
    A.splits = splits; A.kper = kper; A.group = 0;
    A.vec_x = (k % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    A.vec_w = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0)
              && rep_bytes % 16 == 0;
    A.stream_path = 1;
    if (!(A.vec_x && A.vec_w && m <= 64) || reps < 1 || splits < 1
        || splits > wg::MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (mode) {
        case PL_BF16: return (int)launch_reps<Bf16>(A, reps, rep_bytes, st);
        case PL_ASTYPE: return (int)launch_reps<Astype>(A, reps, rep_bytes, st);
        case PL_BITS:
            return (int)launch_reps<Bits<e4m3::BITS>>(A, reps, rep_bytes, st);
        case PL_MAGIC:
            return (int)launch_reps<Bits<e4m3::MAGIC>>(A, reps, rep_bytes, st);
    }
    return (int)cudaErrorInvalidValue;
}
