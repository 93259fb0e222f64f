// T2, the fp8 convert study on K3's main loop:
//   out (M, N) bf16 = x (M, K) bf16 @ conv(w (K, N)), f32 accumulation, one
//   rounding to bf16, no scale.
//
// Replaces tools/bench_pallas_linear.py::pl_linear (its kernel from
// make_kernel).  The TPU study asked whether a hand kernel converting the
// fp8 weight in registers beats the library's operand convert at the
// decode MLP shape (M = 64, 4096 x 11008).  Here every mode runs K3's
// streaming loop (w_stream.cuh: a TMA ring of raw payload, wgmma with the
// converted weight as the A operand, the same deterministic split-K) with
// K3's tiles; only the policy's convert differs:
//
//   pl-astype  K3's hardware convert (e4m3_convert.cuh, ASTYPE: upcast2);
//   pl-bits    the tool's integer pipeline (e4m3_convert.cuh, BITS);
//   pl-magic   the tool's mag >= 8 select plus subnormal table (MAGIC);
//   pl-bf16    a bf16 payload, no convert: its (k, k + 1) pairs are put
//              together by byte permutes.
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
#include "w_stream.cuh"

namespace {

enum Mode { PL_BF16 = 0, PL_ASTYPE = 1, PL_BITS = 2, PL_MAGIC = 3 };

// The converts: two e4m3 bytes (rows k, k + 1 of one column) to their bf16
// bit patterns.
template <int CONV>
struct Bits {
    static constexpr int KIND = ws::BYTE8;
    static constexpr bool GROUPED = false;
    static constexpr bool F16 = false;

    static __device__ __forceinline__ uint32_t cvt2(uint32_t two) {
        return e4m3::cvt2<CONV>(two);
    }
};

// A bf16 payload: no convert.
struct Bf16 {
    static constexpr int KIND = ws::HALF16;
    static constexpr bool GROUPED = false;
    static constexpr bool F16 = false;
};

template <class P>
cudaError_t launch_reps(ws::Launch L, int mt, int reps, long long rep_bytes,
                        cudaStream_t stream) {
    const unsigned char* w = reinterpret_cast<const unsigned char*>(L.w);
    for (int r = 0; r < reps; ++r) {
        L.w = w + r * rep_bytes;
        const cudaError_t err = ws::launch<P>(L, mt, stream);
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// mode: 0 pl-bf16 (w bf16), 1 pl-astype, 2 pl-bits, 3 pl-magic (w e4m3
// bytes).  The streaming loop's conditions (m <= 64, k % 8 == 0,
// n % 16 == 0, 16-byte aligned x and w); mt, splits, kper, ws and counters
// as in K3 (qmatmul.py::stream_plan).
extern "C" int fp8_linear_study(const void* x, const void* w, void* out,
                                int m, int n, int k, int mode, int reps,
                                long long rep_bytes, int mt, int splits,
                                int kper, void* ws, void* counters,
                                void* stream) {
    if (reinterpret_cast<uintptr_t>(x) % 16
        || reinterpret_cast<uintptr_t>(w) % 16 || rep_bytes % 16 || reps < 1)
        return (int)cudaErrorInvalidValue;
    ws::Launch L;
    L.x = x; L.w = w; L.col_scale = nullptr; L.group_scale = nullptr;
    L.out = out; L.ws = reinterpret_cast<float*>(ws);
    L.counters = reinterpret_cast<int*>(counters);
    L.m = m; L.n = n; L.k = k; L.splits = splits; L.kper = kper;
    L.group = 0; L.out_f32 = 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (mode) {
        case PL_BF16: return (int)launch_reps<Bf16>(L, mt, reps, rep_bytes, st);
        case PL_ASTYPE:
            return (int)launch_reps<Bits<e4m3::ASTYPE>>(L, mt, reps,
                                                        rep_bytes, st);
        case PL_BITS:
            return (int)launch_reps<Bits<e4m3::BITS>>(L, mt, reps, rep_bytes,
                                                      st);
        case PL_MAGIC:
            return (int)launch_reps<Bits<e4m3::MAGIC>>(L, mt, reps,
                                                       rep_bytes, st);
    }
    return (int)cudaErrorInvalidValue;
}
