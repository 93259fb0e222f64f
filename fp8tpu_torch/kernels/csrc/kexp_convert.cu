// T1, the fp8 -> bf16 convert and decode-attention dot study.
//
// Replaces tools/kexp_convert.py::stream (its kernel from make_kernel).
// q is (BKV, 1, 8, 128) bf16 and k (BKV, 1, 512, 128) e4m3 bytes or bf16,
// each given R times (rep r at base + r * rep stride: stride 0 re-reads one
// copy, from L2 where it fits; a full stride reads R copies from HBM).
// out (8, 128) f32 is the sum, over every rep and tile, of the mode's
// (8, 128) slice:
//
//   conv-*   the tile's top-left 8 x 128 corner, converted;
//   dot-*    scores[:, :128] of q . k^T (f32);
//   full     ctx = bf16(exp(s - max_row s)) . k, with V = K and no 1/l.
//
// The tool's seven modes, and full-fp8-astype: the full block with the
// hardware convert, the form a tensor-core K4 would take.
//
// The tool's kernel sums into scratch and never stores its output; here
// the sum is written.  Its result depends only on the corner (or the first
// 128 scores), so nvcc would drop the rest of the tile: every block also
// folds every converted element (conv) or every score (dot, full) into
// fold[r][i], one f32 per tile.  That output exists only to keep the
// measured work real.
//
// Bound on an H100: the bytes of k and q, read once a rep (34.6 MB fp8,
// 68.2 MB bf16 at BKV = 512), at 3.35 TB/s; the dots are 0.54 GFLOP a rep
// (1.07 for full), far below the bf16 tensor-core rate.  The design:
//
// * A block walks a contiguous range of (rep, tile) items, rep-major as
//   the TPU grid does, in 64 KB chunks (one e4m3 tile, or half a bf16 tile)
//   through two cp.async stages: one chunk lands while the other is used.
//   Rows are stored with their 16-byte pieces XOR-swizzled by row % 8, so
//   ldmatrix reads of eight rows are conflict-free.
// * Dots are mma.sync.m16n8k16 bf16 with f32 accumulation, the tile's
//   tokens in m and q's 8 rows in n (exactly one n tile).  e4m3 operands
//   are read with ldmatrix (as b16 pairs) and upcast in registers: for the
//   scores a thread's four bytes (d = 4c .. 4c + 3) become the k pairs
//   (2c, 2c + 1) and (2c + 8, 2c + 9), and q's B fragment is read in the
//   same d order.  The full modes' ctx^T = k^T . p^T takes the A operand
//   from the scores' converted fragments, kept in registers (128 a
//   thread): each 16 x 16 fragment's four 8 x 8 quarters are swapped
//   across the diagonal and transposed by movmatrix, so ctx's rows come
//   in q's d order;
//   p^T's B operand is the score accumulator transposed by movmatrix.
// * Merge: each block writes one (8, 128) partial; a second launch adds the
//   partials in a fixed order, so two launches give the same bits.
// * The bits modes are bound by instruction issue, not bytes: at the byte
//   bound the card issues about 8 thread instructions a byte, and half as
//   many on its integer units.  Their convert (e4m3_convert.cuh::
//   bits_pair) takes two bytes a word, picked straight from the loaded
//   word by its first prmt: 5.5 instructions a byte (a byte at a time
//   takes 14), 2.5 of them on the integer units.  The full modes convert
//   each element once, as the tool does: a bf16 copy of a stage in shared
//   memory would need 128 KB beside the two 66 KB stages, past the 227 KB
//   a block may have, so the converted tile stays in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "e4m3_convert.cuh"
#include "mma_frag.cuh"
#include "w_gemm.cuh"

namespace {

using frag::ldsm4;
using frag::movmatrix_trans;

enum Mode {
    CONV_BF16 = 0, CONV_ASTYPE = 1, CONV_BITS = 2, DOT_BF16 = 3,
    DOT_ASTYPE = 4, DOT_BITS = 5, FULL_BITS = 6, FULL_ASTYPE = 7
};

constexpr int S = 512, D = 128, G = 8;
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int CHUNK = 65536;              // bytes of k per stage
constexpr int QROW = 2 * D + 16;          // padded bytes of a q row
constexpr int STAGE = CHUNK + G * QROW;
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE;
constexpr int OUT = G * D;                // elements of out and a partial

template <int MODE>
struct Traits {
    static constexpr bool BF16 = MODE == CONV_BF16 || MODE == DOT_BF16;
    static constexpr bool CONV = MODE <= CONV_BITS;
    static constexpr bool FULL = MODE == FULL_BITS || MODE == FULL_ASTYPE;
    static constexpr int CVT =
        (MODE == CONV_ASTYPE || MODE == DOT_ASTYPE || MODE == FULL_ASTYPE)
        ? e4m3::ASTYPE : e4m3::BITS;
    static constexpr int ROW_BYTES = BF16 ? 2 * D : D;
    static constexpr int ROWS = CHUNK / ROW_BYTES;      // tokens a chunk
    static constexpr int CHUNKS = S / ROWS;             // chunks a tile
    static constexpr int PIECES = ROW_BYTES / 16;       // 16 B pieces a row
    static constexpr int TOK_W = ROWS / WARPS;          // tokens a warp
    static constexpr int MT = TOK_W / 16;               // m tiles a warp
    static constexpr int KEEP = FULL ? MT : 1;          // tiles kept (cv)
};

struct Params {
    const unsigned char* q;
    const unsigned char* k;
    float* partial;            // (gridDim.x, 8, 128)
    float* fold;               // (reps, bkv)
    long long q_rep, k_rep;    // bytes between reps
    int bkv, reps;
};

// Byte offset of 16-byte piece ``pc`` of row ``row`` in a stage.
template <class T>
__device__ __forceinline__ int at(int row, int pc) {
    return row * T::ROW_BYTES + ((pc ^ (row & 7)) << 4);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float lo_f(uint32_t w) {
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_f(uint32_t w) {
    return __uint_as_float(w & 0xFFFF0000u);
}

// Convert every element of a chunk; fold them all into ``part`` and add the
// tile's 8 x 128 corner (rows 0..7 of its first chunk) into ``acc``: thread
// t < 8 * PIECES owns piece t of that corner.
template <int MODE>
__device__ __forceinline__ void conv_chunk(const unsigned char* st, bool head,
                                           float (&acc)[8][4], float& part) {
    using T = Traits<MODE>;
    const int t = threadIdx.x;
#pragma unroll 4
    for (int j = 0; j < CHUNK / 16 / THREADS; ++j) {
        const int id = t + j * THREADS, row = id / T::PIECES;
        const uint4 v = *reinterpret_cast<const uint4*>(
            st + at<T>(row, id % T::PIECES));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        float f[16];
        constexpr int N = T::BF16 ? 8 : 16;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if constexpr (T::BF16) {
                f[2 * e] = lo_f(w[e]);
                f[2 * e + 1] = hi_f(w[e]);
            } else {
                const uint32_t a = e4m3::cvt_half<T::CVT, 0>(w[e]);
                const uint32_t b = e4m3::cvt_half<T::CVT, 1>(w[e]);
                f[4 * e] = lo_f(a);
                f[4 * e + 1] = hi_f(a);
                f[4 * e + 2] = lo_f(b);
                f[4 * e + 3] = hi_f(b);
            }
        }
#pragma unroll
        for (int e = 0; e < N; ++e) part += f[e];
        if (j == 0 && head && row < G) {
#pragma unroll
            for (int e = 0; e < N; ++e) acc[e >> 2][e & 3] += f[e];
        }
    }
}

// The scores of this warp's tokens, S^T = k . q^T: sc[mt] is the m16n8
// accumulator of tokens tok0 + 16 mt .. + 15 (rows) by q rows (columns).
// The full modes keep the converted tile: cv[mt][s] is the A fragment of
// tokens 16 mt .. + 15 by the 16 d of piece s (in the d order of q's B
// fragment), for ctx to take transposed.
template <int MODE>
__device__ __forceinline__ void scores(
        const unsigned char* st, int tok0, float (&sc)[Traits<MODE>::MT][4],
        uint32_t (&cv)[Traits<MODE>::KEEP][8][4]) {
    using T = Traits<MODE>;
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    const unsigned char* qs = st + CHUNK;
    uint32_t b[8][2];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        if constexpr (T::BF16) {
            b[s][0] = *reinterpret_cast<const uint32_t*>(
                qs + g * QROW + (16 * s + 2 * c) * 2);
            b[s][1] = *reinterpret_cast<const uint32_t*>(
                qs + g * QROW + (16 * s + 8 + 2 * c) * 2);
        } else {            // d order 4c .. 4c + 3, as the upcast A pairs
            const uint2 v = *reinterpret_cast<const uint2*>(
                qs + g * QROW + (16 * s + 4 * c) * 2);
            b[s][0] = v.x;
            b[s][1] = v.y;
        }
    }
    const int mi = lane >> 3, mrow = (lane & 7) + 8 * (mi & 1);
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][e] = 0.f;
        const int row = tok0 + 16 * mt + mrow;
#pragma unroll
        for (int pp = 0; pp < 8 / (T::BF16 ? 1 : 2); ++pp) {
            uint32_t r[4];
            if constexpr (T::BF16) {
                ldsm4(r, st + at<T>(row, 2 * pp + (mi >> 1)));
                wg::mma_bf16(sc[mt], r, b[pp][0], b[pp][1]);
            } else {
                ldsm4(r, st + at<T>(row, 2 * pp + (mi >> 1)));
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const uint32_t a[4] = {
                        e4m3::cvt_half<T::CVT, 0>(r[2 * hh]),
                        e4m3::cvt_half<T::CVT, 0>(r[2 * hh + 1]),
                        e4m3::cvt_half<T::CVT, 1>(r[2 * hh]),
                        e4m3::cvt_half<T::CVT, 1>(r[2 * hh + 1])};
                    wg::mma_bf16(sc[mt], a, b[2 * pp + hh][0],
                                 b[2 * pp + hh][1]);
                    if constexpr (T::FULL) {
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            cv[mt][2 * pp + hh][e] = a[e];
                    }
                }
            }
        }
    }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) stream_kernel(const Params p) {
    using T = Traits<MODE>;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[WARPS];
    __shared__ float mx[WARPS][G];

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, c = lane & 3;
    const int items = p.bkv * p.reps;
    const int first = (int)((long long)items * blockIdx.x / gridDim.x);
    const int last = (int)((long long)items * (blockIdx.x + 1) / gridDim.x);
    const int nchunks = (last - first) * T::CHUNKS;
    const int tok0 = warp * T::TOK_W;

    auto load_chunk = [&](int ch) {
        if (ch < nchunks) {
            const int item = first + ch / T::CHUNKS, h = ch % T::CHUNKS;
            const int r = item / p.bkv, i = item % p.bkv;
            unsigned char* st = smem + (ch % STAGES) * STAGE;
            const unsigned char* src = p.k + r * p.k_rep
                + (size_t)i * S * T::ROW_BYTES + (size_t)h * CHUNK;
#pragma unroll 4
            for (int j = 0; j < CHUNK / 16 / THREADS; ++j) {
                const int id = t + j * THREADS;
                wg::cp_async16(st + at<T>(id / T::PIECES, id % T::PIECES),
                               src + (size_t)id * 16, true);
            }
            if (!T::CONV && t < G * 2 * D / 16) {
                const unsigned char* qs =
                    p.q + r * p.q_rep + (size_t)i * G * D * 2;
                wg::cp_async16(st + CHUNK + (t >> 4) * QROW + (t & 15) * 16,
                               qs + t * 16, true);
            }
        }
        wg::cp_async_commit();
    };

    // conv: the corner pieces of thread t; dot: sc of tokens < 128 (warps
    // whose tokens start below 128); full: this warp's share of ctx^T, 8 m
    // tiles of 16 d by the 8 q rows.
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    float fold_item = 0.f;

    load_chunk(0);
    for (int ch = 0; ch < nchunks; ++ch) {
        load_chunk(ch + 1);
        wg::cp_async_wait<1>();
        __syncthreads();
        const unsigned char* st = smem + (ch % STAGES) * STAGE;
        const int h = ch % T::CHUNKS;
        float part = 0.f;
        if constexpr (T::CONV) {
            conv_chunk<MODE>(st, h == 0, acc, part);
        } else {
            float sc[T::MT][4];
            uint32_t cv[T::KEEP][8][4];
            scores<MODE>(st, tok0, sc, cv);
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) part += sc[mt][e];
            if constexpr (!T::FULL) {
                if (h == 0 && tok0 < D) {
#pragma unroll
                    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[mt][e] += sc[mt][e];
                }
            } else {
                // the max of each q row (columns 2c, 2c + 1) over the tile
                float m0 = __int_as_float(0xff800000), m1 = m0;
#pragma unroll
                for (int mt = 0; mt < T::MT; ++mt) {
                    m0 = fmaxf(m0, fmaxf(sc[mt][0], sc[mt][2]));
                    m1 = fmaxf(m1, fmaxf(sc[mt][1], sc[mt][3]));
                }
#pragma unroll
                for (int off = 4; off < 32; off <<= 1) {
                    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
                    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
                }
                if (g == 0) {
                    mx[warp][2 * c] = m0;
                    mx[warp][2 * c + 1] = m1;
                }
                __syncthreads();
#pragma unroll
                for (int w = 0; w < WARPS; ++w) {
                    m0 = fmaxf(m0, mx[w][2 * c]);
                    m1 = fmaxf(m1, mx[w][2 * c + 1]);
                }
#pragma unroll
                for (int kk = 0; kk < T::MT; ++kk) {
                    const uint32_t b0 = movmatrix_trans(wg::pack_bf16(
                        expf(sc[kk][0] - m0), expf(sc[kk][1] - m1)));
                    const uint32_t b1 = movmatrix_trans(wg::pack_bf16(
                        expf(sc[kk][2] - m0), expf(sc[kk][3] - m1)));
#pragma unroll
                    for (int s = 0; s < 8; ++s) {
                        // the kept (tokens x d) fragment transposed: its
                        // 8 x 8 quarters moved and each transposed
                        const uint32_t a[4] = {
                            movmatrix_trans(cv[kk][s][0]),
                            movmatrix_trans(cv[kk][s][2]),
                            movmatrix_trans(cv[kk][s][1]),
                            movmatrix_trans(cv[kk][s][3])};
                        wg::mma_bf16(acc[s], a, b0, b1);
                    }
                }
            }
        }
        part = warp_sum(part);
        if (lane == 0) red[warp] = part;
        __syncthreads();
        if (t == 0) {
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) s += red[w];
            fold_item += s;
            if (h == T::CHUNKS - 1) {
                p.fold[first + ch / T::CHUNKS] = fold_item;
                fold_item = 0.f;
            }
        }
        __syncthreads();            // the stage and red are free again
    }
    wg::cp_async_wait<0>();

    float* out = p.partial + (size_t)blockIdx.x * OUT;
    if constexpr (T::CONV) {
        constexpr int N = T::BF16 ? 8 : 16;
        if (t < G * T::PIECES) {
            const int row = t / T::PIECES, d0 = (t % T::PIECES) * N;
#pragma unroll
            for (int e = 0; e < N; ++e)
                out[row * D + d0 + e] = acc[e >> 2][e & 3];
        }
    } else if constexpr (!T::FULL) {
        if (tok0 < D) {
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    out[(2 * c + (e & 1)) * D + tok0 + 16 * mt + g
                        + 8 * (e >> 1)] = acc[mt][e];
        }
    } else {
        // ctx^T rows of piece s in q's B order: fragment row g holds d =
        // 16 s + 4 (g / 2) + g % 2, row g + 8 (e >= 2) that + 2; q row 2c
        // (+1 for odd e).  The warps' shares added in warp order.
        float* buf = reinterpret_cast<float*>(smem);
        const int dg = 4 * (g >> 1) + (g & 1);
#pragma unroll
        for (int s = 0; s < D / 16; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                buf[warp * OUT + (2 * c + (e & 1)) * D + 16 * s + dg
                    + 2 * (e >> 1)] = acc[s][e];
        __syncthreads();
        for (int e = t; e < OUT; e += THREADS) {
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) s += buf[w * OUT + e];
            out[e] = s;
        }
    }
}

// out[e] = the partials' sum in a fixed order: warp w adds partials
// w, w + 8, ..., then the eight warp sums are added in warp order.
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* partial, float* out, int parts) {
    __shared__ float s[WARPS][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e = blockIdx.x * 32 + lane;
    float v = 0.f;
    for (int z = warp; z < parts; z += WARPS)
        v += partial[(size_t)z * OUT + e];
    s[warp][lane] = v;
    __syncthreads();
    if (warp == 0) {
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) o += s[w][lane];
        out[e] = o;
    }
}

template <int MODE>
cudaError_t launch(const Params& p, int blocks, cudaStream_t stream) {
    static bool configured = false;     // per instance; the attribute sticks
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            stream_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    stream_kernel<MODE><<<blocks, THREADS, SMEM, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// mode: 0 conv-bf16, 1 conv-astype, 2 conv-bits, 3 dot-bf16, 4
// dot-fp8-astype, 5 dot-fp8-bits, 6 full-fp8-bits, 7 full-fp8-astype.  q_rep / k_rep: bytes
// between reps (16-byte multiples).  partial holds blocks * 8 * 128 floats;
// fold reps * bkv.
extern "C" int fp8_kexp_stream(const void* q, const void* k, void* out,
                               void* fold, void* partial, int bkv, int reps,
                               long long q_rep, long long k_rep, int mode,
                               int blocks, void* stream) {
    Params p;
    p.q = reinterpret_cast<const unsigned char*>(q);
    p.k = reinterpret_cast<const unsigned char*>(k);
    p.partial = reinterpret_cast<float*>(partial);
    p.fold = reinterpret_cast<float*>(fold);
    p.q_rep = q_rep;
    p.k_rep = k_rep;
    p.bkv = bkv;
    p.reps = reps;
    if (bkv < 1 || reps < 1 || blocks < 1 || blocks > bkv * reps
        || q_rep % 16 || k_rep % 16
        || reinterpret_cast<uintptr_t>(q) % 16
        || reinterpret_cast<uintptr_t>(k) % 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (mode) {
        case CONV_BF16: err = launch<CONV_BF16>(p, blocks, st); break;
        case CONV_ASTYPE: err = launch<CONV_ASTYPE>(p, blocks, st); break;
        case CONV_BITS: err = launch<CONV_BITS>(p, blocks, st); break;
        case DOT_BF16: err = launch<DOT_BF16>(p, blocks, st); break;
        case DOT_ASTYPE: err = launch<DOT_ASTYPE>(p, blocks, st); break;
        case DOT_BITS: err = launch<DOT_BITS>(p, blocks, st); break;
        case FULL_BITS: err = launch<FULL_BITS>(p, blocks, st); break;
        case FULL_ASTYPE: err = launch<FULL_ASTYPE>(p, blocks, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    merge_kernel<<<OUT / 32, THREADS, 0, st>>>(p.partial,
                                               reinterpret_cast<float*>(out),
                                               blocks);
    return (int)cudaGetLastError();
}
