// K4, decode attention over the paged KV pool: flash partials of one query
// token per slot against the slot's mapped pages, read where they lie.
//
// Replaces fp8tpu/kernels/paged_attention.py::_kernel.
//
//   q      (B, KV*G, D)      bf16, pre-scaled by 1/sqrt(D), head h = kv*G + g
//   pool   (P, 2, L, R, D)   int8 / e4m3 / e5m2 / bf16 payloads, R = page*KV,
//                            row r = t*KV + kv (token-major), k at 0, v at 1
//   sc     (P, 2, L, R)      f32 scale of each (token, kv head) vector
//   table  (B, MP)           int32 physical page of each logical page, -1 =
//                            unmapped
//   lens   (B,)              int32 valid tokens of each slot
//
// and returns the UNNORMALISED partials acc (B, KV*G, D), m (B, KV*G),
// l (B, KV*G), all f32, which the caller merges with the fresh token and the
// chunk's side buffer.  Per token t < lens[b] of slot b and kv head:
//
//   s = (sum_d bf16(K[t, d]) * q[g, d]) * ks[t]          f32, scale after the dot
//   m = max(m, max_t s);  alpha = exp(m_old - m_new)
//   p = exp(s - m_new), exactly 0 for t >= lens[b]
//   pv = bf16(p * vs[t])                                  rounded before the dot
//   l = l * alpha + sum_t p;  acc = acc * alpha + sum_t pv * bf16(V[t, :])
//
// An empty slot gives m = -1e30, l = 0, acc = 0.
//
// Design.  The TPU kernel's grid is (slot, page) with the pages in sequence,
// and folds all KV*G heads into one masked (R x KVG) dot per page.  Here a
// block owns one (slot, kv head) and a contiguous share of that slot's
// tokens; its four warps each run their own flash recurrence over every
// fourth chunk of 16 tokens, and the block merges the four at the end.  It
// reads only that head's rows of a page (D payload bytes every KV*D), never
// the other heads', and nothing at or past lens[b].  Page ids are read in
// the kernel and clamped to [0, P-1], so a row of -1 (a retired slot that
// keeps decoding) reads page 0 and no id leads outside the pool; lens is
// clamped to [0, MP*page].  Nothing is read on the host, so a launch can be
// captured in a CUDA graph.
//
// Bound on an H100: bytes.  A head's token is D payload bytes of K, D of V
// and two scales for 4 * G * D flops, about 8 a byte at G = 4 (int8, D =
// 128).  The first design multiplied in f32 on the SIMT pipes (one token a
// thread, then one column d a thread, four block barriers a 128-token tile)
// and reached 42% of HBM at 64 slots and 18% at 8.  Probes of this one
// (fp8tpu_torch/tools/k4_probe.py: the kernel with its loads alone, and
// with its arithmetic alone) showed the two comparable and each near the
// whole: the loads of scattered 128-byte rows do not stream at the card's
// rate, so the arithmetic has to be lean to hide behind them.  So:
//
// * Both dots run on the tensor cores, mma.sync.m16n8k16 bf16 with f32
//   accumulation, in the orientation of the convert study T1
//   (kexp_convert.cu): S^T = K . q^T with the chunk's 16 tokens in m and
//   the head's G queries (padded to 8) in n; ctx^T = V^T . pv^T with d in
//   m, V^T from ldmatrix.trans and pv^T from the score accumulator through
//   movmatrix.  One-byte rows are read as b16 pairs; a thread's four bytes
//   are upcast to two bf16 pairs in registers, exactly: int8 by masks into
//   the bf16 pattern of 128 + (v & 127) and one bf16x2 subtract of 128 or
//   256, e4m3 / e5m2 by the hardware convert, bf16 as it is.  The score
//   dot runs two accumulator chains; D = 128 (the served model's) is a
//   template constant.
// * The roundings of the plain version, in its order: the scale after the
//   dot, masked tokens at -1e30 with an explicit p = 0, pv = bf16(p * vs)
//   before the context dot, l and acc rescaled by exp(m_old - m_new).
// * Each warp streams its chunks through a two-stage cp.async ring of its
//   own (K rows, V rows and their scales, 4.6 KB a stage at int8 D = 128),
//   with the page-table read one chunk ahead, and waits with wait_group and
//   __syncwarp only: no block barrier until the merge.  Rows past lens[b]
//   in the last chunk are zero-filled, never read.
// * Splits.  With fewer (slot, kv head) pairs than two blocks an SM,
//   gridDim.x blocks share one pair's chunks (n_splits in
//   paged_attention.py, from shapes alone).  Each writes its partial to a
//   workspace; the block that arrives last at the pair's counter merges the
//   partials in split order 0..S-1, so the result does not depend on which
//   block was last and a second launch gives the same bits.  The counters
//   are zero between launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"
#include "w8_policy.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 16;          // tokens a warp takes at a time: one m tile
constexpr int STAGES = 2;          // cp.async stages of each warp's ring
constexpr int MAX_SPLITS = 16;
constexpr int MAX_D = 128;
constexpr int QN = 8;              // queries of a kv head, padded to mma's n
constexpr float NEG = -1e30f;

enum Payload { E4M3 = 0, E5M2 = 1, INT8 = 2, BF16 = 3 };

struct Args {
    const __nv_bfloat16* q;
    const unsigned char* pool;
    const float* sc;
    const int* table;
    const int* lens;
    float* acc;
    float* m;
    float* l;
    float* ws_acc;             // (B*KV, splits, G, D), splits > 1 only
    float* ws_m;               // (B*KV, splits, G)
    float* ws_l;               // (B*KV, splits, G)
    int* counters;             // one per (slot, kv head), zero between launches
    int kv, d, p, layers, mp, page, layer, splits;
};

template <int FMT>
struct Geom {
    static constexpr int ES = FMT == BF16 ? 2 : 1;       // bytes an element
    static constexpr int CPR = MAX_D * ES / 16;           // 16 B pieces a row
    static constexpr int ROW = CPR * 16 + 16;             // padded row bytes
    static constexpr int STAGE = 2 * CHUNK * ROW + 2 * CHUNK * 4;
    static constexpr int SMEM = WARPS * STAGES * STAGE;
};

// Four payload bytes w -> two bf16x2 words, exact: p02 holds bytes 0 and 2
// (low half byte 0), p13 bytes 1 and 3.  int8: 0x4300 | (v & 127) is the
// bf16 128 + (v & 127); minus 128 (v >= 0) or 256 (v < 0), chosen by the
// sign bit, it is v.  fp8: the hardware convert.
template <int FMT>
__device__ __forceinline__ void upcast4(uint32_t w, uint32_t& p02,
                                        uint32_t& p13) {
    if constexpr (FMT == INT8) {
        const uint32_t w13 = w >> 8;
        asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(p02)
            : "r"((w & 0x007F007Fu) | 0x43004300u),
              "r"((w & 0x00800080u) | 0x43004300u));
        asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(p13)
            : "r"((w13 & 0x007F007Fu) | 0x43004300u),
              "r"((w13 & 0x00800080u) | 0x43004300u));
    } else {
        constexpr int W8 = FMT == E4M3 ? w8::E4M3 : w8::E5M2;
        const float2 lo = w8::upcast2<W8>((unsigned short)(w & 0xFFFFu));
        const float2 hi = w8::upcast2<W8>((unsigned short)(w >> 16));
        p02 = wg::pack_bf16(lo.x, hi.x);
        p13 = wg::pack_bf16(lo.y, hi.y);
    }
}

// The pool row (in units of one (token, kv head) vector; also the index of
// its scale) that holds logical position pos of slot b, for k (sel 0) or v
// (sel 1).
__device__ __forceinline__ uint32_t pool_row(const Args& A, int b, int kvh,
                                             int sel, int pos) {
    const int lp = pos / A.page;
    const int t = pos - lp * A.page;
    int pg = A.table[(size_t)b * A.mp + lp];
    pg = min(max(pg, 0), A.p - 1);
    return (((uint32_t)pg * 2 + sel) * A.layers + A.layer)
               * ((uint32_t)A.page * A.kv)
           + (uint32_t)t * A.kv + kvh;
}

constexpr uint32_t NO_ROW = 0xFFFFFFFFu;

// The pool row of this lane's token of the chunk at tok0: lane j < 16 the
// K row of token tok0 + j, lane 16 + j its V row; NO_ROW at or past len.
__device__ __forceinline__ uint32_t locate(const Args& A, int b, int kvh,
                                           int tok0, int len, int lane) {
    const int tok = tok0 + (lane & 15);
    return tok < len ? pool_row(A, b, kvh, lane >> 4, tok) : NO_ROW;
}

// Start the copy of a chunk into a stage: K rows, V rows (D payload
// elements each, zero-filled for NO_ROW) and their scales; ``row`` is this
// lane's locate().
template <int FMT, int DT>
__device__ __forceinline__ void load_chunk(unsigned char* st, const Args& A,
                                           uint32_t row, int lane) {
    using Gm = Geom<FMT>;
    const int d = DT ? DT : A.d;
    const int cpr = d * Gm::ES / 16;
#pragma unroll
    for (int i = 0; i < 2 * CHUNK * Gm::CPR / 32; ++i) {
        const int o = lane + 32 * i;
        const int r = o / Gm::CPR, c = o % Gm::CPR;
        const uint32_t src = __shfl_sync(0xffffffffu, row, r);
        if (c < cpr)
            wg::cp_async16(st + r * Gm::ROW + c * 16,
                           A.pool + (size_t)(src == NO_ROW ? 0u : src)
                                        * (d * Gm::ES) + c * 16,
                           src != NO_ROW);
    }
    const unsigned dst = (unsigned)__cvta_generic_to_shared(
        st + 2 * CHUNK * Gm::ROW + lane * 4);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(A.sc + (row == NO_ROW ? 0u : row)),
                    "r"(row == NO_ROW ? 0 : 4));
}

// DT: the head dim when it is fixed at compile time (128, the served
// model's), else 0 and A.d.
template <int FMT, int G, int DT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const Args A) {
    using Gm = Geom<FMT>;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int is_last;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int D = DT ? DT : A.d, ksteps = D / 16;
    const int len = min(max(A.lens[b], 0), A.mp * A.page);
    const int nchunks = (len + CHUNK - 1) / CHUNK;
    const int per = (nchunks + A.splits - 1) / A.splits;
    const int c_begin = split * per;
    const int c_end = min(nchunks, c_begin + per);
    // this warp's chunks: c_begin + warp, + 4, ...
    const int mine = c_end > c_begin + warp
        ? (c_end - c_begin - warp + WARPS - 1) / WARPS : 0;
    unsigned char* ring = smem + warp * STAGES * Gm::STAGE;

    // q^T as the B operand, one (b0, b1) pair per k16 step; queries g >= G
    // are zero.  One-byte payloads pair d = 4c, 4c + 2 and 4c + 1, 4c + 3.
    uint32_t qb[MAX_D / 16][2];
    const __nv_bfloat16* qrow =
        A.q + (((size_t)b * A.kv + kvh) * G + (g < G ? g : 0)) * D;
#pragma unroll
    for (int s = 0; s < MAX_D / 16; ++s) {
        qb[s][0] = qb[s][1] = 0u;
        if (s < ksteps && g < G) {
            if constexpr (Gm::ES == 1) {
                const uint2 v = *reinterpret_cast<const uint2*>(
                    qrow + 16 * s + 4 * c);
                qb[s][0] = __byte_perm(v.x, v.y, 0x5410);   // d 4c, 4c + 2
                qb[s][1] = __byte_perm(v.x, v.y, 0x7632);   // 4c + 1, 4c + 3
            } else {
                qb[s][0] = *reinterpret_cast<const uint32_t*>(
                    qrow + 16 * s + 2 * c);
                qb[s][1] = *reinterpret_cast<const uint32_t*>(
                    qrow + 16 * s + 8 + 2 * c);
            }
        }
    }

    // this warp's flash state: columns 2c, 2c + 1 (queries); acc[md] is the
    // m16n8 tile of ctx^T for d tile md
    float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
    float acc[MAX_D / 16][4];
#pragma unroll
    for (int md = 0; md < MAX_D / 16; ++md)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[md][e] = 0.f;

    const int mi = lane >> 3;
    auto tok_of = [&](int k) { return (c_begin + warp + WARPS * k) * CHUNK; };
#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) {
        if (k < mine)
            load_chunk<FMT, DT>(ring + k * Gm::STAGE, A,
                            locate(A, b, kvh, tok_of(k), len, lane), lane);
        wg::cp_async_commit();
    }
    // the page-table read of the next chunk to load runs a chunk ahead
    uint32_t row_next = STAGES - 1 < mine
        ? locate(A, b, kvh, tok_of(STAGES - 1), len, lane) : NO_ROW;
    for (int k = 0; k < mine; ++k) {
        const int kn = k + STAGES - 1;
        if (kn < mine)
            load_chunk<FMT, DT>(ring + (kn % STAGES) * Gm::STAGE, A, row_next,
                            lane);
        wg::cp_async_commit();
        if (kn + 1 < mine)
            row_next = locate(A, b, kvh, tok_of(kn + 1), len, lane);
        wg::cp_async_wait<STAGES - 1>();
        __syncwarp();
        const unsigned char* st = ring + (k % STAGES) * Gm::STAGE;
        const float* scl = reinterpret_cast<const float*>(
            st + 2 * CHUNK * Gm::ROW);
        const unsigned char* vrows = st + CHUNK * Gm::ROW;
        const int tok0 = tok_of(k);

        // scores S^T (tokens x queries): rows g and g + 8, columns 2c, 2c + 1
        // two accumulators (even and odd k16 steps) halve the MMA chain
        float sc4[4] = {0.f, 0.f, 0.f, 0.f}, sc4b[4] = {0.f, 0.f, 0.f, 0.f};
        const int srow = (lane & 7) + 8 * (mi & 1);
        if constexpr (Gm::ES == 1) {
#pragma unroll
            for (int pp = 0; pp < MAX_D / 32; ++pp) {
                if (2 * pp >= ksteps) break;
                uint32_t r[4];
                const unsigned char* at = st + srow * Gm::ROW
                                          + (2 * pp + (mi >> 1)) * 16;
                if (2 * pp + 1 < ksteps) frag::ldsm4(r, at);
                else frag::ldsm2(r, at);
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    if (2 * pp + hh >= ksteps) break;
                    uint32_t a[4];               // rows g, g + 8
                    upcast4<FMT>(r[2 * hh], a[0], a[2]);
                    upcast4<FMT>(r[2 * hh + 1], a[1], a[3]);
                    wg::mma_bf16(hh ? sc4b : sc4, a, qb[2 * pp + hh][0],
                                 qb[2 * pp + hh][1]);
                }
            }
        } else {
#pragma unroll
            for (int s = 0; s < MAX_D / 16; ++s) {
                if (s >= ksteps) break;
                uint32_t a[4];
                frag::ldsm4(a, st + srow * Gm::ROW + (2 * s + (mi >> 1)) * 16);
                wg::mma_bf16((s & 1) ? sc4b : sc4, a, qb[s][0], qb[s][1]);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc4[e] += sc4b[e];

        // scale after the dot, mask, running max, p, l, pv
        const bool v0 = tok0 + g < len, v1 = tok0 + g + 8 < len;
        const float ks0 = scl[g], ks1 = scl[g + 8];
        const float vs0 = scl[CHUNK + g], vs1 = scl[CHUNK + g + 8];
        float sv[4] = {v0 ? sc4[0] * ks0 : NEG, v0 ? sc4[1] * ks0 : NEG,
                       v1 ? sc4[2] * ks1 : NEG, v1 ? sc4[3] * ks1 : NEG};
        float alpha[2], pq[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            float mx = fmaxf(sv[j], sv[j + 2]);
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_run[j], mx);
            alpha[j] = expf(m_run[j] - m_new);
            m_run[j] = m_new;
            // an explicit 0 for a masked token: with every token masked
            // m_new is still the sentinel and exp(s - m_new) would be 1
            pq[j] = v0 ? expf(sv[j] - m_new) : 0.f;
            pq[j + 2] = v1 ? expf(sv[j + 2] - m_new) : 0.f;
            float sum = pq[j] + pq[j + 2];
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l_run[j] = l_run[j] * alpha[j] + sum;
        }
        const uint32_t b0 = frag::movmatrix_trans(
            wg::pack_bf16(pq[0] * vs0, pq[1] * vs0));
        const uint32_t b1 = frag::movmatrix_trans(
            wg::pack_bf16(pq[2] * vs1, pq[3] * vs1));

        // ctx^T += V^T . pv^T, after acc *= alpha (skipped where alpha is
        // 1 in every column, as it is once the running max has settled)
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
            for (int md = 0; md < MAX_D / 16; ++md) {
                if (md >= ksteps) break;
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[md][e] *= alpha[e & 1];
            }
        }
        if constexpr (Gm::ES == 1) {
            // d tile md is piece md of the row; fragment rows g, g + 8 are
            // d = 16 md + 2g, 2g + 1
#pragma unroll
            for (int mp2 = 0; mp2 < MAX_D / 32; ++mp2) {
                if (2 * mp2 >= ksteps) break;
                uint32_t r[4];
                const unsigned char* at = vrows + srow * Gm::ROW
                                          + (2 * mp2 + (mi >> 1)) * 16;
                if (2 * mp2 + 1 < ksteps) frag::ldsm4_trans(r, at);
                else frag::ldsm2_trans(r, at);
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    if (2 * mp2 + hh >= ksteps) break;
                    uint32_t a[4];   // tokens 2c, 2c + 1 | 2c + 8, 2c + 9
                    upcast4<FMT>(r[2 * hh], a[0], a[1]);
                    upcast4<FMT>(r[2 * hh + 1], a[2], a[3]);
                    wg::mma_bf16(acc[2 * mp2 + hh], a, b0, b1);
                }
            }
        } else {
            // d tile md is pieces 2md, 2md + 1; fragment rows g, g + 8 are
            // d = 16 md + g, 16 md + 8 + g
            const int vrow = (lane & 7) + 8 * (mi >> 1);
#pragma unroll
            for (int md = 0; md < MAX_D / 16; ++md) {
                if (md >= ksteps) break;
                uint32_t a[4];
                frag::ldsm4_trans(a, vrows + vrow * Gm::ROW
                                     + (2 * md + (mi & 1)) * 16);
                wg::mma_bf16(acc[md], a, b0, b1);
            }
        }
        __syncwarp();                  // the stage is free for the next load
    }
    wg::cp_async_wait<0>();
    __syncthreads();                   // every ring is free: merge space

    // the four warps' states -> shared memory: wm, wl [WARPS][QN], wacc
    // [WARPS][QN][D]
    float* wm = reinterpret_cast<float*>(smem);
    float* wl = wm + WARPS * QN;
    float* wacc = wl + WARPS * QN;
    if (g == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wm[warp * QN + 2 * c + j] = m_run[j];
            wl[warp * QN + 2 * c + j] = l_run[j];
        }
    }
#pragma unroll
    for (int md = 0; md < MAX_D / 16; ++md) {
        if (md >= ksteps) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int d = Gm::ES == 1 ? 16 * md + 2 * g + (e >> 1)
                                      : 16 * md + g + 8 * (e >> 1);
            wacc[(warp * QN + 2 * c + (e & 1)) * D + d] = acc[md][e];
        }
    }
    __syncthreads();

    // merge the warps in warp order: this block's (slot, kv head, split)
    // partial, written to the output (one split) or the workspace
    __shared__ float weight[MAX_SPLITS][QN];
    const size_t pair = (size_t)b * A.kv + kvh;
    const size_t part = pair * A.splits + split;
    if (tid < G) {
        float mt = NEG, lt = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, wm[w * QN + tid]);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            weight[w][tid] = expf(wm[w * QN + tid] - mt);
            lt += wl[w * QN + tid] * weight[w][tid];
        }
        if (A.splits == 1) {
            A.m[pair * G + tid] = mt;
            A.l[pair * G + tid] = lt;
        } else {
            A.ws_m[part * G + tid] = mt;
            A.ws_l[part * G + tid] = lt;
        }
    }
    __syncthreads();
    float* out_acc = A.splits == 1 ? A.acc + pair * G * D
                                   : A.ws_acc + part * G * D;
    for (int i = tid; i < G * D; i += THREADS) {
        const int q = i / D, d = i - q * D;
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
            a += wacc[(w * QN + q) * D + d] * weight[w][q];
        out_acc[i] = a;
    }
    if (A.splits == 1) return;

    // the last block of the pair merges all splits, in split order
    __threadfence();
    __syncthreads();
    if (tid == 0)
        is_last = atomicAdd(&A.counters[pair], 1) == A.splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();

    const size_t first = pair * A.splits;
    __syncthreads();                   // weight[] is free again
    if (tid < G) {
        float mt = NEG, lt = 0.f;
        for (int z = 0; z < A.splits; ++z)
            mt = fmaxf(mt, __ldcg(&A.ws_m[(first + z) * G + tid]));
        for (int z = 0; z < A.splits; ++z) {
            weight[z][tid] = expf(__ldcg(&A.ws_m[(first + z) * G + tid]) - mt);
            lt += __ldcg(&A.ws_l[(first + z) * G + tid]) * weight[z][tid];
        }
        A.m[pair * G + tid] = mt;
        A.l[pair * G + tid] = lt;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += THREADS) {
        const int q = i / D;
        float a = 0.f;
        for (int z = 0; z < A.splits; ++z)
            a += __ldcg(&A.ws_acc[(first + z) * G * D + i]) * weight[z][q];
        A.acc[pair * G * D + i] = a;
    }
    __syncthreads();
    if (tid == 0) A.counters[pair] = 0;
}

template <int FMT, int G, int DT>
cudaError_t launch_d(const Args& A, int batch, cudaStream_t stream) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        paged_attention_kernel<FMT, G, DT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<FMT>::SMEM);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(A.splits, A.kv, batch);
    paged_attention_kernel<FMT, G, DT><<<grid, THREADS, Geom<FMT>::SMEM, stream>>>(
        A);
    return cudaGetLastError();
}

template <int FMT, int G>
cudaError_t launch(const Args& A, int batch, cudaStream_t stream) {
    return A.d == MAX_D ? launch_d<FMT, G, MAX_D>(A, batch, stream)
                        : launch_d<FMT, G, 0>(A, batch, stream);
}

template <int FMT>
cudaError_t launch_g(const Args& A, int batch, int g, cudaStream_t stream) {
    switch (g) {
        case 1: return launch<FMT, 1>(A, batch, stream);
        case 2: return launch<FMT, 2>(A, batch, stream);
        case 4: return launch<FMT, 4>(A, batch, stream);
        case 8: return launch<FMT, 8>(A, batch, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// payload: 0 e4m3, 1 e5m2, 2 int8, 3 bf16.  g (query heads per kv head) is
// 1, 2, 4 or 8; d a multiple of 16 up to 128; the pool holds fewer than
// 2^32 rows.  ws_* and counters are used
// when splits > 1 (at most 16): counters holds one zeroed int per (slot, kv
// head).
extern "C" int fp8_paged_attention(const void* q, const void* pool,
                                   const void* sc, const void* table,
                                   const void* lens, void* acc, void* m,
                                   void* l, int batch, int kv, int g, int d,
                                   int p, int layers, int mp, int page,
                                   int layer, int payload, int splits,
                                   void* ws_acc, void* ws_m, void* ws_l,
                                   void* counters, void* stream) {
    if (batch < 1 || batch > 65535 || kv < 1 || kv > 65535 || d < 16
            || d > MAX_D || d % 16 != 0 || p < 1 || mp < 1 || page < 1
            || layer < 0 || layer >= layers || splits < 1
            || splits > MAX_SPLITS
            || (unsigned long long)p * 2 * layers * page * kv >= (1ull << 32))
        return (int)cudaErrorInvalidValue;
    Args A;
    A.q = reinterpret_cast<const __nv_bfloat16*>(q);
    A.pool = reinterpret_cast<const unsigned char*>(pool);
    A.sc = reinterpret_cast<const float*>(sc);
    A.table = reinterpret_cast<const int*>(table);
    A.lens = reinterpret_cast<const int*>(lens);
    A.acc = reinterpret_cast<float*>(acc);
    A.m = reinterpret_cast<float*>(m);
    A.l = reinterpret_cast<float*>(l);
    A.ws_acc = reinterpret_cast<float*>(ws_acc);
    A.ws_m = reinterpret_cast<float*>(ws_m);
    A.ws_l = reinterpret_cast<float*>(ws_l);
    A.counters = reinterpret_cast<int*>(counters);
    A.kv = kv; A.d = d; A.p = p; A.layers = layers; A.mp = mp;
    A.page = page; A.layer = layer; A.splits = splits;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (payload) {
        case E4M3: return (int)launch_g<E4M3>(A, batch, g, st);
        case E5M2: return (int)launch_g<E5M2>(A, batch, g, st);
        case INT8: return (int)launch_g<INT8>(A, batch, g, st);
        case BF16: return (int)launch_g<BF16>(A, batch, g, st);
    }
    return (int)cudaErrorInvalidValue;
}
