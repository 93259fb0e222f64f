// K6, the in-place dynamic row store:  buf[idx mod n] = slab
//
// Replaces fp8tpu/kernels/inplace.py::_store_kernel.  One kernel stores up
// to two (buf, slab) pairs at one row index: buf is (n, ...) of any 1-, 2-,
// 4- or 8-byte type, slab one row of it, idx a 32-bit integer in device
// memory.  The kernel reads idx itself, so the launch needs no host
// synchronisation and can be captured in a CUDA graph; it writes each buf
// where it lies and copies nothing else.  A negative idx wraps to a
// non-negative row, as jnp's % does.
//
// The serving ring's write is one launch: the payload slab and the scale
// slab at row head, and head = (head + 1) mod n in place.  A batched ring
// write (ring_flush = W) stores W consecutive rows of each slab the same
// way: slab row w lands at row (head + w) mod n, so a start near the end
// wraps and no byte lands outside the ring, and head = (head + W) mod n.  Thread 0 of each
// block is the block's only reader of head: it reads head, then takes a
// ticket (a release atomicAdd on a word of the ring's own, so its read is
// done before the ticket counts), and the block that draws the last ticket
// writes the new head and puts the ticket back to 0.  No block reads a
// moved head: every block read it before it took its ticket.  The ticket is
// taken before the copy and its result waited for after it, so its round
// trip overlaps the copy.
//
// Bound on an H100: the bytes of the rows, read once and written once
// (0.16 us for the served 8-slot ring's two slabs), far below a launch, so
// the design keeps the whole write, head included, in one launch and the
// chain of dependent memory operations inside it short: each thread
// issues its slab loads (four 16-byte pieces where the row and the slab
// are 16-byte aligned, single bytes otherwise and for the tail) before
// thread 0 reads head, then stores them.  The ring's two slabs at 64 slots
// (2 MB + 64 KB) take 132 blocks, one an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;         // pieces a thread

struct Pair {
    unsigned char* buf;
    const unsigned char* slab;
    long long row_bytes;
    long long bytes;           // rows x row_bytes: the whole slab
    long long nvec;            // 16-byte pieces (0 where not aligned)
};

// Piece i, in the order a's 16-byte pieces, b's, then a's bytes past its
// pieces, then b's: where it comes from, its offset in the slab, and its
// width.  A 16-byte piece never straddles two rows: pieces exist only
// where row_bytes is a multiple of 16.
struct Piece {
    unsigned char* buf;
    const unsigned char* src;
    long long row_bytes;
    long long off;
    bool vec;
};

__device__ __forceinline__ Piece piece(const Pair& a, const Pair& b,
                                       long long i) {
    const long long tail_a = a.bytes - 16 * a.nvec;
    if (i < a.nvec) return {a.buf, a.slab, a.row_bytes, 16 * i, true};
    i -= a.nvec;
    if (i < b.nvec) return {b.buf, b.slab, b.row_bytes, 16 * i, true};
    i -= b.nvec;
    if (i < tail_a) return {a.buf, a.slab, a.row_bytes, 16 * a.nvec + i,
                            false};
    return {b.buf, b.slab, b.row_bytes, 16 * b.nvec + i - tail_a, false};
}

__global__ void __launch_bounds__(THREADS)
ring_store_kernel(Pair a, Pair b, int* idx, unsigned* ticket, int n,
                  int rows, long long total) {
    __shared__ int row;
    const long long i0 = (long long)blockIdx.x * THREADS * PER + threadIdx.x;
    uint4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const long long i = i0 + k * THREADS;
        if (i >= total) break;
        const Piece q = piece(a, b, i);
        if (q.vec) {
            v[k] = *reinterpret_cast<const uint4*>(q.src + q.off);
        } else {
            v[k].x = q.src[q.off];
        }
    }
    // the slab loads are in flight while thread 0 reads head
    unsigned drawn = 0;
    if (threadIdx.x == 0) {
        const int h = *idx % n;
        row = h < 0 ? h + n : h;
        // release: the read of head is done before the ticket counts; the
        // result is waited for only at the end, after the copy
        if (ticket != nullptr)
            asm volatile("atom.release.gpu.global.add.u32 %0, [%1], 1;"
                         : "=r"(drawn) : "l"(ticket) : "memory");
    }
    __syncthreads();
    const int r = row;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const long long i = i0 + k * THREADS;
        if (i >= total) break;
        const Piece q = piece(a, b, i);
        long long dr = r, off = q.off;
        if (rows > 1) {            // slab row w goes to row (r + w) mod n
            const long long w = q.off / q.row_bytes;
            off -= w * q.row_bytes;
            dr += w;
            if (dr >= n) dr -= n;
        }
        unsigned char* dst = q.buf + dr * q.row_bytes + off;
        if (q.vec) {
            *reinterpret_cast<uint4*>(dst) = v[k];
        } else {
            *dst = (unsigned char)v[k].x;
        }
    }
    if (threadIdx.x == 0 && ticket != nullptr && drawn == gridDim.x - 1) {
        __threadfence();
        *idx = (int)(((long long)r + rows) % n);
        *ticket = 0;
    }
}

Pair pair_of(void* buf, const void* slab, long long row_bytes, int rows) {
    Pair p;
    p.buf = reinterpret_cast<unsigned char*>(buf);
    p.slab = reinterpret_cast<const unsigned char*>(slab);
    p.row_bytes = row_bytes;
    p.bytes = row_bytes * rows;
    p.nvec = ((reinterpret_cast<uintptr_t>(buf) | (uintptr_t)row_bytes
               | reinterpret_cast<uintptr_t>(slab)) & 15) == 0
        ? p.bytes / 16 : 0;
    return p;
}

}  // namespace

// buf_b / slab_b may be null with row_bytes_b 0 (one pair).  Each slab is
// ``rows`` rows (1 <= rows <= n), stored at rows idx .. idx + rows - 1 mod
// n.  ticket null: idx is only read; else idx is advanced to (idx + rows)
// mod n by the launch (ticket: a zeroed int32 of the caller's, back at 0
// when the launch ends).
extern "C" int fp8_ring_store(void* buf_a, const void* slab_a,
                              long long row_bytes_a, void* buf_b,
                              const void* slab_b, long long row_bytes_b,
                              void* idx, void* ticket, long long n, int rows,
                              void* stream) {
    if (n <= 0 || n > 0x7FFFFFFFLL || row_bytes_a < 0 || row_bytes_b < 0
        || rows < 1 || rows > n)
        return (int)cudaErrorInvalidValue;
    const Pair a = pair_of(buf_a, slab_a, row_bytes_a, rows);
    const Pair b = pair_of(buf_b, slab_b, row_bytes_b, rows);
    const long long total = a.nvec + b.nvec + (a.bytes - 16 * a.nvec)
        + (b.bytes - 16 * b.nvec);
    long long blocks = (total + THREADS * PER - 1) / (THREADS * PER);
    if (blocks < 1) blocks = 1;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    ring_store_kernel<<<(unsigned)blocks, THREADS, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
        a, b, reinterpret_cast<int*>(idx), reinterpret_cast<unsigned*>(ticket),
        (int)n, rows, total);
    return (int)cudaGetLastError();
}
