// The e4m3 -> bf16 converts that the convert studies T1 (kexp_convert.cu)
// and T2 (fp8_linear_study.cu) compare, each giving the bf16 bit pattern:
//
//   ASTYPE  the hardware convert, K3's own (w8::upcast2<E4M3>: cvt of two
//           e4m3 bytes to f16x2, then f32), rounded to bf16 (exact for
//           every e4m3 value);
//   BITS    tools/kexp_convert.py::e4m3_bits_to_bf16 (= bench_pallas_
//           linear.py::conv_bits) bit for bit: normals by an integer add
//           of the bias difference, subnormals by a multiply, the NaN
//           bytes selected; two bytes at a time in one 32-bit word, with
//           no per-byte branch, no int -> f32 convert and no fp8 cvt
//           (bits_pair);
//   MAGIC   tools/bench_pallas_linear.py::conv_magic: the same normals
//           selected by mag >= 8, subnormals from an eight-entry table.
//
// BITS and MAGIC map the NaN bytes 0x7F / 0xFF to 0x7FC0 | sign; ASTYPE
// gives the hardware's NaN.
#pragma once

#include <stdint.h>

#include "w8_policy.cuh"

namespace e4m3 {

enum Convert { ASTYPE = 0, BITS = 1, MAGIC = 2 };

// Each half of d: 0xFFFF where a's bf16 value >= b's, else 0 (one HSET2,
// off the integer pipe).
__device__ __forceinline__ uint32_t ge_mask(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("set.ge.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// Bytes LO and HI of w -> a bf16x2 word (byte LO in the low half), by the
// tool's integer pipeline on both halves at once.  x holds the bytes at
// bits 0-7 and 16-23 (prmt); mag << 4 then lies in bits 4-10 of a half,
// read as a bf16: a normal number where mag >= 8, a subnormal (m * 2^-133)
// where mag = m < 8, so mul.rn.bf16x2 by 2^120 makes the subnormals m *
// 2^-9 exactly, and bf16 compares give the masks (mag >= 8; mag == 0x7F,
// the largest).  Normals add the bias difference; no carry leaves a half.
// 11 instructions a pair: prmt, 2 shifts, an add, the multiply, 2 compares
// and 4 lop3.  Only the prmt and the lop3 need the integer units (64 an
// SM on an H100, against 128 FP32 lanes); the shifts compile to IMAD and
// the compares to HSET2, which run beside them.
template <int LO, int HI>
__device__ __forceinline__ uint32_t bits_pair(uint32_t w) {
    const uint32_t x = __byte_perm(w, 0u, 0x4040u | (HI << 8) | LO);
    const uint32_t m4 = (x << 4) & 0x07F007F0u;
    const uint32_t normal = m4 + 0x3C003C00u;           // + (127 - 7) << 7
    uint32_t sub;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(sub) : "r"(m4), "r"(0x7B807B80u));
    const uint32_t ge8 = ge_mask(m4, 0x00800080u);      // 2^-126
    const uint32_t nan = ge_mask(m4, 0x07F007F0u);
    const uint32_t b = (normal & ge8) | (sub & ~ge8);
    uint32_t out;               // NaN selected, then the sign: two lop3
    asm("lop3.b32 %0, %1, 0x7FC07FC0, %2, 0xD8;" : "=r"(out) : "r"(b), "r"(nan));
    asm("lop3.b32 %0, %1, %2, 0x80008000, 0xF8;" : "=r"(out) : "r"(out), "r"(x << 8));
    return out;
}

__device__ __forceinline__ uint32_t magic1(uint32_t x) {
    const uint32_t mag = x & 0x7Fu;
    const uint32_t normal = (mag << 4) + (120u << 7);
    // bf16 bits of m * 2^-9, m = 0..7, four to a 64-bit word
    const unsigned long long table =
        (mag & 4u) ? 0x3C603C403C203C00ull : 0x3BC03B803B000000ull;
    const uint32_t sub = (uint32_t)(table >> (16u * (mag & 3u))) & 0xFFFFu;
    uint32_t b = mag >= 8u ? normal : sub;
    if (mag == 0x7Fu) b = 0x7FC0u;
    return ((x & 0x80u) << 8) | b;
}

// Two e4m3 bytes (low byte first) -> a bf16x2 word (low half first).
template <int CONV>
__device__ __forceinline__ uint32_t cvt2(uint32_t two) {
    if constexpr (CONV == ASTYPE) {
        const float2 f = w8::upcast2<w8::E4M3>((unsigned short)(two & 0xFFFFu));
        return wg::pack_bf16(f.x, f.y);
    } else if constexpr (CONV == BITS) {
        return bits_pair<0, 1>(two);
    } else {
        return magic1(two & 0xFFu) | (magic1((two >> 8) & 0xFFu) << 16);
    }
}

// Bytes 2 HALF and 2 HALF + 1 of w -> a bf16x2 word: BITS picks them in
// its own first prmt, the others through cvt2.
template <int CONV, int HALF>
__device__ __forceinline__ uint32_t cvt_half(uint32_t w) {
    if constexpr (CONV == BITS) {
        return bits_pair<2 * HALF, 2 * HALF + 1>(w);
    } else {
        return cvt2<CONV>(HALF ? w >> 16 : w & 0xFFFFu);
    }
}

}  // namespace e4m3
