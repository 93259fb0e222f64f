// The e4m3 -> bf16 converts that the convert studies T1 (kexp_convert.cu)
// and T2 (fp8_linear_study.cu) compare, each giving the bf16 bit pattern:
//
//   ASTYPE  the hardware convert, K3's own (w8::upcast2<E4M3>: cvt of two
//           e4m3 bytes to f16x2, then f32), rounded to bf16 (exact for
//           every e4m3 value);
//   BITS    tools/kexp_convert.py::e4m3_bits_to_bf16 (= bench_pallas_
//           linear.py::conv_bits) bit for bit: normals by an integer add
//           of the bias difference, subnormals through an f32 multiply;
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

__device__ __forceinline__ uint32_t bits1(uint32_t x) {
    const uint32_t sign = (x & 0x80u) << 8, mag = x & 0x7Fu;
    const uint32_t normal = (mag << 4) + (120u << 7);
    const float sub_f = (float)(mag & 7u) * 0x1p-9f;
    const uint32_t sub = (__float_as_uint(sub_f) >> 16) & 0xFFFFu;
    uint32_t b = (mag >> 3) == 0 ? sub : normal;
    if (mag == 0x7Fu) b = 0x7FC0u;
    return sign | b;
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
        return bits1(two & 0xFFu) | (bits1((two >> 8) & 0xFFu) << 16);
    } else {
        return magic1(two & 0xFFu) | (magic1((two >> 8) & 0xFFu) << 16);
    }
}

}  // namespace e4m3
