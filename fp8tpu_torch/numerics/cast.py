"""Fake-quantization casts in plain torch ops: the plain version of the
cast kernel (K1, ``kernels/csrc/cast_kernel.cu``).

The bit pipeline is the one of ``fp8tpu.numerics.cast``, written with
int64 tensors and explicit 32-bit masks because torch has no uint32
shifts or adds on the CPU.  Where the JAX code relies on uint32
wraparound, the masks reproduce it.

Subnormal f32 values: the JAX package runs under XLA, whose f32
arithmetic treats subnormal inputs as zero and flushes subnormal results
(DAZ/FTZ) on the CPU and the TPU alike.  The port reproduces that
explicitly around each float multiply and divide of the pipeline
(:func:`_mul`, :func:`_recip`), so the result does not depend on the
device's denormal mode; the CUDA pipeline does the same.

Public entry points (:func:`qdq`, :func:`qdq_mode_string`,
:func:`qdq_blocked`) run this plain pipeline for tensors on the CPU and
launch K1 for tensors on a CUDA device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from .formats import FORMATS, FPFormat, RoundMode, parse_mode_string
from .prng import PRNGKey, salt_of, threefry_bits32

# SR dither source, from the same variable as the JAX package: "hash" (the
# counter hash of :func:`sr_bits_from_salt`, which the kernels compute from
# a salt) or "threefry" (``jax.random.bits``, drawn here and handed to the
# kernels as explicit bits).  Read at every call.
SR_BITS_IMPL = os.environ.get("FP8TPU_SR_BITS", "hash")

_M32 = 0xFFFFFFFF
_F32_MIN_NORMAL = 2.0 ** -126


# -- int64 views of f32 bit patterns -----------------------------------------

def _bits(f: torch.Tensor) -> torch.Tensor:
    """f32 → its bit pattern as a non-negative int64."""
    return f.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _M32


def _float(u: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 → the f32 with that bit pattern."""
    u = u & _M32
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def _flush(t: torch.Tensor) -> torch.Tensor:
    """Subnormal → signed zero (DAZ on an input, FTZ on a result)."""
    return torch.where(t.abs() < _F32_MIN_NORMAL, t * 0.0, t)


def _mul(a, b) -> torch.Tensor:
    """f32 product under DAZ/FTZ, as XLA computes it."""
    return _flush(_flush(a) * _flush(b))


def _recip(scale: torch.Tensor) -> torch.Tensor:
    scale = _flush(scale)
    return _flush(torch.ones_like(scale) / scale)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


# -- SR bits ------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for 32-bit a and c, without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sr_bits_from_salt(salt: int, n: int, device=None,
                      index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint16-valued SR bits (as int64) for flat indices 0..n-1 (or for
    the int64 flat indices ``index``, a block of a larger tensor): the
    murmur3-finalizer counter hash of ``fp8tpu.numerics.cast.sr_bits``."""
    idx = (torch.arange(max(n, 1), dtype=torch.int64, device=device)
           if index is None else index.to(device=device, dtype=torch.int64)
           & _M32)
    h = (_mul32(idx, 0xCC9E2D51) + (salt & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >> 16


def salt_at(salt: int, offset: int) -> int:
    """The salt whose stream starts where ``salt``'s stream is at element
    ``offset``: the hash adds ``idx * 0xCC9E2D51`` to the salt mod 2^32, so
    element ``offset + i`` of one is element ``i`` of the other (a batch
    shard's SR bits are the global tensor's at its offset, with no change
    to a kernel that hashes from a salt)."""
    return (salt + offset * 0xCC9E2D51) & _M32


def require_hash_stream(what: str) -> None:
    """Raise unless SR bits are the counter hash: ``what`` hashes them from
    a salt in the kernel, which cannot give the threefry stream."""
    if SR_BITS_IMPL != "hash":
        raise NotImplementedError(
            f"{what}: SR bits hashed in the kernel from a salt, but "
            f"FP8TPU_SR_BITS={SR_BITS_IMPL!r} asks for another stream; "
            "pass the bits (numerics.cast.sr_bits) instead")


def sr_bits(key: PRNGKey, shape: Sequence[int], device=None,
            offset: int = 0, block=None) -> torch.Tensor:
    """Counter-based random bits for stochastic rounding, deterministic in
    (key, element index); bit-equal to the JAX package for the same key
    data under either :data:`SR_BITS_IMPL` (under "threefry": the low 16
    bits of ``jax.random.bits``' uint32 words, which is what its uint16
    draw keeps).  ``offset``: the bits of the elements ``offset ..`` of a
    larger tensor (a batch shard's, at its row-major offset); ``block``
    (a ``parallel.data.Block``): the bits of a block of a larger tensor,
    each element's at its global row-major index (a column or sequence
    block, whose indices are not one range)."""
    n = 1
    for s in shape:
        n *= int(s)
    index = None
    if block is not None:
        off = block.contiguous_offset(shape)
        if off is None:
            index = block.index(shape, device)
        else:
            offset = off
    if SR_BITS_IMPL == "threefry":
        flat = threefry_bits32(key, n, device, offset, index) & 0xFFFF
    elif index is not None:
        flat = sr_bits_from_salt(salt_of(key), n, device, index)
    else:
        flat = sr_bits_from_salt(salt_at(salt_of(key), offset), n,
                                 device)[:n]
    return flat.reshape(tuple(shape))


# -- fp32 <-> fp16 bit patterns -----------------------------------------------

def f32_to_f16_bits(f: torch.Tensor) -> torch.Tensor:
    """IEEE fp32 → fp16 bit pattern with RNE, in integer ops (int64).
    f32 subnormals underflow to zero."""
    u = _bits(f)
    sign = (u >> 16) & 0x8000
    absu = u & 0x7FFFFFFF
    exp = absu >> 23
    mant = absu & 0x7FFFFF
    e = exp - 127

    lsb = (mant >> 13) & 1
    h_norm = (e + 15) * 1024 + ((mant + 0xFFF + lsb) >> 13)

    m24 = mant | 0x800000
    rs = torch.clamp(-e - 1, 1, 30)
    lsb_s = (m24 >> rs) & 1
    h_sub = (m24 + ((torch.ones_like(rs) << (rs - 1)) - 1) + lsb_s) >> rs

    h_naninf = 0x7C00 | torch.where(mant != 0, (mant >> 13) | 0x200, 0)

    h = torch.where(e >= -14, h_norm, h_sub)
    h = torch.where(e > 15, 0x7C00, h)
    h = torch.where(exp == 0, 0, h)
    h = torch.where(exp == 255, h_naninf, h)
    return h | sign


def f16_bits_to_f32(h: torch.Tensor) -> torch.Tensor:
    """fp16 bit pattern (integer tensor) → fp32 value."""
    h = h & 0xFFFF
    sign = (h >> 15) & 1
    exp = (h >> 10) & 0x1F
    mant = h & 0x3FF

    bits_norm = (sign << 31) | ((exp + 112) << 23) | (mant << 13)
    bits_naninf = (sign << 31) | 0x7F800000 | (mant << 13)
    f = _float(torch.where(exp == 31, bits_naninf, bits_norm))

    f_sub = mant.to(torch.float32) * (2.0 ** -24)
    f_sub = torch.where(sign == 1, -f_sub, f_sub)
    return torch.where(exp == 0, f_sub, f)


def _to_f16_bits(x, scale):
    return f32_to_f16_bits(_mul(x.to(torch.float32), scale))


def _from_f16_bits(u, inv):
    return _mul(f16_bits_to_f32(u), inv)


def _nearest_increment(mode, rnmask, rntie, positive, fmt: FPFormat):
    half = fmt.rounding_half
    if mode == RoundMode.RNE:
        up = (rnmask > half) | (rntie == fmt.cast_tie_mask)
    elif mode == RoundMode.RNAZ:
        up = rnmask >= half
    elif mode == RoundMode.RNTZ:
        up = rnmask > half
    elif mode == RoundMode.RPINF:
        up = positive & (rnmask >= half)
    elif mode == RoundMode.RNINF:
        up = (~positive) & (rnmask >= half)
    elif mode == RoundMode.RTZ:
        up = torch.zeros_like(rnmask, dtype=torch.bool)
    else:
        raise ValueError(f"not a nearest mode: {mode}")
    return up.to(torch.int64) << fmt.cast_lshift


def _prep_scale(scale, x, descale=True):
    """(scale, the final multiplier): 1/scale, or 1 where the cast is to
    stop on the scaled grid (``descale=False``)."""
    scale = _f32(scale, x)
    return scale, _recip(scale) if descale else torch.ones_like(scale)


def _rand(random_bits, mask):
    return random_bits.to(torch.int64) & mask


# -- format bodies --------------------------------------------------------------

def _cast_e5m2(x, mode, scale, daz, random_bits, descale=True):
    fmt = FORMATS["e5m2"]
    scale, inv = _prep_scale(scale, x, descale)
    h = _to_f16_bits(x, scale)

    exp_field = h & 0x7C00
    can_round = (h & 0x7F00) <= fmt.cast_can_round_limit
    is_normal = (exp_field <= 0x7800) & (exp_field >= 0x0400)
    is_denorm = exp_field == 0
    is_naninf = exp_field == 0x7C00
    positive = (h & 0x8000) == 0

    rnmask = h & fmt.cast_grs_mask
    rntie = h & fmt.cast_tie_mask
    rne_incr = _nearest_increment(RoundMode.RNE, rnmask, rntie, positive, fmt)

    if mode == RoundMode.STOCHASTIC:
        rand = _rand(random_bits, fmt.cast_grs_mask)
        if daz:
            incr = rand.expand_as(h)
        else:
            incr = (torch.where(is_normal, rand, 0)
                    + torch.where(is_denorm, rne_incr, 0))
    else:
        incr = _nearest_increment(mode, rnmask, rntie, positive, fmt)

    apply = (~is_naninf) & can_round
    if daz:
        apply = apply & is_normal
    h = torch.where(apply, h + incr, h)
    if daz:
        h = torch.where(is_denorm, 0, h)
    h = h & fmt.mant_trunc_mask
    return _from_f16_bits(h, inv)


def _cast_rebias(x, fmt: FPFormat, mode, scale, random_bits, descale=True):
    scale, inv = _prep_scale(scale, x, descale)
    h = _to_f16_bits(x, scale)

    exp = ((h >> 10) & 0x1F) - 15
    sign = h & 0x8000
    mant = h & 0x03FF

    can_round = (h & 0x7FFF) < fmt.cast_can_round_limit
    is_denorm = (h & 0x7C00) == 0
    is_naninf = (h & 0x7C00) == 0x7C00
    positive = sign == 0

    sat = (exp > fmt.cast_exp_sat) | (~can_round)
    mant = torch.where(sat, fmt.cast_sat_mant, mant)
    exp = torch.where(sat, fmt.cast_exp_sat, exp)
    can_round = can_round & (~sat)

    flush = (~sat) & (exp < fmt.cast_flush_exp)
    mant = torch.where(flush, 0, mant)
    exp = torch.where(flush, -15, exp)

    dn = (~sat) & (~flush) & (exp < fmt.cast_min_norm_exp)
    dshift = torch.where(dn, fmt.cast_min_norm_exp - exp, 0)
    mant = torch.where(dn, (mant >> dshift) << dshift, mant)

    rnmask = mant & fmt.cast_grs_mask
    rntie = mant & fmt.cast_tie_mask
    rne_incr = _nearest_increment(RoundMode.RNE, rnmask, rntie, positive, fmt)

    if mode == RoundMode.STOCHASTIC:
        rand = _rand(random_bits, fmt.cast_grs_mask)
        is_normal = ((h & 0x7C00) <= 0x7800) & ((h & 0x7C00) >= 0x0400)
        incr = (torch.where(is_normal, rand, 0)
                + torch.where(is_denorm, rne_incr, 0))
    else:
        incr = _nearest_increment(mode, rnmask, rntie, positive, fmt)

    mant = torch.where((~is_naninf) & can_round, mant + incr, mant)
    mant = mant & fmt.mant_trunc_mask
    out = (mant + (exp + 15) * 1024) | sign
    return _from_f16_bits(out, inv)


def _cast_e4m3_v2(x, mode, scale, random_bits, descale=True):
    """E4M3 "v2": raw fp16 exponent kept, 3 mantissa bits, everything
    ``|x| >= 1.0`` (inf/NaN included) saturated to ±0.9375 before
    rounding."""
    fmt = FORMATS["e4m3"]
    scale, inv = _prep_scale(scale, x, descale)
    h = _to_f16_bits(x, scale)

    exp = ((h >> 10) & 0x1F) - 15
    sign = h & 0x8000
    mant = h & 0x03FF
    can_round = (h & 0x7FFF) < 0x4B80
    exp_field = h & 0x7C00
    is_normal = (exp_field <= 0x7800) & (exp_field >= 0x0400)
    is_denorm = exp_field == 0
    is_naninf = exp_field == 0x7C00
    positive = sign == 0

    sat = exp > -1
    mant = torch.where(sat, 0x0380, mant)
    exp = torch.where(sat, -1, exp)
    can_round = can_round & (~sat)

    rnmask = mant & fmt.cast_grs_mask
    rntie = mant & fmt.cast_tie_mask
    if mode == RoundMode.STOCHASTIC:
        rne_incr = _nearest_increment(RoundMode.RNE, rnmask, rntie,
                                      positive, fmt)
        rand = _rand(random_bits, fmt.cast_grs_mask)
        incr = (torch.where(is_normal, rand, 0)
                + torch.where(is_denorm, rne_incr, 0))
    else:
        incr = _nearest_increment(mode, rnmask, rntie, positive, fmt)
    mant = torch.where(can_round & (~is_naninf), mant + incr, mant)
    mant = mant & 0xFF80
    out = (mant + (exp + 15) * 1024) | sign
    return _from_f16_bits(out, inv)


def _cast_bfloat16(x, mode, random_bits):
    u = _bits(x)
    naninf = (u & 0x7F800000) == 0x7F800000
    if mode == RoundMode.STOCHASTIC:
        incr = _rand(random_bits, 0xFFFF)
    else:
        incr = 0x7FFF + ((u >> 16) & 1)
    u = torch.where(naninf, u, (u + incr) & _M32)
    return _float(u & 0xFFFF0000)


def _cast_float16(x, mode, daz, random_bits):
    xf = x.to(torch.float32)
    if mode == RoundMode.RNE:
        bits = f32_to_f16_bits(xf)
        if daz:
            bits = torch.where((bits & 0x7C00) == 0, 0, bits)
        return f16_bits_to_f32(bits)

    u = _bits(xf)
    exp = ((u >> 23) & 0xFF) - 127
    mant = u & 0x7FFFFF
    sign = u & 0x80000000

    nan_mant = torch.where((mant != 0) & ((mant & 0x400000) == 0),
                           mant | 0x400000, mant)
    h_naninf = ((0x1F << 23) | nan_mant | (sign >> 3)) >> 13
    h_inf = ((0x1F << 23) | (sign >> 3)) >> 13
    rb = (torch.zeros_like(u) if random_bits is None
          else _rand(random_bits, 0x1FFF))
    exp_bits = ((exp + 15) & 0x1FF) << 23
    h_norm = (((exp_bits | mant | (sign >> 3)) + rb) & _M32) >> 13
    h_denorm = f32_to_f16_bits(xf)

    h = torch.where(
        exp == 128, h_naninf,
        torch.where(exp >= 16, h_inf,
                    torch.where(exp < -14, h_denorm, h_norm)))
    return f16_bits_to_f32(h & 0xFFFF)


def _cast_e5m2_noinf(x, scale, descale=True):
    """E5M2 noINF (exponent offset 16, inf/NaN encodings reclaimed)."""
    scale, inv = _prep_scale(scale, x, descale)
    h = _to_f16_bits(x, scale)
    naninf = (h & 0x7C00) == 0x7C00
    tie = ((h & 0x0100) == 0x0100).to(torch.int64)
    enc = ((((h & 0x7C00) >> 10) + 1) << 10) | (h & 0x83FF)
    enc = torch.where(~naninf, enc + 0x7F + tie, enc) & 0xFFFF
    sat = (h & 0x7FFF) > 0x7F00
    enc = torch.where(sat, (enc & 0x8000) | 0x7F00, enc)
    enc = torch.where(naninf, 0x8000, enc)
    d = ((enc >> 8) & 0xFF) << 8
    dexp = ((((d & 0x7C00) >> 10) - 1) * 1024) & 0xFFFF
    out = (dexp | (d & 0x83FF)) & 0xFFFF
    out = torch.where(d == 0x8000, 0x7C00, out)
    return _from_f16_bits(out, inv)


def _cast_e5m2_flex(x, scale):
    """E5M2 flex-denormal (f32-domain single rounding; ``scale`` is
    accepted and unused, as in the reference)."""
    del scale
    u = _bits(x)
    expf = u & 0x7F800000
    naninf = expf == 0x7F800000
    tie = ((u & 0x00200000) == 0x00200000).to(torch.int64)
    zflush = expf < 0x37800000
    denorm = expf < 0x38800000
    sign = u & 0x80000000
    urne = torch.where(~naninf, (u + 0xFFFFF + tie) & _M32, u)
    exp = ((urne & 0x7F800000) >> 23) - 127
    mant = urne & 0x7FFFFF
    shft = -15 - exp
    rshft = torch.where(denorm, 21 + shft, 21)
    lshft = torch.where(denorm, 8 + shft, 8)
    mant2 = torch.where(
        rshft < 24,
        (mant >> torch.clamp(rshft, 0, 31)) << torch.clamp(lshft, 0, 31), 0)
    out = (mant2 | (((exp + 15) * 1024) & 0xFFFF)
           | torch.where(sign != 0, 0x8000, 0)) & 0xFFFF
    out = torch.where(zflush, 0, out)
    return f16_bits_to_f32(out)


def _cast_fp4(x, scale, descale=True):
    scale, inv = _prep_scale(scale, x, descale)
    f = _mul(x.to(torch.float32), scale)
    u = _bits(f)
    exp = ((u >> 23) & 0xFF) - 127
    sign = u & 0x80000000

    odd_neg = (exp < 0) & ((exp % 2) != 0)
    f2 = torch.where(odd_neg, _mul(f, _f32(1.6, f)), f)
    u2 = _bits(f2)
    u2 = torch.where(exp > 0, sign | (127 << 23), u2)
    u2 = u2 & 0xFF800000
    exp2 = ((u2 >> 23) & 0xFF) - 127
    odd2 = (exp2 < 0) & ((exp2 % 2) != 0)
    # (exp2 + 126) << 23 wraps like the reference's C int arithmetic.
    fixed = sign | ((((exp2 + 126) & _M32) << 23) & _M32)
    u2 = torch.where(odd2, fixed, u2)
    # Flush uses the pre-adjustment exponent, as in the reference.
    u2 = torch.where(exp2 < -12, 0, u2)
    return _mul(_float(u2), inv)


def cast_array(x, scale, random_bits, fmt_name: str, mode: RoundMode,
               daz: bool = False, descale: bool = True) -> torch.Tensor:
    """The plain cast core: ``x`` any float tensor, ``scale`` broadcastable
    to it, ``random_bits`` an integer tensor broadcastable to it (or None).
    Returns float32.  ``descale=False`` stops on the scaled grid: the cast
    without its final multiply by 1/scale (formats that take no scale
    return their cast)."""
    if fmt_name == "e5m2_noinf":
        if mode != RoundMode.RNE:
            raise ValueError("e5m2_noinf implements RNE only")
        return _cast_e5m2_noinf(x, scale, descale)
    if fmt_name == "e5m2_flex":
        if mode != RoundMode.RNE:
            raise ValueError("e5m2_flex implements RNE only")
        return _cast_e5m2_flex(x, scale)
    if fmt_name == "e4m3_v2":
        return _cast_e4m3_v2(x, mode, scale, random_bits, descale)
    fmt = FORMATS[fmt_name]
    if fmt_name == "e5m2":
        return _cast_e5m2(x, mode, scale, daz, random_bits, descale)
    if fmt_name in ("e4m3", "e4m3_ieee", "e3m4"):
        return _cast_rebias(x, fmt, mode, scale, random_bits, descale)
    if fmt_name == "bfloat16":
        return _cast_bfloat16(x, mode, random_bits)
    if fmt_name == "float16":
        return _cast_float16(x, mode, daz, random_bits)
    if fmt_name == "fp4":
        return _cast_fp4(x, scale, descale)
    raise ValueError(f"unknown format {fmt_name}")


# -- hardware-convert route (cast_impl="hw") -----------------------------------

HW_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
             "bfloat16": torch.bfloat16, "float16": torch.float16}


def _convert_nan(xf: torch.Tensor, fmt_name: str) -> torch.Tensor:
    """What XLA's f32 → dtype → f32 round trip makes of a NaN: the sign and
    the quiet bit for the fp8 formats and bf16; float16 keeps the top ten
    payload bits as well.  torch's own converts drop the sign (bf16) or
    depend on the tensor's size (float16), so the NaNs are made here."""
    u = _bits(xf)
    if fmt_name == "float16":
        return _float((u & 0xFFFFE000) | 0x00400000)
    return _float((u & 0x80000000) | 0x7FC00000)


def hw_qdq(x, fmt_name: str, scale, descale: bool = True) -> torch.Tensor:
    """RNE fake-quant through the native dtype convert: clip, one
    f32→dtype→f32 round trip, descale.  Finite out-of-range values
    saturate to ±max_normal (the clip precedes the convert: torch and XLA
    disagree on out-of-range fp8 converts); ±inf passes through on
    formats with an inf encoding and NaN stays NaN, with the bits XLA's
    convert gives it."""
    fmt = FORMATS[fmt_name]
    scale = _f32(scale, x)
    xf = _mul(x.to(torch.float32), scale)
    clipped = torch.clamp(xf, -fmt.max_normal, fmt.max_normal)
    xf = torch.where(torch.isinf(xf), xf, clipped) if fmt.has_inf else clipped
    y = xf.to(HW_DTYPES[fmt_name]).to(torch.float32)
    y = torch.where(torch.isnan(xf), _convert_nan(xf, fmt_name), y)
    return _flush(y / _flush(scale)) if descale else y


def hw_sr(x, fmt_name: str, scale, rb, descale: bool = True) -> torch.Tensor:
    """f32-domain stochastic rounding onto ``fmt_name``'s grid (the
    training casts), bit for bit ``fp8tpu.numerics.cast.hw_sr``.

    ``rb``: uint16-valued random bits of ``x``'s shape.  Normal range: the
    bits are added below the cut (23 - mantissa bits) of the f32 pattern,
    which is then truncated; the add wraps in 32 bits as JAX's uint32 add
    does.  Subnormal range: ``floor(|x|/g + u) * g`` on the format's fixed
    grid g, u = rb / 2^16; bfloat16's subnormal range is f32-subnormal,
    where XLA's flush leaves exact zeros.  Then saturation; NaN and, on
    formats with an inf encoding, ±inf pass through."""
    fmt = FORMATS[fmt_name]
    m, emin = fmt.mant_bits, 1 - fmt.bias
    scale = _f32(scale, x)
    xs0 = _mul(x.to(torch.float32), scale)
    xs = torch.clamp(xs0, -fmt.max_normal, fmt.max_normal)
    u = _bits(xs)
    sign = u & 0x80000000
    mag = u & 0x7FFFFFFF
    e = (mag >> 23) - 127
    rb = rb.to(device=x.device, dtype=torch.int64) & 0xFFFF

    cut = 23 - m
    radd = rb << (cut - 16) if cut >= 16 else rb >> (16 - cut)
    y_norm = _float(((mag + radd) & _M32) & ((_M32 << cut) & _M32))

    shift = m - emin
    if shift > 126:
        y_sub = torch.zeros_like(xs)
    else:
        u01 = rb.to(torch.float32) * 2.0 ** -16
        y_sub = torch.floor(_float(mag) * 2.0 ** shift + u01) \
            * 2.0 ** (emin - m)
    y = torch.where(e >= emin, y_norm, y_sub)
    out = _float(sign | _bits(y))
    out = torch.clamp(out, -fmt.max_normal, fmt.max_normal)
    out = torch.where(torch.isnan(xs0), xs0, out)
    if fmt.has_inf:
        out = torch.where(torch.isinf(xs0), xs0, out)
    return _flush(out / _flush(scale)) if descale else out


# -- entry points ---------------------------------------------------------------

def _salt_for(mode, key, random_bits, offset: int = 0) -> Optional[int]:
    """The SR salt when the bits come from ``key`` (at element ``offset``
    of its stream); None otherwise."""
    if mode != RoundMode.STOCHASTIC or random_bits is not None:
        return None
    if key is None:
        raise ValueError("stochastic rounding requires key or random_bits")
    return salt_at(salt_of(key), offset)


def block_scales(x: torch.Tensor, block_size: int, fmt: FPFormat | str):
    """Per-block scales over the flattened tensor (size a multiple of
    ``block_size``):

    scale_b = 2 · 2^⌊log2(absmax_b)⌋ / headroom   (fp8 formats)
    scale_b = 1 / absmax_b                        (fp4)

    All-zero blocks get scale 1.0.  absmax is taken under DAZ, as XLA's
    max reduction does.
    """
    fmt = FORMATS[fmt] if isinstance(fmt, str) else fmt
    flat = x.to(torch.float32).reshape(-1, block_size)
    amax = _flush(flat.abs().amax(dim=1))
    one = torch.ones_like(amax)
    if fmt.name == "fp4":
        return torch.where(amax > 0, _recip(amax), one)
    p2f = _float(_bits(amax) & 0x7F800000)
    scale = _flush(2.0 * p2f / fmt.block_headroom)
    return torch.where(amax > 0, scale, one)


def qdq_plain(x: torch.Tensor, fmt_name: str, mode: RoundMode = RoundMode.RNE,
              scale=1.0, daz: bool = False,
              random_bits: Optional[torch.Tensor] = None,
              salt: Optional[int] = None, block_size: int = 0, block=None):
    """The plain version of the cast kernel, with its arguments: ``scale``
    broadcastable to ``x`` (ignored when ``block_size`` > 0 selects
    per-block scales), SR bits from ``random_bits`` or hashed from
    ``salt`` (with ``block``, a ``parallel.data.Block``, at each element's
    global index in the tensor ``x`` is a block of).  Runs on any device;
    float32 result of ``x``'s shape."""
    n = x.numel()
    pad = (-n) % block_size if block_size else 0
    if block is not None:
        if block_size or salt is None:
            raise ValueError("a block takes SR bits hashed from a salt, "
                             "and no per-block scales")
        random_bits = sr_bits_from_salt(
            salt, n, x.device, block.index(x.shape, x.device)).reshape(
            x.shape)
        salt = None
    if salt is not None:
        random_bits = sr_bits_from_salt(salt, n + pad, x.device)
    elif random_bits is not None and block_size:
        random_bits = torch.nn.functional.pad(
            random_bits.reshape(-1).to(torch.int64), (0, pad))
    if not block_size:
        if salt is not None:
            random_bits = random_bits[:n].reshape(x.shape)
        return cast_array(x, scale, random_bits, fmt_name, mode, daz)
    flat = torch.nn.functional.pad(x.reshape(-1).to(torch.float32), (0, pad))
    scales = block_scales(flat, block_size, fmt_name)[:, None]
    flat = flat.reshape(-1, block_size)
    if random_bits is not None:
        random_bits = random_bits.reshape(flat.shape)
    out = cast_array(flat, scales, random_bits, fmt_name, mode, daz)
    return out.reshape(-1)[:n].reshape(x.shape)


def _qdq(x, fmt_name, mode, scale, daz, key, random_bits, block_size=0,
         offset=0, block=None):
    if block is not None:
        off = block.contiguous_offset(x.shape)
        if off is not None:       # one range: the salt at its offset
            block, offset = None, off
    if (SR_BITS_IMPL == "threefry" and mode == RoundMode.STOCHASTIC
            and random_bits is None and key is not None):
        # no kernel hashes threefry: the bits are drawn here
        random_bits = sr_bits(key, x.shape, x.device, offset, block)
    salt = _salt_for(mode, key, random_bits, offset)
    if salt is None:
        block = None
    if x.is_cuda:
        from fp8tpu_torch.kernels.cast_kernel import cuda_qdq
        return cuda_qdq(x, fmt_name, mode, scale, daz, random_bits, salt,
                        block_size, block)
    return qdq_plain(x, fmt_name, mode, scale, daz, random_bits, salt,
                     block_size, block)


def qdq(
    x: torch.Tensor,
    fmt: FPFormat | str,
    mode: RoundMode = RoundMode.RNE,
    scale=1.0,
    daz: bool = False,
    key: Optional[PRNGKey] = None,
    random_bits: Optional[torch.Tensor] = None,
    offset: int = 0,
    block=None,
) -> torch.Tensor:
    """Quantize-dequantize ``x`` onto the ``fmt`` value grid.

    ``scale`` is a scalar or a tensor broadcastable to ``x``.  Stochastic
    rounding needs ``key`` or integer ``random_bits`` (uint16 values)
    shaped like ``x``; ``offset`` takes ``key``'s bits from that element of
    its stream on (``x`` a piece of a larger tensor), ``block`` (a
    ``parallel.data.Block``) each element's at its global index (``x`` a
    block of a larger tensor: a column block, a sequence chunk).  Returns
    float32 of ``x``'s shape: the plain pipeline on the CPU, the cast
    kernel on a CUDA device (its block route for a block that is not one
    range).
    """
    fmt_name = fmt if isinstance(fmt, str) else fmt.name
    return _qdq(x, fmt_name, mode, scale, daz, key, random_bits,
                offset=offset, block=block)


def qdq_mode_string(
    x: torch.Tensor,
    mode: str,
    scale=1.0,
    key: Optional[PRNGKey] = None,
    random_bits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mode-string entry point (``E5M2_DAZ_RNE`` …; plus
    ``E5M2_NOINF_RNE`` / ``E5M2_FLEX_RNE`` and ``E4M3_V2_<mode>``)."""
    ml = mode.lower()
    if ml in ("e5m2_noinf_rne", "e5m2_flex_rne"):
        return qdq(x, ml[:-4], RoundMode.RNE, scale)
    if ml.startswith("e4m3_v2_"):
        rmode = RoundMode[ml[len("e4m3_v2_"):].upper()]
        return qdq(x, "e4m3_v2", rmode, scale, False, key, random_bits)
    fmt, rmode, daz = parse_mode_string(mode)
    return qdq(x, fmt, rmode, scale, daz, key, random_bits)


def qdq_blocked(
    x: torch.Tensor,
    fmt: FPFormat | str,
    mode: RoundMode = RoundMode.RNE,
    block_size: int = 128,
    daz: bool = False,
    key: Optional[PRNGKey] = None,
    random_bits: Optional[torch.Tensor] = None,
    offset: int = 0,
) -> torch.Tensor:
    """Block-normalized fake-quant: per-block power-of-two scales over the
    flattened tensor (zero-padded to a multiple of ``block_size``).
    ``offset``: ``x`` is the elements ``offset ..`` of a larger tensor
    whose blocks it holds whole (SR bits from there on)."""
    fmt_name = fmt if isinstance(fmt, str) else fmt.name
    return _qdq(x, fmt_name, mode, 1.0, daz, key, random_bits, block_size,
                offset)
