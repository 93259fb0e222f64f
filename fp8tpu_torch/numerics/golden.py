"""Bit-exact NumPy golden model of every cast the framework implements.

A copy of the JAX package's ``numerics/golden.py`` (NumPy only) that reads
the port's own format table, so the port never imports the JAX package.
It is the framework-free reference that the plain torch cast
(:mod:`fp8tpu_torch.numerics.cast`), the cast kernel K1 and the native
twin (:mod:`fp8tpu_torch.numerics.native_ref`) are held against.  It
re-implements, vectorized in NumPy, the semantics of the reference
toolkit's native cast libraries (mpemu's ``pytquant/cpp/fpemu_impl.cpp``;
its CUDA/HIP files implement the identical bit pipeline):

    y = fp16_rne(scale * x)                # IEEE fp32→fp16, round-nearest-even
    y = grs_round_and_truncate(y.bits)     # per-format bit manipulation
    out = fp32(y) * (1 / scale)

Deliberate deviations from the reference, all documented where they occur:

* Stochastic rounding consumes caller-provided random bits instead of the
  reference's 16 mutable xoroshiro128+ seed states (fpemu_impl.cpp:41-88) —
  the reference PRNG stream is not part of the numerics contract, and a
  counter-based stream is required for reproducibility.  Given identical
  random bits, results are bit-exact across golden / plain torch / kernel
  implementations.
* Everything else — including reference quirks such as E4M3 saturating
  fp16 inf/NaN to ±448, the E4M3-IEEE can_round threshold at 15.0, and the
  denormal shift-then-round-at-fixed-position behavior — is replicated
  bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from .formats import (
    E4M3,
    E4M3_IEEE,
    E5M2,
    E3M4,
    FP4,
    BFLOAT16,
    FLOAT16,
    FPFormat,
    RoundMode,
    parse_mode_string,
)

_NEAREST_MODES = {
    RoundMode.RNE, RoundMode.RNAZ, RoundMode.RNTZ,
    RoundMode.RPINF, RoundMode.RNINF, RoundMode.RTZ,
}


def _to_f16_bits(x: np.ndarray, scale) -> np.ndarray:
    """fp32 → fp16 (RNE) → uint16 bit pattern, as int32 for arithmetic."""
    with np.errstate(over="ignore"):  # overflow to fp16 inf is intended
        h = (np.asarray(x, np.float32) * np.float32(scale)).astype(np.float16)
    return h.view(np.uint16).astype(np.int32)


def _from_f16_bits(u: np.ndarray, inv_scale) -> np.ndarray:
    return (
        u.astype(np.uint16).view(np.float16).astype(np.float32)
        * np.float32(inv_scale)
    )


def _nearest_increment(
    mode: RoundMode,
    rnmask: np.ndarray,
    rntie: np.ndarray,
    positive: np.ndarray,
    fmt: FPFormat,
) -> np.ndarray:
    """Mantissa increment selector for the deterministic rounding modes.

    Mirrors the mask arithmetic of cvt_fp32_e5m2_scalar
    (fpemu_impl.cpp:744-756) parameterized by format.
    """
    half = fmt.rounding_half
    up = np.zeros(rnmask.shape, np.int32)
    if mode == RoundMode.RNE:
        up = ((rnmask > half) | (rntie == fmt.cast_tie_mask)).astype(np.int32)
    elif mode == RoundMode.RNAZ:
        up = (rnmask >= half).astype(np.int32)
    elif mode == RoundMode.RNTZ:
        up = (rnmask > half).astype(np.int32)
    elif mode == RoundMode.RPINF:
        up = (positive & (rnmask >= half)).astype(np.int32)
    elif mode == RoundMode.RNINF:
        up = ((~positive) & (rnmask >= half)).astype(np.int32)
    elif mode == RoundMode.RTZ:
        up = np.zeros(rnmask.shape, np.int32)
    else:
        raise ValueError(f"not a nearest mode: {mode}")
    return up << fmt.cast_lshift


def cast_e5m2(
    x: np.ndarray,
    mode: RoundMode = RoundMode.RNE,
    scale: float = 1.0,
    daz: bool = False,
    random_bits: np.ndarray | None = None,
) -> np.ndarray:
    """E5M2 fake-quant (fpemu_impl.cpp:691-763; DAZ variant 846-919)."""
    fmt = E5M2
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
        assert random_bits is not None, "stochastic rounding needs random bits"
        rand = random_bits.astype(np.int32) & fmt.cast_grs_mask
        if daz:
            # DAZ SR rounds normals only; denormals are flushed below
            # (fpemu_impl.cpp:891-899, 915-917).
            incr = rand
        else:
            # SR for normals, RNE for fp16 denormals (fpemu_impl.cpp:736-742).
            incr = np.where(is_normal, rand, 0) + np.where(
                is_denorm, rne_incr, 0
            )
    else:
        incr = _nearest_increment(mode, rnmask, rntie, positive, fmt)

    apply = (~is_naninf) & can_round
    if daz:
        apply = apply & is_normal
    h = np.where(apply, h + incr, h)
    if daz:
        h = np.where(is_denorm, 0, h)
    h = h & fmt.mant_trunc_mask
    return _from_f16_bits(h, 1.0 / np.float32(scale))


def cast_e5m2_noinf(x: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """E5M2 "noINF" variant (fpemu_impl.cpp:460-535): exponent offset 16
    with the inf/NaN codes reclaimed as ordinary values.

    Bit-faithful to the reference intrinsics, including their quirks:
    the e5m2 payload is built in fp16 bits with exponent field +1
    (bias 16), RNE-rounded to the 2-bit mantissa with carries allowed to
    ripple through the exponent INTO the sign (so +65504-class fp16
    values wrap to the 0x80 "inf" code → +inf, and their negatives wrap
    to byte 0x00 → +0); every input NaN/±inf maps to the single
    reclaimed code, which decodes as +inf (signs lost); decode of a
    0x00..0x03 byte with the -1 exponent field yields the 0xFC00-family
    patterns (-inf/-NaN) — replicated as-is.  RNE only (the reference
    implements no other rounding for this variant) and never reachable
    from its own mode-string dispatch (fpemu_impl.cpp:1866-2009); it is
    exposed here as mode string ``E5M2_NOINF_RNE`` for L0 parity."""
    h = _to_f16_bits(x, scale)
    naninf = (h & 0x7C00) == 0x7C00
    tie = ((h & 0x0100) == 0x0100).astype(np.int32)
    # encode: exponent field + 1 (offset-16 bias), sign+mantissa kept
    enc = ((((h & 0x7C00) >> 10) + 1) << 10) | (h & 0x83FF)
    enc = np.where(~naninf, enc + 0x7F + tie, enc) & 0xFFFF
    # reference "saturation" mask — unreachable for finite fp16 inputs
    # (compares the bias-15 pattern against a NaN-range constant), kept
    # for bit parity
    sat = (h & 0x7FFF) > 0x7F00
    enc = np.where(sat, (enc & 0x8000) | 0x7F00, enc)
    enc = np.where(naninf, 0x8000, enc)
    byte = (enc >> 8) & 0xFF
    # decode (fpemu_impl.cpp:496-510): 0x80 is the reclaimed inf code
    d = (byte << 8) & 0xFFFF
    dexp = (((((d & 0x7C00) >> 10) - 1) << 10)) & 0xFFFF
    out = (dexp | (d & 0x83FF)) & 0xFFFF
    out = np.where(d == 0x8000, 0x7C00, out)
    return _from_f16_bits(out, 1.0 / np.float32(scale))


def cast_e5m2_flex(x: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """E5M2 "flex"-denormal variant (fpemu_impl.cpp:537-593): a single
    f32-domain rounding (no via-fp16 double round) with flexible
    subnormal handling — RNE-add on the f32 pattern keeping 2 mantissa
    bits, denormal range (|x| < 2^-14) mantissa truncated on the shifted
    grid WITHOUT re-adding the implicit leading bit, flush below 2^-16.

    Bit-faithful quirks preserved: the ``scale`` argument exists in the
    reference's signature but is never applied in its body (replicated);
    there is no overflow saturation (the commented-out ovflow mask) — an
    exponent >= 16 wraps into the fp16 inf/NaN field; exp == -16 inputs
    survive the flush test and build a -1 exponent field (inf-family
    patterns).  RNE only; unreachable from the reference's mode-string
    dispatch; exposed as ``E5M2_FLEX_RNE``."""
    del scale  # the reference intrinsic takes but never uses it
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.int64)
    expf = u & 0x7F800000
    naninf = expf == 0x7F800000
    tie = ((u & 0x00200000) == 0x00200000).astype(np.int64)
    zflush = expf < 0x37800000                 # |x| < 2^-16
    denorm = expf < 0x38800000                 # |x| < 2^-14
    sign = u & 0x80000000
    urne = np.where(~naninf, u + 0xFFFFF + tie, u)
    exp = ((urne & 0x7F800000) >> 23) - 127
    mant = urne & 0x7FFFFF
    shft = -15 - exp
    rshft = np.where(denorm, 21 + shft, 21)
    lshft = np.where(denorm, 8 + shft, 8)
    # AVX512 variable shifts yield 0 for counts >= 32; numpy needs them
    # clipped (the result is already 0 whenever the clip engages)
    mant2 = np.where(rshft < 24,
                     (mant >> np.clip(rshft, 0, 63))
                     << np.clip(lshft, 0, 63), 0)
    out = (mant2 | (((exp + 15) << 10) & 0xFFFF)
           | np.where(sign != 0, 0x8000, 0)) & 0xFFFF
    out = np.where(zflush, 0, out)
    return _from_f16_bits(out.astype(np.int32), np.float32(1.0))


def _cast_rebias(
    x: np.ndarray,
    fmt: FPFormat,
    mode: RoundMode,
    scale: float,
    random_bits: np.ndarray | None,
) -> np.ndarray:
    """Shared E4M3 / E4M3-IEEE / E3M4 pipeline (fpemu_impl.cpp:1038-1133,
    1330-1427, 1623-1717): decompose fp16, saturate / flush / pre-truncate
    denormals, GRS-round, recompose."""
    h = _to_f16_bits(x, scale)

    exp = ((h >> 10) & 0x1F) - 15
    sign = h & 0x8000
    mant = h & 0x03FF

    can_round = (h & 0x7FFF) < fmt.cast_can_round_limit
    is_denorm = (h & 0x7C00) == 0
    is_naninf = (h & 0x7C00) == 0x7C00
    positive = sign == 0

    # Saturate (note: fp16 inf/NaN also saturate to ±max — reference quirk).
    sat = (exp > fmt.cast_exp_sat) | (~can_round)
    mant = np.where(sat, fmt.cast_sat_mant, mant)
    exp = np.where(sat, fmt.cast_exp_sat, exp)
    can_round = can_round & (~sat)

    # Flush below the subnormal range.
    flush = (~sat) & (exp < fmt.cast_flush_exp)
    mant = np.where(flush, 0, mant)
    exp = np.where(flush, -15, exp)

    # Denormal range: zero out sub-representable low bits before rounding.
    dn = (~sat) & (~flush) & (exp < fmt.cast_min_norm_exp)
    dshift = np.where(dn, fmt.cast_min_norm_exp - exp, 0)
    mant = np.where(dn, (mant >> dshift) << dshift, mant)

    rnmask = mant & fmt.cast_grs_mask
    rntie = mant & fmt.cast_tie_mask
    rne_incr = _nearest_increment(RoundMode.RNE, rnmask, rntie, positive, fmt)

    if mode == RoundMode.STOCHASTIC:
        assert random_bits is not None, "stochastic rounding needs random bits"
        rand = random_bits.astype(np.int32) & fmt.cast_grs_mask
        is_normal = ((h & 0x7C00) <= 0x7800) & ((h & 0x7C00) >= 0x0400)
        incr = np.where(is_normal, rand, 0) + np.where(is_denorm, rne_incr, 0)
    else:
        incr = _nearest_increment(mode, rnmask, rntie, positive, fmt)

    mant = np.where((~is_naninf) & can_round, mant + incr, mant)

    # Truncate and recompose; mantissa carry into the exponent is intended.
    mant = mant & fmt.mant_trunc_mask
    out = (mant + ((exp + 15) << 10)) | sign
    return _from_f16_bits(out, 1.0 / np.float32(scale))


def cast_e4m3(x, mode=RoundMode.RNE, scale=1.0, random_bits=None):
    return _cast_rebias(x, E4M3, mode, scale, random_bits)


def cast_e4m3_ieee(x, mode=RoundMode.RNE, scale=1.0, random_bits=None):
    return _cast_rebias(x, E4M3_IEEE, mode, scale, random_bits)


def cast_e3m4(x, mode=RoundMode.RNE, scale=1.0, random_bits=None):
    return _cast_rebias(x, E3M4, mode, scale, random_bits)


def cast_e4m3_v2(x, mode=RoundMode.RNE, scale=1.0, random_bits=None):
    """E4M3 "v2" variant (CUDA-only ``E4M3v2_Kernel``,
    fpemu_kernels.cu:770-875): a unit-interval E4M3 experiment that
    keeps the raw fp16 exponent (no rebias, no flush, no denormal
    pre-truncation), truncates to 3 mantissa bits, and hard-saturates
    every ``|fp16(x*scale)| >= 1.0`` — fp16 inf/NaN included — to
    ±0.9375 (exponent field 14, mantissa 0x380).

    Dead code in the reference: the kernel is never instantiated (no
    ``E4M3v2_Kernel<<<...>>>`` launch exists and no mode string reaches
    it from ``fpemu_cuda_forward``); implemented for L0-surface
    completeness and exposed as ``E4M3_V2_<mode>`` from
    :func:`cast_mode_string`, like the out-of-ABI E5M2 noINF/flex
    variants.

    Bit-faithful quirks preserved: a value just below 1.0 can ROUND to
    exactly 1.0 (the saturation check precedes rounding, and the
    rounding carry ripples into the exponent field); stochastic
    rounding adds 7 random bits for fp16 normals and falls back to RNE
    for fp16 denormals; deterministic modes round denormals on the
    same GRS window as normals (no normal gate)."""
    fmt = E4M3  # shares E4M3's GRS geometry: lshift 7, grs 0x7F, tie 0xC0
    h = _to_f16_bits(x, scale)
    exp = ((h >> 10) & 0x1F) - 15
    sign = h & 0x8000
    mant = h & 0x03FF
    can_round = (h & 0x7FFF) < 0x4B80          # |fp16| < 15.0
    exp_field = h & 0x7C00
    is_normal = (exp_field <= 0x7800) & (exp_field >= 0x0400)
    is_denorm = exp_field == 0
    is_naninf = exp_field == 0x7C00
    positive = sign == 0

    sat = exp > -1                              # |x| >= 1.0 (inf/NaN too)
    mant = np.where(sat, 0x0380, mant)
    exp = np.where(sat, -1, exp)
    can_round = can_round & ~sat

    rnmask = mant & fmt.cast_grs_mask
    rntie = mant & fmt.cast_tie_mask
    if mode == RoundMode.STOCHASTIC:
        assert random_bits is not None, "stochastic rounding needs random bits"
        rne_incr = _nearest_increment(RoundMode.RNE, rnmask, rntie,
                                      positive, fmt)
        rand = random_bits.astype(np.int32) & fmt.cast_grs_mask
        incr = np.where(is_normal, rand, 0) + np.where(is_denorm, rne_incr, 0)
    else:
        incr = _nearest_increment(mode, rnmask, rntie, positive, fmt)
    mant = np.where(can_round & ~is_naninf, mant + incr, mant)
    mant = mant & 0xFF80                        # (0xFFFF << 7), carry kept
    out = (mant + ((exp + 15) << 10)) | sign
    return _from_f16_bits(out, 1.0 / np.float32(scale))


def cast_bfloat16(
    x: np.ndarray,
    mode: RoundMode = RoundMode.RNE,
    random_bits: np.ndarray | None = None,
) -> np.ndarray:
    """BF16 fake-quant on fp32 bits, modeling the reference's AVX512
    production path (cvt_fp32_bf16_rne_intrinsic, fpemu_impl.cpp:207-231):
    true round-to-nearest-even via the 0x7FFF + lsb bias add over the
    FULL 16 discarded bits, NaN/Inf passed through unchanged.

    Reference defects deliberately NOT modeled (found by tools/diffref.py,
    documented in DIFFREF.json):
      * its scalar tail (fpemu_impl.cpp:284-329, runs for the size%16
        remainder) rounds on a 4-bit GRS window that ignores sticky bits
        0-12, so the reference binary disagrees with itself between the
        vector body and the tail;
      * its vector SR path adds BOTH the 16 random bits and the RNE bias
        (0x7FFF+fixup, fpemu_impl.cpp:268-279) — an up-biased "SR" unlike
        its own scalar SR; we add the random bits only (unbiased)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.int64)
    naninf = (u & 0x7F800000) == 0x7F800000
    if mode == RoundMode.STOCHASTIC:
        assert random_bits is not None
        incr = random_bits.astype(np.int64) & 0xFFFF
    else:
        incr = 0x7FFF + ((u >> 16) & 1)
    u = np.where(naninf, u, u + incr)
    u = u & 0xFFFF0000
    return (u & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def cast_float16(
    x: np.ndarray,
    mode: RoundMode = RoundMode.RNE,
    daz: bool = False,
    random_bits: np.ndarray | None = None,
) -> np.ndarray:
    """FP16 fake-quant (fpemu_impl.cpp:356-423).

    RNE: IEEE fp32→fp16→fp32 round trip, with optional DAZ flushing fp16
    denormals.  Stochastic: add 13 random bits below the fp16 mantissa in
    the fp32 domain (the reference leaves fp16-denormal results RNE-rounded;
    replicated).
    """
    xf = np.asarray(x, np.float32)
    if mode == RoundMode.RNE:
        with np.errstate(over="ignore"):  # overflow to fp16 inf is intended
            h = xf.astype(np.float16)
        if daz:
            bits = h.view(np.uint16)
            is_denorm = (bits & 0x7C00) == 0
            bits = np.where(is_denorm, 0, bits)
            h = bits.view(np.float16)
        return h.astype(np.float32)

    assert mode == RoundMode.STOCHASTIC and random_bits is not None
    u = xf.view(np.uint32).astype(np.int64)
    exp = ((u >> 23) & 0xFF) - 127
    mant = u & 0x7FFFFF
    sign = u & 0x80000000

    # inf/NaN passthrough (signalling NaN quietened).
    nan_mant = np.where((mant != 0) & ((mant & 0x400000) == 0),
                        mant | 0x400000, mant)
    h_naninf = ((0x1F << 23) | nan_mant | (sign >> 3)) >> 13
    # Saturate |x| >= 2^16 to inf.
    h_inf = ((0x1F << 23) | (sign >> 3)) >> 13
    # Normal range: add 13 random bits below the kept mantissa.
    rb = random_bits.astype(np.int64) & 0x1FFF
    h_norm = ((((exp + 15) << 23) | mant | (sign >> 3)) + rb) >> 13
    # fp16-denormal range: reference intends SR but overwrites with RNE.
    with np.errstate(over="ignore"):
        h_denorm = xf.astype(np.float16).view(np.uint16).astype(np.int64)

    h = np.where(
        exp == 128, h_naninf,
        np.where(exp >= 16, h_inf, np.where(exp < -14, h_denorm, h_norm)),
    )
    return (h & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)


def cast_fp4(x: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """FP4 nearest power-of-two cast (fpemu_impl.cpp:1797-1824): grid is
    ± even powers of two in [2^-12, 1], with a ×1.6 probe deciding whether
    an odd-exponent value rounds up to the next even power."""
    f = np.asarray(x, np.float32) * np.float32(scale)
    u = f.view(np.uint32).astype(np.int64)
    exp = ((u >> 23) & 0xFF) - 127
    sign = u & 0x80000000

    odd_neg = (exp < 0) & (exp % 2 != 0)
    f2 = np.where(odd_neg, f * np.float32(1.6), f)
    u2 = f2.astype(np.float32).view(np.uint32).astype(np.int64)
    # Saturate positives of exponent > 0 to ±1.0.
    u2 = np.where(exp > 0, sign | (127 << 23), u2)
    u2 = u2 & 0xFF800000
    exp2 = ((u2 >> 23) & 0xFF) - 127
    # Round-up failed: drop to the next even power below.
    odd2 = (exp2 < 0) & (exp2 % 2 != 0)
    u2 = np.where(odd2, sign | ((exp2 + 126) << 23), u2)
    # Flush uses the pre-adjustment exponent (fpemu_impl.cpp:1818-1821).
    u2 = np.where(exp2 < -12, 0, u2)
    out = (u2 & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    return out * (np.float32(1.0) / np.float32(scale))


def block_scales(x: np.ndarray, block_size: int, fmt: FPFormat) -> np.ndarray:
    """Per-block scales for block-normalized casting: flatten, split into
    ``block_size`` blocks, scale = 2·2^⌊log2(absmax)⌋ / headroom
    (fpemu_impl.cpp:794-799 E5M2, 1166-1171 E4M3; FP4 uses 1/absmax)."""
    flat = np.asarray(x, np.float32).reshape(-1)
    n = flat.shape[0]
    nblocks = (n + block_size - 1) // block_size
    scales = np.ones((nblocks,), np.float32)
    for b in range(nblocks):
        blk = flat[b * block_size:(b + 1) * block_size]
        amax = np.max(np.abs(blk))
        if fmt.name == "fp4":
            scales[b] = 1.0 / amax if amax > 0 else 1.0
        elif amax == 0.0:
            # Deviation: the reference computes scale 0 for an all-zero
            # block and dequantizes with 1/0 = inf (NaN output); we use 1.
            scales[b] = 1.0
        else:
            bits = np.asarray(amax, np.float32).view(np.uint32)
            p2 = np.asarray(bits & np.uint32(0x7F800000), np.uint32)
            scales[b] = 2.0 * p2.view(np.float32) / fmt.block_headroom
    return scales


def cast_blocked(
    x: np.ndarray,
    fmt: FPFormat,
    mode: RoundMode,
    block_size: int,
    daz: bool = False,
    random_bits: np.ndarray | None = None,
) -> np.ndarray:
    """Block-normalized cast: per-block absmax scale, then the per-format
    cast with that scale (E5M2_Kernel block path, fpemu_impl.cpp:783-817)."""
    flat = np.asarray(x, np.float32).reshape(-1)
    scales = block_scales(flat, block_size, fmt)
    out = np.empty_like(flat)
    for b in range(scales.shape[0]):
        sl = slice(b * block_size, (b + 1) * block_size)
        rb = None if random_bits is None else random_bits.reshape(-1)[sl]
        out[sl] = cast(flat[sl], fmt, mode, scale=float(scales[b]), daz=daz,
                       random_bits=rb)
    return out.reshape(np.asarray(x).shape)


def cast(
    x: np.ndarray,
    fmt: FPFormat,
    mode: RoundMode = RoundMode.RNE,
    scale: float = 1.0,
    daz: bool = False,
    random_bits: np.ndarray | None = None,
) -> np.ndarray:
    """Dispatch to the per-format golden cast."""
    if fmt.name == "e5m2":
        return cast_e5m2(x, mode, scale, daz, random_bits)
    if fmt.name == "e4m3":
        return cast_e4m3(x, mode, scale, random_bits)
    if fmt.name == "e4m3_ieee":
        return cast_e4m3_ieee(x, mode, scale, random_bits)
    if fmt.name == "e3m4":
        return cast_e3m4(x, mode, scale, random_bits)
    if fmt.name == "fp4":
        return cast_fp4(x, scale)
    if fmt.name == "bfloat16":
        return cast_bfloat16(x, mode, random_bits)
    if fmt.name == "float16":
        return cast_float16(x, mode, daz, random_bits)
    raise ValueError(f"unknown format {fmt.name}")


def cast_mode_string(
    x: np.ndarray,
    mode: str,
    scale: float = 1.0,
    random_bits: np.ndarray | None = None,
    block_norm: bool = False,
    block_size: int = 1,
) -> np.ndarray:
    """Reference-ABI entry point taking mode strings like ``E4M3_RNE``
    (fpemu_forward, fpemu_impl.cpp:2013-2028).  ``E5M2_NOINF_RNE`` /
    ``E5M2_FLEX_RNE`` name the reference's out-of-ABI L0 variants
    (fpemu_impl.cpp:460-593); ``E4M3_V2_<mode>`` names the dead
    CUDA-only E4M3v2_Kernel (fpemu_kernels.cu:770-875)."""
    ml = mode.lower()
    if ml == "e5m2_noinf_rne":
        return cast_e5m2_noinf(x, scale)
    if ml == "e5m2_flex_rne":
        return cast_e5m2_flex(x, scale)
    if ml.startswith("e4m3_v2_"):
        rmode = RoundMode[ml[len("e4m3_v2_"):].upper()]
        return cast_e4m3_v2(x, rmode, scale, random_bits)
    fmt, rmode, daz = parse_mode_string(mode)
    # ABI guard: the reference SILENTLY disables block_norm when the
    # tensor size is not a multiple of block_size (fpemu_forward,
    # fpemu_impl.cpp:2013-2028) — replicated for bit parity.
    if block_norm and block_size != np.asarray(x).size:
        if np.asarray(x).size % block_size:
            block_norm, block_size = False, 1
    if block_norm:
        return cast_blocked(x, fmt, rmode, block_size, daz, random_bits)
    return cast(x, fmt, rmode, scale, daz, random_bits)
