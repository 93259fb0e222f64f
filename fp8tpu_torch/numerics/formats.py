"""Floating-point format descriptors for every low-precision format the port
supports: E5M2 (+DAZ variants), E4M3, E4M3-IEEE, E3M4, FP4, BFLOAT16 and
FLOAT16.

Each FP8 format is described at the value-grid level (bias, max,
min-subnormal) and at the fp16-domain cast level: FP32→FP8 is emulated by
converting to IEEE fp16 and rounding/truncating the 16-bit pattern.  The
plain torch cast (:mod:`fp8tpu_torch.numerics.cast`) and the CUDA cast
pipeline (``kernels/csrc/cast.cuh``) share the constants in this table.

Data and small pure helpers only; a copy of ``fp8tpu.numerics.formats``
so the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class RoundMode(enum.Enum):
    """Rounding modes (mode-string suffixes)."""

    RNE = "rne"                  # round to nearest, ties to even
    STOCHASTIC = "stochastic"    # stochastic rounding (random bits below grid)
    RNAZ = "rnaz"                # round to nearest, ties away from zero
    RNTZ = "rntz"                # round to nearest, ties toward zero
    RPINF = "rpinf"              # round toward +inf
    RNINF = "rninf"              # round toward -inf
    RTZ = "rtz"                  # truncate (round toward zero)
    NEAREST = "nearest"          # FP4 power-of-two nearest


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """One low-precision floating-point format.

    Value-grid fields describe the format itself; the ``cast_*`` fields
    parameterize the via-fp16 cast pipeline shared by all FP8 formats.
    """

    name: str
    exp_bits: int
    mant_bits: int
    bias: int
    max_normal: float
    min_subnormal: float
    has_inf: bool              # E5M2 keeps fp16 inf/nan; E4M3/E3M4 saturate

    # Number of fp16 mantissa bits dropped; rounding happens at bit
    # ``cast_lshift`` of the fp16 mantissa.
    cast_lshift: int
    cast_grs_mask: int         # guard/round/sticky mask on the fp16 mantissa
    cast_tie_mask: int         # RNE tie pattern mask
    # E5M2 rounds the raw fp16 word; the rebias family (E4M3/E3M4) decomposes
    # into sign/exp/mant and applies saturate/flush/denorm first.
    cast_rebias: bool
    cast_can_round_limit: int  # threshold on (h & 0x7FFF) (or h & 0x7F00 for E5M2)
    cast_exp_sat: Optional[int] = None    # saturation unbiased exponent
    cast_sat_mant: Optional[int] = None   # saturated fp16 mantissa pattern
    cast_flush_exp: Optional[int] = None  # flush-to-zero below this exponent
    cast_min_norm_exp: Optional[int] = None  # denorm handling below this exponent
    # Per-block scaling headroom divisor:
    # scale = 2 * 2^floor(log2(absmax)) / headroom.
    block_headroom: float = 1.0

    @property
    def rounding_half(self) -> int:
        """Half-ULP threshold within the GRS bits (e.g. 0x80 for E5M2)."""
        return 1 << (self.cast_lshift - 1)

    @property
    def mant_trunc_mask(self) -> int:
        """fp16-word mask that truncates dropped mantissa bits."""
        return (0xFFFF << self.cast_lshift) & 0xFFFF

    def valid_round_modes(self) -> tuple:
        if self.name == "e5m2":
            return (
                RoundMode.RTZ, RoundMode.STOCHASTIC, RoundMode.RNE,
                RoundMode.RNAZ, RoundMode.RNTZ, RoundMode.RPINF,
                RoundMode.RNINF,
            )
        if self.name in ("e4m3", "e4m3_ieee", "e3m4", "bfloat16", "float16"):
            return (RoundMode.RNE, RoundMode.STOCHASTIC)
        if self.name == "fp4":
            return (RoundMode.NEAREST,)
        return ()


E5M2 = FPFormat(
    name="e5m2", exp_bits=5, mant_bits=2, bias=15,
    max_normal=57344.0, min_subnormal=2.0 ** -16, has_inf=True,
    cast_lshift=8, cast_grs_mask=0x00FF, cast_tie_mask=0x0180,
    cast_rebias=False, cast_can_round_limit=0x7B00,
    block_headroom=16384.0,
)

E4M3 = FPFormat(
    name="e4m3", exp_bits=4, mant_bits=3, bias=7,
    max_normal=448.0, min_subnormal=2.0 ** -9, has_inf=False,
    cast_lshift=7, cast_grs_mask=0x007F, cast_tie_mask=0x00C0,
    cast_rebias=True, cast_can_round_limit=0x5F00,
    cast_exp_sat=8, cast_sat_mant=0x0300,
    cast_flush_exp=-9, cast_min_norm_exp=-6,
    block_headroom=8.0,
)

E4M3_IEEE = FPFormat(
    name="e4m3_ieee", exp_bits=4, mant_bits=3, bias=7,
    max_normal=240.0, min_subnormal=2.0 ** -9, has_inf=True,
    cast_lshift=7, cast_grs_mask=0x007F, cast_tie_mask=0x00C0,
    cast_rebias=True, cast_can_round_limit=0x5B80,
    cast_exp_sat=7, cast_sat_mant=0x0380,
    cast_flush_exp=-9, cast_min_norm_exp=-6,
    block_headroom=8.0,
)

E3M4 = FPFormat(
    name="e3m4", exp_bits=3, mant_bits=4, bias=3,
    max_normal=30.0, min_subnormal=2.0 ** -6, has_inf=False,
    cast_lshift=6, cast_grs_mask=0x003F, cast_tie_mask=0x0060,
    cast_rebias=True, cast_can_round_limit=0x4F80,
    cast_exp_sat=4, cast_sat_mant=0x0380,
    cast_flush_exp=-6, cast_min_norm_exp=-2,
    block_headroom=1.0,
)

# FP4 / BF16 / FP16 do not use the via-fp16 GRS pipeline; their cast fields
# are placeholders so the policy layer can treat formats uniformly.
FP4 = FPFormat(
    name="fp4", exp_bits=3, mant_bits=0, bias=0,
    max_normal=1.0, min_subnormal=2.0 ** -12, has_inf=False,
    cast_lshift=0, cast_grs_mask=0, cast_tie_mask=0,
    cast_rebias=False, cast_can_round_limit=0,
)

BFLOAT16 = FPFormat(
    name="bfloat16", exp_bits=8, mant_bits=7, bias=127,
    max_normal=3.3895314e38, min_subnormal=9.184e-41, has_inf=True,
    cast_lshift=16, cast_grs_mask=0x0000FFFF, cast_tie_mask=0x00018000,
    cast_rebias=False, cast_can_round_limit=0,
)

FLOAT16 = FPFormat(
    name="float16", exp_bits=5, mant_bits=10, bias=15,
    max_normal=65504.0, min_subnormal=2.0 ** -24, has_inf=True,
    cast_lshift=13, cast_grs_mask=0x00001FFF, cast_tie_mask=0x00003000,
    cast_rebias=False, cast_can_round_limit=0,
)

FORMATS = {
    f.name: f for f in (E5M2, E4M3, E4M3_IEEE, E3M4, FP4, BFLOAT16, FLOAT16)
}

# Formats that run through the via-fp16 GRS cast pipeline.
FP8_FORMATS = ("e5m2", "e4m3", "e4m3_ieee", "e3m4")

_PREFIXES = (
    ("e5m2_daz_", E5M2, True), ("e5m2_", E5M2, False),
    ("e4m3_ieee_", E4M3_IEEE, False), ("e4m3_", E4M3, False),
    ("e3m4_", E3M4, False), ("fp4_", FP4, False),
    ("bfloat16_", BFLOAT16, False),
    ("float16_daz_", FLOAT16, True), ("float16_", FLOAT16, False),
)


def parse_mode_string(mode: str):
    """Parse a mode string like ``E4M3_RNE`` or ``E5M2_DAZ_STOCHASTIC``
    into (format, round_mode, daz).  INT8/INT4 are handled by
    :mod:`fp8tpu_torch.numerics.integer`."""
    m = mode.lower()
    for prefix, fmt, daz in _PREFIXES:
        if m.startswith(prefix):
            return fmt, RoundMode(m[len(prefix):]), daz
    raise ValueError(f"unknown cast mode string: {mode!r}")


def mode_string(fmt: FPFormat, mode: RoundMode, daz: bool = False) -> str:
    """Inverse of :func:`parse_mode_string`."""
    if daz:
        return f"{fmt.name}_daz_{mode.value}".upper()
    return f"{fmt.name}_{mode.value}".upper()
