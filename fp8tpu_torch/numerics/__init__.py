"""Number formats and the plain torch cast pipeline."""

from .cast import (
    block_scales,
    cast_array,
    f16_bits_to_f32,
    f32_to_f16_bits,
    qdq,
    qdq_blocked,
    qdq_mode_string,
    sr_bits,
)
from .formats import (
    BFLOAT16,
    E3M4,
    E4M3,
    E4M3_IEEE,
    E5M2,
    FLOAT16,
    FORMATS,
    FP4,
    FP8_FORMATS,
    FPFormat,
    RoundMode,
    mode_string,
    parse_mode_string,
)

__all__ = [
    "BFLOAT16", "E3M4", "E4M3", "E4M3_IEEE", "E5M2", "FLOAT16", "FORMATS",
    "FP4", "FP8_FORMATS", "FPFormat", "RoundMode", "block_scales", "cast_array",
    "f16_bits_to_f32", "f32_to_f16_bits", "mode_string", "parse_mode_string",
    "qdq", "qdq_blocked", "qdq_mode_string", "sr_bits",
]
