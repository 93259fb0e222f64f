"""Quantization configuration objects.

The equivalent of the reference's config objects (qutils.py:22-214):
hashable frozen dataclasses, with the same expressive surface — per-tensor-role formats,
rounding schemes, and a scaling mini-grammar — but no mutable global
state: enabling/disabling quantization is expressed by deriving a new
config (`dataclasses.replace`), not by flag mutation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from fp8tpu_torch.numerics.formats import FORMATS, RoundMode

FP_DTYPES = ("e5m2", "e4m3", "e4m3_ieee", "e3m4", "fp4", "bfloat16",
             "float16")
INT_DTYPES = ("int8", "int4")
SCALINGS = ("none", "per-tensor", "per-channel", "fine-grained", "per-block")

# Valid (dtype → schemes) matrix, mirroring qutils.py:42-98.
_VALID_SCHEMES = {
    "e5m2": {"rtz", "stochastic", "rne", "rnaz", "rntz", "rpinf", "rninf",
             "daz_stochastic", "daz_rne", "daz_rnaz", "daz_rntz"},
    "e4m3": {"rne", "stochastic"},
    "e4m3_ieee": {"rne", "stochastic"},
    "e3m4": {"rne", "stochastic"},
    "fp4": {"nearest"},
    "bfloat16": {"rne", "stochastic"},
    "float16": {"rne", "stochastic", "daz_rne"},
    "int8": {"rne"},
    "int4": {"rne"},
}


def _parse_scaling(scaling: str) -> Tuple[str, str]:
    """Parse the reference's scaling strings — 'per-tensor',
    'per-tensor-mean', 'per-channel', 'fine-grained', 'per-block', 'none'
    (qutils.py:29-38) — into (granularity, method)."""
    if scaling in (None, "none", "None"):
        return "none", "max"
    parts = scaling.split("-")
    method = "mean" if "mean" in parts else "max"
    if "tensor" in parts:
        return "per-tensor", method
    if "channel" in parts:
        return "per-channel", method
    if scaling.startswith("fine-grained"):
        return "fine-grained", method
    if "block" in parts:
        return "per-block", method
    raise ValueError(f"unknown scaling spec {scaling!r}")


@dataclasses.dataclass(frozen=True)
class TensorQuantConfig:
    """What to do to one tensor role (reference qutils.py:22-134).

    ``dtype``   format name, or int8/int4.
    ``scheme``  rounding scheme string (may carry a ``daz_`` prefix).
    ``scaling`` granularity spec; accepts the reference grammar
                ('per-tensor-mean', 'fine-grained', …).
    """

    dtype: str
    scheme: str = "rne"
    scaling: str = "none"
    group_size: int = 1
    block_size: int = 128
    channel_axis: int = 0
    # Cast implementation: "bitexact" replicates the reference's via-fp16
    # pipeline bit-for-bit (including its denormal-range quirks); "hw"
    # uses the spec-exact single-rounding hardware convert (clip +
    # native fp8/bf16/fp16 convert — ~3 HLO ops instead of ~100, an
    # order-of-magnitude compile-time saver for training graphs).  "hw"
    # silently falls back to bitexact for formats/modes without a
    # hardware path (e3m4, fp4, e4m3_ieee, DAZ, non-RNE rounding).
    cast_impl: str = "bitexact"

    def __post_init__(self):
        if self.cast_impl not in ("bitexact", "hw"):
            raise ValueError(f"invalid cast_impl {self.cast_impl!r}")
        if self.dtype not in FP_DTYPES + INT_DTYPES:
            raise ValueError(f"invalid dtype {self.dtype!r}")
        scheme = self.scheme
        if self.dtype in INT_DTYPES:
            scheme = "rne"
        if scheme not in _VALID_SCHEMES[self.dtype]:
            raise ValueError(
                f"scheme {self.scheme!r} invalid for {self.dtype}: "
                f"choose from {sorted(_VALID_SCHEMES[self.dtype])}"
            )
        granularity, method = _parse_scaling(self.scaling)
        object.__setattr__(self, "scaling", granularity)
        object.__setattr__(self, "_method", method)

    # -- derived views -------------------------------------------------
    @property
    def method(self) -> str:
        return self._method  # type: ignore[attr-defined]

    @property
    def is_int(self) -> bool:
        return self.dtype in INT_DTYPES

    @property
    def bits(self) -> int:
        return int(self.dtype[3:]) if self.is_int else 8

    @property
    def daz(self) -> bool:
        return self.scheme.startswith("daz_")

    @property
    def round_mode(self) -> RoundMode:
        s = self.scheme[4:] if self.daz else self.scheme
        return RoundMode(s)

    @property
    def is_stochastic(self) -> bool:
        return not self.is_int and self.round_mode == RoundMode.STOCHASTIC

    @property
    def fmt(self):
        return FORMATS[self.dtype]

    def get_flt_max(self) -> float:
        return FORMATS[self.dtype].max_normal

    def get_flt_min(self) -> float:
        return FORMATS[self.dtype].min_subnormal

    def mode_string(self) -> str:
        """Reference-ABI mode string, e.g. E5M2_DAZ_RNE."""
        return f"{self.dtype}_{self.scheme}".upper()

    def __repr__(self):
        return (f"[{self.mode_string()}, scaling: {self.scaling}, "
                f"method: {self.method}]")


# Tensor roles a module exposes (qutils.py:137-156): weights, input/output
# activations, and the three gradient streams.
ROLES = ("wt", "iact", "oact", "wtgrad", "igrad", "ograd")


@dataclasses.dataclass(frozen=True)
class ModuleQuantConfig:
    """Per-module policy: one optional TensorQuantConfig per role, plus
    execution options (reference qutils.py:137-198)."""

    wt: Optional[TensorQuantConfig] = None
    iact: Optional[TensorQuantConfig] = None
    oact: Optional[TensorQuantConfig] = None
    wtgrad: Optional[TensorQuantConfig] = None
    igrad: Optional[TensorQuantConfig] = None
    ograd: Optional[TensorQuantConfig] = None
    # Use the fused fake-quant GEMM engine for this module's contractions
    # (the reference's hw_patch C-model, qutils.py:478-509).
    patch_ops: bool = False
    # Collect tensor statistics / bindump telemetry for this module.
    tensor_stats: bool = False
    bindump: bool = False

    def role(self, name: str) -> Optional[TensorQuantConfig]:
        return getattr(self, name)

    def replace(self, **kw) -> "ModuleQuantConfig":
        return dataclasses.replace(self, **kw)

    def without_roles(self, *names: str) -> "ModuleQuantConfig":
        return dataclasses.replace(self, **{n: None for n in names})

    def __repr__(self):
        parts = [f"{r}: {self.role(r)}" for r in ROLES if self.role(r)]
        return "ModuleQuantConfig(" + ", ".join(parts) + ")"
