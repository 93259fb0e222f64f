"""Single-entry fake-quantization with a straight-through gradient.

``fake_quant`` computes the scale its config asks for and casts, in one
call; on a CUDA tensor the cast is one launch of the cast kernel (K1).
The backward pass is straight-through: gradient-stream quantization is
applied explicitly per the igrad/ograd/wtgrad role configs.
"""

from __future__ import annotations

from typing import Optional

import torch

from fp8tpu_torch.numerics import cast as _cast
from fp8tpu_torch.numerics import integer as _integer
from fp8tpu_torch.numerics import scaling as _scaling
from fp8tpu_torch.numerics.formats import FORMATS
from fp8tpu_torch.numerics.prng import PRNGKey

from .config import TensorQuantConfig


def _hw_eligible(cfg: TensorQuantConfig) -> bool:
    return (cfg.cast_impl == "hw" and cfg.dtype in _cast.HW_DTYPES
            and cfg.scheme in ("rne", "stochastic")
            and cfg.scaling != "per-block")


def _scale(x: torch.Tensor, cfg: TensorQuantConfig):
    fmt = FORMATS[cfg.dtype]
    if cfg.scaling == "none":
        return 1.0
    if cfg.scaling == "per-tensor":
        return _scaling.per_tensor(x, fmt, cfg.method)
    if cfg.scaling == "per-channel":
        return _scaling.per_channel(x, fmt, cfg.method, cfg.channel_axis)
    if cfg.scaling == "fine-grained":
        return _scaling.fine_grained(x, fmt, cfg.group_size, cfg.method)
    raise ValueError(f"unknown scaling {cfg.scaling!r}")


def _quantize_impl(x: torch.Tensor, cfg: TensorQuantConfig,
                   key: Optional[PRNGKey]) -> torch.Tensor:
    if cfg.is_int:
        return _integer.qdq_int(x, bits=cfg.bits)
    if cfg.is_stochastic and key is None:
        raise ValueError(f"{cfg.mode_string()} needs a PRNG key for "
                         "stochastic rounding")
    if _hw_eligible(cfg):
        scale = _scale(x, cfg)
        if cfg.scheme == "stochastic":
            return _cast.hw_sr(x, cfg.dtype, scale, None)
        return _cast.hw_qdq(x, cfg.dtype, scale)
    fmt = FORMATS[cfg.dtype]
    key = key if cfg.is_stochastic else None
    if cfg.scaling == "per-block":
        return _cast.qdq_blocked(x, fmt, cfg.round_mode, cfg.block_size,
                                 cfg.daz, key=key)
    return _cast.qdq(x, fmt, cfg.round_mode, _scale(x, cfg), cfg.daz,
                     key=key)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, key):
        return _quantize_impl(x, cfg, key).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x: torch.Tensor, cfg: TensorQuantConfig,
               key: Optional[PRNGKey] = None) -> torch.Tensor:
    """Fake-quantize ``x`` per ``cfg``; straight-through gradient.  Output
    dtype equals input dtype (fp8-grid values are exact in bf16 and f32
    alike)."""
    return _FakeQuant.apply(x, cfg, key)


class _FixedScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, scale, key):
        if cfg.is_int:
            s, zp = scale
            return _integer.qdq_int_with_qparams(x, s, zp,
                                                 bits=cfg.bits).to(x.dtype)
        return _cast.qdq(x, FORMATS[cfg.dtype], cfg.round_mode, scale,
                         cfg.daz, key=key if cfg.is_stochastic else None
                         ).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant_with_scale(x: torch.Tensor, cfg: TensorQuantConfig, scale,
                          key: Optional[PRNGKey] = None) -> torch.Tensor:
    """Fake-quantize with an externally calibrated scale (for int configs,
    ``scale`` is the (scale, zero_point) pair).  Straight-through
    gradient."""
    return _FixedScale.apply(x, cfg, scale, key)


def quantize_grad(g: torch.Tensor, cfg: Optional[TensorQuantConfig],
                  key: Optional[PRNGKey] = None) -> torch.Tensor:
    """Quantize a gradient stream; no-op when ``cfg`` is None."""
    if cfg is None:
        return g
    return _quantize_impl(g, cfg, key)
