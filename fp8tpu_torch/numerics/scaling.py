"""Scale computation for fake-quantization (the scaling mini-grammar).

  per-tensor  "max":  scale = flt_max / max|x|, clamped to 6.55e4 when the
                      raw scale exceeds 3.275e4 (covers max|x| == 0 too),
                      never above the range-exact scale.
  per-tensor  "mean": scale = flt_min / mean|x| (mean floored to flt_min
                      when ≤ 1e-5), clamped to ≥ 1.
  per-channel:        the same formulas per slice of ``axis``.
  fine-grained:       per (dim-0 × dim-1 group) scales.
  per-block:          power-of-two block scales (cast.block_scales).

Axes are those of the tensor passed in.  The JAX package states weight
axes in Flax layouts (HWIO, (in, out)); callers holding torch layouts map
the tensor to the Flax layout first (see quant.interceptor.quantize_params),
so the scales land on the same elements.

Returns float32 scales broadcastable against ``x``.  "mean" sums in
torch's reduction order, which can differ from XLA's in the last bit.
Divisions keep a tensor numerator: torch computes ``scalar / tensor`` as
a reciprocal times the scalar, two roundings where XLA has one.
"""

from __future__ import annotations

import torch

from .formats import FORMATS, FPFormat

_SCALE_CLAMP_THRESHOLD = 3.275e4
_SCALE_CLAMP_VALUE = 6.55e4
_MEAN_EPS_TENSOR = 1e-5
_MEAN_EPS_CHANNEL = 1e-6


def _fmt(fmt) -> FPFormat:
    return FORMATS[fmt] if isinstance(fmt, str) else fmt


def _max_scale(vmax: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    scale = torch.full_like(vmax, fmt.max_normal) / vmax
    # The reference clamps any raw scale above 3.275e4 UP to 6.55e4; for
    # e5m2 that can push finite values past 57344.  Keep the clamp's intent
    # (pull tiny tensors into fp16's normal range) but never exceed the
    # range-exact scale.
    return torch.where(scale > _SCALE_CLAMP_THRESHOLD,
                       torch.clamp(scale, max=_SCALE_CLAMP_VALUE), scale)


def _mean_scale(mean: torch.Tensor, fmt: FPFormat, eps: float):
    mean = torch.where(mean > eps, mean,
                       torch.full_like(mean, fmt.min_subnormal))
    scale = torch.full_like(mean, fmt.min_subnormal) / mean
    return torch.clamp(scale, min=1.0)


def per_tensor(x: torch.Tensor, fmt, method: str = "max") -> torch.Tensor:
    fmt = _fmt(fmt)
    xf = x.to(torch.float32)
    if method == "max":
        # max|x| in one reduction (NaN-propagating, like amax of abs)
        return _max_scale(torch.linalg.vector_norm(xf, float("inf")), fmt)
    if method == "mean":
        return _mean_scale(xf.abs().mean(), fmt, _MEAN_EPS_TENSOR)
    raise ValueError(f"unknown scaling method {method!r}")


def per_channel(x: torch.Tensor, fmt, method: str = "max",
                axis: int = 0) -> torch.Tensor:
    """One scale per slice of ``axis``, shaped for broadcasting."""
    fmt = _fmt(fmt)
    axis = axis % x.ndim
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    ax = x.to(torch.float32).abs()
    if method == "max":
        scale = _max_scale(ax.amax(dim=reduce_axes), fmt)
    elif method == "mean":
        scale = _mean_scale(ax.mean(dim=reduce_axes), fmt, _MEAN_EPS_CHANNEL)
    else:
        raise ValueError(f"unknown scaling method {method!r}")
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return scale.reshape(shape)


def fine_grained(x: torch.Tensor, fmt, group_size: int,
                 method: str = "max") -> torch.Tensor:
    """Per (dim-0, dim-1 group) scales for a tensor of shape (K, C, ...);
    ``C`` must divide by ``group_size``."""
    fmt = _fmt(fmt)
    if x.ndim < 2:
        raise ValueError("fine-grained scaling needs ndim >= 2")
    k, c = x.shape[0], x.shape[1]
    if c % group_size != 0:
        raise ValueError(f"input channels {c} not divisible by group size "
                         f"{group_size}")
    grouped = x.to(torch.float32).reshape(k, c // group_size, group_size,
                                          -1).abs()
    if method == "max":
        scale = _max_scale(grouped.amax(dim=(2, 3)), fmt)
    elif method == "mean":
        scale = _mean_scale(grouped.mean(dim=(2, 3)), fmt, _MEAN_EPS_CHANNEL)
    else:
        raise ValueError(f"unknown scaling method {method!r}")
    scale = torch.repeat_interleave(scale, group_size, dim=1)
    return scale.reshape((k, c) + (1,) * (x.ndim - 2))
