"""Adaptive sparsity: learned per-output-channel pruning thresholds, the
port of the JAX package's ``sparse/adaptive.py``.

A straight-through binary weight mask with the piecewise surrogate gradient
of WeightMaskStep (mpemu's adasparse.py:17-32), learned thresholds per
output channel, and the degenerate-mask reset (if at most 1% of the
weights survive, the threshold counts as 0 for that step; functional, in
place of the reference's in-place parameter reset, adasparse.py:63-70).

The layers keep the port's layouts, as :class:`fp8tpu_torch.linen.Dense`
and :class:`~fp8tpu_torch.linen.Conv` do: ``weight`` (out, in) and OIHW,
NCHW activations, output channels on axis 0 of the weight.  Their
parameters are named ``weight`` / ``threshold`` / ``bias``, so
``models.variables_from_flax`` carries the JAX layers' ``kernel`` /
``threshold`` / ``bias`` across.  Neither subclasses ``Dense`` or
``Conv``: the interceptor classifies both as ``LayerKind.OTHER`` and casts
nothing, as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fp8tpu_torch import linen
from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.numerics.cast import _flush


class _WeightMaskStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (_flush(x) > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        ax = x.abs()
        # adasparse.py:24-31: 2 - 4|x| near zero, 0.4 in the mid band, 0
        # outside.
        inner = _flush(2.0 - _flush(4.0 * ax))
        window = torch.where(
            ax > 1.0, torch.zeros((), dtype=x.dtype, device=x.device),
            torch.where(ax > 0.4, torch.full((), 0.4, dtype=x.dtype,
                                             device=x.device), inner))
        return _flush(g * window)


def weight_mask_step(x: torch.Tensor) -> torch.Tensor:
    """Heaviside forward; piecewise-window surrogate backward."""
    return _WeightMaskStep.apply(x)


def _masked_weight(w: torch.Tensor, threshold: torch.Tensor,
                   channel_axis: int = 0) -> torch.Tensor:
    """Apply the learned-threshold mask; a degenerate mask (at most 1%
    survivors) falls back to threshold 0 (adasparse.py:63-70).  Decided
    on the device, with no host read."""
    shape = [1] * w.ndim
    shape[channel_axis] = w.shape[channel_axis]
    mask = weight_mask_step(w.abs() - threshold.reshape(shape))
    size = torch.tensor(float(mask.numel()), dtype=mask.dtype,
                        device=mask.device)
    ratio = mask.sum() / size
    mask0 = weight_mask_step(w.abs())
    return w * torch.where(ratio <= 0.01, mask0, mask)


class SparseLinear(linen.Module):
    """Dense layer with learned-threshold weight sparsity
    (adasparse.py:34-82): ``y = x @ (weight * mask).T + bias``."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.weight = nn.Parameter(torch.empty(features, in_features))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_features))
        self.threshold = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        wm = _masked_weight(self.weight, self.threshold, channel_axis=0)
        with full_fp32():
            return F.linear(x, wm, self.bias)


class SparseConv(linen.Module):
    """Conv layer with learned per-output-channel threshold sparsity
    (adasparse.py:84-161), on NCHW inputs with an OIHW ``weight`` and
    Flax's padding specs."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding="SAME",
                 use_bias: bool = True):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        fan_in = in_features * math.prod(self.kernel_size)
        self.weight = nn.Parameter(
            torch.empty(features, in_features, *self.kernel_size))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(fan_in))
        self.threshold = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        wm = _masked_weight(self.weight, self.threshold, channel_axis=0)
        (pt, pb), (pl, pr) = linen.conv_padding(
            self.padding, x.shape[-2:], self.kernel_size, self.strides)
        with full_fp32():
            return F.conv2d(F.pad(x, (pl, pr, pt, pb)), wm, self.bias,
                            self.strides)
