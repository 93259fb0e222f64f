"""ScaleShift: BatchNorm folded to a per-channel affine.

Before PTQ, BatchNorm layers become ``y = x * scale + shift`` with
scale/shift folded from the BN statistics, which makes the normalisation a
quantizable affine op.  Models use :class:`SwitchableNorm` (BatchNorm, or
ScaleShift after folding) and :func:`fold_batchnorm` rewrites a state_dict
for the model built with ``norm_mode="scale_shift"``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from fp8tpu_torch.linen import BatchNorm, Module


class ScaleShift(Module):
    """y = x * scale + shift, per channel (dim 1)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.shift = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * self.scale.reshape(shape) + self.shift.reshape(shape)


class SwitchableNorm(Module):
    """BatchNorm (``mode="bn"``, child ``bn``) that can be folded into a
    ScaleShift affine (``mode="scale_shift"``, child ``ss``)."""

    def __init__(self, features: int, mode: str = "bn",
                 momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.mode = mode
        if mode == "scale_shift":
            self.ss = ScaleShift(features)
        elif mode == "bn":
            self.bn = BatchNorm(features, momentum, epsilon)
        else:
            raise ValueError(f"unknown norm mode {mode!r}")

    def forward(self, x):
        return self.ss(x) if self.mode == "scale_shift" else self.bn(x)


def fold_bn_stats(gamma, beta, mean, var, eps: float = 1e-5):
    """scale = γ/√(σ²+ε), shift = β − μ·scale.  Computed on the CPU with a
    correctly rounded sqrt and divide (torch's CUDA sqrt and rsqrt are not
    correctly rounded), so the folded model is the same on every device."""
    device = gamma.device
    gamma, beta, mean, var = (t.cpu() for t in (gamma, beta, mean, var))
    v = var + eps
    scale = gamma * (torch.ones_like(v) / torch.sqrt(v))
    return scale.to(device), (beta - mean * scale).to(device)


def fold_batchnorm(state_dict: Dict[str, torch.Tensor],
                   eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Fold every SwitchableNorm's ``bn.*`` entries into ``ss.scale`` and
    ``ss.shift``; returns the state_dict of the model instantiated with
    ``norm_mode="scale_shift"`` (running statistics dropped)."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        if name.endswith("bn.weight"):
            pre = name[:-len("bn.weight")]
            out[pre + "ss.scale"], out[pre + "ss.shift"] = fold_bn_stats(
                value, state_dict[pre + "bn.bias"],
                state_dict[pre + "bn.running_mean"],
                state_dict[pre + "bn.running_var"], eps)
        elif ".bn." not in "." + name:
            out[name] = value
    return out
