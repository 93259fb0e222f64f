"""INT8/INT4 affine min-max fake-quantization.

Asymmetric per-tensor affine quantization with zero-point, round, clamp,
dequantize; plus qparams from observed min/max for calibrated inference.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch


def _qrange(bits: int):
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def qdq_int(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Asymmetric min-max fake-quant, per tensor."""
    xf = x.to(torch.float32)
    q_min, q_max = _qrange(bits)
    min_val, max_val = xf.amin(), xf.amax()
    scale = (max_val - min_val) / (q_max - q_min)
    # Guard the degenerate constant-tensor case.
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    zero_point = q_min - (min_val / scale)
    q = torch.clamp(torch.round(xf / scale + zero_point), q_min, q_max)
    return (scale * (q - zero_point)).to(torch.float32)


def qdq_int_with_qparams(x: torch.Tensor, scale, zero_point,
                         bits: int = 8) -> torch.Tensor:
    """Fake-quant with precomputed qparams (calibrated inference path)."""
    q_min, q_max = _qrange(bits)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale + zero_point),
                    q_min, q_max)
    return (scale * (q - zero_point)).to(torch.float32)


def int_qparams(min_val, max_val, bits: int = 8, symmetric: bool = False):
    """(scale, zero_point) from observed min/max."""
    q_min, q_max = _qrange(bits)
    min_val = torch.clamp(torch.as_tensor(min_val, dtype=torch.float32),
                          max=0.0)
    max_val = torch.clamp(torch.as_tensor(max_val, dtype=torch.float32),
                          min=0.0)
    if symmetric:
        amax = torch.maximum(min_val.abs(), max_val.abs())
        scale = amax / ((q_max - q_min) / 2)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        zero_point = torch.zeros_like(scale)
    else:
        scale = (max_val - min_val) / (q_max - q_min)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        zero_point = torch.clamp(q_min - torch.round(min_val / scale),
                                 q_min, q_max)
    return scale, zero_point
