"""Per-block absmax quantization of stored payloads: the port of
``fp8tpu/numerics/blockquant.py``.

One helper for the per-block absmax -> scale -> clip -> cast pattern of
payloads that are stored quantized (the 8-bit optimizer's moments,
``training/opt8.py``), not fake-quantized in place.  It is also the plain
version of the requant step of the 8-bit AdamW kernel
(``kernels/adam8.py``, P3).

Convention: ``scale = max(absmax, 1e-30) / grid_max``, so a zero block
dequantizes to exact zeros through a tiny positive scale.

The arithmetic is XLA's, step for step: the amax, a correctly rounded
divide by the grid maximum (never a multiply by its reciprocal), the
clip before the convert (an fp8 convert of an out-of-range value differs
between torch and XLA), ``torch.round`` (half to even, as ``jnp.round``)
for int8, and f32 subnormals flushed where XLA flushes them (DAZ on
every input of a float op, FTZ on its result).
"""

from __future__ import annotations

import torch

from .cast import _flush

WIRE_DTYPES = {
    "e4m3": torch.float8_e4m3fn,
    "e5m2": torch.float8_e5m2,
    "bf16": torch.bfloat16,
}
GRID_MAX = {"e4m3": 448.0, "e5m2": 57344.0, "int8": 127.0}


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a / b`` under DAZ/FTZ, one correctly rounded divide."""
    return _flush(_flush(a) / _flush(b))


def _fp8(y: torch.Tensor, fmt: str) -> torch.Tensor:
    """Clipped f32 to fp8 storage; a NaN gets the code XLA's convert writes
    (e5m2 keeps the sign and the quiet bit, 0x7E / 0xFE, where torch writes
    0x7F / 0xFF; e4m3 has one NaN code a sign)."""
    payload = y.to(WIRE_DTYPES[fmt])
    if fmt != "e5m2":
        return payload
    nan = torch.where(torch.signbit(y), 0xFE, 0x7E).to(torch.uint8)
    return torch.where(torch.isnan(y), nan,
                       payload.view(torch.uint8)).view(WIRE_DTYPES[fmt])


def block_scale(amax: torch.Tensor, fmt: str) -> torch.Tensor:
    """``max(amax, 1e-30) / grid_max`` in f32, as XLA computes it."""
    floor = torch.full_like(amax, 1e-30)
    return _div(torch.maximum(_flush(amax), floor),
                torch.full_like(amax, GRID_MAX[fmt]))


def quant_blocks(x: torch.Tensor, fmt: str):
    """Quantize ``x`` (..., block) against per-block absmax scales.

    Returns ``(payload, scales)``: the payload in the target dtype, the
    scales f32 of shape ``x.shape[:-1]`` with ``x ~ payload * scales[...,
    None]``.  ``fmt`` is one of "int8", "e4m3", "e5m2" and "bf16"; bf16 is
    the identity payload with unit scales.
    """
    amax = x.abs().amax(dim=-1)
    if fmt == "bf16":
        return x.to(torch.bfloat16), torch.ones_like(amax,
                                                     dtype=torch.float32)
    xf = x.to(torch.float32)
    gmax = GRID_MAX[fmt]
    scale = block_scale(amax.to(torch.float32), fmt)
    y = torch.clamp(_div(xf, scale[..., None]), -gmax, gmax)
    if fmt == "int8":
        return torch.round(y).to(torch.int8), scale
    return _fp8(y, fmt), scale


def dequant_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quant_blocks` (f32)."""
    return _flush(q.to(torch.float32) * _flush(scale)[..., None])
