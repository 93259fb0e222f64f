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

A NaN's bits are made explicitly where torch's own depend on the tensor:
an f32 block's amax is the largest magnitude's bits (a NaN above inf),
``max(amax, 1e-30)`` keeps the amax's NaN (torch's vectorised
``maximum`` returns 0xFFFFFFFF, its scalar loop the operand), and an fp8
NaN code dequantizes to XLA's NaN, 0x7FC00000 with the code's sign
(torch's convert gives 0x7FF00000).  The 8-bit AdamW kernel
(``kernels/csrc/adam8.cu``) takes the same bits.
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
    """``max(amax, 1e-30) / grid_max`` in f32, as XLA computes it (a NaN
    amax kept as it is)."""
    a = _flush(amax)
    floor = torch.full_like(a, 1e-30)
    return _div(torch.where(torch.isnan(a), a, torch.maximum(a, floor)),
                torch.full_like(a, GRID_MAX[fmt]))


def _absmax(x: torch.Tensor) -> torch.Tensor:
    """Each block's largest |x|; of f32 blocks as the largest magnitude's
    bits (exact, and the NaN with the largest payload where there is
    one)."""
    if x.dtype != torch.float32:
        return x.abs().amax(dim=-1)
    return (x.view(torch.int32) & 0x7FFFFFFF).amax(dim=-1).view(
        torch.float32)


def quant_blocks(x: torch.Tensor, fmt: str):
    """Quantize ``x`` (..., block) against per-block absmax scales.

    Returns ``(payload, scales)``: the payload in the target dtype, the
    scales f32 of shape ``x.shape[:-1]`` with ``x ~ payload * scales[...,
    None]``.  ``fmt`` is one of "int8", "e4m3", "e5m2" and "bf16"; bf16 is
    the identity payload with unit scales.
    """
    amax = _absmax(x)
    if fmt == "bf16":
        return x.to(torch.bfloat16), torch.ones_like(amax,
                                                     dtype=torch.float32)
    scale = block_scale(amax.to(torch.float32), fmt)
    return quant_given(x, scale[..., None], fmt), scale


def quant_given(x: torch.Tensor, scale: torch.Tensor, fmt: str):
    """The payload of ``x`` against ``scale`` (broadcastable to it, given:
    a block's scale reduced over the ranks that hold its elements):
    :func:`quant_blocks`' divide, clip and convert for "int8", "e4m3" and
    "e5m2"."""
    gmax = GRID_MAX[fmt]
    y = torch.clamp(_div(x.to(torch.float32), scale), -gmax, gmax)
    if fmt == "int8":
        return torch.round(y).to(torch.int8)
    return _fp8(y, fmt)


def dequant_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quant_blocks` (f32); an fp8 NaN code gives XLA's
    NaN."""
    x = q.to(torch.float32)
    if q.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        nan = torch.tensor([0x7FC00000, -0x00400000], dtype=torch.int32)
        nan = nan.view(torch.float32).to(x.device)
        x = torch.where(torch.isnan(x), torch.where(torch.signbit(x),
                                                    nan[1], nan[0]), x)
    return _flush(x * _flush(scale)[..., None])
