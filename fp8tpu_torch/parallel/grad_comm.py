"""Quantized-payload gradient all-reduce (fp8 / int8 on the wire), the
counterpart of ``fp8tpu/parallel/grad_comm.py``, over a process group.

The flat gradient is cut into one chunk per rank.  Phase 1 quantizes
every chunk once against per-block absmax scales (``numerics.blockquant``)
and ``all_to_all_single`` delivers chunk ``j`` to rank ``j``, which
dequantizes the N payloads and sums them in f32, in rank order.  Phase 2
requantizes the reduced chunk once and a flat all-gather gives
every rank every chunk.  Two quantizations an element, whatever N; the
wire carries one byte an element a phase (plus an f32 scale a block)
against four for an f32 all-reduce.

Payloads travel as their bytes (uint8 views): gloo's ``all_to_all``
refuses ``float8_e4m3fn`` tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from fp8tpu_torch.numerics.blockquant import dequant_blocks, quant_blocks

from .mesh import gather_rows


def _wire(q: torch.Tensor) -> torch.Tensor:
    return q.contiguous().view(torch.uint8)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def wire_all_reduce(x: torch.Tensor, group=None, fmt: Optional[str] = "e4m3",
                    mean: bool = False, block: int = 512) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` with quantized wire payloads.

    ``fmt`` is one of "e4m3", "e5m2", "int8", "bf16" and None; None is an
    exact f32 ``all_reduce``.  ``block`` is the per-scale granularity, so
    gradients of different layers raveled together keep their own range.
    Accumulation is f32 on every rank; the result (the same bits on every
    rank) has ``x``'s shape and floating dtype (f32 for an integer ``x``).
    """
    n = dist.get_world_size(group)
    if fmt is None:
        out = x.to(torch.float32).clone()
        dist.all_reduce(out, group=group)
        if mean:
            out = out / torch.full_like(out, n)
        return out.to(x.dtype)

    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    size = flat.shape[0]
    csz = -(-size // n)            # elements per destination chunk
    nb = -(-csz // block)          # blocks per chunk
    csz = nb * block
    flat = torch.nn.functional.pad(flat, (0, n * csz - size))
    blocks = flat.reshape(n, nb, block)

    # Phase 1: quantize once per block, all_to_all, f32 sum in rank order.
    # bf16 has no scales to move (they are all ones).
    scaled = fmt != "bf16"
    q, s = quant_blocks(blocks, fmt)
    q = _all_to_all(_wire(q), group).view(q.dtype)
    s = _all_to_all(s, group) if scaled else s
    parts = dequant_blocks(q, s)                     # (n, nb, block) f32
    reduced = parts[0]
    for j in range(1, n):
        reduced = reduced + parts[j]
    if mean:
        reduced = reduced / torch.full_like(reduced, n)

    # Phase 2: requantize the reduced chunk once, quantized all_gather.
    qr, sr = quant_blocks(reduced, fmt)
    qg = gather_rows(_wire(qr), group).view(qr.dtype)  # (n*nb, block)
    sg = (gather_rows(sr, group) if scaled
          else torch.ones(qg.shape[0], dtype=torch.float32,
                          device=qg.device))
    out = dequant_blocks(qg, sg).reshape(-1)[:size]
    out_dtype = orig_dtype if orig_dtype.is_floating_point else torch.float32
    return out.reshape(orig_shape).to(out_dtype)


def wire_all_reduce_tree(tree, group=None, fmt: Optional[str] = "e4m3",
                         mean: bool = False, block: int = 512):
    """:func:`wire_all_reduce` over a dict (nested or flat) of tensors.

    Every leaf is raveled into ONE f32 vector first (``jax.flatten_util.
    ravel_pytree``'s order: keys sorted at every level), so the sync is one
    all_to_all and one all_gather a call, with each leaf's own blocks
    keeping its range.  Leaves come back in their shapes and dtypes."""
    leaves = []

    def walk(t, keys):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], keys + (k,))
            else:
                leaves.append((keys + (k,), t[k]))

    walk(tree, ())
    if not leaves:
        return tree
    flat = torch.cat([v.to(torch.float32).reshape(-1) for _, v in leaves])
    red = wire_all_reduce(flat, group, fmt=fmt, mean=mean, block=block)
    out: dict = {}
    at = 0
    for keys, v in leaves:
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = red[at:at + v.numel()].reshape(v.shape).to(v.dtype)
        at += v.numel()
    return out


def wire_bytes_per_element(fmt: Optional[str], n_devices: int,
                           block: int = 512) -> float:
    """Network bytes moved per gradient element for one all-reduce
    (both phases), for the scaling projection."""
    width = {None: 4.0, "bf16": 2.0, "e4m3": 1.0, "e5m2": 1.0,
             "int8": 1.0}[fmt]
    frac = (n_devices - 1) / n_devices
    scale_overhead = 0.0 if fmt in (None, "bf16") else 4.0 / block
    return 2.0 * frac * (width + scale_overhead)
