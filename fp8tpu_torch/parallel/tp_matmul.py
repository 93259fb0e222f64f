"""Tensor-parallel quantized matmuls with overlapped collectives, the
counterpart of ``fp8tpu/parallel/tp_matmul.py``.

Megatron's pair: a column-parallel up-projection (no collective) feeding a
row-parallel down-projection whose partial products are summed over the
mesh's ``model`` group.  The row-parallel contraction is cut along its
output columns, and each chunk's ``all_reduce`` (or ``reduce_scatter``) is
issued, asynchronously, as soon as that chunk's product is queued, so the
collective of chunk i runs while chunk i+1 is computed.

Every function takes and returns this rank's shard (the body of the JAX
package's ``shard_map``).  Weights are fp8 payloads with per-output-column
scales (``kernels.qmatmul.quantize_weights``); payloads shard, scales shard
with their channel axis.  The local product is JAX's ``_dequant_dot``:
``x @ w8`` accumulated in f32, times the column scale.  For bf16 ``x`` on
the card that is one launch of K3 (``kernels.qmatmul.dequant_matmul``); f32
``x`` contracts in IEEE f32 (K3 would round it to bf16).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.kernels.qmatmul import dequant_matmul

from .mesh import Mesh, gather_rows, reduce_scatter_flat


def _dequant_dot(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor,
                 out_dtype) -> torch.Tensor:
    """``(x @ w8) * s`` with an f32 sum and one rounding to ``out_dtype``."""
    if x.dtype == torch.bfloat16:
        return dequant_matmul(x, w8, s, out_dtype=out_dtype)
    with full_fp32():
        out = torch.matmul(x, w8.to(x.dtype))
    return (out.to(torch.float32) * s.reshape(-1).to(torch.float32)).to(
        out_dtype)


def column_parallel_qmatmul(x: torch.Tensor, w8: torch.Tensor,
                            scales: torch.Tensor, mesh: Mesh,
                            axis: str = "model") -> torch.Tensor:
    """Megatron column-parallel: ``y = x @ dequant(w8)`` with the output
    columns sharded over ``axis``.  x (B, K) replicated, w8 (K, N/T) and
    scales (N/T,) this rank's columns; returns this rank's (B, N/T) in x's
    dtype.  No collective (the paired row-parallel matmul carries the
    sum)."""
    del mesh, axis
    return _dequant_dot(x, w8, scales, x.dtype)


def _tiles_to_natural(local: torch.Tensor, group, t: int, chunks: int):
    """The (B, N) product in its natural column order from every rank's
    reduce-scattered tiles: rank r holds ``[chunk c, tile r]`` for each c,
    so the gathered order is [rank, chunk, inner]; the natural one is
    [chunk, rank, inner]."""
    b, w = local.shape
    out = gather_rows(local, group).reshape(t, b, chunks, w // chunks)
    return out.permute(1, 2, 0, 3).reshape(b, t * w)


def chunk_columns(w8: torch.Tensor, chunks: int) -> torch.Tensor:
    """A row-parallel weight laid out by column chunk: (K/T, N) ->
    (chunks, K/T, N/chunks), contiguous, so that each chunk's product reads
    its weight as it lies.  Done once for a weight that is reused; a (K/T,
    N) weight given to :func:`row_parallel_qmatmul` is laid out this way at
    every call."""
    k, n = w8.shape
    if n % chunks:
        raise ValueError(f"N={n} is not a multiple of {chunks} chunks")
    return w8.reshape(k, chunks, n // chunks).permute(1, 0, 2).contiguous()


def row_parallel_qmatmul(x: torch.Tensor, w8: torch.Tensor,
                         scales: torch.Tensor, mesh: Mesh,
                         axis: str = "model", overlap_chunks: int = 4,
                         scatter: bool = False) -> torch.Tensor:
    """Megatron row-parallel with an overlapped reduction.

    x (B, K/T) and w8 (K/T, N) are this rank's rows of the contraction
    (w8 may come as :func:`chunk_columns` ``(w8, overlap_chunks)``, which
    saves a copy of it a call); scales (N,) are replicated.  The partial
    (B, N) product is computed in ``overlap_chunks`` column chunks, f32
    each, and chunk i's ``all_reduce`` (``scatter=False``) or
    reduce-scatter (``scatter=True``) is issued as soon as its product is
    queued; the handles are waited on at the end.  Returns the (B, N) sum
    in x's dtype, replicated.  With ``scatter=True`` each rank first holds
    one tile of every chunk, and the tiles are gathered back into the
    natural column order, as the JAX package's reshape does (a consumer
    that keeps the permuted layout would skip that copy)."""
    if w8.ndim == 2:
        w8 = chunk_columns(w8, overlap_chunks)
    elif w8.shape[0] != overlap_chunks:
        raise ValueError(f"a weight of {w8.shape[0]} chunks for "
                         f"{overlap_chunks}")
    csz = w8.shape[2]
    group = mesh.group(axis)
    t = dist.get_world_size(group)
    if scatter and csz % t:
        raise ValueError(f"a chunk of {csz} columns does not split over "
                         f"{t} ranks")
    s = scales.reshape(-1)
    pending, outs = [], []
    for c in range(overlap_chunks):
        part = _dequant_dot(x, w8[c], s[c * csz:(c + 1) * csz],
                            torch.float32)
        if scatter:
            # reduce_scatter splits dim 0: the columns go first
            send = part.t().contiguous()
            red = torch.empty((csz // t, part.shape[0]),
                              dtype=torch.float32, device=part.device)
            pending.append(reduce_scatter_flat(
                red, send, group=group, async_op=True))
            outs.append(red)
        else:
            pending.append(dist.all_reduce(part, group=group, async_op=True))
            outs.append(part)
    for h in pending:
        h.wait()
    if scatter:
        local = torch.cat([r.t() for r in outs], dim=1)
        return _tiles_to_natural(local, group, t, overlap_chunks).to(x.dtype)
    return torch.cat([o.to(x.dtype) for o in outs], dim=1)


def tp_mlp_block(x: torch.Tensor, up8, up_s, down8, down_s, mesh: Mesh,
                 axis: str = "model", overlap_chunks: int = 4
                 ) -> torch.Tensor:
    """A full TP MLP: column-parallel up (+silu) feeding row-parallel down
    with the overlapped sum.  x (B, K) replicated -> (B, K) replicated; up8
    (K, FF/T), up_s (FF/T,), down8 (FF/T, K) (or its :func:`chunk_columns`)
    this rank's shards, down_s (K,) replicated."""
    h = column_parallel_qmatmul(x, up8, up_s, mesh, axis)
    h = F.silu(h.to(torch.float32)).to(x.dtype)
    return row_parallel_qmatmul(h, down8, down_s, mesh, axis,
                                overlap_chunks=overlap_chunks)
