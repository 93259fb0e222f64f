"""GPipe-style pipeline parallelism over a ``stage`` mesh axis, the
counterpart of ``fp8tpu/parallel/pipeline.py``.

The layer stack is split into S stages, one a rank of the stage group;
microbatches stream through ``M + S - 1`` ticks.  At tick t stage 0 takes
microbatch t, every other stage the activation its predecessor sent at
tick t - 1; every stage runs its block and hops the result to its
successor, and the last stage emits microbatch t - (S - 1).  A closing
sum over the stage group replicates the outputs.

The JAX package differentiates its scan and ``ppermute`` and gets the
GPipe backward for free.  Here the hop is an autograd Function (forward:
send to s + 1, receive from s - 1; backward: the reverse), and the tick
loop keeps every tick's hop on the path to the outputs (stage 0 selects
its microbatch with ``torch.where``, which keeps the received state in the
graph, and every tick's block output reaches the output buffer through a
``where`` too), so each rank's hops form one chain that the backward walks
in reverse tick order: every rank posts its sends and receives in the same
tick order in both passes.  Bubble ticks are computed, as in the JAX
package (their inputs are zeros or a repeated microbatch and nothing of
them reaches the outputs).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .mesh import Mesh
from .sharding import NamedSharding, P


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def stack_stage_params(per_stage_params):
    """Stack a list of S identically-structured dicts of tensors along a new
    leading stage axis (leaves become (S, ...)): the layout
    :func:`pipeline_apply` expects."""
    first, *rest = per_stage_params
    return _tree_map(lambda *xs: torch.stack(xs, dim=0), first, *rest)


def stage_param_sharding(stage_params, mesh: Mesh):
    """Shardings placing each stage's parameter slice on its stage row
    (leading axis over ``stage``, the rest replicated)."""
    return _tree_map(
        lambda x: NamedSharding(mesh, P("stage", *([None] * (x.ndim - 1)))),
        stage_params)


def _exchange(send: Optional[torch.Tensor], to: Optional[int],
              like: torch.Tensor, frm: Optional[int]) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` and receive a tensor shaped like
    ``like`` from ``frm`` (zeros when there is none), both posted at once."""
    recv = torch.zeros_like(like)
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv, frm))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


class _Hop(torch.autograd.Function):
    """One tick's stage hop: forward sends ``y`` to the next stage and
    returns what the previous stage sent; backward sends the cotangent of
    that back to the previous stage and returns the cotangent of ``y`` from
    the next one."""

    @staticmethod
    def forward(ctx, y, nxt, prv):
        ctx.nxt, ctx.prv = nxt, prv
        return _exchange(y, nxt, y, prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prv, g, ctx.nxt), None, None


class _SumOut(torch.autograd.Function):
    """The closing sum over the stage group.  Every rank holds the summed
    outputs (replicated), and a loss of them is the global program's loss
    counted once, so the cotangent reaches each rank's addend as it is."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """An input replicated over ``group`` and used differently by its ranks:
    identity forward; backward sums the ranks' cotangents, the cotangent of
    the one global tensor."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _local_stage(p: torch.Tensor, sid: int) -> torch.Tensor:
    """This stage's slice of a (S, ...) leaf: a DTensor's local (1, ...)
    block, or row ``sid`` of a whole tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return p.to_local()[0]
    return p[sid]


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   mesh: Mesh, n_microbatches: int, axis: str = "stage",
                   batch_axis: Optional[str] = "data",
                   remat: bool = False) -> torch.Tensor:
    """Run ``x`` through S pipelined stages: ``y = f_{S-1}(... f_0(x))``.

    ``stage_params``: dict of tensors with leading dim S on every leaf
    (:func:`stack_stage_params`; whole, or DTensors placed by
    :func:`stage_param_sharding`); this rank runs row ``sid`` of them.
    ``stage_fn(params_slice, x_mb) -> y_mb`` must keep the microbatch
    shape.  ``x``: this rank's rows of the batch (its ``batch_axis`` shard;
    the same on every stage), a multiple of ``n_microbatches``.  Returns
    those rows' outputs, replicated over ``axis``.

    Differentiable.  The cotangents of the parameters are summed over
    ``batch_axis`` (they are replicated there) and those of ``x`` over the
    stages (only stage 0 reads it), so every rank gets the gradient of the
    global loss: the sum over data ranks of each rank's loss of its rows.
    ``remat=True`` wraps each stage call in ``torch.utils.checkpoint``
    (non-reentrant): the ticks keep only stage inputs and the backward
    recomputes the stage.  Every rank of the mesh must call this with the
    same shapes and ``requires_grad`` flags."""
    S = mesh.shape[axis]
    M = n_microbatches
    group = mesh.group(axis)
    sid = dist.get_rank(group)
    nxt = dist.get_global_rank(group, sid + 1) if sid < S - 1 else None
    prv = dist.get_global_rank(group, sid - 1) if sid > 0 else None
    params = _tree_map(lambda p: _local_stage(p, sid), stage_params)
    if batch_axis is not None and mesh.shape.get(batch_axis, 1) > 1:
        dgroup = mesh.group(batch_axis)
        params = _tree_map(lambda p: _Replicated.apply(p, dgroup), params)
    if S > 1:
        x = _Replicated.apply(x, group)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch of {B} rows is not {M} microbatches")
    mbs = x.reshape(M, B // M, *x.shape[1:])
    run = ((lambda p, h: checkpoint(stage_fn, p, h, use_reentrant=False))
           if remat else stage_fn)

    first = torch.tensor(sid == 0, device=x.device)
    last = sid == S - 1
    state = torch.zeros_like(mbs[0])
    outs = [torch.zeros_like(mbs[0]) for _ in range(M)]
    for t in range(M + S - 1):
        x_in = torch.where(first, mbs[min(t, M - 1)], state)
        y = run(params, x_in)
        out_t = t - (S - 1)
        slot = max(out_t, 0)
        outs[slot] = torch.where(
            torch.tensor(out_t >= 0 and last, device=x.device), y,
            outs[slot])
        if S > 1:
            state = _Hop.apply(y, nxt, prv)
    outputs = torch.stack(outs)
    if S > 1:
        outputs = _SumOut.apply(
            torch.where(torch.tensor(last, device=x.device), outputs,
                        torch.zeros_like(outputs)), group)
    return outputs.reshape(B, *x.shape[1:])
