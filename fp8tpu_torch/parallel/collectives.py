"""The collectives of tensor and sequence parallelism as autograd
functions: what GSPMD's transposes make of them in the backward.

A raw ``dist.all_reduce`` or ``all_gather`` is invisible to autograd.
Each collective here carries its backward, and which one depends on who
consumes its result (PR 20's trap 83, one layer down):

- :func:`sum_f32`, the row-parallel sum: every rank's f32 partials summed
  and rounded once to the layer's type; its consumer is replicated over
  the group, so the backward is the identity.
- :func:`column_input`, the input of a column-parallel product: the
  identity forward (as f32, so that the backward's partial products stay
  f32); the backward sums the ranks' partial input gradients in f32 and
  rounds once to the input's type, as the unsharded product's one dot
  with f32 accumulation does (trap 88 in the backward).  It sits inside
  the module, below the interceptor's igrad cast, which then casts the
  summed gradient.
- :func:`gather`, blocks put back together for a replicated consumer:
  the backward is the rank's block of the gradient.
- :func:`gather_parts`, blocks put together for a consumer that uses a
  different part on each rank (k / v gathered for the rank's query
  heads): the backward sums the ranks' f32 gradients and gives each rank
  its block, rounded once to the input's type.
- :func:`block`, the rank's block of a replicated tensor: the backward
  gathers the blocks.
- :func:`seq_gather`, a sequence-split tensor (k, v) gathered whole for
  each rank's own rows (not a replicated consumer): the forward pads the
  short last chunk and drops the padding, and the result is f32; the
  backward sums the ranks' f32 gradients of the whole tensor and gives
  each rank its chunk, rounded once to the input's type.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .data import seq_chunk
from .mesh import gather_rows


def _size(group) -> int:
    return dist.get_world_size(group)


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` (no
    backward: a checkpoint's global leaves)."""
    if t.dtype.itemsize == 1 and t.dtype != torch.uint8:
        # gloo moves no fp8 or int8: their bytes
        return gather_dim(t.view(torch.uint8), dim, group).view(t.dtype)
    return gather_rows(t.movedim(dim, 0).contiguous(), group).movedim(0, dim)



def _block_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, i = _size(group), dist.get_rank(group)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).contiguous()


class _SumF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dtype):
        ctx.dtype = t.dtype
        out = t.to(torch.float32).clone()
        dist.all_reduce(out, group=group)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def sum_f32(t: torch.Tensor, group, dtype) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``t`` in f32, rounded once to
    ``dtype``; backward the identity."""
    return _SumF32.apply(t, group, dtype)


class _ColumnInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.dtype = group, x.dtype
        return x.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32).contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.to(ctx.dtype), None


def column_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as f32, for a product whose partial input gradients the
    ranks of ``group`` sum in the backward (f32, rounded once to ``x``'s
    type)."""
    return _ColumnInput.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block_dim(g, ctx.dim, ctx.group), None, None


def gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``group`` along ``dim`` put together, for a
    consumer that every rank computes alike; backward the rank's block."""
    return _Gather.apply(t, dim % t.ndim, group)


class _GatherParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.dtype = dim, group, t.dtype
        return gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32).contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return _block_dim(g, ctx.dim, ctx.group).to(ctx.dtype), None, None


def gather_parts(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``group`` along ``dim`` put together, for a
    consumer that uses another part of it on each rank; backward the f32
    sum of the ranks' gradients, the rank's block rounded once to ``t``'s
    type."""
    return _GatherParts.apply(t, dim % t.ndim, group)


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


def block(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The rank's block of a replicated ``t`` along ``dim``; backward the
    blocks gathered."""
    return _Block.apply(t, dim % t.ndim, group)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, length):
        n, i = _size(group), dist.get_rank(group)
        chunk = seq_chunk(length, n)
        ctx.dim, ctx.group, ctx.dtype = dim, group, t.dtype
        ctx.start, ctx.local, ctx.chunk = i * chunk, t.shape[dim], chunk
        t = t.to(torch.float32)
        if t.shape[dim] < chunk:
            pad = list(t.shape)
            pad[dim] = chunk - t.shape[dim]
            t = torch.cat([t, t.new_zeros(pad)], dim=dim)
        return gather_dim(t, dim, group).narrow(dim, 0, length)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32).contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        mine = g.narrow(ctx.dim, ctx.start, ctx.local)
        return mine.to(ctx.dtype).contiguous(), None, None, None


def seq_gather(t: torch.Tensor, group, dim: int, length: int) -> torch.Tensor:
    """The ranks' sequence chunks of ``group`` along ``dim`` (chunks of
    ``seq_chunk(length, n)``, the last shorter) put together into the
    ``length`` positions, as f32; backward the f32 sum over the ranks of
    the whole gradient, each rank's chunk of it rounded once to ``t``'s
    type."""
    return _SeqGather.apply(t, dim % t.ndim, group, length)
