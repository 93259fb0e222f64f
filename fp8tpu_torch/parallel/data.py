"""Data parallelism as the global step: what a rank's casts need to know
about the batch it holds.

Under GSPMD the JAX package's data-parallel train step is the unsharded
step, whatever the mesh.  A rank here holds rows ``index * b ..
(index + 1) * b`` of the global batch (``b`` its own rows), and for its
step to be the global one:

- a per-tensor scale of an activation or a gradient stream is the global
  tensor's: the rank's amax is reduced (MAX) over the group;
- stochastic rounding draws the global tensor's bits at the rank's
  row-major offset (``index * numel`` for a tensor whose leading dimension
  is the batch);
- the raw gradients are summed over the group (f32, as GSPMD's psum)
  before anything casts them, the loss being each rank's rows' sum over
  the global count.

Weights are replicated and their casts need none of this.

Tensor and sequence parallelism split activations and weights over the
mesh's model and seq groups as well: :class:`TensorShard` marks a tensor
split over any of the data, seq and model groups, so that its casts reduce
over the groups that split it, and its :class:`Block` says where the rank's
elements lie in the global tensor: stochastic rounding hashes each
element's global row-major index, which for a column or sequence block is
not one contiguous range.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Block:
    """Where a rank's block of a row-major tensor lies in the global one:
    ``shape`` the global shape, ``start`` the block's first index along
    each dimension (its extents are the local tensor's)."""

    shape: Tuple[int, ...]
    start: Tuple[int, ...]

    def index(self, local_shape: Sequence[int], device=None) -> torch.Tensor:
        """The global row-major index (int64) of every local element, in
        the local tensor's row-major order."""
        idx = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(local_shape))):
            ar = torch.arange(self.start[d], self.start[d] + local_shape[d],
                              dtype=torch.int64, device=device) * stride
            idx = idx + ar.reshape((-1,) + (1,) * (len(local_shape) - 1 - d))
            stride *= self.shape[d]
        return idx.reshape(-1)

    def segments(self, local_shape: Sequence[int]):
        """The block as runs of dimensions, each a split dimension with the
        unsplit ones after it (and the leading unsplit ones as one run):
        ``[(local extent, global extent, start), ...]``, outermost first.
        Element ``(i_0, .., i_k)`` of the runs has the global index
        ``((s_0 + i_0) G_1 + s_1 + i_1) G_2 + ...``."""
        runs: List[List[int]] = []
        for n, g, s in zip(local_shape, self.shape, self.start):
            if runs and s == 0 and n == g:
                runs[-1] = [runs[-1][0] * n, runs[-1][1] * g, runs[-1][2] * n]
            else:
                runs.append([n, g, s])
        return [tuple(r) for r in runs] or [(1, 1, 0)]

    def contiguous_offset(self, local_shape: Sequence[int]) -> Optional[int]:
        """The global index of the block's first element when its elements
        are one contiguous range of the global tensor (every run but the
        last one element long), else None."""
        runs = self.segments(local_shape)
        if any(n != 1 for n, _, _ in runs[:-1]):
            return None
        off = 0
        for _, g, s in runs:
            off = off * g + s
        return off


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rank ``index`` of ``count`` equal row blocks of a batch split over
    ``group`` along dimension 0."""

    group: object
    index: int
    count: int

    @classmethod
    def of(cls, group) -> "BatchShard":
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def block(self, shape: Sequence[int]) -> Block:
        """The rank's rows of the global tensor."""
        shape = tuple(shape)
        if not shape:
            return Block((), ())
        return Block((shape[0] * self.count,) + shape[1:],
                     (shape[0] * self.index,) + (0,) * (len(shape) - 1))

    def max(self, a: torch.Tensor) -> torch.Tensor:
        """The largest of the ranks' ``a`` (f32, element by element: a 0-d
        amax or a per-channel one), NaN where any rank's is NaN (MAX
        reductions do not promise to carry a NaN)."""
        nan = torch.isnan(a)
        both = torch.stack([torch.where(nan, torch.zeros_like(a), a),
                            nan.to(a.dtype)])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        return torch.where(both[1] > 0, torch.full_like(a, float("nan")),
                           both[0])

    def sum(self, a: torch.Tensor) -> torch.Tensor:
        out = a.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def sum_grads(self, grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Every gradient summed over the group in f32, in one all-reduce of
        their concatenation; each comes back in its shape and dtype."""
        names = list(grads)
        flat = torch.cat([grads[n].to(torch.float32).reshape(-1)
                          for n in names])
        dist.all_reduce(flat, group=self.group)
        out, at = {}, 0
        for n in names:
            g = grads[n]
            out[n] = flat[at:at + g.numel()].reshape(g.shape).to(g.dtype)
            at += g.numel()
        return out


def seq_chunk(length: int, count: int) -> int:
    """The length of a sequence chunk when ``length`` positions are split
    over ``count`` ranks: ``ceil(length / count)``, the last chunk
    shorter (the JAX package's GSPMD pads the uneven split; the port keeps
    the global length in every offset and gather)."""
    return -(-length // count)


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """A rank's block of a tensor split over the data group (its rows,
    dimension 0: ``data``), over the seq group (dimension ``seq_dim`` of
    ``seq_len`` global positions, in chunks of :func:`seq_chunk`: ``seq``),
    over the model group (dimension ``model_dim``: ``model``), or over any
    of them together; each part may be None.  The parts are
    :class:`BatchShard` s of their groups; ``seq_len`` None means the
    local length times the group's size.

    The casts read it as they read a :class:`BatchShard`: ``max`` and
    ``sum`` reduce over the product of the groups, so a per-tensor scale
    is the whole tensor's, and :meth:`block` places the rank's elements in
    the global tensor for stochastic rounding.  A reduction over several
    parts is one collective over their product group (``Mesh.group`` of
    ``mesh``, the ``parallel.Mesh`` the parts' groups come from, which
    such a shard needs).  :meth:`reducing` keeps the
    parts that a per-channel reduction over some dimensions has to cross
    (a column shard of a Dense kernel scaled per input row needs the model
    group's MAX of each row; a row shard needs none)."""

    data: Optional[BatchShard] = None
    model: Optional[BatchShard] = None
    model_dim: int = -1
    seq: Optional[BatchShard] = None
    seq_dim: int = 1
    seq_len: Optional[int] = None
    mesh: object = dataclasses.field(default=None, compare=False)

    @property
    def parts(self) -> Tuple[BatchShard, ...]:
        return tuple(p for p in (self.data, self.seq, self.model)
                     if p is not None)

    def _reducer(self) -> Optional[BatchShard]:
        """The shard whose collectives reduce over every part: the one
        part, or the parts' product group (None without a part)."""
        parts = self.parts
        if len(parts) < 2:
            return parts[0] if parts else None
        if self.mesh is None:
            raise ValueError("a TensorShard of several parts reduces over "
                             "their product group: give it the mesh")
        axes = ((("host", "data") if self.data is not None else ())
                + (("seq",) if self.seq is not None else ())
                + (("model",) if self.model is not None else ()))
        return BatchShard.of(self.mesh.group(*axes))

    @property
    def count(self) -> int:
        return math.prod(p.count for p in self.parts)

    def _dims(self, ndim: int):
        """(part, dimension, global length or None) of each split."""
        out = []
        if self.data is not None:
            out.append((self.data, 0, None))
        if self.seq is not None:
            out.append((self.seq, self.seq_dim % ndim, self.seq_len))
        if self.model is not None:
            out.append((self.model, self.model_dim % ndim, None))
        return out

    def block(self, shape: Sequence[int]) -> Block:
        """Where the rank's block of ``shape`` lies in the global tensor."""
        gshape, start = list(shape), [0] * len(shape)
        for part, d, length in self._dims(len(shape)):
            n = shape[d]
            if length is None:
                gshape[d], start[d] = n * part.count, n * part.index
            else:
                chunk = seq_chunk(length, part.count)
                gshape[d], start[d] = length, chunk * part.index
                if n != max(0, min(chunk, length - chunk * part.index)):
                    raise ValueError(
                        f"a sequence chunk of {n} positions on rank "
                        f"{part.index} of {part.count} over {length}")
        return Block(tuple(gshape), tuple(start))

    def max(self, a: torch.Tensor) -> torch.Tensor:
        r = self._reducer()
        return a if r is None else r.max(a)

    def sum(self, a: torch.Tensor) -> torch.Tensor:
        r = self._reducer()
        return a if r is None else r.sum(a)

    def reducing(self, dims, ndim: int) -> Optional["TensorShard"]:
        """The parts whose split dimension is among ``dims`` (of a tensor of
        ``ndim`` dimensions), or None when there is none."""
        dims = {d % ndim for d in dims}
        data = self.data if 0 in dims else None
        model = self.model if self.model_dim % ndim in dims else None
        seq = self.seq if self.seq_dim % ndim in dims else None
        if data is None and model is None and seq is None:
            return None
        return dataclasses.replace(self, data=data, model=model, seq=seq)

