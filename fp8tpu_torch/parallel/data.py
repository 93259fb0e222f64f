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

Tensor parallelism splits activations and weights over the mesh's model
group as well: :class:`TensorShard` marks a tensor split over the data
group, the model group or both, so that its casts reduce over the groups
that split it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


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

    def offset(self, numel: int) -> int:
        """Row-major index of this rank's first element in the global
        tensor of which it holds ``numel`` elements."""
        return self.index * numel

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


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """A rank's block of a tensor split over the data group (its rows,
    dimension 0: ``data``), over the model group (dimension ``model_dim``:
    ``model``), or over both; either part may be None.  Both parts are
    :class:`BatchShard` s of their groups.

    The casts read it as they read a :class:`BatchShard`: ``max`` and
    ``sum`` reduce over the product of the groups, so a per-tensor scale
    is the whole tensor's.  :meth:`reducing` keeps the parts that a
    per-channel reduction over some dimensions has to cross (a column
    shard of a Dense kernel scaled per input row needs the model group's
    MAX of each row; a row shard needs none).  Stochastic rounding of a
    model-split tensor is not ported: the JAX layout's offsets of a column
    block are not one contiguous range (ROADMAP §1 item 7c)."""

    data: Optional[BatchShard] = None
    model: Optional[BatchShard] = None
    model_dim: int = -1

    @property
    def parts(self) -> Tuple[BatchShard, ...]:
        return tuple(p for p in (self.data, self.model) if p is not None)

    @property
    def count(self) -> int:
        return math.prod(p.count for p in self.parts)

    def offset(self, numel: int) -> int:
        if self.model is not None:
            raise NotImplementedError(
                "stochastic rounding of a tensor split over the model group "
                "(its JAX-layout offsets are not contiguous): ROADMAP §1 "
                "item 7c")
        return 0 if self.data is None else self.data.offset(numel)

    def max(self, a: torch.Tensor) -> torch.Tensor:
        for p in self.parts:
            a = p.max(a)
        return a

    def sum(self, a: torch.Tensor) -> torch.Tensor:
        for p in self.parts:
            a = p.sum(a)
        return a

    def reducing(self, dims, ndim: int) -> Optional["TensorShard"]:
        """The parts whose split dimension is among ``dims`` (of a tensor of
        ``ndim`` dimensions), or None when there is none."""
        dims = {d % ndim for d in dims}
        data = self.data if 0 in dims else None
        model = self.model if self.model_dim % ndim in dims else None
        if data is None and model is None:
            return None
        return TensorShard(data, model, self.model_dim)
