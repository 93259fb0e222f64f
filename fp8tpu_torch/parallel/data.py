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
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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
        """The largest of the ranks' ``a`` (a 0-d f32), NaN when any rank's
        is NaN (MAX reductions do not promise to carry a NaN)."""
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
