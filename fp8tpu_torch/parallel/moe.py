"""Mixture-of-experts FFN (GShard / Switch style), the counterpart of
``fp8tpu/parallel/moe.py``: capacity-bounded top-k routing as dense
one-hot dispatch / combine einsums, and the quantized expert FFN built on
it.

Expert weights are fp8 (or int8) payloads with per-(expert,
output-channel) scales, as in the serving artifact.  The JAX package
shards the expert axis over a mesh and lets GSPMD insert the collectives.
Here, given a mesh, each rank of its ``axis`` group runs its E/T experts:
routing and the dispatch einsum run replicated, each rank takes its
experts' rows, and its expert outputs are gathered into the full (E, C, D)
tensor before the combine, which then runs as without a mesh.  The
gather's backward takes the rank's rows of the (replicated) cotangent and
the row slice's backward gathers them, so outputs and gradients are the
mesh-less ones, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.kernels.qmatmul import quantize_weights

from .mesh import gather_rows


def quantize_expert_weights(w: torch.Tensor, fmt: str = "e4m3"):
    """(E, K, N) expert stack -> (payload (E, K, N), scales (E, 1, N)): each
    expert quantized on its own, one scale per output channel."""
    qs = [quantize_weights(we, fmt) for we in w]
    return (torch.stack([p for p, _ in qs]), torch.stack([s for _, s in qs]))


def _dequant(w8, s, dtype):
    return (w8.to(torch.float32) * s).to(dtype)


def top_k_routing(logits: torch.Tensor, top_k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-bounded top-k routing (GShard-style, static shapes).

    logits (T, E) -> dispatch (T, E, C) {0, 1} f32, combine (T, E, C) f32
    (router probabilities at the dispatched slots), and the aux
    load-balancing loss (Switch: E * sum_e fraction_e * mean-prob_e, about 1
    when balanced).  Tokens overflowing an expert's capacity C are dropped.
    Choices go by ``argmax``, whose first maximum is the lowest expert
    index, as ``jnp.argmax``'s is."""
    T, E = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    dev = logits.device

    dispatch = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    masked = probs
    # aux loss uses the top-1 assignment fractions (Switch eq. 4-6)
    top1 = probs.argmax(dim=-1)
    frac = F.one_hot(top1, E).to(torch.float32).mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()

    fill = torch.zeros(E, dtype=torch.int64, device=dev)
    for _ in range(top_k):
        choice = masked.argmax(dim=-1)                        # (T,)
        onehot = F.one_hot(choice, E)                         # (T, E) int64
        # position of each token within its chosen expert's queue
        pos = (torch.cumsum(onehot, dim=0) - 1) + fill[None, :]
        pos_t = (pos * onehot).sum(dim=-1)                    # (T,)
        keep = pos_t < capacity
        slot = F.one_hot(pos_t.clamp(max=capacity - 1), capacity).to(
            torch.float32)
        d = (onehot.to(torch.float32) * keep[:, None])[..., None] \
            * slot[:, None, :]
        gate = probs.gather(1, choice[:, None])
        dispatch = dispatch + d
        combine = combine + d * gate[..., None]
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        masked = masked * (1.0 - onehot.to(torch.float32))
    return dispatch, combine, aux


class _ExpertRows(torch.autograd.Function):
    """Forward: this rank's expert rows of a replicated (E, ...) tensor.
    Backward: every rank's row cotangents gathered into the full one (the
    same on every rank)."""

    @staticmethod
    def forward(ctx, t, group, rank, n):
        ctx.group = group
        rows = t.shape[0] // n
        return t[rank * rows:(rank + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g, ctx.group), None, None, None


class _GatherExperts(torch.autograd.Function):
    """Forward: every rank's expert rows gathered into the full (E, ...)
    tensor.  Backward: this rank's rows of the cotangent, which every rank
    holds whole (what follows the gather runs replicated)."""

    @staticmethod
    def forward(ctx, t, group, rank):
        ctx.rank, ctx.rows = rank, t.shape[0]
        return gather_rows(t, group)

    @staticmethod
    def backward(ctx, g):
        r, rows = ctx.rank, ctx.rows
        return g[r * rows:(r + 1) * rows], None, None


def moe_ffn(x: torch.Tensor, gate_kernel: torch.Tensor,
            up8: torch.Tensor, up_s: torch.Tensor,
            down8: torch.Tensor, down_s: torch.Tensor,
            top_k: int = 2, capacity_factor: float = 1.25,
            mesh: Optional[object] = None, axis: str = "model"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized MoE FFN: route -> per-expert fp8 up / gelu / down ->
    combine.

    x (T, D); gate_kernel (D, E); up8 / up_s, down8 / down_s from
    :func:`quantize_expert_weights` ((E, D, F) and (E, F, D) stacks).  The
    contractions run in f32 (IEEE, not TF32), the GELU is the tanh form
    (``jax.nn.gelu``'s default).  Returns (y (T, D) in x's dtype,
    aux_loss).

    With ``mesh`` (a :class:`~fp8tpu_torch.parallel.mesh.Mesh`), x and
    gate_kernel are replicated over ``axis`` and the expert stacks are
    sharded over it: each rank passes its E/T rows (experts r*E/T first,
    the shard ``shard_params`` gives under ``MOE_PARAM_RULES``) and
    computes those experts only; the result and its gradients equal the
    mesh-less call's."""
    T, D = x.shape
    E = gate_kernel.shape[1]
    capacity = max(int(capacity_factor * top_k * T / E), top_k)

    xf = x.to(torch.float32)
    with full_fp32():
        logits = xf @ gate_kernel.to(torch.float32)
        dispatch, combine, aux = top_k_routing(logits, top_k, capacity)
        xe = torch.einsum("tec,td->ecd", dispatch, xf)
        if mesh is not None:
            group = mesh.group(axis)
            rank, n = dist.get_rank(group), dist.get_world_size(group)
            for w in (up8, up_s, down8, down_s):
                if w.shape[0] * n != E:
                    raise ValueError(f"an expert stack of {w.shape[0]} rows "
                                     f"for {E} experts over {n} ranks")
            xe = _ExpertRows.apply(xe, group, rank, n)
        h = torch.einsum("ecd,edf->ecf", xe,
                         _dequant(up8, up_s, torch.float32))
        h = F.gelu(h, approximate="tanh")
        ye = torch.einsum("ecf,efd->ecd", h,
                          _dequant(down8, down_s, torch.float32))
        if mesh is not None:
            ye = _GatherExperts.apply(ye, group, rank)
        y = torch.einsum("ecd,tec->td", ye, combine)
    return y.to(x.dtype), aux
