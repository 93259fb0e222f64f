"""Tensor telemetry: the port of ``fp8tpu/utils/stats.py``.

Statistics are plain functions of tensors that a train step returns beside
its results and the host logs at window boundaries, in place of the
reference's per-module hook telemetry."""

from __future__ import annotations

from typing import Dict

import torch


def tensor_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """absmax / smallest non-zero |x| / mean / std of one tensor (f32)."""
    xf = x.to(torch.float32)
    ax = xf.abs()
    nz = torch.where(ax > 0, ax, torch.full_like(ax, float("inf")))
    return {
        "absmax": ax.max(),
        "absmin_nonzero": nz.min(),
        "mean": xf.mean(),
        "std": xf.std(correction=0),
    }


def log2_histogram(x: torch.Tensor, lo: int = -40,
                   hi: int = 40) -> torch.Tensor:
    """Exponent histogram: counts per power-of-two bucket of |x| (int32,
    index 0 the zeros, then the bins [2^lo, 2^hi), the ends clamped)."""
    ax = x.to(torch.float32).abs().reshape(-1)
    exp = torch.floor(torch.log2(torch.where(ax > 0, ax,
                                             torch.ones_like(ax))))
    exp = torch.clamp(exp, lo, hi - 1).to(torch.int64) - lo
    exp = torch.where(ax > 0, exp, torch.full_like(exp, -1))
    return torch.bincount(exp + 1, minlength=hi - lo + 1).to(torch.int32)


def _leaves(tree, prefix=()):
    """(name, leaf) of a nest of dicts / lists / tuples, named with "/" as
    the JAX package names a pytree's leaves: dict keys sorted, a list's
    or tuple's items as ``[i]``."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (f"[{i}]",))
    else:
        yield "/".join(prefix), tree


def tree_stats(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-leaf :func:`tensor_stats` of the floating leaves of a nest (a
    state_dict, gradients)."""
    return {name: tensor_stats(leaf) for name, leaf in _leaves(tree)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()}


def stats_window_enabled(step: int, window: int = 1000,
                         width: int = 1) -> bool:
    """True for ``width`` steps at every ``window`` boundary."""
    return (step % window) < width
