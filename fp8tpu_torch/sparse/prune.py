"""Sparsity engine: magnitude top-k weight pruning and stochastic gradient
pruning (capability parity with mpemu/sparse_utils.py), the port of the
JAX package's ``sparse/prune.py``.

* The stochastic-pruning threshold (the reference solves a lognormal
  survival equation with scipy's root_scalar on the host,
  sparse_utils.py:79-95) is a 50-step bisection in log space over 0-d
  tensors on the input's device: no value is read back to the host.
* Thresholds and the step counter live in an explicit :class:`SparseState`
  of 0-d tensors instead of mutable config attributes.

Given the same key and state, every function here is bit-equal to the JAX
package's on the CPU, but for the stochastic threshold: torch's f32
``erf``, ``exp`` and ``log`` and its summation order are not XLA's, so
that one float is held to a measured relative tolerance
(``tests/test_torch_sparse.py::THRESHOLD_RTOL``); what is computed from a
given threshold is bit-equal again.  XLA treats f32 subnormals as zero in
compares and ``sign`` and flushes subnormal products (ROADMAP trap 7); the
port does the same explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from fp8tpu_torch.numerics import prng
from fp8tpu_torch.numerics.cast import _flush
from fp8tpu_torch.numerics.prng import PRNGKey

Alpha = Union[float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    """Which tensor streams to sparsify (sparse_utils.py:14-31)."""

    weight: bool = False
    ingrad: bool = False
    outgrad: bool = False
    wtgrad: bool = False
    weight_sparsity: float = 0.0     # target fraction of zeros
    outgrad_sparsity: float = 0.0
    alpha_window: int = 50           # threshold refresh period
    sample_factor: float = 0.1       # top-k threshold sampling fraction


@dataclasses.dataclass
class SparseState:
    """Carried thresholds (reference weight_alpha / outgrad_alpha) and the
    step, as 0-d tensors (f32, f32, int32)."""

    weight_alpha: torch.Tensor
    outgrad_alpha: torch.Tensor
    step: torch.Tensor

    @staticmethod
    def create(device=None) -> "SparseState":
        # The reference initializes alphas to fp16-max = prune nothing.
        f32 = dict(dtype=torch.float32, device=device)
        return SparseState(weight_alpha=torch.tensor(65504.0, **f32),
                           outgrad_alpha=torch.tensor(65504.0, **f32),
                           step=torch.tensor(0, dtype=torch.int32,
                                             device=device))


def _f32(v: Alpha, device) -> torch.Tensor:
    """``v`` as an f32 tensor on ``device`` (a Python number converted as
    JAX converts a weakly typed scalar against f32)."""
    return torch.as_tensor(v, dtype=torch.float32, device=device) \
        if not isinstance(v, torch.Tensor) else v.to(device)


def _against(alpha: Alpha, x: torch.Tensor) -> torch.Tensor:
    """``alpha`` in the type JAX computes ``alpha op x`` in: a Python
    number takes ``x``'s float type (weak typing), an array is promoted
    with it (an f32 threshold keeps f32 against bf16 values)."""
    if isinstance(alpha, torch.Tensor):
        return alpha.to(device=x.device,
                        dtype=torch.promote_types(alpha.dtype, x.dtype))
    return torch.tensor(alpha, dtype=x.dtype, device=x.device)


def _size(x: torch.Tensor) -> torch.Tensor:
    """``x.size`` as the f32 tensor JAX divides by.  A divisor must be a
    tensor: torch's CUDA divide by a Python number multiplies by its
    reciprocal."""
    return torch.tensor(float(np.float32(x.numel())), dtype=torch.float32,
                        device=x.device)


def stochastic_prune(x: torch.Tensor, alpha: Alpha,
                     key: PRNGKey) -> torch.Tensor:
    """Stochastic pruning (sparse_utils.py:72-78): values below the
    threshold are kept with probability |x|/alpha (rescaled to +-alpha) or
    zeroed, an unbiased sparsifier for gradients."""
    a32 = _f32(alpha, x.device)
    rand = _flush(a32 * prng.uniform(key, x.shape, device=x.device))
    xf = x.float()
    ax = _flush(xf.abs())
    a = _against(alpha, x)
    kept = _flush(a * torch.sign(_flush(x.to(a.dtype))))
    out = torch.where(ax < _flush(a32), kept.float(), xf)
    out = torch.where(ax < rand, torch.zeros_like(out), out)
    return out.to(x.dtype)


def _lognormal_survival_gap(log_alpha, sparsity, sigma):
    """equationStochastic (sparse_utils.py:115-121) with mu factored out:
    zero when pruning at alpha = exp(log_alpha + mu) hits ``sparsity``."""
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=torch.float32,
                                    device=sigma.device))
    a = torch.exp(log_alpha)
    half_var = torch.exp(sigma * sigma / 2)
    pt1 = half_var * torch.erf(sigma / sqrt2 - log_alpha / (sqrt2 * sigma))
    pt2 = a * torch.erf(log_alpha / (sqrt2 * sigma))
    return 0.5 - sparsity + (pt1 + pt2 - half_var) / (2 * a)


def stochastic_prune_threshold(x: torch.Tensor, sparsity: float,
                               iters: int = 50) -> torch.Tensor:
    """Solve for the stochastic-pruning threshold reaching ``sparsity``,
    assuming |x| of the nonzeros is lognormal (sparse_utils.py:79-95): a
    log-space bisection over the reference's bracket [e^-9, e^5], each step
    a few 0-d tensor ops on ``x``'s device."""
    ax = _flush(x.float().abs().reshape(-1))
    nonzero = ax > 0
    count = torch.clamp_min(nonzero.sum(dtype=torch.int32), 1)
    n_nz = count.float()
    existing_sp = 1.0 - n_nz / _size(ax)
    target = torch.clamp_min(sparsity - existing_sp, 0.0)

    logs = torch.where(nonzero, torch.log(torch.where(
        nonzero, ax, torch.ones_like(ax))), torch.zeros_like(ax))
    mu = logs.sum() / n_nz
    d = logs - mu
    var = torch.where(nonzero, d * d, torch.zeros_like(d)).sum() \
        / torch.clamp_min(count - 1, 1).float()
    sigma = torch.sqrt(torch.clamp_min(var, 1e-12))

    lo = torch.tensor(-9.0, dtype=torch.float32, device=x.device)
    hi = torch.tensor(5.0, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        mid = (lo + hi) / 2
        # gap is increasing in alpha (-sparsity at alpha -> 0, 1 - sparsity
        # as alpha grows): gap > 0 means the root lies below mid.
        below = _lognormal_survival_gap(mid, target, sigma) > 0
        lo, hi = torch.where(below, lo, mid), torch.where(below, mid, hi)
    alpha = torch.exp((lo + hi) / 2 + mu)
    # No pruning needed: threshold 0 (prunes nothing).
    return torch.where(target > 0, alpha, torch.zeros_like(alpha))


def topk_prune(w: torch.Tensor, alpha: Alpha) -> torch.Tensor:
    """Magnitude pruning against a threshold (Topk_Pruning,
    sparse_utils.py:97-102)."""
    a = _against(alpha, w)
    small = _flush(w.abs().to(a.dtype)) < _flush(a)
    return torch.where(small, torch.zeros((), device=w.device),
                       w.float()).to(w.dtype)


def topk_threshold_sampled(w: torch.Tensor, sparsity: float, key: PRNGKey,
                           sample_factor: float = 0.1) -> torch.Tensor:
    """Sampled top-k magnitude threshold (Topk_Threshold_Sampled,
    sparse_utils.py:104-113): sample ~10% of entries with replacement,
    return the value at the (1 - sparsity) quantile of the sample."""
    flat = w.float().abs().reshape(-1)
    n = flat.numel()
    n_samp = max(1, int(n * sample_factor))
    idx = prng.randint(key, 0, n, (n_samp,), device=w.device)
    sampled = flat[idx]
    k = max(1, int(n_samp * (1.0 - sparsity)))
    return torch.topk(sampled, k).values[k - 1]


def _refresh(step: torch.Tensor, window: int) -> torch.Tensor:
    return (step != 0) & (step % window == 0)


def sparsify_weight(w: torch.Tensor, cfg: SparseConfig, state: SparseState,
                    key: PRNGKey) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight pruning with windowed threshold refresh
    (SparseConfig.sparsify_weight_tensor, sparse_utils.py:42-49).  Returns
    (pruned weight, new alpha).  The sampled threshold is drawn at every
    step, as in the JAX package, and kept only on a refresh step: no
    host read decides it."""
    new_alpha = torch.where(
        _refresh(state.step.to(w.device), cfg.alpha_window),
        topk_threshold_sampled(w, cfg.weight_sparsity, key,
                               cfg.sample_factor),
        state.weight_alpha.to(w.device))
    return topk_prune(w, new_alpha), new_alpha


def sparsify_outgrad(g: torch.Tensor, cfg: SparseConfig, state: SparseState,
                     key: PRNGKey) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output-gradient stochastic pruning with windowed threshold refresh
    (sparse_utils.py:36-41)."""
    new_alpha = torch.where(
        _refresh(state.step.to(g.device), cfg.alpha_window),
        stochastic_prune_threshold(g, cfg.outgrad_sparsity),
        state.outgrad_alpha.to(g.device))
    return stochastic_prune(g, new_alpha, key), new_alpha


def sparsity_of(x: torch.Tensor) -> torch.Tensor:
    """Fraction of zeros (print_sparse_stats, sparse_utils.py:64-70), as
    an f32 0-d tensor; subnormals count as zeros, as under XLA."""
    nz = (_flush(x.float()) != 0).sum(dtype=torch.int32).float()
    return 1.0 - nz / _size(x)
