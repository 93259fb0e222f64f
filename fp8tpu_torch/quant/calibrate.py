"""Calibration: a statistics sweep over batches.

Observers are side outputs of the interceptor (``stats_sink``) rather
than stateful submodules; batches fold with pure merge rules.  Produces
the qparams of calibrated inference: FP8 scales (flt_max / absmax) and
INT (scale, zero_point) pairs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import torch
from torch.func import functional_call

from fp8tpu_torch import linen
from fp8tpu_torch.numerics.formats import FORMATS
from fp8tpu_torch.numerics.integer import int_qparams

from .config import TensorQuantConfig
from .interceptor import make_quant_interceptor
from .policy import QuantPolicy


class _NullPolicy:
    """Observe-only policy: resolves every module to None."""

    is_training = False

    def resolve(self, path, kind):
        return None


_NULL_POLICY = _NullPolicy()


def collect_stats_fn(model: torch.nn.Module,
                     policy: Optional[QuantPolicy] = None,
                     per_channel: bool = False) -> Callable:
    """``(params, *args) -> (out, stats)``.  With a ``policy``, activations
    are fake-quantized while observed, as the reference's calibration
    passes run the hooked model."""

    def run(params, *args, **kwargs):
        sink: Dict[str, Dict[str, Any]] = {}
        interceptor = make_quant_interceptor(
            policy if policy is not None else _NULL_POLICY,
            stats_sink=sink, per_channel_stats=per_channel)
        with linen.intercept_methods(interceptor, model):
            out = functional_call(model, params, args, kwargs)
        stats = {path: {k: v for k, v in rec.items() if k != "kind"}
                 for path, rec in sink.items()}
        return out, stats

    return run


def merge_stats(acc: Optional[Dict], new: Dict, mode: str = "minmax",
                momentum: float = 0.9) -> Dict:
    """Fold one batch of stats into the accumulator: ``minmax`` keeps the
    global extrema, ``running`` an exponential average of per-batch
    extrema."""
    if acc is None:
        return {path: dict(rec) for path, rec in new.items()}
    out = {}
    for path, rec in new.items():
        if path not in acc:
            out[path] = rec
            continue
        a, merged = acc[path], {}
        for k, v in rec.items():
            if k not in a:
                merged[k] = v
            elif mode == "running":
                merged[k] = momentum * a[k] + (1 - momentum) * v
            elif k.endswith("_min"):
                merged[k] = torch.minimum(a[k], v)
            else:
                merged[k] = torch.maximum(a[k], v)
        out[path] = merged
    for path in acc:
        if path not in out:
            out[path] = acc[path]
    return out


def calibrate(
    model: torch.nn.Module,
    batches: Iterable,
    policy: Optional[QuantPolicy] = None,
    mode: str = "minmax",
    momentum: float = 0.9,
    per_channel: bool = False,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Run the sweep over ``batches`` (each an args tuple or one tensor)
    with ``params`` (default: the model's state_dict) and return merged
    per-module stats."""
    run = collect_stats_fn(model, policy, per_channel=per_channel)
    if params is None:
        params = model.state_dict()
    acc = None
    with torch.no_grad():
        for batch in batches:
            args = batch if isinstance(batch, tuple) else (batch,)
            if any(torch.is_tensor(a) and a.numel() == 0 for a in args):
                continue  # empty tail batch: nothing to observe
            _, stats = run(params, *args)
            acc = merge_stats(acc, stats, mode=mode, momentum=momentum)
    if acc is None:
        raise ValueError("calibrate() received no non-empty batches")
    return acc


def fp8_scale_from_stats(stats_rec: Dict, cfg: TensorQuantConfig,
                         role: str = "iact") -> torch.Tensor:
    """Calibrated per-tensor scale: flt_max / observed absmax, clamped as
    in numerics.scaling."""
    absmax = stats_rec[f"{role}_absmax"]
    absmax = torch.clamp(absmax, min=1e-30)
    scale = torch.full_like(absmax, FORMATS[cfg.dtype].max_normal) / absmax
    return torch.where(scale > 3.275e4, torch.clamp(scale, max=6.55e4),
                       scale)


def int_qparams_from_stats(stats_rec: Dict, bits: int = 8,
                           symmetric: bool = False, role: str = "iact"):
    """Calibrated INT qparams from observed min/max."""
    return int_qparams(stats_rec[f"{role}_min"], stats_rec[f"{role}_max"],
                       bits=bits, symmetric=symmetric)


def qparams_from_stats(stats: Dict[str, Dict], policy: QuantPolicy,
                       module_table: Dict) -> Dict[str, Dict]:
    """{path: {role: scale}} for calibrated inference."""
    out: Dict[str, Dict] = {}
    for path, rec in stats.items():
        kind = module_table.get(path)
        cfg = policy.resolve(path, kind) if kind is not None else None
        if cfg is None:
            continue
        entry = {}
        for role in ("iact", "oact"):
            rcfg = cfg.role(role)
            if rcfg is None or f"{role}_absmax" not in rec:
                continue
            if rcfg.is_int:
                entry[role] = int_qparams_from_stats(rec, rcfg.bits,
                                                     role=role)
            else:
                entry[role] = fp8_scale_from_stats(rec, rcfg, role)
        if entry:
            out[path] = entry
    return out
