"""Training / eval metric logging: the port of ``fp8tpu/utils/metrics.py``.

Windowed medians (``SmoothedValue``), an iteration logger with throughput
(``MetricLogger``) and top-k accuracy, after the reference's example
utilities; the cross-process mean goes through ``torch.distributed`` when
a process group is up, and is the identity otherwise.  The SQuAD span
metrics (``beam_search_spans``, ``squad_em_f1``) are NumPy, copies of the
JAX module's; they take arrays or tensors.
"""

from __future__ import annotations

import collections
import time
from typing import Dict

import numpy as np
import torch


class SmoothedValue:
    """Windowed median / average tracker."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} "
                 "({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        v = float(value)
        self.deque.append(v)
        self.count += n
        self.total += v * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with throughput."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        for i, obj in enumerate(iterable):
            t0 = time.time()
            yield obj
            iter_time.update(time.time() - t0)
            if i % print_freq == 0:
                print(f"{header} [{i}]  {self}  iter_time: {iter_time}")
        total = time.time() - start
        print(f"{header} Total time: {total:.1f}s")


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1,)):
    """Top-k accuracy in percent, one f32 scalar tensor per k (ties broken
    toward the higher index, as the JAX package's reversed argsort)."""
    order = torch.flip(torch.argsort(logits, dim=-1, stable=True), (-1,))
    results = []
    for k in topk:
        hit = (order[:, :k] == labels[:, None]).any(dim=1)
        results.append(hit.to(torch.float32).mean() * 100.0)
    return results


def all_reduce_mean(value, group=None):
    """Cross-process metric mean: ``torch.distributed``'s all-reduce over
    ``group`` when a process group is up (a tensor is reduced in place and
    returned), the identity in a single process."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return value
    t = value if isinstance(value, torch.Tensor) else torch.tensor(
        float(value))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    t /= dist.get_world_size(group)
    return t


def _host(a) -> np.ndarray:
    """An array or a tensor (on any device) as a NumPy array."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def beam_search_spans(start_logits, end_logits, n_best: int = 20,
                      max_answer_len: int = 30):
    """N-best span selection — the decode step of the reference's
    run_qa_beam_search_no_trainer.py: take the top-k start and end
    logits, score every valid (start <= end, length-bounded) pair by
    summed logits, and return the best span per example.

    start_logits/end_logits: (B, S) arrays.  Returns (starts, ends)
    int arrays of shape (B,).
    """
    sl = _host(start_logits)
    el = _host(end_logits)
    B, S = sl.shape
    k = min(n_best, S)
    top_s = np.argpartition(-sl, k - 1, axis=1)[:, :k]
    top_e = np.argpartition(-el, k - 1, axis=1)[:, :k]
    starts = np.zeros(B, np.int64)
    ends = np.zeros(B, np.int64)
    for b in range(B):
        best = -np.inf
        for s in top_s[b]:
            for e in top_e[b]:
                if e < s or e - s + 1 > max_answer_len:
                    continue
                score = sl[b, s] + el[b, e]
                if score > best:
                    best = score
                    starts[b], ends[b] = s, e
        if not np.isfinite(best):          # no valid pair: greedy fallback
            starts[b] = int(np.argmax(sl[b]))
            ends[b] = max(int(np.argmax(el[b])), starts[b])
    return starts, ends


def squad_em_f1(pred_starts, pred_ends, gold_starts, gold_ends):
    """SQuAD-style span metrics: exact match and token-overlap F1.

    The reference computes these through the HF ``squad`` metric over
    decoded answer strings (run_squad.py; run_qa_no_trainer.py) — at the
    span level the definition is: EM = both endpoints equal; F1 = the
    harmonic mean of precision/recall of the predicted token range
    against the gold range.  Inputs are int arrays of shape (N,).

    Returns dict(exact_match=%, f1=%).
    """
    ps, pe, gs, ge = map(_host, (pred_starts, pred_ends, gold_starts,
                                 gold_ends))
    # normalize reversed spans
    ps, pe = np.minimum(ps, pe), np.maximum(ps, pe)
    gs, ge = np.minimum(gs, ge), np.maximum(gs, ge)

    em = (ps == gs) & (pe == ge)
    inter = np.maximum(0, np.minimum(pe, ge) - np.maximum(ps, gs) + 1)
    plen = pe - ps + 1
    glen = ge - gs + 1
    prec = inter / plen
    rec = inter / glen
    f1 = np.where(inter > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-9),
                  0.0)
    return {"exact_match": float(em.mean() * 100),
            "f1": float(f1.mean() * 100)}
