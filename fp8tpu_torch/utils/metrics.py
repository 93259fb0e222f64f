"""Training / eval metric logging: the port of ``fp8tpu/utils/metrics.py``.

Windowed medians (``SmoothedValue``), an iteration logger with throughput
(``MetricLogger``) and top-k accuracy, after the reference's example
utilities; the cross-process mean goes through ``torch.distributed`` when
a process group is up, and is the identity otherwise.  (The SQuAD span
metrics of the JAX module wait for the SQuAD models.)
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
