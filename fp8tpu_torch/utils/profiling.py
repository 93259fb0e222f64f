"""Profiling / tracing helpers: the port of ``fp8tpu/utils/profiling.py``.

``torch.profiler`` traces (Chrome trace format), named ranges that show in
them (and as NVTX ranges on the card), and wall-clock timers that wait for
the device the work ran on."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the CPU and, where present,
    the card; written as ``trace.json`` (Chrome / Perfetto) under
    ``log_dir`` (default: ``./fp8tpu_torch_trace``).  Yields the
    profiler."""
    log_dir = log_dir or os.path.join(os.getcwd(), "fp8tpu_torch_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range: a ``record_function`` scope in the profiler's trace
    and, on the card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(tree) -> None:
    """Wait for the device that the first tensor of ``tree`` lives on."""
    from .stats import _leaves
    for _, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


class Timer:
    """Wall-clock timer; ``stop(sync_on=tensors)`` first waits for the
    device those tensors live on (CUDA launches return before the work is
    done)."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            _sync(sync_on)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed


def benchmark(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Steady-state seconds an iteration: ``warmup`` calls, then ``iters``
    queued calls and one wait for the device of the result."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters
