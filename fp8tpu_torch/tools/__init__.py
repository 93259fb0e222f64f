"""Command-line studies of the port, each the counterpart of a JAX tool in
``tools/``: ``python -m fp8tpu_torch.tools.kexp_convert`` (T1) and
``python -m fp8tpu_torch.tools.bench_fp8_linear`` (T2).  They run on the
card unless ``--device cpu`` is given, and raise without one.  Beside them,
measurements that need a card: ``bench_wgemm.py`` and ``bench_k1k4.py``
(kernel device times of two checkouts, in turns), ``k1_probe.py`` and
``k4_probe.py`` (what bounds K1 and K4)."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.splitlines()[0] if out else "nvidia-smi gave no output"


def device_ms(fn, iters: int = 16, replays: int = 5) -> float:
    """Device ms of one call of ``fn`` on the card: ``iters`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's time between launches (Python, allocator, wrapper) is not in
    the number.  For launches of a few microseconds, where an event-timed
    loop measures the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)
