"""T2, the fp8 convert study on K3's main loop
(``csrc/fp8_linear_study.cu``): its wrapper, launch count and plain
version.

Replaces ``tools/bench_pallas_linear.py::pl_linear``: ``out (M, N) bf16 =
x (M, K) bf16 @ conv(w (K, N))`` with f32 accumulation, one rounding to
bf16 and no scale.  The modes differ only in the weight's convert:
"pl-astype" (K3's hardware convert), "pl-bits" (the tool's integer
pipeline), "pl-magic" (its select plus subnormal table) on e4m3 weights,
and "pl-bf16" on bf16 weights with no convert.  The kernel is K3's
streaming loop (``csrc/w_stream.cuh``) with K3's plan, launched once a
rep.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fp8tpu_torch._device import full_fp32

from . import _build
from .kexp_convert import convert, e4m3_bytes
from .qmatmul import (check_gemm_shape, sm_count, split_workspace,
                      stream_plan, streams)

MODES = ("pl-bf16", "pl-astype", "pl-bits", "pl-magic")

# Kernel launches (one a rep) since the last reset_launches(), in all and
# by mode.
launches = 0
mode_launches = {m: 0 for m in MODES}


def reset_launches() -> None:
    global launches
    launches = 0
    for m in mode_launches:
        mode_launches[m] = 0


def _check(x: torch.Tensor, w: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if (x.ndim != 2 or w.ndim not in (2, 3) or x.shape[1] != w.shape[-2]):
        raise ValueError(f"linear needs x (M, K) and w ([R,] K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if mode == "pl-bf16":
        if w.dtype != torch.bfloat16:
            raise ValueError(f"pl-bf16 needs bf16 weights, got {w.dtype}")
    else:
        e4m3_bytes(w)


def weight_values(w: torch.Tensor, mode: str) -> torch.Tensor:
    """The weight as the mode's convert makes it, in bf16."""
    if mode == "pl-bf16":
        return w
    return convert(w, mode[3:])


def linear_plain(x: torch.Tensor, w: torch.Tensor, mode: str,
                 reps: int = 64) -> torch.Tensor:
    """The plain version of :func:`linear` (any device): x rounded to bf16,
    a full-f32 ``torch.matmul`` against the converted weight, rounded once
    to bf16.  With a rep dimension the last rep's weight gives the result,
    as the kernel's last launch writes it."""
    _check(x, w, mode)
    if w.ndim == 3:
        w = w[-1]
    xb = x.to(torch.bfloat16).to(torch.float32)
    with full_fp32():
        out = torch.matmul(xb, weight_values(w, mode).to(torch.float32))
    return out.to(torch.bfloat16)


def rep_weights(w: torch.Tensor, reps: int, cold: bool) -> torch.Tensor:
    """w with a leading rep dimension: a stride-0 view (warm) or ``reps``
    real copies (cold)."""
    wr = w.unsqueeze(0).expand(reps, *w.shape)
    return wr.contiguous() if cold else wr


@functools.cache
def _fn():
    fn = _build.load("fp8_linear_study").fp8_linear_study
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def linear(x: torch.Tensor, w: torch.Tensor, mode: str, reps: int = 64,
           cold: bool = False) -> torch.Tensor:
    """``x @ conv(w)`` in bf16, the kernel launched once for each of R reps
    of w.  w is one copy (made into R by :func:`rep_weights` with ``reps``
    and ``cold``) or already carries the rep dimension, whose stride the
    kernel follows.  The kernel on CUDA tensors, the plain version on the
    CPU."""
    global launches
    _check(x, w, mode)
    if w.ndim == 2:
        w = rep_weights(w, reps, cold)
    if not x.is_cuda:
        return linear_plain(x, w, mode)
    m, k = x.shape
    reps, n = w.shape[0], w.shape[2]
    check_gemm_shape("linear", m, n, k)
    wd = w if mode == "pl-bf16" else e4m3_bytes(w)
    xb = x.to(torch.bfloat16).contiguous()
    if not (wd[0].is_contiguous() and wd.stride(0) * wd.element_size() % 16
            == 0 and streams(m, n, k, xb, wd)):
        raise ValueError("linear takes K3's streaming kernel: M <= 64, "
                         "K % 8 == 0, N % 16 == 0, contiguous 16-byte "
                         "aligned operands")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    plan = stream_plan(m, n, k, sm_count(x.device.index or 0),
                       "bf16" if mode == "pl-bf16" else "w8")
    ws, counters = split_workspace(x.device, plan.splits, m, n)
    err = _fn()(xb.data_ptr(), wd.data_ptr(), out.data_ptr(), m, n, k,
                MODES.index(mode), reps, wd.stride(0) * wd.element_size(),
                plan.mt, plan.splits, plan.kper,
                ws.data_ptr() if ws is not None else None,
                counters.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"fp8_linear_study kernel ({mode})")
    launches += reps
    mode_launches[mode] += reps
    return out
