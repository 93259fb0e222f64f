"""K2, the fused fake-quant GEMM (``csrc/qmatmul.cu``): its wrapper, launch
count and plain version.

Replaces ``fp8tpu/kernels/qmatmul.py::_qdq_matmul_kernel`` with
``impl="bitexact"``: ``qdq(x; sx) @ qdq(w; sw[N])`` in IEEE f32 with f32
accumulation.  Every hw-patched contraction on a CUDA tensor is one launch.
The plain version, :func:`plain`, casts both operands with the plain cast
and multiplies with ``torch.matmul`` in full f32; the wrapper uses it only
for tensors on the CPU.

Not yet ported (FP8 training): ``impl="hw"`` and stochastic rounding of
the operands; both raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.numerics.cast import cast_array
from fp8tpu_torch.numerics.formats import RoundMode

from . import _build
from .cast_kernel import variant_code

# Launches of the kernel since the last reset_launches().
launches = 0

_MAX_ROWS = 65535 * 64  # grid.y limit times the 64-row tile


def reset_launches() -> None:
    global launches
    launches = 0


def _scales(x, w, scale_x, scale_w):
    sx = torch.as_tensor(scale_x, dtype=torch.float32,
                         device=x.device).reshape(-1)[:1]
    sw = (torch.as_tensor(scale_w, dtype=torch.float32, device=x.device)
          * torch.ones(w.shape[1], dtype=torch.float32, device=x.device))
    return sx.contiguous(), sw.reshape(-1).contiguous()


def _check(x, w, fmt_x, mode_x, fmt_w, mode_w, impl):
    if impl != "bitexact":
        raise NotImplementedError(
            f"qdq_matmul impl={impl!r} is ported with FP8 training")
    for fmt, mode in ((fmt_x, mode_x), (fmt_w, mode_w)):
        if fmt is not None and mode == RoundMode.STOCHASTIC:
            raise NotImplementedError(
                "stochastic operand rounding in qdq_matmul is ported with "
                "FP8 training")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"qdq_matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")


def plain(x, w, fmt_x: Optional[str] = "e4m3",
          mode_x: RoundMode = RoundMode.RNE, fmt_w: Optional[str] = "e4m3",
          mode_w: RoundMode = RoundMode.RNE, scale_x=1.0, scale_w=1.0):
    """The plain version of K2 (any device): plain casts, then a full-f32
    ``torch.matmul``."""
    sx, sw = _scales(x, w, scale_x, scale_w)
    xq = x.to(torch.float32)
    wq = w.to(torch.float32)
    if fmt_x is not None:
        xq = cast_array(xq, sx[0], None, fmt_x, mode_x)
    if fmt_w is not None:
        wq = cast_array(wq, sw.reshape(1, -1), None, fmt_w, mode_w)
    with full_fp32():
        return torch.matmul(xq, wq)


@functools.cache
def _fn():
    fn = _build.load("qmatmul").fp8_qdq_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w):
    global launches
    m, k = x.shape
    n = w.shape[1]
    if m > _MAX_ROWS or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"qdq_matmul shape ({m}, {k}) @ ({k}, {n}) exceeds "
                         "the kernel's grid")
    xf = x.to(torch.float32).contiguous()
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    sx, sw = _scales(xf, wf, scale_x, scale_w)
    code_x = -1 if fmt_x is None else variant_code(fmt_x, mode_x)
    code_w = -1 if fmt_w is None else variant_code(fmt_w, mode_w)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _fn()(xf.data_ptr(), wf.data_ptr(), out.data_ptr(), m, n, k,
                code_x, sx.data_ptr(), code_w, sw.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qdq_matmul kernel")
    launches += 1
    return out


def qdq_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    fmt_x: Optional[str] = "e4m3",
    mode_x: RoundMode = RoundMode.RNE,
    fmt_w: Optional[str] = "e4m3",
    mode_w: RoundMode = RoundMode.RNE,
    scale_x=1.0,
    scale_w=1.0,
    out_dtype=torch.float32,
    impl: str = "bitexact",
) -> torch.Tensor:
    """Fused fake-quant matmul ``qdq(x) @ qdq(w)``.  ``scale_x`` is one
    per-tensor scale, ``scale_w`` a scalar or one scale per output column
    (N,); scales may be CUDA tensors (no host sync).  A ``fmt`` of None
    leaves that operand uncast.  K2 on a CUDA tensor, the plain version on
    the CPU."""
    _check(x, w, fmt_x, mode_x, fmt_w, mode_w, impl)
    if x.is_cuda:
        out = _launch(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w)
    else:
        out = plain(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w)
    return out.to(out_dtype)
