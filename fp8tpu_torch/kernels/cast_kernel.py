"""K1, the cast kernel (``csrc/cast_kernel.cu``): its wrapper, launch count
and plain version.

Replaces ``fp8tpu/kernels/cast_kernel.py::_kernel_body``.  Every
``fake_quant`` and ``qdq`` call on a CUDA tensor is one launch of it.  The
plain version is :func:`fp8tpu_torch.numerics.cast.qdq_plain`, which the
wrapper never calls: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fp8tpu_torch.numerics.formats import RoundMode

from . import _build

FMT_IDS = {"e5m2": 0, "e4m3": 1, "e4m3_ieee": 2, "e3m4": 3, "fp4": 4,
           "bfloat16": 5, "float16": 6, "e5m2_noinf": 7, "e5m2_flex": 8,
           "e4m3_v2": 9}
MODE_IDS = {RoundMode.RNE: 0, RoundMode.STOCHASTIC: 1, RoundMode.RNAZ: 2,
            RoundMode.RNTZ: 3, RoundMode.RPINF: 4, RoundMode.RNINF: 5,
            RoundMode.RTZ: 6}

# Launches of the kernel since the last reset_launches().
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def variant_code(fmt_name: str, mode: RoundMode, daz: bool = False) -> int:
    """The kernel's template instance for (format, mode, daz), with the
    arguments a format ignores normalised away (``fp8::code_of``)."""
    if fmt_name not in FMT_IDS:
        raise ValueError(f"unknown format {fmt_name}")
    if fmt_name == "fp4":
        mode, daz = RoundMode.RNE, False
    elif fmt_name == "bfloat16":
        daz = False
        if mode != RoundMode.STOCHASTIC:
            mode = RoundMode.RNE
    elif fmt_name == "float16":
        if mode != RoundMode.RNE:
            mode, daz = RoundMode.STOCHASTIC, False
    elif fmt_name in ("e5m2_noinf", "e5m2_flex"):
        if mode != RoundMode.RNE:
            raise ValueError(f"{fmt_name} implements RNE only")
        daz = False
    elif fmt_name != "e5m2":
        daz = False
    if mode not in MODE_IDS:
        raise ValueError(f"not a nearest mode: {mode}")
    return FMT_IDS[fmt_name] * 16 + MODE_IDS[mode] * 2 + int(daz)


def scale_layout(scale, x: torch.Tensor):
    """(flat f32 scales on x's device, inner, nscale) such that element i of
    ``x`` reads ``scales[(i // inner) % nscale]``.  A scale broadcast along
    one run of axes is passed as it is; any other broadcast is expanded."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if s.numel() == 1:
        return s.reshape(1).contiguous(), 1, 1
    if s.ndim > x.ndim:
        raise ValueError(f"scale {tuple(s.shape)} does not broadcast to "
                         f"{tuple(x.shape)}")
    shape = [1] * (x.ndim - s.ndim) + list(s.shape)
    dims = [i for i, d in enumerate(shape) if d != 1]
    lo, hi = dims[0], dims[-1] + 1
    if all(shape[i] == x.shape[i] for i in range(lo, hi)):
        inner = 1
        for d in x.shape[hi:]:
            inner *= d
        return s.reshape(-1).contiguous(), inner, s.numel()
    full = s.reshape(shape).expand(x.shape).contiguous().reshape(-1)
    return full, 1, full.numel()


@functools.cache
def _fn():
    lib = _build.load("cast_kernel")
    fn = lib.fp8_cast
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_qdq(x: torch.Tensor, fmt_name: str, mode: RoundMode = RoundMode.RNE,
             scale=1.0, daz: bool = False,
             random_bits: Optional[torch.Tensor] = None,
             salt: Optional[int] = None, block_size: int = 0) -> torch.Tensor:
    """One launch of K1 on a CUDA tensor; the arguments of
    :func:`~fp8tpu_torch.numerics.cast.qdq_plain`.  Float32 result of
    ``x``'s shape."""
    global launches
    if not x.is_cuda:
        raise ValueError("cuda_qdq takes a CUDA tensor")
    if block_size < 0:
        raise ValueError(f"block_size {block_size} < 0")
    code = variant_code(fmt_name, mode, daz)
    xf = x.to(torch.float32).contiguous()
    y = torch.empty_like(xf)
    scales, inner, nscale = scale_layout(scale, xf)
    rbits, rb_mode = None, 0
    if random_bits is not None:
        rbits = torch.broadcast_to(
            random_bits.to(device=x.device, dtype=torch.int32),
            x.shape).contiguous()
        rb_mode = 1
    elif salt is not None:
        rb_mode = 2
    err = _fn()(code, xf.data_ptr(), y.data_ptr(), xf.numel(),
                scales.data_ptr(), inner, nscale, block_size,
                rbits.data_ptr() if rbits is not None else None, rb_mode,
                (salt or 0) & 0xFFFFFFFF,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"cast kernel ({fmt_name}, {mode.value})")
    launches += 1
    return y
