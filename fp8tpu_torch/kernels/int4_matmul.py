"""K5, the W4A16 unpack-GEMM (``csrc/int4_matmul.cu``): its wrapper, launch
count, plain version and the grouped int4 quantizer.

Replaces ``fp8tpu/kernels/int4_matmul.py::_int4_kernel``.  Packing: byte r
of a column of ``wp`` (K/2, N) holds ``w[2r]`` in the low nibble and
``w[2r + 1]`` in the high nibble, both signed.  Per-channel scales (N,)
apply in f32 in the epilogue; grouped scales (K/group, N) are rounded to
bf16 and multiplied into the unpacked weights in bf16 before the dot, and
that rounding is part of the function.  With ``weight_fmt="int4"`` every
serving linear on a CUDA tensor is one launch of the kernel, on the route
``qmatmul.weight_gemm_plan`` picks (the streaming loop's decode form or
prefill route, or the general kernel), as K3's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fp8tpu_torch._device import full_fp32

from . import _build
from .qmatmul import (check_gemm_shape, div_exact, flush_amax, sm_count,
                      split_workspace, weight_gemm_plan)

# Launches of the kernel since the last reset_launches(), in all and by
# route (as qmatmul.dequant_routes).
launches = 0
routes = {"stream": 0, "prefill": 0, "general": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    for key in routes:
        routes[key] = 0


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) integers in [-8, 7] -> (K/2, N) uint8, even rows in the low
    nibble."""
    q = q.to(torch.int32)
    return ((q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)).to(torch.uint8)


def unpack_int4(wp: torch.Tensor):
    """(K/2, N) uint8 -> the signed low- and high-nibble planes, int32."""
    w = wp.to(torch.int32)
    lo = (w & 0xF) - ((w & 0x8) << 1)
    hi = (w >> 4) - ((w & 0x80) >> 3)
    return lo, hi


def quantize_weights_int4_grouped(w: torch.Tensor, group_size: int = 128):
    """AWQ-class grouped int4 quantization: one scale per (K-group, output
    channel).  Returns (packed (K/2, N) uint8, scales (K/group_size, N)
    f32)."""
    k, n = w.shape
    if k % group_size or group_size % 2:
        raise ValueError(f"K={k} must be a multiple of an even group_size "
                         f"(got {group_size})")
    wf = w.to(torch.float32).reshape(k // group_size, group_size, n)
    amax = flush_amax(wf.abs().amax(dim=1))
    s = torch.where(amax > 0, div_exact(amax, 7.0), torch.ones_like(amax))
    q = torch.clip(torch.round(wf / s[:, None]), -8, 7).reshape(k, n)
    return pack_int4(q), s


def _check(x, wp, scales, group_size, out_dtype):
    k2, n = wp.shape
    if wp.dtype != torch.uint8 or wp.ndim != 2:
        raise ValueError("int4_matmul takes a (K/2, N) uint8 packed weight")
    if x.shape[-1] != 2 * k2:
        raise ValueError(f"int4_matmul: x has K={x.shape[-1]}, the packed "
                         f"weight {2 * k2}")
    if group_size:
        if group_size % 2 or (2 * k2) % group_size \
                or tuple(scales.shape) != (2 * k2 // group_size, n):
            raise ValueError(
                f"grouped scales must be (K/group_size, N) with an even "
                f"group_size dividing K; got {tuple(scales.shape)}, "
                f"group_size={group_size}, K={2 * k2}")
    elif scales.numel() != n:
        raise ValueError(f"per-channel scales must have N={n} elements, got "
                         f"{tuple(scales.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int4_matmul out_dtype must be bf16 or f32, got "
                         f"{out_dtype}")


def int4_matmul_plain(x, wp, scales, group_size: Optional[int] = None,
                      out_dtype=torch.bfloat16):
    """The plain version of K5 (any device): nibble planes in bf16, grouped
    scales multiplied in bf16, two f32 half-contractions against the even
    and odd columns of x (rounded to bf16)."""
    _check(x, wp, scales, group_size, out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    lo, hi = (p.to(torch.bfloat16) for p in unpack_int4(wp))
    if group_size:
        s = scales.to(torch.bfloat16).repeat_interleave(group_size // 2, dim=0)
        lo, hi = lo * s, hi * s
    with full_fp32():
        out = (torch.matmul(x2[:, 0::2].float(), lo.float())
               + torch.matmul(x2[:, 1::2].float(), hi.float()))
    if not group_size:
        out = out * scales.reshape(1, -1).to(torch.float32)
    return out.to(out_dtype).reshape(*lead, wp.shape[1])


@functools.cache
def _fn():
    fn = _build.load("int4_matmul").fp8_int4_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def int4_matmul(x: torch.Tensor, wp: torch.Tensor, scales: torch.Tensor,
                group_size: Optional[int] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ dequant_int4(wp)`` reading the packed buffer once.  x (..., K)
    bf16 or f32 (rounded to bf16); ``scales`` (N,) per channel or
    (K/group_size, N) with ``group_size`` set.  K5 on a CUDA tensor, the
    plain version on the CPU."""
    global launches
    if not x.is_cuda:
        return int4_matmul_plain(x, wp, scales, group_size, out_dtype)
    _check(x, wp, scales, group_size, out_dtype)
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
    m, k = xb.shape
    n = wp.shape[1]
    check_gemm_shape("int4_matmul", m, n, k)
    wp = wp.contiguous()
    s = scales.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    plan = weight_gemm_plan(m, n, k, sm_count(x.device.index or 0), "int4",
                            xb, wp, s, group=group_size)
    ws, counters = split_workspace(x.device, plan.splits, m, n)
    err = _fn()(xb.data_ptr(), wp.data_ptr(), s.data_ptr(), out.data_ptr(),
                m, n, k, group_size or 0, int(out_dtype == torch.float32),
                plan.splits, plan.kper, plan.code,
                ws.data_ptr() if ws is not None else None,
                counters.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int4_matmul kernel")
    launches += 1
    routes[plan.route] += 1
    return out.reshape(*lead, n)
