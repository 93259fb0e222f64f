"""K2, the fused fake-quant GEMM (``csrc/qmatmul.cu``), and K3, the serving
dequant-GEMM (``csrc/dequant_matmul.cu``): wrappers, launch counts and
plain versions.

Replaces ``fp8tpu/kernels/qmatmul.py::_qdq_matmul_kernel`` with
``impl="bitexact"``: ``qdq(x; sx) @ qdq(w; sw[N])`` in IEEE f32 with f32
accumulation.  Every hw-patched contraction on a CUDA tensor is one launch.
The plain version, :func:`plain`, casts both operands with the plain cast
and multiplies with ``torch.matmul`` in full f32; the wrapper uses it only
for tensors on the CPU.

Not yet ported (FP8 training): ``impl="hw"`` and stochastic rounding of
the operands; both raise NotImplementedError.

K3 replaces ``fp8tpu/kernels/qmatmul.py::_dequant_matmul_kernel``:
``(x @ upcast(w8)) * s[N]`` with the payload upcast to bf16 in registers,
f32 accumulation, the per-output-channel scale in the epilogue and one
rounding to ``out_dtype``.  Every serving linear on a CUDA tensor is one
launch of it.  :func:`quantize_weights` makes its payloads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.numerics.cast import cast_array
from fp8tpu_torch.numerics.formats import FORMATS, RoundMode

from . import _build
from .cast_kernel import variant_code

# Launches of K2 and of K3 since the last reset_launches().
launches = 0
dequant_launches = 0

_MAX_ROWS = 65535 * 64  # grid.y limit times the 64-row tile


def reset_launches() -> None:
    global launches, dequant_launches
    launches = 0
    dequant_launches = 0


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


# -- K3: serving dequant-GEMM ---------------------------------------------------

FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
_PAYLOAD_IDS = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1, torch.int8: 2}


def div_exact(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` as one correctly rounded division on every device (with a
    Python scalar divisor torch multiplies by the reciprocal on CUDA)."""
    return a / torch.full_like(a, c)


def quantize_weights(w: torch.Tensor, fmt: str = "e4m3", axis: int = -1):
    """Quantize a weight matrix to real fp8 (or int8) storage: ``(payload,
    scales)`` with f32 ``scales`` per slice of ``axis`` (kept as a size-1
    broadcastable shape), such that ``w ~ payload.float() * scales``.
    Clamp, then IEEE RNE convert: the clip keeps the convert from
    saturating or overflowing."""
    wf = w.to(torch.float32)
    ax = axis % w.ndim
    reduce_axes = [i for i in range(w.ndim) if i != ax]
    amax = wf.abs().amax(dim=reduce_axes, keepdim=True) if reduce_axes \
        else wf.abs()
    one = torch.ones_like(amax)
    if fmt == "int8":
        scales = torch.where(amax > 0, div_exact(amax, 127.0), one)
        q = torch.clip(torch.round(wf / scales), -127, 127)
        return q.to(torch.int8), scales
    if fmt not in FP8_DTYPES:
        raise ValueError(f"no hardware dtype for {fmt!r}; serve with e4m3, "
                         "e5m2 or int8 (e3m4/fp4 use the emulation path)")
    top = FORMATS[fmt].max_normal
    scales = torch.where(amax > 0, div_exact(amax, top), one)
    q = torch.clip(wf / scales, -top, top)
    return q.to(FP8_DTYPES[fmt]), scales


def _check_dequant(x, w8, scales, out_dtype):
    if x.ndim != 2 or w8.ndim != 2 or x.shape[1] != w8.shape[0]:
        raise ValueError(f"dequant_matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w8.shape)}")
    if w8.dtype not in _PAYLOAD_IDS:
        raise ValueError(f"dequant_matmul payload must be e4m3, e5m2 or "
                         f"int8, got {w8.dtype}")
    if scales.numel() != w8.shape[1]:
        raise ValueError(f"dequant_matmul needs one scale per output column "
                         f"({w8.shape[1]}), got {tuple(scales.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_matmul out_dtype must be bf16 or f32, got "
                         f"{out_dtype}")


def dequant_matmul_plain(x, w8, scales, out_dtype=torch.bfloat16):
    """The plain version of K3 (any device): x rounded to bf16, an f32
    contraction against the upcast payload, the scale in f32, one rounding
    to ``out_dtype``."""
    _check_dequant(x, w8, scales, out_dtype)
    xb = x.to(torch.bfloat16).to(torch.float32)
    with full_fp32():
        out = torch.matmul(xb, w8.to(torch.float32))
    return (out * scales.reshape(1, -1).to(torch.float32)).to(out_dtype)


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def streams(m: int, n: int, k: int, *tensors: torch.Tensor) -> bool:
    """Whether a weight GEMM takes the streaming kernel (the decode form:
    cp.async stages, 128-column tiles): at most 64 rows, and every operand
    readable in 16-byte pieces."""
    return (m <= 64 and k % 8 == 0 and n % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def split_k(m: int, n: int, k: int, sms: int, stream: bool = False,
            bk: int = 64):
    """(splits, K rows per split) for the weight-GEMM kernels: split K when
    the output has fewer tiles than about two per SM, at most 8 ways, at
    least 256 rows a split, rows a multiple of the kernel's K slab.  The
    streaming kernel's tiles are 128 columns wide, the general kernel's
    64."""
    if stream:
        tiles = -(-n // 128)
    else:
        bm = 16 if m <= 16 else 64 if m <= 64 else 128
        tiles = -(-n // 64) * -(-m // bm)
    splits = max(1, min(8, (2 * sms + tiles // 2) // tiles, k // 256))
    kper = -(-k // (splits * bk)) * bk
    return -(-k // kper), kper


_COUNTERS = {}


def split_workspace(device, splits: int, m: int, n: int):
    """(partials, tile counters) for a split-K launch on ``device``.  The
    counters are zero between launches (the kernel resets them), so one
    tensor per device serves every launch on its stream."""
    counters = _COUNTERS.get(device)
    if counters is None:
        counters = _COUNTERS[device] = torch.zeros(
            4096, dtype=torch.int32, device=device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=device) \
        if splits > 1 else None
    return ws, counters


@functools.cache
def _dequant_fn():
    fn = _build.load("dequant_matmul").fp8_dequant_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def check_gemm_shape(what: str, m: int, n: int, k: int) -> None:
    if m > 65535 * 128 or max(m, n, k) >= 2 ** 31 or min(m, n, k) < 1:
        raise ValueError(f"{what} shape ({m}, {k}) @ ({k}, {n}) is outside "
                         "the kernel's grid")


def dequant_matmul(x: torch.Tensor, w8: torch.Tensor, scales: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ dequant(w8)``: x (M, K) bf16 or f32 (rounded to bf16), w8 (K, N)
    e4m3 / e5m2 / int8 from :func:`quantize_weights`, ``scales`` one f32
    per output column.  K3 on a CUDA tensor, the plain version on the
    CPU."""
    global dequant_launches
    if not x.is_cuda:
        return dequant_matmul_plain(x, w8, scales, out_dtype)
    _check_dequant(x, w8, scales, out_dtype)
    m, k = x.shape
    n = w8.shape[1]
    check_gemm_shape("dequant_matmul", m, n, k)
    xb = x.to(torch.bfloat16).contiguous()
    w8 = w8.contiguous()
    s = scales.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    stream = streams(m, n, k, xb, w8)
    splits, kper = split_k(m, n, k, sm_count(x.device.index or 0), stream)
    ws, counters = split_workspace(x.device, splits, m, n)
    err = _dequant_fn()(
        xb.data_ptr(), w8.data_ptr(), s.data_ptr(), out.data_ptr(), m, n, k,
        _PAYLOAD_IDS[w8.dtype], int(out_dtype == torch.float32), splits, kper,
        int(stream), ws.data_ptr() if ws is not None else None,
        counters.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dequant_matmul kernel")
    dequant_launches += 1
    return out
