"""K2, the fused fake-quant GEMM (``csrc/qmatmul.cu``), and K3, the serving
dequant-GEMM (``csrc/dequant_matmul.cu``): wrappers, launch counts and
plain versions.

K2 replaces ``fp8tpu/kernels/qmatmul.py::_qdq_matmul_kernel``:
``qdq(x; sx) @ qdq(w; sw[N])`` in IEEE f32 with f32 accumulation, each
operand cast by the bit pipeline (``impl="bitexact"``) or the
hardware-convert route (``impl="hw"``: ``hw_qdq`` / ``hw_sr`` for e4m3,
e5m2 and bfloat16, the bit pipeline for every other format, float16
included), rounding to nearest or stochastically.  Stochastic operands
take the bits of the JAX package's CPU route (``_qdq_matmul_jnp``): the
counter hash salted by ``fold_in(fold_in(key(0), seed), tag)``, tag 1
for x and 2 for w, over the operand's row-major index.  Every
hw-patched contraction on a CUDA tensor, forward and backward, is one
launch.  The plain version, :func:`plain`, casts both operands with the
plain casts and multiplies with ``torch.matmul`` in full f32; the wrapper
uses it only for tensors on the CPU.

With ``impl="hw"`` and both operands on formats of at most 7 mantissa
bits the JAX package leaves Pallas (``_hw_xla_ok``): each operand is cast
once onto its scaled grid, exact in bf16, the two are contracted with
f32 accumulation and the product is descaled.  :func:`qdq_matmul` does
the same with plain casts and a full-f32 ``torch.matmul`` on every
device: that route has no kernel to port.

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
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.numerics.cast import (_flush, _mul, cast_array, hw_qdq,
                                        hw_sr, sr_bits_from_salt)
from fp8tpu_torch.numerics.formats import FORMATS, RoundMode

from . import _build
from .cast_kernel import FMT_IDS, variant_code

# Launches of K2 and of K3 since the last reset_launches(); K2's also by
# variant: "bitexact" and "hw" casts, or "uncast" (neither operand cast).
launches = 0
k2_launches = {"bitexact": 0, "hw": 0, "uncast": 0}
dequant_launches = 0

_MAX_ROWS = 65535 * 64  # grid.y limit times the 64-row tile
IMPLS = ("bitexact", "hw")
# Formats that K2's "hw" route converts natively; others take the bit
# pipeline (``fp8tpu/kernels/qmatmul.py::_HW_KERNEL_FMTS``).
HW_KERNEL_FMTS = ("e4m3", "e5m2", "bfloat16")


def reset_launches() -> None:
    global launches, dequant_launches
    launches = 0
    dequant_launches = 0
    for variant in k2_launches:
        k2_launches[variant] = 0


def _scales(x, w, scale_x, scale_w):
    sx = torch.as_tensor(scale_x, dtype=torch.float32,
                         device=x.device).reshape(-1)[:1]
    sw = (torch.as_tensor(scale_w, dtype=torch.float32, device=x.device)
          * torch.ones(w.shape[1], dtype=torch.float32, device=x.device))
    return sx.contiguous(), sw.reshape(-1).contiguous()


def _check(x, w, impl):
    if impl not in IMPLS:
        raise ValueError(f"qdq_matmul impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"qdq_matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")


def _hw_xla_ok(fmt_x, fmt_w) -> bool:
    """Whether ``impl="hw"`` takes the route outside the kernel: both
    operands quantized to formats with at most 7 mantissa bits, whose
    scaled grid values are exact in bf16."""
    return (fmt_x is not None and fmt_w is not None
            and FORMATS[fmt_x].mant_bits <= 7
            and FORMATS[fmt_w].mant_bits <= 7)


def sr_salt(seed: int, tag: int, fmt: Optional[str],
            mode: RoundMode) -> Optional[int]:
    """The SR salt of a stochastic operand (tag 1 for x, 2 for w); None
    when the operand is uncast or rounds to nearest."""
    if fmt is None or mode != RoundMode.STOCHASTIC:
        return None
    return prng.salt_of(prng.fold_in(prng.fold_in(prng.key(0), seed), tag))


def cast_operand(v, fmt, mode, scale, impl, salt, descale=True):
    """One operand through the plain casts: K2's in-kernel cast
    (``descale=False`` gives the "hw" route's scaled grid values)."""
    rb = None if salt is None else sr_bits_from_salt(
        salt, v.numel(), v.device)[:v.numel()].reshape(v.shape)
    if impl == "hw" and fmt in HW_KERNEL_FMTS:
        if mode == RoundMode.STOCHASTIC:
            return hw_sr(v, fmt, scale, rb, descale)
        return hw_qdq(v, fmt, scale, descale)
    out = cast_array(v, scale, rb, fmt, mode)
    return out if descale else _mul(out, scale)


def plain(x, w, fmt_x: Optional[str] = "e4m3",
          mode_x: RoundMode = RoundMode.RNE, fmt_w: Optional[str] = "e4m3",
          mode_w: RoundMode = RoundMode.RNE, scale_x=1.0, scale_w=1.0,
          seed: int = 0, impl: str = "bitexact"):
    """The plain version of K2 (any device): plain casts, then a full-f32
    ``torch.matmul``."""
    sx, sw = _scales(x, w, scale_x, scale_w)
    xq = x.to(torch.float32)
    wq = w.to(torch.float32)
    if fmt_x is not None:
        xq = cast_operand(xq, fmt_x, mode_x, sx[0], impl,
                          sr_salt(seed, 1, fmt_x, mode_x))
    if fmt_w is not None:
        wq = cast_operand(wq, fmt_w, mode_w, sw.reshape(1, -1), impl,
                          sr_salt(seed, 2, fmt_w, mode_w))
    with full_fp32():
        return torch.matmul(xq, wq)


def _hw_grid_matmul(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w,
                    seed):
    """The "hw" route outside the kernel: each operand cast once onto its
    scaled grid and rounded to bf16 (exact), an f32 contraction of the
    bf16 values (``torch.matmul`` on bf16 tensors would round its result
    to bf16), the descale last."""
    sx, sw = _scales(x, w, scale_x, scale_w)
    sw = sw.reshape(1, -1)
    xg = cast_operand(x.to(torch.float32), fmt_x, mode_x, sx[0], "hw",
                      sr_salt(seed, 1, fmt_x, mode_x), descale=False)
    wg = cast_operand(w.to(device=x.device, dtype=torch.float32), fmt_w,
                      mode_w, sw, "hw", sr_salt(seed, 2, fmt_w, mode_w),
                      descale=False)
    with full_fp32():
        out = torch.matmul(xg.to(torch.bfloat16).to(torch.float32),
                           wg.to(torch.bfloat16).to(torch.float32))
    return _flush(out / _flush(_mul(sx[0], sw)))


@functools.cache
def _fn():
    fn = _build.load("qmatmul").fp8_qdq_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _operand_code(fmt, mode, impl) -> int:
    """The kernel's cast variant for an operand: -1 uncast; the hw route's
    codes (``cast.cuh::hw_code``) for its formats under ``impl="hw"``,
    where every mode but SR rounds to nearest, as the JAX kernel does;
    the bit pipeline's (``variant_code``) otherwise."""
    if fmt is None:
        return -1
    if impl == "hw" and fmt in HW_KERNEL_FMTS:
        return 0x100 | (FMT_IDS[fmt] << 4) \
            | (2 if mode == RoundMode.STOCHASTIC else 0)
    return variant_code(fmt, mode)


def _launch(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w, seed=0,
            impl="bitexact", unsplit: bool = False):
    """One K2 launch.  ``unsplit`` keeps K whole where :func:`k2_split`
    would split it (a measurement of the kernel without split-K)."""
    global launches
    m, k = x.shape
    n = w.shape[1]
    if m > _MAX_ROWS or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"qdq_matmul shape ({m}, {k}) @ ({k}, {n}) exceeds "
                         "the kernel's grid")
    xf = x.to(torch.float32).contiguous()
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    sx, sw = _scales(xf, wf, scale_x, scale_w)
    splits, kper = k2_split(m, n, k, sm_count(x.device.index or 0),
                            unsplit)
    ws, counters = split_workspace(x.device, splits, m, n)
    salts = [sr_salt(seed, 1, fmt_x, mode_x), sr_salt(seed, 2, fmt_w, mode_w)]
    salt_x, salt_w = (-1 if s is None else s for s in salts)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _fn()(xf.data_ptr(), wf.data_ptr(), out.data_ptr(), m, n, k,
                _operand_code(fmt_x, mode_x, impl), sx.data_ptr(), salt_x,
                _operand_code(fmt_w, mode_w, impl), sw.data_ptr(), salt_w,
                splits, kper, ws.data_ptr() if ws is not None else None,
                counters.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "qdq_matmul kernel")
    launches += 1
    k2_launches["uncast" if fmt_x is None and fmt_w is None else impl] += 1
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
    seed: int = 0,
    out_dtype=torch.float32,
    impl: str = "bitexact",
) -> torch.Tensor:
    """Fused fake-quant matmul ``qdq(x) @ qdq(w)``.  ``scale_x`` is one
    per-tensor scale, ``scale_w`` a scalar or one scale per output column
    (N,); scales may be CUDA tensors (no host sync).  A ``fmt`` of None
    leaves that operand uncast.  ``seed`` keys stochastic operands.  K2 on
    a CUDA tensor, the plain version on the CPU; ``impl="hw"`` with two
    operands of at most 7 mantissa bits takes the route outside the
    kernel (see the module docstring)."""
    _check(x, w, impl)
    args = (x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w, seed)
    if impl == "hw" and _hw_xla_ok(fmt_x, fmt_w):
        out = _hw_grid_matmul(*args)
    elif x.is_cuda:
        out = _launch(*args, impl=impl)
    else:
        out = plain(*args, impl=impl)
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


def plan_splits(tiles: int, k: int, sms: int, cap: int, min_rows: int,
                slab: int):
    """(splits, K rows per split) for a launch of ``tiles`` output tiles
    whose blocks may share a tile's K range (``split_k.cuh``): split when
    the tiles alone give fewer than about two blocks per SM, at most
    ``cap`` ways, at least ``min_rows`` rows a split, rows a multiple of
    the kernel's K slab.  Never more tiles than tile counters."""
    splits = 1 if not 0 < tiles <= _N_COUNTERS else max(
        1, min(cap, (2 * sms + tiles // 2) // tiles, k // min_rows))
    kper = max(slab, -(-k // (splits * slab)) * slab)
    return max(1, -(-k // kper)), kper


def k2_split(m: int, n: int, k: int, sms: int, unsplit: bool = False):
    """K2's split of K over its 64x64 tiles (split launches take that
    tile): up to 64 ways, at least 512 rows a split, as the backward's
    weight gradient needs (576 x 64 outputs over K = 100352 at ResNet-50's
    first stage)."""
    tiles = -(-m // 64) * -(-n // 64)
    return plan_splits(tiles, k, sms, 1 if unsplit else 64, 512, 16)


def split_k(m: int, n: int, k: int, sms: int, stream: bool = False,
            bk: int = 64):
    """(splits, K rows per split) for the weight-GEMM kernels (K3, K5): at
    most 8 ways, at least 256 rows a split.  The streaming kernel's tiles
    are 128 columns wide, the general kernel's 64."""
    if stream:
        tiles = -(-n // 128)
    else:
        bm = 16 if m <= 16 else 64 if m <= 64 else 128
        tiles = -(-n // 64) * -(-m // bm)
    return plan_splits(tiles, k, sms, 8, 256, bk)


_COUNTERS = {}
_N_COUNTERS = 4096


def split_workspace(device, splits: int, m: int, n: int):
    """(partials, tile counters) for a split-K launch on ``device``.  The
    counters are zero between launches (the kernel resets them), so one
    tensor per device serves every launch on its stream."""
    counters = _COUNTERS.get(device)
    if counters is None:
        counters = _COUNTERS[device] = torch.zeros(
            _N_COUNTERS, dtype=torch.int32, device=device)
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
