"""K1, the cast kernel (``csrc/cast_kernel.cu``): its wrapper, launch count
and plain version.

Replaces ``fp8tpu/kernels/cast_kernel.py::_kernel_body``.  Every
``fake_quant`` and ``qdq`` call on a CUDA tensor is one launch of it (on
its block route where SR bits hash the global indices of a column or
sequence block of a split tensor, ``fp8_cast_block``).  The
plain version is :func:`fp8tpu_torch.numerics.cast.qdq_plain`, which the
wrapper never calls: a CUDA tensor launches the kernel or raises.

The wrapper picks the kernel's path up front (:func:`vector_path`): 16-byte
accesses where ``x``, the output and the bits are 16-byte aligned and the
tensor has fewer than 2^31 elements, else one element a thread.  With the
scale given as a CUDA tensor a call synchronises nothing and allocates only
its output, so it can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fp8tpu_torch.numerics.cast import require_hash_stream
from fp8tpu_torch.numerics.formats import RoundMode

from . import _build

FMT_IDS = {"e5m2": 0, "e4m3": 1, "e4m3_ieee": 2, "e3m4": 3, "fp4": 4,
           "bfloat16": 5, "float16": 6, "e5m2_noinf": 7, "e5m2_flex": 8,
           "e4m3_v2": 9}
MODE_IDS = {RoundMode.RNE: 0, RoundMode.STOCHASTIC: 1, RoundMode.RNAZ: 2,
            RoundMode.RNTZ: 3, RoundMode.RPINF: 4, RoundMode.RNINF: 5,
            RoundMode.RTZ: 6}

# Launches of the kernel since the last reset_launches(), and of them
# those of its block route.
launches = 0
block_launches = 0


def reset_launches() -> None:
    global launches, block_launches
    launches = 0
    block_launches = 0


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


def vector_path(n: int, ptrs, inner: int = 1, nscale: int = 1) -> bool:
    """Whether the kernel takes its 16-byte path: every pointer in ``ptrs``
    (None for an absent tensor) 16-byte aligned, and n, inner and nscale
    below 2^31 (32-bit indices)."""
    return (max(n, inner, nscale) < 2 ** 31
            and all(p is None or p % 16 == 0 for p in ptrs))


_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
         ctypes.c_void_p]


@functools.cache
def _fn():
    lib = _build.load("cast_kernel")
    fn = lib.fp8_cast
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _block_fn():
    fn = _build.load("cast_kernel").fp8_cast_block
    fn.argtypes = _ARGS[:-1] + [ctypes.c_longlong * 7, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_args(block, shape):
    """The block route's 7 arguments for a ``parallel.data.Block`` of a
    tensor of ``shape``: its runs (``Block.segments``, at most three)
    padded to three, as (L1, L2, G1, G2, s0, s1, s2), the global extents
    and starts mod 2^32 (the hash takes a 32-bit index, and the index's
    sums and products wrap alike).  Raises on more than three runs (a
    tensor split over data, seq and model with a leading unsplit
    dimension cannot arise: data splits dimension 0)."""
    runs = block.segments(shape)
    if len(runs) > 3:
        raise ValueError(f"a block of {len(runs)} runs; K1 takes three")
    runs = [(1, 1, 0)] * (3 - len(runs)) + list(runs)
    (_, _, s0), (l1, g1, s1), (l2, g2, s2) = runs
    m = 0xFFFFFFFF
    return (l1, l2, g1 & m, g2 & m, s0 & m, s1 & m, s2 & m)


def cuda_qdq(x: torch.Tensor, fmt_name: str, mode: RoundMode = RoundMode.RNE,
             scale=1.0, daz: bool = False,
             random_bits: Optional[torch.Tensor] = None,
             salt: Optional[int] = None, block_size: int = 0,
             block=None) -> torch.Tensor:
    """One launch of K1 on a CUDA tensor; the arguments of
    :func:`~fp8tpu_torch.numerics.cast.qdq_plain`.  With ``block`` the
    kernel's block route: it hashes each element's global index, which it
    computes from the block's runs (:func:`block_args`).  Float32 result
    of ``x``'s shape."""
    global launches, block_launches
    if salt is not None and random_bits is None:
        require_hash_stream("cast kernel")
    if not x.is_cuda:
        raise ValueError("cuda_qdq takes a CUDA tensor")
    if block_size < 0:
        raise ValueError(f"block_size {block_size} < 0")
    if block is not None and (salt is None or random_bits is not None
                              or block_size):
        raise ValueError("the block route hashes its bits from a salt, "
                         "with no per-block scales")
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
    rptr = rbits.data_ptr() if rbits is not None else None
    vec = vector_path(xf.numel(), (xf.data_ptr(), y.data_ptr(), rptr),
                      inner, nscale)
    args = (code, xf.data_ptr(), y.data_ptr(), xf.numel(), scales.data_ptr(),
            inner, nscale, block_size, rptr, rb_mode,
            (salt or 0) & 0xFFFFFFFF, int(vec))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if block is None:
        err = _fn()(*args, stream)
    else:
        err = _block_fn()(*args, (ctypes.c_longlong * 7)(
            *block_args(block, x.shape)), stream)
        block_launches += 1
    _build.check(err, f"cast kernel ({fmt_name}, {mode.value})")
    launches += 1
    return y
