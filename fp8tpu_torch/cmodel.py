"""ctypes bindings for the native MXU C-model (native/cmodel.cpp): a copy
of ``fp8tpu/cmodel.py`` (numpy and ctypes only) that builds the library
into the port's own git-ignored directory, ``fp8tpu_torch/kernels/_build``.

The TPU-native successor of the reference's ``mpemu.cmodel.simple``
(simple_gemm.cpp / simple_conv2d.cpp pybind modules): a host-side C++
blocked GEMM/conv engine emulating the matrix unit's tile geometry —
here 128x128 with bf16 operand rounding and fp32 tile accumulation —
used for bit-level study of accumulation order and as a device-free
execution backend in tests.

Autograd parity with the reference's ``cmodel/simple.py`` (SimpleMatmul/
SimpleConv2dFunction): :func:`matmul` carries a custom backward that
issues two more engine GEMMs with transpose bookkeeping
(simple.py:124-146).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "cmodel.cpp")
_LIB_DIR = os.path.join(_REPO, "fp8tpu_torch", "kernels", "_build")
_LIB = os.path.join(_LIB_DIR, "libcmodel.so")

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile from source, keyed on a source hash (never ship or load a
    checked-in binary: the .so is untracked and rebuilt per checkout).
    The library and its hash stamp are written under temporary names and
    renamed into place, so processes building at once never load a
    half-written file."""
    import hashlib
    src_hash = hashlib.sha256(open(_SRC, "rb").read()).hexdigest()
    stamp = _LIB + ".hash"
    if (os.path.exists(_LIB) and not force and os.path.exists(stamp)
            and open(stamp).read() == src_hash):
        return _LIB
    os.makedirs(_LIB_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
         _SRC, "-o", tmp],
        check=True)
    os.replace(tmp, _LIB)
    with open(stamp + f".{os.getpid()}.tmp", "w") as f:
        f.write(src_hash)
    os.replace(stamp + f".{os.getpid()}.tmp", stamp)
    return _LIB


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fp = ctypes.POINTER(ctypes.c_float)
        lib.cmodel_gemm.restype = ctypes.c_int
        lib.cmodel_gemm.argtypes = [
            fp, fp, fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cmodel_conv2d_fp.restype = ctypes.c_int
        lib.cmodel_conv2d_fp.argtypes = [
            fp, fp, fp] + [ctypes.c_int64] * 9 + [ctypes.c_int]
        lib.cmodel_conv2d_bp.restype = ctypes.c_int
        lib.cmodel_conv2d_bp.argtypes = [
            fp, fp, fp] + [ctypes.c_int64] * 9 + [ctypes.c_int]
        lib.cmodel_conv2d_wu.restype = ctypes.c_int
        lib.cmodel_conv2d_wu.argtypes = [
            fp, fp, fp] + [ctypes.c_int64] * 9 + [ctypes.c_int]
        lib.cmodel_version.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def gemm(a: np.ndarray, b: np.ndarray, a_trans: bool = False,
         b_trans: bool = False, alpha: float = 1.0, beta: float = 0.0,
         c: Optional[np.ndarray] = None, tile: int = 128,
         kchunk: int = 0, round_bf16: bool = True) -> np.ndarray:
    """``alpha * op(a) @ op(b) + beta * c`` through the tile engine.

    ``round_bf16`` rounds operands to bf16 before the systolic array —
    the MXU's native behavior; pass False for an fp32 study.  ``kchunk``
    limits how much of K accumulates inside one tile pass (0 = all).
    """
    lib = load()
    af = np.ascontiguousarray(a, np.float32)
    bf = np.ascontiguousarray(b, np.float32)
    m = af.shape[1] if a_trans else af.shape[0]
    k = af.shape[0] if a_trans else af.shape[1]
    k2 = bf.shape[1] if b_trans else bf.shape[0]
    n = bf.shape[0] if b_trans else bf.shape[1]
    assert k == k2, (a.shape, b.shape)
    out = (np.ascontiguousarray(c, np.float32).copy()
           if c is not None else np.zeros((m, n), np.float32))
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.cmodel_gemm(
        af.ctypes.data_as(fp), bf.ctypes.data_as(fp),
        out.ctypes.data_as(fp), m, n, k, int(a_trans), int(b_trans),
        ctypes.c_float(alpha), ctypes.c_float(beta), tile, kchunk,
        int(round_bf16))
    if rc != 0:
        raise ValueError(f"cmodel_gemm failed rc={rc}")
    return out


def conv2d_fp(x: np.ndarray, w: np.ndarray, stride: int = 1,
              pad: int = 0, round_bf16: bool = True) -> np.ndarray:
    """NHWC conv2d forward: x (N,H,W,Cin), w (KH,KW,Cin,Cout)."""
    lib = load()
    xf = np.ascontiguousarray(x, np.float32)
    n, h, wd, cin = xf.shape
    kh, kw, cin2, cout = w.shape
    assert cin == cin2
    wf = np.ascontiguousarray(w.reshape(kh * kw * cin, cout), np.float32)
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (wd + 2 * pad - kw) // stride + 1
    out = np.zeros((n * oh * ow, cout), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.cmodel_conv2d_fp(
        xf.ctypes.data_as(fp), wf.ctypes.data_as(fp),
        out.ctypes.data_as(fp), n, h, wd, cin, kh, kw, cout, stride, pad,
        int(round_bf16))
    if rc != 0:
        raise ValueError(f"cmodel_conv2d_fp failed rc={rc}")
    return out.reshape(n, oh, ow, cout)


def matmul_vjp(a: np.ndarray, b: np.ndarray, g: np.ndarray,
               round_bf16: bool = True):
    """Backward of ``a @ b`` through the engine: two more GEMMs with
    transpose bookkeeping (cmodel/simple.py:124-146)."""
    da = gemm(g, b, b_trans=True, round_bf16=round_bf16)
    db = gemm(a, g, a_trans=True, round_bf16=round_bf16)
    return da, db


def conv2d_bp(dy: np.ndarray, w: np.ndarray, x_shape, stride: int = 1,
              pad: int = 0, round_bf16: bool = True) -> np.ndarray:
    """Conv2d backward-data through the engine: dy (N,OH,OW,Cout),
    w (KH,KW,Cin,Cout) -> dx (N,H,W,Cin).  Native analog of the
    reference's gemm_kernel_conv_bp (simple_conv2d_impl.cpp:472-572)."""
    lib = load()
    n, h, wd, cin = x_shape
    kh, kw, cin2, cout = w.shape
    assert cin == cin2
    dyf = np.ascontiguousarray(dy, np.float32)
    wf = np.ascontiguousarray(w.reshape(kh * kw * cin, cout), np.float32)
    dx = np.zeros((n, h, wd, cin), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.cmodel_conv2d_bp(
        dyf.ctypes.data_as(fp), wf.ctypes.data_as(fp),
        dx.ctypes.data_as(fp), n, h, wd, cin, kh, kw, cout, stride, pad,
        int(round_bf16))
    if rc != 0:
        raise ValueError(f"cmodel_conv2d_bp failed rc={rc}")
    return dx


def conv2d_wu(x: np.ndarray, dy: np.ndarray, ksize, stride: int = 1,
              pad: int = 0, round_bf16: bool = True) -> np.ndarray:
    """Conv2d backward-weight through the engine: x (N,H,W,Cin),
    dy (N,OH,OW,Cout) -> dw (KH,KW,Cin,Cout).  Native analog of
    gemm_kernel_conv_wu (simple_conv2d_impl.cpp:574-670)."""
    lib = load()
    xf = np.ascontiguousarray(x, np.float32)
    dyf = np.ascontiguousarray(dy, np.float32)
    n, h, wd, cin = xf.shape
    kh, kw = ksize
    cout = dyf.shape[-1]
    dw = np.zeros((kh * kw * cin, cout), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.cmodel_conv2d_wu(
        xf.ctypes.data_as(fp), dyf.ctypes.data_as(fp),
        dw.ctypes.data_as(fp), n, h, wd, cin, kh, kw, cout, stride, pad,
        int(round_bf16))
    if rc != 0:
        raise ValueError(f"cmodel_conv2d_wu failed rc={rc}")
    return dw.reshape(kh, kw, cin, cout)


def conv2d_vjp(x: np.ndarray, w: np.ndarray, g: np.ndarray,
               stride: int = 1, pad: int = 0, round_bf16: bool = True):
    """Backward of conv2d_fp through the engine: (dx, dw) — the same
    bp/wu pair the reference's SimpleConv2dFunction issues
    (cmodel/simple.py:202-216)."""
    dx = conv2d_bp(g, w, x.shape, stride, pad, round_bf16)
    dw = conv2d_wu(x, g, w.shape[:2], stride, pad, round_bf16)
    return dx, dw
