"""ctypes bindings for the native C++ reference cast library
(``native/fpemu_ref.cpp``): a copy of the JAX package's
``numerics/native_ref.py`` (NumPy and ctypes only) that builds the library
into the port's own git-ignored directory, ``fp8tpu_torch/kernels/_build``.

The host-side analog of the reference's pytquant extension (pybind11
``fpemu_cpp.forward``, pytquant/cpp/fpemu_impl.cpp:2047-2050), bound with
ctypes and built on demand with the system compiler.  It is a third
implementation of the cast contract beside :mod:`.golden` and the plain
torch cast, for cross-checking without a device.

The build is atomic: under an exclusive ``fcntl`` lock on a file beside
the library, ``g++`` writes a temporary name that ``os.replace`` moves into
place, and the source hash stamp is written last the same way.  Processes
that build at once (pytest-xdist workers) wait for the first and never load
a half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "fpemu_ref.cpp")
_LIB_DIR = os.path.join(_REPO, "fp8tpu_torch", "kernels", "_build")
_LIB = os.path.join(_LIB_DIR, "libfpemu_ref.so")

_lib: Optional[ctypes.CDLL] = None


def _fresh(src_hash: str) -> bool:
    stamp = _LIB + ".hash"
    if not (os.path.exists(_LIB) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read() == src_hash


def _replace_with(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def build(force: bool = False) -> str:
    """Compile the shared library (g++ -O2), keyed on a source hash so a
    stale or foreign binary is never loaded; atomic under a lock."""
    with open(_SRC, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()
    if not force and _fresh(src_hash):
        return _LIB
    os.makedirs(_LIB_DIR, exist_ok=True)
    with open(_LIB + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if force or not _fresh(src_hash):
                _replace_with(_LIB, lambda tmp: subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
                     "-o", tmp], check=True))

                def stamp(tmp):
                    with open(tmp, "w") as f:
                        f.write(src_hash)
                _replace_with(_LIB + ".hash", stamp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return _LIB


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.fpemu_cast.restype = ctypes.c_int
        lib.fpemu_cast.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_float, ctypes.c_int,
            ctypes.c_int64, ctypes.c_uint64,
        ]
        lib.fpemu_version.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def cast(x: np.ndarray, mode: str, scale: float = 1.0,
         block_norm: bool = False, block_size: int = 1,
         seed: int = 0) -> np.ndarray:
    """Reference-ABI cast on the host (mode strings like ``E4M3_RNE``)."""
    lib = load()
    xf = np.ascontiguousarray(x, np.float32)
    # ABI guard (fpemu_forward, fpemu_impl.cpp:2013-2028): block_norm is
    # SILENTLY disabled when size is not a multiple of block_size —
    # mirrored by golden.cast_mode_string.
    if block_norm and block_size != xf.size and xf.size % block_size:
        block_norm, block_size = False, 1
    out = np.empty_like(xf)
    rc = lib.fpemu_cast(
        xf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        xf.size, mode.upper().encode(), ctypes.c_float(scale),
        int(block_norm), int(block_size), seed)
    if rc != 0:
        raise ValueError(f"unknown mode {mode!r}")
    return out.reshape(x.shape)


def version() -> str:
    return load().fpemu_version().decode()
