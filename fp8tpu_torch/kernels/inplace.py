"""K6, the in-place dynamic row store (``csrc/inplace.cu``): its wrapper,
launch count and plain version.

Replaces ``fp8tpu/kernels/inplace.py::_store_kernel``: ``buf[idx mod n] =
slab`` where ``idx`` lives in device memory.  The port mutates ``buf`` and
returns it (the JAX function consumes ``buf`` and returns the updated
array).  The kernel reads the index itself, so a launch needs no host
synchronisation and can be captured in a CUDA graph.  Every shape and
every 1-, 2-, 4- or 8-byte type goes through the kernel on a CUDA tensor.
The serving decoder's ring write is two launches per decode step (payload
slab, scale slab).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .qmatmul import sm_count

# Launches of the kernel since the last reset_launches().
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check(buf, slab):
    if buf.ndim < 1 or tuple(slab.shape) != tuple(buf.shape[1:]):
        raise ValueError(f"dyn_store: slab {tuple(slab.shape)} is not a row "
                         f"of buf {tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("dyn_store: buf must be contiguous")


def dyn_store_plain(buf: torch.Tensor, slab: torch.Tensor, idx):
    """The plain version of K6 (any device): ``buf[idx mod n] = slab`` in
    place through ``index_copy_`` with the index kept as a tensor; returns
    ``buf``."""
    _check(buf, slab)
    row = torch.remainder(
        torch.as_tensor(idx, device=buf.device).to(torch.int64).reshape(1),
        buf.shape[0])
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[buf.element_size()]
    # integer views: byte moves are defined for every payload type
    buf.view(width).index_copy_(
        0, row, slab.to(buf.dtype).contiguous().view(width)[None])
    return buf


@functools.cache
def _fn():
    fn = _build.load("inplace").fp8_dyn_store
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dyn_store(buf: torch.Tensor, slab: torch.Tensor, idx) -> torch.Tensor:
    """``buf[idx mod n] = slab`` without copying ``buf``; mutates and returns
    ``buf``.  ``slab.shape`` must equal ``buf.shape[1:]``; ``idx`` is a
    0-dim (or 1-element) integer tensor on ``buf``'s device (a Python int
    is moved there).  A negative index wraps to a non-negative row.  K6 on
    a CUDA tensor, the plain version on the CPU."""
    global launches
    if not buf.is_cuda:
        return dyn_store_plain(buf, slab, idx)
    _check(buf, slab)
    row = slab.to(device=buf.device, dtype=buf.dtype).contiguous()
    i32 = torch.as_tensor(idx, device=buf.device).to(torch.int32).reshape(1)
    n = buf.shape[0]
    err = _fn()(buf.data_ptr(), row.data_ptr(), i32.data_ptr(), n,
                row.numel() * row.element_size(),
                4 * sm_count(buf.device.index or 0),
                torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(err, "dyn_store kernel")
    launches += 1
    return buf
