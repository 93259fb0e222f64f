"""K6, the in-place dynamic row store (``csrc/inplace.cu``): its wrappers,
launch count and plain versions.

Replaces ``fp8tpu/kernels/inplace.py::_store_kernel``: ``buf[idx mod n] =
slab`` where ``idx`` lives in device memory.  The port mutates ``buf`` and
returns it (the JAX function consumes ``buf`` and returns the updated
array).  The kernel reads the index itself, so a launch needs no host
synchronisation and can be captured in a CUDA graph.  Every shape and
every 1-, 2-, 4- or 8-byte type goes through the kernel on a CUDA tensor.

Two entry points launch the one kernel: :func:`dyn_store`, one (buf,
slab) pair, and :func:`ring_store`, the serving ring's write of a decode
step: the payload slab and the scale slab at row ``head``, and ``head``
advanced to ``(head + 1) mod n`` in place, all in one launch (the JAX
package makes two ``dyn_store`` calls and ``jnp.mod(head + 1, S)``).  With
``rows=W`` it is the batched ring write (``ring_flush = W``): W rows of
each slab at rows ``head .. head + W - 1`` (each mod n) and ``head``
advanced by W, still one launch (the JAX package's two
``dynamic_update_slice`` calls of the W-row side buffer and its
``jnp.mod(head + W, S)``; that slice clamps a start past ``n - W`` where
the kernel wraps each row, which differs only outside the W-aligned
heads the serving loop keeps).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Launches of the kernel since the last reset_launches(), in all and by
# entry point.
launches = 0
routes = {"dyn_store": 0, "ring_store": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    for r in routes:
        routes[r] = 0


def _check(buf, slab, rows=1):
    row = tuple(buf.shape[1:])
    want = row if rows == 1 else (rows,) + row
    if buf.ndim < 1 or tuple(slab.shape) != want:
        what = "a row" if rows == 1 else f"{rows} rows"
        raise ValueError(f"dyn_store: slab {tuple(slab.shape)} is not "
                         f"{what} of buf {tuple(buf.shape)}")
    if not 1 <= rows <= buf.shape[0]:
        raise ValueError(f"dyn_store: {rows} rows into a ring of "
                         f"{buf.shape[0]}")
    if not buf.is_contiguous():
        raise ValueError("dyn_store: buf must be contiguous")


def _store_plain(buf: torch.Tensor, slab: torch.Tensor, idx, rows: int):
    """``buf[(idx + w) mod n] = slab[w]`` for w < rows, through one
    ``index_copy_`` with the index kept as a tensor."""
    _check(buf, slab, rows)
    first = torch.as_tensor(idx, device=buf.device).to(torch.int64).reshape(1)
    at = torch.remainder(first + torch.arange(rows, device=buf.device),
                         buf.shape[0])
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[buf.element_size()]
    # integer views: byte moves are defined for every payload type
    buf.view(width).index_copy_(
        0, at, slab.to(buf.dtype).contiguous().view(width).reshape(
            (rows,) + tuple(buf.shape[1:])))
    return buf


def dyn_store_plain(buf: torch.Tensor, slab: torch.Tensor, idx):
    """The plain version of K6 (any device): ``buf[idx mod n] = slab`` in
    place through ``index_copy_`` with the index kept as a tensor; returns
    ``buf``."""
    return _store_plain(buf, slab, idx, 1)


def ring_store_plain(kv8: torch.Tensor, slab8: torch.Tensor,
                     sc: torch.Tensor, slabs: torch.Tensor,
                     head: torch.Tensor, n: int, ticket=None,
                     rows: int = 1) -> None:
    """The plain version of :func:`ring_store` (any device): both slabs'
    ``rows`` rows stored at ``(head + w) mod n``, then ``head = (head +
    rows) mod n`` in place.  ``ticket`` is the kernel's and is not
    touched."""
    _store_plain(kv8, slab8, head, rows)
    _store_plain(sc, slabs, head, rows)
    head.copy_(torch.remainder(head + rows, n))


@functools.cache
def _fn():
    fn = _build.load("inplace").fp8_ring_store
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] * 2 \
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows(buf: torch.Tensor, slab: torch.Tensor, rows: int = 1
          ) -> torch.Tensor:
    _check(buf, slab, rows)
    return slab.to(device=buf.device, dtype=buf.dtype).contiguous()


def _row_bytes(buf: torch.Tensor) -> int:
    return buf[0].numel() * buf.element_size()


def dyn_store(buf: torch.Tensor, slab: torch.Tensor, idx) -> torch.Tensor:
    """``buf[idx mod n] = slab`` without copying ``buf``; mutates and returns
    ``buf``.  ``slab.shape`` must equal ``buf.shape[1:]``; ``idx`` is a
    0-dim (or 1-element) integer tensor on ``buf``'s device (a Python int
    is moved there).  A negative index wraps to a non-negative row.  K6 on
    a CUDA tensor, the plain version on the CPU."""
    global launches
    if not buf.is_cuda:
        return dyn_store_plain(buf, slab, idx)
    row = _rows(buf, slab)
    i32 = torch.as_tensor(idx, device=buf.device).to(torch.int32).reshape(1)
    err = _fn()(buf.data_ptr(), row.data_ptr(), _row_bytes(buf), None, None,
                0, i32.data_ptr(), None, buf.shape[0], 1,
                torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(err, "dyn_store kernel")
    launches += 1
    routes["dyn_store"] += 1
    return buf


def ring_store(kv8: torch.Tensor, slab8: torch.Tensor, sc: torch.Tensor,
               slabs: torch.Tensor, head: torch.Tensor, n: int,
               ticket: torch.Tensor, rows: int = 1) -> None:
    """One decode step's ring write: ``kv8[head mod n] = slab8``,
    ``sc[head mod n] = slabs`` and ``head = (head + 1) mod n``, in place.
    With ``rows`` > 1 the slabs hold that many rows (a leading axis),
    stored at ``(head + w) mod n``, and ``head`` advances by ``rows``.
    ``head`` is a one-element int32 tensor, ``ticket`` a zeroed one-element
    int32 tensor that belongs to this ring (the blocks' count; the launch
    puts it back to 0).  One K6 launch on CUDA tensors (capturable in a
    CUDA graph: every replay advances ``head``), the plain version on the
    CPU."""
    global launches
    if not kv8.is_cuda:
        return ring_store_plain(kv8, slab8, sc, slabs, head, n, rows=rows)
    if kv8.shape[0] != n or sc.shape[0] != n:
        raise ValueError(f"ring_store: rings of {kv8.shape[0]} and "
                         f"{sc.shape[0]} rows, n = {n}")
    for t in (head, ticket):
        if (t.dtype != torch.int32 or t.numel() != 1
                or t.device != kv8.device):
            raise ValueError("ring_store: head and ticket are one-element "
                             "int32 tensors on the ring's device")
    r8, rs = _rows(kv8, slab8, rows), _rows(sc, slabs, rows)
    err = _fn()(kv8.data_ptr(), r8.data_ptr(), _row_bytes(kv8), sc.data_ptr(),
                rs.data_ptr(), _row_bytes(sc), head.data_ptr(),
                ticket.data_ptr(), n, rows,
                torch.cuda.current_stream(kv8.device).cuda_stream)
    _build.check(err, "ring_store kernel")
    launches += 1
    routes["ring_store"] += 1
