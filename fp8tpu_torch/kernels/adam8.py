"""P3: one parameter leaf's whole 8-bit AdamW update (``csrc/adam8.cu``).

P3 has no TPU counterpart.  In the JAX package the 8-bit optimizer
(``fp8tpu/training/opt8.py``) is XLA ops that fuse into the jitted train
step: dequantize the int8 first and e4m3 second moments, the Adam update
in f32, requantize per block of 256 (``numerics/blockquant.py``), then
optax's ``add_decayed_weights``, ``scale_by_learning_rate`` and
``apply_updates``.  Run eagerly that is about 20 elementwise launches a
leaf, each a pass over the state; P3 is one pass.

On a leaf of n elements, with its moments ``(nblocks, block)`` payloads
and ``(nblocks,)`` f32 scales (flat in the leaf's order, zero-padded):

    m   = b1 * deq(m) + (1 - b1) * g
    v   = b2 * deq(v) + (1 - b2) * g * g
    upd = (m / bc1) / (sqrt(v / bc2) + eps)
    m, v = quant_blocks(m, "int8"), quant_blocks(v, "e4m3")
    mode "apply":  p = p + (-lr) * (upd [+ wd * p])     (in place)
    mode "store":  out = upd                            (scale_by_adam_8bit)

All in f32 with XLA's rounding: no fused multiply-adds, correctly rounded
divides and square roots, f32 subnormals flushed on every input and
result (DAZ/FTZ), the bias corrections ``bc1 = 1 - b1**count`` and
``bc2`` computed on the host and passed in.  On a CPU tensor the wrapper
runs the plain version below; on a CUDA tensor it launches the kernel or
raises.

A leaf may be given as a 2-D strided view (a Dense weight stored (out,
in) and updated in the JAX package's (in, out) order, so that its blocks
hold the same elements as the JAX package's): the kernel reads and
writes ``p`` and ``g`` through the view's strides.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fp8tpu_torch.numerics.blockquant import dequant_blocks, quant_blocks
from fp8tpu_torch.numerics.cast import _flush

from . import _build

BLOCK = 256                 # elements a block; one warp a block in P3
MODES = {"apply": 0, "apply_decay": 1, "store": 2}

# Launches of P3 since the last reset_launches().
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


class Adam8Args(NamedTuple):
    """The scalars of one update, each rounded to f32 as the JAX package
    rounds it: ``b1``, ``b2``, ``eps`` and the weight decay as Python
    floats (weak-typed), ``one_minus_b1`` / ``one_minus_b2`` computed in
    f64 then rounded, ``bc1`` / ``bc2`` in f32 from the count, ``neg_lr``
    the negated learning rate."""

    b1: float
    b2: float
    eps: float
    bc1: float
    bc2: float
    weight_decay: float = 0.0
    neg_lr: float = 0.0

    def f32(self):
        """(b1, 1 - b1, b2, 1 - b2, eps, bc1, bc2, wd, -lr) as f32."""
        vals = (self.b1, 1.0 - self.b1, self.b2, 1.0 - self.b2, self.eps,
                self.bc1, self.bc2, self.weight_decay, self.neg_lr)
        return tuple(float(torch.tensor(v, dtype=torch.float32))
                     for v in vals)


def bias_corrections(b1: float, b2: float, count: int):
    """``(1 - b1**count, 1 - b2**count)`` in f32, as XLA's CPU computes
    them (torch's CPU pow gives the same bits for counts 1-2000 at 0.9 and
    0.999); on the host, never with the card's pow."""
    c = torch.tensor(float(count), dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)

    def bc(b):
        return float(one - torch.pow(torch.tensor(b, dtype=torch.float32),
                                     c))

    return bc(b1), bc(b2)


# -- the plain version ----------------------------------------------------------

def _f(a):
    """DAZ on an input (a Python float here is an f32 constant, normal)."""
    return a if isinstance(a, float) else _flush(a)


def _mul(a, b):
    return _flush(_f(a) * _f(b))


def _add(a, b):
    return _flush(_f(a) + _f(b))


def _div(a, b):
    return _flush(_flush(a) / _flush(b))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root: through f64 (rounding the f64
    root to f32 is exact rounding of the real root).  torch's own f32
    ``sqrt`` is not correctly rounded, neither on the card nor in the
    CPU's vectorised loop."""
    return _flush(torch.sqrt(_flush(x).double()).float())


def adam_moments(gf: torch.Tensor, mq, ms, vq, vs, args: Adam8Args):
    """One leaf's Adam step on flat, padded f32 gradients ``gf`` (nblocks *
    block): ``(upd, mq, ms, vq, vs)``, the update over the padded length
    and the requantized moments.  ``fp8tpu/training/opt8.py``'s leaf,
    op by op."""
    b1, omb1, b2, omb2, eps, bc1, bc2, _, _ = args.f32()
    block = mq.shape[-1]
    m = _add(_mul(b1, dequant_blocks(mq, ms).reshape(-1)), _mul(omb1, gf))
    v = _add(_mul(b2, dequant_blocks(vq, vs).reshape(-1)),
             _mul(_mul(omb2, gf), gf))
    upd = _div(_div(m, torch.full_like(m, bc1)),
               _add(_sqrt(_div(v, torch.full_like(v, bc2))), eps))
    mq, ms = quant_blocks(m.reshape(-1, block), "int8")
    vq, vs = quant_blocks(v.reshape(-1, block), "e4m3")
    return upd, mq, ms, vq, vs


def _padded(g: torch.Tensor, nblocks: int, block: int) -> torch.Tensor:
    gf = g.to(torch.float32).reshape(-1)
    return torch.nn.functional.pad(gf, (0, nblocks * block - gf.numel()))


def adam8_update_plain(p: torch.Tensor, g: torch.Tensor, mq, ms, vq, vs,
                       args: Adam8Args, mode: str = "apply") -> None:
    """The plain version of P3, in place: the moments always; ``p`` by
    ``mode`` ("apply": ``p += -lr * upd``; "apply_decay": ``p += -lr *
    (upd + wd * p)``; "store": ``p = upd``).  ``p`` and ``g`` may be views
    (written through)."""
    upd, mq2, ms2, vq2, vs2 = adam_moments(
        _padded(g, mq.shape[0], mq.shape[1]), mq, ms, vq, vs, args)
    u = upd[:g.numel()].reshape(g.shape).to(g.dtype)
    if mode == "store":
        p.copy_(u)
    else:
        _, _, _, _, _, _, _, wd, neg_lr = args.f32()
        if mode == "apply_decay":
            u = _add(u, _mul(wd, p))
        p.copy_(_add(p, _mul(neg_lr, u)).to(p.dtype))
    for dst, src in ((mq, mq2), (ms, ms2), (vq, vq2), (vs, vs2)):
        dst.copy_(src)


# -- the kernel -----------------------------------------------------------------

@functools.cache
def _fn():
    fn = _build.load("adam8").adam8_update
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 \
        + [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _geometry(p: torch.Tensor):
    """(cols, s0, s1) of the element order P3 walks: flat for a contiguous
    tensor, the view's (rows, cols) order for a 2-D strided view."""
    if p.is_contiguous():
        return max(p.numel(), 1), 0, 1
    if p.ndim != 2:
        raise ValueError(f"adam8_update takes a contiguous leaf or a 2-D "
                         f"view, got shape {tuple(p.shape)} strides "
                         f"{p.stride()}")
    return p.shape[1], p.stride(0), p.stride(1)


def adam8_update(p: torch.Tensor, g: torch.Tensor, mq: torch.Tensor,
                 ms: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
                 args: Adam8Args, mode: str = "apply") -> None:
    """One leaf's 8-bit AdamW update in place (see the module docstring):
    P3 on CUDA tensors (f32 ``p`` and ``g`` of one shape and strides,
    ``mq`` int8 and ``vq`` e4m3 (nblocks, 256) contiguous, f32 scales),
    the plain version on CPU tensors."""
    global launches
    if not p.is_cuda:
        adam8_update_plain(p, g, mq, ms, vq, vs, args, mode)
        return
    n = p.numel()
    nb = -(-n // BLOCK)
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"adam8_update takes f32 p and g on the card, got "
                         f"{p.dtype} and {g.dtype}")
    if g.shape != p.shape or g.stride() != p.stride():
        raise ValueError("adam8_update needs g in p's shape and strides")
    if (mq.dtype != torch.int8 or vq.dtype != torch.float8_e4m3fn
            or tuple(mq.shape) != (nb, BLOCK) or vq.shape != mq.shape
            or ms.dtype != torch.float32 or vs.dtype != torch.float32
            or tuple(ms.shape) != (nb,) or vs.shape != ms.shape
            or not all(t.is_contiguous() for t in (mq, ms, vq, vs))):
        raise ValueError(f"adam8_update needs int8 / e4m3 ({nb}, {BLOCK}) "
                         "payloads and f32 scales, contiguous")
    if not all(t.device == p.device for t in (g, mq, ms, vq, vs)):
        raise ValueError("adam8_update needs every tensor on one device")
    if n == 0:
        return
    cols, s0, s1 = _geometry(p)
    err = _fn()(p.data_ptr(), g.data_ptr(), mq.data_ptr(), ms.data_ptr(),
                vq.data_ptr(), vs.data_ptr(), n, cols, s0, s1, *args.f32(),
                MODES[mode], torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "adam8_update kernel")
    launches += 1
