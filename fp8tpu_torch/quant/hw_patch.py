"""Fused-engine contraction routing: the reference's "HW patching" C-model
(qutils.py:478-509), where patched modules compute their contraction
through one fused fake-quant GEMM (K2, ``kernels.qmatmul``) with the
operands cast per the module's ``iact`` role, instead of separate casts
around a plain matmul.

Forward only: the backward of these contractions (two more engine GEMMs,
straight-through w.r.t. the casts) is ported with FP8 training and raises
until then.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fp8tpu_torch import linen
from fp8tpu_torch.kernels.qmatmul import qdq_matmul
from fp8tpu_torch.numerics import scaling as _scaling
from fp8tpu_torch.numerics.formats import FORMATS
from fp8tpu_torch.numerics.prng import PRNGKey

from .config import ModuleQuantConfig, TensorQuantConfig


def _fmt_args(cfg: Optional[TensorQuantConfig]):
    if cfg is None:
        return None, None
    return cfg.dtype, cfg.round_mode


def _operand_scale(x, cfg: Optional[TensorQuantConfig]):
    """Per-tensor engine scale with fake_quant's scaling grammar."""
    if cfg is None or cfg.scaling == "none":
        return 1.0
    return _scaling.per_tensor(x, FORMATS[cfg.dtype], cfg.method)


def _impl_of(cfg_t: Optional[TensorQuantConfig]) -> str:
    return ("hw" if (cfg_t is not None and cfg_t.cast_impl == "hw")
            else "bitexact")


class _NoBackward(torch.autograd.Function):
    """Forward through ``fn``; the backward is not ported yet."""

    @staticmethod
    def forward(ctx, fn, a, b):
        return fn(a, b)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the backward of hw-patched contractions is ported with FP8 "
            "training")


def patched_matmul(a: torch.Tensor, b: torch.Tensor,
                   cfg: ModuleQuantConfig) -> torch.Tensor:
    """2-D ``qdq(a) @ qdq(b)`` through the fused engine; both operands use
    the module's ``iact`` role."""
    fmt, mode = _fmt_args(cfg.iact)

    def fwd(a, b):
        return qdq_matmul(a, b, fmt_x=fmt, mode_x=mode, fmt_w=fmt,
                          mode_w=mode, scale_x=_operand_scale(a, cfg.iact),
                          scale_w=_operand_scale(b, cfg.iact),
                          impl=_impl_of(cfg.iact)).to(a.dtype)

    return _NoBackward.apply(fwd, a, b)


def patched_linear(x: torch.Tensor, w: torch.Tensor,
                   cfg: ModuleQuantConfig) -> torch.Tensor:
    """2-D ``qdq(x) @ w`` through the fused engine: the activation is cast
    per ``iact`` in the kernel; the weight passes uncast because
    quantize_params already applied the ``wt`` role."""
    fmt, mode = _fmt_args(cfg.iact)

    def fwd(x, w):
        return qdq_matmul(x, w, fmt_x=fmt, mode_x=mode, fmt_w=None,
                          scale_x=_operand_scale(x, cfg.iact),
                          impl=_impl_of(cfg.iact)).to(x.dtype)

    return _NoBackward.apply(fwd, x, w)


def conv_patchable(module) -> bool:
    """The engine's conv restrictions: 2-D, no groups, no dilation, and an
    explicit padding or SAME/VALID."""
    if not isinstance(module, linen.Conv) or len(module.kernel_size) != 2:
        return False
    if module.feature_group_count != 1:
        return False
    pad = module.padding
    return not isinstance(pad, str) or pad.upper() in ("SAME", "VALID")


def engine_conv(x: torch.Tensor, weight: torch.Tensor, bias, strides,
                padding, cfg: ModuleQuantConfig,
                key: Optional[PRNGKey] = None) -> torch.Tensor:
    """NCHW conv2d through the fused engine: im2col (one strided copy,
    features ordered (Cin, KH, KW) as in the JAX package) + one engine GEMM
    against the OIHW weight.  The per-tensor iact scale is taken on the
    im2col matrix, as the JAX package does."""
    del key  # stochastic engine modes are ported with FP8 training
    cout, cin, kh, kw = weight.shape
    if isinstance(strides, int):
        strides = (strides, strides)
    (pt, pb), (pl, pr) = linen.conv_padding(padding, x.shape[-2:], (kh, kw),
                                            strides)
    xp = x.to(torch.float32)
    if pt or pb or pl or pr:
        xp = F.pad(xp, (pl, pr, pt, pb))
    # (B, Cin, OH, OW, KH, KW) view → rows (b, oh, ow), features (c, kh, kw)
    patches = xp.unfold(2, kh, strides[0]).unfold(3, kw, strides[1])
    oh, ow = patches.shape[2], patches.shape[3]
    col = patches.permute(0, 2, 3, 1, 4, 5).reshape(-1, cin * kh * kw)
    w2d = weight.to(torch.float32).reshape(cout, cin * kh * kw).t()
    out = patched_linear(col, w2d, cfg)
    out = out.reshape(x.shape[0], oh, ow, cout).permute(0, 3, 1, 2)
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out


def engine_matmul(a: torch.Tensor, b: torch.Tensor, cfg: ModuleQuantConfig,
                  key: Optional[PRNGKey] = None) -> torch.Tensor:
    """Shape-polymorphic entry: 2-D direct; batched ``a`` against a 2-D
    ``b`` by flattening; batched x batched one engine GEMM per slice."""
    del key  # stochastic engine modes are ported with FP8 training
    if a.ndim == 2 and b.ndim == 2:
        return patched_matmul(a, b, cfg)
    if b.ndim == 2:
        out = patched_matmul(a.reshape(-1, a.shape[-1]), b, cfg)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    af = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    bf = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.stack([patched_matmul(x, y, cfg) for x, y in zip(af, bf)])
    return out.reshape(*batch, *out.shape[-2:])
