"""Fused-engine contraction routing: the reference's "HW patching" C-model
(qutils.py:478-509), where patched modules compute their contraction
through one fused fake-quant GEMM (K2, ``kernels.qmatmul``) with the
operands cast per the module's ``iact`` role, instead of separate casts
around a plain matmul.

The backward runs two more engine GEMMs, uncast, over the re-quantized
saved operands (the C-model's autograd, cmodel/simple.py:124-146),
straight-through with respect to the casts: one ``torch.autograd.Function``
in place of the JAX package's two ``custom_vjp``s, and one more for the
conv, whose forward on the card is K2 as an implicit GEMM.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fp8tpu_torch import linen
from fp8tpu_torch.kernels import qmatmul
from fp8tpu_torch.kernels.qmatmul import qdq_matmul
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.numerics import scaling as _scaling
from fp8tpu_torch.numerics.formats import FORMATS, RoundMode
from fp8tpu_torch.numerics.prng import PRNGKey

from .config import ModuleQuantConfig, TensorQuantConfig


def _fmt_args(cfg: Optional[TensorQuantConfig]):
    if cfg is None:
        return None, RoundMode.RNE
    return cfg.dtype, cfg.round_mode


def _operand_scale(x, cfg: Optional[TensorQuantConfig], shard=None):
    """Per-tensor engine scale with fake_quant's scaling grammar (the global
    batch's with a ``parallel.data.BatchShard``)."""
    if cfg is None or cfg.scaling == "none":
        return 1.0
    return _scaling.per_tensor(x, FORMATS[cfg.dtype], cfg.method, shard)


def _sr_block(x, cfg: Optional[TensorQuantConfig], shard):
    """Where a stochastic operand ``x`` that ranks split lies in the whole
    operand (``shard.block``): K2 hashes its SR bits at each element's
    global index.  None without a shard or SR, or for the whole operand."""
    if shard is None or cfg is None or not cfg.is_stochastic:
        return None
    block = shard.block(x.shape)
    return None if block.shape == tuple(x.shape) else block


def _flat_shard(shard, ndim: int):
    """The shard of an ``ndim``-D operand read as (rows, last dimension):
    a split of dimension 0 or of the last one keeps its place; a sequence
    split or a split of another dimension interleaves the rows, and
    raises."""
    if shard is None or ndim == 2 or not hasattr(shard, "seq"):
        return shard
    if shard.seq is not None or (shard.model is not None
                                 and shard.model_dim % ndim != ndim - 1):
        raise NotImplementedError(
            "an engine operand flattened to rows whose split interleaves "
            "them (a sequence split, or a split of a middle dimension)")
    return dataclasses.replace(shard, model_dim=-1)


def _check_shard(cfg: Optional[TensorQuantConfig], shard) -> None:
    """The engine conv's stochastic operand is its im2col, whose SR index
    is the gathered matrix's: under a batch shard it raises."""
    if shard is not None and cfg is not None and cfg.is_stochastic:
        raise NotImplementedError(
            "a stochastic engine conv operand of a batch shard (the "
            "im2col's SR stream has no offset)")


def _impl_of(cfg_t: Optional[TensorQuantConfig]) -> str:
    return ("hw" if (cfg_t is not None and cfg_t.cast_impl == "hw")
            else "bitexact")


def _seed_of(key: Optional[PRNGKey]) -> int:
    """The engine seed of a key: ``randint(key, (), 0, 2**31 - 1)``, 0
    without a key (``fp8tpu/quant/hw_patch.py::_seed_of``)."""
    return 0 if key is None else prng.randint(key, 0, 2 ** 31 - 1)


def _requant(x, cfg_t: Optional[TensorQuantConfig], shard=None):
    """The quantized operand for the backward, re-derived from the saved
    one: the reference's hooks quantize in place, so its backward consumes
    quantized values.  RNE reproduces the forward's cast; stochastic
    configs take an independent draw from key(0), as the JAX package
    does."""
    from .fakequant import fake_quant
    x = x.to(torch.float32)
    if cfg_t is None:
        return x
    return fake_quant(x, cfg_t, prng.key(0) if cfg_t.is_stochastic else None,
                      shard)


def _uncast(a, b):
    return qdq_matmul(a, b, fmt_x=None, fmt_w=None)


class _EngineMatmul(torch.autograd.Function):
    """``qdq(a) @ qdq(b)``, each operand cast per its config (None leaves
    it uncast); backward ``g @ bq.T`` and ``aq.T @ g`` over the
    re-quantized saved operands.  ``shard_a`` / ``shard_b`` (a
    ``parallel.data.BatchShard`` or ``TensorShard``, or None) are the
    operands': their per-tensor scales are then the whole operand's, and a
    stochastic operand's SR bits the whole operand's at each element's
    global index (:func:`_sr_block`, which K2's pre-pass maps)."""

    @staticmethod
    def forward(ctx, a, b, seed, cfg_a, cfg_b, shard_a, shard_b):
        ctx.save_for_backward(a, b)
        ctx.cfgs, ctx.shards = (cfg_a, cfg_b), (shard_a, shard_b)
        fmt_a, mode_a = _fmt_args(cfg_a)
        fmt_b, mode_b = _fmt_args(cfg_b)
        return qdq_matmul(a, b, fmt_x=fmt_a, mode_x=mode_a, fmt_w=fmt_b,
                          mode_w=mode_b,
                          scale_x=_operand_scale(a, cfg_a, shard_a),
                          scale_w=_operand_scale(b, cfg_b, shard_b),
                          seed=seed, impl=_impl_of(cfg_a),
                          block_x=_sr_block(a, cfg_a, shard_a),
                          block_w=_sr_block(b, cfg_b, shard_b)).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        cfg_a, cfg_b = ctx.cfgs
        shard_a, shard_b = ctx.shards
        gf = g.to(torch.float32)
        da = _uncast(gf, _requant(b, cfg_b, shard_b).t()) \
            if ctx.needs_input_grad[0] else None
        db = _uncast(_requant(a, cfg_a, shard_a).t(), gf) \
            if ctx.needs_input_grad[1] else None
        return (None if da is None else da.to(a.dtype),
                None if db is None else db.to(b.dtype), None, None, None,
                None, None)


def patched_matmul(a: torch.Tensor, b: torch.Tensor, cfg: ModuleQuantConfig,
                   seed: int = 0, shard=None, shard_b=None) -> torch.Tensor:
    """2-D ``qdq(a) @ qdq(b)`` through the fused engine; both operands use
    the module's ``iact`` role.  ``shard`` and ``shard_b`` are ``a``'s and
    ``b``'s (a ``parallel.data.BatchShard`` or ``TensorShard``, or None)."""
    return _EngineMatmul.apply(a, b, seed, cfg.iact, cfg.iact, shard,
                               shard_b)


def patched_linear(x: torch.Tensor, w: torch.Tensor, cfg: ModuleQuantConfig,
                   seed: int = 0) -> torch.Tensor:
    """2-D ``qdq(x) @ w`` through the fused engine: the activation is cast
    per ``iact`` in the kernel; the weight passes uncast because
    quantize_params already applied the ``wt`` role."""
    return _EngineMatmul.apply(x, w, seed, cfg.iact, None, None, None)


def conv_patchable(module) -> bool:
    """The engine's conv restrictions: 2-D, no groups, no dilation, and an
    explicit padding or SAME/VALID."""
    if not isinstance(module, linen.Conv) or len(module.kernel_size) != 2:
        return False
    if module.feature_group_count != 1:
        return False
    pad = module.padding
    return not isinstance(pad, str) or pad.upper() in ("SAME", "VALID")


def engine_ok(cfg: Optional[ModuleQuantConfig]) -> bool:
    """Whether a module resolved to ``cfg`` runs its contraction on the
    fused engine: hw patching is on and the activation's scale is one the
    engine takes (per tensor, or none); per-channel and fine-grained iact
    configs stay on the unpatched path."""
    return (cfg is not None and cfg.patch_ops
            and (cfg.iact is None
                 or cfg.iact.scaling in ("none", "per-tensor")))


def engine_convs(model: torch.nn.Module, policy) -> set:
    """Paths of the convs of ``model`` that ``policy`` runs on the fused
    engine, one K2 launch a call on the card: ``conv_patchable`` and
    resolved to an :func:`engine_ok` config."""
    from .policy import LayerKind
    return {path for path, m in ((n.replace(".", "/"), m)
                                 for n, m in model.named_modules())
            if conv_patchable(m)
            and engine_ok(policy.resolve(path, LayerKind.CONV))}


def _implicit_ok(cfg_t: Optional[TensorQuantConfig]) -> bool:
    """Whether the conv's activation cast commutes with im2col, so that K2
    can cast the activation once and gather its im2col: an elementwise
    cast that is not stochastic (SR draws bits by the im2col's index),
    under no scale or a per-tensor "max" scale (a max over the gathered
    positions is the max over the im2col; a mean is not)."""
    return cfg_t is None or (not cfg_t.is_stochastic and (
        cfg_t.scaling == "none" or cfg_t.method == "max"))


class _EngineConv(torch.autograd.Function):
    """NCHW ``qdq(x) (*) weight`` through the fused engine, the weight
    uncast (quantize_params applied its role).  On a CUDA tensor whose
    cast commutes with im2col (:func:`_implicit_ok`) the forward is one
    K2 implicit-GEMM launch (``qmatmul.conv``) with the scale taken over
    the positions the im2col gathers; otherwise im2col and one engine GEMM,
    the scale taken on the im2col, as the JAX package does.  It saves x,
    not the im2col; the backward rebuilds the im2col, re-quantizes it
    (:func:`_requant`) and runs the two uncast GEMMs, reading the
    transposed operands in place, then autograd's col2im."""

    @staticmethod
    def forward(ctx, x, weight, seed, strides, pads, cfg_t, shard):
        _check_shard(cfg_t, shard)
        ctx.save_for_backward(x, weight)
        ctx.geometry = strides, pads
        ctx.cfg, ctx.shard = cfg_t, shard
        fmt, mode = _fmt_args(cfg_t)
        impl = _impl_of(cfg_t)
        ksize = tuple(weight.shape[2:])
        if x.is_cuda and _implicit_ok(cfg_t):
            scale = _operand_scale(qmatmul.gathered(x, ksize, strides, pads),
                                   cfg_t, shard)
            return qmatmul.conv(x, weight, strides, pads, fmt, mode, scale,
                                seed, impl)
        col, oh, ow = qmatmul.im2col(x, ksize, strides, pads)
        cout = weight.shape[0]
        w2d = weight.to(torch.float32).reshape(cout, -1).t()
        out = qdq_matmul(col, w2d, fmt_x=fmt, mode_x=mode, fmt_w=None,
                         scale_x=_operand_scale(col, cfg_t, shard), seed=seed,
                         impl=impl)
        return out.reshape(x.shape[0], oh, ow, cout).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        strides, pads = ctx.geometry
        cout = weight.shape[0]
        with torch.enable_grad():
            xr = x.detach().requires_grad_(ctx.needs_input_grad[0])
            col, _, _ = qmatmul.im2col(xr, tuple(weight.shape[2:]), strides,
                                       pads)
        gf = g.to(torch.float32).permute(0, 2, 3, 1).reshape(-1, cout)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_rows = weight.to(torch.float32).reshape(cout, -1)
            dcol = _uncast(gf, w_rows)
            dx = torch.autograd.grad(col, xr, dcol)[0].to(x.dtype)
        if ctx.needs_input_grad[1]:
            colq = _requant(col.detach(), ctx.cfg, ctx.shard)
            dw = _uncast(colq.t(), gf).t().reshape(weight.shape).to(
                weight.dtype)
        return dx, dw, None, None, None, None, None


def engine_conv(x: torch.Tensor, weight: torch.Tensor, bias, strides,
                padding, cfg: ModuleQuantConfig,
                key: Optional[PRNGKey] = None, shard=None) -> torch.Tensor:
    """NCHW conv2d through the fused engine (:class:`_EngineConv`): the
    JAX package's im2col (features ordered (Cin, KH, KW)) + one engine
    GEMM against the OIHW weight, with the per-tensor iact scale of the
    im2col matrix; on the card an implicit GEMM computes the same."""
    if isinstance(strides, int):
        strides = (strides, strides)
    pads = linen.conv_padding(padding, x.shape[-2:], tuple(weight.shape[2:]),
                              strides)
    out = _EngineConv.apply(x, weight, _seed_of(key), tuple(strides),
                            tuple(map(tuple, pads)), cfg.iact,
                            shard).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out


def engine_matmul(a: torch.Tensor, b: torch.Tensor, cfg: ModuleQuantConfig,
                  key: Optional[PRNGKey] = None, shard=None, shards=None,
                  slice_shards=None) -> torch.Tensor:
    """Shape-polymorphic entry: 2-D direct; batched ``a`` against a 2-D
    ``b`` by flattening; batched x batched one engine GEMM per slice.  With
    ``shard`` (the interceptor's operands are a rank's rows of a
    data-parallel batch) a 2-D operand's per-tensor max is the global
    operand's (a max, unlike an SR offset, does not depend on the layout,
    and of a replicated operand it is its own); ``shards`` gives each
    operand's instead (a tensor-parallel rank's).  A batched x batched
    slice lies whole on one rank and keeps its own scale, unless the
    sequence is split: ``slice_shards`` are then the shards of an ``a``
    slice (its rows, over the seq group) and of a ``b`` slice."""
    seed = _seed_of(key)
    sa, sb = (shard, shard) if shards is None else shards
    if b.ndim == 2:
        a2 = a if a.ndim == 2 else a.reshape(-1, a.shape[-1])
        out = patched_matmul(a2, b, cfg, seed, _flat_shard(sa, a.ndim), sb)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    af = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    bf = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    sa, sb = slice_shards or (None, None)
    out = torch.stack([patched_matmul(x, y, cfg, seed, sa, sb)
                       for x, y in zip(af, bf)])
    return out.reshape(*batch, *out.shape[-2:])
