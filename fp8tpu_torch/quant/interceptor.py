"""Quantization interception for the port's models.

Every call of a :class:`fp8tpu_torch.linen.Module` inside
:func:`fp8tpu_torch.linen.intercept_methods` goes through the interceptor
that :func:`make_quant_interceptor` builds, which applies the policy's
roles in the reference's order:

  iact  → inputs fake-quantized before the module body
  igrad → gradient w.r.t. module inputs, quantized on the backward pass
  (engine) → hw-patched Conv / Matmul contractions run the fused GEMM
  ograd → gradient w.r.t. module outputs, quantized on the backward pass
  oact  → outputs fake-quantized after the module body
  wt    → parameters, fake-quantized once by :func:`quantize_params`

Paths are Flax's (``stage0_block0/conv1``) and ``module_key`` is the crc32
of the path, so policies and SR streams resolve as in the JAX package.
Weights are quantized in the Flax layout (HWIO, (in, out)) and mapped
back, so per-channel scales land on the same elements.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Optional

import torch
from torch.func import functional_call

from fp8tpu_torch import linen
from fp8tpu_torch.numerics.prng import PRNGKey, fold_in

from .config import TensorQuantConfig
from .fakequant import fake_quant, quantize_grad
from .policy import LayerKind, QuantPolicy


def classify_module(module) -> LayerKind:
    """Map a module to its LayerKind."""
    from fp8tpu_torch.ops import wrappers as _w

    if isinstance(module, _w.BatchMatmul):
        return LayerKind.BATCH_MATMUL
    if isinstance(module, (_w.Matmul, _w.AddMatmul)):
        return LayerKind.MATMUL
    if isinstance(module, (_w.EltwiseAdd, _w.EltwiseMul, _w.EltwiseDiv)):
        return LayerKind.ELTWISE
    if isinstance(module, (_w.Norm, _w.Mean)):
        return LayerKind.NORM_OP
    if isinstance(module, linen.Dense):
        return LayerKind.DENSE
    if isinstance(module, linen.Conv):
        return LayerKind.CONV
    return LayerKind.OTHER


def module_key(path: str) -> int:
    """Stable per-module PRNG stream id: crc32 of the path."""
    return zlib.crc32(path.encode()) & 0x7FFFFFFF


class _GradCast(torch.autograd.Function):
    """Identity forward; quantizes the cotangent on the way back."""

    @staticmethod
    def forward(ctx, x, cfg, key):
        ctx.cfg, ctx.key = cfg, key
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return quantize_grad(g, ctx.cfg, ctx.key).to(g.dtype), None, None


def grad_cast(x: torch.Tensor, cfg: Optional[TensorQuantConfig],
              key: Optional[PRNGKey]) -> torch.Tensor:
    return _GradCast.apply(x, cfg, key)


def _is_float(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def _map_float_args(fn, args):
    return tuple(fn(a) if _is_float(a) else a for a in args)


def _chan_dims(a: torch.Tensor):
    """Axes reduced by a per-channel observer: all but the channel axis
    (dim 1 of an NCHW activation, else the last)."""
    chan = 1 if a.ndim == 4 else a.ndim - 1
    return tuple(i for i in range(a.ndim) if i != chan)


def _fold(rec: Dict[str, Any], name: str, value, op) -> None:
    rec[name] = value if name not in rec else op(rec[name], value)


def make_quant_interceptor(
    policy: QuantPolicy,
    key: Optional[PRNGKey] = None,
    stats_sink: Optional[Dict[str, Dict[str, Any]]] = None,
    classify: Callable[[Any], LayerKind] = classify_module,
    per_channel_stats: bool = False,
):
    """Build an interceptor applying ``policy``.

    ``key``        PRNG key for stochastic rounding (folded per module).
    ``stats_sink`` if given, per-module activation min/max/absmax are
                   recorded into it (the calibration sweep).
    ``per_channel_stats`` also records per-channel min/max/absmax.
    """

    def interceptor(next_fun, args, kwargs, context):
        module, path = context.module, context.path
        kind = classify(module)
        cfg = policy.resolve(path, kind)
        if cfg is None and stats_sink is None:
            return next_fun(*args, **kwargs)

        def mod_key(tag: int):
            return None if key is None else fold_in(key,
                                                    module_key(path) ^ tag)

        if stats_sink is not None:
            rec = stats_sink.setdefault(path, {"kind": kind.value})
            flat = [a for a in args if _is_float(a)]
            if flat:
                with torch.no_grad():
                    _fold(rec, "iact_min",
                          torch.stack([a.amin() for a in flat]).amin(),
                          torch.minimum)
                    _fold(rec, "iact_max",
                          torch.stack([a.amax() for a in flat]).amax(),
                          torch.maximum)
                    _fold(rec, "iact_absmax",
                          torch.stack([a.abs().amax() for a in flat]).amax(),
                          torch.maximum)
                    if per_channel_stats:
                        for i, a in enumerate(flat):
                            pre = "iact_ch" if i == 0 else f"iact{i}_ch"
                            dims = _chan_dims(a)
                            _fold(rec, f"{pre}_min", a.amin(dims),
                                  torch.minimum)
                            _fold(rec, f"{pre}_max", a.amax(dims),
                                  torch.maximum)
                            _fold(rec, f"{pre}_absmax", a.abs().amax(dims),
                                  torch.maximum)

        # The engine's operand scale is per-tensor, so per-channel and
        # fine-grained iact configs stay on the unpatched path.
        engine_ok = (cfg is not None and cfg.patch_ops and not kwargs
                     and (cfg.iact is None
                          or cfg.iact.scaling in ("none", "per-tensor")))
        patched = engine_ok and kind in (LayerKind.MATMUL,
                                         LayerKind.BATCH_MATMUL)
        patched_conv = False
        if engine_ok and kind == LayerKind.CONV and len(args) == 1:
            from .hw_patch import conv_patchable
            patched_conv = conv_patchable(module)
        patched = patched or patched_conv
        # On the patched path the engine casts the two contraction operands
        # itself; only other inputs (AddMatmul's addend) get the iact cast.
        if cfg is not None and cfg.iact is not None:
            if patched:
                ncontr = len(args) - 2
                args = tuple(
                    fake_quant(a, cfg.iact, mod_key(1))
                    if (i < ncontr and _is_float(a)) else a
                    for i, a in enumerate(args))
            else:
                args = _map_float_args(
                    lambda a: fake_quant(a, cfg.iact, mod_key(1)), args)
        if cfg is not None and cfg.igrad is not None:
            args = _map_float_args(
                lambda a: grad_cast(a, cfg.igrad, mod_key(2)), args)

        if patched_conv:
            from .hw_patch import engine_conv
            out = engine_conv(args[0], module.weight,
                              module.bias if module.use_bias else None,
                              module.strides, module.padding, cfg,
                              mod_key(5))
        elif patched:
            from .hw_patch import engine_matmul
            if len(args) == 3:          # AddMatmul(inp, a, b)
                out = args[0] + engine_matmul(args[1], args[2], cfg,
                                              mod_key(5))
            else:                       # Matmul / BatchMatmul (a, b)
                out = engine_matmul(args[0], args[1], cfg, mod_key(5))
        else:
            out = next_fun(*args, **kwargs)

        if stats_sink is not None and _is_float(out):
            rec = stats_sink.setdefault(path, {"kind": kind.value})
            with torch.no_grad():
                _fold(rec, "oact_min", out.amin(), torch.minimum)
                _fold(rec, "oact_max", out.amax(), torch.maximum)
                _fold(rec, "oact_absmax", out.abs().amax(), torch.maximum)

        if cfg is not None and _is_float(out):
            if cfg.ograd is not None:
                out = grad_cast(out, cfg.ograd, mod_key(3))
            if cfg.oact is not None:
                out = fake_quant(out, cfg.oact, mod_key(4))
        return out

    return interceptor


# ---------------------------------------------------------------------------
# Module table + weight quantization
# ---------------------------------------------------------------------------

def build_module_table(model: torch.nn.Module) -> Dict[str, LayerKind]:
    """Every submodule path → LayerKind (``named_modules`` with Flax
    paths)."""
    return {name.replace(".", "/"): classify_module(m)
            for name, m in model.named_modules() if name}


_WEIGHT_NAMES = ("weight", "embedding", "scale")


def to_flax_layout(t: torch.Tensor, kind: Optional[LayerKind]):
    """OIHW conv weight → HWIO; (out, in) dense weight → (in, out)."""
    if kind == LayerKind.CONV and t.ndim == 4:
        return t.permute(2, 3, 1, 0)
    if kind == LayerKind.DENSE and t.ndim == 2:
        return t.t()
    return t


def from_flax_layout(t: torch.Tensor, kind: Optional[LayerKind]):
    """Inverse of :func:`to_flax_layout`."""
    if kind == LayerKind.CONV and t.ndim == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    if kind == LayerKind.DENSE and t.ndim == 2:
        return t.t().contiguous()
    return t


def quantize_params(
    params: Dict[str, torch.Tensor],
    policy: QuantPolicy,
    module_table: Dict[str, LayerKind],
    key: Optional[PRNGKey] = None,
) -> Dict[str, torch.Tensor]:
    """Fake-quantize the weights of a state_dict per policy; biases are
    never quantized.  Each weight is cast in its Flax layout, so
    ``channel_axis`` means what it means in the JAX package."""
    out = {}
    for name, leaf in params.items():
        path, _, leaf_name = name.rpartition(".")
        path = path.replace(".", "/")
        kind = module_table.get(path)
        cfg = policy.resolve(path, kind) if kind is not None else None
        if (cfg is not None and cfg.wt is not None
                and leaf_name in _WEIGHT_NAMES):
            k = fold_in(key, module_key(path)) if key is not None else None
            with torch.no_grad():
                leaf = from_flax_layout(
                    fake_quant(to_flax_layout(leaf, kind), cfg.wt, k), kind)
        out[name] = leaf
    return out


def quantized_apply(
    model: torch.nn.Module,
    policy: QuantPolicy,
    *args,
    params: Optional[Dict[str, torch.Tensor]] = None,
    key: Optional[PRNGKey] = None,
    quantize_weights: bool = True,
    module_table: Optional[Dict[str, LayerKind]] = None,
    **kwargs,
):
    """One-shot quantized forward of ``model`` (or of ``params`` in its
    structure): weights and activations per policy."""
    if module_table is None:
        module_table = build_module_table(model)
    if params is None:
        params = model.state_dict()
    if quantize_weights:
        wkey = fold_in(key, 0xE0) if key is not None else None
        params = quantize_params(params, policy, module_table, wkey)
    with linen.intercept_methods(make_quant_interceptor(policy, key=key),
                                 model):
        return functional_call(model, params, args, kwargs)
