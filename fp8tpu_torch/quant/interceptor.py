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
    if isinstance(module, linen.Embed):
        return LayerKind.EMBED
    if isinstance(module, linen.LayerNorm):
        return LayerKind.LAYERNORM
    return LayerKind.OTHER


def module_key(path: str) -> int:
    """Stable per-module PRNG stream id: crc32 of the path."""
    return zlib.crc32(path.encode()) & 0x7FFFFFFF


def _in_jax_layout(fn, a: torch.Tensor, cfg: Optional[TensorQuantConfig],
                   nchw: bool = True):
    """``fn(a)`` for a cast whose result depends on the layout, computed in
    the JAX package's layout: an NCHW activation is cast as NHWC, so SR
    bits (keyed by the row-major index) and per-channel, fine-grained or
    per-block scales land on the same elements.  Per-tensor RNE casts, and
    4-D tensors that are not NCHW (``nchw=False``: a BatchMatmul's
    operands, already in the JAX layout), run as they are."""
    if (not nchw or a.ndim != 4 or cfg is None or cfg.is_int
            or (not cfg.is_stochastic
                and cfg.scaling in ("none", "per-tensor"))):
        return fn(a)
    return fn(a.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _GradCast(torch.autograd.Function):
    """Identity forward; quantizes the cotangent on the way back."""

    @staticmethod
    def forward(ctx, x, cfg, key, nchw, shard):
        ctx.cfg, ctx.key, ctx.nchw, ctx.shard = cfg, key, nchw, shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        q = _in_jax_layout(
            lambda t: quantize_grad(t, ctx.cfg, ctx.key, ctx.shard),
            g, ctx.cfg, ctx.nchw)
        return q.to(g.dtype), None, None, None, None


def grad_cast(x: torch.Tensor, cfg: Optional[TensorQuantConfig],
              key: Optional[PRNGKey], nchw: bool = True,
              shard=None) -> torch.Tensor:
    return _GradCast.apply(x, cfg, key, nchw, shard)


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
    shard=None,
    mesh=None,
):
    """Build an interceptor applying ``policy``.

    ``key``        PRNG key for stochastic rounding (folded per module).
    ``stats_sink`` if given, per-module activation min/max/absmax are
                   recorded into it (the calibration sweep).
    ``per_channel_stats`` also records per-channel min/max/absmax.
    ``shard``      a ``parallel.data.BatchShard``: the model runs on one
                   rank's rows of a data-parallel batch, and every
                   activation and gradient cast is the rank's share of the
                   global batch's (scales and SR bits); every activation
                   the casts see must lead with the batch dimension.
    ``mesh``       a ``parallel.Mesh``: the model is the tensor-parallel
                   form of ``models.transformer`` on one rank, its rows
                   of the batch split over the mesh's data group (and its
                   positions over the seq group).  Each cast's operand is
                   split as its module says (``tp_in`` / ``tp_out``: the
                   dimension split over the model group; ``seq_in`` /
                   ``seq_out``: over the seq group), forward and
                   backward alike (a cotangent is split as its operand),
                   so a per-tensor scale is the whole tensor's and SR
                   bits are the whole tensor's at each element's global
                   index: a column-parallel input reduces over data x
                   seq, a row-parallel input or a BatchMatmul operand on
                   the rank's heads over data x seq x model.  A
                   calibration sweep records the whole tensor's min, max
                   and absmax (per-channel statistics raise); hw-patched
                   BatchMatmuls take each slice's scale over the seq
                   group.
    """
    data = model = seq = None
    if mesh is not None:
        if shard is not None:
            raise ValueError("pass a mesh or a batch shard, not both")
        if stats_sink is not None and per_channel_stats:
            raise NotImplementedError(
                "per-channel calibration statistics under a mesh")
        from fp8tpu_torch.parallel.data import BatchShard, TensorShard
        data = BatchShard.of(mesh.group("host", "data"))
        model = BatchShard.of(mesh.group("model"))
        if mesh.shape.get("seq", 1) > 1:
            seq = BatchShard.of(mesh.group("seq"))

    def split_as(dim, seq_dim=None, sp=None):
        """The shard of an operand split over the model group along
        ``dim`` (None: replicated over it) and, under a sequence split
        ``sp``, over the seq group along ``seq_dim``."""
        if mesh is None:
            return shard
        on_seq = seq is not None and sp is not None and seq_dim is not None
        return TensorShard(data, None if dim is None else model,
                           -1 if dim is None else dim,
                           seq if on_seq else None,
                           seq_dim if on_seq else 1,
                           sp.length if on_seq else None, mesh)

    def arg_shards(module, n):
        """The shard of each of ``n`` arguments of ``module``."""
        seq_in = getattr(module, "seq_in", None)
        sp = getattr(module, "seq_split", None)
        return [split_as(getattr(module, "tp_in", None),
                         seq_in[i] if isinstance(seq_in, tuple) else seq_in,
                         sp) for i in range(n)]

    def slice_shards(module):
        """Under a sequence split, the shards of a batched engine call's
        (a, b) slices: an ``a`` slice is the rank's rows (split over the
        seq group along its dimension 0), ``b`` gathered whole."""
        sp = getattr(module, "seq_split", None)
        if mesh is None or seq is None or sp is None:
            return None
        return (TensorShard(seq=seq, seq_dim=0, seq_len=sp.length), None)

    def global_min(a, sh):
        m = a.amin()
        return m if mesh is None else -sh.max(-m)

    def global_max(a, sh):
        m = a.amax()
        return m if mesh is None else sh.max(m)

    def interceptor(next_fun, args, kwargs, context):
        module, path = context.module, context.path
        kind = classify(module)
        cfg = policy.resolve(path, kind)
        if cfg is None and stats_sink is None:
            return next_fun(*args, **kwargs)
        in_shards = arg_shards(module, len(args))
        out_shard = split_as(getattr(module, "tp_out", None),
                             getattr(module, "seq_out", None),
                             getattr(module, "seq_split", None))

        def mod_key(tag: int):
            return None if key is None else fold_in(key,
                                                    module_key(path) ^ tag)

        # A BatchMatmul's 4-D operands ((B, H, S, D) in the decoder's
        # attention) are in the JAX layout already; other 4-D activations
        # are NCHW.
        nchw = kind != LayerKind.BATCH_MATMUL

        def cast(a, tcfg, tag, sh):
            return _in_jax_layout(
                lambda t: fake_quant(t, tcfg, mod_key(tag), sh), a, tcfg,
                nchw)

        if stats_sink is not None:
            rec = stats_sink.setdefault(path, {"kind": kind.value})
            flat = [(a, sh) for a, sh in zip(args, in_shards)
                    if _is_float(a)]
            if flat:
                with torch.no_grad():
                    _fold(rec, "iact_min", torch.stack(
                        [global_min(a, sh) for a, sh in flat]).amin(),
                        torch.minimum)
                    _fold(rec, "iact_max", torch.stack(
                        [global_max(a, sh) for a, sh in flat]).amax(),
                        torch.maximum)
                    _fold(rec, "iact_absmax", torch.stack(
                        [global_max(a.abs(), sh) for a, sh in flat]).amax(),
                        torch.maximum)
                    flat = [a for a, _ in flat]
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

        from .hw_patch import engine_ok as _engine_ok
        engine_ok = not kwargs and _engine_ok(cfg)
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
            ncontr = len(args) - 2 if patched else len(args)
            args = tuple(
                cast(a, cfg.iact, 1, sh)
                if (i < ncontr and _is_float(a)) else a
                for i, (a, sh) in enumerate(zip(args, in_shards)))
        if cfg is not None and cfg.igrad is not None:
            args = tuple(
                grad_cast(a, cfg.igrad, mod_key(2), nchw, sh)
                if _is_float(a) else a for a, sh in zip(args, in_shards))

        if patched_conv:
            from .hw_patch import engine_conv
            out = engine_conv(args[0], module.weight,
                              module.bias if module.use_bias else None,
                              module.strides, module.padding, cfg,
                              mod_key(5), shard)
        elif patched:
            from .hw_patch import engine_matmul
            a, b = args[-2:]
            if hasattr(module, "gathered"):     # a sequence-split operand
                b = module.gathered(b)
            kw = ({} if mesh is None else
                  {"shards": tuple(in_shards[-2:]),
                   "slice_shards": slice_shards(module)})
            out = engine_matmul(a, b, cfg, mod_key(5), shard, **kw)
            if len(args) == 3:          # AddMatmul(inp, a, b)
                out = args[0] + out
        else:
            out = next_fun(*args, **kwargs)

        if stats_sink is not None and _is_float(out):
            rec = stats_sink.setdefault(path, {"kind": kind.value})
            with torch.no_grad():
                _fold(rec, "oact_min", global_min(out, out_shard),
                      torch.minimum)
                _fold(rec, "oact_max", global_max(out, out_shard),
                      torch.maximum)
                _fold(rec, "oact_absmax", global_max(out.abs(), out_shard),
                      torch.maximum)

        if cfg is not None and _is_float(out):
            if cfg.ograd is not None:
                out = grad_cast(out, cfg.ograd, mod_key(3), nchw, out_shard)
            if cfg.oact is not None:
                out = cast(out, cfg.oact, 4, out_shard)
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


def weight_shards(model: torch.nn.Module, mesh) -> Dict[str, Any]:
    """The ``parallel.data.TensorShard`` of every weight that ``model`` (a
    tensor-parallel ``models.transformer`` form) holds split over the
    mesh's model group, by state_dict name, in the Flax layout
    (``tp_weight``); replicated weights have none."""
    from fp8tpu_torch.parallel.data import BatchShard, TensorShard
    model_part = BatchShard.of(mesh.group("model"))
    out = {}
    for name, m in model.named_modules():
        dim = getattr(m, "tp_weight", None)
        if dim is None:
            continue
        leaf = "embedding" if isinstance(m, linen.Embed) else "weight"
        out[f"{name}.{leaf}"] = TensorShard(None, model_part, dim)
    return out


def quantize_params(
    params: Dict[str, torch.Tensor],
    policy: QuantPolicy,
    module_table: Dict[str, LayerKind],
    key: Optional[PRNGKey] = None,
    shards: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Fake-quantize the weights of a state_dict per policy; biases are
    never quantized.  Each weight is cast in its Flax layout, so
    ``channel_axis`` means what it means in the JAX package.  The casts are
    straight-through: a loss through the quantized weights reaches the
    weights passed in.  ``shards`` (:func:`weight_shards`) marks the
    weights that are a rank's shard of a tensor-parallel model: their
    scales are the whole weight's."""
    shards = shards or {}
    out = {}
    for name, leaf in params.items():
        path, _, leaf_name = name.rpartition(".")
        path = path.replace(".", "/")
        kind = module_table.get(path)
        cfg = policy.resolve(path, kind) if kind is not None else None
        if (cfg is not None and cfg.wt is not None
                and leaf_name in _WEIGHT_NAMES):
            k = fold_in(key, module_key(path)) if key is not None else None
            leaf = from_flax_layout(
                fake_quant(to_flax_layout(leaf, kind), cfg.wt, k,
                           shards.get(name)), kind)
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
    mesh=None,
    **kwargs,
):
    """One-shot quantized forward of ``model`` (or of ``params`` in its
    structure): weights and activations per policy.  With ``mesh``,
    ``model`` is the tensor-parallel form on this rank (``models.
    Decoder(cfg, mesh=mesh)``), ``params`` its shards and the arguments
    its rows of the batch: every cast is this rank's share of the
    unsharded cast (:func:`make_quant_interceptor`)."""
    if mesh is not None and getattr(model, "tp", None) is None:
        raise ValueError("a mesh needs the model's tensor-parallel form "
                         "(built with the same mesh)")
    if module_table is None:
        module_table = build_module_table(model)
    if params is None:
        params = model.state_dict()
    if quantize_weights:
        wkey = fold_in(key, 0xE0) if key is not None else None
        params = quantize_params(
            params, policy, module_table, wkey,
            None if mesh is None else weight_shards(model, mesh))
    with linen.intercept_methods(
            make_quant_interceptor(policy, key=key, mesh=mesh), model):
        return functional_call(model, params, args, kwargs)
