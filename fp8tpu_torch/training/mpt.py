"""FP8 mixed-precision training: the port of ``fp8tpu/training/mpt.py``.

The reference trains with FP32 master weights and, after each optimizer
step, stochastically requantizes the master copy to FP16 (embeddings
optionally to row-block-normalized FP8).  The step is the JAX package's
pipeline around a ``torch.optim`` optimizer:

    grads  = grad(quantized forward)       # fwd/bwd casts per policy
    grads  = quantize_wtgrads(grads)       # wtgrad role
    optimizer.step()                       # skipped on a non-finite grad
    params = master_requant(params)        # FLOAT16_STOCHASTIC + emb FP8

Parameters are a dict of the model's own tensors under torch names
(``stage0_block0.conv1.weight``).  The casts walk it under the JAX
package's names and layouts: a Conv or Dense ``weight`` is the Flax
``kernel`` (cast as HWIO / (in, out)), a norm's ``weight`` its ``scale``,
so SR streams (keyed by ``path/leaf`` and the row-major index) and
scales are the JAX package's.  The optimizer updates the tensors in
place.  ``optax.sgd(lr, momentum)`` is ``torch.optim.SGD(lr, momentum,
dampening=0)``; ``optax.adamw`` is ``torch.optim.AdamW`` with the same
hyperparameters; the JAX package's ``adamw_8bit`` is
:func:`fp8tpu_torch.training.adamw_8bit` (given the emulator's module
table, so that its moments keep the JAX package's layout).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call

from fp8tpu_torch import linen
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.numerics.prng import PRNGKey
from fp8tpu_torch.quant.config import TensorQuantConfig
from fp8tpu_torch.quant.fakequant import fake_quant
from fp8tpu_torch.quant.interceptor import (
    build_module_table,
    from_flax_layout,
    make_quant_interceptor,
    module_key,
    quantize_params,
    to_flax_layout,
)
from fp8tpu_torch.quant.policy import LayerKind, QuantPolicy, get_policy

MASTER_CFGS = {
    "fp32": None,
    "fp16": TensorQuantConfig("float16", "stochastic", cast_impl="hw"),
    "float16": TensorQuantConfig("float16", "stochastic", cast_impl="hw"),
    "e5m2": TensorQuantConfig("e5m2", "stochastic", cast_impl="hw"),
}

EMB_CFGS = {
    None: None,
    "e5m2": TensorQuantConfig("e5m2", "stochastic", "per-block"),
    "e4m3": TensorQuantConfig("e4m3", "stochastic", "per-block"),
    "e3m4": TensorQuantConfig("e3m4", "stochastic", "per-block"),
}

Params = Dict[str, torch.Tensor]


def _entries(tensors: Params, module_table: Dict[str, LayerKind]):
    """(name, module path, Flax leaf name, kind, tensor) per entry."""
    for name, t in tensors.items():
        path, _, leaf = name.rpartition(".")
        path = path.replace(".", "/")
        kind = module_table.get(path)
        if leaf == "weight":
            leaf = ("kernel" if kind in (LayerKind.CONV, LayerKind.DENSE)
                    else "scale")
        yield name, path, leaf, kind, t


def _cast_flax(t, kind, cfg, key, shard=None):
    """``fake_quant`` of a parameter-shaped tensor in its Flax layout
    (``shard``: a tensor-parallel rank's block of the leaf in that layout,
    so that its scale and SR bits are the whole leaf's, trap 22)."""
    return from_flax_layout(fake_quant(to_flax_layout(t, kind), cfg, key,
                                       shard), kind)


def master_requant(params: Params, module_table: Dict[str, LayerKind],
                   key: PRNGKey, master_fmt: str = "fp16",
                   emb_fmt: Optional[str] = None,
                   shards: Optional[Dict] = None) -> Params:
    """Requantize master params after the optimizer update.  Embeddings
    optionally cast to FP8 with per-row block-norm scaling (the block is
    the embedding row).  ``shards`` (``interceptor.weight_shards``): the
    leaves that are a rank's shard of a tensor-parallel model, each cast
    as its block of the whole leaf's cast (a vocabulary shard's rows at
    their contiguous offset)."""
    master_cfg = MASTER_CFGS[master_fmt]
    emb_cfg = EMB_CFGS[emb_fmt]
    shards = shards or {}
    out = {}
    for name, path, leaf, kind, t in _entries(params, module_table):
        k = prng.fold_in(key, module_key(f"{path}/{leaf}"))
        if emb_cfg is not None and kind == LayerKind.EMBED and t.ndim == 2:
            cfg = dataclasses.replace(emb_cfg, block_size=t.shape[1])
            t = fake_quant(t, cfg, k, shards.get(name))
        elif master_cfg is not None and t.is_floating_point():
            t = _cast_flax(t, kind, master_cfg, k, shards.get(name))
        out[name] = t
    return out


def quantize_wtgrads(grads: Params, policy: QuantPolicy,
                     module_table: Dict[str, LayerKind],
                     key: PRNGKey, shards: Optional[Dict] = None) -> Params:
    """Apply the wtgrad role to weight gradients (``shards`` as in
    :func:`master_requant`: a split leaf's scale over the model group, its
    SR bits at the Flax layout's global indices)."""
    shards = shards or {}
    out = {}
    for name, path, leaf, kind, g in _entries(grads, module_table):
        cfg = policy.resolve(path, kind) if kind is not None else None
        if (cfg is not None and cfg.wtgrad is not None
                and leaf in ("kernel", "embedding", "scale")):
            g = _cast_flax(g, kind, cfg.wtgrad,
                           prng.fold_in(key, module_key(f"{path}/{leaf}")),
                           shards.get(name))
        out[name] = g
    return out


@dataclasses.dataclass
class MPTEmulator:
    """Policy, module table and master-precision settings of one model
    (the reference's MPTEmulator).  Stateless: tensors live in the
    caller's parameters and optimizer.  With ``mesh`` the model is the
    tensor-parallel form on this rank (``models.Decoder(cfg, mesh=)``):
    every cast takes its operand's or leaf's split (``shards``: the
    weights the model holds split over the model group)."""

    model: torch.nn.Module
    policy: QuantPolicy
    module_table: Dict[str, LayerKind]
    master_fmt: str = "fp16"
    emb_fmt: Optional[str] = None
    mesh: Optional[object] = None

    @property
    def shards(self) -> Optional[Dict]:
        if self.mesh is None:
            return None
        if getattr(self, "_shards", None) is None:
            from fp8tpu_torch.quant.interceptor import weight_shards
            self._shards = weight_shards(self.model, self.mesh)
        return self._shards

    def set_master_param_precision(self, fmt: str) -> "MPTEmulator":
        return dataclasses.replace(self, master_fmt=fmt)

    def set_embedding_precision(self, fmt: Optional[str],
                                emb_norm: bool = True) -> "MPTEmulator":
        return dataclasses.replace(self, emb_fmt=fmt)

    def blacklist_modules(self, *patterns: str) -> "MPTEmulator":
        return dataclasses.replace(
            self, policy=self.policy.with_exempt(*patterns))

    def apply_quantized(self, params: Params, *args,
                        key: Optional[PRNGKey] = None, shard=None,
                        **kwargs):
        """Forward with weight, activation and gradient-stream casts; the
        gradient reaches ``params`` straight through the weight casts.
        ``shard``: the arguments are a rank's rows of a data-parallel batch
        (``make_quant_interceptor``)."""
        params = quantize_params(
            params, self.policy, self.module_table,
            prng.fold_in(key, 1) if key is not None else None, self.shards)
        with linen.intercept_methods(
                make_quant_interceptor(self.policy, key=key, shard=shard,
                                       mesh=self.mesh),
                self.model):
            return functional_call(self.model, params, args, kwargs)

    def quantize_grads(self, grads: Params, key: PRNGKey) -> Params:
        return quantize_wtgrads(grads, self.policy, self.module_table, key,
                                self.shards)

    def post_update(self, params: Params, key: PRNGKey) -> Params:
        return master_requant(params, self.module_table, key,
                              self.master_fmt, self.emb_fmt, self.shards)


def initialize(
    model: torch.nn.Module,
    sample_args: tuple = (),
    training_algo: str = "hybrid",
    master_fmt: str = "fp16",
    emb_fmt: Optional[str] = None,
    exempt_layers: tuple = (),
    device="cuda",
    mesh=None,
) -> MPTEmulator:
    """FP8 mixed-precision training setup.  ``training_algo``: 'direct'
    (all-E5M2), 'hybrid' (E4M3 forward / E5M2 backward), 'bfloat16' or any
    training preset of ``get_policy``.  Moves ``model`` to ``device`` (CUDA
    unless the caller asks for the CPU).  ``mesh``: ``model`` is the
    tensor-parallel form built over it (``models.Decoder(cfg,
    mesh=mesh)``), and the steps of :func:`make_train_step` are the global
    step over the mesh."""
    if mesh is not None and getattr(model, "tp", None) is None:
        raise ValueError("a mesh needs the model's tensor-parallel form "
                         "(built with the same mesh)")
    policy = get_policy(training_algo, training=True)
    if exempt_layers:
        policy = policy.with_exempt(*exempt_layers)
    model.to(resolve_device(device))
    del sample_args  # the table comes from named_modules; kept for the API
    return MPTEmulator(model=model, policy=policy,
                       module_table=build_module_table(model),
                       master_fmt=master_fmt, emb_fmt=emb_fmt, mesh=mesh)


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    """Dynamic loss scale: halves on overflow, doubles after
    ``growth_interval`` consecutive clean steps."""

    scale: float
    good_steps: int = 0

    def after(self, finite: bool, growth_interval: int, max_scale: float,
              min_scale: float) -> "LossScaleState":
        if not finite:
            return LossScaleState(max(self.scale * 0.5, min_scale), 0)
        good = self.good_steps + 1
        if good >= growth_interval:
            return LossScaleState(min(self.scale * 2.0, max_scale), 0)
        return LossScaleState(self.scale, good)


def token_shard(mesh):
    """The ``BatchShard`` of the group over which a mesh's ranks hold
    different tokens (host x data x seq): the group the loss and the raw
    gradients are summed over."""
    from fp8tpu_torch.parallel.data import BatchShard
    return BatchShard.of(mesh.group("host", "data", "seq"))


def world_all(ok: torch.Tensor) -> torch.Tensor:
    """``ok`` (a bool) on every rank of the world: the MIN all-reduce."""
    import torch.distributed as dist
    flag = ok.to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return flag[0] > 0


class LMBatch:
    """A rank's block of a language-model batch under a mesh: ``inputs``
    and ``labels`` (the global tokens shifted by one, then split: rows over
    the data group, a chunk of the ``length`` positions over the seq
    group, the last chunk short where ``length`` does not divide), and
    ``tokens``, the global count of labels the loss is over."""

    def __init__(self, inputs, labels, length: int, tokens: int):
        self.inputs, self.labels = inputs, labels
        self.length, self.tokens = length, tokens


def lm_batch(tokens: torch.Tensor, mesh=None) -> LMBatch:
    """This rank's :class:`LMBatch` of the global (B, S + 1) ``tokens``
    (``batch_sharding(mesh, seq_parallel=True)``: rows over host x data,
    positions over seq), split after the shift (GSPMD pads the uneven
    split of ``tokens[:, :-1]``; the port keeps the global length in every
    offset and gather instead); the whole batch without a mesh."""
    from fp8tpu_torch.parallel.data import seq_chunk
    from fp8tpu_torch.parallel.sharding import batch_sharding
    B, S = tokens.shape[0], tokens.shape[1] - 1
    if mesh is None:
        return LMBatch(tokens[:, :-1], tokens[:, 1:], S, B * S)
    row_axes, seq_axes = batch_sharding(mesh, seq_parallel=True).spec[:2]
    i, n = mesh.split(row_axes)
    s, ns = mesh.split(seq_axes)
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} "
                         "ranks")
    rows, chunk = B // n, seq_chunk(S, ns)
    r = slice(i * rows, (i + 1) * rows)
    c = slice(s * chunk, min((s + 1) * chunk, S))
    return LMBatch(tokens[r, :-1][:, c], tokens[r, 1:][:, c], S, B * S)


def lm_loss(apply_fn, params, batch: LMBatch) -> torch.Tensor:
    """The mean cross entropy of a language model over the global batch,
    as this rank's share: its tokens' sum over the global count (one
    correctly rounded divide, trap 80)."""
    import torch.nn.functional as F
    logits = apply_fn(params, batch.inputs, seq_len=batch.length)
    s = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                        batch.labels.reshape(-1), reduction="sum")
    return s / torch.tensor(float(batch.tokens), device=s.device)


def init_train_state(optimizer: torch.optim.Optimizer,
                     loss_scale: Optional[float] = 2.0 ** 12):
    """The ``opt_state`` of :func:`make_train_step`: the optimizer (which
    holds its moments) with the dynamic loss-scale carry, or the bare
    optimizer when ``loss_scale`` is None."""
    if loss_scale is None:
        return optimizer
    return optimizer, LossScaleState(float(loss_scale))


def step_grads(emulator: MPTEmulator, loss_fn: Callable[..., torch.Tensor],
               params: Params, batch, key: PRNGKey,
               scale: Optional[float] = None, shard=None):
    """The gradient half of a train step with ``key``: ``(loss, grads)`` of
    ``loss_fn`` through the quantized forward, the loss multiplied by
    ``scale`` for the backward, the wtgrad casts, then both unscaled.

    With ``shard`` (a ``parallel.data.BatchShard``) ``batch`` is this
    rank's rows of the global batch, and ``loss_fn`` must return the rank's
    share of the global loss (its rows' sum over the global count): the
    activation and gradient casts take the global batch's scales and SR
    bits, the raw gradients and the loss are summed over the shard's group,
    and only then do the wtgrad casts run, so every rank holds the global
    step's gradients.

    With the emulator's mesh ``batch`` is this rank's block of the global
    batch (its rows over data, its positions over seq: :func:`lm_batch`)
    and ``params`` its shards; ``loss_fn`` returns the rank's tokens' share
    of the global loss.  The raw gradients and the loss are summed over
    data x seq, never over model: a leaf split over model is the rank's
    block of the gradient, and one replicated over it (a norm's scale)
    is already whole on every model rank, its input gradient summed
    inside the model (``parallel.collectives.column_input``)."""
    kf, kg, _ = prng.split(key, 3)
    names = list(params)
    loss = loss_fn(lambda v, *a, **kw: emulator.apply_quantized(
        v, *a, key=kf, shard=shard, **kw), params, batch)
    if scale is not None:
        loss = loss * scale
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g
             for n, g in zip(names, grads)}
    loss = loss.detach()
    if emulator.mesh is not None:
        shard = token_shard(emulator.mesh)
    if shard is not None:
        grads = shard.sum_grads(grads)
        loss = shard.sum(loss)
    grads = emulator.quantize_grads(grads, kg)
    if scale is not None:
        loss = loss / scale
        grads = {n: (g / torch.full_like(g, scale)).to(g.dtype)
                 for n, g in grads.items()}
    return loss, grads


def make_train_step(
    emulator: MPTEmulator,
    loss_fn: Callable[..., torch.Tensor],
    loss_scale: Optional[float] = 2.0 ** 12,
    growth_interval: int = 2000,
    max_scale: float = 2.0 ** 24,
    min_scale: float = 1.0,
    shard=None,
):
    """A train step running the whole MPT pipeline.

    ``loss_fn(apply_fn, params, batch)``, where ``apply_fn`` is the
    quantized forward.  Returns ``step(params, opt_state, batch, key) ->
    (params, opt_state, loss)`` with ``opt_state`` from
    :func:`init_train_state`; ``params`` are the tensors the optimizer was
    built over, updated in place.

    The loss is multiplied by the carried scale before the backward, so
    the cast gradient streams see values above their flush thresholds;
    gradients are unscaled after the wtgrad casts.  On a non-finite
    gradient the step is a true skip: parameters, optimizer moments and
    step count stay as they were, and the scale halves.

    ``shard``: data parallelism as the global step (:func:`step_grads`);
    every rank then holds the same gradients, so the finite check, the
    update and the loss scale agree on all ranks.  With the emulator's
    mesh each rank holds its shards' gradients only, so the finite check
    is reduced over the whole world: every rank skips or keeps a step
    alike, and the loss-scale trajectory is the global one."""
    use_scale = loss_scale is not None

    def step(params: Params, opt_state, batch, key: PRNGKey):
        is_wrapped = (isinstance(opt_state, tuple) and len(opt_state) == 2
                      and isinstance(opt_state[1], LossScaleState))
        if use_scale != is_wrapped:
            raise ValueError(
                f"loss_scale mismatch: make_train_step(loss_scale="
                f"{'on' if use_scale else 'None'}) but init_train_state "
                f"produced a {'wrapped' if is_wrapped else 'bare'} "
                f"opt_state; pass the same loss_scale to both")
        optimizer, ls = opt_state if use_scale else (opt_state, None)
        loss, grads = step_grads(emulator, loss_fn, params, batch, key,
                                 None if ls is None else ls.scale, shard)
        # The one host read of the step: torch.optim updates its moments
        # and step count in place, so whether the update happens at all
        # must be known before optimizer.step() runs.
        ok = torch.stack([torch.isfinite(g).all()
                          for g in grads.values()]).all()
        if emulator.mesh is not None:
            ok = world_all(ok)
        finite = bool(ok)
        if finite:
            for n, p in params.items():
                p.grad = grads[n]
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                new = emulator.post_update(params, prng.split(key, 3)[2])
                for n, p in params.items():
                    if new[n] is not p:
                        p.copy_(new[n])
        if ls is None:
            return params, optimizer, loss
        ls = ls.after(finite, growth_interval, max_scale, min_scale)
        return params, (optimizer, ls), loss

    return step
