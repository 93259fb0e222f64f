"""8-bit optimizer state: Adam moments quantized with per-block scales, the
port of ``fp8tpu/training/opt8.py``.

The first moment m is stored as int8 and the second moment v as e4m3, each
with one f32 absmax scale per block of 256 (``numerics/blockquant.py``):
m is signed and roughly homogeneous within a block, so linear int8 is its
grid; v is non-negative and spread over orders of magnitude within a
block, where the fp8 exponent keeps small entries that int8 would flush
to zero.  All arithmetic is f32; only the carried state is 8-bit, 4x
smaller than f32 moments.

Two forms, both with the JAX package's state layout (per leaf a flat,
zero-padded ``(nblocks, block)`` payload and ``(nblocks,)`` f32 scales):

- :func:`scale_by_adam_8bit` is the functional transformation of the JAX
  package: ``init(params)`` and ``update(grads, state)`` on nests (dicts,
  lists, tuples) of tensors, returning new state.
- :func:`adamw_8bit` returns a ``torch.optim.Optimizer`` over the model's
  tensors, which :func:`fp8tpu_torch.training.make_train_step` takes as it
  takes ``torch.optim.AdamW``.  Its step follows optax's chain of
  ``scale_by_adam_8bit``, ``add_decayed_weights`` and
  ``scale_by_learning_rate`` (not ``torch.optim.AdamW``'s order), so the
  parameters are the JAX package's bit for bit: ``u = adam(g)``, ``u = u +
  wd * p`` (masked), ``p = p + (-lr) * u``.  One launch of P3
  (``kernels/adam8.py::adam8_update_many``) a step does all of it for
  every leaf on the card.

Under tensor parallelism (``shards``: a rank's leaves are its blocks of
the global leaves) the moments stay the global leaves' blocks of 256.  A
leaf whose blocks lie whole on the rank (a row shard at a block edge)
keeps its slice of the global payload and scales and the one launch; a
leaf whose blocks cross ranks (a column shard) stores its own elements'
codes and every block's scale, and takes P3's split-block route, its
blocks' scales the MAX over the model group of the ranks' partial absmax
(one all-reduce a step for all such leaves).

The bias corrections ``1 - b**count`` are computed on the host in f32, and
the learning rate (a float, or a schedule of the count) is read on the
host.  A step that :func:`make_train_step` skips on a non-finite gradient
never reaches the optimizer, so its moments and count stay as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from fp8tpu_torch.kernels.adam8 import (Adam8Args, Leaf, SplitLeaf,
                                        adam8_split_amax, adam8_split_apply,
                                        adam8_update, adam8_update_many,
                                        bias_corrections)
from fp8tpu_torch.quant.interceptor import from_flax_layout, to_flax_layout
from fp8tpu_torch.quant.policy import LayerKind

INT32_MAX = 2 ** 31 - 1


class Moment8(NamedTuple):
    """One quantized moment tensor (flat payload + per-block scales)."""

    payload: torch.Tensor   # (nblocks, block) int8 or float8_e4m3fn
    scale: torch.Tensor     # (nblocks,) f32


class Adam8State(NamedTuple):
    count: torch.Tensor     # () int32
    m: Any                  # nest of Moment8 (int8)
    v: Any                  # nest of Moment8 (e4m3)


class ScaleByScheduleState(NamedTuple):
    """optax's state of a scheduled learning rate: its own count."""

    count: torch.Tensor     # () int32


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a nest of dicts, lists and tuples
    (NamedTuples are leaves, so that a Moment8 travels whole)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


class _Leaf(NamedTuple):
    update: torch.Tensor
    m: Moment8
    v: Moment8


def _nblocks(n: int, block: int) -> int:
    return -(-n // block)


def _zeros(p: torch.Tensor, block: int, dtype) -> Moment8:
    nb = _nblocks(p.numel(), block)
    return Moment8(torch.zeros((nb, block), dtype=dtype, device=p.device),
                   torch.zeros((nb,), dtype=torch.float32, device=p.device))


def _increment(count: int) -> int:
    """``optax.safe_int32_increment``: stops at the int32 maximum."""
    return min(count + 1, INT32_MAX)


def scale_by_adam_8bit(b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8,
                       block: int = 256) -> GradientTransformation:
    """Adam with int8 first / e4m3 second moments (per-block scales), in
    the functional form of the JAX package: ``update(grads, state)`` ->
    ``(updates, new_state)``, the state left as it was."""

    def init(params):
        leaves = []
        _map(leaves.append, params)
        dev = leaves[0].device if leaves else None
        return Adam8State(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=_map(lambda p: _zeros(p, block, torch.int8), params),
            v=_map(lambda p: _zeros(p, block, torch.float8_e4m3fn), params))

    def update(updates, state, params=None):
        del params
        count = _increment(int(state.count))
        args = Adam8Args(b1, b2, eps, *bias_corrections(b1, b2, count))

        def leaf(g, qm, qv):
            g32 = g.to(torch.float32).contiguous()
            out = torch.empty_like(g32)
            m = Moment8(qm.payload.clone(), qm.scale.clone())
            v = Moment8(qv.payload.clone(), qv.scale.clone())
            adam8_update(out, g32, *m, *v, args, mode="store")
            return _Leaf(out.to(g.dtype), m, v)

        outs = _map(leaf, updates, state.m, state.v)
        pick = (lambda i: _map(lambda o: o[i], outs))
        return pick(0), Adam8State(
            count=torch.tensor(count, dtype=torch.int32,
                               device=state.count.device),
            m=pick(1), v=pick(2))

    return GradientTransformation(init, update)


def _flax_name(name: str, kind: Optional[LayerKind]) -> str:
    """A parameter's Flax path (``layer_0/attn/q_proj/kernel``), as the
    training casts name it (``training/mpt.py::_entries``)."""
    path, _, leaf = name.rpartition(".")
    if leaf == "weight":
        leaf = ("kernel" if kind in (LayerKind.CONV, LayerKind.DENSE)
                else "scale")
    return f"{path.replace('.', '/')}/{leaf}" if path else leaf


class Adam8W(torch.optim.Optimizer):
    """AdamW with 8-bit moments, in optax's order (see the module
    docstring).  Built by :func:`adamw_8bit`."""

    def __init__(self, params, learning_rate, b1: float, b2: float,
                 eps: float, weight_decay: float, block: int, mask,
                 module_table: Optional[Dict[str, LayerKind]],
                 shards: Optional[Dict] = None):
        named = (list(params.items()) if isinstance(params, dict)
                 else [(str(i), p) for i, p in enumerate(params)])
        super().__init__([p for _, p in named], dict(
            lr=learning_rate, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, block=block, count=0))
        self.names = [n for n, _ in named]
        # With a module table the state is keyed as the JAX package keys it
        # over the model's Flax variables (see chain_state).
        self.flax = module_table is not None
        table = module_table or {}
        self.kinds = {n: table.get(n.rpartition(".")[0].replace(".", "/"))
                      for n in self.names}
        if callable(mask):
            mask = mask(dict(named))
        self.decay = {n: bool(weight_decay) and (mask is None or bool(
            mask[n])) for n in self.names}
        # name -> (Block of the Flax-layout view in the global leaf, split)
        self.blocks: Dict[str, Any] = {}
        for n, sh in (shards or {}).items():
            self.blocks[n] = self._placement(n, sh, block)
        for n, p in named:
            if self.blocks.get(n, (None, False))[1]:
                blk = self.blocks[n][0]
                nb = _nblocks(math.prod(blk.shape), block)
                for which, dt in (("m", torch.int8),
                                  ("v", torch.float8_e4m3fn)):
                    self.state[p][which] = Moment8(
                        torch.zeros(p.numel(), dtype=dt, device=p.device),
                        torch.zeros(nb, dtype=torch.float32,
                                    device=p.device))
            else:
                self.state[p]["m"] = _zeros(p, block, torch.int8)
                self.state[p]["v"] = _zeros(p, block, torch.float8_e4m3fn)
        self.shards = shards or {}
        self._table = None      # P3's leaf table, kept while it matches

    def _placement(self, name: str, shard, block: int):
        """(the Flax-layout view's ``Block`` in the global leaf, whether its
        moment blocks cross ranks)."""
        p = dict(zip(self.names, self.param_groups[0]["params"]))[name]
        view = self._layout(name, p)
        blk = shard.block(view.shape)
        off = blk.contiguous_offset(view.shape)
        total = math.prod(blk.shape)
        whole = off is not None and off % block == 0 and (
            view.numel() % block == 0 or off + view.numel() == total)
        if not whole and view.ndim != 2:
            raise NotImplementedError(
                f"8-bit moments of {name}: a split {view.ndim}-D leaf")
        return blk, not whole

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    def _layout(self, name: str, t: torch.Tensor):
        """The leaf in the order its moments are kept: a Dense kernel's
        (in, out) (a strided view of the (out, in) weight), a conv's HWIO
        (a copy), else the tensor as it is."""
        kind = self.kinds[name]
        if kind in (LayerKind.CONV, LayerKind.DENSE) and t.ndim in (2, 4):
            v = to_flax_layout(t, kind)
            return v if t.ndim == 2 else v.contiguous()
        return t if t.is_contiguous() else t.contiguous()

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        lr, count = group["lr"], group["count"]
        neg_lr = -float(lr(count) if callable(lr) else lr)
        new = _increment(count)
        b1, b2 = group["b1"], group["b2"]
        args = Adam8Args(b1, b2, group["eps"], *bias_corrections(b1, b2, new),
                         weight_decay=group["weight_decay"], neg_lr=neg_lr)
        leaves, split, copies = [], [], []
        for name, p in zip(self.names, group["params"]):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            pv, gv = self._layout(name, p), self._layout(name, g)
            st = self.state[p]
            mode = "apply_decay" if self.decay[name] else "apply"
            blk, crosses = self.blocks.get(name, (None, False))
            if crosses:
                split.append((name, SplitLeaf(
                    pv, gv, *st["m"], *st["v"], blk.start[0], blk.start[1],
                    blk.shape[1], mode)))
            else:
                leaves.append(Leaf(pv, gv, *st["m"], *st["v"], mode=mode))
            if pv.data_ptr() != p.data_ptr():
                copies.append((p, pv, self.kinds[name]))
        self._table = adam8_update_many(leaves, args, self._table)
        if split:
            self._split_step(split, args)
        for p, pv, kind in copies:
            p.copy_(from_flax_layout(pv, kind))
        group["count"] = new
        return loss

    def _split_step(self, split, args: Adam8Args) -> None:
        """The leaves whose blocks cross ranks: the partial absmax of every
        block, one MAX all-reduce over the model group, then the
        quantization by the reduced scales and the update."""
        import torch.distributed as dist
        # one buffer, each leaf's (2, nblocks) slots contiguous in it
        sizes = [2 * lf.ms.numel() for _, lf in split]
        amax = torch.zeros(sum(sizes), dtype=torch.int32,
                           device=split[0][1].p.device)
        parts = [part.view(2, -1) for part in amax.split(sizes)]
        for (_, lf), part in zip(split, parts):
            adam8_split_amax(lf, args, part)
        group = self.shards[split[0][0]].model.group
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        for (_, lf), part in zip(split, parts):
            adam8_split_apply(lf, args, part)

    # -- the JAX package's state tree ------------------------------------------

    def chain_state(self):
        """The optimizer's state as the JAX package's ``optax.chain`` state
        of ``adamw_8bit`` (``Adam8State``, the decay's empty state, and the
        schedule's count when the learning rate is a schedule).  Given a
        module table, the moments are keyed as the JAX package keys them
        over the model's Flax variables: nested dicts of Flax paths
        (``{"params": {"layer_0": {"attn": {"q_proj": {"kernel": ...}}}}}``,
        the npz keys ``examples/train_fp8.py`` writes); else by parameter
        name."""
        group = self.param_groups[0]
        dev = group["params"][0].device if group["params"] else None

        def count():
            return torch.tensor(group["count"], dtype=torch.int32, device=dev)

        def moments(which):
            tree: Dict[str, Any] = {}
            for name, p in zip(self.names, group["params"]):
                *path, leaf = self._path(name)
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = self.state[p][which]
            return tree

        chain = [Adam8State(count=count(), m=moments("m"), v=moments("v"))]
        if group["weight_decay"]:
            chain.append(())
        chain.append(ScaleByScheduleState(count()) if callable(group["lr"])
                     else ())
        return tuple(chain)

    def global_chain_state(self):
        """:meth:`chain_state` with every sharded leaf's moments as the
        global leaf's (the payload (nblocks, 256) and scales a
        single-process run holds; the padding's codes 0).  Collective over
        each shard's model group: every rank calls it and gets the global
        state, which a model-parallel run saves."""
        chain = self.chain_state()
        if not self.shards:
            return chain
        params = dict(zip(self.names, self.param_groups[0]["params"]))

        def whole(tree, which):
            out = {}
            for k, v in tree.items():
                out[k] = (whole(v, which) if isinstance(v, dict) else v)
            return out

        adam = chain[0]
        for which in ("m", "v"):
            tree = whole(getattr(adam, which), which)
            for name, sh in self.shards.items():
                node, path = tree, self._path(name)
                for part in path[:-1]:
                    node = node[part]
                node[path[-1]] = self._global_moment(name, params[name], sh,
                                                     which)
            adam = adam._replace(**{which: tree})
        return (adam,) + tuple(chain[1:])

    def _global_moment(self, name, p, shard, which) -> Moment8:
        from fp8tpu_torch.parallel.collectives import gather_dim
        st = self.state[p][which]
        blk, crosses = self.blocks[name]
        block = st.payload.shape[-1] if not crosses else 256
        nb = _nblocks(math.prod(blk.shape), block)
        group = shard.model.group
        if not crosses:
            return Moment8(gather_dim(st.payload, 0, group)[:nb],
                           gather_dim(st.scale, 0, group)[:nb])
        view = self._layout(name, p)
        codes = gather_dim(st.payload.reshape(1, -1), 0, group)
        flat = torch.zeros(nb * block, dtype=torch.uint8, device=p.device)
        for r in range(shard.model.count):
            other = dataclasses.replace(
                shard, model=dataclasses.replace(shard.model, index=r))
            idx = other.block(view.shape).index(view.shape, p.device)
            flat[idx] = codes[r].view(torch.uint8)
        return Moment8(flat.view(st.payload.dtype).reshape(nb, block),
                       st.scale.clone())

    def load_global_chain_state(self, chain) -> None:
        """Load a global state (:meth:`global_chain_state`'s form, or a
        single-process run's :meth:`chain_state`): each sharded leaf takes
        its block of the global moments (no collective)."""
        adam = chain[0]
        group = self.param_groups[0]
        for name, p in zip(self.names, group["params"]):
            for which in ("m", "v"):
                src = getattr(adam, which)
                for part in self._path(name):
                    src = src[part]
                src = Moment8(*(_as_tensor(t, d) for t, d in
                                zip(src, self.state[p][which])))
                dst = self.state[p][which]
                if name not in self.shards:
                    for s_, d in zip(src, dst):
                        d.copy_(s_)
                    continue
                blk, crosses = self.blocks[name]
                view = self._layout(name, p)
                if crosses:
                    idx = blk.index(view.shape, p.device)
                    dst.payload.copy_(src.payload.reshape(-1)[idx.to(
                        src.payload.device)])
                    dst.scale.copy_(src.scale)
                else:
                    b0 = blk.contiguous_offset(view.shape) // \
                        dst.payload.shape[-1]
                    nb = dst.payload.shape[0]
                    dst.payload.copy_(src.payload[b0:b0 + nb])
                    dst.scale.copy_(src.scale[b0:b0 + nb])
        group["count"] = int(adam.count)

    def _path(self, name: str):
        """The keys of a leaf's moments in :meth:`chain_state`."""
        if not self.flax:
            return [name]
        return ["params"] + _flax_name(name, self.kinds[name]).split("/")

    def load_chain_state(self, chain) -> None:
        """Load a state tree of :meth:`chain_state`'s form (tensors or numpy
        arrays, the JAX package's own state when a module table was
        given), copying every payload and scale byte for byte."""
        adam = chain[0]
        group = self.param_groups[0]

        def find(tree, name):
            for part in self._path(name):
                tree = tree[part]
            return tree

        for name, p in zip(self.names, group["params"]):
            for which in ("m", "v"):
                src, dst = find(getattr(adam, which), name), self.state[p][
                    which]
                for s, d in zip(src, dst):
                    d.copy_(_as_tensor(s, d))
        group["count"] = int(adam.count)


def _as_tensor(a, like: torch.Tensor) -> torch.Tensor:
    """A numpy array (fp8 as ml_dtypes, or raw bytes) or tensor as a tensor
    of ``like``'s dtype, the bytes unchanged."""
    if isinstance(a, torch.Tensor):
        return a
    import numpy as np
    a = np.array(a)
    if like.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return torch.from_numpy(a.view(np.uint8)).view(like.dtype)
    return torch.from_numpy(a)


def adamw_8bit(params, learning_rate, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 1e-4,
               block: int = 256, mask=None,
               module_table: Optional[Dict[str, LayerKind]] = None,
               shards: Optional[Dict] = None) -> Adam8W:
    """AdamW with 8-bit moments over ``params`` (a dict of named tensors,
    or an iterable of tensors), with the defaults of the JAX package's
    ``adamw_8bit`` (``optax.adamw``'s, weight_decay=1e-4).

    ``learning_rate`` is a float or a schedule (count -> float);
    ``mask`` a dict of names -> bool (or a callable of the params dict
    giving one) choosing the leaves that take the weight decay.  With the
    emulator's ``module_table``, Dense and Conv kernels keep their moments
    in the Flax layout, so that their blocks are the JAX package's.
    ``shards`` (``quant.interceptor.weight_shards`` of a tensor-parallel
    model, or the emulator's ``shards``): ``params`` are a rank's shards,
    and their moments the global leaves' blocks (module docstring)."""
    return Adam8W(params, learning_rate, b1, b2, eps, weight_decay, block,
                  mask, module_table, shards)


def state_bytes(state) -> int:
    """Total bytes of an optimizer state: a nest of tensors (an
    ``Adam8State`` or a chain of them), or a ``torch.optim.Optimizer``
    (for :class:`Adam8W` its :meth:`~Adam8W.chain_state`, which the JAX
    package's function counts the same; for another optimizer the tensors
    it holds)."""
    if isinstance(state, Adam8W):
        state = state.chain_state()
    elif isinstance(state, torch.optim.Optimizer):
        state = [v for s in state.state.values() for v in s.values()]
    total = 0

    def add(t):
        nonlocal total
        if isinstance(t, tuple):            # a Moment8 or another NamedTuple
            for x in t:
                _map(add, x)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()

    _map(add, state)
    return total
