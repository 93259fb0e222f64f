"""Sharding rules for data / tensor / sequence parallel execution, the
counterpart of ``fp8tpu/parallel/sharding.py``.

The rules are the JAX package's, copied: a parameter's path (Flax's,
``layer_0/attn/q_proj/kernel``) picks a :class:`PartitionSpec` naming the
mesh axis each tensor dimension is split over, repaired per leaf for rank
and divisibility.  FP8 payloads shard like their bf16 counterparts,
per-channel scales with their channel axis, per-tensor scales replicate.

A torch state_dict is matched under the Flax names and layouts that
``models.variables_to_flax`` gives it (a Dense ``weight`` (out, in) is the
``kernel`` (in, out)), and its spec is mapped back to the torch layout, so
``shard_params`` places every tensor as the JAX package places its Flax
twin.  Placement makes DTensors (``distribute_tensor``) with ``Shard(d)``
along each mesh axis a spec names and ``Replicate()`` along the others.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, Optional, Tuple

from .mesh import Mesh


class PartitionSpec(tuple):
    """Per-dimension mesh axes (``None``: not split; a tuple of axes: split
    over their product, the first outermost), as ``jax.sharding.
    PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A spec on a mesh; ``placements`` are the DTensor placements, one a
    mesh axis."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, part in enumerate(self.spec)
                    if part == axis or (isinstance(part, tuple)
                                        and axis in part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


# -- Decoder (training form) sharding rules: path glob -> PartitionSpec ----
# Megatron-style TP: column-parallel up-projections, row-parallel
# down-projections; the row-parallel outputs carry the reduction.
DECODER_PARAM_RULES: Tuple[Tuple[str, P], ...] = (
    ("embed/embedding", P("model", None)),          # vocab-sharded
    ("*/q_proj/kernel", P(None, "model")),
    ("*/k_proj/kernel", P(None, "model")),
    ("*/v_proj/kernel", P(None, "model")),
    ("*/o_proj/kernel", P("model", None)),
    ("*/gate_proj/kernel", P(None, "model")),
    ("*/up_proj/kernel", P(None, "model")),
    ("*/down_proj/kernel", P("model", None)),
    ("*/lm_head/kernel", P(None, "model")),
    ("*", P()),                                     # norms etc. replicate
)

# MoE decoder (DecoderConfig.n_experts > 0): experts shard over the
# ``model`` axis (expert parallelism, parallel/moe.py); the router
# replicates.  Dense layers keep the Megatron TP rules above.
MOE_PARAM_RULES: Tuple[Tuple[str, P], ...] = (
    ("*/moe/up", P("model", None, None)),
    ("*/moe/down", P("model", None, None)),
    ("*/moe/router/kernel", P()),
) + DECODER_PARAM_RULES

# -- Serving params (stacked (L, K, N) payloads + (L, N) scales) ----------
SERVE_PARAM_RULES: Tuple[Tuple[str, P], ...] = (
    ("embed", P("model", None)),
    ("q8", P(None, None, "model")), ("qs", P(None, "model")),
    ("k8", P(None, None, "model")), ("ks", P(None, "model")),
    ("v8", P(None, None, "model")), ("vs", P(None, "model")),
    ("o8", P(None, "model", None)), ("os", P(None, None)),
    ("gate8", P(None, None, "model")), ("gates", P(None, "model")),
    ("up8", P(None, None, "model")), ("ups", P(None, "model")),
    ("down8", P(None, "model", None)), ("downs", P(None, None)),
    # MoE serving artifact (L, E, K, N) expert stacks: experts over the
    # model axis (expert parallelism); router replicates.
    ("router", P()),
    ("eup8", P(None, "model", None, None)), ("eups", P(None, "model", None)),
    ("edown8", P(None, "model", None, None)),
    ("edowns", P(None, "model", None)),
    ("*", P()),
)

# KV cache (L, B, S, KV, D): slots over data, kv-heads over model.
KV_CACHE_SPEC = P(None, "data", None, "model", None)
KV_SCALE_SPEC = P(None, "data", None, "model")


def _match_spec(path: str, rules) -> P:
    for pattern, spec in rules:
        if fnmatch.fnmatch(path, pattern):
            return spec
    return P()


def _shrink_spec(spec: P, shape, mesh: Mesh) -> P:
    """Drop or keep axes so the spec is valid for this leaf: rank-match
    and divisibility (replicate anything that doesn't divide)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts = parts[:len(shape)]
    fixed = []
    for dim, ax in zip(shape, parts):
        if ax is None:
            fixed.append(None)
        else:
            fixed.append(ax if dim % mesh.shape[ax] == 0 else None)
    return P(*fixed)


# torch layout <- Flax layout of a leaf: the torch dim of each Flax dim.
_DENSE = (1, 0)                 # (in, out) kernel <- (out, in) weight
_CONV = (2, 3, 1, 0)            # HWIO kernel <- OIHW weight


def _flax_name(name: str, module_table: Dict):
    """(Flax path, torch-dims-of-each-Flax-dim or None) of a state_dict
    name, as ``models.variables_to_flax`` maps it."""
    from fp8tpu_torch.quant.policy import LayerKind
    path, _, leaf = name.rpartition(".")
    mpath = path.replace(".", "/")
    kind = module_table.get(mpath)
    perm = None
    if leaf == "weight" and kind in (LayerKind.DENSE, LayerKind.CONV):
        leaf, perm = "kernel", (_DENSE if kind == LayerKind.DENSE else _CONV)
    elif leaf in ("running_mean", "running_var"):
        leaf = leaf[len("running_"):]
    elif leaf == "weight":
        leaf = "scale"
    return (f"{mpath}/{leaf}" if mpath else leaf), perm


def _leaf_spec(path: str, shape, mesh: Mesh, rules, perm=None) -> P:
    """The repaired spec of a leaf matched under ``path``; ``perm`` maps a
    Flax-layout spec onto the torch layout (``shape`` is the torch one)."""
    if perm is None:
        return _shrink_spec(_match_spec(path, rules), shape, mesh)
    flax_shape = [shape[d] for d in perm]
    fspec = _shrink_spec(_match_spec(path, rules), flax_shape, mesh)
    parts = [None] * len(shape)
    for fdim, tdim in enumerate(perm):
        parts[tdim] = fspec[fdim]
    return P(*parts)


def _walk(tree, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _walk(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _rebuild(items):
    out: Dict = {}
    for keys, v in items:
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def shard_tree(tree, mesh: Mesh, rules, module_table: Optional[Dict] = None):
    """A :class:`NamedSharding` for every leaf of ``tree`` per path rules
    (rank / divisibility repaired per leaf), in ``tree``'s structure.

    ``tree`` is either nested dicts in the Flax layout (a leading "params"
    level is dropped from the path, as the JAX package does) or, given the
    model's ``module_table``, a flat torch state_dict, matched under its
    Flax names with the spec mapped to the torch layout."""
    if module_table is not None:
        out = {}
        for name, t in tree.items():
            path, perm = _flax_name(name, module_table)
            out[name] = NamedSharding(
                mesh, _leaf_spec(path, tuple(t.shape), mesh, rules, perm))
        return out
    items = []
    for keys, leaf in _walk(tree):
        names = keys[1:] if keys[0] == "params" else keys
        spec = _leaf_spec("/".join(names), tuple(getattr(leaf, "shape", ())),
                          mesh, rules)
        items.append((keys, NamedSharding(mesh, spec)))
    return _rebuild(items)


def shard_params(params, mesh: Mesh, rules=DECODER_PARAM_RULES,
                 module_table: Optional[Dict] = None):
    """Place a parameter tree on the mesh per rules: each leaf a DTensor
    (``distribute_tensor``: every rank passes the same full tensor and
    keeps its shard, ``to_local()``).  The tree is read as
    :func:`shard_tree` reads it."""
    from torch.distributed.tensor import distribute_tensor
    shardings = shard_tree(params, mesh, rules, module_table)
    if module_table is not None:
        return {n: distribute_tensor(t, mesh.device_mesh,
                                     shardings[n].placements)
                for n, t in params.items()}
    flat = dict(_walk(shardings))
    return _rebuild((keys, distribute_tensor(t, mesh.device_mesh,
                                             flat[keys].placements))
                    for keys, t in _walk(params))


def split_dim(path: str, shape, mesh: Mesh, rules,
              axis: str = "model") -> Optional[int]:
    """The dimension of a leaf of ``shape`` (the full, unsharded shape,
    in the layout ``rules`` speak of) that ``rules`` split over ``axis``
    once repaired for divisibility, or None where it replicates."""
    spec = _leaf_spec(path, tuple(shape), mesh, rules)
    dims = [d for d, part in enumerate(spec)
            if part == axis or (isinstance(part, tuple) and axis in part)]
    return dims[0] if dims else None


def _block(t, spec: PartitionSpec, mesh: Mesh):
    """This rank's block of ``t`` under ``spec``: each split dimension cut
    into the product of its axes' sizes, the block at this rank's
    coordinates (the first axis outermost)."""
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        n, i = 1, 0
        for ax in axes:
            n, i = n * mesh.shape[ax], i * mesh.shape[ax] + mesh.index(ax)
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t.contiguous()


def local_shards(tree, mesh: Mesh, rules,
                 module_table: Optional[Dict] = None):
    """This rank's shard of every leaf of ``tree`` as :func:`shard_tree`
    places it (the ``to_local()`` of :func:`shard_params`, taken without
    DTensors): a flat torch state_dict given its ``module_table`` (the
    tensor-parallel models of ``models.transformer`` load these), or a
    dict of tensors in the Flax layout (the serving artifact's).  Every
    rank passes the same full tensors."""
    shardings = shard_tree(tree, mesh, rules, module_table)
    if module_table is not None:
        return {n: _block(t, shardings[n].spec, mesh)
                for n, t in tree.items()}
    flat = dict(_walk(shardings))
    return _rebuild((keys, _block(t, flat[keys].spec, mesh))
                    for keys, t in _walk(tree))


def batch_sharding(mesh: Mesh, seq_parallel: bool = False) -> NamedSharding:
    """Input batch (B, S, ...): batch over (host, data) (data parallelism
    spans hosts), optionally the sequence over seq."""
    return NamedSharding(
        mesh, P(("host", "data"), "seq" if seq_parallel else None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
