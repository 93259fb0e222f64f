"""Checkpoint / resume, and the serving artifact on disk.

The JAX package's ``fp8tpu/utils/checkpoint.py`` in PyTorch: the policy as
JSON; a checkpoint of (params, opt_state, step) plus the policy in the
JAX package's npz + ``meta.json`` format (its fallback when Orbax is
missing; the card has no Orbax), so that a checkpoint either package
writes restores in the other; and the serving artifact (npz + JSON), the
way a quantized decoder reaches a server on another machine.

Names in the npz files are the JAX package's tree paths: the keys of
nested dicts (and the indices of lists and tuples) joined with "/".  A
port state_dict is a flat dict of tensors, so its names are its keys
under ``params/``.  Dtypes that numpy lacks (bf16, fp8) are stored as
their raw bytes (a uint8 view, as the JAX package stores ml_dtypes
arrays) and rebuilt from the manifest (the serving artifact) or from the
template (a checkpoint).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.quant.config import ModuleQuantConfig, TensorQuantConfig
from fp8tpu_torch.quant.policy import LayerKind, QuantPolicy

_ROLES = ("wt", "iact", "oact", "wtgrad", "igrad", "ograd")

# torch dtypes by the name ``str(jax_array.dtype)`` gives them.
_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_RAW = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


# -- policy (de)serialization ------------------------------------------------

def _tcfg_to_dict(c: Optional[TensorQuantConfig]):
    if c is None:
        return None
    return {"dtype": c.dtype, "scheme": c.scheme, "scaling": c.scaling,
            "group_size": c.group_size, "block_size": c.block_size,
            "channel_axis": c.channel_axis, "cast_impl": c.cast_impl}


def _tcfg_from_dict(d):
    return None if d is None else TensorQuantConfig(**d)


def policy_to_json(policy: QuantPolicy) -> str:
    mq = policy.default
    return json.dumps({
        "default": {r: _tcfg_to_dict(mq.role(r)) for r in _ROLES},
        "patch_ops": mq.patch_ops,
        "emb": _tcfg_to_dict(policy.emb),
        "whitelist": [k.value for k in policy.whitelist],
        "exempt_layers": list(policy.exempt_layers),
        "output_fused_layers": list(policy.output_fused_layers),
        "overrides": [
            [pat, None if cfg is None else
             {r: _tcfg_to_dict(cfg.role(r)) for r in _ROLES}]
            for pat, cfg in policy.overrides],
        "is_training": policy.is_training,
        "name": policy.name,
    })


def policy_from_json(s: str) -> QuantPolicy:
    d = json.loads(s)
    default = ModuleQuantConfig(
        patch_ops=d.get("patch_ops", False),
        **{r: _tcfg_from_dict(v) for r, v in d["default"].items()})
    overrides = tuple(
        (pat, None if cfg is None else ModuleQuantConfig(
            **{r: _tcfg_from_dict(v) for r, v in cfg.items()}))
        for pat, cfg in d.get("overrides", []))
    return QuantPolicy(
        default=default,
        emb=_tcfg_from_dict(d.get("emb")),
        whitelist=tuple(LayerKind(k) for k in d["whitelist"]),
        exempt_layers=tuple(d.get("exempt_layers", ())),
        output_fused_layers=tuple(d.get("output_fused_layers", ())),
        overrides=overrides,
        is_training=d.get("is_training", False),
        name=d.get("name", "custom"),
    )


# -- trees of tensors --------------------------------------------------------

def _fields(tree):
    """[(".name", value)] of a NamedTuple or dataclass node, as JAX names
    the attributes of a registered node; None for another node."""
    if hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", _jax_scalar(getattr(tree, f.name)))
                for f in dataclasses.fields(tree)]
    return None


def _jax_scalar(v):
    """A Python scalar of a dataclass carry (``LossScaleState``) as the JAX
    package holds it: an f32 or int32 array."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return v
    return np.float32(v) if isinstance(v, float) else np.int32(v)


def _flatten(tree, prefix=()):
    """[(path, leaf)] of nested dicts / lists / tuples / NamedTuples /
    dataclasses, dict keys in sorted order as JAX flattens them; an
    optimizer with a ``chain_state`` (the 8-bit AdamW) as that state."""
    if hasattr(tree, "chain_state"):
        return _flatten(tree.chain_state(), prefix)
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    fields = _fields(tree)
    if fields is not None:
        out = []
        for name, v in fields:
            out += _flatten(v, prefix + (name,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _stored(v) -> np.ndarray:
    """A leaf as the array the npz holds: numpy's own dtypes as they are,
    bf16 / fp8 as their raw bytes."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype in _RAW:
            t = t.view(torch.uint8) if t.ndim else t.reshape(1).view(
                torch.uint8)
        return t.numpy()
    return np.asarray(v)


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return _NAMES[v.dtype]
    return str(np.asarray(v).dtype)


def _tensor(raw: np.ndarray, shape, dtype: torch.dtype, device):
    if raw.dtype.kind == "V":
        # the JAX package's npz fallback writes ml_dtypes leaves (fp8)
        # as opaque one-byte records
        raw = raw.view(np.uint8)
    t = torch.from_numpy(np.ascontiguousarray(raw))
    if dtype in _RAW and t.dtype == torch.uint8:
        t = t.view(dtype)                 # bytes-stored extension dtype
    return t.reshape(tuple(shape)).to(device=device, dtype=dtype)


# -- checkpoint save/restore --------------------------------------------------

def save_checkpoint(directory: str, step: int, params,
                    opt_state=None, policy: Optional[QuantPolicy] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save a training / serving checkpoint: ``meta.json`` (step, policy,
    extra) and ``state_<step>.npz`` with ``params`` (a state_dict, or any
    nest of dicts / lists of tensors) and ``opt_state`` under those two
    names, in the JAX package's npz format.  ``opt_state`` may be
    :func:`~fp8tpu_torch.training.init_train_state`'s ``(optimizer,
    LossScaleState)`` with the 8-bit AdamW: it is written under the keys
    the JAX package writes for the chain state of its ``adamw_8bit`` and
    its ``LossScaleState`` (``opt_state/0/0/.m/<leaf>/.payload``, ...,
    ``opt_state/1/.scale``)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    meta = {"step": step}
    if policy is not None:
        meta["policy"] = policy_to_json(policy)
    if extra:
        meta["extra"] = extra
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f)
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    arrays = {name: _stored(v) for name, v in _flatten(state)}
    path = os.path.join(directory, f"state_{step}.npz")
    np.savez(path, **arrays)
    return path


def restore_checkpoint(directory: str, step: int, template) -> Dict:
    """Restore ``{"state": state, "meta": meta}``.  ``template`` has the
    target structure (``{"params": state_dict, ...}``, as the JAX package
    takes a pytree); each leaf comes back as a tensor of the template
    leaf's dtype on its device (a non-tensor leaf: on the CPU), a
    dataclass (``LossScaleState``) with its fields read back, and an 8-bit
    AdamW optimizer loaded in place and returned."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    if "policy" in meta:
        meta["policy"] = policy_from_json(meta["policy"])
    data = np.load(os.path.join(directory, f"state_{step}.npz"))

    def restore(tree, prefix):
        if hasattr(tree, "chain_state"):
            tree.load_chain_state(restore(tree.chain_state(), prefix))
            return tree
        if isinstance(tree, dict):
            return {k: restore(v, prefix + (str(k),)) for k, v in tree.items()}
        fields = _fields(tree)
        if fields is not None:
            got = {n[1:]: restore(v, prefix + (n,)) for n, v in fields}
            if hasattr(tree, "_fields"):
                return type(tree)(**got)
            return dataclasses.replace(tree, **{
                n: type(getattr(tree, n))(v.item())
                if isinstance(getattr(tree, n), (int, float)) else v
                for n, v in got.items()})
        if isinstance(tree, (list, tuple)):
            return type(tree)(restore(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        raw = data["/".join(prefix)]
        if isinstance(tree, torch.Tensor):
            return _tensor(raw, tree.shape, tree.dtype, tree.device)
        return torch.from_numpy(np.array(raw))

    return {"state": restore(template, ()), "meta": meta}


# -- tensor-parallel runs: the global tree ------------------------------------

def global_params(params: Dict[str, torch.Tensor], shards: Dict,
                  module_table: Dict) -> Dict[str, torch.Tensor]:
    """The global leaves of a tensor-parallel rank's ``params`` (a state
    dict of its shards), every shard gathered over its model group along
    its split dimension in the Flax layout (``shards``:
    ``quant.interceptor.weight_shards``); replicated leaves as they are.
    Collective: every rank of the model group calls it, and every rank
    gets the global tree (what a model-parallel run saves, as the JAX
    script saves global arrays)."""
    from fp8tpu_torch.parallel.collectives import gather_dim
    from fp8tpu_torch.quant.interceptor import (from_flax_layout,
                                                to_flax_layout)
    out = {}
    for name, t in params.items():
        sh = shards.get(name)
        if sh is None:
            out[name] = t.detach()
            continue
        kind = module_table.get(name.rpartition(".")[0].replace(".", "/"))
        v = to_flax_layout(t.detach(), kind)
        out[name] = from_flax_layout(
            gather_dim(v, sh.model_dim % v.ndim, sh.model.group), kind)
    return out


def local_params(full: Dict[str, torch.Tensor], shards: Dict,
                 module_table: Dict) -> Dict[str, torch.Tensor]:
    """A rank's blocks of the global leaves ``full`` (the inverse of
    :func:`global_params`; no collective)."""
    from fp8tpu_torch.quant.interceptor import (from_flax_layout,
                                                to_flax_layout)
    out = {}
    for name, t in full.items():
        sh = shards.get(name)
        if sh is None:
            out[name] = t
            continue
        kind = module_table.get(name.rpartition(".")[0].replace(".", "/"))
        v = to_flax_layout(t, kind)
        d = sh.model_dim % v.ndim
        n = v.shape[d] // sh.model.count
        out[name] = from_flax_layout(
            v.narrow(d, sh.model.index * n, n).contiguous(), kind)
    return out


# -- the serving artifact -----------------------------------------------------

# The JAX package's ServeConfig has a ``staging_impl`` field (its ring
# write's XLA / Pallas switch) that the port's does not: the port writes
# the JAX default, so either package reads the file, and drops it on load.
_JAX_ONLY = {"staging_impl": "auto"}


def save_serve_artifact(directory: str, params: Dict[str, torch.Tensor],
                        cfg) -> str:
    """Persist a serving artifact: the quantized parameters (fp8 / int8 /
    int4 payloads and scales, a flat dict) and its ServeConfig, self
    describing: ``serve_meta.json`` (a manifest of names, shapes and JAX
    dtype names, and every field of the JAX package's ServeConfig) and
    ``serve_params.npz``.  The JAX package's ``load_serve_artifact`` reads
    it, and this module's reads the JAX package's, byte for byte."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(params)
    fields = {}
    for f in dataclasses.fields(cfg):
        if f.name == "paged_decode_impl":
            fields.update(_JAX_ONLY)
        if f.name != "model":
            fields[f.name] = getattr(cfg, f.name)
    meta = {
        "manifest": {name: [list(v.shape), _dtype_name(v)]
                     for name, v in flat},
        "serve_config": {"model": dataclasses.asdict(cfg.model), **fields},
    }
    with open(os.path.join(directory, "serve_meta.json"), "w") as f:
        json.dump(meta, f)
    path = os.path.join(directory, "serve_params.npz")
    np.savez(path, **{name: _stored(v) for name, v in flat})
    return path


def load_serve_artifact(directory: str, device="cuda"):
    """Load (params, ServeConfig) saved by :func:`save_serve_artifact` or by
    the JAX package's: tensors on ``device`` (the card unless the caller
    asks for the CPU)."""
    from fp8tpu_torch.models.transformer import DecoderConfig
    from fp8tpu_torch.serve.model import ServeConfig

    dev = resolve_device(device)
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "serve_meta.json")) as f:
        meta = json.load(f)
    sc = dict(meta["serve_config"])
    model = DecoderConfig(**sc.pop("model"))
    for key in _JAX_ONLY:
        sc.pop(key, None)
    cfg = ServeConfig(model=model, **sc)
    data = np.load(os.path.join(directory, "serve_params.npz"))
    params: Dict[str, Any] = {}
    for name, (shape, dtype) in meta["manifest"].items():
        arr = _tensor(data[name], shape, _DTYPES[dtype], dev)
        node = params
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return params, cfg
