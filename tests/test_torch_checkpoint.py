"""fp8tpu_torch.utils.checkpoint against fp8tpu.utils.checkpoint: the policy
JSON, checkpoints in the JAX package's npz + meta.json format, and the
serving artifact, each written by one package and read by the other in
``tmp_path``.  The JAX side runs with ``_HAS_ORBAX`` set to False (the
npz format; the card has no Orbax); nothing in ``fp8tpu/`` changes."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_serve_model as serve
from fp8tpu.quant import policy as jpolicy
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import convert_decoder_params as j_convert
from fp8tpu.utils import checkpoint as jckpt
from fp8tpu_torch.quant import policy as tpolicy
from fp8tpu_torch.serve import (RingKVCache, ServeConfig, decode_step,
                                serve_params_from_jax)
from fp8tpu_torch.utils import (load_serve_artifact, policy_from_json,
                                policy_to_json, restore_checkpoint,
                                save_checkpoint, save_serve_artifact)


@pytest.fixture
def npz_jax(monkeypatch):
    monkeypatch.setattr(jckpt, "_HAS_ORBAX", False)


def raw(a) -> np.ndarray:
    return serve.raw(a)


POLICIES = ["e5m2", "e4m3", "e3m4", "hybrid", "hybrid_inference",
            "bfloat16"]


@pytest.mark.parametrize("name", POLICIES)
def test_policy_json_equal_and_round_trips(name):
    """The same policy gives the same JSON string in both packages, and
    each package reads the other's."""
    jp, tp = jpolicy.PRESETS[name](), tpolicy.PRESETS[name]()
    s = policy_to_json(tp)
    assert s == jckpt.policy_to_json(jp)
    assert policy_from_json(s) == tp
    assert jckpt.policy_to_json(jckpt.policy_from_json(s)) == s
    assert policy_to_json(policy_from_json(jckpt.policy_to_json(jp))) == s


def _state(rng):
    params = {"dense": {"kernel": rng.standard_normal((4, 3)).astype(
        np.float32), "bias": np.arange(3, dtype=np.float32)},
        "scale": np.float32(2.5).reshape(()),
        "steps": np.arange(5, dtype=np.int32)}
    opt = [{"mu": rng.standard_normal(3).astype(np.float32)},
           np.int32(7).reshape(())]
    return params, opt


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_jax_checkpoint_restores_into_the_port(rng, tmp_path, npz_jax):
    params, opt = _state(rng)
    policy = jpolicy.get_policy("e4m3")
    jckpt.save_checkpoint(str(tmp_path), 3, jax.tree.map(jnp.asarray, params),
                          opt_state=jax.tree.map(jnp.asarray, opt),
                          policy=policy, extra={"epoch": 1})
    template = {"params": _torch_tree(params), "opt_state": _torch_tree(opt)}
    out = restore_checkpoint(str(tmp_path), 3, template)
    got = out["state"]
    np.testing.assert_array_equal(got["params"]["dense"]["kernel"].numpy(),
                                  params["dense"]["kernel"])
    np.testing.assert_array_equal(got["opt_state"][0]["mu"].numpy(),
                                  opt[0]["mu"])
    assert int(got["opt_state"][1]) == 7 and got["params"]["steps"].dtype \
        == torch.int32
    assert out["meta"]["step"] == 3 and out["meta"]["extra"] == {"epoch": 1}
    assert out["meta"]["policy"] == tpolicy.get_policy("e4m3")


def test_port_checkpoint_restores_into_jax(rng, tmp_path, npz_jax):
    params, opt = _state(rng)
    save_checkpoint(str(tmp_path), 5, _torch_tree(params),
                    opt_state=_torch_tree(opt),
                    policy=tpolicy.get_policy("hybrid", True))
    out = jckpt.restore_checkpoint(str(tmp_path), 5, {
        "params": params, "opt_state": opt})
    got = out["state"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(
            {"params": params, "opt_state": opt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert out["meta"]["policy"] == jpolicy.get_policy("hybrid", True)


def test_port_state_dict_checkpoint_with_bf16_round_trips(tmp_path):
    """A state_dict (flat, dotted names) with bf16 and fp8 tensors: numpy
    lacks the dtypes, so the file holds their bytes and the template
    rebuilds them, bit for bit."""
    sd = {"layer.weight": torch.randn(3, 4).to(torch.bfloat16),
          "layer.q8": torch.randn(4, 2).to(torch.float8_e4m3fn),
          "layer.scale": torch.rand(2)}
    save_checkpoint(str(tmp_path), 0, sd)
    names = set(np.load(os.path.join(tmp_path, "state_0.npz")).files)
    assert names == {f"params/{k}" for k in sd}
    got = restore_checkpoint(str(tmp_path), 0, {"params": {
        k: torch.empty_like(v) for k, v in sd.items()}})["state"]["params"]
    for k, v in sd.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(raw(got[k]), raw(v))


# -- the serving artifact ---------------------------------------------------------

def _jax_artifact(fmt, moe=False):
    if moe:
        import test_torch_serve_moe as moe_tests
        jp, _ = moe_tests._artifact(fmt)
        jcfg = moe_tests._models()[0]
    else:
        jp, _ = serve._artifact(fmt)
        jcfg = serve._models()[0]
    return jp, jcfg


@pytest.mark.parametrize("fmt,moe", [("e4m3", False), ("int8", False),
                                     ("int4", False), ("e4m3", True)],
                         ids=["e4m3", "int8", "int4-grouped", "moe"])
def test_jax_artifact_loads_into_the_port_and_serves(fmt, moe, tmp_path):
    """save_serve_artifact of the JAX package (its ServeConfig carries
    staging_impl, which the port drops) -> load_serve_artifact of the
    port: every array byte-equal, the config equal, and a decode step on
    the loaded artifact equal to one on the artifact carried across in
    memory."""
    jp, jcfg = _jax_artifact(fmt, moe)
    jsc = JServeConfig(model=jcfg, weight_fmt=fmt, kv_fmt="int8",
                       matmul_impl="direct", staging_impl="pallas",
                       int4_group=32)
    jckpt.save_serve_artifact(str(tmp_path), jp, jsc)
    meta = json.load(open(os.path.join(tmp_path, "serve_meta.json")))
    assert meta["serve_config"]["staging_impl"] == "pallas"
    tp, tsc = load_serve_artifact(str(tmp_path), device="cpu")
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].shape == jp[k].shape
        np.testing.assert_array_equal(raw(tp[k]), raw(jp[k]))
    assert tsc.weight_fmt == fmt and tsc.matmul_impl == "direct"
    assert tsc.int4_group == 32 and tsc.model.n_experts == jcfg.n_experts
    mem = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = tsc.model
    tok = torch.tensor([3, 5], dtype=torch.int32)

    def step(params):
        ring = RingKVCache.create(cfg.n_layers, 2, 32, cfg.n_kv_heads,
                                  cfg.head_dim, "int8", device="cpu")
        return decode_step(params, ring, tok, tok, tsc)[0]

    got = step(tp)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, step(mem))


@pytest.mark.parametrize("fmt", ["e4m3", "int4"])
def test_port_artifact_loads_in_jax_byte_for_byte(fmt, tmp_path):
    """save_serve_artifact of the port -> fp8tpu.utils.checkpoint's loader:
    every array byte-equal, the JAX ServeConfig built (staging_impl at its
    default), and the two meta files equal."""
    jp, jcfg = _jax_artifact(fmt)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = serve._models()[1]
    tsc = ServeConfig(model=tcfg, weight_fmt=fmt, kv_fmt="int8",
                      int4_group=32, ring_flush=4)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    save_serve_artifact(str(port_dir), tp, tsc)
    got, jsc = jckpt.load_serve_artifact(str(port_dir))
    assert set(got) == set(tp)
    for k in tp:
        assert str(got[k].dtype) == str(jp[k].dtype)
        np.testing.assert_array_equal(raw(got[k]), raw(tp[k]))
    assert jsc == JServeConfig(model=jcfg, weight_fmt=fmt, kv_fmt="int8",
                               int4_group=32, ring_flush=4)
    jckpt.save_serve_artifact(str(jax_dir), jp, jsc)
    assert (port_dir / "serve_meta.json").read_text() \
        == (jax_dir / "serve_meta.json").read_text()
    back, bsc = load_serve_artifact(str(port_dir), device="cpu")
    assert bsc == tsc
    for k in tp:
        np.testing.assert_array_equal(raw(back[k]), raw(tp[k]))


def test_load_serve_artifact_defaults_to_cuda(tmp_path, monkeypatch):
    jp, jcfg = _jax_artifact("e4m3")
    jckpt.save_serve_artifact(str(tmp_path), jp, JServeConfig(model=jcfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serve_artifact(str(tmp_path))
    assert dataclasses.fields(ServeConfig)[0].name == "model"


# -- the 8-bit optimizer's train state --------------------------------------------

def _opt8_states(rng):
    """The same 8-bit AdamW train state two steps in, in both packages: the
    JAX package's ``(optax chain state, LossScaleState)`` from
    ``init_train_state`` and the port's ``(optimizer, LossScaleState)``,
    with equal moments (the port's update is the JAX package's un-jitted
    one bit for bit).  A flat dict of leaves keeps the keys equal."""
    import optax
    from fp8tpu.training import adamw_8bit as j_adamw_8bit
    from fp8tpu.training import mpt as jmpt
    from fp8tpu_torch.training import LossScaleState, adamw_8bit, \
        init_train_state
    shapes = {"dense.weight": (40, 30), "bias": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    jopt = j_adamw_8bit(1e-3)
    with jax.disable_jit():
        jp = jax.tree.map(jnp.asarray, params)
        jstate = jmpt.init_train_state(jopt, jp)
        inner = jstate[0]
        for g in grads:
            u, inner = jopt.update(jax.tree.map(jnp.asarray, g), inner, jp)
            jp = optax.apply_updates(jp, u)
    jstate = (inner, jmpt.LossScaleState(scale=jnp.float32(2048.0),
                                          good_steps=jnp.int32(3)))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = adamw_8bit(tp, 1e-3)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    tstate = init_train_state(opt)
    tstate = (opt, LossScaleState(2048.0, 3))
    return tp, jp, tstate, jstate


def _assert_opt8_equal(jstate, tstate):
    """Every leaf of the two states byte for byte: fp8 payloads compared as
    bytes (the JAX package's restore gives them back as uint8)."""
    from fp8tpu_torch.utils.checkpoint import _flatten, _stored
    want = dict(jax.tree_util.tree_flatten_with_path(jstate)[0])
    got = dict(_flatten(tstate))

    def raw(v):
        return np.ascontiguousarray(_stored(v)).reshape(-1).view(np.uint8)

    names = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp): v for kp, v in want.items()}
    assert set(names) == set(got)
    for name, v in names.items():
        np.testing.assert_array_equal(raw(np.asarray(v)), raw(got[name]),
                                      err_msg=name)


def test_opt8_train_state_port_to_jax_and_back(rng, tmp_path, npz_jax):
    """An 8-bit AdamW train state written by the port restores in the JAX
    package under its own keys, byte for byte, and the JAX package's file
    restores into the port's optimizer, byte for byte, with the count and
    the loss-scale carry."""
    from fp8tpu_torch.training import LossScaleState, adamw_8bit
    tp, jp, tstate, jstate = _opt8_states(rng)
    _assert_opt8_equal(jstate, tstate)
    save_checkpoint(str(tmp_path / "port"), 2, tp, opt_state=tstate)
    jkeys = set(np.load(tmp_path / "port" / "state_2.npz").files)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jp, opt_state=jstate)
    assert jkeys == set(np.load(tmp_path / "jax" / "state_2.npz").files)
    assert "opt_state/0/0/.v/dense.weight/.payload" in jkeys
    assert "opt_state/1/.good_steps" in jkeys
    back = jckpt.restore_checkpoint(str(tmp_path / "port"), 2, {
        "params": jp, "opt_state": jstate})["state"]["opt_state"]
    _assert_opt8_equal(back, tstate)

    fresh = {k: torch.zeros_like(v) for k, v in tp.items()}
    opt = adamw_8bit(fresh, 1e-3)
    out = restore_checkpoint(str(tmp_path / "jax"), 2, {
        "params": fresh, "opt_state": (opt, LossScaleState(1.0))})["state"]
    assert out["opt_state"][0] is opt and opt.count == 2
    assert out["opt_state"][1] == LossScaleState(2048.0, 3)
    _assert_opt8_equal(jstate, out["opt_state"])
    for k in tp:
        np.testing.assert_array_equal(out["params"][k].numpy(),
                                      tp[k].numpy())


def test_opt8_state_carried_from_jax_flax_tree():
    """``Adam8W.load_chain_state`` (with a module table) carries a JAX
    state over Flax variables (nested dicts of Flax paths, Dense kernels
    (in, out)) into the port's optimizer over the model's tensors, byte
    for byte; the Dense moments stay in the JAX package's (in, out)
    order."""
    from fp8tpu.models.mlp import MLP as JMLP
    from fp8tpu.training import adamw_8bit as j_adamw_8bit
    from fp8tpu_torch.models import mlp as t_mlp
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.quant.interceptor import build_module_table
    from fp8tpu_torch.training import adamw_8bit
    x = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    jm = JMLP(features=(32,), num_classes=4)
    v = jm.init(jax.random.key(0), x)
    jopt = j_adamw_8bit(1e-3)
    g = jax.tree.map(lambda a: jnp.asarray(np.random.default_rng(2)
                                           .standard_normal(a.shape)
                                           .astype(np.float32)), v)
    with jax.disable_jit():
        _, inner = jopt.update(g, jopt.init(v), v)
    tm = t_mlp(16, (32,), 4, device="cpu")
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    params = dict(tm.named_parameters())
    opt = adamw_8bit(params, 1e-3, module_table=build_module_table(tm))
    opt.load_chain_state(jax.tree.map(np.asarray, inner))
    assert opt.count == 1
    for name, p in params.items():
        node = inner[0].m["params"]
        path, _, leaf = name.rpartition(".")
        for part in path.split(".") + [
                "kernel" if leaf == "weight" else leaf]:
            node = node[part]
        np.testing.assert_array_equal(opt.state[p]["m"].payload.numpy(),
                                      np.asarray(node.payload))


def test_opt8_decoder_checkpoint_port_to_jax_and_back(tmp_path, npz_jax):
    """examples/train_fp8.py's checkpoint of a decoder (Flax variables, the
    ``adamw_8bit`` chain state keyed by Flax paths, the loss-scale carry):
    the port writes it under the JAX package's keys from its model and
    optimizer (``variables_to_flax``, the optimizer built with the module
    table), the JAX package restores it byte for byte, and the JAX
    package's file restores into a fresh port model and optimizer."""
    from fp8tpu.models.transformer import Decoder as JDecoder
    from fp8tpu.models.transformer import DecoderConfig as JConfig
    from fp8tpu.training import adamw_8bit as j_adamw_8bit
    from fp8tpu.training import mpt as jmpt
    from fp8tpu_torch.models import (variables_from_flax,
                                     variables_to_flax)
    from fp8tpu_torch.models.transformer import Decoder as TDecoder
    from fp8tpu_torch.models.transformer import DecoderConfig as TConfig
    from fp8tpu_torch.quant.interceptor import build_module_table
    from fp8tpu_torch.training import LossScaleState, adamw_8bit
    cfg = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4,
               n_kv_heads=2, d_ff=64, max_seq_len=16, dtype="float32")
    toks = np.zeros((1, 8), np.int32)
    v = JDecoder(JConfig(**cfg)).init(jax.random.key(0), toks)
    jopt = j_adamw_8bit(1e-3)
    rng = np.random.default_rng(3)
    with jax.disable_jit():
        inner = jopt.init(v)
        for _ in range(2):
            g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
                a.shape).astype(np.float32)), v)
            _, inner = jopt.update(g, inner, v)
    jstate = (inner, jmpt.LossScaleState(scale=jnp.float32(2048.0),
                                          good_steps=jnp.int32(3)))

    def port_model():
        tm = TDecoder(TConfig(**cfg))
        table = build_module_table(tm)
        params = dict(tm.named_parameters())
        return tm, table, params, adamw_8bit(params, 1e-3,
                                             module_table=table)

    tm, table, params, opt = port_model()
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    opt.load_chain_state(jax.tree.map(np.asarray, inner))
    tstate = (opt, LossScaleState(2048.0, 3))
    _assert_opt8_equal(jstate, tstate)

    save_checkpoint(str(tmp_path / "port"), 2,
                    variables_to_flax(params, table), opt_state=tstate)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, v, opt_state=jstate)
    keys = set(np.load(tmp_path / "port" / "state_2.npz").files)
    assert keys == set(np.load(tmp_path / "jax" / "state_2.npz").files)
    assert ("opt_state/0/0/.m/params/layer_0/attn/q_proj/kernel/.payload"
            in keys)
    assert "params/params/layer_0/attn/q_proj/kernel" in keys
    back = jckpt.restore_checkpoint(str(tmp_path / "port"), 2, {
        "params": v, "opt_state": jstate})["state"]
    _assert_opt8_equal(back["opt_state"], tstate)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(v)[0],
                          jax.tree_util.tree_leaves(back["params"])):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=str(kp))

    tm2, table2, params2, opt2 = port_model()
    out = restore_checkpoint(str(tmp_path / "jax"), 2, {
        "params": variables_to_flax(params2, table2),
        "opt_state": (opt2, LossScaleState(1.0))})["state"]
    assert out["opt_state"][0] is opt2 and opt2.count == 2
    assert out["opt_state"][1] == LossScaleState(2048.0, 3)
    _assert_opt8_equal(jstate, out["opt_state"])
    tm2.load_state_dict(variables_from_flax(out["params"]))
    for k, t in tm2.state_dict().items():
        torch.testing.assert_close(t, tm.state_dict()[k], rtol=0, atol=0)
