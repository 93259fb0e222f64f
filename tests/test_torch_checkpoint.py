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
