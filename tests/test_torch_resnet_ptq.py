"""Port parity for the slice as a whole: tiny-ResNet PTQ through
fp8tpu_torch.quantize_model against fp8tpu.quantize_model (JAX on the CPU,
the hw-patched engine's Pallas kernel in interpret mode), plus the port's
import boundary and device rules."""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

import fp8tpu
import fp8tpu_torch
from fp8tpu.models.resnet import RESNET_EXEMPT
from fp8tpu.models.resnet import tiny_resnet as j_tiny_resnet
from fp8tpu.quant.policy import get_policy as jget_policy
from fp8tpu_torch.kernels import cast_kernel, qmatmul
from fp8tpu_torch.models import (resnext50_32x4d, tiny_resnet, tiny_resnext,
                                 variables_from_flax, wide_resnet50_2)

REPO = Path(__file__).resolve().parents[1]

# Tolerance on PTQ logits, relative to max|logit|.  The casts, scales and
# quantized weights are bit-equal, but the port's convolutions, matmuls and
# means sum in another order than XLA's (a few f32 ulps).  Where that moves
# a value across an fp8 rounding boundary the cast changes it by one fp8
# step (1/16 relative for e4m3) and later layers dilute it; without such a
# flip the logits agree to ~1e-6.
PTQ_RTOL = 2e-3


@functools.lru_cache(maxsize=None)
def _models():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    jm = j_tiny_resnet()
    v = jax.jit(jm.init)(jax.random.key(1), x)
    step = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                         mutable=["batch_stats"]))
    for _ in range(2):
        _, upd = step(v, x)
        v = {**v, "batch_stats": upd["batch_stats"]}
    tm = tiny_resnet(device="cpu")
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    tm.eval()
    return jm, v, tm, x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def test_fp32_forward_matches():
    jm, v, tm, x, xt = _models()
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = tm(xt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


FLOWS = [
    ("e4m3-hw-patched-calibrated-fused",
     dict(dtype="e4m3", hw=True, fuse_bn=True, calibrate=True)),
    ("e4m3", dict(dtype="e4m3")),
    ("e3m4", dict(dtype="e3m4")),
    ("hybrid-fused", dict(dtype="hybrid", fuse_bn=True)),
]


@pytest.mark.parametrize("name,flow", FLOWS, ids=[f[0] for f in FLOWS])
def test_ptq_logits_match(name, flow):
    from fp8tpu.models.resnet import ResNet, ResNetConfig
    jm, v, tm, x, xt = _models()
    jkw, tkw = {}, {}
    if flow.get("hw"):
        jkw["policy"] = jget_policy(flow["dtype"]).with_hw_patching()
        tkw["policy"] = fp8tpu_torch.get_policy(
            flow["dtype"]).with_hw_patching()
    if flow.get("fuse_bn"):
        jkw.update(fuse_bn=True, inference_model=ResNet(ResNetConfig(
            stage_sizes=(1, 1), width=16, num_classes=10, small_images=True,
            norm_mode="scale_shift")))
        tkw.update(fuse_bn=True, inference_model=tiny_resnet(
            device="cpu", norm_mode="scale_shift"))
    if flow.get("calibrate"):
        jkw["calibration_batches"] = [x, x * 0.5]
        tkw["calibration_batches"] = [xt, xt * 0.5]
    jq = fp8tpu.quantize_model(jm, v, (x,), dtype=flow["dtype"],
                               list_exempt_layers=RESNET_EXEMPT, **jkw)
    tq = fp8tpu_torch.quantize_model(tm, (xt,), dtype=flow["dtype"],
                                     list_exempt_layers=RESNET_EXEMPT,
                                     device="cpu", **tkw)
    want = np.asarray(jq(x))
    with torch.no_grad():
        got = tq(xt).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PTQ_RTOL * np.abs(want).max())
    # quantized conv and dense weights are bit-equal after the layout map
    jw = variables_from_flax(jax.tree.map(np.asarray, jq.variables))
    for k, w in jw.items():
        if k.endswith("weight") and "bn" not in k:
            np.testing.assert_array_equal(
                tq.variables[k].numpy().view(np.uint32),
                w.numpy().view(np.uint32), err_msg=k)
    if flow.get("calibrate"):
        assert jq.qparams.keys() == tq.qparams.keys()
    # the quantized model is close to the fp32 one, as in tests/test_api.py
    with torch.no_grad():
        ref = tm(xt).numpy()
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.95


@functools.lru_cache(maxsize=None)
def _resnext():
    from fp8tpu.models.resnet import tiny_resnext as j_tiny_resnext
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    jm = j_tiny_resnext()
    v = jax.jit(jm.init)(jax.random.key(3), x)
    _, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                           mutable=["batch_stats"]))(v, x)
    v = {**v, "batch_stats": upd["batch_stats"]}
    tm = tiny_resnext(device="cpu")
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    tm.eval()
    return jm, v, tm, x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("hw", [False, True], ids=["e4m3", "e4m3-hw-patched"])
def test_tiny_resnext_ptq_logits_match(hw):
    """The grouped bottleneck through PTQ: logits within the PTQ limit of
    the JAX package's, quantized weights bit-equal; with hw patching the
    grouped conv stays unpatched on both sides and the others take K2."""
    from fp8tpu_torch.quant import hw_patch as thw
    jm, v, tm, x, xt = _resnext()
    grouped = [m for m in tm.modules()
               if getattr(m, "feature_group_count", 1) > 1]
    assert len(grouped) == 2          # one 3x3 conv in each stage's block
    assert all(m.feature_group_count == 4 and not thw.conv_patchable(m)
               for m in grouped)
    jkw, tkw = {}, {}
    if hw:
        jkw["policy"] = jget_policy("e4m3").with_hw_patching()
        tkw["policy"] = fp8tpu_torch.get_policy("e4m3").with_hw_patching()
    jq = fp8tpu.quantize_model(jm, v, (x,), dtype="e4m3",
                               list_exempt_layers=RESNET_EXEMPT, **jkw)
    tq = fp8tpu_torch.quantize_model(tm, (xt,), dtype="e4m3",
                                     list_exempt_layers=RESNET_EXEMPT,
                                     device="cpu", **tkw)
    want = np.asarray(jq(x))
    k2 = qmatmul.launches
    with torch.no_grad():
        got = tq(xt).numpy()
    assert qmatmul.launches == k2            # the CPU path launches nothing
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PTQ_RTOL * np.abs(want).max())
    jw = variables_from_flax(jax.tree.map(np.asarray, jq.variables))
    for k, w in jw.items():
        if k.endswith("weight") and "bn" not in k:
            np.testing.assert_array_equal(
                tq.variables[k].numpy().view(np.uint32),
                w.numpy().view(np.uint32), err_msg=k)


@pytest.mark.parametrize("name", ["resnext50_32x4d", "wide_resnet50_2"])
def test_full_size_constructors_match_jax_shapes(name):
    """The full-size ResNeXt and wide ResNet have the JAX package's
    parameters, shape for shape (the JAX side traced, not materialised)."""
    import fp8tpu.models.resnet as jres
    jm = getattr(jres, name)()
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    want = {}

    def walk(tree, path):
        for k, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, path + (k,))
            else:
                want[path + (k,)] = tuple(sub.shape)

    walk(shapes["params"], ())
    walk(shapes["batch_stats"], ())
    tm = {"resnext50_32x4d": resnext50_32x4d,
          "wide_resnet50_2": wide_resnet50_2}[name](device="cpu")
    got = {k: tuple(t.shape) for k, t in tm.state_dict().items()}
    assert len(got) == len(want)
    assert sum(int(np.prod(s)) for s in got.values()) \
        == sum(int(np.prod(s)) for s in want.values())
    conv = [(k, s) for k, s in want.items() if k[-1] == "kernel"
            and len(s) == 4]
    for path, (kh, kw, cin, cout) in conv:
        assert got[".".join(path[:-1] + ("weight",))] == (cout, cin, kh, kw)


def test_cpu_path_launches_no_kernel():
    _, _, tm, _, xt = _models()
    k1, k2 = cast_kernel.launches, qmatmul.launches
    tq = fp8tpu_torch.quantize_model(
        tm, (xt,), policy=fp8tpu_torch.get_policy("e4m3").with_hw_patching(),
        list_exempt_layers=RESNET_EXEMPT, device="cpu")
    with torch.no_grad():
        tq(xt)
    assert (cast_kernel.launches, qmatmul.launches) == (k1, k2)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiny_resnet()
    tm = tiny_resnet(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fp8tpu_torch.quantize_model(tm, (torch.zeros(1, 3, 8, 8),))


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fp8tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_fp8tpu():
    files = sorted((REPO / "fp8tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"fp8tpu_torch/kernels/int4_matmul.py",
            "fp8tpu_torch/kernels/inplace.py",
            "fp8tpu_torch/kernels/paged_attention.py",
            "fp8tpu_torch/serve/speculative.py",
            "fp8tpu_torch/models/transformer.py",
            "fp8tpu_torch/serve/__init__.py",
            "fp8tpu_torch/serve/kv_cache.py", "fp8tpu_torch/serve/model.py",
            "fp8tpu_torch/serve/engine.py",
            "fp8tpu_torch/serve/server.py",
            "fp8tpu_torch/training/__init__.py",
            "fp8tpu_torch/training/mpt.py",
            "fp8tpu_torch/kernels/kexp_convert.py",
            "fp8tpu_torch/kernels/fp8_linear_study.py",
            "fp8tpu_torch/tools/__init__.py",
            "fp8tpu_torch/tools/kexp_convert.py",
            "fp8tpu_torch/tools/bench_fp8_linear.py",
            "fp8tpu_torch/tools/bench_tp.py",
            "fp8tpu_torch/cmodel.py", "fp8tpu_torch/linen.py",
            "fp8tpu_torch/models/resnet.py",
            "fp8tpu_torch/kernels/adam8.py",
            "fp8tpu_torch/training/opt8.py",
            "fp8tpu_torch/numerics/blockquant.py",
            "fp8tpu_torch/utils/__init__.py",
            "fp8tpu_torch/utils/checkpoint.py",
            "fp8tpu_torch/utils/metrics.py",
            "fp8tpu_torch/utils/stats.py",
            "fp8tpu_torch/utils/profiling.py",
            "fp8tpu_torch/utils/bindump.py",
            "fp8tpu_torch/sparse/__init__.py",
            "fp8tpu_torch/sparse/prune.py",
            "fp8tpu_torch/sparse/adaptive.py",
            "fp8tpu_torch/numerics/golden.py",
            "fp8tpu_torch/numerics/native_ref.py",
            "fp8tpu_torch/examples/__init__.py",
            "fp8tpu_torch/examples/_common.py",
            "fp8tpu_torch/examples/train_fp8.py",
            "fp8tpu_torch/examples/serve_llm.py",
            "fp8tpu_torch/examples/serve_http.py",
            "fp8tpu_torch/examples/eval_ppl.py",
            "fp8tpu_torch/examples/resnet_ptq.py",
            "fp8tpu_torch/examples/resnet_qat.py",
            "fp8tpu_torch/tools/convert_torch.py",
            "fp8tpu_torch/models/vision.py", "fp8tpu_torch/models/bert.py",
            "fp8tpu_torch/data/imagenet.py", "fp8tpu_torch/data/squad.py",
            "fp8tpu_torch/examples/launch_sweep.py",
            "fp8tpu_torch/examples/bert_squad_ptq.py",
            "fp8tpu_torch/examples/bert_qa_finetune.py",
            "fp8tpu_torch/parallel/collectives.py"} <= names
    for path in files:
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"
