"""The port's vision families (``fp8tpu_torch.models.vision`` and the
grouped tiny ResNeXt) against the JAX package's, each with the JAX
``init``'s weights carried across (``models.variables_from_flax``), inputs
from a numpy seed:

- fp32 logits within FP32_TOL of max|logit|;
- e4m3 PTQ logits (the family's exempt list), plain and hw-patched,
  within PTQ_TOL of max|logit| (PERF.md §2: the casts are bit-equal, only
  f32 summation order differs), and the quantized weights bit-equal;
- MobileNet: the hw-patched forward against the plain one, as
  tests/test_vision_models.py holds the JAX package, and the engine never
  reached on a depthwise conv; every family's engine convs are exactly
  its non-exempt dense convs;
- the layout points a straight translation gets wrong: SAME padding of a
  stride-2 conv, floor-mode pools, ShuffleNet's channel shuffle, ViT's
  token order, jax.nn's activations.

The JAX side is jitted where the JAX script jits (applies), un-jitted
where it does not (quantize_model's weight casts).
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fp8tpu
import fp8tpu.models as J
import fp8tpu_torch as ft
import fp8tpu_torch.models as T
from fp8tpu_torch.models import variables_from_flax

FP32_TOL = 1e-5         # of max|logit|: f32 summation order (the tests print it)
PTQ_TOL = 2e-3          # of max|logit| (PERF.md §2)

# name: (constructor kwargs, exempt list name)
FAMILIES = {
    "tiny_vgg": ({}, "VGG_EXEMPT"),
    "tiny_mobilenet": ({}, "MOBILENET_EXEMPT"),
    "tiny_inception": ({}, "INCEPTION_EXEMPT"),
    "tiny_densenet": ({}, "DENSENET_EXEMPT"),
    "tiny_shufflenet": ({}, "SHUFFLENET_EXEMPT"),
    "tiny_squeezenet": ({}, "SQUEEZENET_EXEMPT"),
    "tiny_mbconv": ({}, "MBCONV_EXEMPT"),
    "tiny_mbconv_hs": ({"act": "hardswish"}, "MBCONV_EXEMPT"),
    "tiny_resnext": ({}, "RESNET_EXEMPT"),
    "tiny_vit": ({}, "VIT_EXEMPT"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image():
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3))
    return x.astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _maker(name):
    return name[:-len("_hs")] if name.endswith("_hs") else name


@functools.lru_cache(maxsize=None)
def _jax_family(name):
    """The JAX family's variables, fp32 logits, e4m3 PTQ logits plain and
    hw-patched, and quantized variables, on ``_image()``."""
    kw, exempt = FAMILIES[name]
    model = getattr(J, _maker(name))(8, **kw)
    x = jnp.asarray(_image())
    v = jax.jit(model.init)(jax.random.key(0), x)
    base = np.asarray(jax.jit(model.apply)(v, x))
    qm = fp8tpu.quantize_model(
        model, v, (x,), dtype="e4m3",
        list_exempt_layers=getattr(J, exempt))
    out = {}
    for hw in (False, True):
        q = dataclasses.replace(qm, policy=qm.policy.with_hw_patching()) \
            if hw else qm
        out[hw] = np.asarray(jax.jit(lambda vv, xb: q.apply(
            xb, variables=vv))(qm.variables, x))
    return (jax.tree.map(np.asarray, v), base, out,
            jax.tree.map(np.asarray, qm.variables))


def _port(name, variables):
    kw, _ = FAMILIES[name]
    model = getattr(T, _maker(name))(8, device="cpu", **kw)
    model.load_state_dict(variables_from_flax(variables))
    return model.eval()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_fp32_matches_jax(name):
    v, base, _, _ = _jax_family(name)
    with torch.no_grad():
        got = _port(name, v)(_nchw(_image())).numpy()
    err = _rel(got, base)
    print(f"{name}: fp32 logits {err:.3e} of max|logit|")
    assert err <= FP32_TOL, f"{name}: fp32 logits {err:.3e} of max|logit|"


@pytest.mark.parametrize("hw", [False, True], ids=["plain", "hw"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_ptq_matches_jax(name, hw):
    v, _, qlogits, qv = _jax_family(name)
    policy = ft.get_policy("e4m3", training=False)
    if hw:
        policy = policy.with_hw_patching()
    x = _nchw(_image())
    qm = ft.quantize_model(_port(name, v), (x,), policy=policy,
                           list_exempt_layers=getattr(
                               T, FAMILIES[name][1]), device="cpu")
    with torch.no_grad():
        got = qm(x).numpy()
    err = _rel(got, qlogits[hw])
    print(f"{name} ({'hw' if hw else 'plain'}): e4m3 logits {err:.3e} of "
          "max|logit|")
    assert err <= PTQ_TOL, f"{name}: e4m3 logits {err:.3e} of max|logit|"
    want = variables_from_flax(qv)
    bad = {k: int((t.numpy().view(np.uint32)
                   != want[k].numpy().view(np.uint32)).sum())
           for k, t in qm.variables.items()}
    assert not any(bad.values()), {k: n for k, n in bad.items() if n}


def _engine_convs(model, exempt):
    """The convs the hw-patched e4m3 policy with ``exempt`` sends to the
    engine."""
    from fp8tpu_torch.quant.hw_patch import engine_convs
    return engine_convs(model, ft.get_policy("e4m3", training=False)
                        .with_hw_patching().with_exempt(*exempt))


@pytest.mark.parametrize("name", ["tiny_mobilenet", "tiny_shufflenet",
                                  "tiny_mbconv", "tiny_resnext"])
def test_engine_takes_the_dense_convs_only(name, monkeypatch):
    """Under hw patching the engine conv runs once a forward for each
    non-exempt dense conv, and never for a depthwise or grouped one."""
    from fp8tpu_torch.quant import hw_patch
    v, _, _, _ = _jax_family(name)
    model = _port(name, v)
    exempt = getattr(T, FAMILIES[name][1])
    paths = {id(m): n.replace(".", "/") for n, m in model.named_modules()}
    want = _engine_convs(model, exempt)
    routed, calls = set(), []
    patchable, engine = hw_patch.conv_patchable, hw_patch.engine_conv

    def spy_patchable(module):
        ok = patchable(module)
        if ok:
            routed.add(paths[id(module)])
        return ok

    def spy_engine(*a, **kw):
        calls.append(a[1].shape)
        return engine(*a, **kw)

    monkeypatch.setattr(hw_patch, "conv_patchable", spy_patchable)
    monkeypatch.setattr(hw_patch, "engine_conv", spy_engine)
    x = _nchw(_image())
    qm = ft.quantize_model(model, (x,), policy=ft.get_policy(
        "e4m3", training=False).with_hw_patching(), list_exempt_layers=exempt,
        device="cpu")
    with torch.no_grad():
        qm(x)
    grouped = {n.replace(".", "/") for n, m in model.named_modules()
               if isinstance(m, ft.linen.Conv) and m.feature_group_count > 1}
    assert grouped, "the family has no grouped conv"
    assert routed == want and not routed & grouped
    assert len(calls) == len(want)


def test_mobilenet_patched_matches_plain():
    """tests/test_vision_models.py's MobileNet check on the port: the
    depthwise convs fall back to F.conv2d and the patched forward matches
    the unpatched one; ``conv_patchable`` refuses a depthwise conv."""
    from fp8tpu_torch.quant.hw_patch import conv_patchable
    from fp8tpu_torch.quant.interceptor import quantized_apply
    from fp8tpu_torch.quant.policy import e4m3_inference_policy
    assert not conv_patchable(ft.linen.Conv(8, 8, (3, 3),
                                            feature_group_count=8,
                                            use_bias=False))
    v, _, _, _ = _jax_family("tiny_mobilenet")
    model = _port("tiny_mobilenet", v)
    x = _nchw(_image())
    pol = e4m3_inference_policy(calibrated=False)
    with torch.no_grad():
        plain = quantized_apply(model, pol, x).numpy()
        patched = quantized_apply(model, pol.with_hw_patching(), x).numpy()
    np.testing.assert_allclose(patched, plain, rtol=5e-2, atol=5e-2)
    err = _rel(patched, plain)
    assert err <= PTQ_TOL, f"patched vs plain {err:.3e} of max|logit|"


def test_layout_points():
    """SAME padding of a stride-2 3x3 conv on an even input is (0, 1);
    SqueezeNet's pools are floor mode; the channel shuffle is JAX's
    element order; ViT flattens its patch grid row-major."""
    from fp8tpu_torch.linen import conv_padding
    from fp8tpu_torch.models.vision import channel_shuffle
    assert conv_padding("SAME", (32, 32), (3, 3), (2, 2)) == ((0, 1),
                                                               (0, 1))
    sq = T.tiny_squeezenet(8, device="cpu")
    assert sq(torch.zeros(1, 3, 33, 33)).shape == (1, 8)
    x = np.arange(2 * 3 * 3 * 8, dtype=np.float32).reshape(2, 3, 3, 8)
    want = x.reshape(2, 3, 3, 2, 4).swapaxes(3, 4).reshape(2, 3, 3, 8)
    got = channel_shuffle(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)
    vit = T.tiny_vit(8, device="cpu")
    assert vit.pos_embed.shape == (1, 17, 64)
    assert vit.cls_token.shape == (1, 1, 64)


def test_activations_bit_equal_to_jax():
    """relu6, hard_swish, silu and the exact GELU against jax.nn's on
    10^5 f32 inputs: hard_swish and relu6 bit for bit (XLA multiplies by
    f32(1/6); a true divide by 6 differs, and the test prints in how many);
    silu and GELU within 4 ulps of max(|value|, 1): torch's f32 exp and
    erfc are not XLA's (PERF.md §2), and GELU's tail below -13 differs in
    relative terms where XLA flushes what torch keeps as a subnormal."""
    from fp8tpu_torch.models.vision import gelu_exact, hard_swish, relu6, silu
    x = (np.random.default_rng(1).standard_normal(100_000) * 4).astype(
        np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for fn, jfn in ((relu6, jax.nn.relu6), (hard_swish, jax.nn.hard_swish)):
        np.testing.assert_array_equal(fn(xt).numpy(), np.asarray(jfn(xj)))
    divided = (xt * (relu6(xt + 3.0) / torch.tensor(6.0))).numpy()
    share = float((divided != np.asarray(jax.nn.hard_swish(xj))).mean())
    print(f"hard_swish with a true divide: {share:.3f} of the values differ")
    assert share > 0
    for fn, jfn in ((silu, jax.nn.silu),
                    (gelu_exact, lambda a: jax.nn.gelu(a, approximate=False))):
        got, want = fn(xt).numpy(), np.asarray(jfn(xj))
        ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(want),
                                                          np.float32(1)))
        assert float(ulps.max()) <= 4.0, float(ulps.max())


@pytest.mark.parametrize("name", ["densenet", "mobilenet_v3",
                                  "efficientnet_b0", "vit_b16"])
def test_full_width_structure(name):
    """A full-width constructor builds (on the meta device) the JAX
    package's parameters and statistics: the same module paths and the
    same counts (ViT-B/16: 86.6M parameters)."""
    shapes = jax.eval_shape(lambda: getattr(J, name)().init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    jax_paths = {"/".join(k.key for k in p[1:-1]) for p, _ in flat
                 if p[0].key == "params"}
    n_jax = sum(int(np.prod(s.shape)) for _, s in flat)
    model = getattr(T, name)(device="meta")
    port_paths = {n.rpartition(".")[0].replace(".", "/")
                  for n, _ in model.named_parameters()}
    n_port = sum(t.numel() for t in model.state_dict().values())
    print(f"{name}: {n_port} parameters and statistics")
    assert port_paths == jax_paths
    assert n_port == n_jax, (n_port, n_jax)
