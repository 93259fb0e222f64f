"""Port parity: fp8tpu_torch.quant and ops against fp8tpu.quant and ops (JAX
on the CPU; Pallas kernels in interpret mode, as the JAX tests run them).

Policies, module tables, print_config text and quantized weights must be
equal; contractions must agree within the f32 summation-order bound."""

import dataclasses
import enum
import functools

import flax.linen as fnn
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.kernels.qmatmul import qdq_matmul as j_qdq_matmul
from fp8tpu.numerics.cast import cast_array as jcast_array
from fp8tpu.numerics.formats import RoundMode as JRoundMode
from fp8tpu.models.mlp import MLP as JMLP
from fp8tpu.models.resnet import tiny_resnet as j_tiny_resnet
from fp8tpu.ops import scale_shift as jss
from fp8tpu.ops import wrappers as jw
from fp8tpu.quant import calibrate as jcal
from fp8tpu.quant import config as jconfig
from fp8tpu.quant import fakequant as jfq
from fp8tpu.quant import hw_patch as jhw
from fp8tpu.quant import interceptor as jint
from fp8tpu.quant import policy as jpolicy
from fp8tpu_torch.kernels import qmatmul
from fp8tpu_torch.models import mlp as t_mlp
from fp8tpu_torch.models import tiny_resnet, variables_from_flax
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.numerics.formats import RoundMode
from fp8tpu_torch.linen import Module as TModule
from fp8tpu_torch.ops import scale_shift as tss
from fp8tpu_torch.ops import wrappers as tw
from fp8tpu_torch.quant import calibrate as tcal
from fp8tpu_torch.quant import config as tconfig
from fp8tpu_torch.quant import fakequant as tfq
from fp8tpu_torch.quant import hw_patch as thw
from fp8tpu_torch.quant import interceptor as tint
from fp8tpu_torch.quant import policy as tpolicy

INFERENCE = ("e4m3", "e3m4", "hybrid", "e5m2", "bfloat16")
TRAINING = ("e5m2", "direct", "e5m2-scaled", "hybrid", "hybrid-scaled",
            "hybrid-fwd-only", "hybrid-bwd-only", "hybrid-no-igrad",
            "hybrid-no-oact", "hybrid-no-wtgrad", "hybrid-no-actgrad",
            "hybrid-no-bmm", "hybrid-no-normres", "hybrid-gemm", "bfloat16")
PATHS = ("conv1", "fc", "stage0_block0/conv1", "stage0_block0/residual_add",
         "encoder/layer_0/attn/score_matmul", "embed", "ln_f", "norm1/bn",
         "head")


def plain(obj):
    """A config or policy as nested builtins, for equality across the two
    packages' (distinct but identical) classes."""
    if dataclasses.is_dataclass(obj):
        out = {f.name: plain(getattr(obj, f.name))
               for f in dataclasses.fields(obj)}
        if hasattr(obj, "_method"):
            out["_method"] = obj._method
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (tuple, list)):
        return [plain(o) for o in obj]
    return obj


def _policies():
    pairs = [(f"inference:{d}", jpolicy.get_policy(d),
              tpolicy.get_policy(d)) for d in INFERENCE]
    pairs += [(f"training:{d}", jpolicy.get_policy(d, training=True),
               tpolicy.get_policy(d, training=True)) for d in TRAINING]
    pairs += [
        ("e4m3 uncalibrated", jpolicy.e4m3_inference_policy(False),
         tpolicy.e4m3_inference_policy(False)),
        ("e3m4 uncalibrated", jpolicy.e3m4_inference_policy(False),
         tpolicy.e3m4_inference_policy(False)),
        ("e4m3 hw-patched, exempt, fused, override",
         jpolicy.get_policy("e4m3").with_hw_patching()
         .with_exempt("conv1", "fc").with_output_fused("*conv*")
         .with_override("head", None),
         tpolicy.get_policy("e4m3").with_hw_patching()
         .with_exempt("conv1", "fc").with_output_fused("*conv*")
         .with_override("head", None)),
    ]
    return pairs


@pytest.mark.parametrize("name,jp,tp", _policies(),
                         ids=[p[0] for p in _policies()])
def test_policy_resolve_equal(name, jp, tp):
    assert plain(tp) == plain(jp)
    for path in PATHS:
        for kind in jpolicy.LayerKind:
            assert plain(tp.resolve(path, tpolicy.LayerKind(kind.value))) \
                == plain(jp.resolve(path, kind)), (path, kind)
            assert repr(tp.resolve(path, tpolicy.LayerKind(kind.value))) \
                == repr(jp.resolve(path, kind))


def test_config_validation_matches():
    for args in (("e4m3", "rtz"), ("fp4", "rne"), ("int9",), ("e5m2", "x"),
                 ("e4m3", "rne", "per-galaxy")):
        with pytest.raises(ValueError):
            jconfig.TensorQuantConfig(*args)
        with pytest.raises(ValueError):
            tconfig.TensorQuantConfig(*args)


# -- fake_quant ------------------------------------------------------------------

FQ_CASES = [
    dict(dtype="e4m3", scaling="per-tensor"),
    dict(dtype="e4m3", scaling="per-channel"),
    dict(dtype="e4m3", scaling="per-channel", channel_axis=1),
    dict(dtype="e3m4", scaling="per-tensor-mean"),
    dict(dtype="e4m3", scaling="fine-grained", group_size=2),
    dict(dtype="e5m2", scheme="daz_rne", scaling="per-block", block_size=32),
    dict(dtype="e5m2", scheme="rne", cast_impl="hw"),
    dict(dtype="e4m3", scheme="rne", scaling="per-tensor", cast_impl="hw"),
    dict(dtype="bfloat16", scheme="stochastic"),
    dict(dtype="e4m3", scheme="stochastic", scaling="per-channel"),
    dict(dtype="e5m2", scheme="stochastic", cast_impl="hw"),
    dict(dtype="e4m3", scheme="stochastic", scaling="per-tensor",
         cast_impl="hw"),
    dict(dtype="bfloat16", scheme="stochastic", cast_impl="hw"),
    dict(dtype="float16", scheme="stochastic", cast_impl="hw"),
    dict(dtype="fp4", scheme="nearest", scaling="per-tensor"),
    dict(dtype="int8"),
    dict(dtype="int4"),
]


@pytest.mark.parametrize("kw", FQ_CASES, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_fake_quant_bit_equal(kw):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 6, 3, 3)) * 3.0).astype(np.float32)
    jc, tc = jconfig.TensorQuantConfig(**kw), tconfig.TensorQuantConfig(**kw)
    j = jfq.fake_quant(jnp.asarray(x), jc, jax.random.key(5))
    t = tfq.fake_quant(torch.from_numpy(x), tc, prng.key(5))
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  np.asarray(j).view(np.uint32))


def test_fake_quant_is_straight_through_and_keeps_dtype():
    x = torch.randn(4, 5, dtype=torch.bfloat16, requires_grad=True)
    cfg = tconfig.TensorQuantConfig("e4m3", "rne", "per-tensor")
    y = tfq.fake_quant(x, cfg)
    assert y.dtype == torch.bfloat16
    (y.float() * 3.0).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


@pytest.mark.parametrize("kw,scale", [
    (dict(dtype="e4m3"), 3.0), (dict(dtype="e5m2", scheme="daz_rne"), 0.25),
    (dict(dtype="int8"), (0.05, 3.0))])
def test_fake_quant_with_scale_bit_equal(kw, scale):
    x = (np.random.default_rng(6).standard_normal((5, 7)) * 2).astype(
        np.float32)
    j = jfq.fake_quant_with_scale(jnp.asarray(x),
                                  jconfig.TensorQuantConfig(**kw), scale)
    t = tfq.fake_quant_with_scale(torch.from_numpy(x),
                                  tconfig.TensorQuantConfig(**kw), scale)
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  np.asarray(j).view(np.uint32))


def test_stochastic_needs_a_key():
    cfg = tconfig.TensorQuantConfig("e5m2", "stochastic")
    with pytest.raises(ValueError):
        tfq.fake_quant(torch.ones(3), cfg)


# -- fused GEMM and the hw-patched engine ----------------------------------------

def summation_bound(xq, wq):
    """|a - b| bound for two f32 sums of K products taken in different
    orders: each is within K*2^-24 of sum|x_i w_i|."""
    k = xq.shape[-1]
    return 2.0 * k * 2.0 ** -24 * (np.abs(xq) @ np.abs(wq)) + 1e-30


@pytest.mark.parametrize("fmt_x,fmt_w", [("e4m3", "e4m3"), ("e4m3", None),
                                         (None, None), ("fp4", "e3m4")])
def test_qdq_matmul_matches_jax_interpret(fmt_x, fmt_w):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, 70)).astype(np.float32)
    w = rng.standard_normal((70, 45)).astype(np.float32)
    sx = np.float32(448.0 / np.abs(x).max())
    sw = (448.0 / np.abs(w).max(0)).astype(np.float32)
    j = np.asarray(j_qdq_matmul(jnp.asarray(x), jnp.asarray(w), fmt_x,
                                JRoundMode.RNE, fmt_w, JRoundMode.RNE,
                                sx, sw, interpret=True))
    t = qmatmul.qdq_matmul(torch.from_numpy(x), torch.from_numpy(w), fmt_x,
                           RoundMode.RNE, fmt_w, RoundMode.RNE,
                           torch.tensor(sx), torch.from_numpy(sw)).numpy()
    xq = x if fmt_x is None else np.asarray(
        jcast_array(jnp.asarray(x), sx, None, fmt_x, JRoundMode.RNE))
    wq = w if fmt_w is None else np.asarray(
        jcast_array(jnp.asarray(w), sw[None, :], None, fmt_w,
                    JRoundMode.RNE))
    assert np.all(np.abs(t - j) <= summation_bound(xq, wq))


# (impl, fmt_x, mode_x, fmt_w, mode_w): the "hw" route in the kernel (RNE:
# the Pallas kernel in interpret mode; SR: the JAX package's CPU route),
# bitexact SR, and the "hw" route outside the kernel (both operands of at
# most 7 mantissa bits), where float16 and e3m4 take the bit pipeline.
SR, RNE = RoundMode.STOCHASTIC, RoundMode.RNE
HW_CASES = [
    ("hw", "e4m3", RNE, None, RNE),
    ("hw", "e5m2", SR, None, RNE),
    ("hw", "float16", RNE, "bfloat16", SR),
    ("bitexact", "e4m3", SR, "e5m2", SR),
    ("hw", "e4m3", RNE, "e4m3", RNE),
    ("hw", "e5m2", SR, "e3m4", RNE),
]


@pytest.mark.parametrize("impl,fmt_x,mode_x,fmt_w,mode_w", HW_CASES)
def test_qdq_matmul_hw_and_sr_match_jax(impl, fmt_x, mode_x, fmt_w, mode_w):
    """Products within the f32 summation-order bound of the JAX package's,
    and x's in-kernel cast bit-equal to its: against an identity weight
    each output is one exact product (plus exact zeros, so -0 reads +0)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((37, 70)) * 4).astype(np.float32)
    w = rng.standard_normal((70, 45)).astype(np.float32)
    sx = np.float32(448.0 / np.abs(x).max())
    sw = (448.0 / np.abs(w).max(0)).astype(np.float32)
    jm = {"hw": "hw", "bitexact": "bitexact"}[impl]

    def jax_mm(x, w, fmt_w, sw):
        return np.asarray(j_qdq_matmul(
            jnp.asarray(x), jnp.asarray(w), fmt_x, JRoundMode(mode_x.value),
            fmt_w, JRoundMode(mode_w.value), sx, sw, seed=12345,
            interpret=True, impl=jm))

    def port_mm(x, w, fmt_w, sw):
        return qmatmul.qdq_matmul(
            torch.from_numpy(x), torch.from_numpy(w), fmt_x, mode_x, fmt_w,
            mode_w, torch.tensor(sx), torch.from_numpy(np.asarray(sw)),
            seed=12345, impl=impl).numpy()

    j, t = jax_mm(x, w, fmt_w, sw), port_mm(x, w, fmt_w, sw)
    xq = port_mm(x, np.eye(70, dtype=np.float32), None, np.float32(1.0))
    want_xq = jax_mm(x, np.eye(70, dtype=np.float32), None, np.float32(1.0))
    np.testing.assert_array_equal(xq.view(np.uint32),
                                  want_xq.view(np.uint32))
    wq = w if fmt_w is None else np.asarray(
        qmatmul.cast_operand(torch.from_numpy(w), fmt_w, mode_w,
                             torch.from_numpy(sw).reshape(1, -1), impl,
                             qmatmul.sr_key(12345, 2, fmt_w, mode_w)))
    assert np.all(np.abs(t - j) <= 2 * summation_bound(xq, wq))


def test_qdq_matmul_unported_modes_raise():
    """Every impl of the JAX kernel is ported: "hw" and SR operands run;
    an unknown impl and mismatched shapes raise."""
    x, w = torch.ones(4, 4), torch.ones(4, 4)
    assert torch.equal(qmatmul.qdq_matmul(x, w, impl="hw"),
                       torch.full((4, 4), 4.0))
    assert torch.equal(qmatmul.qdq_matmul(x, w, mode_x=RoundMode.STOCHASTIC),
                       torch.full((4, 4), 4.0))
    with pytest.raises(ValueError):
        qmatmul.qdq_matmul(x, w, impl="fast")
    with pytest.raises(ValueError):
        qmatmul.qdq_matmul(x, torch.ones(3, 4))


@pytest.mark.parametrize("m,n,k,sms,unsplit,want", [
    (576, 64, 100352, 132, False, (53, 1920)),  # ResNet-50 stage-1 3x3 dW
    (576, 64, 100352, 132, True, (1, 100352)),  # the same, kept whole
    (72, 40, 20000, 132, False, (37, 544)),
    (100352, 64, 576, 132, False, (1, 576)),    # forward: tiles fill the card
    (64, 64, 1000, 132, False, (1, 1024)),      # K too short to split
    (8320, 4096, 8192, 8192, False, (1, 8192)),  # more tiles than counters
])
def test_k2_split_plan(m, n, k, sms, unsplit, want):
    """K2's split of K over its 128 x 64 tiles (one plan with K3's, other
    caps): about two blocks per SM, at most 64 ways, at least 512 rows a
    split, a multiple of the 32-row slab."""
    splits, kper = qmatmul.k2_split(m, n, k, sms, unsplit)
    assert (splits, kper) == want
    assert kper % 32 == 0 and (splits - 1) * kper < k <= splits * kper


def _engine_cfgs():
    j = jconfig.ModuleQuantConfig(
        iact=jconfig.TensorQuantConfig("e4m3", "rne", "per-tensor"),
        patch_ops=True)
    t = tconfig.ModuleQuantConfig(
        iact=tconfig.TensorQuantConfig("e4m3", "rne", "per-tensor"),
        patch_ops=True)
    return j, t


@pytest.mark.parametrize("ksize,strides,padding,bias,hw,scheme,scaling", [
    (3, 1, [(1, 1), (1, 1)], False, 9, "rne", "per-tensor"),
    (3, 2, [(1, 1), (1, 1)], False, 9, "rne", "per-tensor"),
    (1, 2, "SAME", False, 8, "rne", "per-tensor"),
    (3, 2, "SAME", True, 8, "rne", "per-tensor"),
    (1, 1, "VALID", True, 7, "rne", "per-tensor"),
    # the conv Function's other routes: a 1x1 stride-2 conv on an odd
    # size (the scale over every other row and column), a stochastic
    # iact and a "mean" scale (the explicit im2col on every device)
    (1, 2, [(0, 0), (0, 0)], False, 9, "rne", "per-tensor"),
    (3, 1, [(1, 1), (1, 1)], False, 7, "stochastic", "per-tensor"),
    (3, 2, "SAME", False, 8, "rne", "per-tensor-mean"),
])
def test_engine_conv_matches_jax(ksize, strides, padding, bias, hw, scheme,
                                 scaling):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    k = (rng.standard_normal((ksize, ksize, 4, 6)) / 3).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32) if bias else None
    jcfg, tcfg = (c.ModuleQuantConfig(
        iact=c.TensorQuantConfig("e4m3", scheme, scaling), patch_ops=True)
        for c in (jconfig, tconfig))
    j = np.asarray(jhw.engine_conv(jnp.asarray(x), jnp.asarray(k),
                                   None if b is None else jnp.asarray(b),
                                   strides, padding, jcfg, interpret=True))
    t = thw.engine_conv(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                        None if b is None else torch.from_numpy(b),
                        strides, padding, tcfg).numpy().transpose(0, 2, 3, 1)
    assert t.shape == j.shape
    # the engine casts the im2col operand with identical scales; the
    # rest is summation order over K = Cin*KH*KW <= 36 products
    np.testing.assert_allclose(t, j, rtol=1e-5,
                               atol=1e-5 * float(np.abs(j).max()))


@pytest.mark.parametrize("ashape,bshape", [((16, 24), (24, 8)),
                                           ((3, 5, 24), (24, 8)),
                                           ((3, 5, 24), (3, 24, 7))])
def test_engine_matmul_matches_jax(ashape, bshape):
    rng = np.random.default_rng(3)
    a = rng.standard_normal(ashape).astype(np.float32)
    b = rng.standard_normal(bshape).astype(np.float32)
    jcfg, tcfg = _engine_cfgs()
    j = np.asarray(jhw.engine_matmul(jnp.asarray(a), jnp.asarray(b), jcfg,
                                     interpret=True))
    t = thw.engine_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          tcfg).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5,
                               atol=1e-5 * float(np.abs(j).max()))


class _JWrapped(fnn.Module):
    @fnn.compact
    def __call__(self, a, b, c):
        y = jw.Matmul(name="mm")(a, b)
        z = jw.AddMatmul(name="amm")(c, a, b)
        return jw.EltwiseMul(name="mul")(y, z)


class _TWrapped(TModule):
    def __init__(self):
        super().__init__()
        self.mm, self.amm, self.mul = tw.Matmul(), tw.AddMatmul(), \
            tw.EltwiseMul()

    def forward(self, a, b, c):
        return self.mul(self.mm(a, b), self.amm(c, a, b))


@pytest.mark.parametrize("patched", [False, True])
def test_quantized_apply_through_op_wrappers(patched):
    """Matmul / AddMatmul / EltwiseMul call sites: iact casts, and with hw
    patching the engine on the contraction operands only."""
    rng = np.random.default_rng(7)
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((4, 8), (8, 5), (4, 5)))
    # jax arrays: the JAX interceptor casts only jax.Array arguments and
    # would pass numpy inputs through uncast
    ja, jb, jc_ = (jnp.asarray(v) for v in (a, b, c))
    jp, tp = jpolicy.get_policy("e4m3"), tpolicy.get_policy("e4m3")
    if patched:
        jp, tp = jp.with_hw_patching(), tp.with_hw_patching()
    jm = _JWrapped()
    j = np.asarray(jint.quantized_apply(
        jm, jp, jm.init(jax.random.key(0), ja, jb, jc_), ja, jb, jc_))
    t = tint.quantized_apply(_TWrapped(), tp, *(torch.from_numpy(v)
                                                for v in (a, b, c))).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5,
                               atol=1e-5 * float(np.abs(j).max()))


def test_engine_backward_not_ported_yet():
    """The engine's backward is ported: two uncast GEMMs over the
    re-quantized operands, straight-through with respect to the casts."""
    _, tcfg = _engine_cfgs()
    a = torch.randn(4, 8, requires_grad=True)
    b = torch.randn(8, 3)
    out = thw.engine_matmul(a, b, tcfg)
    g = torch.randn(4, 3)
    out.backward(g)
    bq = tfq.fake_quant(b, tcfg.iact)
    torch.testing.assert_close(a.grad, g @ bq.t(), rtol=1e-6, atol=1e-6)


def _grad_cfgs(scheme, dtype, impl):
    kw = dict(scaling="per-tensor", cast_impl=impl)
    return tuple(c.ModuleQuantConfig(iact=c.TensorQuantConfig(dtype, scheme,
                                                              **kw),
                                     patch_ops=True)
                 for c in (jconfig, tconfig))


GRAD_CFGS = [("rne", "e4m3", "hw"), ("stochastic", "e5m2", "hw"),
             ("rne", "e4m3", "bitexact")]


@pytest.mark.parametrize("scheme,dtype,impl", GRAD_CFGS)
@pytest.mark.parametrize("op", ["linear", "matmul"])
def test_engine_gradients_match_jax_grad(op, scheme, dtype, impl):
    """d/dx and d/dw of patched_linear / patched_matmul against jax.grad
    through the JAX custom_vjp: the saved operands re-quantize to the same
    bits (SR from key(0) on both sides), so the two backward GEMMs differ
    by summation order only."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((20, 24)).astype(np.float32)
    w = rng.standard_normal((24, 9)).astype(np.float32)
    r = rng.standard_normal((20, 9)).astype(np.float32)
    jcfg, tcfg = _grad_cfgs(scheme, dtype, impl)
    jfn = jhw.patched_linear if op == "linear" else jhw.patched_matmul
    tfn = thw.patched_linear if op == "linear" else thw.patched_matmul
    seed = prng.randint(prng.key(3), 0, 2 ** 31 - 1)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jfn(
        a, b, jnp.int32(seed), jcfg, True) * r), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw_ = torch.from_numpy(w).requires_grad_(True)
    (tfn(tx, tw_, tcfg, seed) * torch.from_numpy(r)).sum().backward()
    xq = tfq.fake_quant(torch.from_numpy(x), tcfg.iact, prng.key(0)).numpy()
    wq = w if op == "linear" else tfq.fake_quant(
        torch.from_numpy(w), tcfg.iact, prng.key(0)).numpy()
    assert np.all(np.abs(tx.grad.numpy() - np.asarray(jgx))
                  <= summation_bound(r, wq.T))
    assert np.all(np.abs(tw_.grad.numpy() - np.asarray(jgw))
                  <= summation_bound(xq.T, r))


@pytest.mark.parametrize("strides,padding,ksize,scheme", [
    (1, [(1, 1), (1, 1)], 3, "rne"), (2, "SAME", 3, "rne"),
    (2, "SAME", 1, "rne"), (1, [(1, 1), (1, 1)], 3, "stochastic")])
def test_engine_conv_gradients_match_jax_grad(strides, padding, ksize,
                                              scheme):
    """Through the conv autograd Function: it saves x and rebuilds and
    re-quantizes the im2col in its backward (SR from key(0) on both
    sides); the port's col2im is autograd's unfold backward, the JAX
    package's the VJP of conv_general_dilated_patches."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    k = (rng.standard_normal((ksize, ksize, 4, 6)) / 3).astype(np.float32)
    jcfg, tcfg = _grad_cfgs(scheme, "e4m3", "hw")
    out_hw = 9 // strides + (9 % strides > 0) if strides > 1 else 9
    r = rng.standard_normal((2, out_hw, out_hw, 6)).astype(np.float32)
    jgx, jgk = jax.grad(lambda a, b: jnp.sum(jhw.engine_conv(
        a, b, None, strides, padding, jcfg, interpret=True) * r),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    tk = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    out = thw.engine_conv(tx, tk, None, strides, padding, tcfg)
    assert type(out.grad_fn).__name__ == "_EngineConvBackward"
    (out * torch.from_numpy(r.transpose(0, 3, 1, 2).copy())).sum().backward()
    gx = tx.grad.numpy().transpose(0, 2, 3, 1)
    gk = tk.grad.numpy().transpose(2, 3, 1, 0)
    # sums of at most 6 * 9 products (dcol) then 9 overlapping patches,
    # and of 2 * 81 products (dW), in another order than XLA's
    np.testing.assert_allclose(gx, np.asarray(jgx), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgx).max()))
    np.testing.assert_allclose(gk, np.asarray(jgk), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgk).max()))


# -- module table, weights, folding, calibration ---------------------------------

@functools.lru_cache(maxsize=None)
def _tiny_pair(norm_mode="bn", seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    jm = j_tiny_resnet(norm_mode=norm_mode)
    v = jax.jit(jm.init)(jax.random.key(seed), x)
    if norm_mode == "bn":
        _, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
        v = {**v, "batch_stats": upd["batch_stats"]}
    tm = tiny_resnet(device="cpu", norm_mode=norm_mode)
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    tm.eval()
    return jm, v, tm, x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@functools.lru_cache(maxsize=None)
def _mlp_pair():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 12)).astype(np.float32)
    jm = JMLP(features=(16, 8), num_classes=5)
    v = jm.init(jax.random.key(4), x)
    tm = t_mlp(12, (16, 8), 5, device="cpu")
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    return jm, v, tm, x, torch.from_numpy(x)


def _kinds(table):
    return {path: kind.value for path, kind in table.items()}


@pytest.mark.parametrize("which", ["tiny_resnet_bn", "tiny_resnet_ss", "mlp"])
def test_module_table_and_print_config_equal(which, capsys):
    from fp8tpu.api import QuantizedModel as JQ
    from fp8tpu_torch.api import QuantizedModel as TQ
    if which == "mlp":
        jm, v, tm, x, _ = _mlp_pair()
    else:
        jm, v, tm, x, _ = _tiny_pair("bn" if which.endswith("bn")
                                     else "scale_shift")
    jt = jint.build_module_table(jm, v, x)
    tt = tint.build_module_table(tm)
    assert _kinds(tt) == _kinds(jt)
    for jp, tp in ((jpolicy.get_policy("e4m3").with_exempt("conv1", "fc"),
                    tpolicy.get_policy("e4m3").with_exempt("conv1", "fc")),
                   (jpolicy.get_policy("hybrid", training=True),
                    tpolicy.get_policy("hybrid", training=True))):
        JQ(jm, jp, v, jt).print_config()
        jtext = capsys.readouterr().out
        TQ(tm, tp, {}, tt, torch.device("cpu")).print_config()
        assert capsys.readouterr().out == jtext
        assert "E4M3_RNE" in jtext


WEIGHT_POLICIES = [
    ("e4m3", lambda p: p.get_policy("e4m3")),
    ("hybrid", lambda p: p.get_policy("hybrid")),
    ("e5m2-hw", lambda p: p.get_policy("e5m2")),
    ("e4m3-sr-per-channel", lambda p: p.QuantPolicy(
        default=p.ModuleQuantConfig(wt=p.TensorQuantConfig(
            "e4m3", "stochastic", "per-channel")))),
]


@pytest.mark.parametrize("name,make", WEIGHT_POLICIES,
                         ids=[w[0] for w in WEIGHT_POLICIES])
def test_quantize_params_bit_equal(name, make):
    for jm, v, tm, x, _ in (_tiny_pair(), _mlp_pair()):
        jp, tp = make(jpolicy), make(tpolicy)
        table = jint.build_module_table(jm, v, x)
        jq = jax.jit(lambda v: jint.quantize_params(
            v, jp, table, jax.random.key(3)))(v)
        tq = tint.quantize_params(tm.state_dict(), tp,
                                  tint.build_module_table(tm), prng.key(3))
        want = variables_from_flax(jax.tree.map(np.asarray, jq))
        assert want.keys() == tq.keys()
        for k in want:
            np.testing.assert_array_equal(
                tq[k].numpy().view(np.uint32), want[k].numpy().view(np.uint32),
                err_msg=k)


def test_fold_batchnorm_matches():
    jm, v, tm, _, _ = _tiny_pair()
    want = variables_from_flax(jax.tree.map(np.asarray, jss.fold_batchnorm(v)))
    got = tss.fold_batchnorm(tm.state_dict())
    assert want.keys() == got.keys()
    for k in want:
        # XLA's rsqrt and a correctly rounded 1/sqrt differ by an ulp or two
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=3e-7, atol=1e-12, err_msg=k)


def test_calibrate_and_qparams_match():
    jm, v, tm, x, xt = _tiny_pair()
    jp = jpolicy.get_policy("e4m3").with_exempt("conv1", "fc")
    tp = tpolicy.get_policy("e4m3").with_exempt("conv1", "fc")
    jstats = jcal.calibrate(jm, v, [x, x * 0.5], policy=jp)
    tstats = tcal.calibrate(tm, [xt, xt * 0.5], policy=tp)
    assert jstats.keys() == tstats.keys()
    for path in jstats:
        assert jstats[path].keys() == tstats[path].keys()
        for k in jstats[path]:
            np.testing.assert_allclose(
                tstats[path][k].numpy(), np.asarray(jstats[path][k]),
                rtol=2e-6, err_msg=f"{path} {k}")
    jq = jcal.qparams_from_stats(jstats, jp, jint.build_module_table(jm, v, x))
    tq = tcal.qparams_from_stats(tstats, tp, tint.build_module_table(tm))
    assert jq.keys() == tq.keys()
    for path in jq:
        for role in jq[path]:
            np.testing.assert_allclose(tq[path][role].numpy(),
                                       np.asarray(jq[path][role]), rtol=2e-6)


def test_per_channel_stats_match():
    jm, v, tm, x, xt = _mlp_pair()
    jstats = jcal.calibrate(jm, v, [x, x * 0.5], per_channel=True)
    tstats = tcal.calibrate(tm, [xt, xt * 0.5], per_channel=True)
    assert jstats.keys() == tstats.keys()
    for path in jstats:
        assert jstats[path].keys() == tstats[path].keys()
        for k in jstats[path]:
            np.testing.assert_allclose(
                tstats[path][k].numpy(), np.asarray(jstats[path][k]),
                rtol=2e-6, err_msg=f"{path} {k}")


@pytest.mark.parametrize("mode", ["minmax", "running"])
def test_merge_stats_matches(mode):
    a = {"m": {"iact_min": -1.0, "iact_max": 2.0}, "only_a": {"iact_max": 1.0}}
    b = {"m": {"iact_min": -3.0, "iact_max": 1.5, "oact_max": 4.0}}
    j = jcal.merge_stats(jax.tree.map(jnp.float32, a),
                         jax.tree.map(jnp.float32, b), mode)
    t = tcal.merge_stats({p: {k: torch.tensor(v) for k, v in r.items()}
                          for p, r in a.items()},
                         {p: {k: torch.tensor(v) for k, v in r.items()}
                          for p, r in b.items()}, mode)
    assert j.keys() == t.keys()
    for p in j:
        for k in j[p]:
            np.testing.assert_allclose(float(t[p][k]), float(j[p][k]),
                                       rtol=1e-7)


# -- Embed / LayerNorm classification, LayerNorm, the C-model loader ----------------

def test_classify_embed_and_layernorm():
    """linen.Embed is EMBED and linen.LayerNorm LAYERNORM, as flax's are."""
    from fp8tpu_torch import linen
    assert jint.classify_module(fnn.Embed(8, 4)) == jpolicy.LayerKind.EMBED
    assert tint.classify_module(linen.Embed(8, 4)).value \
        == tpolicy.LayerKind.EMBED.value == "embed"
    assert jint.classify_module(fnn.LayerNorm()) \
        == jpolicy.LayerKind.LAYERNORM
    assert tint.classify_module(linen.LayerNorm(4)).value == "layernorm"


def test_decoder_ptq_casts_the_embedding_like_jax():
    """A tiny Decoder through quantized_apply with the default e4m3 policy:
    the embedding table is cast bit-equal to the JAX side, and the logits
    agree within the PTQ limit.  The decoder runs in f32: in bf16, XLA's
    fusion elides roundings the port keeps (ROADMAP trap 15), and the fp8
    casts turn those bf16 steps into fp8 steps."""
    from fp8tpu.models import Decoder as JDecoder
    from fp8tpu.models.transformer import tiny_config as j_tiny_config
    from fp8tpu_torch.models import Decoder, tiny_config
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=256, max_seq_len=32, dtype="float32")
    jm, tm = JDecoder(j_tiny_config(**kw)), Decoder(tiny_config(**kw))
    tokens = np.random.default_rng(3).integers(0, 256, (2, 12)).astype(
        np.int32)
    v = jm.init(jax.random.key(0), jnp.asarray(tokens))
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    jp, tp = jpolicy.get_policy("e4m3"), tpolicy.get_policy("e4m3")
    jtable = jint.build_module_table(jm, v, jnp.asarray(tokens))
    ttable = tint.build_module_table(tm)
    assert jtable["embed"] == jpolicy.LayerKind.EMBED
    assert ttable["embed"] == tpolicy.LayerKind.EMBED
    jq = jint.quantize_params(v, jp, jtable)
    tq = tint.quantize_params(tm.state_dict(), tp, ttable)
    want = np.asarray(jq["params"]["embed"]["embedding"])
    got = tq["embed.embedding"].numpy()
    assert (got != v["params"]["embed"]["embedding"]).any()   # it was cast
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    j = np.asarray(jint.quantized_apply(jm, jp, v, jnp.asarray(tokens)))
    with torch.no_grad():
        t = tint.quantized_apply(tm, tp, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3 * np.abs(j).max())


@pytest.mark.parametrize("use_scale,use_bias", [(True, True), (False, True),
                                                (True, False)])
def test_layernorm_bit_equal(use_scale, use_bias):
    """Rows whose statistics are exact (values on a 1/8 grid, variance a
    power of 4) leave only elementwise ops, which must give the same
    bits; Gaussian rows differ by XLA's rsqrt and summation order only."""
    from fp8tpu_torch import linen
    rng = np.random.default_rng(5)
    n, f = 6, 64
    mean = rng.integers(-40, 40, (n, 1)) / 8.0
    half = 2.0 ** rng.integers(-3, 3, (n, 1))
    sign = np.where(rng.permuted(np.arange(f)[None].repeat(n, 0), axis=1)
                    < f // 2, 1.0, -1.0)
    exact = (mean + sign * half).astype(np.float32)
    gauss = (rng.standard_normal((n, f)) * 3 + 0.5).astype(np.float32)
    jm = fnn.LayerNorm(epsilon=0.0, use_scale=use_scale, use_bias=use_bias)
    v = jm.init(jax.random.key(0), exact)
    v = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(
        np.float32), v)
    tm = linen.LayerNorm(f, epsilon=0.0, use_scale=use_scale,
                         use_bias=use_bias)
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    assert set(tm.state_dict()) == {k for k, on in (("scale", use_scale),
                                                    ("bias", use_bias)) if on}
    with torch.no_grad():
        got = tm(torch.from_numpy(exact)).numpy()
        got_g = tm(torch.from_numpy(gauss)).numpy()
    want = np.asarray(jax.jit(jm.apply)(v, exact))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    want_g = np.asarray(jax.jit(jm.apply)(v, gauss))
    np.testing.assert_allclose(got_g, want_g, rtol=0,
                               atol=8 * 2.0 ** -23 * np.abs(want_g).max())
    assert fnn.LayerNorm().epsilon == linen.LayerNorm(4).epsilon == 1e-6
    with torch.no_grad():
        bf = linen.LayerNorm(f, dtype=torch.bfloat16)(
            torch.from_numpy(gauss))
    assert bf.dtype == torch.bfloat16


def test_cmodel_gemm_and_conv_equal_jax_package():
    """The copied C-model loader builds native/cmodel.cpp into the port's
    own build directory and gives the JAX package's results bit for bit."""
    from fp8tpu import cmodel as jcm
    from fp8tpu_torch import cmodel as tcm
    if not tcm.available():
        pytest.skip("no C++ compiler for native/cmodel.cpp")
    assert "fp8tpu_torch" in tcm.build() and tcm.build() != jcm._LIB
    rng = np.random.default_rng(9)
    a = rng.standard_normal((70, 300)).astype(np.float32)
    b = rng.standard_normal((300, 45)).astype(np.float32)
    for kw in (dict(), dict(round_bf16=False, kchunk=64),
               dict(a_trans=True, b_trans=True, alpha=0.5)):
        aa = a.T.copy() if kw.get("a_trans") else a
        bb = b.T.copy() if kw.get("b_trans") else b
        np.testing.assert_array_equal(
            tcm.gemm(aa, bb, **kw).view(np.uint32),
            jcm.gemm(aa, bb, **kw).view(np.uint32))
    x = rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(tcm.conv2d_fp(x, w, 2, 1),
                                  jcm.conv2d_fp(x, w, 2, 1))
    g = rng.standard_normal((2, 5, 5, 7)).astype(np.float32)
    for t, j in zip(tcm.conv2d_vjp(x, w, g, 2, 1),
                    jcm.conv2d_vjp(x, w, g, 2, 1)):
        np.testing.assert_array_equal(t, j)
