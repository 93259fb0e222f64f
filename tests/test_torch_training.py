"""Port parity for FP8 mixed-precision training: fp8tpu_torch.training and
the hw casts under it against fp8tpu (JAX on the CPU, the hw-patched
engine's Pallas kernel in interpret mode, as the JAX package's own tests
run it).

Keys, SR casts, master requantization and weight-gradient casts must be
bit-equal.  Train steps are held to stated tolerances: the port's
convolutions, matmuls and batch statistics sum in another order than
XLA's, and where that moves a value across an fp8 rounding boundary a
cast changes it by one fp8 step."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from fp8tpu.models.mlp import MLP as JMLP
from fp8tpu.models.resnet import RESNET_EXEMPT
from fp8tpu.models.resnet import tiny_resnet as j_tiny_resnet
from fp8tpu.numerics import cast as jcast
from fp8tpu.quant import interceptor as jint
from fp8tpu.training import mpt as jmpt
from fp8tpu_torch.models import mlp as t_mlp
from fp8tpu_torch.models import tiny_resnet, variables_from_flax
from fp8tpu_torch.numerics import cast as tcast
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.quant import interceptor as tint
from fp8tpu_torch.quant import policy as tpolicy
from fp8tpu_torch.training import mpt as tmpt

# Train steps, port against the JAX package.  Losses agree to summation
# order (measured: 1.4e-7 relative over 3 steps of each run); a flipped
# e4m3 forward cast would move a loss by far less than 1e-5 on these
# models.  Parameters came out bit-equal in every run (the fp16 SR master
# copy snaps both onto the same grid); the tolerance allows a parameter
# below 1 to land a few fp16 steps (2^-11 at 1) away.
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-3

BOUNDARY = np.array(
    [0.0, -0.0, 1.0, -1.0, 448.0, 449.0, 480.0, -500.0, 57344.0, 61440.0,
     65504.0, 70000.0, 3.3e38, -3.4e38, 2.0 ** -6, 2.0 ** -9, 2.0 ** -10,
     3 * 2.0 ** -11, 2.0 ** -14, 2.0 ** -16, 2.0 ** -17, 2.0 ** -24,
     2.0 ** -25, 2.0 ** -126, 1e-40, -1e-40, 1e-39, -3e-39, 2.0 ** -149,
     np.inf, -np.inf, np.nan, -np.nan],
    np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# -- keys and casts ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 123456789])
def test_split_and_randint_bit_equal(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    for n in (2, 3, 5):
        want = [tuple(int(w) for w in jax.random.key_data(k))
                for k in jax.random.split(jk, n)]
        assert prng.split(tk, n) == want
    for lo, hi in ((0, 2 ** 31 - 1), (-5, 17), (3, 3), (0, 1 << 20)):
        want = int(jax.random.randint(jk, (), lo, hi, dtype=jnp.int32))
        assert prng.randint(tk, lo, hi) == want, (lo, hi)


def _cast_inputs():
    rng = np.random.default_rng(0)
    x = np.concatenate([BOUNDARY, (rng.standard_normal(2000) * np.exp(
        rng.uniform(-30, 12, 2000))).astype(np.float32)])
    x.view(np.uint32)[-2000] = 0x7F800123          # a NaN with a payload
    rb = rng.integers(0, 65536, x.shape).astype(np.uint16)
    return x, rb


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "bfloat16", "float16"])
def test_hw_sr_and_hw_qdq_bit_equal(fmt):
    """Same bits in, same bits out: normals, the format's subnormals, f32
    subnormals, saturation, ±inf and NaN payloads.  The JAX side runs
    jitted with the scale traced, as fake_quant calls it (a constant
    scale lets XLA fold ``x * 1.0`` and turn ``/ c`` into ``* (1/c)``)."""
    x, rb = _cast_inputs()
    jsr = jax.jit(lambda v, r, s: jcast.hw_sr(v, fmt, s, r))
    jq = jax.jit(lambda v, s: jcast.hw_qdq(v, fmt, s))
    for s in (1.0, 3.7, 1e-3):
        want = jsr(jnp.asarray(x), jnp.asarray(rb), jnp.float32(s))
        got = tcast.hw_sr(torch.from_numpy(x), fmt, s,
                          torch.from_numpy(rb.astype(np.int32)))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"hw_sr scale {s}")
        want = jq(jnp.asarray(x), jnp.float32(s))
        got = tcast.hw_qdq(torch.from_numpy(x), fmt, s)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"hw_qdq scale {s}")


# -- weights, master copy, weight gradients ------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_resnet():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    jm = j_tiny_resnet()
    return jm, jax.jit(jm.init)(jax.random.key(0), x), x


def _resnet():
    """The JAX tiny ResNet, its variables and input, and a fresh port model
    holding the same weights."""
    jm, v, x = _jax_resnet()
    tm = tiny_resnet(device="cpu")
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    return jm, v, tm, x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@functools.lru_cache(maxsize=None)
def _jax_mlp():
    x = np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32)
    jm = JMLP(features=(32,), num_classes=4)
    return jm, jm.init(jax.random.key(0), x), x


def _mlp():
    jm, v, x = _jax_mlp()
    tm = t_mlp(16, (32,), 4, device="cpu")
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    return jm, v, tm, x, torch.from_numpy(x)


def _torch_params(tm, jparams):
    """The JAX params tree as the port's parameter dict (torch names,
    torch layouts)."""
    sd = variables_from_flax({"params": jax.tree.map(np.asarray, jparams)})
    names = dict(tm.named_parameters())
    assert sd.keys() == names.keys()
    return sd


def _assert_params_equal(got, jparams, tm, **tol):
    want = _torch_params(tm, jparams)
    for k in want:
        if tol:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       want[k].numpy(), err_msg=k, **tol)
        else:
            np.testing.assert_array_equal(
                _bits(got[k].detach().numpy()), _bits(want[k].numpy()),
                err_msg=k)


@pytest.mark.parametrize("which", ["resnet", "mlp"])
@pytest.mark.parametrize("master_fmt", ["fp16", "e5m2", "fp32"])
def test_master_requant_bit_equal(which, master_fmt):
    jm, v, tm, x, _ = _resnet() if which == "resnet" else _mlp()
    rng = np.random.default_rng(9)
    jparams = jax.tree.map(
        lambda p: p + rng.standard_normal(p.shape).astype(np.float32) * 1e-3,
        v["params"])
    table = jint.build_module_table(jm, v, x)
    want = jax.jit(lambda p: jmpt.master_requant(
        p, table, jax.random.key(5), master_fmt))(jparams)
    got = tmpt.master_requant(_torch_params(tm, jparams),
                              tint.build_module_table(tm), prng.key(5),
                              master_fmt)
    _assert_params_equal(got, want, tm)


@pytest.mark.parametrize("algo", ["hybrid", "direct", "hybrid-scaled"])
def test_quantize_wtgrads_bit_equal(algo):
    jm, v, tm, x, _ = _resnet()
    rng = np.random.default_rng(10)
    jgrads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
        v["params"])
    table = jint.build_module_table(jm, v, x)
    jp = jmpt.get_policy(algo, training=True).with_exempt(*RESNET_EXEMPT)
    tp = tpolicy.get_policy(algo, training=True).with_exempt(*RESNET_EXEMPT)
    want = jax.jit(lambda g: jmpt.quantize_wtgrads(
        g, jp, table, jax.random.key(6)))(jgrads)
    got = tmpt.quantize_wtgrads(_torch_params(tm, jgrads), tp,
                                tint.build_module_table(tm), prng.key(6))
    _assert_params_equal(got, want, tm)


def test_quantized_apply_gives_every_whitelisted_weight_a_gradient():
    """The weight casts are straight-through: a loss reaches every weight
    that the policy quantizes (and every other parameter)."""
    _, _, tm, _, xt = _resnet()
    policy = tpolicy.get_policy("hybrid", training=True).with_hw_patching()
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in tm.named_parameters()}
    tm.train()
    out = tint.quantized_apply(tm, policy, xt, params=params,
                               key=prng.key(2))
    out.square().sum().backward()
    table = tint.build_module_table(tm)
    whitelisted = [k for k in params if k.endswith(".weight") and policy
                   .resolve(k.rpartition(".")[0].replace(".", "/"),
                            table[k.rpartition(".")[0].replace(".", "/")])
                   is not None]
    assert len(whitelisted) == 7            # 6 convs and the head
    for k, p in params.items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, k


# -- train steps ---------------------------------------------------------------------

def _jax_xent(apply_fn, params, batch):
    x, y = batch
    return optax.softmax_cross_entropy_with_integer_labels(
        apply_fn(params, x), y).mean()


def _torch_xent(apply_fn, params, batch):
    x, y = batch
    return F.cross_entropy(apply_fn(params, x), y)


def _run_jax(emu, opt, loss_fn, params, batch, steps, **kw):
    step = jax.jit(jmpt.make_train_step(emu, opt, loss_fn, **kw))
    state = jmpt.init_train_state(opt, params, kw.get("loss_scale", 2.0 ** 12))
    losses, scales = [], []
    for i in range(steps):
        params, state, loss = step(params, state, batch,
                                   jax.random.fold_in(jax.random.key(1), i))
        losses.append(float(loss))
        scales.append((float(state[1].scale), int(state[1].good_steps)))
    return params, losses, scales


def _run_torch(emu, opt, loss_fn, params, batch, steps, **kw):
    step = tmpt.make_train_step(emu, loss_fn, **kw)
    state = tmpt.init_train_state(opt, kw.get("loss_scale", 2.0 ** 12))
    losses, scales = [], []
    for i in range(steps):
        params, state, loss = step(params, state, batch,
                                   prng.fold_in(prng.key(1), i))
        losses.append(float(loss))
        scales.append((state[1].scale, state[1].good_steps))
    return params, losses, scales


def _check_run(jrun, trun, tm):
    (jparams, jlosses, jscales), (tparams, tlosses, tscales) = jrun, trun
    assert tscales == jscales
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    _assert_params_equal(tparams, jparams, tm, rtol=0, atol=PARAM_ATOL)


def test_train_step_tiny_resnet_hybrid_hw_patched():
    """Three steps of hybrid FP8 training with hw patching (every conv but
    the stem through K2's "hw" route forward and two uncast K2 GEMMs
    backward), BatchNorm on batch statistics, SGD with momentum, dynamic
    loss scaling from 2^12 with growth every 2 steps."""
    jm, v, tm, x, xt = _resnet()
    y = np.arange(4) % 10
    jemu = jmpt.initialize(jm, v, (x,), training_algo="hybrid",
                           exempt_layers=RESNET_EXEMPT)
    jemu = dataclasses.replace(jemu, policy=jemu.policy.with_hw_patching())
    bs = v["batch_stats"]

    def jloss(apply_fn, p, batch):
        xb, yb = batch
        out, _ = apply_fn({"params": p, "batch_stats": bs}, xb, train=True,
                          mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            out, yb).mean()

    jrun = _run_jax(jemu, optax.sgd(0.1, momentum=0.9), jloss, v["params"],
                    (jnp.asarray(x), jnp.asarray(y)), 3, growth_interval=2)

    temu = tmpt.initialize(tm, training_algo="hybrid",
                           exempt_layers=RESNET_EXEMPT, device="cpu")
    temu = dataclasses.replace(temu, policy=temu.policy.with_hw_patching())
    tm.train()
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in tm.named_parameters()}
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
    trun = _run_torch(temu, opt, _torch_xent, params,
                      (xt, torch.from_numpy(y)), 3, growth_interval=2)
    tm.eval()
    assert jrun[2] == [(4096.0, 1), (8192.0, 0), (8192.0, 1)]
    _check_run(jrun, trun, tm)


@pytest.mark.parametrize("algo,patched", [("direct", False),
                                          ("hybrid", False),
                                          ("hybrid", True)])
def test_train_step_mlp(algo, patched):
    """The MLP of tests/test_training.py: Dense layers are never
    engine-patched, so hw patching changes nothing there."""
    jm, v, tm, x, xt = _mlp()
    y = np.arange(8) % 4
    jemu = jmpt.initialize(jm, v, (x,), training_algo=algo)
    temu = tmpt.initialize(tm, training_algo=algo, device="cpu")
    if patched:
        jemu = dataclasses.replace(jemu,
                                   policy=jemu.policy.with_hw_patching())
        temu = dataclasses.replace(temu,
                                   policy=temu.policy.with_hw_patching())
    jrun = _run_jax(jemu, optax.sgd(0.1), _jax_xent, v,
                    (jnp.asarray(x), jnp.asarray(y)), 3)
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in tm.named_parameters()}
    opt = torch.optim.SGD(params.values(), lr=0.1)
    trun = _run_torch(temu, opt, _torch_xent, params,
                      (xt, torch.from_numpy(y)), 3)
    _check_run((jrun[0]["params"],) + jrun[1:], trun, tm)


def _fresh_mlp_step(opt_cls=torch.optim.Adam, **kw):
    _, _, tm, _, xt = _mlp()
    emu = tmpt.initialize(tm, training_algo="hybrid", device="cpu")
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in tm.named_parameters()}
    opt = opt_cls(params.values(), lr=0.1)
    step = tmpt.make_train_step(emu, _torch_xent, **kw)
    return params, opt, step, xt, torch.arange(8) % 4


def test_overflow_is_a_true_skip():
    """A NaN forward: parameters, Adam's moments and step count stay
    bit-identical, the scale halves, twice."""
    params, opt, step, xt, y = _fresh_mlp_step()
    state = tmpt.init_train_state(opt)
    params, state, _ = step(params, state, (xt, y), prng.key(0))   # clean
    before = {k: p.detach().clone() for k, p in params.items()}
    moments = {k: {n: t.clone() for n, t in opt.state[p].items()}
               for k, p in params.items()}
    bad = xt.clone()
    bad[0, 0] = float("nan")
    params, state, _ = step(params, state, (bad, y), prng.key(1))
    assert state[1] == tmpt.LossScaleState(2.0 ** 11, 0)
    params, state, _ = step(params, state, (bad, y), prng.key(2))
    assert state[1].scale == 2.0 ** 10
    for k, p in params.items():
        assert torch.equal(p, before[k]), k
        for n, t in opt.state[p].items():
            assert torch.equal(t, moments[k][n]), (k, n)


def test_loss_scale_grows_and_state_mismatch_raises():
    params, opt, step, xt, y = _fresh_mlp_step(loss_scale=4.0,
                                               growth_interval=2)
    state = tmpt.init_train_state(opt, loss_scale=4.0)
    params, state, _ = step(params, state, (xt, y), prng.key(0))
    assert state[1] == tmpt.LossScaleState(4.0, 1)
    params, state, _ = step(params, state, (xt, y), prng.key(1))
    assert state[1] == tmpt.LossScaleState(8.0, 0)
    assert all(int(s["step"]) == 2 for s in opt.state.values())
    with pytest.raises(ValueError, match="loss_scale mismatch"):
        step(params, opt, (xt, y), prng.key(2))


def test_emulator_facade_methods():
    _, _, tm, _, _ = _mlp()
    emu = tmpt.initialize(tm, training_algo="hybrid", device="cpu")
    assert emu.set_master_param_precision("e5m2").master_fmt == "e5m2"
    assert emu.set_embedding_precision("e4m3").emb_fmt == "e4m3"
    assert emu.blacklist_modules("head").policy.resolve(
        "head", tpolicy.LayerKind.DENSE) is None
