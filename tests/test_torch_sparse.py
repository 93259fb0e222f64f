"""The port's sparsity engine (``fp8tpu_torch.sparse``), ``prng.uniform`` /
shaped ``randint`` and ``fake_quant_sparse`` against the JAX package.

Every case of tests/test_sparse.py runs here against the port, and each
function is held to the JAX one on the same seeded numpy inputs, un-jitted
JAX on the CPU: bit for bit given the same key and state, except the
stochastic-pruning threshold.  That one float goes through torch's f32
``erf`` / ``exp`` / ``log`` and its summation order, which differ from
XLA's in the last bits, so it is held to THRESHOLD_RTOL, about 8x the
worst gap (1.18e-6) ``test_threshold_within_tolerance`` prints over its
inputs (a normal, a lognormal, a small-scale and a half-zero tensor at
sparsities 0.3-0.9).
Everything computed from a given threshold is bit-equal again.

SparseLinear / SparseConv contract in f32 in both packages, in other
summation orders: outputs and gradients within 1e-5 of their largest
magnitude.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.quant.config import TensorQuantConfig as JConfig
from fp8tpu.quant.fakequant import fake_quant as j_fake_quant
from fp8tpu.quant.fakequant import fake_quant_sparse as j_fake_quant_sparse
from fp8tpu.sparse import adaptive as ja
from fp8tpu.sparse import prune as jp
from fp8tpu_torch.models import variables_from_flax
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.quant import interceptor
from fp8tpu_torch.quant.config import TensorQuantConfig
from fp8tpu_torch.quant.fakequant import fake_quant, fake_quant_sparse
from fp8tpu_torch.quant.policy import LayerKind
from fp8tpu_torch.sparse import (
    SparseConfig,
    SparseConv,
    SparseLinear,
    SparseState,
    sparsify_outgrad,
    sparsify_weight,
    sparsity_of,
    stochastic_prune,
    stochastic_prune_threshold,
    topk_prune,
    topk_threshold_sampled,
    weight_mask_step,
)

THRESHOLD_RTOL = 1e-5
LAYER_TOL = 1e-5


def _bits(a):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(pkg, w_alpha, g_alpha, step):
    if pkg == "jax":
        return jp.SparseState(weight_alpha=jnp.float32(w_alpha),
                              outgrad_alpha=jnp.float32(g_alpha),
                              step=jnp.int32(step))
    return SparseState(weight_alpha=torch.tensor(w_alpha, dtype=torch.float32),
                       outgrad_alpha=torch.tensor(g_alpha,
                                                  dtype=torch.float32),
                       step=torch.tensor(step, dtype=torch.int32))


# -- the cases of tests/test_sparse.py, on the port ---------------------------

def test_topk_prune_threshold():
    w = torch.tensor([0.1, -0.5, 0.01, 2.0, -0.02])
    np.testing.assert_array_equal(
        topk_prune(w, 0.05).numpy(), np.float32([0.1, -0.5, 0.0, 2.0, 0.0]))


def test_topk_threshold_sampled_hits_sparsity(rng):
    w = _t(rng.normal(0, 1, 20000).astype(np.float32))
    alpha = topk_threshold_sampled(w, sparsity=0.7, key=prng.key(0))
    sp = float(sparsity_of(topk_prune(w, alpha)))
    assert abs(sp - 0.7) < 0.05, sp


def test_stochastic_prune_unbiased(rng):
    x = rng.normal(0, 1, 50000).astype(np.float32)
    alpha = 0.5
    y = stochastic_prune(_t(x), alpha, prng.key(1)).numpy()
    big = np.abs(x) >= alpha
    np.testing.assert_array_equal(y[big], x[big])
    vals = y[~big]
    assert set(np.round(np.unique(np.abs(vals)), 5)).issubset({0.0, alpha})
    assert abs(vals.mean() - x[~big].mean()) < 5e-3


def _scipy_threshold(x, sparsity):
    from scipy.optimize import root_scalar
    from scipy.special import erf

    logs = np.log(np.abs(x[x != 0]))
    mu, sigma = logs.mean(), logs.std(ddof=1)

    def eq(alpha):
        sqrt2 = np.sqrt(2.0)
        pt1 = np.exp(sigma ** 2 / 2) * erf(sigma / sqrt2
                                           - np.log(alpha) / (sqrt2 * sigma))
        pt2 = alpha * erf(np.log(alpha) / (sqrt2 * sigma))
        pt3 = np.exp(sigma ** 2 / 2)
        return 0.5 - sparsity + (pt1 + pt2 - pt3) / (2 * alpha)

    sol = root_scalar(eq, bracket=[np.exp(-9.0), np.exp(5.0)])
    return np.exp(np.log(sol.root) + mu)


def test_stochastic_threshold_matches_scipy(rng):
    x = rng.lognormal(mean=-2.0, sigma=1.2, size=50000).astype(np.float32)
    x = x * rng.choice([-1, 1], size=x.shape)
    got = float(stochastic_prune_threshold(_t(x), 0.6))
    expected = _scipy_threshold(x, 0.6)
    assert abs(got - expected) / expected < 1e-3
    sp = float(sparsity_of(stochastic_prune(_t(x), got, prng.key(2))))
    assert abs(sp - 0.6) < 0.08, sp


def test_sparsify_weight_window():
    cfg = SparseConfig(weight=True, weight_sparsity=0.5, alpha_window=10)
    w = _t(np.random.default_rng(0).normal(0, 1, 1000).astype(np.float32))
    pruned, alpha = sparsify_weight(w, cfg, _state("torch", 0.0, 0.0, 10),
                                    prng.key(0))
    assert abs(float(sparsity_of(pruned)) - 0.5) < 0.08
    state2 = SparseState(weight_alpha=alpha,
                         outgrad_alpha=torch.tensor(0.0), step=torch.tensor(
                             11, dtype=torch.int32))
    _, alpha2 = sparsify_weight(w, cfg, state2, prng.key(1))
    assert float(alpha2) == float(alpha)


def test_sparsify_outgrad_refreshes():
    cfg = SparseConfig(outgrad=True, outgrad_sparsity=0.5, alpha_window=5)
    g = prng.uniform(prng.key(0), (4096,), -1.0, 1.0)
    y, alpha = sparsify_outgrad(g, cfg, _state("torch", 0.0, 0.0, 5),
                                prng.key(1))
    assert float(alpha) > 0
    assert 0.2 < float(sparsity_of(y)) < 0.8


def test_weight_mask_step_gradient():
    x = torch.tensor([-2.0, -0.7, -0.2, 0.0, 0.2, 0.7, 2.0],
                     requires_grad=True)
    np.testing.assert_array_equal(weight_mask_step(x).detach().numpy(),
                                  [0, 0, 0, 0, 1, 1, 1])
    weight_mask_step(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               [0.0, 0.4, 1.2, 2.0, 1.2, 0.4, 0.0], rtol=1e-6)


def test_sparse_linear_trains(rng):
    torch.manual_seed(0)
    m = SparseLinear(12, 8)
    x = _t(rng.normal(0, 1, (16, 12)).astype(np.float32))
    y = _t(rng.normal(0, 1, (16, 8)).astype(np.float32))
    opt = torch.optim.Adam(m.parameters(), lr=0.01)
    losses = []
    for _ in range(50):
        loss = torch.mean((m(x) - y) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.5
    assert float(m.threshold.detach().abs().max()) > 0


# -- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 7), (2, 3, 4),
                                   (1000,)])
def test_uniform_and_randint_bit_equal(seed, shape):
    jk, tk = jax.random.fold_in(jax.random.key(seed), 3), prng.fold_in(
        prng.key(seed), 3)
    for lo, hi in [(0.0, 1.0), (-2.0, 3.5), (1e-30, 1.0)]:
        want = jax.random.uniform(jk, shape, jnp.float32, lo, hi)
        got = prng.uniform(tk, shape, lo, hi)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for lo, hi in [(0, 10), (0, 2048), (-5, 10 ** 6), (0, 2 ** 31 - 1),
                   (-2 ** 31, 2 ** 31 - 1), (3, 3), (7, 2)]:
        want = np.asarray(jax.random.randint(jk, shape, lo, hi))
        got = prng.randint(tk, lo, hi, shape)
        if shape == ():
            assert isinstance(got, int) and got == int(want), (lo, hi)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_range_is_one_fma():
    """Jitted ``jax.random.uniform`` rounds ``floats * span + minval``
    once (ROADMAP trap 79): a separate multiply and add miss it on the
    share printed here (run with -s); ``prng.uniform`` does not."""
    jk, tk = jax.random.key(3), prng.key(3)
    want = np.asarray(jax.random.uniform(jk, (100000,), jnp.float32, -2.0,
                                         3.5))
    u = prng.uniform(tk, (100000,)).numpy()
    apart = u * np.float32(5.5) + np.float32(-2.0)
    share = float((_bits(apart) != _bits(want)).mean())
    print(f"uniform (-2, 3.5): {share:.4f} of separate mul + add differ")
    assert share > 0.1
    np.testing.assert_array_equal(_bits(prng.uniform(tk, (100000,), -2.0,
                                                     3.5)), _bits(want))


@pytest.mark.parametrize("alpha", [0.5, "array", 1e-3])
def test_stochastic_prune_bit_equal(alpha, rng):
    x = rng.normal(0, 1, (64, 129)).astype(np.float32)
    x.flat[:6] = [1e-40, -1e-40, 0.0, -0.0, 3e-39, -0.5]
    ja_, ta_ = ((jnp.float32(0.37), torch.tensor(0.37))
                if alpha == "array" else (alpha, alpha))
    want = jp.stochastic_prune(jnp.asarray(x), ja_, jax.random.key(4))
    got = stochastic_prune(_t(x), ta_, prng.key(4))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_stochastic_prune_bf16_bit_equal(rng):
    x = rng.normal(0, 1, 4096).astype(np.float32)
    xt = _t(x).bfloat16()
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    for ja_, ta_ in [(0.5, 0.5), (jnp.float32(0.3), torch.tensor(0.3))]:
        want = jp.stochastic_prune(xj, ja_, jax.random.key(9))
        got = stochastic_prune(xt, ta_, prng.key(9))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bits(got.float()), _bits(np.asarray(want).astype(np.float32)))


@pytest.mark.parametrize("alpha", [0.05, "array", 0.0])
def test_topk_prune_bit_equal(alpha, rng):
    w = rng.normal(0, 0.1, (33, 65)).astype(np.float32)
    w.flat[:3] = [1e-40, 0.05, -0.05]
    ja_, ta_ = ((jnp.float32(0.08), torch.tensor(0.08))
                if alpha == "array" else (alpha, alpha))
    np.testing.assert_array_equal(
        _bits(topk_prune(_t(w), ta_)),
        _bits(jp.topk_prune(jnp.asarray(w), ja_)))


@pytest.mark.parametrize("sparsity,factor", [(0.7, 0.1), (0.5, 0.25),
                                             (0.95, 0.05)])
def test_topk_threshold_sampled_bit_equal(sparsity, factor, rng):
    w = rng.normal(0, 1, (100, 201)).astype(np.float32)
    for s in range(3):
        want = jp.topk_threshold_sampled(jnp.asarray(w), sparsity,
                                         jax.random.key(s), factor)
        got = topk_threshold_sampled(_t(w), sparsity, prng.key(s), factor)
        assert _bits(got) == _bits(want)


def _threshold_inputs():
    rng = np.random.default_rng(11)
    half = rng.normal(0, 1, (128, 129)).astype(np.float32)
    half[rng.random(half.shape) < 0.5] = 0.0
    lognormal = rng.lognormal(-2.0, 1.2, 40000).astype(np.float32)
    return {"normal": rng.normal(0, 1, 50000).astype(np.float32),
            "lognormal": lognormal * rng.choice([-1, 1], lognormal.shape),
            "small": rng.normal(0, 1e-3, (64, 257)).astype(np.float32),
            "half-zero": half}


THRESHOLD_INPUTS = _threshold_inputs()


@pytest.mark.parametrize("name", list(THRESHOLD_INPUTS))
def test_threshold_within_tolerance(name):
    """Prints the worst relative gap of the four sparsities (run with -s):
    the measurement behind THRESHOLD_RTOL."""
    x = THRESHOLD_INPUTS[name]
    worst = 0.0
    for sparsity in (0.3, 0.5, 0.6, 0.9):
        want = float(jp.stochastic_prune_threshold(jnp.asarray(x), sparsity))
        got = float(stochastic_prune_threshold(_t(x), sparsity))
        if want == 0.0:
            assert got == 0.0, (sparsity, got)
            continue
        worst = max(worst, abs(got - want) / want)
    print(f"threshold {name}: worst relative gap {worst:.3g}")
    assert worst <= THRESHOLD_RTOL


def test_threshold_is_zero_when_already_sparse():
    x = np.zeros(1000, np.float32)
    x[:100] = np.linspace(0.1, 1.0, 100)
    assert float(stochastic_prune_threshold(_t(x), 0.5)) == 0.0
    assert float(jp.stochastic_prune_threshold(jnp.asarray(x), 0.5)) == 0.0


@pytest.mark.parametrize("step", [0, 10, 11, 20])
def test_sparsify_weight_bit_equal(step, rng):
    cfg = SparseConfig(weight=True, weight_sparsity=0.5, alpha_window=10)
    jcfg = jp.SparseConfig(weight=True, weight_sparsity=0.5, alpha_window=10)
    w = rng.normal(0, 1, (50, 40)).astype(np.float32)
    want, wa = jp.sparsify_weight(jnp.asarray(w), jcfg,
                                  _state("jax", 0.25, 0.0, step),
                                  jax.random.key(step))
    got, ga = sparsify_weight(_t(w), cfg, _state("torch", 0.25, 0.0, step),
                              prng.key(step))
    assert _bits(ga) == _bits(wa)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(sparsity_of(got)) == _bits(jp.sparsity_of(want))


@pytest.mark.parametrize("step", [0, 5, 7])
def test_sparsify_outgrad_bit_equal_given_alpha(step, rng):
    """Off a refresh step the carried alpha is used and the output is
    bit-equal; on one the thresholds agree within THRESHOLD_RTOL, and the
    output is bit-equal given the JAX run's alpha."""
    cfg = SparseConfig(outgrad=True, outgrad_sparsity=0.5, alpha_window=5)
    jcfg = jp.SparseConfig(outgrad=True, outgrad_sparsity=0.5,
                           alpha_window=5)
    g = rng.normal(0, 1e-2, (32, 128)).astype(np.float32)
    want, wa = jp.sparsify_outgrad(jnp.asarray(g), jcfg,
                                   _state("jax", 0.0, 0.004, step),
                                   jax.random.key(1))
    got, ga = sparsify_outgrad(_t(g), cfg, _state("torch", 0.0, 0.004, step),
                               prng.key(1))
    if step % 5 or step == 0:
        assert _bits(ga) == _bits(wa)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        assert abs(float(ga) - float(wa)) <= THRESHOLD_RTOL * float(wa)
        again = stochastic_prune(_t(g), torch.tensor(float(wa)), prng.key(1))
        np.testing.assert_array_equal(_bits(again), _bits(want))


def test_sparsity_of_bit_equal(rng):
    x = rng.normal(0, 1, 3001).astype(np.float32)
    x[::3] = 0.0
    x[1:10] = 1e-40          # subnormals count as zeros under XLA
    assert _bits(sparsity_of(_t(x))) == _bits(jp.sparsity_of(jnp.asarray(x)))


def test_weight_mask_step_bit_equal_to_jax_grad():
    x = np.array([-2.0, -1.0, -0.7, -0.4, -0.2, 0.0, 1e-40, 0.2, 0.3999,
                  0.4, 0.4001, 0.7, 1.0, 1.0001, 2.0], np.float32)
    w = np.arange(x.size, dtype=np.float32) - 3.5
    want_y = ja.weight_mask_step(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(ja.weight_mask_step(v) * w))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = weight_mask_step(xt)
    (y * _t(w)).sum().backward()
    np.testing.assert_array_equal(_bits(y), _bits(want_y))
    np.testing.assert_array_equal(_bits(xt.grad), _bits(want_g))


def _jax_layer(kind, threshold_value):
    if kind == "linear":
        m, x = ja.SparseLinear(features=6), np.random.default_rng(3).normal(
            0, 1, (5, 7)).astype(np.float32)
    else:
        m = ja.SparseConv(features=4, kernel_size=(3, 3), strides=(2, 2))
        x = np.random.default_rng(3).normal(0, 1, (2, 9, 9, 3)).astype(
            np.float32)
    v = m.init(jax.random.key(0), jnp.asarray(x))
    v = jax.tree.map(np.asarray, v)
    thr = v["params"]["threshold"]
    v["params"]["threshold"] = np.full_like(thr, threshold_value) + \
        np.linspace(0.0, 0.1, thr.size, dtype=np.float32)
    v["params"]["bias"] = np.linspace(-0.2, 0.2, thr.size).astype(np.float32)
    return m, v, x


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("threshold", [0.3, 50.0],
                         ids=["masked", "degenerate"])
def test_sparse_layers_match_jax(kind, threshold):
    """Outputs and the gradients of weight, threshold and bias, with the
    JAX layer's parameters carried across by variables_from_flax; a
    threshold above every weight leaves no survivor, and the mask resets
    to threshold 0 in both."""
    m, v, x = _jax_layer(kind, threshold)
    up = np.random.default_rng(5)

    def loss(params, xx):
        y = m.apply({"params": params}, xx)
        return jnp.sum(y * jnp.asarray(cot)), y

    y0 = m.apply(v, jnp.asarray(x))
    cot = up.normal(0, 1, y0.shape).astype(np.float32)
    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
        v["params"], jnp.asarray(x))

    sd = variables_from_flax(v)
    assert set(sd) == {"weight", "threshold", "bias"}
    if kind == "linear":
        tm = SparseLinear(7, 6)
        xt = _t(x)
    else:
        tm = SparseConv(3, 4, kernel_size=(3, 3), strides=(2, 2))
        xt = _t(x.transpose(0, 3, 1, 2))
    tm.load_state_dict(sd)
    y = tm(xt)
    ct = _t(cot) if kind == "linear" else _t(cot.transpose(0, 3, 1, 2))
    (y * ct).sum().backward()
    got = y.detach().numpy()
    if kind == "conv":
        got = got.transpose(0, 2, 3, 1)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LAYER_TOL * np.abs(want).max())
    gw = variables_from_flax({"params": jax.tree.map(np.asarray, grads)})
    for name, p in tm.named_parameters():
        w = gw[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=LAYER_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
    # degenerate: the reset mask is |w| > 0, which the threshold does not
    # reach; otherwise the window passes it a gradient
    assert (np.count_nonzero(gw["threshold"].numpy()) > 0) == (threshold < 1)


def test_sparse_layers_are_uncast_other():
    table = interceptor.build_module_table(torch.nn.Sequential(
        SparseLinear(4, 4), SparseConv(4, 4)))
    assert set(table.values()) == {LayerKind.OTHER}


def _coo_case():
    x = np.zeros((8, 8), np.float32)
    x[1, 2], x[5, 5], x[0, 7] = 1.37, -0.021, 300.0
    return x


@pytest.mark.parametrize("mode", [("e4m3", "rne", "none"),
                                  ("e4m3", "rne", "per-tensor"),
                                  ("e5m2", "stochastic", "per-tensor"),
                                  ("e4m3", "stochastic", "none")])
def test_fake_quant_sparse_matches_jax(mode, rng):
    """Values bit-equal to the JAX BCOO's data, indices and shape as
    given, and the dense result of tests/test_cast_jnp.py's case."""
    from jax.experimental import sparse as jsparse

    dtype, scheme, scaling = mode
    x = rng.normal(0, 2, (24, 40)).astype(np.float32)
    x[rng.random(x.shape) < 0.7] = 0.0
    x[:8, :8] = _coo_case()
    jk = jax.random.key(5) if scheme == "stochastic" else None
    tk = prng.key(5) if scheme == "stochastic" else None
    jcfg = JConfig(dtype, scheme, scaling=scaling)
    cfg = TensorQuantConfig(dtype, scheme, scaling=scaling)
    want = j_fake_quant_sparse(jsparse.BCOO.fromdense(jnp.asarray(x)), jcfg,
                               jk)
    sp = _t(x).to_sparse_coo()
    got = fake_quant_sparse(sp, cfg, tk)
    assert got.layout == torch.sparse_coo and got.shape == sp.shape
    assert torch.equal(got.indices(), sp.coalesce().indices())
    np.testing.assert_array_equal(_bits(got.values()), _bits(want.data))
    if scheme == "rne":
        dense = np.asarray(j_fake_quant(jnp.asarray(x), jcfg))
        nz = x != 0
        np.testing.assert_array_equal(_bits(got.to_dense())[nz],
                                      _bits(dense)[nz])
        np.testing.assert_array_equal(
            _bits(fake_quant_sparse(_t(x), cfg)),
            _bits(fake_quant(_t(x), cfg)))


def test_fake_quant_sparse_rejects_channel_scaling():
    cfg = TensorQuantConfig("e4m3", "rne", scaling="per-channel")
    with pytest.raises(ValueError, match="none/per-tensor"):
        fake_quant_sparse(_t(_coo_case()).to_sparse_coo(), cfg)
