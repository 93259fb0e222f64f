"""fp8tpu_torch.training.opt8 (and P3's plain version under it) against
fp8tpu.training.opt8, JAX on the CPU.

Un-jitted JAX is the op-by-op reference: payload bytes, scales, updates
and parameters bit for bit.  Jitted, XLA rewrites the update (a divide by
a constant turned into a multiply by its reciprocal), so from a common
state the scales move by an ulp or two, a few codes flip and the updates
differ by up to ~4e-4 relative after 5 steps (measured): held within 2
ulp, 99.9% of codes and 1e-3 relative.  The JAX package's own cases of
tests/test_opt8.py are mirrored at the end."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fp8tpu.training import opt8 as jo
from fp8tpu_torch.kernels import adam8
from fp8tpu_torch.numerics.cast import _flush
from fp8tpu_torch.training import opt8 as to

SHAPES = {"a": (300, 257), "b": (7, 11, 3)}


@functools.lru_cache(maxsize=None)
def _grads(steps=5, seed=0):
    """Gradients spread over 8 decades (and into the f32 subnormal range
    once squared)."""
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * np.exp(rng.uniform(-18, 0, s)))
             .astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(steps)]


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _u32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def _u8(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _run_unjitted(steps):
    tx, tt = jo.scale_by_adam_8bit(), to.scale_by_adam_8bit()
    zeros = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    with jax.disable_jit():
        js = tx.init(jax.tree.map(jnp.asarray, zeros))
    ts = tt.init(_t(zeros))
    out = []
    for g in _grads()[:steps]:
        with jax.disable_jit():
            ju, js = tx.update(jax.tree.map(jnp.asarray, g), js)
        tu, ts = tt.update(_t(g), ts)
        out.append((ju, js, tu, ts))
    return out


def _assert_step_equal(ju, js, tu, ts):
    assert int(ts.count) == int(js.count)
    for k in SHAPES:
        np.testing.assert_array_equal(_u32(tu[k]), _u32(ju[k]), err_msg=k)
        for which in ("m", "v"):
            jm, tm = getattr(js, which)[k], getattr(ts, which)[k]
            np.testing.assert_array_equal(_u8(tm.payload), _u8(jm.payload))
            np.testing.assert_array_equal(_u32(tm.scale), _u32(jm.scale))


def _first_difference(k, step, g, old, ju, js, tu, ts):
    """None where step ``step`` of leaf ``k`` is the JAX package's bit for
    bit, else a report of its first differing element: where, its
    gradient, its block's old codes and scales (the port's state before
    the step), the count, and both results there."""
    first = {}
    d = np.flatnonzero(_u32(tu[k]).reshape(-1) != _u32(ju[k]).reshape(-1))
    if d.size:
        first["update"] = int(d[0])
    for which in ("m", "v"):
        jm, tm = getattr(js, which)[k], getattr(ts, which)[k]
        d = np.flatnonzero(_u8(tm.payload).reshape(-1)
                           != _u8(jm.payload).reshape(-1))
        if d.size:
            first[f"{which} code"] = int(d[0])
        d = np.flatnonzero(_u32(tm.scale) != _u32(jm.scale))
        if d.size:
            first[f"{which} scale"] = int(d[0]) * 256
    if not first:
        return None
    i = min(first.values())
    b = i // 256
    gf = g[k].reshape(-1)
    gi = gf[i] if i < gf.size else np.float32(0)

    def state(st, label):
        return ", ".join(
            f"{label} {w} code 0x{_u8(getattr(st, w)[k].payload).reshape(-1)[i]:02x}"
            f" scale {float(np.asarray(getattr(st, w)[k].scale)[b])!r}"
            f" (0x{_u32(getattr(st, w)[k].scale)[b]:08x})" for w in "mv")

    def upd(u):
        flat = np.asarray(u[k]).reshape(-1)
        return (f"{float(flat[i])!r} (0x{_u32(flat)[i]:08x})"
                if i < flat.size else "padding")

    return (f"leaf {k}, step {step} (count {int(ts.count)}): first "
            f"difference at element {i} (block {b}) in {sorted(first)}; "
            f"g {float(gi)!r} (0x{np.float32(gi).view(np.uint32):08x}); "
            f"{state(old, 'old')}; port: update {upd(tu)}, "
            f"{state(ts, 'new')}; JAX: update {upd(ju)}, "
            f"{state(js, 'new')}")


def test_scale_by_adam_8bit_bit_equal_to_unjitted_jax():
    """5 updates of a (300, 257) leaf and an odd-shaped one: updates,
    payload bytes and scales bit for bit at every step.  On a failure the
    message holds the first differing element's inputs."""
    old = to.scale_by_adam_8bit().init(
        _t({k: np.zeros(s, np.float32) for k, s in SHAPES.items()}))
    for step, (ju, js, tu, ts) in enumerate(_run_unjitted(5), 1):
        for k in SHAPES:
            report = _first_difference(k, step, _grads()[step - 1], old, ju,
                                       js, tu, ts)
            assert report is None, report
        _assert_step_equal(ju, js, tu, ts)
        old = ts


def test_first_difference_reports_the_inputs():
    """The failure report of the bit-equality test: a code planted one
    byte off is found, with its element, gradient, old state and count."""
    ju, js, tu, ts = _run_unjitted(1)[0]
    old = to.scale_by_adam_8bit().init(
        _t({k: np.zeros(s, np.float32) for k, s in SHAPES.items()}))
    assert _first_difference("a", 1, _grads()[0], old, ju, js, tu,
                             ts) is None
    ts.m["a"].payload.view(-1)[300] += 1
    report = _first_difference("a", 1, _grads()[0], old, ju, js, tu, ts)
    g = float(_grads()[0]["a"].reshape(-1)[300])
    for part in ("element 300 (block 1)", "['m code']", "count 1",
                 f"g {g!r}", "old m code 0x00 scale 0.0", "JAX: update"):
        assert part in report, (part, report)


def test_plain_f32_sqrt_breaks_parity(monkeypatch):
    """torch's CPU f32 sqrt is not correctly rounded in its vectorised
    loop; P3's plain version takes the f64 route.  With a plain
    ``torch.sqrt`` the updates leave the JAX package's."""
    monkeypatch.setattr(adam8, "_sqrt",
                        lambda x: _flush(torch.sqrt(_flush(x))))
    ju, _, tu, _ = _run_unjitted(1)[0]
    assert (_u32(tu["a"]) != _u32(ju["a"])).sum() > 0


def test_scale_by_adam_8bit_near_jitted_jax():
    """Against the jitted update, from a common state each step (the port's
    state fed to both)."""
    tx, tt = jo.scale_by_adam_8bit(), to.scale_by_adam_8bit()
    zeros = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    ts = tt.init(_t(zeros))
    jupd = jax.jit(tx.update)
    for g in _grads():
        js = jo.Adam8State(
            count=jnp.asarray(ts.count.numpy()),
            m={k: jo.Moment8(jnp.asarray(m.payload.numpy()),
                             jnp.asarray(m.scale.numpy()))
               for k, m in ts.m.items()},
            v={k: jo.Moment8(jnp.asarray(_u8(m.payload)).view(
                jnp.float8_e4m3fn), jnp.asarray(m.scale.numpy()))
               for k, m in ts.v.items()})
        ju, js = jupd(jax.tree.map(jnp.asarray, g), js)
        tu, ts = tt.update(_t(g), ts)
        for k in SHAPES:
            a, b = tu[k].numpy(), np.asarray(ju[k])
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=0)
            for which in ("m", "v"):
                jm, tm = getattr(js, which)[k], getattr(ts, which)[k]
                ulp = np.abs(_u32(tm.scale).astype(np.int64)
                             - _u32(jm.scale).astype(np.int64))
                assert ulp.max() <= 2, (k, which, ulp.max())
                same = (_u8(tm.payload) == _u8(jm.payload)).mean()
                assert same >= 0.999, (k, which, same)


@pytest.mark.parametrize("mask,schedule", [(False, False), (True, False),
                                           (False, True)],
                         ids=["plain", "mask", "schedule"])
def test_adamw_8bit_parameters_bit_equal_to_unjitted_chain(mask, schedule):
    """Three steps of ``adamw_8bit`` (optax's order: adam, decayed weights,
    -lr, apply) against the un-jitted optax chain: parameters, count and
    payloads bit for bit; with a decay mask and with a schedule."""
    rng = np.random.default_rng(5)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    m = {"a": True, "b": False} if mask else None
    lr = optax.linear_schedule(1e-2, 1e-3, 5) if schedule else 1e-3
    jtx = jo.adamw_8bit(lr, mask=m)
    with jax.disable_jit():
        jp = jax.tree.map(jnp.asarray, p0)
        js = jtx.init(jp)
        for g in _grads()[:3]:
            u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
            jp = optax.apply_updates(jp, u)
    tp = _t(p0)
    opt = to.adamw_8bit(tp, (lambda c: float(lr(c))) if schedule else lr,
                        mask=m)
    for g in _grads()[:3]:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in SHAPES:
        np.testing.assert_array_equal(_u32(tp[k]), _u32(jp[k]), err_msg=k)
        np.testing.assert_array_equal(
            _u8(opt.state[tp[k]]["v"].payload), _u8(js[0].v[k].payload))
    assert opt.count == int(js[0].count) == 3
    assert to.state_bytes(opt) == jo.state_bytes(js)


def test_state_bytes_equal_to_jax():
    params = {"w": np.zeros((1024, 512), np.float32),
              "b": np.zeros(33, np.float32)}
    jb = jo.state_bytes(jo.scale_by_adam_8bit().init(
        jax.tree.map(jnp.asarray, params)))
    assert to.state_bytes(to.scale_by_adam_8bit().init(_t(params))) == jb
    adamw = torch.optim.AdamW([torch.zeros(1024, 512)])
    adamw.param_groups[0]["params"][0].grad = torch.zeros(1024, 512)
    adamw.step()
    assert to.state_bytes(adamw) / jb > 3.8


# -- tests/test_opt8.py, mirrored ----------------------------------------------

def _mlp_task(seed=0):
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.standard_normal((256, 16)), dtype=torch.float32)
    w_true = torch.tensor(rng.standard_normal((16, 1)), dtype=torch.float32)
    y = torch.tanh(X @ w_true) + 0.01 * torch.tensor(
        rng.standard_normal((256, 1)), dtype=torch.float32)
    params = {
        "w1": torch.tensor(rng.standard_normal((16, 33)) * 0.3,
                           dtype=torch.float32),
        "b1": torch.zeros(33),       # 33: not a block multiple
        "w2": torch.tensor(rng.standard_normal((33, 1)) * 0.3,
                           dtype=torch.float32),
    }

    def loss_fn(p):
        h = torch.tanh(X @ p["w1"] + p["b1"])
        return ((h @ p["w2"] - y) ** 2).mean()

    return params, loss_fn


def _train(opt_fn, seed, steps):
    params, loss_fn = _mlp_task(seed)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    opt = opt_fn(params)
    with torch.no_grad():
        base = float(loss_fn(params))
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(params)
        loss.backward()
        opt.step()
    with torch.no_grad():
        return float(loss_fn(params)), base


def test_converges_like_fp32_adam():
    loss8, base = _train(lambda p: to.adamw_8bit(p, 1e-2, block=64), 0, 300)
    loss32, _ = _train(lambda p: torch.optim.AdamW(
        p.values(), lr=1e-2, weight_decay=1e-4), 0, 300)
    assert loss8 < 0.1 * base, (loss8, base)
    assert loss8 <= loss32 * 1.3 + 1e-4, (loss8, loss32)


def test_moments_track_fp32_adam():
    params, loss_fn = _mlp_task(seed=1)
    tt = to.scale_by_adam_8bit(block=64)
    s8 = tt.init(params)
    p8 = {k: v.clone() for k, v in params.items()}
    p32 = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    adam = torch.optim.Adam(p32.values(), lr=1e-2, eps=1e-8)
    for _ in range(10):
        q = {k: v.clone().requires_grad_(True) for k, v in p8.items()}
        g8 = dict(zip(q, torch.autograd.grad(loss_fn(q), list(q.values()))))
        u8, s8 = tt.update(g8, s8)
        p8 = {k: p8[k] - 1e-2 * u8[k] for k in p8}
        adam.zero_grad()
        loss_fn(p32).backward()
        adam.step()
    m8 = (s8.m["w1"].payload.float() * s8.m["w1"].scale[:, None]).reshape(-1)
    m32 = adam.state[p32["w1"]]["exp_avg"].reshape(-1)
    m8 = m8[:m32.numel()]
    assert float((m8 - m32).abs().max()) < 0.12 * float(m32.abs().max())
    a = p8["w1"].reshape(-1).numpy()
    b = p32["w1"].detach().reshape(-1).numpy()
    assert np.corrcoef(a, b)[0, 1] > 0.995


def test_state_is_4x_smaller():
    params = {"w": torch.zeros(1024, 512)}
    b8 = to.state_bytes(to.scale_by_adam_8bit(block=256).init(params))
    assert 2 * 4 * 1024 * 512 / b8 > 3.8, b8


def test_padding_roundtrip_odd_shapes():
    tt = to.scale_by_adam_8bit(block=256)
    s = tt.init({"w": torch.full((7, 13), 0.5)})
    u, s = tt.update({"w": torch.full((7, 13), 0.25)}, s)
    assert u["w"].shape == (7, 13)
    assert bool(torch.isfinite(u["w"]).all())
    uw = u["w"].numpy()
    assert np.allclose(uw, uw[0, 0], rtol=1e-5)


def test_second_moment_e4m3_preserves_small_entries():
    tt = to.scale_by_adam_8bit(b2=0.0, block=64)   # v = g^2 directly
    s = tt.init({"w": torch.zeros(64)})
    g = torch.tensor(np.concatenate([np.full(32, 10.0), np.full(32, 0.1)]),
                     dtype=torch.float32)
    _, s = tt.update({"w": g}, s)
    v = (s.v["w"].payload.float() * s.v["w"].scale[:, None]).reshape(-1)
    np.testing.assert_allclose(v[:32].numpy(), 100.0, rtol=0.07)
    np.testing.assert_allclose(v[32:].numpy(), 1e-2, rtol=0.07)
