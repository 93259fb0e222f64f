"""Port parity for batched ring writes (``ServeConfig.ring_flush = W``).

(a) ``_steps_impl`` with ``ring_flush=4`` against the JAX package's
    ``_steps_impl_sideflush`` (reached through its ``_steps_impl``), both
    un-jitted, on the tiny ring decoder after a prefill: per-step logits
    within the serving parity test's EAGER_TOL of max|logit|, the ring's
    payload and scale bytes equal (measured: every byte, for both format
    pairs), the head equal, and one ring write every W steps.
(b) The two alignment errors, with the JAX messages.
(c) The engine's chunk choice against the JAX engine's for W in 2, 4 and
    6 (a multiple of W on the ring, untouched on the paged pool), and the
    ring engine with ``ring_flush=4`` against the same engine without it.
(d) ``ring_store_plain(rows=W)`` against the JAX flush's
    ``dynamic_update_slice`` of the W-row side buffer at aligned heads, bit
    for bit, and at a start past ``n - W``, where the port wraps each row
    mod n (the JAX slice clamps the start: ROADMAP §3).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_serve_model as serve
from fp8tpu.serve import RingKVCache as JRing
from fp8tpu.serve import ServingEngine as JServingEngine
from fp8tpu.serve import model as jmodel
from fp8tpu_torch.kernels import inplace
from fp8tpu_torch.serve import (Request, RingKVCache, ServingEngine,
                                decode_chunk)
from fp8tpu_torch.serve import model as tmodel

W = 4


def _prefilled(fmt, kv_fmt, W):
    """Both sides after a prefill of slot 0 (slot 1 empty), with
    ``ring_flush = W``; the prefill's (JAX, port) logits last."""
    jp, tp = serve._artifact(fmt)
    jsc, tsc = serve._cfgs(fmt, kv_fmt)
    jsc = dataclasses.replace(jsc, ring_flush=W)
    tsc = dataclasses.replace(tsc, ring_flush=W)
    S = serve.S
    jr = JRing.create(2, 2, S, 2, 16, kv_fmt)
    tr = RingKVCache.create(2, 2, S, 2, 16, kv_fmt, device="cpu")
    prompt = np.array(serve.PROMPT + [0] * (S - len(serve.PROMPT)), np.int32)
    jl, jr = jmodel.prefill(jp, jr, jnp.asarray(prompt), jnp.int32(0),
                            jnp.int32(len(serve.PROMPT)), jsc)
    tl, tr = tmodel.prefill(tp, tr, torch.from_numpy(prompt), 0,
                            len(serve.PROMPT), tsc)
    tok = np.array([int(np.argmax(np.asarray(jl))), 7], np.int32)
    pos = np.array([len(serve.PROMPT), 0], np.int32)
    return jp, tp, jsc, tsc, jr, tr, tok, pos, (np.asarray(jl), tl.numpy())


@pytest.mark.parametrize("fmt,kv_fmt", [("e4m3", "int8"), ("int4", "e4m3")])
def test_sideflush_decode_matches_jax_unjitted(monkeypatch, fmt, kv_fmt):
    n = 2 * W
    rows = []
    orig = inplace.ring_store

    def counting(*a, **kw):
        rows.append(kw.get("rows", 1))
        return orig(*a, **kw)
    monkeypatch.setattr(inplace, "ring_store", counting)
    with jax.disable_jit():
        jp, tp, jsc, tsc, jr, tr, tok, pos, first = _prefilled(fmt, kv_fmt,
                                                               W)
        temp = np.zeros(2, np.float32)
        jl, jr, _, _ = jmodel._steps_impl(
            jp, jr, jnp.asarray(tok), jnp.asarray(pos), jax.random.key(0),
            jnp.asarray(temp), n, jsc, True, greedy_only=True)
    (tl, ttok), tr, _, fpos = tmodel._steps_impl(
        tp, tr, torch.from_numpy(tok), torch.from_numpy(pos), None,
        torch.from_numpy(temp), n, tsc, True, greedy_only=True)
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (n, 2, 128)
    # the greedy tokens fed forward are the same on both sides
    np.testing.assert_array_equal(ttok.numpy(), jl.argmax(-1))
    pairs = [first] + [(jl[i], tl[i].numpy()) for i in range(n)]
    assert rows == [W, W]                      # one W-row flush every W steps
    serve._check_run(pairs, jr, tr, serve.EAGER_TOL, 0.99)
    np.testing.assert_array_equal(serve.raw(tr.kv8), serve.raw(jr.kv8))
    np.testing.assert_array_equal(serve.raw(tr.sc), serve.raw(jr.sc))
    assert int(tr.ticket) == 0
    assert torch.equal(fpos, torch.from_numpy(pos) + n)


def test_sideflush_equals_single_row_writes_in_the_port():
    """Side buffer + W-row flush and one row a step attend to the same
    keys: within the chunk-vs-steps bound (ROADMAP trap 18), with rings
    mostly byte-equal and the same head."""
    _, tp, _, tsc, _, ra, tok, pos, _ = _prefilled("e4m3", "int8", W)
    _, _, _, tsc1, _, rb, _, _, _ = _prefilled("e4m3", "int8", 0)
    temp = torch.zeros(2)
    t, p = torch.from_numpy(tok), torch.from_numpy(pos)
    ta, la, ra, fa, pa = decode_chunk(tp, ra, t, p, None, temp, 2 * W, tsc,
                                      greedy_only=True)
    tb, lb, rb, fb, pb = decode_chunk(tp, rb, t, p, None, temp, 2 * W, tsc1,
                                      greedy_only=True)
    assert int(ra.head) == int(rb.head) == 2 * W
    assert torch.equal(pa, pb)
    same = (serve.raw(ra.kv8) == serve.raw(rb.kv8)).mean()
    assert same >= 0.99, same
    np.testing.assert_allclose(serve.f32(ra.sc), serve.f32(rb.sc),
                               rtol=2.0 ** -7, atol=0)
    # tokens agree until a near tie (both decode the same distributions)
    agree = (ta == tb).float().mean()
    assert agree >= 0.5, (ta, tb)


# -- (b) the alignment errors ----------------------------------------------------

@pytest.mark.parametrize("n_steps,S,what", [(6, 32, "divisible"),
                                            (8, 30, "max_seq")])
def test_misaligned_chunk_and_ring_raise_like_jax(n_steps, S, what):
    jp, tp = serve._artifact("e4m3")
    jsc, tsc = serve._cfgs("e4m3", "int8")
    jsc = dataclasses.replace(jsc, ring_flush=W)
    tsc = dataclasses.replace(tsc, ring_flush=W)
    tok = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match=what) as want:
        jmodel._steps_impl(jp, JRing.create(2, 2, S, 2, 16, "int8"),
                           jnp.asarray(tok), jnp.asarray(tok),
                           jax.random.key(0), jnp.zeros(2), n_steps, jsc,
                           False)
    with pytest.raises(ValueError, match=what) as got:
        tmodel._steps_impl(tp, RingKVCache.create(2, 2, S, 2, 16, "int8",
                                                  device="cpu"),
                           torch.from_numpy(tok), torch.from_numpy(tok),
                           None, torch.zeros(2), n_steps, tsc, False)
    assert str(got.value) == str(want.value)


# -- (c) the engine ---------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 4, 6])
@pytest.mark.parametrize("use_paged", [False, True], ids=["ring", "paged"])
def test_pick_chunk_matches_the_jax_engine(w, use_paged):
    jp, tp = serve._artifact("e4m3")
    jsc, tsc = serve._cfgs("e4m3", "int8")
    kw = dict(n_slots=2, max_seq=48, use_paged=use_paged, page_size=8)
    for chunk_size in (1, 5, 16, 32):
        jeng = JServingEngine(jp, dataclasses.replace(jsc, ring_flush=w),
                              chunk_size=chunk_size, **kw)
        teng = ServingEngine(tp, dataclasses.replace(tsc, ring_flush=w),
                             chunk_size=chunk_size, device="cpu", **kw)
        for budgets in ((0, 0), (1, 0), (3, 2), (5, 1), (9, 0), (17, 30),
                        (40, 2)):
            jeng._rem_est = teng._rem_est = lambda i, b=budgets: b[i]
            got, want = teng._pick_chunk(), jeng._pick_chunk()
            assert got == want, (chunk_size, budgets, got, want)
            if got and not use_paged:
                assert got % w == 0


def test_ring_engine_with_ring_flush_answers_like_single_row_writes():
    """The ring engine with ring_flush=4 serves every request its budget
    with chunks of 4, 8, ...; its tokens agree with the single-row engine's
    (the same distributions, another summation order of the side rows)."""
    _, tp = serve._artifact("e4m3")
    _, tsc = serve._cfgs("e4m3", "int8")
    reqs = lambda: [Request(uid=i, prompt=[1 + i, 2 + i, 3 + i],
                            max_new_tokens=7) for i in range(3)]
    chunks = []
    eng = ServingEngine(tp, dataclasses.replace(tsc, ring_flush=W),
                        n_slots=2, max_seq=32, chunk_size=8, device="cpu")
    orig = eng._pick_chunk
    eng._pick_chunk = lambda: chunks.append(orig()) or chunks[-1]
    out = eng.run(reqs())
    ref = ServingEngine(tp, tsc, n_slots=2, max_seq=32, chunk_size=8,
                        device="cpu").run(reqs())
    assert set(out) == {0, 1, 2}
    assert all(len(v) == 7 for v in out.values())
    assert all(c % W == 0 for c in chunks if c)
    assert sum(out[u] == ref[u] for u in out) >= 2


# -- (d) the W-row store ------------------------------------------------------------

L, SLOTS, KV, D, S = 2, 2, 2, 16, 8


@pytest.mark.parametrize("head", [0, 4], ids=["head0", "head4"])
@pytest.mark.parametrize("kind", ["int8", "e4m3"])
def test_w_row_store_plain_matches_the_jax_flush(rng, kind, head):
    j_t, t_t = {"int8": (jnp.int8, torch.int8),
                "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}[kind]
    bk = SLOTS * KV
    kv = jnp.asarray(rng.standard_normal((S, 2, L, bk, D)) * 40).astype(j_t)
    sc = rng.random((S, 2, L, bk)).astype(np.float32)
    side8 = jnp.asarray(rng.standard_normal((W, 2, L, bk, D)) * 40
                        ).astype(j_t)
    side_sc = rng.random((W, 2, L, bk)).astype(np.float32)
    z = jnp.zeros((), jnp.int32)
    jkv = jax.lax.dynamic_update_slice(kv, side8, (jnp.int32(head), z, z, z, z))
    jsc = jax.lax.dynamic_update_slice(jnp.asarray(sc), jnp.asarray(side_sc),
                                       (jnp.int32(head), z, z, z))
    tkv = torch.from_numpy(np.asarray(kv).view(np.uint8).copy()).view(t_t)
    tsc = torch.from_numpy(sc.copy())
    ts8 = torch.from_numpy(np.asarray(side8).view(np.uint8).copy()).view(t_t)
    thead = torch.tensor(head, dtype=torch.int32)
    before = inplace.launches
    inplace.ring_store(tkv, ts8, tsc, torch.from_numpy(side_sc), thead, S,
                       torch.zeros(1, dtype=torch.int32), rows=W)
    assert inplace.launches == before          # the plain version, on the CPU
    assert int(thead) == (head + W) % S
    np.testing.assert_array_equal(tkv.view(torch.uint8).numpy(),
                                  np.asarray(jkv).view(np.uint8))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("head", [S - 1, S - 2, 2 * S - 3, -1])
def test_w_row_store_plain_wraps_each_row(rng, head):
    """A start past n - W wraps row by row, as ``dyn_store`` wraps its
    index: no byte outside the ring, every other row untouched."""
    kv = torch.from_numpy(rng.integers(-127, 128, (S, 3, 5), dtype=np.int8))
    sc = torch.from_numpy(rng.random((S, 3), dtype=np.float32))
    s8 = torch.from_numpy(rng.integers(-127, 128, (W, 3, 5), dtype=np.int8))
    ss = torch.from_numpy(rng.random((W, 3), dtype=np.float32))
    want8, wants = kv.clone(), sc.clone()
    for w in range(W):
        want8[(head + w) % S] = s8[w]
        wants[(head + w) % S] = ss[w]
    h = torch.tensor(head, dtype=torch.int32)
    inplace.ring_store_plain(kv, s8, sc, ss, h, S, rows=W)
    assert torch.equal(kv, want8) and torch.equal(sc, wants)
    assert int(h) == (head + W) % S


def test_w_row_store_checks_its_slab():
    kv = torch.zeros((S, 3), dtype=torch.int8)
    sc = torch.zeros((S,), dtype=torch.float32)
    h = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="row"):
        inplace.ring_store_plain(kv, torch.zeros((3,), dtype=torch.int8), sc,
                                 torch.zeros(()), h, S, rows=W)
    with pytest.raises(ValueError, match="rows into a ring"):
        inplace.ring_store_plain(kv, torch.zeros((S + 1, 3),
                                                 dtype=torch.int8),
                                 sc, torch.zeros((S + 1,)), h, S, rows=S + 1)
