"""Port parity for MoE serving (tests/test_serve_moe.py on the port's side):
the MoE artifact, the serving-form expert FFN and every decode path of
fp8tpu_torch.serve against fp8tpu.serve on a tiny 4-expert top-2 decoder,
from the same Flax variables.

References and tolerances are the serving tests'
(tests/test_torch_serve_model.py): the un-jitted JAX functions at
EAGER_TOL = 4e-3 of max|logit| (only summation order and 1-ulp
transcendental differences remain), the jitted ones at JIT_TOL = 4e-2
(XLA elides bf16 roundings the source writes), artifacts byte for byte,
greedy tokens by the margin rule.  The expert FFN alone is held to the
same two tolerances relative to its max|output|.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.models import Decoder as JDecoder
from fp8tpu.models.transformer import tiny_config as j_tiny_config
from fp8tpu.serve import Request as JRequest
from fp8tpu.serve import RingKVCache as JRing
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import ServingEngine as JServingEngine
from fp8tpu.serve import convert_decoder_params as j_convert
from fp8tpu.serve import model as jmodel
from fp8tpu_torch.models import Decoder, tiny_config, variables_from_flax
from fp8tpu_torch.serve import (PagedKVCache, Request, RingKVCache,
                                ServeConfig, ServingEngine,
                                convert_decoder_params, decode_step,
                                decode_steps, decode_steps_paged,
                                full_logits, prefill, random_serve_params,
                                serve_params_from_jax)
from fp8tpu_torch.serve import model as tmodel

MOE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab_size=128, max_seq_len=64, n_experts=4, moe_top_k=2,
           moe_capacity_factor=4.0)
S = 32
JIT_TOL, EAGER_TOL = 4e-2, 4e-3
PROMPT = [3, 14, 15, 92, 65, 35]


def raw(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, tcfg = j_tiny_config(**MOE), tiny_config(**MOE)
    v = JDecoder(jcfg).init(jax.random.key(0), jnp.arange(16)[None] % 128)
    v = jax.tree.map(np.asarray, v)
    tm = Decoder(tcfg)
    tm.load_state_dict(variables_from_flax(v))
    return jcfg, tcfg, v, tm


@functools.lru_cache(maxsize=None)
def _artifact(fmt):
    jcfg, _, v, _ = _models()
    jp = j_convert(v, jcfg, fmt=fmt, int4_group=32)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _cfgs(fmt, kv_fmt, **kw):
    jcfg, tcfg, _, _ = _models()
    kw = dict(weight_fmt=fmt, kv_fmt=kv_fmt, **kw)
    return JServeConfig(model=jcfg, **kw), ServeConfig(model=tcfg, **kw)


# -- the artifact: byte for byte -------------------------------------------------

@pytest.mark.parametrize("fmt", ["e4m3", "int8", "int4", "bf16"])
def test_moe_artifact_bit_equal_and_carried_from_jax(fmt):
    jcfg, tcfg, _, tm = _models()
    L, E, Dm, F = 2, 4, 64, 128
    jp, tp_jax = _artifact(fmt)
    tp = convert_decoder_params(tm.state_dict(), tcfg, fmt=fmt, int4_group=32)
    assert "gate8" not in tp and set(tp) == set(jp) == set(tp_jax)
    assert tp["router"].dtype == torch.bfloat16
    assert tuple(tp["router"].shape) == (L, Dm, E)
    payload = {"e4m3": torch.float8_e4m3fn, "int8": torch.int8,
               "int4": torch.uint8, "bf16": torch.bfloat16}[fmt]
    k2 = 2 if fmt == "int4" else 1
    assert tp["eup8"].dtype == tp_jax["edown8"].dtype == payload
    assert tuple(tp["eup8"].shape) == (L, E, Dm // k2, F)
    assert tuple(tp["edown8"].shape) == (L, E, F // k2, Dm)
    if fmt == "int4":        # grouped scales, one per 32 rows of K
        assert tuple(tp["eups"].shape) == (L, E, Dm // 32, F)
        assert tuple(tp["edowns"].shape) == (L, E, F // 32, Dm)
    else:
        assert tuple(tp["eups"].shape) == (L, E, F)
        assert tuple(tp["edowns"].shape) == (L, E, Dm)
    for k, want in jp.items():
        for got in (tp[k], tp_jax[k]):
            assert tuple(got.shape) == want.shape, k
            np.testing.assert_array_equal(raw(got), raw(want), err_msg=k)


def test_random_moe_params_give_each_expert_its_own_draw():
    cfg = tiny_config(**MOE)
    jp, _ = _artifact("e4m3")
    for fmt in ("e4m3", "int8", "int4"):
        p = random_serve_params(cfg, fmt, seed=2, device="cpu")
        assert "gate8" not in p
        if fmt == "e4m3":
            assert {k: tuple(v.shape) for k, v in p.items()} \
                == {k: v.shape for k, v in jp.items()}
        up = raw(p["eup8"]).reshape(2, 4, -1)
        assert p["eup8"].is_contiguous() and p["eup8"].stride(1) > 0
        assert all(not np.array_equal(up[0, 0], up[0, e]) for e in (1, 2, 3))
    q = random_serve_params(cfg, "e4m3", seed=2, device="cpu")
    r = random_serve_params(cfg, "e4m3", seed=2, device="cpu")
    assert all(np.array_equal(raw(q[k]), raw(r[k])) for k in q)


# -- the expert FFN -----------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["e4m3", "int4", "bf16"])
def test_moe_ffn_matches_jax(rng, fmt):
    jp, tp = _artifact(fmt)
    jsc, tsc = _cfgs(fmt, "int8")
    x = jnp.asarray(rng.standard_normal((2, 5, 64)), jnp.bfloat16)
    tx = tmodel._tensor_from_array(np.asarray(x), "cpu")
    jxs = {k: jp[k][1] for k in jmodel._MOE_KEYS}
    txs = tmodel._layer_xs(tp, 1)
    assert set(txs) == set(tmodel._ATTN_KEYS) | set(jxs)
    got = tmodel._moe_ffn(tx, txs, tsc.model, tmodel._make_linear(tsc))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 5, 64)
    got = got.float().numpy()
    linear = jmodel._make_linear(jsc)
    with jax.disable_jit():
        eager = np.asarray(jmodel._moe_ffn(x, jxs, jsc.model, linear),
                           np.float32)
    jitted = np.asarray(jax.jit(lambda a, xs: jmodel._moe_ffn(
        a, xs, jsc.model, linear))(x, jxs), np.float32)
    for want, tol in ((eager, EAGER_TOL), (jitted, JIT_TOL)):
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_zero_router_picks_experts_0_and_1(rng):
    """A uniform router row picks the two lowest experts, each gated 1/E,
    as jax.lax.top_k does."""
    jp, tp = _artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "int8")
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    txs = dict(tmodel._layer_xs(tp, 0), router=torch.zeros(64, 4,
                                                            dtype=torch.bfloat16))
    linear = tmodel._make_linear(tsc)
    got = tmodel._moe_ffn(x, txs, tsc.model, linear).float()
    want = 0
    for e in (0, 1):
        h = linear(x, txs["eup8"][e], txs["eups"][e]).float()
        h = torch.nn.functional.gelu(h, approximate="tanh").to(torch.bfloat16)
        want = want + 0.25 * linear(h, txs["edown8"][e],
                                    txs["edowns"][e]).float()
    assert torch.equal(got, want.to(torch.bfloat16).float())
    jxs = {k: jp[k][0] for k in jmodel._MOE_KEYS}
    jxs["router"] = jnp.zeros((64, 4), jnp.bfloat16)
    with jax.disable_jit():
        jy = np.asarray(jmodel._moe_ffn(jnp.asarray(x.float().numpy(),
                                                    jnp.bfloat16), jxs,
                                        jsc.model,
                                        jmodel._make_linear(jsc)), np.float32)
    assert np.abs(got.numpy() - jy).max() <= EAGER_TOL * np.abs(jy).max()


# -- decode paths -------------------------------------------------------------------

def _ring_run(fmt, kv_fmt, n_steps):
    """Prefill slot 0 with PROMPT, then ``n_steps`` decode steps of two
    slots, both sides fed JAX's greedy tokens; per-call logit pairs and
    both rings."""
    jp, tp = _artifact(fmt)
    jsc, tsc = _cfgs(fmt, kv_fmt)
    jr = JRing.create(2, 2, S, 2, 16, kv_fmt)
    tr = RingKVCache.create(2, 2, S, 2, 16, kv_fmt, device="cpu")
    prompt = np.array(PROMPT + [0] * (S - len(PROMPT)), np.int32)
    jl, jr = jmodel.prefill(jp, jr, jnp.asarray(prompt), jnp.int32(0),
                            jnp.int32(len(PROMPT)), jsc)
    tl, tr = prefill(tp, tr, torch.from_numpy(prompt), 0, len(PROMPT), tsc)
    pairs = [(np.asarray(jl), tl.numpy())]
    tok = np.array([int(np.argmax(pairs[0][0])), 7], np.int32)
    pos = np.array([len(PROMPT), 0], np.int32)
    for _ in range(n_steps):
        jl, jr = jmodel.decode_step(jp, jr, jnp.asarray(tok),
                                    jnp.asarray(pos), jsc)
        tl, tr = decode_step(tp, tr, torch.from_numpy(tok),
                             torch.from_numpy(pos), tsc)
        pairs.append((np.asarray(jl), tl.numpy()))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    return pairs, jr, tr


@pytest.mark.parametrize("fmt,kv_fmt,jit", [("e4m3", "int8", False),
                                            ("int4", "e4m3", True)],
                         ids=["e4m3-unjitted", "int4-jitted"])
def test_moe_prefill_and_ring_decode_match_jax(fmt, kv_fmt, jit):
    if jit:
        pairs, jr, tr = _ring_run(fmt, kv_fmt, 3)
    else:
        with jax.disable_jit():
            pairs, jr, tr = _ring_run(fmt, kv_fmt, 3)
    tol, min_equal = (JIT_TOL, 0.85) if jit else (EAGER_TOL, 0.99)
    for step, (want, got) in enumerate(pairs):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), step
    assert int(tr.head) == int(jr.head) == 3
    assert (raw(tr.kv8) == raw(jr.kv8)).mean() >= min_equal
    np.testing.assert_allclose(np.asarray(tr.sc), np.asarray(jr.sc),
                               rtol=3 * 2.0 ** -7, atol=0)


def test_moe_full_logits_match_jax_unjitted():
    jp, tp = _artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "int8")
    seq = np.array(PROMPT + [89, 79], np.int32)
    with jax.disable_jit():
        want = np.asarray(jmodel.full_logits(jp, jnp.asarray(seq), jsc))
    got = full_logits(tp, torch.from_numpy(seq), tsc).numpy()
    assert got.shape == want.shape == (8, 128)
    assert np.abs(got - want).max() <= EAGER_TOL * np.abs(want).max()


def _paged_tokens(impl, n=8):
    _, tp = _artifact("e4m3")
    _, tsc = _cfgs("e4m3", "e4m3", paged_decode_impl=impl)
    pc = PagedKVCache.create(16, 8, 2, 2, 8, 2, 16, "e4m3", device="cpu")
    for b in range(2):
        pc = pc.assign_pages(b, np.arange(8), np.arange(8) + b * 8)
    toks, _ = decode_steps_paged(tp, pc, torch.tensor([3, 4], dtype=torch.int32),
                                 torch.zeros(2, dtype=torch.int32), None,
                                 torch.zeros(2), n, tsc, greedy_only=True)
    return toks


@pytest.mark.parametrize("impl", tmodel.PAGED_DECODE_IMPLS)
def test_moe_paged_decode_matches_ring(impl):
    """Every paged mode gives the ring's greedy tokens while the context
    fits both (tests/test_serve_moe.py::test_moe_paged_decode_matches_ring),
    and the jitted JAX ring's by the margin rule."""
    jp, tp = _artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "e4m3")
    tok, pos = np.array([3, 4], np.int32), np.zeros(2, np.int32)
    ring = RingKVCache.create(2, 2, 32, 2, 16, "e4m3", device="cpu")
    t_ring, _ = decode_steps(tp, ring, torch.from_numpy(tok),
                             torch.from_numpy(pos), None, torch.zeros(2), 8,
                             tsc, greedy_only=True)
    assert torch.equal(_paged_tokens(impl), t_ring)
    if impl == "ringview":
        j_ring, _ = jmodel.decode_steps(
            jp, JRing.create(2, 2, 32, 2, 16, "e4m3"), jnp.asarray(tok),
            jnp.asarray(pos), jax.random.key(0), jnp.zeros(2), 8, jsc,
            greedy_only=True)
        _margin_agree({b: t_ring[b].tolist() for b in range(2)},
                      {b: np.asarray(j_ring)[b].tolist() for b in range(2)},
                      {b: [int(tok[b])] for b in range(2)}, tp, tsc)


# -- the engines ---------------------------------------------------------------------

def _margin_agree(out, ref, prompts, tp, tsc, tol=JIT_TOL):
    """Equal token lists, or lists that part at a near tie of the port's
    teacher-forced logits."""
    assert set(out) == set(ref)
    exact = 0
    for uid, want in ref.items():
        got = out[uid]
        assert len(got) == len(want)
        if got == want:
            exact += 1
            continue
        j = next(i for i in range(len(got)) if got[i] != want[i])
        logits = full_logits(tp, torch.tensor(prompts[uid] + want[:j],
                                              dtype=torch.int32), tsc)[-1]
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) <= 2 * tol * float(logits.abs().max())
    return exact


def test_moe_engine_matches_the_jax_engine():
    jp, tp = _artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "int8")
    prompts = {i: [1 + i, 2 + i, 3 + i] for i in range(3)}
    jout = JServingEngine(jp, jsc, n_slots=2, max_seq=64).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=5)
         for i, p in prompts.items()])
    out = ServingEngine(tp, tsc, n_slots=2, max_seq=64, device="cpu").run(
        [Request(uid=i, prompt=p, max_new_tokens=5)
         for i, p in prompts.items()])
    assert all(len(v) == 5 for v in out.values())
    assert _margin_agree(out, jout, prompts, tp, tsc) >= 1
    paged = ServingEngine(tp, tsc, n_slots=2, max_seq=64, use_paged=True,
                          page_size=8, device="cpu").run(
        [Request(uid=i, prompt=p, max_new_tokens=5)
         for i, p in prompts.items()])
    _margin_agree(paged, out, prompts, tp, tsc)


def test_moe_target_speculation_matches_plain():
    """Speculation through the MoE FFN branch
    (tests/test_spec_engine.py::test_moe_target_speculation_matches_plain):
    the verify pass, the catch-up and the draft all reach the FFN through
    the shared block."""
    jp, tp = _artifact("e4m3")
    _, tsc = _cfgs("e4m3", "e4m3")
    dcfg = tiny_config(**{**MOE, "n_experts": 0, "n_heads": 2})
    dp = random_serve_params(dcfg, "e4m3", seed=3, device="cpu")
    prompts = {i: [2 + i, 7, 11, 5 + i] for i in range(2)}
    reqs = lambda: [Request(uid=i, prompt=p, max_new_tokens=8)
                    for i, p in prompts.items()]
    kw = dict(n_slots=2, max_seq=64, use_paged=True, page_size=8,
              device="cpu")
    ref = ServingEngine(tp, tsc, **kw).run(reqs())
    out = ServingEngine(tp, tsc, draft_params=dp,
                        draft_cfg=ServeConfig(model=dcfg), k_spec=3,
                        **kw).run(reqs())
    _margin_agree(out, ref, prompts, tp, tsc)
    self_draft = ServingEngine(tp, tsc, draft_params=tp, draft_cfg=tsc,
                               k_spec=3, **kw).run(reqs())
    _margin_agree(self_draft, ref, prompts, tp, tsc)
    # speculation keeps refusing batched ring writes, as the JAX package does
    with pytest.raises(ValueError, match="ring_flush"):
        from fp8tpu_torch.serve import speculative_decode
        speculative_decode(tp, tp, [1, 2], 4, dataclasses.replace(
            tsc, ring_flush=4), tsc, k_spec=2)
