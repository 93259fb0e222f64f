"""Batched speculation and scored-suffix admission in the port's paged
engine on the CPU: ``ServingEngine(draft_params=..., prefix_compute_reuse=
True)`` against the port's plain paged engine and the JAX engine
(tests/test_spec_engine.py and the compute-reuse half of
tests/test_prefix_cache.py on the port's side).

Greedy speculation must give the plain engine's tokens: the verify pass
and the decode chunk differ only in summation order, so where two token
lists part, the step must be a near tie of the port's own teacher-forced
logits (the margin rule).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.models import Decoder as JDecoder
from fp8tpu.models.transformer import tiny_config as j_tiny_config
from fp8tpu.serve import Request as JRequest
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import ServingEngine as JServingEngine
from fp8tpu.serve import convert_decoder_params as j_convert
from fp8tpu_torch.models import tiny_config
from fp8tpu_torch.serve import (EngineServer, Request, ServeConfig,
                                ServingEngine, full_logits,
                                serve_params_from_jax)

TARGET = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=256, max_seq_len=96)
DRAFT = dict(TARGET, n_heads=2)
JIT_TOL = 4e-2        # of max|logit|: bf16 steps of another summation order
PSZ = 8
SYS = list(range(1, 1 + 2 * PSZ))        # 2 full pages of system prompt


@functools.lru_cache(maxsize=None)
def model(which="target"):
    kw = TARGET if which == "target" else DRAFT
    jcfg = j_tiny_config(**kw)
    v = JDecoder(jcfg).init(jax.random.key(0 if which == "target" else 1),
                            jnp.ones((1, 8), jnp.int32))
    jp = j_convert(v, jcfg)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, JServeConfig(model=jcfg), tp, ServeConfig(model=tiny_config(
        **kw))


def plain_engine(**kw):
    _, _, tp, tsc = model()
    kw.setdefault("n_slots", 2)
    return ServingEngine(tp, tsc, max_seq=96, chunk_size=8, use_paged=True,
                         page_size=PSZ, device="cpu", **kw)


def spec_engine(self_draft=False, k=4, rpd=1, **kw):
    _, _, dp, dsc = model("target" if self_draft else "draft")
    return plain_engine(draft_params=dp, draft_cfg=dsc, k_spec=k,
                        spec_rounds_per_dispatch=rpd, **kw)


def reqs(n=3, new=10, **kw):
    return [Request(uid=i, prompt=[2 + i, 7, 11, 5 + i], max_new_tokens=new,
                    **kw) for i in range(n)]


def agree(out, ref, requests, tol=JIT_TOL):
    """Same uids and lengths, and each pair of token lists equal or parted
    at a near tie of the port's teacher-forced logits."""
    _, _, tp, tsc = model()
    prompts = {r.uid: r.prompt for r in requests}
    assert set(out) == set(ref)
    for uid, want in ref.items():
        got = out[uid]
        assert len(got) == len(want)
        if got == want:
            continue
        j = next(i for i in range(len(got)) if got[i] != want[i])
        logits = full_logits(tp, torch.tensor(prompts[uid] + want[:j],
                                              dtype=torch.int32), tsc)[-1]
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) <= 2 * tol * float(
            logits.abs().max()), (uid, j)
    return sum(out[u] == ref[u] for u in ref)


@pytest.mark.parametrize("rpd", [1, 2, 3])
def test_greedy_spec_engine_matches_plain_engine(rpd):
    ref = plain_engine().run(reqs())
    eng = spec_engine(rpd=rpd)
    out = eng.run(reqs())
    assert agree(out, ref, reqs()) >= 2
    assert eng.spec_rounds > 0 and eng.spec_rounds % rpd == 0
    assert eng.spec_drafted > 0 and eng.spec_drafted % 4 == 0
    assert 0 <= eng.spec_accepted <= eng.spec_drafted


def test_greedy_spec_engine_matches_jax_spec_engine():
    jp, jsc, _, _ = model()
    jdp, jdsc, _, _ = model("draft")
    jout = JServingEngine(jp, jsc, n_slots=2, max_seq=96, chunk_size=8,
                          use_paged=True, page_size=PSZ, draft_params=jdp,
                          draft_cfg=jdsc, k_spec=4).run(
        [JRequest(**vars(r)) for r in reqs()])
    out = spec_engine().run(reqs())
    assert agree(out, jout, reqs()) >= 1


def test_self_draft_engine_full_acceptance():
    """Draft == target: every block verifies, rounds emit K + 1 tokens,
    and the tokens are the plain engine's."""
    ref = plain_engine().run(reqs())
    eng = spec_engine(self_draft=True)
    out = eng.run(reqs())
    agree(out, ref, reqs())
    assert eng.spec_accepted == eng.spec_drafted > 0


@pytest.mark.parametrize("n,new,rpd", [(2, 3, 1), (5, 6, 1), (5, 7, 2)])
def test_budget_and_cycling(n, new, rpd):
    """Budgets that are not a multiple of K + 1 end exactly at the budget;
    more requests than slots cycle through, also with rounds chained."""
    out = spec_engine(rpd=rpd).run(reqs(n=n, new=new))
    assert set(out) == set(range(n)) and all(len(v) == new
                                             for v in out.values())
    agree(out, plain_engine().run(reqs(n=n, new=new)), reqs(n=n, new=new))


@pytest.mark.parametrize("rpd,new", [(1, 80), (2, 60)])
def test_long_budget_to_the_window_edge(rpd, new):
    """A budget close to the window: the R * (K + 1) reserve comes out of
    the prompt trim, so the spec engine emits the plain engine's tokens
    all the way; a budget past the reserve is refused at submit."""
    rs = [Request(uid=0, prompt=[2, 7, 11, 5], max_new_tokens=new)]
    ref = plain_engine().run([Request(**vars(r)) for r in rs])
    eng = spec_engine(rpd=rpd)
    out = eng.run([Request(**vars(r)) for r in rs])
    assert len(ref[0]) == new
    agree(out, ref, rs)
    with pytest.raises(ValueError, match="verify reserve"):
        eng.submit(Request(uid=1, prompt=[1], max_new_tokens=96 - 2))


def test_topk1_and_tiny_topp_spec_equal_greedy():
    """top_k = 1 (or top_p below the argmax's probability) at temperature
    > 0 keeps only the argmax in both laws: the filtered spec engine gives
    the greedy plain engine's tokens."""
    ref = plain_engine().run(reqs(n=2, new=8))
    out = spec_engine().run(reqs(n=2, new=8, temperature=0.9, top_k=1))
    agree(out, ref, reqs(n=2, new=8))
    out = spec_engine().run(reqs(n=2, new=8, temperature=0.7, top_p=1e-6))
    agree(out, ref, reqs(n=2, new=8))


def test_sampling_runs_behind_the_server():
    eng = spec_engine(seed=3)
    srv = EngineServer(eng).start()
    try:
        futs = [srv.submit(r) for r in reqs(n=3, new=8, temperature=0.8,
                                             top_k=5)]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()
    assert all(len(o) == 8 and all(0 <= t < 256 for t in o) for o in outs)
    assert eng.spec_rounds > 0


def _reuse_reqs(n=3, new=6):
    return [Request(uid=i, prompt=SYS + [40 + i, 41 + i], max_new_tokens=new)
            for i in range(n)]


def test_prefix_compute_reuse_outputs_equal_no_reuse():
    """Scored-suffix admission (the suffix starts on a page boundary)
    against the dense prefill with shared pages: the same tokens, by the
    margin rule, with the two system pages skipped for later requests."""
    ref = plain_engine(prefix_cache=True).run(_reuse_reqs())
    eng = plain_engine(prefix_cache=True, prefix_compute_reuse=True)
    out = eng.run(_reuse_reqs())
    agree(out, ref, _reuse_reqs())
    assert eng.prefix_reuse and eng.prefix_tokens_reused == 2 * PSZ


def test_compute_reuse_warm_equals_cold_and_counts():
    """A request admitted against cached prefix pages gives exactly the
    tokens it gives admitted cold (the cached bytes are what its own
    scoring would have written); the counter accumulates."""
    req = Request(uid=7, prompt=SYS + [40, 41], max_new_tokens=6)
    cold = plain_engine(prefix_cache=True, prefix_compute_reuse=True)
    out_cold = cold.run([Request(**vars(req))])
    assert cold.prefix_tokens_reused == 0
    warm = plain_engine(prefix_cache=True, prefix_compute_reuse=True)
    warm.run([Request(uid=0, prompt=SYS + [90], max_new_tokens=4)])
    out_warm = warm.run([Request(**vars(req))])
    assert warm.prefix_tokens_reused == 2 * PSZ
    assert out_warm[7] == out_cold[7]
    # a prompt of exactly two pages gives its last page back: one to score
    warm.run([Request(uid=8, prompt=SYS, max_new_tokens=4)])
    assert warm.prefix_tokens_reused == 3 * PSZ


def test_spec_with_compute_reuse_and_jax_reuse_engine():
    """Speculation over scored admissions, against the JAX engine with the
    same options."""
    jp, jsc, _, _ = model()
    jdp, jdsc, _, _ = model("draft")
    kw = dict(n_slots=2, max_seq=96, chunk_size=8, use_paged=True,
              page_size=PSZ, prefix_cache=True, prefix_compute_reuse=True)
    jout = JServingEngine(jp, jsc, draft_params=jdp, draft_cfg=jdsc,
                          k_spec=4, **kw).run(
        [JRequest(**vars(r)) for r in _reuse_reqs()])
    eng = spec_engine(prefix_cache=True, prefix_compute_reuse=True)
    out = eng.run(_reuse_reqs())
    agree(out, jout, _reuse_reqs())
    assert eng.prefix_tokens_reused == 2 * PSZ and eng.spec_rounds > 0


def test_draft_needs_its_config_and_ring_ignores_the_draft():
    _, _, tp, tsc = model()
    with pytest.raises(ValueError, match="draft_cfg"):
        plain_engine(draft_params=tp)
    ring = ServingEngine(tp, tsc, n_slots=2, max_seq=96, draft_params=tp,
                         device="cpu")
    assert ring.spec is False
    assert set(ring.run(reqs(n=1, new=4))) == {0}
