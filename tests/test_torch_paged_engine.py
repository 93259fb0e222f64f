"""The port's paged serving engine on the CPU: ``ServingEngine(use_paged=
True)`` against the JAX engine on the tiny model, the page allocator, and
the prefix cache as tests/test_prefix_cache.py holds it."""

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
from fp8tpu_torch.serve import (EngineServer, PagedKVCache, Request,
                                ServeConfig, ServingEngine, full_logits,
                                serve_params_from_jax)

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, max_seq_len=96)
PSZ = 8                                  # page size: multi-page prompts
SYS = list(range(1, 1 + 2 * PSZ))        # 2 full pages of system prompt


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = j_tiny_config(**TINY), tiny_config(**TINY)
    v = JDecoder(jcfg).init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))
    jp = j_convert(v, jcfg)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp, ServeConfig(model=tcfg)


def engine(setup, prefix_cache=False, n_slots=2, n_pages=None, max_seq=96,
           impl=None, **kw):
    _, _, tcfg, tp, scfg = setup
    if impl is not None:
        scfg = ServeConfig(model=tcfg, paged_decode_impl=impl)
    kw.setdefault("chunk_size", 8)
    return ServingEngine(tp, scfg, n_slots=n_slots, max_seq=max_seq,
                         use_paged=True, page_size=PSZ, n_pages=n_pages,
                         prefix_cache=prefix_cache, device="cpu", **kw)


def reqs(n=3, new=6):
    return [Request(uid=i, prompt=SYS + [40 + i, 41 + i], max_new_tokens=new)
            for i in range(n)]


def drain(eng):
    while any(s is not None for s in eng.slots) or eng.queue \
            or eng._inflight:
        eng.step()


# -- the pool behind the engine ---------------------------------------------------

def test_paged_engine_matches_ring_engine_and_reclaims_pages(setup):
    _, _, _, tp, scfg = setup
    ring_out = ServingEngine(tp, scfg, n_slots=2, max_seq=64,
                             device="cpu").run(
        [Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6)])
    eng = engine(setup, n_pages=24, max_seq=64, chunk_size=32)
    assert isinstance(eng.cache, PagedKVCache) and eng.use_paged
    out = eng.run([Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6),
                   Request(uid=1, prompt=[9, 8, 7, 6], max_new_tokens=5)])
    assert out[0] == ring_out[0] and len(out[1]) == 5
    # all pages returned to the free pool after retirement
    assert sorted(eng.free_pages) == list(range(24))
    assert (eng._table == -1).all()
    assert len(eng.finished_logprobs[1]) == 4


def test_submit_guard_rejects_what_can_never_admit(setup):
    eng = engine(setup, n_pages=3, max_seq=64)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(uid=0, prompt=[1] * 30, max_new_tokens=30))
    eng.submit(Request(uid=1, prompt=[1] * 10, max_new_tokens=8))   # 3 pages
    assert len(eng.run()[1]) == 8


def test_request_waits_for_pages_then_runs(setup):
    """Two requests of 3 pages each on a pool of 4: the second stays queued
    (FIFO) until the first retires, and both match their solo runs."""
    want = {i: engine(setup, n_slots=1).run(
        [Request(uid=i, prompt=SYS + [50 + i], max_new_tokens=4)])[i]
        for i in range(2)}
    eng = engine(setup, n_pages=4)
    for i in range(2):
        eng.submit(Request(uid=i, prompt=SYS + [50 + i], max_new_tokens=4))
    eng._admit()
    assert sum(s is not None for s in eng.slots) == 1 and len(eng.queue) == 1
    assert len(eng.free_pages) == 1
    assert eng.run() == want


@pytest.mark.parametrize("impl", ["ringview", "kernel", "side"])
def test_paged_engine_tokens_match_jax_engine(setup, impl):
    """Token lists against the JAX paged engine's, by the margin rule: where
    they part, the top-2 margin of the port's teacher-forced logits at that
    step lies inside the logit tolerance (4e-2 of max|logit|)."""
    jcfg, jp, tcfg, tp, scfg = setup
    prompts = {i: SYS[:3 + 5 * i] + [40 + i] for i in range(4)}
    jeng = JServingEngine(
        jp, JServeConfig(model=jcfg, paged_decode_impl=impl), n_slots=2,
        max_seq=64, chunk_size=4, use_paged=True, page_size=PSZ)
    jout = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=6)
                     for i, p in prompts.items()])
    teng = engine(setup, max_seq=64, chunk_size=4, impl=impl)
    tout = teng.run([Request(uid=i, prompt=list(p), max_new_tokens=6)
                     for i, p in prompts.items()])
    assert set(tout) == set(jout)
    assert sorted(teng.free_pages) == sorted(jeng.free_pages)
    exact = 0
    for uid, want in jout.items():
        got = tout[uid]
        assert len(got) == len(want) == 6
        if got == want:
            exact += 1
            continue
        j = next(i for i in range(6) if got[i] != want[i])
        seq = torch.tensor(prompts[uid] + want[:j], dtype=torch.int32)
        logits = full_logits(tp, seq, scfg)[-1]
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) <= 2 * 4e-2 * float(logits.abs().max())
    assert exact >= 1


def test_pipeline_depths_agree_and_table_uploads_are_fresh(setup):
    """The depth changes the reconciliation lag, never the stream; every
    upload of the host table is a new device tensor, so a chunk already
    dispatched keeps the table it was given."""
    many = lambda: [Request(uid=i, prompt=[1 + i, 2 + i], max_new_tokens=7)
                    for i in range(4)]
    want = engine(setup, chunk_size=4, depth=2).run(many())
    for depth in (0, 3):
        assert engine(setup, chunk_size=4, depth=depth).run(many()) == want
    eng = engine(setup)
    eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=3))
    before = eng.cache.page_table
    eng._admit()
    assert eng.cache.page_table is not before and (before == -1).all()
    assert eng.cache.page_table.dtype == torch.int32
    np.testing.assert_array_equal(eng.cache.page_table.numpy(), eng._table)
    drain(eng)


def test_paged_engine_behind_the_server_and_sampling(setup):
    eng = engine(setup, prefix_cache=True, seed=3)
    srv = EngineServer(eng).start()
    futs = {r.uid: srv.submit(r) for r in reqs(3)}
    futs[9] = srv.submit(Request(uid=9, prompt=SYS + [3], max_new_tokens=5,
                                 temperature=0.9, top_k=5))
    out = {uid: f.result(timeout=300) for uid, f in futs.items()}
    srv.stop()
    ref = engine(setup).run(reqs(3))
    assert {k: out[k] for k in ref} == ref and len(out[9]) == 5
    assert all(0 <= t < 128 for t in out[9])


# -- the prefix cache ---------------------------------------------------------------

def test_outputs_identical_with_and_without_cache(setup):
    assert engine(setup, prefix_cache=True).run(reqs()) \
        == engine(setup, prefix_cache=False).run(reqs())


def test_pages_are_physically_shared(setup):
    eng = engine(setup, prefix_cache=True, n_slots=1)
    eng.submit(Request(uid=0, prompt=SYS + [40], max_new_tokens=4))
    eng._admit()
    first_pages = list(eng._slot_pages[0][:2])
    assert len(first_pages) == 2
    drain(eng)
    assert len(eng._prefix_index) == 2       # both full pages registered
    eng.submit(Request(uid=1, prompt=SYS + [77], max_new_tokens=4))
    eng._admit()
    # the second request's first two table entries ARE the cached pages
    assert list(eng._slot_pages[0][:2]) == first_pages
    assert (eng._page_ref[first_pages] == 1).all()
    assert eng.page_stats == {"allocated": 3 + 1, "shared": 2, "max_ref": 1}
    drain(eng)
    assert 1 in eng.finished


def test_shared_pages_bytes_unchanged_by_a_second_admission(setup):
    """Two admissions with the same prefix: the second maps the first's
    pages, holds them together with it, and leaves their bytes untouched
    (its prefill writes only from write_starts on)."""
    eng = engine(setup, prefix_cache=True, n_slots=2)
    eng.submit(Request(uid=0, prompt=SYS + [40], max_new_tokens=30))
    eng._admit()
    shared = list(eng._slot_pages[0][:2])
    pool8 = eng.cache.pool.view(torch.uint8)
    before = (pool8[shared].clone(), eng.cache.sc[shared].clone())
    assert bool((before[1] != 1).all())              # the prefix is written
    eng.submit(Request(uid=1, prompt=SYS + [77, 78], max_new_tokens=4))
    eng._admit()
    assert list(eng._slot_pages[1][:2]) == shared
    assert (eng._page_ref[shared] == 2).all()
    assert eng.page_stats["max_ref"] == 2
    own = eng._slot_pages[1][2]
    assert bool((eng.cache.sc[own, :, :, :2 * 2] != 1).all())   # its 2 tokens
    assert torch.equal(pool8[shared], before[0])
    assert torch.equal(eng.cache.sc[shared], before[1])
    out = eng.run()
    # decode never writes a shared page either (generation starts past it)
    assert torch.equal(pool8[shared], before[0])
    assert len(out[0]) == 30 and len(out[1]) == 4
    assert int(eng._page_ref.sum()) == 0


def test_capacity_win_under_page_pressure(setup):
    """A pool sized so two requests only fit concurrently when the 2-page
    prefix is shared (3 pages each: private needs 6, shared 2 + 1 + 1)."""
    two = lambda base=0: [Request(uid=base + i, prompt=SYS + [50 + i],
                                  max_new_tokens=4) for i in range(2)]
    ref = engine(setup, n_pages=6).run(two())
    eng = engine(setup, prefix_cache=True, n_pages=5)
    for r in two():
        eng.submit(r)
    eng._admit()
    # cold cache: only the first admits (nothing is registered yet)
    assert sum(s is not None for s in eng.slots) == 1
    assert eng.run() == ref
    # warm cache: now BOTH admit in one shot within 5 pages
    for r in two(10):
        eng.submit(r)
    eng._admit()
    assert sum(s is not None for s in eng.slots) == 2
    out2 = eng.run()
    assert [out2[10], out2[11]] == [ref[0], ref[1]]


def test_eviction_frees_cold_pages_not_held_ones(setup):
    # a pool of exactly one request's worth: B admits only by evicting A's
    # cold cached pages
    eng = engine(setup, prefix_cache=True, n_slots=1, n_pages=3)
    eng.run([Request(uid=0, prompt=SYS + [3], max_new_tokens=4)])
    assert len(eng._prefix_index) == 2 and len(eng.free_pages) == 1
    b = list(range(60, 60 + 2 * PSZ))
    out_b = eng.run([Request(uid=1, prompt=b + [3], max_new_tokens=4)])
    assert len(out_b[1]) == 4              # B completed despite eviction
    assert all(k[0] == 60 for k in eng._prefix_index)   # A evicted, B cached
    # a failed allocation evicts nothing: 3 cached-or-free pages, 4 wanted
    assert eng._alloc_pages(4) is None and len(eng._prefix_index) == 2


def test_active_holder_blocks_eviction(setup):
    eng = engine(setup, prefix_cache=True, n_slots=2, n_pages=6)
    eng.submit(Request(uid=0, prompt=SYS + [3], max_new_tokens=8))
    eng._admit()
    held = list(eng._slot_pages[0][:2])
    assert (eng._page_ref[held] == 1).all()
    eng.submit(Request(uid=1, prompt=list(range(60, 60 + 2 * PSZ)) + [3],
                       max_new_tokens=8))
    eng._admit()
    assert eng.slots[1] is None and len(eng.queue) == 1   # 4 pages, 2 free
    assert set(eng.run()) == {0, 1}       # admitted once the holder retired
    assert not set(held) - set(eng._page_prefix) - set(eng.free_pages)


# -- what waits -----------------------------------------------------------------------

def test_unported_paged_modes_raise_and_ring_ignores_the_flag(setup):
    """Compute-level prefix reuse and batched speculation are ported: the
    paged engine takes both options (tests/test_torch_spec_engine.py holds
    their outputs); the ring engine ignores the prefix cache."""
    _, _, _, tp, scfg = setup
    eng = ServingEngine(tp, scfg, use_paged=True, prefix_cache=True,
                        prefix_compute_reuse=True, device="cpu")
    assert eng.prefix_reuse and eng.spec is False
    eng = ServingEngine(tp, scfg, use_paged=True, draft_params=tp,
                        draft_cfg=scfg, device="cpu")
    assert eng.spec and eng.dcache.n_slots == eng.n_slots
    eng = ServingEngine(tp, scfg, n_slots=2, max_seq=96, use_paged=False,
                        prefix_cache=True, device="cpu")
    assert eng.prefix_cache is False
    assert set(eng.run([Request(uid=0, prompt=[1, 2, 3],
                                max_new_tokens=4)])) == {0}
