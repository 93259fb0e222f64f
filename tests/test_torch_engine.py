"""The port's serving engine and threaded server on the CPU: the
scheduler properties of tests/test_serve.py and tests/test_engine_server.py
on the tiny model, and its token lists against the JAX engine's."""

import dataclasses
import functools
import threading

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
                                random_serve_params, serve_params_from_jax)

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, max_seq_len=64)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = j_tiny_config(**TINY), tiny_config(**TINY)
    v = JDecoder(jcfg).init(jax.random.key(0), jnp.arange(16)[None] % 128)
    jp = j_convert(v, jcfg)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp, ServeConfig(model=tcfg)


def engine(**kw):
    _, _, _, tp, scfg = _setup()
    kw.setdefault("n_slots", 2)
    return ServingEngine(tp, scfg, max_seq=64, device="cpu", **kw)


def test_engine_continuous_batching():
    reqs = [Request(uid=i, prompt=[1 + i, 2 + i, 3 + i], max_new_tokens=5)
            for i in range(5)]                 # more requests than slots
    eng = engine()
    out = eng.run(reqs)
    assert set(out) == {0, 1, 2, 3, 4}
    assert all(len(v) == 5 for v in out.values())
    assert all(0 <= t < 128 for v in out.values() for t in v)
    # per-uid metrics and logprobs (the first token carries none)
    assert set(eng.finished_meta) == set(out)
    assert all(m["n_tokens"] == 5 and m["latency_s"] >= m["ttft_s"] >= 0
               for m in eng.finished_meta.values())
    assert all(len(lp) == 4 and all(x <= 0 for x in lp)
               for lp in eng.finished_logprobs.values())


def test_engine_greedy_deterministic():
    req = lambda: [Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6)]
    assert engine().run(req())[0] == engine().run(req())[0]


def test_engine_batch_isolation():
    """A request's output must not depend on what shares the batch."""
    solo = engine().run([Request(uid=0, prompt=[9, 8, 7], max_new_tokens=4)])
    paired = engine().run(
        [Request(uid=0, prompt=[9, 8, 7], max_new_tokens=4),
         Request(uid=1, prompt=[1, 2, 3, 4, 5], max_new_tokens=4)])
    assert solo[0] == paired[0]


def test_engine_parking_mixed_budgets():
    """Chunks are sized to the LONGEST remaining budget; short requests
    park mid-chunk, return exact budgets, and leave the long one alone."""
    solo = engine().run([Request(uid=0, prompt=[9, 8, 7], max_new_tokens=20)])
    out = engine(chunk_size=16).run(
        [Request(uid=0, prompt=[9, 8, 7], max_new_tokens=20),
         Request(uid=1, prompt=[4, 5], max_new_tokens=2)])
    assert len(out[0]) == 20 and len(out[1]) == 2
    assert out[0] == solo[0]


def test_engine_slot_reuse_after_parking():
    solo = engine(n_slots=1).run(
        [Request(uid=7, prompt=[11, 12, 13], max_new_tokens=6)])
    out = engine(n_slots=1, chunk_size=16).run(
        [Request(uid=0, prompt=[1, 2], max_new_tokens=3),
         Request(uid=7, prompt=[11, 12, 13], max_new_tokens=6)])
    assert out[7] == solo[7] and len(out[0]) == 3


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_engine_pipeline_depths_agree(depth):
    """The depth changes the reconciliation lag, never the stream."""
    reqs = lambda: [Request(uid=i, prompt=[1 + i, 2 + i], max_new_tokens=7)
                    for i in range(4)]
    want = engine(chunk_size=4, depth=2).run(reqs())
    assert engine(chunk_size=4, depth=depth).run(reqs()) == want


def test_engine_batched_admission_matches_serial():
    reqs = [Request(uid=0, prompt=[5, 6, 7], max_new_tokens=4),
            Request(uid=1, prompt=[8, 9], max_new_tokens=4),
            Request(uid=2, prompt=[10, 11, 12, 13], max_new_tokens=4)]
    copy = lambda: [dataclasses.replace(r, prompt=list(r.prompt))
                    for r in reqs]
    assert engine(n_slots=4).run(copy()) == engine(n_slots=1).run(copy())


def test_engine_step_streaming_eos_and_cancel():
    eng = engine()
    ref = engine().run([Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6)])
    # on_token streams every token in order, the first included
    seen = []
    out = engine().run([Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6)],
                       on_token=lambda uid, tok: seen.append((uid, tok)))
    assert [t for _, t in seen] == out[0] == ref[0]
    # EOS retires a request at the token
    eos = ref[0][2]
    cut = engine().run([Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6,
                                eos_id=eos)])
    assert cut[0] == ref[0][:ref[0].index(eos) + 1]
    # step(): admit, one chunk, reconcile
    eng.submit(Request(uid=3, prompt=[5, 6, 7], max_new_tokens=6))
    eng.submit(Request(uid=4, prompt=[1], max_new_tokens=40))
    eng.submit(Request(uid=5, prompt=[2], max_new_tokens=4))
    eng.step()
    assert eng.finished[3] == ref[0]
    assert eng.cancel(5) and eng.finished[5] == []     # still queued
    assert eng.cancel(4) and 1 <= len(eng.finished[4]) < 40
    assert not eng.cancel(99)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(uid=6, prompt=[1], max_new_tokens=10_000))


def test_engine_sampling_requests_run():
    out = engine(seed=3).run(
        [Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6, temperature=1.0,
                 top_k=4),
         Request(uid=1, prompt=[8, 9], max_new_tokens=4, temperature=0.8,
                 top_p=0.9)])
    assert len(out[0]) == 6 and len(out[1]) == 4
    assert all(0 <= t < 128 for v in out.values() for t in v)
    again = engine(seed=3).run(
        [Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6, temperature=1.0,
                 top_k=4),
         Request(uid=1, prompt=[8, 9], max_new_tokens=4, temperature=0.8,
                 top_p=0.9)])
    assert again == out                       # the seed fixes the stream


def test_engine_long_prompt_is_trimmed_to_the_window():
    out = engine().run([Request(uid=0, prompt=list(range(1, 101)),
                                max_new_tokens=10)])
    assert len(out[0]) == 10


def test_engine_unported_modes_raise():
    _, _, tcfg, tp, scfg = _setup()
    with pytest.raises(NotImplementedError, match="paged"):
        ServingEngine(tp, scfg, use_paged=True, device="cpu")
    with pytest.raises(NotImplementedError, match="speculation"):
        ServingEngine(tp, scfg, draft_params=tp, device="cpu")
    with pytest.raises(NotImplementedError, match="ring_flush"):
        ServingEngine(tp, dataclasses.replace(scfg, ring_flush=4),
                      device="cpu")


def test_engine_defaults_to_cuda(monkeypatch):
    _, _, _, tp, scfg = _setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tp, scfg)


@pytest.mark.parametrize("n_slots,chunk", [(2, 32), (4, 4)])
def test_engine_tokens_match_jax_engine(n_slots, chunk):
    """Token lists against the JAX engine's.  Where they part, the step
    must be a near tie: the top-2 margin of the port's own teacher-forced
    logits at that step lies inside the logit tolerance (4e-2 of
    max|logit|, see tests/test_torch_serve_model.py)."""
    jcfg, jp, tcfg, tp, scfg = _setup()
    prompts = {i: [1 + i, 2 + i, 3 + i, 40 + 2 * i][:2 + i % 3]
               for i in range(6)}
    jout = JServingEngine(jp, JServeConfig(model=jcfg), n_slots=n_slots,
                          max_seq=64, chunk_size=chunk).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=8)
         for i, p in prompts.items()])
    tout = engine(n_slots=n_slots, chunk_size=chunk).run(
        [Request(uid=i, prompt=p, max_new_tokens=8)
         for i, p in prompts.items()])
    assert set(tout) == set(jout)
    exact = 0
    for uid, want in jout.items():
        got = tout[uid]
        assert len(got) == len(want) == 8
        if got == want:
            exact += 1
            continue
        j = next(i for i in range(8) if got[i] != want[i])
        seq = torch.tensor(prompts[uid] + want[:j], dtype=torch.int32)
        logits = full_logits(tp, seq, scfg)[-1]
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) <= 2 * 4e-2 * float(logits.abs().max())
    assert exact >= 1


# -- the threaded front end ----------------------------------------------------

def _req(uid, new=6):
    return Request(uid=uid, prompt=[2 + uid, 7, 11], max_new_tokens=new)


@functools.lru_cache(maxsize=None)
def _random_setup():
    cfg = tiny_config(**{**TINY, "max_seq_len": 96})
    return random_serve_params(cfg, "e4m3", device="cpu"), \
        ServeConfig(model=cfg)


def _server_engine(**kw):
    params, scfg = _random_setup()
    return ServingEngine(params, scfg, max_seq=96, device="cpu", **kw)


def test_async_results_match_batch_run():
    ref = _server_engine(n_slots=2, chunk_size=8).run(
        [_req(i) for i in range(4)])
    srv = EngineServer(_server_engine(n_slots=2, chunk_size=8)).start()
    futs = {i: srv.submit(_req(i)) for i in range(4)}
    out = {i: f.result(timeout=120) for i, f in futs.items()}
    srv.stop()
    assert out == ref
    info = srv.pop_info(0)
    assert info["meta"]["n_tokens"] == 6 and len(info["logprobs"]) == 5
    assert srv.pop_info(0) == {}


def test_concurrent_submitters_and_streaming():
    srv = EngineServer(_server_engine(n_slots=2, chunk_size=8)).start()
    streamed, results = {}, {}

    def client(uid):
        toks = []
        fut = srv.submit(_req(uid, new=5), on_token=toks.append)
        results[uid] = fut.result(timeout=120)
        streamed[uid] = toks

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    srv.stop()
    assert set(results) == set(range(5))
    for uid in results:
        assert streamed[uid] == results[uid]      # in order, nothing lost
        assert len(results[uid]) == 5


def test_submit_after_stop_and_duplicate_uid():
    srv = EngineServer(_server_engine(n_slots=1)).start()
    fut = srv.submit(_req(0, new=3))
    with pytest.raises(ValueError, match="already in flight"):
        srv.submit(_req(0))
    assert len(fut.result(timeout=120)) == 3
    srv.stop()
    with pytest.raises(RuntimeError):
        srv.submit(_req(1))


def test_invalid_request_fails_future():
    srv = EngineServer(_server_engine(n_slots=1)).start()
    fut = srv.submit(Request(uid=0, prompt=[1], max_new_tokens=10_000))
    with pytest.raises(ValueError, match="max_new_tokens"):
        fut.result(timeout=60)
    srv.stop()


def test_async_cancel_stops_a_request():
    eng = _server_engine(n_slots=1, chunk_size=4)
    srv = EngineServer(eng).start()
    first = threading.Event()
    fut = srv.submit(_req(0, new=90), on_token=lambda tok: first.set())
    assert first.wait(timeout=120)
    srv.cancel(0)
    toks = fut.result(timeout=120)
    srv.stop()
    assert 1 <= len(toks) < 90
    ref = _server_engine(n_slots=1, chunk_size=4).run([_req(0, new=90)])
    assert toks == ref[0][:len(toks)]             # a prefix of the full run


def test_callback_error_does_not_stop_the_server():
    srv = EngineServer(_server_engine(n_slots=1)).start()

    def bad(tok):
        raise RuntimeError("client went away")

    fut = srv.submit(_req(0, new=4), on_token=bad)
    assert len(fut.result(timeout=120)) == 4
    srv.stop()
