"""Port parity for draft-and-verify speculation on the ring cache:
fp8tpu_torch.serve.speculative against fp8tpu.serve.speculative on the tiny
decoder, from the same artifact, ring bytes and tokens (the ring half of
tests/test_speculative.py on the port's side).

As in tests/test_torch_serve_model.py there are two references: the JAX
functions un-jitted (every rounding the source writes is kept: EAGER_TOL)
and jitted (XLA elides some bf16 roundings: JIT_TOL).  Greedy tokens are
compared by the margin rule: where two token lists part, the step must be
a near tie of the port's own logits.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.models import Decoder as JDecoder
from fp8tpu.models.transformer import tiny_config as j_tiny_config
from fp8tpu.serve import RingKVCache as JRing
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import convert_decoder_params as j_convert
from fp8tpu.serve import model as jmodel
from fp8tpu.serve import speculative as jspec
from fp8tpu_torch.models import tiny_config
from fp8tpu_torch.serve import (RingKVCache, ServeConfig, decode_step,
                                full_logits, prefill, ring_from_jax,
                                serve_params_from_jax)
from fp8tpu_torch.serve import speculative as tspec

TARGET = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=256, max_seq_len=96)
DRAFT = dict(TARGET, n_heads=2)            # head_dim 32, G = 1
EAGER_TOL = 4e-3      # of max|logit|, against the un-jitted JAX functions
JIT_TOL = 4e-2        # against the jitted ones
S = 64                # ring rows


def raw(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@functools.lru_cache(maxsize=None)
def model(which="target", kv_fmt="int8"):
    """(JAX artifact, JAX cfg, port artifact, port cfg) of a tiny decoder
    initialised by Flax from a seed."""
    kw = TARGET if which == "target" else DRAFT
    jcfg = j_tiny_config(**kw)
    v = JDecoder(jcfg).init(jax.random.key(0 if which == "target" else 1),
                            jnp.ones((1, 8), jnp.int32))
    jp = j_convert(v, jcfg)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (jp, JServeConfig(model=jcfg, kv_fmt=kv_fmt), tp,
            ServeConfig(model=tiny_config(**kw), kv_fmt=kv_fmt))


def rings(prompt, which="target", kv_fmt="int8"):
    """A one-slot ring prefilled with ``prompt`` on the JAX side and the
    same bytes on the port's."""
    jp, jsc, _, _ = model(which, kv_fmt)
    m = jsc.model
    j = JRing.create(m.n_layers, 1, S, m.n_kv_heads, m.head_dim, kv_fmt)
    with jax.disable_jit():
        _, j = jmodel.prefill(jp, j, jnp.asarray(prompt, jnp.int32),
                              jnp.int32(0), jnp.int32(len(prompt)), jsc)
    t = ring_from_jax(np.asarray(j.kv8), np.asarray(j.sc), j.head,
                      device="cpu")
    return j, t


def i32(values):
    return torch.tensor(values, dtype=torch.int32)


def assert_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def margin_ok(logits: torch.Tensor, tol=EAGER_TOL) -> bool:
    """The top-2 margin lies inside the logit tolerance: a near tie."""
    top2 = logits.topk(2).values
    return float(top2[0] - top2[1]) <= 2 * tol * float(logits.abs().max())


def tokens_agree(got, want, context, params, scfg, tol=EAGER_TOL):
    """Equal token lists, or a first difference at a near tie of the
    port's teacher-forced logits over ``context + want``."""
    if got == want:
        return True
    j = next(i for i in range(min(len(got), len(want))) if got[i] != want[i])
    seq = i32(context + want[:j])
    return margin_ok(full_logits(params, seq, scfg)[-1], tol)


PROMPT = [3, 14, 15, 9, 2, 6]
BLOCK = [7, 21, 42, 77, 11]


@pytest.mark.parametrize("kv_fmt", ["int8", "e4m3"])
def test_score_tokens_matches_jax(kv_fmt):
    """One ring verify pass of T = 5 tokens: logits and every ring byte
    against the un-jitted JAX function, the head advanced by T in place;
    logits against the jitted function within its tolerance."""
    jp, jsc, tp, tsc = model("target", kv_fmt)
    j, t = rings(PROMPT, kv_fmt=kv_fmt)
    head = t.head
    toks, pos = np.asarray([BLOCK], np.int32), np.asarray([6], np.int32)
    with jax.disable_jit():
        jl, j2 = jspec.score_tokens(jp, j, jnp.asarray(toks),
                                    jnp.asarray(pos), jsc)
    tl, t2 = tspec.score_tokens(tp, t, torch.from_numpy(toks),
                                torch.from_numpy(pos), tsc)
    assert t2 is t and t.head is head
    assert tuple(tl.shape) == (1, 5, 256) and tl.dtype == torch.float32
    assert_close(tl.numpy(), jl, EAGER_TOL)
    np.testing.assert_array_equal(raw(t.kv8), raw(j2.kv8))
    np.testing.assert_array_equal(raw(t.sc), raw(j2.sc))
    assert int(t.head) == int(j2.head) == 5
    j, _ = rings(PROMPT, kv_fmt=kv_fmt)
    jl, _ = jspec.score_tokens(jp, j, jnp.asarray(toks), jnp.asarray(pos),
                               jsc)
    assert_close(tl.numpy(), jl, JIT_TOL)


def test_score_tokens_equals_t_decode_steps():
    """logits[:, t] is what t + 1 plain decode steps give, and the ring
    holds the same rows (the JAX property, on the port alone).  The two
    paths round the attention context to bf16 after other summation
    orders (the step's own key enters as a score of its own there), so
    they are held to the bf16-step tolerance and the margin rule."""
    _, _, tp, tsc = model()
    _, ta = rings(PROMPT)
    _, tb = rings(PROMPT)
    steps = []
    for i, tok in enumerate(BLOCK):
        lg, ta = decode_step(tp, ta, i32([tok]), i32([6 + i]), tsc)
        steps.append(lg[0])
    lb, tb = tspec.score_tokens(tp, tb, i32([BLOCK]), i32([6]), tsc)
    for i in range(5):
        assert_close(lb[0, i].numpy(), steps[i].numpy(), JIT_TOL)
        assert int(lb[0, i].argmax()) == int(steps[i].argmax()) \
            or margin_ok(steps[i], JIT_TOL)
    assert int(ta.head) == int(tb.head)
    assert (raw(ta.kv8) == raw(tb.kv8)).mean() > 0.99


def test_score_tokens_window_reserve_hides_rolled_back_rows():
    """Past the ring's size the window is S - T rows: rows a rollback
    discarded never alias into the mask (two slots, a wrapped head)."""
    jp, jsc, tp, tsc = model()
    m = jsc.model
    rng = np.random.default_rng(4)
    j = JRing.create(m.n_layers, 2, S, m.n_kv_heads, m.head_dim, "int8")
    kv8 = rng.integers(-100, 100, j.kv8.shape).astype(np.int8)
    sc = rng.uniform(0.01, 0.02, j.sc.shape).astype(np.float32)
    j = JRing(jnp.asarray(kv8), jnp.asarray(sc), jnp.int32(S - 2))
    t = ring_from_jax(kv8, sc, S - 2, device="cpu")
    toks = np.asarray([BLOCK[:4], BLOCK[1:]], np.int32)
    pos = np.asarray([70, 20], np.int32)
    with jax.disable_jit():
        jl, j = jspec.score_tokens(jp, j, jnp.asarray(toks), jnp.asarray(pos),
                                   jsc)
    tl, t = tspec.score_tokens(tp, t, torch.from_numpy(toks),
                               torch.from_numpy(pos), tsc)
    assert_close(tl.numpy(), jl, EAGER_TOL)
    np.testing.assert_array_equal(raw(t.kv8), raw(j.kv8))
    assert int(t.head) == int(j.head) == 2


def test_rollback_then_decode_matches_jax():
    """Score 4, roll back 2, decode one step: the port moves the ring's
    own head tensor in place, and the step matches the JAX pair; it also
    matches the path that only ever scored 2."""
    jp, jsc, tp, tsc = model()
    prompt = [1, 2, 3]
    j, t = rings(prompt)
    head = t.head
    ptr = head.data_ptr()
    with jax.disable_jit():
        _, j = jspec.score_tokens(jp, j, jnp.asarray([[7, 8, 9, 10]]),
                                  jnp.asarray([3], jnp.int32), jsc)
        j = jspec.rollback(j, 2)
        jl, j = jmodel.decode_step(jp, j, jnp.asarray([42], jnp.int32),
                                   jnp.asarray([5], jnp.int32), jsc)
    _, t = tspec.score_tokens(tp, t, i32([[7, 8, 9, 10]]), i32([3]), tsc)
    assert int(t.head) == 4
    assert tspec.rollback(t, 2) is t
    assert t.head is head and t.head.data_ptr() == ptr and int(head) == 2
    tl, t = decode_step(tp, t, i32([42]), i32([5]), tsc)
    assert_close(tl.numpy(), jl, EAGER_TOL)
    np.testing.assert_array_equal(raw(t.kv8), raw(j.kv8))
    assert int(t.head) == int(j.head) == 3
    _, t2 = rings(prompt)
    _, t2 = tspec.score_tokens(tp, t2, i32([[7, 8]]), i32([3]), tsc)
    tl2, _ = decode_step(tp, t2, i32([42]), i32([5]), tsc)
    assert_close(tl2.numpy(), tl.numpy(), EAGER_TOL)


def test_greedy_verify_bit_equal():
    rng = np.random.default_rng(0)
    B, K, V = 6, 4, 50
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    tgt = logits.argmax(-1)
    draft = tgt[:, :K].copy()
    for b, n in enumerate([0, 1, 2, 3, 4, 2]):     # accept n, then differ
        if n < K:
            draft[b, n] = (draft[b, n] + 1) % V
    ja, jb = jspec.greedy_verify(jnp.asarray(logits), jnp.asarray(draft))
    ta, tb = tspec.greedy_verify(torch.from_numpy(logits),
                                 torch.from_numpy(draft.astype(np.int32)))
    assert ta.dtype == tb.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert ta.tolist() == [0, 1, 2, 3, 4, 2]


@pytest.mark.parametrize("top_k,top_p", [
    ([0, 1, 5, 70, 3, 0], [1.0, 1.0, 0.9, 0.3, 1e-6, 0.5]),
    ([0, 0, 0, 0, 0, 0], [1.0, 1.0, 1.0, 1.0, 1.0, 1.0])])
def test_filter_logits_bit_equal(top_k, top_p):
    """Per-slot top-k / top-p keep sets (k past the 64-token pool, both
    filters off on some slots) give the JAX package's bits."""
    rng = np.random.default_rng(1)
    B, T, V = 6, 3, 100
    logits = (rng.standard_normal((B, T, V)) * 3).astype(np.float32)
    tk, tp = np.asarray(top_k, np.int32), np.asarray(top_p, np.float32)
    want = np.asarray(jspec.filter_logits(jnp.asarray(logits),
                                          jnp.asarray(tk), jnp.asarray(tp)))
    got = tspec.filter_logits(torch.from_numpy(logits), torch.from_numpy(tk),
                              torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_draft_chunk_tokens_match_their_logits():
    """draft_chunk's (token, logits) pairs: greedy tokens are the argmaxes
    of the returned logits, which match the JAX chunk's; tokens sampled at
    a temperature near 0 are their own logits' argmaxes too (each token
    was drawn from the logits returned beside it)."""
    jp, jsc, tp, tsc = model("draft")
    j, t = rings([1, 2, 3], "draft")
    with jax.disable_jit():
        jd, jl, j = jspec.draft_chunk(jp, j, jnp.asarray([5], jnp.int32),
                                      jnp.asarray([3], jnp.int32),
                                      jax.random.key(9),
                                      jnp.zeros((1,), jnp.float32), 4, jsc)
    td, tl, t = tspec.draft_chunk(tp, t, i32([5]), i32([3]), None,
                                  torch.zeros(1), 4, tsc)
    assert tuple(td.shape) == (1, 4) and tuple(tl.shape) == (1, 4, 256)
    np.testing.assert_array_equal(td[0].numpy(), tl[0].argmax(-1).numpy())
    assert_close(tl.numpy(), jl, EAGER_TOL)
    if td.tolist() == np.asarray(jd).tolist():
        np.testing.assert_array_equal(raw(t.kv8), raw(j.kv8))
    assert int(t.head) == int(j.head) == 4
    _, t = rings([1, 2, 3], "draft")
    gen = torch.Generator().manual_seed(3)
    sd, sl, _ = tspec.draft_chunk(tp, t, i32([5]), i32([3]), gen,
                                  torch.full((1,), 1e-4), 4, tsc)
    np.testing.assert_array_equal(sd[0].numpy(), sl[0].argmax(-1).numpy())


def _plain_greedy(tp, tsc, prompt, n_new):
    ring = RingKVCache.create(tsc.model.n_layers, 1, 96,
                              tsc.model.n_kv_heads, tsc.model.head_dim,
                              tsc.kv_fmt, device="cpu")
    logits, ring = prefill(tp, ring, i32(prompt), 0, len(prompt), tsc)
    toks = [int(logits.argmax())]
    while len(toks) < n_new:
        lg, ring = decode_step(tp, ring, i32([toks[-1]]),
                               i32([len(prompt) + len(toks) - 1]), tsc)
        toks.append(int(lg[0].argmax()))
    return toks


@pytest.mark.parametrize("self_draft", [False, True])
def test_speculative_decode_greedy_matches_jax_and_plain(self_draft):
    """Greedy speculative decode gives the plain decode loop's tokens and
    the JAX function's (by the margin rule); a self-draft accepts every
    drafted token, K + 1 tokens a round."""
    jp, jsc, tp, tsc = model()
    jd, jdsc, td, tdsc = (jp, jsc, tp, tsc) if self_draft \
        else model("draft")
    prompt, n_new = [5, 9, 1, 30, 2], 20
    jout, jst = jspec.speculative_decode(jp, jd, prompt, n_new, jsc, jdsc,
                                         k_spec=4, max_seq=96)
    out, st = tspec.speculative_decode(tp, td, prompt, n_new, tsc, tdsc,
                                       k_spec=4, max_seq=96)
    assert len(out) == n_new and st.emitted >= n_new - 1 and st.rounds >= 1
    assert tokens_agree(out, list(jout), prompt, tp, tsc, JIT_TOL)
    assert tokens_agree(out, _plain_greedy(tp, tsc, prompt, n_new), prompt,
                        tp, tsc)
    if self_draft:
        assert st.acceptance_rate == 1.0 and st.tokens_per_round == 5.0
        assert jst.acceptance_rate == 1.0
    else:
        assert st.drafted == 4 * st.rounds


def test_speculative_decode_sampling_runs_and_rejects_what_cannot_fit():
    _, _, tp, tsc = model()
    _, _, td, tdsc = model("draft")
    gen = torch.Generator().manual_seed(5)
    out, st = tspec.speculative_decode(tp, td, [1, 2, 3], 12, tsc, tdsc,
                                       k_spec=3, max_seq=96, temperature=0.8,
                                       generator=gen)
    assert len(out) == 12 and all(0 <= t < 256 for t in out)
    assert st.rounds >= 12 // 4
    with pytest.raises(ValueError, match="verify reserve"):
        tspec.speculative_decode(tp, td, list(range(90)), 8, tsc, tdsc,
                                 max_seq=96)


def test_spec_stats():
    for stats in (tspec.SpecStats(rounds=4, drafted=16, accepted=10,
                                  emitted=14),
                  jspec.SpecStats(rounds=4, drafted=16, accepted=10,
                                  emitted=14)):
        assert stats.acceptance_rate == pytest.approx(10 / 16)
        assert stats.tokens_per_round == pytest.approx(3.5)
    empty = tspec.SpecStats()
    assert empty.acceptance_rate == 0.0 and empty.tokens_per_round == 0.0
