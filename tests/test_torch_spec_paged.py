"""Port parity for speculation on the paged pool: score_tokens_paged,
the chunked and scored prefills, the batched speculation round and the
sampled acceptance of fp8tpu_torch.serve.speculative against
fp8tpu.serve.speculative on the tiny decoder (the paged half of
tests/test_speculative.py on the port's side).

The JAX functions are run un-jitted (every rounding the source writes is
kept: EAGER_TOL) and jitted (XLA elides some bf16 roundings: JIT_TOL).
Pools start from the same bytes on both sides (paged_from_jax) and are
compared byte for byte.
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
from fp8tpu.serve import PagedKVCache as JPaged
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import convert_decoder_params as j_convert
from fp8tpu.serve import model as jmodel
from fp8tpu.serve import speculative as jspec
from fp8tpu_torch.models import tiny_config
from fp8tpu_torch.serve import (ServeConfig, decode_step_paged,
                                paged_from_jax, serve_params_from_jax)
from fp8tpu_torch.serve import speculative as tspec

TARGET = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=256, max_seq_len=96)
DRAFT = dict(TARGET, n_heads=2)
EAGER_TOL = 4e-3      # of max|logit|, against the un-jitted JAX functions
JIT_TOL = 4e-2        # against the jitted ones
PAGE, MAX_PAGES = 8, 8


def raw(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@functools.lru_cache(maxsize=None)
def model(which="target", impl="ringview"):
    """(JAX artifact, JAX cfg, port artifact, port cfg) of a tiny decoder
    initialised by Flax from a seed; both sides decode pages with
    ``impl``."""
    kw = TARGET if which == "target" else DRAFT
    jcfg = j_tiny_config(**kw)
    v = JDecoder(jcfg).init(jax.random.key(0 if which == "target" else 1),
                            jnp.ones((1, 8), jnp.int32))
    jp = j_convert(v, jcfg)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (jp, JServeConfig(model=jcfg, kv_fmt="int8",
                             paged_decode_impl=impl), tp,
            ServeConfig(model=tiny_config(**kw), kv_fmt="int8",
                        paged_decode_impl=impl))


def pools(prompts, which="target"):
    """Slot b owns pages [b * MAX_PAGES, (b + 1) * MAX_PAGES) and holds
    prompts[b] (prefilled by the un-jitted JAX function); the port's pool
    has the same bytes."""
    jp, jsc, _, _ = model(which)
    m = jsc.model
    B = len(prompts)
    j = JPaged.create(B * MAX_PAGES, PAGE, m.n_layers, B, MAX_PAGES,
                      m.n_kv_heads, m.head_dim, "int8")
    table = np.arange(B * MAX_PAGES, dtype=np.int32).reshape(B, MAX_PAGES)
    j = dataclasses.replace(j, page_table=jnp.asarray(table))
    with jax.disable_jit():
        for b, prompt in enumerate(prompts):
            if prompt:
                _, j = jmodel.prefill_paged(
                    jp, j, jnp.asarray(prompt, jnp.int32), jnp.int32(b),
                    jnp.int32(len(prompt)), jsc)
    t = paged_from_jax(np.asarray(j.pool), np.asarray(j.sc), table,
                       m.n_kv_heads, device="cpu")
    return j, t


def i32(values):
    return torch.tensor(values, dtype=torch.int32)


def assert_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def assert_pools_near(a, b):
    """Two pools written through other summation orders: a bf16 step of a
    k / v vector moves its int8 payload by at most a step or two and its
    scale (amax / 127) by a few bf16 steps (2^-8 relative each)."""
    pa, pb = (p.pool.to(torch.int32).numpy() for p in (a, b))
    assert np.abs(pa - pb).max() <= 2 and (pa == pb).mean() > 0.95
    np.testing.assert_allclose(a.sc.numpy(), b.sc.numpy(), rtol=2.0 ** -5)


def assert_pools_equal(t, j):
    np.testing.assert_array_equal(raw(t.pool), raw(j.pool))
    np.testing.assert_array_equal(raw(t.sc), raw(j.sc))


PROMPTS = [[3, 14, 15, 9, 2, 6], [7, 7, 1], list(range(20, 31))]


def test_score_tokens_paged_valid_t_and_slots_match_jax():
    """Three rows over a 3-slot pool: row 0 scores slot 2 with 4 valid
    tokens, row 1 slot 0 with 1, row 2 is padding (slot 3 >= n_slots) and
    writes nothing.  Logits and every pool byte against the un-jitted JAX
    function; logits against the jitted one."""
    jp, jsc, tp, tsc = model()
    j, t = pools(PROMPTS)
    toks = np.asarray([[11, 22, 33, 44], [44, 99, 98, 97], [5, 6, 7, 8]],
                      np.int32)
    pos = np.asarray([11, 6, 2], np.int32)
    valid = np.asarray([4, 1, 3], np.int32)
    slots = np.asarray([2, 0, 3], np.int32)
    before = raw(t.pool).copy()
    args = (jnp.asarray(toks), jnp.asarray(pos), jsc)
    kw = dict(valid_t=jnp.asarray(valid), slots=jnp.asarray(slots))
    with jax.disable_jit():
        jl, j2 = jspec.score_tokens_paged(jp, j, *args, **kw)
    tl, t2 = tspec.score_tokens_paged(
        tp, t, torch.from_numpy(toks), torch.from_numpy(pos), tsc,
        valid_t=torch.from_numpy(valid), slots=torch.from_numpy(slots))
    assert t2 is t
    assert_close(tl.numpy(), jl, EAGER_TOL)
    assert_pools_equal(t, j2)
    changed = (raw(t.pool) != before).reshape(t.n_pages, -1).any(axis=1)
    # slot 2's page 1 (positions 11..14) and slot 0's page 0 (position 6)
    assert sorted(np.flatnonzero(changed).tolist()) == [0, 2 * MAX_PAGES + 1]
    j, _ = pools(PROMPTS)
    jl, _ = jspec.score_tokens_paged(jp, j, *args, **kw)
    assert_close(tl.numpy(), jl, JIT_TOL)


def test_score_tokens_paged_equals_steps_and_ignores_garbage_tails():
    """A full block equals chained paged decode steps (by the bf16-step
    tolerance: the contexts round to bf16 after other summation orders),
    and a slot's logits and pages do not depend on tokens past its
    valid count."""
    _, _, tp, tsc = model()
    _, ta = pools(PROMPTS[:2])
    _, tb = pools(PROMPTS[:2])
    toks = np.asarray([[7, 21, 42, 77], [9, 33, 51, 2]], np.int32)
    pos0 = np.asarray([6, 3], np.int32)
    steps = []
    for k in range(4):
        lg, ta = decode_step_paged(tp, ta, torch.from_numpy(toks[:, k]),
                                   torch.from_numpy(pos0 + k), tsc)
        steps.append(lg)
    lb, tb = tspec.score_tokens_paged(tp, tb, torch.from_numpy(toks),
                                      torch.from_numpy(pos0), tsc)
    for k in range(4):
        assert_close(lb[:, k].numpy(), steps[k].numpy(), JIT_TOL)
    assert_pools_near(ta, tb)
    _, t1 = pools(PROMPTS[:2])
    _, t2 = pools(PROMPTS[:2])
    l1, _ = tspec.score_tokens_paged(tp, t1, i32([[11, 22, 33], [44, 99, 99]]),
                                     i32([6, 3]), tsc, valid_t=i32([3, 1]))
    l2, _ = tspec.score_tokens_paged(tp, t2, i32([[11, 22, 33], [44, 44, 44]]),
                                     i32([6, 3]), tsc, valid_t=i32([3, 1]))
    assert torch.equal(l1[1, 0], l2[1, 0]) and torch.equal(l1[0], l2[0])
    np.testing.assert_array_equal(raw(t1.pool), raw(t2.pool))


def test_prefill_chunked_paged_matches_single_shot_and_jax():
    """Chunks of 5 against one scored pass over the whole prompt, a resume
    from 5 cached tokens, and the JAX chunked prefill (un-jitted): pool
    bytes equal to JAX's."""
    jp, jsc, tp, tsc = model()
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]
    j, ta = pools([[]])
    with jax.disable_jit():
        jl, j = jspec.prefill_chunked_paged(jp, j, prompt, 0, jsc, chunk=5)
    la, ta = tspec.prefill_chunked_paged(tp, ta, prompt, 0, tsc, chunk=5)
    assert tuple(la.shape) == (256,)
    assert_close(la.numpy(), jl, EAGER_TOL)
    assert_pools_equal(ta, j)
    # one pass: the same attention in other blocks, so bf16 steps move
    _, tb = pools([[]])
    lb, tb = tspec.score_tokens_paged(tp, tb, i32([prompt]), i32([0]), tsc)
    assert_close(la.numpy(), lb[0, -1].numpy(), JIT_TOL)
    assert_pools_near(ta, tb)
    _, tc = pools([[]])
    _, tc = tspec.score_tokens_paged(tp, tc, i32([prompt[:5]]), i32([0]),
                                     tsc)
    lc, _ = tspec.prefill_chunked_paged(tp, tc, prompt, 0, tsc, chunk=4,
                                        start=5)
    assert_close(lc.numpy(), la.numpy(), JIT_TOL)
    with pytest.raises(ValueError, match="start"):
        tspec.prefill_chunked_paged(tp, tc, prompt, 0, tsc, start=13)


def test_prefill_scored_paged_matches_jax():
    """Scored admission of 3 rows (two cached prefixes, one cold, one
    padding row): first tokens, the patched carry and pool bytes against
    the un-jitted JAX function."""
    jp, jsc, tp, tsc = model()
    j, t = pools([PROMPTS[2][:8], [], PROMPTS[0][:0], []])
    suffix = np.zeros((4, 8), np.int32)
    suffix[0, :3] = PROMPTS[2][8:]
    suffix[1, :6] = PROMPTS[0]
    suffix[2, :2] = [5, 6]
    slots = np.asarray([0, 1, 4, 2], np.int32)         # row 2 is padding
    clens = np.asarray([8, 0, 0, 0], np.int32)
    slens = np.asarray([3, 6, 2, 1], np.int32)
    suffix[3, 0] = 77
    carry_t = np.full(4, 9, np.int32)
    carry_p = np.full(4, 3, np.int32)
    with jax.disable_jit():
        jf, j, jt, jpos = jspec.prefill_scored_paged(
            jp, j, jnp.asarray(suffix), jnp.asarray(slots),
            jnp.asarray(clens), jnp.asarray(slens), jax.random.key(0),
            jnp.zeros(4), jnp.asarray(carry_t), jnp.asarray(carry_p), jsc)
    tf, t, tt, tpos = tspec.prefill_scored_paged(
        tp, t, torch.from_numpy(suffix), torch.from_numpy(slots),
        torch.from_numpy(clens), torch.from_numpy(slens), None,
        torch.zeros(4), torch.from_numpy(carry_t), torch.from_numpy(carry_p),
        tsc)
    assert tf.tolist() == np.asarray(jf).tolist()
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tpos.tolist() == np.asarray(jpos).tolist() == [11, 6, 1, 3]
    assert_pools_equal(t, j)


def _spec_pools():
    prompts = [[2, 7, 11, 5], [3, 8, 12, 6, 9, 1]]
    jt, tt = pools(prompts)
    jd, td = pools(prompts, "draft")
    pend = np.asarray([[40, 40], [12, 41]], np.int32)
    pend_n = np.asarray([1, 2], np.int32)
    tpos = np.asarray([4, 7], np.int32)
    dpos = np.asarray([4, 6], np.int32)
    return (jt, tt, jd, td), (pend, pend_n, tpos, dpos)


@pytest.mark.parametrize("rounds", [1, 2])
def test_spec_round_and_rounds_match_jax(rounds):
    """Greedy rounds over two slots (one with two pending tokens) against
    the un-jitted JAX functions: drafted tokens, accepted counts, bonus
    tokens, the pending carry, both positions, and both pools' bytes."""
    jp, jsc, tp, tsc = model()
    jdp, jdsc, tdp, tdsc = model("draft")
    (jt, tt, jd, td), carry = _spec_pools()
    temp = np.zeros(2, np.float32)
    jargs = [jnp.asarray(c) for c in carry]
    targs = [torch.from_numpy(c) for c in carry]
    with jax.disable_jit():
        if rounds == 1:
            jout = jspec.spec_round(jp, jt, jdp, jd, *jargs,
                                    jax.random.key(0), jnp.asarray(temp), 4,
                                    jsc, jdsc, any_sampled=False)
        else:
            jout = jspec.spec_rounds(jp, jt, jdp, jd, *jargs,
                                     jax.random.key(0), jnp.asarray(temp), 4,
                                     rounds, jsc, jdsc, any_sampled=False)
    if rounds == 1:
        tout = tspec.spec_round(tp, tt, tdp, td, *targs, None,
                                torch.from_numpy(temp), 4, tsc, tdsc,
                                any_sampled=False)
    else:
        tout = tspec.spec_rounds(tp, tt, tdp, td, *targs, None,
                                 torch.from_numpy(temp), 4, rounds, tsc,
                                 tdsc, any_sampled=False)
    names = ("drafted", "a", "bonus", "pend", "pend_n", "tpos", "dpos")
    for name, got, want in zip(names, tout[:7], jout[:7]):
        assert got.dtype == torch.int32, name
        assert got.tolist() == np.asarray(want).tolist(), name
    assert tout[7] is tt and tout[8] is td
    assert_pools_equal(tt, jout[7])
    assert_pools_equal(td, jout[8])


def test_spec_round_sampled_and_filtered_runs():
    """A sampled round with top-k / top-p (the draft's filtered draws fed
    forward): tokens in the vocabulary, counts in [0, K], positions
    advanced by a + 1."""
    _, _, tp, tsc = model()
    _, _, tdp, tdsc = model("draft")
    (_, tt, _, td), (pend, pend_n, tpos, dpos) = _spec_pools()
    gen = torch.Generator().manual_seed(1)
    out = tspec.spec_round(
        tp, tt, tdp, td, torch.from_numpy(pend), torch.from_numpy(pend_n),
        torch.from_numpy(tpos), torch.from_numpy(dpos), gen,
        torch.tensor([0.8, 0.0]), 4, tsc, tdsc, any_sampled=True,
        filtering=True, top_k=i32([5, 0]), top_p=torch.tensor([0.9, 1.0]))
    drafted, a, bonus, _, pend_n2, tpos2, _ = out[:7]
    assert ((0 <= drafted) & (drafted < 256)).all()
    assert ((0 <= a) & (a <= 4)).all() and ((0 <= bonus) & (bonus < 256)).all()
    assert torch.equal(tpos2, torch.from_numpy(tpos) + a + 1)
    assert torch.equal(pend_n2, torch.where(a == 4, 2, 1).to(torch.int32))


def _tiled_pool(prompt, n):
    """n slots that each hold ``prompt`` (prefilled once by JAX), the
    target model's pool."""
    j, t = pools([prompt])
    pool = np.tile(np.asarray(j.pool)[:MAX_PAGES], (n, 1, 1, 1, 1))
    sc = np.tile(np.asarray(j.sc)[:MAX_PAGES], (n, 1, 1, 1))
    table = np.arange(n * MAX_PAGES, dtype=np.int32).reshape(n, MAX_PAGES)
    return paged_from_jax(pool, sc, table, t.kv_heads, device="cpu")


@pytest.mark.parametrize("draft_prompt", [[2, 7, 11, 5], [3, 7, 11, 5]],
                         ids=["self-draft", "other-context"])
@pytest.mark.parametrize("temp,top_k,top_p", [(0.5, 6, 1.0), (0.3, 0, 0.6)],
                         ids=["top_k", "top_p"])
def test_spec_round_filtered_marginal_matches_filtered_target(
        draft_prompt, temp, top_k, top_p):
    """Through a whole spec_round with a filter that bites (the filtered
    law lies >= 0.3 in total variation from the unfiltered one): the first
    emitted token of N identical slots follows the FILTERED target law
    within the TV limit of the sample_verify test.  The draft (the target's
    weights over the same or another context) feeds its filtered draws
    forward, so this holds with and without acceptance."""
    N = 16384
    _, _, tp, tsc = model()
    prompt, pend = [2, 7, 11, 5], 40
    lg, _ = tspec.score_tokens_paged(tp, _tiled_pool(prompt, 1), i32([[pend]]),
                                     i32([len(prompt)]), tsc)
    scaled = lg / temp
    law = torch.softmax(tspec.filter_logits(scaled, i32([top_k]),
                                            torch.tensor([top_p])), -1)
    law, unfiltered = law[0, 0].numpy(), torch.softmax(scaled, -1)[0, 0]
    assert 0.5 * np.abs(unfiltered.numpy() - law).sum() > 0.3
    gen = torch.Generator().manual_seed(1)
    start = i32([len(prompt)] * N)
    out = tspec.spec_round(
        tp, _tiled_pool(prompt, N), tp, _tiled_pool(draft_prompt, N),
        i32([[pend, pend]] * N), i32([1] * N), start, start, gen,
        torch.full((N,), temp), 4, tsc, tsc, any_sampled=True,
        filtering=True, top_k=i32([top_k] * N),
        top_p=torch.full((N,), top_p))
    drafted, a, bonus = out[:3]
    first = torch.where(a >= 1, drafted[:, 0], bonus).numpy()
    hist = np.bincount(first, minlength=law.size) / N
    assert 0.5 * np.abs(hist - law).sum() < 0.02
    accepted = float((a >= 1).float().mean())
    # q = p up to the draft steps' other summation order, or a law of its
    # own that overlaps p: the bonus path is taken too
    assert accepted > 0.95 if draft_prompt == prompt else \
        0.05 < accepted < 0.95


def test_sample_verify_marginal_matches_target():
    """Leviathan Thm 1: the emitted first token (an accepted draft or the
    residual resample) follows the TARGET law, over independent trials
    drawn from the port's generator."""
    V, N = 8, 40000
    rng = np.random.default_rng(3)
    p_logits = (rng.standard_normal(V) * 1.5).astype(np.float32)
    q_logits = (rng.standard_normal(V) * 1.5).astype(np.float32)
    p = np.exp(p_logits) / np.exp(p_logits).sum()
    q = np.exp(q_logits) / np.exp(q_logits).sum()
    gen = torch.Generator().manual_seed(0)
    draft = torch.multinomial(torch.from_numpy(q).expand(N, V), 1,
                              replacement=True, generator=gen).to(torch.int32)
    lp = torch.from_numpy(p_logits).expand(N, 2, V)
    lq = torch.from_numpy(q_logits).expand(N, 1, V)
    a, bonus = tspec.sample_verify(lp, lq, draft, gen, torch.ones(N))
    first = torch.where(a >= 1, draft[:, 0], bonus).numpy()
    hist = np.bincount(first, minlength=V) / N
    assert 0.5 * np.abs(hist - p).sum() < 0.02
    acc = float((a >= 1).float().mean())
    assert acc == pytest.approx(np.minimum(p, q).sum(), abs=0.02)
    # filtered: with top_k = 1 both laws keep only their argmax
    a1, b1 = tspec.sample_verify(lp[:64], lq[:64], draft[:64], gen,
                                 torch.ones(64), top_k=torch.ones(
                                     64, dtype=torch.int32))
    first1 = torch.where(a1 >= 1, draft[:64, 0], b1)
    assert (first1 == int(np.argmax(p))).all()
