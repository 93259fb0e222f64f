"""Port parity for the paged KV pool and the paged decode / prefill
functions: fp8tpu_torch.serve against fp8tpu.serve on the tiny model, from
the same artifact, tokens and page tables (tests/test_serve.py:264-567 on the
port's side).

As in tests/test_torch_serve_model.py there are two references: the JAX
functions jitted (XLA elides some bf16 roundings: JIT_TOL) and un-jitted
(every rounding the source writes is kept: EAGER_TOL).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from fp8tpu.models import Decoder as JDecoder
from fp8tpu.models.transformer import tiny_config as j_tiny_config
from fp8tpu.serve import PagedKVCache as JPaged
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import convert_decoder_params as j_convert
from fp8tpu.serve import model as jmodel
from fp8tpu.serve.speculative import _paged_write_block as j_write_block
from fp8tpu_torch.models import tiny_config
from fp8tpu_torch.serve import (PagedKVCache, RingKVCache, ServeConfig,
                                decode_chunk_paged, decode_step_paged,
                                decode_steps, decode_steps_paged,
                                paged_from_jax, prefill_batch_paged,
                                prefill_paged, serve_params_from_jax)
from fp8tpu_torch.serve import model as tmodel
from fp8tpu_torch.serve import speculative as tspec

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, max_seq_len=32)
L, KV, D = 2, 2, 16
JIT_TOL = 4e-2        # of max|logit|, against the jitted JAX functions
EAGER_TOL = 4e-3      # against the un-jitted ones
IMPLS = ("ringview", "kernel", "side", "side-eager", "scatter")


def raw(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.fixture(scope="module")
def setup():
    """The tiny model and its e4m3 artifact on both sides, built once."""
    jcfg, tcfg = j_tiny_config(**TINY), tiny_config(**TINY)
    v = JDecoder(jcfg).init(jax.random.key(0), jnp.arange(16)[None] % 128)
    jp = j_convert(v, jcfg)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def cfgs(setup, kv_fmt="int8", impl="ringview"):
    jcfg, tcfg = setup[:2]
    kw = dict(kv_fmt=kv_fmt, paged_decode_impl=impl)
    return JServeConfig(model=jcfg, **kw), ServeConfig(model=tcfg, **kw)


def pools(kv_fmt="int8", n_slots=2, n_pages=8, page=8, max_pages=4,
          table=None):
    """The same pool on both sides; by default slot b owns the pages
    [b * max_pages, (b + 1) * max_pages)."""
    if table is None:
        table = np.arange(n_slots * max_pages, dtype=np.int32).reshape(
            n_slots, max_pages)
    j = JPaged.create(n_pages, page, L, n_slots, max_pages, KV, D, kv_fmt)
    j = dataclasses.replace(j, page_table=jnp.asarray(table))
    t = PagedKVCache.create(n_pages, page, L, n_slots, max_pages, KV, D,
                            kv_fmt, device="cpu")
    t.page_table = torch.from_numpy(np.asarray(table, np.int32).copy())
    return j, t


def assert_pools_equal(j, t):
    np.testing.assert_array_equal(raw(t.pool), raw(j.pool))
    np.testing.assert_array_equal(raw(t.sc), raw(j.sc))
    np.testing.assert_array_equal(t.page_table.numpy(),
                                  np.asarray(j.page_table))


# -- the pool's own methods: bit for bit -------------------------------------------

def test_create_properties_assign_and_free():
    j, t = pools("e4m3", n_slots=3, n_pages=10, page=8, max_pages=4,
                 table=-np.ones((3, 4), np.int32))
    assert (t.fmt, t.page_size, t.max_pages, t.max_seq, t.n_slots,
            t.n_pages) == (j.fmt, j.page_size, j.max_pages, j.max_seq,
                           j.n_slots, 10) == ("e4m3", 8, 4, 32, 3, 10)
    assert t.pool.dtype == torch.float8_e4m3fn and t.sc.dtype == torch.float32
    assert tuple(t.pool.shape) == j.pool.shape == (10, 2, L, 16, D)
    assert t.page_table.dtype == torch.int32
    # the scratch page of dropped writes lies past the pool, in its storage
    assert t.store8.shape[0] == 11 and t.pool.data_ptr() == t.store8.data_ptr()
    assert_pools_equal(j, t)
    j = j.assign_pages(1, jnp.arange(3), jnp.asarray([7, 2, 9]))
    old = t.page_table
    t = t.assign_pages(1, np.arange(3), np.array([7, 2, 9]))
    assert t.page_table is not old and int(old[1, 0]) == -1
    assert_pools_equal(j, t)
    j, t = j.free_slot(1), t.free_slot(1)
    assert_pools_equal(j, t)
    for fmt, dt in (("int8", torch.int8), ("e5m2", torch.float8_e5m2),
                    ("bf16", torch.bfloat16)):
        p = PagedKVCache.create(2, 4, 1, 1, 2, 2, 16, fmt, device="cpu")
        assert p.pool.dtype == dt and p.fmt == fmt


@pytest.mark.parametrize("kv_fmt", ["int8", "e4m3", "bf16"])
def test_write_step_with_overruns_and_unmapped_pages(rng, kv_fmt):
    """Slot 0 writes inside its pages, slot 1 into an unmapped page, slot 2
    past max_seq: the last two drop and nothing else changes."""
    table = np.array([[5, 3, 0, 1], [2, -1, -1, -1], [4, 6, 7, 8]], np.int32)
    j, t = pools(kv_fmt, n_slots=3, n_pages=9, table=table)
    dt = {"int8": np.int8, "e4m3": ml_dtypes.float8_e4m3fn,
          "bf16": ml_dtypes.bfloat16}[kv_fmt]
    for pos in ([13, 9, 33], [0, 7, 31], [31, 8, 32]):
        fk = (rng.standard_normal((L, 3, KV, D)) * 20).astype(np.float32
                                                               ).astype(dt)
        fv = (rng.standard_normal((L, 3, KV, D)) * 20).astype(np.float32
                                                               ).astype(dt)
        fks = rng.uniform(0.1, 1, (L, 3, KV)).astype(np.float32)
        fvs = rng.uniform(0.1, 1, (L, 3, KV)).astype(np.float32)
        j = j.write_step(jnp.asarray(fk), jnp.asarray(fks), jnp.asarray(fv),
                         jnp.asarray(fvs), jnp.asarray(pos, jnp.int32))
        same = t.write_step(*(tmodel._tensor_from_array(a, "cpu")
                              for a in (fk, fks, fv, fvs)),
                            torch.tensor(pos, dtype=torch.int32))
        assert same is t
        assert_pools_equal(j, t)
    assert (t.sc != 1).any()


def test_gather_and_paged_from_jax(rng):
    table = np.array([[5, 3, -1, 1], [2, -1, 0, 4]], np.int32)
    j, _ = pools("e4m3", n_pages=6, table=table)
    j = dataclasses.replace(
        j, pool=jnp.asarray(rng.standard_normal(j.pool.shape) * 50
                            ).astype(jnp.float8_e4m3fn),
        sc=jnp.asarray(rng.uniform(0.1, 1, j.sc.shape), jnp.float32))
    t = paged_from_jax(np.asarray(j.pool), np.asarray(j.sc),
                       np.asarray(j.page_table), j.kv_heads, device="cpu")
    assert t.fmt == "e4m3" and t.kv_heads == KV and t.page_size == 8
    assert_pools_equal(j, t)
    jk, js = j.gather()
    tk, ts = t.gather()
    assert tuple(tk.shape) == jk.shape == (2, 4, 2, L, 16, D)
    np.testing.assert_array_equal(raw(tk), raw(jk))
    np.testing.assert_array_equal(raw(ts), raw(js))


def test_paged_write_block_matches_jax(rng):
    """The chunk-end block write: rows past valid_t, past max_seq, into
    unmapped pages and of masked rows drop."""
    table = np.array([[5, 3, 0, 1], [2, -1, -1, -1], [4, 6, 7, 8]], np.int32)
    j, t = pools("int8", n_slots=3, n_pages=9, table=table)
    T = 6
    fk = rng.integers(-127, 128, (L, 3, T, KV, D)).astype(np.int8)
    fv = rng.integers(-127, 128, (L, 3, T, KV, D)).astype(np.int8)
    fks = rng.uniform(0.1, 1, (L, 3, T, KV)).astype(np.float32)
    fvs = rng.uniform(0.1, 1, (L, 3, T, KV)).astype(np.float32)
    starts = np.array([5, 6, 29], np.int32)
    valid_t = np.array([6, 6, 4], np.int32)
    for row_valid in (None, np.array([True, True, False])):
        jkw = {} if row_valid is None else dict(
            row_valid=jnp.asarray(row_valid))
        tkw = {} if row_valid is None else dict(
            row_valid=torch.from_numpy(row_valid))
        j = j_write_block(j, *(jnp.asarray(a) for a in (fk, fks, fv, fvs)),
                          jnp.asarray(starts), jnp.asarray(valid_t), **jkw)
        t = tspec._paged_write_block(
            t, *(torch.from_numpy(a) for a in (fk, fks, fv, fvs)),
            torch.from_numpy(starts), torch.from_numpy(valid_t), **tkw)
        assert_pools_equal(j, t)
        starts = starts + 1


# -- prefill: pool bytes and logits --------------------------------------------------

PROMPT = [3, 14, 15, 92, 65, 35, 89, 79, 32, 38, 46]


def test_prefill_paged_matches_jax_unjitted(setup):
    jsc, tsc = cfgs(setup)
    jp, tp = setup[2:]
    j, t = pools("int8", table=np.array([[6, 1, 4, -1], [0, 2, 3, 5]]))
    prompt = np.array(PROMPT + [0] * 5, np.int32)
    with jax.disable_jit():
        jl, j = jmodel.prefill_paged(jp, j, jnp.asarray(prompt), jnp.int32(0),
                                     jnp.int32(len(PROMPT)), jsc)
    tl, t = prefill_paged(tp, t, torch.from_numpy(prompt), 0, len(PROMPT),
                          tsc)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() \
        <= EAGER_TOL * np.abs(np.asarray(jl)).max()
    # the same rows were written, with the same bytes
    assert_pools_equal(j, t)
    assert int((t.sc != 1).sum()) == 2 * L * len(PROMPT) * KV


def test_prefill_batch_paged_write_starts_and_drops(setup):
    """Batched admission with padding rows, a padding slot and write_starts:
    pool bytes equal to JAX's (un-jitted), logits within EAGER_TOL, the
    token / position carry patched only for real slots."""
    jsc, tsc = cfgs(setup)
    jp, tp = setup[2:]
    j, t = pools("int8", n_slots=3, n_pages=12,
                 table=np.array([[6, 1, 4, -1], [0, 2, 3, 5], [7, 8, 9, 10]]))
    prompts = np.zeros((4, 16), np.int32)
    prompts[0, :11], prompts[1, :3], prompts[2, :9] = PROMPT, [9, 8, 7], \
        PROMPT[:9]
    slots = np.array([2, 0, 1, 3], np.int32)           # n_slots = 3
    lengths = np.array([11, 3, 9, 0], np.int32)
    starts = np.array([8, 0, 0, 0], np.int32)          # row 0 skips a page
    temp, tk, tp_ = np.zeros(4, np.float32), np.zeros(4, np.int32), \
        np.ones(4, np.float32)
    with jax.disable_jit():
        jf, j, jtok, jpos = jmodel.prefill_batch_paged(
            jp, j, jnp.asarray(prompts), jnp.asarray(slots),
            jnp.asarray(lengths), jax.random.key(0), jnp.asarray(temp),
            jnp.asarray(tk), jnp.asarray(tp_), jnp.zeros(3, jnp.int32),
            jnp.zeros(3, jnp.int32), jsc, write_starts=jnp.asarray(starts))
    tf, t, ttok, tpos = prefill_batch_paged(
        tp, t, torch.from_numpy(prompts), torch.from_numpy(slots),
        torch.from_numpy(lengths), torch.Generator().manual_seed(0),
        torch.from_numpy(temp), torch.from_numpy(tk), torch.from_numpy(tp_),
        torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
        tsc, write_starts=torch.from_numpy(starts))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tpos.numpy(), [3, 9, 11])
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tf.numpy()[:3], np.asarray(jf)[:3])
    assert_pools_equal(j, t)
    # slot 2's first page (physical 7) was covered by write_starts
    assert bool((t.sc[7] == 1).all()) and bool((t.sc[8] != 1).any())
    assert int((t.sc != 1).sum()) == 2 * L * KV * (3 + 3 + 9)


def test_prefill_paged_matches_jax_jitted(setup):
    jsc, tsc = cfgs(setup, "e4m3")
    jp, tp = setup[2:]
    j, t = pools("e4m3")
    prompt = np.array(PROMPT + [0] * 5, np.int32)
    jl, j = jmodel.prefill_paged(jp, j, jnp.asarray(prompt), jnp.int32(1),
                                 jnp.int32(len(PROMPT)), jsc)
    tl, t = prefill_paged(tp, t, torch.from_numpy(prompt), 1, len(PROMPT),
                          tsc)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() \
        <= JIT_TOL * np.abs(np.asarray(jl)).max()
    written_j = np.asarray(j.sc) != 1
    np.testing.assert_array_equal(t.sc.numpy() != 1, written_j)
    assert (raw(t.pool) == raw(j.pool)).mean() >= 0.95


# -- decode: two chunks, every mode, both references -------------------------------

def _two_chunks_jax(setup, impl, jit):
    jsc, _ = cfgs(setup, "int8", impl)
    jp = setup[2]
    j, _ = pools("int8")
    tok, pos = jnp.asarray([3, 4], jnp.int32), jnp.asarray([5, 2], jnp.int32)
    zero = jnp.zeros(2, jnp.float32)

    def run():
        t1, p1 = jmodel.decode_steps_paged(jp, j, tok, pos, jax.random.key(0),
                                           zero, 3, jsc, greedy_only=True)
        t2, p2 = jmodel.decode_steps_paged(jp, p1, t1[:, -1], pos + 3,
                                           jax.random.key(1), zero, 2, jsc,
                                           greedy_only=True)
        l3, p3 = jmodel.decode_step_paged(jp, p2, t2[:, -1], pos + 5, jsc)
        return np.asarray(t1), np.asarray(t2), np.asarray(l3), p3

    if jit:
        return run()
    with jax.disable_jit():
        return run()


def _two_chunks_port(setup, impl, feed):
    """The port over the same two chunks and the final step, fed JAX's
    tokens at the chunk boundaries (``feed``), so both sides see one
    context."""
    _, tsc = cfgs(setup, "int8", impl)
    tp = setup[3]
    _, t = pools("int8")
    tok = torch.tensor([3, 4], dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    zero = torch.zeros(2)
    t1, t = decode_steps_paged(tp, t, tok, pos, None, zero, 3, tsc,
                               greedy_only=True)
    t2, t = decode_steps_paged(tp, t, torch.from_numpy(feed[0][:, -1].copy()),
                               pos + 3, None, zero, 2, tsc, greedy_only=True)
    l3, t = decode_step_paged(tp, t, torch.from_numpy(feed[1][:, -1].copy()),
                              pos + 5, tsc)
    return t1.numpy(), t2.numpy(), l3.numpy(), t


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_two_chunks_match_jax_unjitted(setup, impl):
    """Against the un-jitted JAX functions: the final logits within
    EAGER_TOL, the pool after 6 written tokens almost byte for byte.  The
    first chunk's tokens are equal unless a step's top-2 margin is inside
    the tolerance (none is, for these inputs)."""
    j1, j2, jl, jpool = _two_chunks_jax(setup, impl, jit=False)
    t1, t2, tl, tpool = _two_chunks_port(setup, impl, (j1, j2))
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    assert np.abs(tl - jl).max() <= EAGER_TOL * np.abs(jl).max()
    np.testing.assert_array_equal(tpool.sc.numpy() != 1,
                                  np.asarray(jpool.sc) != 1)
    assert (raw(tpool.pool) == raw(jpool.pool)).mean() >= 0.99
    np.testing.assert_allclose(tpool.sc.numpy(), np.asarray(jpool.sc),
                               rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_two_chunks_match_jax_jitted(setup, impl):
    """Against the jitted JAX functions (what a user of the JAX package
    runs): logits within JIT_TOL; tokens by the margin rule, a step whose
    JAX top-2 margin is inside the tolerance may flip."""
    j1, j2, jl, jpool = _two_chunks_jax(setup, impl, jit=True)
    t1, t2, tl, tpool = _two_chunks_port(setup, impl, (j1, j2))
    assert np.abs(tl - jl).max() <= JIT_TOL * np.abs(jl).max()
    assert t1.shape == j1.shape == (2, 3) and t2.shape == j2.shape == (2, 2)
    # the first token of each chunk follows from identical contexts
    top2 = np.sort(jl, axis=-1)[:, -2:]
    safe = (top2[:, 1] - top2[:, 0]) > 2 * JIT_TOL * np.abs(jl).max()
    assert (tl.argmax(-1) == jl.argmax(-1))[safe].all()
    assert (t1[:, 0] == j1[:, 0]).all()
    np.testing.assert_array_equal(tpool.sc.numpy() != 1,
                                  np.asarray(jpool.sc) != 1)
    assert (raw(tpool.pool) == raw(jpool.pool)).mean() >= 0.85


def _port_chunks(setup, impl, kv_fmt="int8"):
    _, tsc = cfgs(setup, kv_fmt, impl)
    tp = setup[3]
    _, t = pools(kv_fmt)
    tok = torch.tensor([3, 4], dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    zero = torch.zeros(2)
    t1, t = decode_steps_paged(tp, t, tok, pos, None, zero, 8, tsc,
                               greedy_only=True)
    t2, t = decode_steps_paged(tp, t, t1[:, -1], pos + 8, None, zero, 4, tsc,
                               greedy_only=True)
    return t1, t2, t


def test_side_equals_side_eager_bit_for_bit(setup):
    """Within a chunk the side buffer covers the fresh tokens, so WHEN the
    pool is written cannot be observed: tokens and pool bytes are equal."""
    a1, a2, pa = _port_chunks(setup, "side")
    b1, b2, pb = _port_chunks(setup, "side-eager")
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert torch.equal(pa.pool, pb.pool) and torch.equal(pa.sc, pb.sc)


@pytest.mark.parametrize("impl", ["kernel", "ringview", "scatter"])
def test_every_impl_matches_side(setup, impl):
    """The same greedy tokens and (up to rare bf16 flips) the same pool as
    "side", as tests/test_serve.py::test_paged_impl_matches_side holds."""
    a1, a2, pa = _port_chunks(setup, "side", "e4m3")
    b1, b2, pb = _port_chunks(setup, impl, "e4m3")
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert (raw(pa.pool) != raw(pb.pool)).mean() < 0.01
    np.testing.assert_allclose(pa.sc.numpy(), pb.sc.numpy(), rtol=2e-2)


def test_paged_equals_ring_tokens_while_context_fits_both(setup):
    _, tsc = cfgs(setup, "e4m3")
    tp = setup[3]
    tok = torch.tensor([3, 4], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    ring = RingKVCache.create(L, 2, 32, KV, D, "e4m3", device="cpu")
    want, _ = decode_steps(tp, ring, tok, pos, None, torch.zeros(2), 8, tsc,
                           greedy_only=True)
    _, t = pools("e4m3")
    got, _ = decode_steps_paged(tp, t, tok, pos, None, torch.zeros(2), 8, tsc,
                                greedy_only=True)
    assert torch.equal(got, want)


def test_decode_chunk_paged_carry_and_logprobs(setup):
    _, tsc = cfgs(setup, "int8", "kernel")
    tp = setup[3]
    _, ta = pools("int8")
    _, tb = pools("int8")
    tok = torch.tensor([11, 29], dtype=torch.int32)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    toks, lps, ta, ftok, fpos = decode_chunk_paged(
        tp, ta, tok, pos, None, torch.zeros(2), 5, tsc, greedy_only=True)
    cur, p, seq, seq_lp = tok, pos, [], []
    for _ in range(5):
        logits, tb = decode_step_paged(tp, tb, cur, p, tsc)
        cur = logits.argmax(-1).to(torch.int32)
        seq.append(cur)
        seq_lp.append(torch.log_softmax(logits, -1).gather(
            -1, cur[:, None].long())[:, 0])
        p = p + 1
    # One chunk of 5 reads its own tokens from the side buffer; 5 chunks of
    # 1 read them back from the pool through K4's recurrence: the same keys
    # in another grouping, so contexts differ by bf16 steps.
    assert torch.equal(toks, torch.stack(seq, 1))
    torch.testing.assert_close(lps, torch.stack(seq_lp, 1), rtol=0, atol=3e-2)
    assert torch.equal(ftok, cur) and torch.equal(fpos, p)
    assert (raw(ta.pool) == raw(tb.pool)).mean() >= 0.97   # 31% is written
    assert torch.equal(ta.sc != 1, tb.sc != 1)


def test_context_beyond_a_ring(setup):
    """24 prompt tokens in pages of 8: a decode step at position 24 attends
    to all of them (a ring of 16 would have slid past the first 8), and
    agrees with JAX's paged step and with the dense forward."""
    jsc, tsc = cfgs(setup, "e4m3", "kernel")
    jp, tp = setup[2:]
    total = 24
    prompt = ((np.arange(total) * 7 + 3) % 128).astype(np.int32)
    j, t = pools("e4m3", n_slots=1, n_pages=8)
    padded = np.concatenate([prompt, np.zeros(8, np.int32)])
    _, j = jmodel.prefill_paged(jp, j, jnp.asarray(padded), jnp.int32(0),
                                jnp.int32(total), jsc)
    _, t = prefill_paged(tp, t, torch.from_numpy(padded), 0, total, tsc)
    jl, _ = jmodel.decode_step_paged(jp, j, jnp.asarray(prompt[-1:]),
                                     jnp.asarray([total], jnp.int32), jsc)
    tl, t = decode_step_paged(tp, t, torch.from_numpy(prompt[-1:].copy()),
                              torch.tensor([total], dtype=torch.int32), tsc)
    jl, tl = np.asarray(jl)[0], tl.numpy()[0]
    assert np.abs(tl - jl).max() <= JIT_TOL * np.abs(jl).max()
    seq = torch.from_numpy(np.concatenate([prompt, prompt[-1:]]))
    dense = tmodel.full_logits(tp, seq, tsc)[-1].numpy()
    assert np.corrcoef(tl, dense)[0, 1] > 0.98
    # forgetting the first page changes the answer: the step looked at it
    t.page_table = torch.tensor([[7, 1, 2, 3]], dtype=torch.int32)
    tl2, _ = decode_step_paged(tp, t, torch.from_numpy(prompt[-1:].copy()),
                               torch.tensor([total], dtype=torch.int32), tsc)
    assert np.abs(tl2.numpy()[0] - tl).max() > 1e-3 * np.abs(tl).max()


@pytest.mark.parametrize("impl", ["ringview", "kernel", "side-eager"])
def test_overrun_writes_dropped(setup, impl):
    """A slot decoding past its mapped pages or past max_seq must not touch
    another slot's pages (tests/test_serve.py:340)."""
    _, tsc = cfgs(setup, "e4m3", impl)
    tp = setup[3]
    table = np.array([[0, 1], [2, -1], [3, 4]], np.int32)
    _, t = pools("e4m3", n_slots=3, n_pages=16, max_pages=2, table=table)
    before = t.pool.clone()
    # slot 0 at 3 (page 0), slot 1 at 12 (unmapped page), slot 2 at 16 (= max_seq)
    _, t = decode_step_paged(tp, t, torch.tensor([5, 6, 7], dtype=torch.int32),
                             torch.tensor([3, 12, 16], dtype=torch.int32),
                             tsc)
    changed = (raw(t.pool) != raw(before)).reshape(16, -1).any(axis=1)
    assert changed[0] and not changed[1:].any()


def test_unknown_impl_and_cpu_device_rules(setup, monkeypatch):
    tp = setup[3]
    _, t = pools("int8")
    tok = torch.zeros(2, dtype=torch.int32)
    bad = ServeConfig(model=setup[1], kv_fmt="int8",
                      paged_decode_impl="pages")
    with pytest.raises(ValueError, match="paged_decode_impl"):
        decode_step_paged(tp, t, tok, tok, bad)
    assert ServeConfig(model=setup[1]).paged_decode_impl == "ringview"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: PagedKVCache.create(2, 4, 1, 1, 2, 2, 16),
                 lambda: paged_from_jax(np.zeros((1, 2, 1, 8, 16), np.int8),
                                        np.ones((1, 2, 1, 8), np.float32),
                                        np.zeros((1, 1), np.int32), 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
