"""Port parity for K4's plain version: fp8tpu_torch.kernels.paged_attention
against the Pallas kernel of fp8tpu.kernels.paged_attention in interpret
mode, on the same numpy-seeded inputs, and the merged context of
``_attend_paged_kernel`` against ``_attend_paged`` and the JAX pair.

m is a max of scores, each an f32 sum of D exact bf16 x payload products
times one f32 scale.  Two implementations add those products in different
orders, so m is bit-equal only where every partial sum is exact: the "exact"
inputs put q on a 1/8 grid and the payload on a grid coarse enough for that.
The "gaussian" inputs are ordinary data, where the stated summation-order
bound holds instead.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from fp8tpu.kernels.paged_attention import paged_decode_attention as j_k4
from fp8tpu.models.transformer import tiny_config as j_tiny_config
from fp8tpu.serve import PagedKVCache as JPaged
from fp8tpu.serve import model as jmodel
from fp8tpu_torch.kernels import paged_attention as k4
from fp8tpu_torch.models import tiny_config
from fp8tpu_torch.serve import PagedKVCache
from fp8tpu_torch.serve import model as tmodel
from fp8tpu_torch.serve.model import _tensor_from_array

NP_DTYPES = {"int8": np.int8, "e4m3": ml_dtypes.float8_e4m3fn,
             "e5m2": ml_dtypes.float8_e5m2, "bf16": ml_dtypes.bfloat16}
PAGE, KV, G, LAYERS = 8, 2, 2, 2


def make_case(seed, batch, max_pages, d, fmt, exact):
    """Pool, scales, a shuffled table with -1 entries, ragged lengths with a
    0 and a mid-page end, queries; as numpy / ml_dtypes arrays."""
    rng = np.random.default_rng(seed)
    P, R = batch * max_pages + 1, PAGE * KV
    shape = (P, 2, LAYERS, R, d)
    if fmt == "int8":
        pool = rng.integers(-127, 128, shape).astype(np.int8)
    elif exact:
        pool = (rng.integers(-15, 16, shape) * 0.25).astype(NP_DTYPES[fmt])
    else:
        pool = (rng.standard_normal(shape) * 3).astype(np.float32).astype(
            NP_DTYPES[fmt])
    sc = rng.uniform(0.004, 0.02, (P, 2, LAYERS, R)).astype(np.float32)
    if exact:
        q = (rng.integers(-16, 17, (batch, KV * G, d)) / 8.0)
    else:
        q = rng.standard_normal((batch, KV * G, d)) * 0.7
    q = q.astype(np.float32).astype(ml_dtypes.bfloat16)
    full = max_pages * PAGE
    lens = np.array([0, PAGE + 3, full][:batch], np.int32)
    table = rng.permutation(P)[:batch * max_pages].reshape(
        batch, max_pages).astype(np.int32)
    mapped = np.arange(max_pages)[None] * PAGE < lens[:, None]
    table = np.where(mapped, table, -1).astype(np.int32)
    return q, pool, sc, table, lens


def run_both(case, layer):
    q, pool, sc, table, lens = case
    want = j_k4(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(sc),
                jnp.asarray(table), jnp.asarray(lens),
                jnp.asarray([layer], jnp.int32), page_size=PAGE, kv_heads=KV,
                interpret=True)
    got = k4.paged_decode_attention(
        *(_tensor_from_array(a, "cpu") for a in case), layer,
        page_size=PAGE, kv_heads=KV)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def bounds(case, layer):
    """|port - JAX| allowed: scores differ by at most s_tol = 2 D 2^-24
    max_t(sum_d |q k| ks) (summation order), so p = exp(s - m) by 2 s_tol
    relative, and p * vs rounded to bf16 by one more bf16 step (2^-7):
    |l - l'| <= l (2 s_tol + T 2^-22), |acc - acc'| <= A (2 s_tol + 2^-7 +
    T 2^-22) with A = sum_t pv_t |v_td| (computed here in float64)."""
    q, pool, sc, table, lens = case
    B, KVG, D = q.shape
    MP = table.shape[1]
    T = MP * PAGE
    safe = np.maximum(table, 0)
    qh = q.astype(np.float64).reshape(B, KV, G, D)
    k = pool[safe, 0, layer].astype(np.float64).reshape(B, T, KV, D)
    v = pool[safe, 1, layer].astype(np.float64).reshape(B, T, KV, D)
    ks = sc[safe, 0, layer].astype(np.float64).reshape(B, T, KV)
    vs = sc[safe, 1, layer].astype(np.float64).reshape(B, T, KV)
    mask = (np.arange(T)[None] < lens[:, None])[:, None, None, :]
    s = np.einsum("bkgd,btkd->bkgt", qh, k) * ks.transpose(0, 2, 1)[:, :, None]
    s_abs = np.einsum("bkgd,btkd->bkgt", np.abs(qh), np.abs(k)) \
        * ks.transpose(0, 2, 1)[:, :, None]
    s_tol = 2.0 * D * 2.0 ** -24 * np.where(mask, s_abs, 0).max(-1)
    m = np.where(mask, s, -1e30).max(-1)
    p = np.exp(np.where(mask, s - m[..., None], -np.inf))
    pv = p * vs.transpose(0, 2, 1)[:, :, None]
    a_abs = np.einsum("bkgt,btkd->bkgd", pv, np.abs(v))
    rel = 2 * s_tol + T * 2.0 ** -22
    return (s_tol.reshape(B, KVG), (p.sum(-1) * rel).reshape(B, KVG) + 1e-30,
            (a_abs * (rel + 2.0 ** -7)[..., None]).reshape(B, KVG, D) + 1e-30)


SHAPES = [(2, 3, 16), (3, 4, 32)]


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("fmt", ["int8", "e4m3"])
@pytest.mark.parametrize("batch,max_pages,d", SHAPES)
def test_plain_matches_pallas_interpret_exact_dots(batch, max_pages, d, fmt,
                                                   layer):
    case = make_case(7, batch, max_pages, d, fmt, exact=True)
    (acc_w, m_w, l_w), (acc_g, m_g, l_g) = run_both(case, layer)
    assert acc_g.shape == acc_w.shape == (batch, KV * G, d)
    assert m_g.dtype == l_g.dtype == acc_g.dtype == np.float32
    np.testing.assert_array_equal(m_g.view(np.uint32), m_w.view(np.uint32))
    _, l_tol, acc_tol = bounds(case, layer)
    assert (np.abs(l_g - l_w) <= l_tol).all()
    assert (np.abs(acc_g - acc_w) <= acc_tol).all()
    # the empty slot: the sentinel, and nothing accumulated
    assert (m_g[0] == np.float32(-1e30)).all()
    assert (l_g[0] == 0).all() and (acc_g[0] == 0).all()


@pytest.mark.parametrize("fmt", ["int8", "e4m3", "e5m2", "bf16"])
@pytest.mark.parametrize("batch,max_pages,d", SHAPES)
def test_plain_matches_pallas_interpret_gaussian(batch, max_pages, d, fmt):
    case = make_case(11, batch, max_pages, d, fmt, exact=False)
    (acc_w, m_w, l_w), (acc_g, m_g, l_g) = run_both(case, 1)
    m_tol, l_tol, acc_tol = bounds(case, 1)
    assert np.isfinite(acc_g).all()
    assert (np.abs(m_g - m_w) <= m_tol).all()
    assert (np.abs(l_g - l_w) <= l_tol).all()
    assert (np.abs(acc_g - acc_w) <= acc_tol).all()


def test_unmapped_pages_read_page_zero_and_lens_masks():
    """A table row of -1 with a non-zero length (a retired slot that keeps
    decoding) reads page 0, as the JAX index maps clamp it; tokens at or
    past ``lens`` change nothing."""
    case = list(make_case(3, 2, 3, 16, "int8", exact=True))
    case[3][1] = -1
    (acc_w, m_w, l_w), (acc_g, m_g, l_g) = run_both(case, 0)
    np.testing.assert_array_equal(m_g.view(np.uint32), m_w.view(np.uint32))
    _, l_tol, acc_tol = bounds(case, 0)
    assert (np.abs(l_g - l_w) <= l_tol).all()
    assert (np.abs(acc_g - acc_w) <= acc_tol).all()


def test_rows_past_lens_are_invisible():
    """Slot 1 ends mid-page (lens = PAGE + 3): the rest of that page may
    hold anything without changing a bit of the result."""
    q, pool, sc, table, lens = make_case(3, 2, 3, 16, "e4m3", exact=False)
    _, first = run_both((q, pool, sc, table, lens), 1)
    pool2, sc2 = pool.copy(), sc.copy()
    pool2[table[1, 1], :, :, 3 * KV:] = 1.0
    sc2[table[1, 1], :, :, 3 * KV:] = 1e9
    _, second = run_both((q, pool2, sc2, table, lens), 1)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_wrapper_checks_shapes_and_counts_no_launch_on_cpu():
    case = [_tensor_from_array(a, "cpu")
            for a in make_case(5, 2, 3, 16, "int8", True)]
    before = k4.launches
    k4.paged_decode_attention(*case, 0, page_size=PAGE, kv_heads=KV)
    assert k4.launches == before
    with pytest.raises(ValueError, match="layer"):
        k4.paged_decode_attention(*case, LAYERS, page_size=PAGE, kv_heads=KV)
    with pytest.raises(ValueError, match="page_size"):
        k4.paged_decode_attention(*case, 0, page_size=PAGE + 1, kv_heads=KV)
    q, pool, sc, table, lens = case
    with pytest.raises(ValueError, match="int8, e4m3"):
        k4.paged_decode_attention(q, pool.to(torch.int32), sc, table, lens, 0,
                                  page_size=PAGE, kv_heads=KV)
    with pytest.raises(ValueError, match="lens"):
        k4.paged_decode_attention(q, pool, sc, table, lens[:1], 0,
                                  page_size=PAGE, kv_heads=KV)
    assert k4.n_splits(8, 8, 128, 132) == 2      # no more than the rounds
    assert k4.n_splits(8, 8, 512, 132) == 4      # one wave of 2 an SM
    assert k4.n_splits(2, 8, 1024, 132) == 16
    assert k4.n_splits(64, 8, 1024, 132) == 1    # enough pairs already
    assert k4.n_splits(1, 1, 128 * 64, 132) == k4.MAX_SPLITS


# -- the merged context ----------------------------------------------------------

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, max_seq_len=32)


def _attend_inputs(kv_fmt, w):
    """A pool with some context, a side buffer with ``w`` live rows, fresh
    k/v and queries for 2 slots of the tiny model (H 4, KV 2, D 16)."""
    rng = np.random.default_rng(19)
    B, H, D, W, MP = 2, 4, 16, 4, 3
    q, pool, sc, table, _ = make_case(23, B, MP, D, kv_fmt, exact=False)
    lens = np.array([PAGE + 3, 2 * PAGE], np.int32)
    table = np.arange(B * MP, dtype=np.int32).reshape(B, MP)
    dt = NP_DTYPES[kv_fmt]

    def payload(shape):
        if kv_fmt == "int8":
            return rng.integers(-127, 128, shape).astype(np.int8)
        return (rng.standard_normal(shape) * 3).astype(np.float32).astype(dt)

    return dict(
        q=(rng.standard_normal((B, H, D))).astype(np.float32).astype(
            ml_dtypes.bfloat16),
        kq8=payload((B, KV, D)), vq8=payload((B, KV, D)),
        kqs=rng.uniform(0.004, 0.02, (B, KV)).astype(np.float32),
        vqs=rng.uniform(0.004, 0.02, (B, KV)).astype(np.float32),
        pool=pool, sc=sc, table=table, lens=lens,
        sk8=payload((W, B * KV, D)), sv8=payload((W, B * KV, D)),
        sks=rng.uniform(0.004, 0.02, (W, B * KV)).astype(np.float32),
        svs=rng.uniform(0.004, 0.02, (W, B * KV)).astype(np.float32), w=w)


@pytest.mark.parametrize("w", [0, 3])
@pytest.mark.parametrize("kv_fmt", ["int8", "e4m3"])
def test_attend_paged_kernel_matches_attend_paged_and_jax(kv_fmt, w):
    """The merge of K4's partials with the fresh token and the side buffer
    (``_attend_paged_kernel``) against the snapshot attention
    (``_attend_paged``) and against the JAX pair, layer 1.  The context is
    bf16: 2^-7 relative, plus the summation-order terms, of the largest
    |context| component."""
    a = _attend_inputs(kv_fmt, w)
    jcfg, tcfg = j_tiny_config(**TINY), tiny_config(**TINY)
    li = 1
    jp = JPaged(pool=jnp.asarray(a["pool"]), sc=jnp.asarray(a["sc"]),
                page_table=jnp.asarray(a["table"]), kv_heads=KV)
    side_keys = ("sk8", "sks", "sv8", "svs")
    fresh_keys = ("q", "kq8", "kqs", "vq8", "vqs")
    jside = {k: jnp.asarray(a[k]) for k in side_keys}
    jfresh = [jnp.asarray(a[k]) for k in fresh_keys]
    with jax.disable_jit():
        want_k = jmodel._attend_paged_kernel(
            *jfresh, jp, jnp.int32(li), jnp.asarray(a["lens"]), jcfg,
            w=jnp.int32(w), **jside)
        kvp, scp = jp.gather()
        want_s = jmodel._attend_paged(
            *jfresh, kvp[:, :, 0, li], scp[:, :, 0, li], kvp[:, :, 1, li],
            scp[:, :, 1, li], jnp.asarray(a["lens"]), PAGE, jcfg,
            w=jnp.int32(w), **jside)
    t = {k: _tensor_from_array(v, "cpu") if isinstance(v, np.ndarray) else v
         for k, v in a.items()}
    tp = PagedKVCache(pool=t["pool"], sc=t["sc"], page_table=t["table"],
                      kv_heads=KV)
    tside = {k: t[k] for k in side_keys}
    tfresh = [t[k] for k in fresh_keys]
    got_k = tmodel._attend_paged_kernel(*tfresh, tp, li, t["lens"], tcfg,
                                        w=w, **tside)
    kvp, scp = tp.gather()
    got_s = tmodel._attend_paged(
        *tfresh, kvp[:, :, 0, li], scp[:, :, 0, li], kvp[:, :, 1, li],
        scp[:, :, 1, li], t["lens"], PAGE, tcfg, w=w, **tside)
    assert got_k.dtype == torch.bfloat16 and tuple(got_k.shape) == (2, 64)
    got_k, got_s = got_k.float().numpy(), got_s.float().numpy()
    want_k = np.asarray(want_k.astype(jnp.float32))
    want_s = np.asarray(want_s.astype(jnp.float32))
    tol = 2.0 ** -6 * np.abs(want_s).max()
    for got, want in ((got_k, want_k), (got_s, want_s), (got_k, got_s),
                      (want_k, want_s)):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= tol
