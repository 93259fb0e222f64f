"""Port parity for the serving decoder: fp8tpu_torch.serve against
fp8tpu.serve on the tiny model, from the same artifact and tokens.

Two references.  (1) The JAX functions as the package runs them, jitted:
XLA's fusion elides some bf16 roundings between fused ops (a
f32 -> bf16 -> f32 convert pair disappears), so its logits differ from the
source's op-by-op arithmetic by a few bf16 steps.  (2) The same functions
under ``jax.disable_jit()``, where every rounding the source writes is
kept: the port follows the source, so it agrees with this one much more
tightly (layer by layer it is bit-equal until summation order intervenes).
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
from fp8tpu.serve import RingKVCache as JRing
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import convert_decoder_params as j_convert
from fp8tpu.serve import model as jmodel
from fp8tpu.serve import quantize_kv as j_quantize_kv
from fp8tpu_torch.kernels import inplace, int4_matmul, qmatmul
from fp8tpu_torch.models import Decoder, tiny_config, variables_from_flax
from fp8tpu_torch.serve import (KVCache, RingKVCache, ServeConfig,
                                convert_decoder_params, decode_chunk,
                                decode_step, decode_steps, full_logits,
                                prefill, prefill_batch, quantize_kv,
                                random_serve_params, ring_from_jax,
                                serve_params_from_jax)
from fp8tpu_torch.serve import model as tmodel

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, max_seq_len=32)
S = 32                          # ring size
# Logits against the jitted JAX functions, relative to max|logit|: bf16
# activations through 2 layers, with XLA eliding roundings the port keeps
# (measured 0.8e-2 to 2.8e-2 over the format pairs below; e5m2 KV, with 2
# mantissa bits, is the widest).
JIT_TOL = 4e-2
# Against the un-jitted JAX functions only summation order and 1-ulp
# rsqrt / exp / sin differences remain, and the rare bf16 step they cause
# (measured: 0 for e4m3 + int8 KV and int4 + e4m3 KV, 2.3e-3 for bf16 +
# bf16).
EAGER_TOL = 4e-3


def raw(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, tcfg = j_tiny_config(**TINY), tiny_config(**TINY)
    jm = JDecoder(jcfg)
    v = jm.init(jax.random.key(0), jnp.arange(16)[None] % 128)
    tm = Decoder(tcfg)
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    return jcfg, tcfg, v, tm


@functools.lru_cache(maxsize=None)
def _artifact(fmt, embed_fmt="bf16", group=32):
    jcfg, _, v, _ = _models()
    jp = j_convert(v, jcfg, fmt=fmt, embed_fmt=embed_fmt, int4_group=group)
    tp = serve_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _cfgs(fmt, kv_fmt, embed_fmt="bf16"):
    jcfg, tcfg, _, _ = _models()
    kw = dict(weight_fmt=fmt, kv_fmt=kv_fmt, embed_fmt=embed_fmt)
    return JServeConfig(model=jcfg, **kw), ServeConfig(model=tcfg, **kw)


# -- quantizers and artifacts: bit-equal ---------------------------------------

@pytest.mark.parametrize("fmt", ["int8", "e4m3", "e5m2", "bf16"])
def test_quantize_kv_bit_equal(rng, fmt):
    x = (rng.standard_normal((3, 5, 2, 16)) * 3).astype(np.float32)
    x[1, 2, 0] = 0.0                                   # a zero vector
    x[0, 0, 1, 3] = 1e4                                # an outlier
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jp, js = j_quantize_kv(xb, fmt)
    tp, ts = quantize_kv(tmodel._tensor_from_array(np.asarray(xb), "cpu"),
                         fmt)
    assert tuple(ts.shape) == js.shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(raw(tp), raw(jp))
    np.testing.assert_array_equal(raw(ts), raw(js))


# Rows whose amax or scale XLA flushes, and non-finite elements: the
# quantizers flush a subnormal amax as XLA does (scale 1, zero payload),
# keep the finite scale where XLA flushes amax / max to 0 (the JAX
# package then stores +-max and NaN payloads), and give e5m2 NaNs XLA's
# bits (0x7E / 0xFE).
FLUSH_ROWS = {
    "subnormal amax": [1e-39, 0.0, 0.0, 0.0],
    "subnormal scale": [1e-37, -3e-38, 2e-38, 0.0],
    "nan": [np.nan, 1.0, -2.0, 0.0],
    "inf": [np.inf, 1.0, 0.0, -3.0],
    "-inf": [-np.inf, 0.5, 0.0, 0.0],
}
FLUSH_QUANTIZERS = [("kv", "int8"), ("kv", "e4m3"), ("kv", "e5m2"),
                    ("weights", "int8"), ("weights", "e4m3"),
                    ("weights", "e5m2"), ("int4", None), ("int4", 2),
                    ("int4_grouped", 2)]
FLUSH_CASES = [(which, fmt, row) for which, fmt in FLUSH_QUANTIZERS
               for row in FLUSH_ROWS
               if row.startswith("subnormal") or fmt in ("e4m3", "e5m2")]


def _quantize_both(which, fmt, x):
    """(JAX payload, JAX scale, port payload, port scale) of one quantizer
    on the column (or head vector) ``x``, beside a normal column."""
    from fp8tpu.kernels import int4_matmul as j_int4
    from fp8tpu.kernels import qmatmul as j_qmatmul
    if which == "kv":
        v = x.reshape(1, 1, 4)
        with jax.disable_jit():
            jp, js = j_quantize_kv(jnp.asarray(v), fmt)
        tp, ts = quantize_kv(torch.from_numpy(v), fmt)
        return jp, js, tp, ts
    w = np.stack([x, np.float32([0.5, -1.0, 2.0, 3.0])], axis=1)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    with jax.disable_jit():
        if which == "weights":
            jp, js = j_qmatmul.quantize_weights(jw, fmt)
        elif which == "int4":
            jp, js = jmodel.quantize_weights_int4(jw, fmt)
        else:
            jp, js = j_int4.quantize_weights_int4_grouped(jw, fmt)
    if which == "weights":
        tp, ts = qmatmul.quantize_weights(tw, fmt)
    elif which == "int4":
        tp, ts = tmodel.quantize_weights_int4(tw, fmt)
    else:
        tp, ts = int4_matmul.quantize_weights_int4_grouped(tw, fmt)
    return jp, js, tp, ts


@pytest.mark.parametrize("which,fmt,row", FLUSH_CASES)
def test_quantizers_flush_like_xla(which, fmt, row):
    """The three rows of the serving quantizers' flush fault against the
    un-jitted JAX functions: byte-equal, except where XLA flushes a
    normal amax's scale to 0, where the port keeps amax / max."""
    x = np.float32(FLUSH_ROWS[row])
    jp, js, tp, ts = _quantize_both(which, fmt, x)
    js, ts_np = np.asarray(js, np.float32), ts.numpy()
    flushed = (js == 0) & (ts_np != 0)
    if row != "subnormal scale" or not flushed.any():
        np.testing.assert_array_equal(raw(tp), raw(jp))
        np.testing.assert_array_equal(raw(ts), raw(js))
        return
    # where XLA flushed the scale: the port's is positive and finite, and
    # every other scale is bit-equal
    assert np.isfinite(ts_np[flushed]).all() and (ts_np[flushed] > 0).all()
    np.testing.assert_array_equal(ts_np[~flushed].view(np.uint32),
                                  js[~flushed].view(np.uint32))
    if which in ("kv", "weights"):
        assert np.isfinite(tp.to(torch.float32).numpy()).all()
        back = (tp.to(torch.float32) * ts).numpy().reshape(-1, 4) \
            if which == "kv" else (tp.to(torch.float32) * ts)[:, 0].numpy()
        # one payload step at the amax: 1/127 of it, or 2^-mantissa bits
        step = 1e-37 * {"int8": 1 / 127, "e4m3": 2 ** -3,
                        "e5m2": 2 ** -2}[fmt]
        assert np.abs(back.reshape(-1) - x).max() <= step


ARTIFACTS = [("e4m3", "bf16", 32), ("int8", "bf16", 32), ("int4", "bf16", 32),
             ("int4", "bf16", None), ("bf16", "bf16", 32),
             ("e5m2", "e4m3", 32), ("e4m3", "int8", 32)]


@pytest.mark.parametrize("fmt,embed_fmt,group", ARTIFACTS)
def test_convert_decoder_params_bit_equal(fmt, embed_fmt, group):
    _, tcfg, _, tm = _models()
    jp, _ = _artifact(fmt, embed_fmt, group)
    tp = convert_decoder_params(tm.state_dict(), tcfg, fmt=fmt,
                                embed_fmt=embed_fmt, int4_group=group)
    assert set(tp) == set(jp)
    for k, want in jp.items():
        got = tp[k]
        assert tuple(got.shape) == want.shape, k
        assert str(got.dtype).split(".")[1].replace("fn", "") \
            == want.dtype.name.replace("fn", ""), (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(raw(got), raw(want), err_msg=k)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8", "int4", "bf16"])
def test_serve_params_from_jax_keeps_every_byte(fmt):
    jp, tp = _artifact(fmt)
    want_dtype = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
                  "int8": torch.int8, "int4": torch.uint8,
                  "bf16": torch.bfloat16}[fmt]
    assert tp["gate8"].dtype == want_dtype
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["qs"].dtype == torch.float32
    for k in jp:
        np.testing.assert_array_equal(raw(tp[k]), raw(jp[k]), err_msg=k)


def test_ring_from_jax():
    jr = JRing.create(2, 2, S, 2, 16, "e4m3")
    jr = dataclasses.replace(jr, head=jnp.int32(5))
    tr = ring_from_jax(np.asarray(jr.kv8), np.asarray(jr.sc),
                       np.asarray(jr.head), device="cpu")
    assert tr.kv8.dtype == torch.float8_e4m3fn and tr.fmt == "e4m3"
    assert tr.max_seq == S and int(tr.head) == 5
    assert tr.head.dtype == torch.int32
    np.testing.assert_array_equal(raw(tr.sc), raw(jr.sc))


def test_random_serve_params_shapes_and_seed():
    _, tcfg, _, _ = _models()
    a = random_serve_params(tcfg, "e4m3", seed=3, device="cpu")
    b = random_serve_params(tcfg, "e4m3", seed=3, device="cpu")
    jp, _ = _artifact("e4m3")
    assert {k: tuple(v.shape) for k, v in a.items()} \
        == {k: v.shape for k, v in jp.items()}
    assert a["q8"].dtype == torch.float8_e4m3fn
    assert all(torch.equal(raw_t(a[k]), raw_t(b[k])) for k in a)
    g = random_serve_params(tcfg, "int4", embed_fmt="e4m3", device="cpu")
    assert g["gate8"].dtype == torch.uint8 and g["gate8"].shape == (2, 32, 128)
    assert g["gates"].shape == (2, 1, 128) and "embed_s" in g


def raw_t(t):
    return t.contiguous().view(torch.uint8)


# -- prefill + decode against JAX ----------------------------------------------

PROMPT = [3, 14, 15, 92, 65, 35]


def _run_both(fmt, kv_fmt, n_steps=8, embed_fmt="bf16"):
    """Prefill slot 0 with PROMPT, then ``n_steps`` decode steps of two
    slots (slot 1 starts empty), feeding both sides JAX's greedy tokens.
    Returns per-call (jax logits, port logits) and both rings."""
    jp, tp = _artifact(fmt, embed_fmt)
    jsc, tsc = _cfgs(fmt, kv_fmt, embed_fmt)
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


def _check_run(pairs, jr, tr, tol, min_equal, scale_steps=1):
    for step, (want, got) in enumerate(pairs):
        assert got.shape == want.shape and np.isfinite(got).all()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, (step, err)
    assert int(tr.head) == int(jr.head) == len(pairs) - 1
    # the ring: scales within ``scale_steps`` bf16 steps (a scale is the
    # largest |k| or |v| of a bf16 head vector over a constant), payload
    # bytes mostly equal (a k or v that differs by one bf16 step re-rounds
    # a few elements)
    np.testing.assert_allclose(f32(tr.sc), f32(jr.sc),
                               rtol=scale_steps * 2.0 ** -7, atol=0)
    same = (raw(tr.kv8) == raw(jr.kv8)).mean()
    assert same >= min_equal, same


WEIGHT_CASES = [("e4m3", "int8"), ("e5m2", "int8"), ("int8", "int8"),
                ("int4", "int8"), ("bf16", "int8")]
KV_CASES = [("e4m3", "e4m3"), ("e4m3", "e5m2"), ("e4m3", "bf16"),
            ("bf16", "bf16")]


@pytest.mark.parametrize("fmt,kv_fmt", WEIGHT_CASES + KV_CASES)
def test_prefill_and_decode_match_jax_jitted(fmt, kv_fmt):
    pairs, jr, tr = _run_both(fmt, kv_fmt)
    _check_run(pairs, jr, tr, JIT_TOL, 0.85, scale_steps=3)


@pytest.mark.parametrize("fmt,kv_fmt", [("e4m3", "int8"), ("int4", "e4m3"),
                                        ("bf16", "bf16")])
def test_prefill_and_decode_match_jax_unjitted(fmt, kv_fmt):
    with jax.disable_jit():
        pairs, jr, tr = _run_both(fmt, kv_fmt, n_steps=3)
    _check_run(pairs, jr, tr, EAGER_TOL, 0.99)


def test_embed_fmt_path_matches_jax():
    pairs, jr, tr = _run_both("e4m3", "int8", n_steps=2, embed_fmt="e4m3")
    _check_run(pairs, jr, tr, JIT_TOL, 0.85, scale_steps=3)


def test_first_layer_of_prefill_is_bit_equal():
    """Against the un-jitted JAX function, layer 0's k/v see no reordered
    sum that survives the bf16 cast: payloads and scales are bit-equal."""
    jp, tp = _artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "int8")
    toks = np.array([PROMPT, PROMPT[::-1]], np.int32)
    with jax.disable_jit():
        _, jk, jks, jv, jvs = jmodel._dense_forward(jp, jnp.asarray(toks),
                                                    jsc)
    _, tk, tks, tv, tvs = tmodel._dense_forward(tp, torch.from_numpy(toks),
                                                tsc)
    assert tuple(tk.shape) == jk.shape == (2, 2, 6, 2, 16)
    for got, want in ((tk, jk), (tks, jks), (tv, jv), (tvs, jvs)):
        np.testing.assert_array_equal(raw(got[0]), raw(want[0]))


def test_decode_steps_greedy_tokens_match_under_margin_rule():
    """Greedy tokens equal JAX's up to the first step whose JAX top-2 margin
    is inside the logit tolerance (a near tie may flip; later tokens then
    follow another context)."""
    jp, tp = _artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "int8")
    n = 8
    tok = np.array([11, 29], np.int32)
    pos = np.zeros(2, np.int32)
    temp = np.zeros(2, np.float32)
    jr = JRing.create(2, 2, S, 2, 16, "int8")
    jt, _ = jmodel.decode_steps(jp, jr, jnp.asarray(tok), jnp.asarray(pos),
                                jax.random.key(0), jnp.asarray(temp), n, jsc,
                                greedy_only=True)
    tr = RingKVCache.create(2, 2, S, 2, 16, "int8", device="cpu")
    tt, tr = decode_steps(tp, tr, torch.from_numpy(tok),
                          torch.from_numpy(pos), None,
                          torch.from_numpy(temp), n, tsc, greedy_only=True)
    jt, tt = np.asarray(jt), tt.numpy()
    assert tt.shape == jt.shape == (2, n) and int(tr.head) == n
    # JAX's own margins, teacher-forced step by step
    jr = JRing.create(2, 2, S, 2, 16, "int8")
    cur, p = tok, pos
    live = np.ones(2, bool)
    for j in range(n):
        jl, jr = jmodel.decode_step(jp, jr, jnp.asarray(cur), jnp.asarray(p),
                                    jsc)
        top2 = np.sort(np.asarray(jl), axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        safe = margin > 2 * JIT_TOL * np.abs(np.asarray(jl)).max()
        for b in range(2):
            if live[b] and safe[b]:
                assert tt[b, j] == jt[b, j], (b, j, margin[b])
            elif live[b] and tt[b, j] != jt[b, j]:
                live[b] = False            # flipped on a near tie
        cur, p = jt[:, j].astype(np.int32), p + 1
    assert live.any()


# -- consistency inside the port -----------------------------------------------

def test_decode_chunk_equals_repeated_decode_step():
    _, tp = _artifact("e4m3")
    _, tsc = _cfgs("e4m3", "int8")
    tok = torch.tensor([11, 29], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    temp = torch.zeros(2)
    ra = RingKVCache.create(2, 2, S, 2, 16, "int8", device="cpu")
    toks, lps, ra, ftok, fpos = decode_chunk(tp, ra, tok, pos, None, temp, 5,
                                             tsc, greedy_only=True)
    rb = RingKVCache.create(2, 2, S, 2, 16, "int8", device="cpu")
    cur, p, seq, seq_lp = tok, pos, [], []
    for _ in range(5):
        logits, rb = decode_step(tp, rb, cur, p, tsc)
        cur = logits.argmax(-1).to(torch.int32)
        seq.append(cur)
        seq_lp.append(torch.log_softmax(logits, -1).gather(
            -1, cur[:, None].long())[:, 0])
        p = p + 1
    assert torch.equal(toks, torch.stack(seq, 1))
    torch.testing.assert_close(lps, torch.stack(seq_lp, 1), rtol=0, atol=1e-5)
    assert torch.equal(ftok, cur) and torch.equal(fpos, p)
    assert torch.equal(raw_t(ra.kv8), raw_t(rb.kv8))
    assert torch.equal(ra.sc, rb.sc) and int(ra.head) == int(rb.head) == 5


@pytest.mark.parametrize("fmt,kv_fmt", [("e4m3", "e4m3"), ("int4", "int8")])
def test_full_logits_matches_jax_and_incremental_decode(fmt, kv_fmt):
    jp, tp = _artifact(fmt)
    jsc, tsc = _cfgs(fmt, kv_fmt)
    seq = np.array(PROMPT + [89, 79], np.int32)
    want = np.asarray(jmodel.full_logits(jp, jnp.asarray(seq), jsc))
    got = full_logits(tp, torch.from_numpy(seq), tsc).numpy()
    assert got.shape == want.shape == (8, 128)
    assert np.abs(got - want).max() <= JIT_TOL * np.abs(want).max()
    # incremental decode of the same tokens ends on the same distribution
    ring = RingKVCache.create(2, 1, S, 2, 16, kv_fmt, device="cpu")
    for i, t in enumerate(seq):
        logits, ring = decode_step(
            tp, ring, torch.tensor([int(t)], dtype=torch.int32),
            torch.tensor([i], dtype=torch.int32), tsc)
    inc = logits[0].numpy()
    assert np.corrcoef(inc, got[-1])[0, 1] > 0.98
    assert np.argmax(got[-1]) in np.argsort(inc)[-3:]


def test_ring_wraps_and_slides():
    """Decoding past the ring size keeps running on the last S tokens."""
    _, tp = _artifact("e4m3")
    _, tsc = _cfgs("e4m3", "int8")
    ring = RingKVCache.create(2, 1, 8, 2, 16, "int8", device="cpu")
    toks, ring = decode_steps(
        tp, ring, torch.tensor([5], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32), None, torch.zeros(1), 11, tsc,
        greedy_only=True)
    assert toks.shape == (1, 11) and int(ring.head) == 11 % 8
    assert bool((ring.sc[:, :, :, :] != 1).any(dim=1).all())


def test_prefill_batch_drops_padding_rows_and_slots():
    """Rows past a prompt's length and requests in padding slots
    (slot >= n_slots) write nothing, as JAX's mode="drop" scatters."""
    jp, tp = _artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "int8")
    prompts = np.zeros((4, S), np.int32)
    prompts[0, :6], prompts[1, :3] = PROMPT, [9, 8, 7]
    slots = np.array([1, 0, 2, 2], np.int32)           # n_slots = 2
    lengths = np.array([6, 3, 0, 0], np.int32)
    temp, tk, tp_ = np.zeros(4, np.float32), np.zeros(4, np.int32), \
        np.ones(4, np.float32)
    jr = dataclasses.replace(JRing.create(2, 2, S, 2, 16, "int8"),
                             head=jnp.int32(2))         # windows wrap
    jf, jr, jtok, jpos = jmodel.prefill_batch(
        jp, jr, jnp.asarray(prompts), jnp.asarray(slots),
        jnp.asarray(lengths), jax.random.key(0), jnp.asarray(temp),
        jnp.asarray(tk), jnp.asarray(tp_), jnp.zeros(2, jnp.int32),
        jnp.zeros(2, jnp.int32), jsc)
    tr = RingKVCache.create(2, 2, S, 2, 16, "int8", device="cpu")
    tr.head = torch.tensor(2, dtype=torch.int32)
    tf, tr, ttok, tpos = prefill_batch(
        tp, tr, torch.from_numpy(prompts), torch.from_numpy(slots),
        torch.from_numpy(lengths), torch.Generator().manual_seed(0),
        torch.from_numpy(temp), torch.from_numpy(tk), torch.from_numpy(tp_),
        torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
        tsc)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tpos.numpy(), [3, 6])
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tf.numpy()[:2], np.asarray(jf)[:2])
    # the same rows were written, and only those
    written_j = (np.asarray(jr.sc) != 1).any(axis=(1, 2))
    written_t = (tr.sc.numpy() != 1).any(axis=(1, 2))
    np.testing.assert_array_equal(written_t, written_j)
    assert written_t.sum() == (6 + 3) * 2
    assert (raw(tr.kv8) == raw(jr.kv8)).mean() >= 0.95


def test_kvcache_update_matches_jax(rng):
    from fp8tpu.serve import KVCache as JKVCache
    k = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    jc = JKVCache.create(2, 2, 8, 2, 16, "e4m3").update(
        1, jnp.asarray(k), jnp.asarray(v), jnp.int32(4))
    tc = KVCache.create(2, 2, 8, 2, 16, "e4m3", device="cpu").update(
        1, torch.from_numpy(k), torch.from_numpy(v), 4)
    jc = jc.update_slot(0, jnp.int32(1), jnp.asarray(k[0]), jnp.asarray(v[0]),
                        jnp.int32(0))
    tc = tc.update_slot(0, 1, torch.from_numpy(k[0]), torch.from_numpy(v[0]),
                        0)
    assert tc.fmt == "e4m3" and tc.max_seq == 8
    for name in ("k8", "v8", "k_scale", "v_scale"):
        np.testing.assert_array_equal(raw(getattr(tc, name)),
                                      raw(getattr(jc, name)), err_msg=name)
    assert tc.layer(1)[0].shape == (2, 2, 8, 16)


# -- sampling ------------------------------------------------------------------

def test_sample_tokens_filters(rng):
    """The semantics of tests/test_serve.py's sampling tests, on the
    filtered support (the JAX random streams are not reproduced)."""
    B, V = 4, 64
    logits = torch.from_numpy((rng.standard_normal((B, V)) * 3).astype(
        np.float32))
    temp = torch.ones(B)
    greedy = logits.argmax(-1).to(torch.int32)
    gen = torch.Generator().manual_seed(0)
    k1 = tmodel.sample_tokens(logits, gen, temp,
                              torch.full((B,), 1, dtype=torch.int32), None)
    assert torch.equal(k1, greedy)
    tiny_p = tmodel.sample_tokens(logits, gen, temp, None,
                                  torch.full((B,), 1e-6))
    assert torch.equal(tiny_p, greedy)
    top5 = logits.topk(5, -1).indices
    for _ in range(20):
        t = tmodel.sample_tokens(logits, gen, temp,
                                 torch.full((B,), 5, dtype=torch.int32), None)
        assert all(int(t[b]) in top5[b].tolist() for b in range(B))
    t0 = tmodel.sample_tokens(logits, gen, torch.zeros(B),
                              torch.full((B,), 5, dtype=torch.int32),
                              torch.full((B,), 0.5))
    assert torch.equal(t0, greedy)
    assert torch.equal(tmodel.sample_tokens(logits, None, temp,
                                            greedy_only=True), greedy)


def test_sample_tokens_per_slot_filter_isolation():
    """A plain temperature-sampling slot co-batched with a filtered slot
    draws from the FULL vocabulary, not the 64-candidate pool."""
    logits = torch.zeros(2, 256)
    gen = torch.Generator().manual_seed(1)
    seen, seen_filtered = set(), set()
    for _ in range(64):
        t = tmodel.sample_tokens(
            logits, gen, torch.ones(2),
            torch.tensor([0, 4], dtype=torch.int32), torch.ones(2))
        seen.add(int(t[0]))
        seen_filtered.add(int(t[1]))
    assert max(seen) >= 64, sorted(seen)[-5:]
    assert len(seen_filtered) <= 4


def test_sample_tokens_temperature_distribution():
    """Unfiltered sampling follows softmax(logits / T)."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(2)
    t = tmodel.sample_tokens(logits, gen, torch.full((4000,), 2.0))
    freq = np.bincount(t.numpy(), minlength=4) / 4000.0
    want = torch.softmax(logits[0] / 2.0, -1).numpy()
    assert np.abs(freq - want).max() < 0.03


def test_chosen_logprob_matches_jax(rng):
    logits = (rng.standard_normal((3, 50)) * 2).astype(np.float32)
    chosen = np.array([4, 49, 0], np.int32)
    want = np.asarray(jmodel._chosen_logprob(jnp.asarray(logits),
                                             jnp.asarray(chosen)))
    got = tmodel._chosen_logprob(torch.from_numpy(logits),
                                 torch.from_numpy(chosen)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- what waits, and the device rules ------------------------------------------

def test_unported_options_raise_not_implemented():
    """Every option that raised before it was ported now serves: W8A8
    (matmul_impl="direct") decodes within the tolerance of the un-jitted
    JAX function, ring_flush > 1 in a one-step call writes its row directly
    (as the JAX package does), and a random MoE artifact decodes; an
    unknown matmul_impl raises."""
    jcfg, tcfg, _, _ = _models()
    jp, tp = _artifact("e4m3")
    ring = RingKVCache.create(2, 1, S, 2, 16, "int8", device="cpu")
    tok = torch.zeros(1, dtype=torch.int32)
    direct, ring = decode_step(tp, ring, tok, tok, ServeConfig(
        model=tcfg, kv_fmt="int8", matmul_impl="direct"))
    with jax.disable_jit():
        jdirect, _ = jmodel.decode_step(
            jp, JRing.create(2, 1, S, 2, 16, "int8"), jnp.zeros(1, jnp.int32),
            jnp.zeros(1, jnp.int32), JServeConfig(
                model=jcfg, kv_fmt="int8", matmul_impl="direct"))
    assert np.abs(direct.numpy() - np.asarray(jdirect)).max() \
        <= EAGER_TOL * np.abs(np.asarray(jdirect)).max()
    with pytest.raises(ValueError, match="matmul_impl"):
        decode_step(tp, ring, tok, tok, ServeConfig(
            model=tcfg, kv_fmt="int8", matmul_impl="w4a4"))
    ring = RingKVCache.create(2, 1, S, 2, 16, "int8", device="cpu")
    want, _ = decode_step(tp, RingKVCache.create(2, 1, S, 2, 16, "int8",
                                                 device="cpu"), tok, tok,
                          ServeConfig(model=tcfg, kv_fmt="int8"))
    got, ring = decode_step(tp, ring, tok, tok, ServeConfig(
        model=tcfg, kv_fmt="int8", ring_flush=4))
    assert torch.equal(got, want) and int(ring.head) == 1
    mcfg = tiny_config(n_experts=4, **TINY)
    mp = random_serve_params(mcfg, device="cpu")
    assert "router" in mp and tuple(mp["eup8"].shape) == (2, 4, 64, 128)
    logits, _ = decode_step(mp, RingKVCache.create(2, 1, S, 2, 16, "int8",
                                                   device="cpu"), tok, tok,
                            ServeConfig(model=mcfg, kv_fmt="int8"))
    assert logits.shape == (1, 128) and bool(torch.isfinite(logits).all())


def test_cpu_path_launches_no_kernel_and_defaults_to_cuda(monkeypatch):
    _, tcfg, _, _ = _models()
    before = (qmatmul.dequant_launches, int4_matmul.launches,
              inplace.launches)
    _run_both("int4", "int8", n_steps=1)
    _run_both("e4m3", "int8", n_steps=1)
    assert (qmatmul.dequant_launches, int4_matmul.launches,
            inplace.launches) == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: random_serve_params(tcfg),
                 lambda: RingKVCache.create(2, 1, S, 2, 16),
                 lambda: KVCache.create(2, 1, S, 2, 16),
                 lambda: serve_params_from_jax({}),
                 lambda: ring_from_jax(np.zeros(1), np.zeros(1), 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
