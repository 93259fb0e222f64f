"""W8A8 serving (``matmul_impl="direct"``) against the JAX package.

P2's plain version (``qmatmul.quantize_rows_plain``) against
``fp8tpu/serve/model.py::_quantize_act``, P1's (``w8a8_matmul_plain``) and
the int8 route (K3's plain version with a row scale) against
``fp8_linear(..., "direct")``, then the tiny decoder served with
``matmul_impl="direct"`` on every path: the ring, the five paged modes,
``full_logits``, an MoE artifact, a speculation round and the engine
behind the server.  Tolerances as in tests/test_torch_serve_model.py:
4e-3 of max|logit| against the un-jitted JAX functions, 4e-2 against the
jitted ones (XLA elides bf16 roundings the source writes)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_serve_model as serve
from fp8tpu.serve import PagedKVCache as JPaged
from fp8tpu.serve import RingKVCache as JRing
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import ServingEngine as JServingEngine
from fp8tpu.serve import model as jmodel
from fp8tpu.serve.engine import Request as JRequest
from fp8tpu_torch.kernels import qmatmul
from fp8tpu_torch.models import tiny_config
from fp8tpu_torch.serve import (EngineServer, PagedKVCache, Request,
                                RingKVCache, ServeConfig, ServingEngine,
                                decode_step, decode_step_paged,
                                decode_steps_paged, full_logits, prefill,
                                random_serve_params, speculative_decode)
from fp8tpu_torch.serve import model as tmodel

JIT_TOL = 4e-2
EAGER_TOL = 4e-3
# Direct linears against the jitted JAX functions: besides the roundings
# XLA elides, jit turns _quantize_act's ``amax / 448`` into a product with
# 1 / 448, so a row's scale may sit one ulp off the divide the source
# writes (and the port computes), and some of its activation codes then a
# whole e4m3 step (2^-3) away.  Measured on the tiny decoder: 0.030-0.054
# of max|logit| over the ring and paged cases below (0.008-0.028 with
# convert linears).
DIRECT_JIT_TOL = 8e-2
J_FP8 = {"e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2,
         "int8": jnp.int8, "bf16": jnp.bfloat16}


def bf16_pair(x: np.ndarray):
    """The same bf16 bits as a JAX array and a torch tensor (through the
    raw bits: torch's f32 -> bf16 convert sets a NaN's sign)."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    bits = np.ascontiguousarray(np.asarray(xj)).view(np.int16)
    return xj, torch.from_numpy(bits.copy()).view(torch.bfloat16)


def raw(a) -> np.ndarray:
    return serve.raw(a)


# -- P2: the per-row activation quantizer ---------------------------------------

EDGE_ROWS = {
    "zero": [0.0, 0.0, 0.0, 0.0],
    "bf16 subnormals": [2.0 ** -130, -(2.0 ** -133), 2.0 ** -127, 0.0],
    "bf16 max, -0": [3.3895313892515355e38, -0.0, -3.3895313892515355e38,
                     1.0],
    "+inf": [np.inf, 1.0, 0.0, -3.0],
    "-inf": [-np.inf, 0.5, -0.0, 2.0],
    "nan": [np.nan, 1.0, -2.0, 0.0],
    "ties": [448.0, 0.5 * (1.0 + 1.125), -13.0, 0.0625 * 1.5],
}


def _rows(rng):
    x = (rng.standard_normal((6, 64))
         * np.float32([1e-3, 1.0, 30.0, 1e4, 5e-30, 1e30])[:, None])
    edges = np.zeros((len(EDGE_ROWS), 64), np.float32)
    for i, row in enumerate(EDGE_ROWS.values()):
        edges[i, :4] = row
    return bf16_pair(np.concatenate([x.astype(np.float32), edges]))


def test_quantize_rows_plain_matches_jax(rng):
    """Codes and scales bit-equal to the un-jitted _quantize_act on random
    rows of several magnitudes and on every edge row (a zero row takes
    s = 1, bf16 subnormals flush, +-inf rows give NaN where inf / inf, -0
    keeps its sign, a NaN row takes s = 1 and keeps its NaN's sign)."""
    xj, xt = _rows(rng)
    with jax.disable_jit():
        jq, js = jmodel._quantize_act(xj)
    tq, ts = qmatmul.quantize_rows_plain(xt)
    np.testing.assert_array_equal(raw(tq), raw(jq))
    np.testing.assert_array_equal(raw(ts), raw(js))
    # the model's producer is the same function on the CPU
    mq, ms = tmodel._quantize_act(xt)
    np.testing.assert_array_equal(raw(mq), raw(tq))
    np.testing.assert_array_equal(raw(ms), raw(ts))


def test_quantize_rows_plain_against_jax_jitted(rng):
    """Under jit XLA turns ``amax / 448`` into a product with 1 / 448, which
    is not correctly rounded (trap 8): a row's scale may sit one f32 ulp
    from the port's (which follows the source's divide), and its codes
    then one e4m3 step.  Rows whose scales agree have equal codes."""
    xj, xt = _rows(rng)
    jq, js = jax.jit(jmodel._quantize_act)(xj)
    tq, ts = qmatmul.quantize_rows_plain(xt)
    js_bits = np.asarray(js).view(np.int32)[:, 0]
    ts_bits = ts.numpy().view(np.int32)[:, 0]
    assert (np.abs(js_bits.astype(np.int64) - ts_bits) <= 1).all()
    same = js_bits == ts_bits
    assert same.sum() >= len(same) // 2
    np.testing.assert_array_equal(raw(tq)[same], raw(jq)[same])
    a = tq.float().numpy()[~same]
    b = np.asarray(jq.astype(jnp.float32))[~same]
    assert (np.abs(a - b) <= 2.0 ** -3 * np.abs(b)).all()


def test_tiny_amax_row_keeps_its_scale():
    """A row whose amax lies in (0, 448 2^-126): XLA flushes amax / 448 to
    0, and the JAX package then stores +-448 for every nonzero element and
    NaN for a zero; the port keeps the subnormal scale, so the row
    quantizes as any other row does (ROADMAP §3)."""
    x = np.zeros((1, 8), np.float32)
    x[0, :4] = [1e-37, -3e-38, 0.0, 5e-38]
    xj, xt = bf16_pair(x)
    with jax.disable_jit():
        jq, js = jmodel._quantize_act(xj)
    assert float(np.asarray(js)[0, 0]) == 0.0
    assert raw(jq)[0, :4].tolist() == [0x7E, 0xFE, 0xFF, 0x7E]
    tq, ts = qmatmul.quantize_rows_plain(xt)
    amax = float(np.asarray(xj.astype(jnp.float32))[0, 0])
    assert float(ts[0, 0]) == float(np.float32(amax) / np.float32(448.0)) > 0
    assert raw(tq)[0, :4].tolist() == [0x7E, 0xF0, 0x00, 0x76]


# -- P1 and the int8 route against fp8_linear(..., "direct") --------------------

def _linear_inputs(rng, fmt, m, k=64, n=48, exact=False):
    """x (m, k) and a quantized weight (JAX payload, port payload, scale).
    ``exact``: every row's amax is 448 and every element a small integer
    (scale 1, codes exact), weights likewise, so every f32 sum is exact."""
    if exact:
        x = rng.integers(-8, 9, (m, k)).astype(np.float32)
        x[:, 0] = 448.0
        top = {"e4m3": 448.0, "e5m2": 57344.0, "int8": 127.0,
               "bf16": 448.0}[fmt]
        w = rng.integers(-8, 9, (k, n)).astype(np.float32)
        w[0] = top
    else:
        x = rng.standard_normal((m, k)).astype(np.float32) * 3
        w = rng.standard_normal((k, n)).astype(np.float32) / 8
    xj, xt = bf16_pair(x)
    if fmt == "bf16":
        wt = torch.from_numpy(w).to(torch.bfloat16)
        s = torch.ones(n)
    else:
        wt, s = qmatmul.quantize_weights(torch.from_numpy(w), fmt)
        s = s.reshape(-1)
    wj = jnp.asarray(raw(wt)).view(J_FP8[fmt]).reshape(k, n)
    return xj, xt, wj, wt, s


@pytest.mark.parametrize("m", [1, 5, 70])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8", "bf16"])
def test_direct_linear_matches_jax(rng, fmt, m):
    """fp8_linear(..., "direct") against the JAX one, un-jitted and jitted:
    within the summation-order bound (2 K 2^-24 sum|x w| xs s) plus one
    bf16 step; and its contraction (P1's plain version, or K3's with the
    row scale for int8) against the same bound from the same codes."""
    xj, xt, wj, wt, s = _linear_inputs(rng, fmt, m)
    sj = jnp.asarray(s.numpy())
    got = tmodel.fp8_linear(xt, wt, s, "direct").float().numpy()
    xq, xs = qmatmul.quantize_rows_plain(xt)
    codes = np.abs(xq.float().numpy()) @ np.abs(wt.float().numpy())
    bound = (2 * 64 * 2.0 ** -24 * codes * xs.numpy() * s.numpy()[None]
             + 2.0 ** -7 * np.abs(got))
    with jax.disable_jit():
        want = np.asarray(jmodel.fp8_linear(xj, wj, sj, "direct").astype(
            jnp.float32))
    assert (np.abs(got - want) <= bound).all()
    # jitted: a row whose scale XLA rounds one ulp off may move each code
    # one e4m3 step (2^-3 relative)
    jitted = np.asarray(jax.jit(jmodel.fp8_linear, static_argnums=3)(
        xj, wj, sj, "direct").astype(jnp.float32))
    off = (np.asarray(jax.jit(jmodel._quantize_act)(xj)[1])
           != xs.numpy()).reshape(-1, 1)
    step = 2.0 ** -3 * codes * xs.numpy() * s.numpy()[None]
    assert (np.abs(got - jitted) <= bound + off * step).all()
    if fmt in ("e4m3", "e5m2"):
        plain = qmatmul.w8a8_matmul_plain(xq, xs.reshape(-1), wt, s)
    elif fmt == "int8":
        plain = qmatmul.dequant_matmul_plain(xq.to(torch.bfloat16), wt, s,
                                             row_scale=xs.reshape(-1))
    else:
        plain = None
    if plain is not None:
        assert (np.abs(plain.float().numpy() - want) <= bound).all()


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8", "bf16"])
def test_direct_linear_bit_equal_where_sums_are_exact(rng, fmt):
    """Codes on a coarse grid (scale 1, small integers): every f32 sum is
    exact, so the port and the JAX function agree bit for bit."""
    xj, xt, wj, wt, s = _linear_inputs(rng, fmt, 9, exact=True)
    got = tmodel.fp8_linear(xt, wt, s, "direct")
    with jax.disable_jit():
        want = jmodel.fp8_linear(xj, wj, jnp.asarray(s.numpy()), "direct")
    np.testing.assert_array_equal(raw(got), raw(want))


@pytest.mark.parametrize("m", [1, 8, 64, 65, 512, 2048])
@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 11008), (11008, 4096),
                                 (5504, 2048), (64, 48)])
def test_w8a8_plan_covers_k_in_whole_stages(m, k, n):
    """P1's launch plan on the streaming loop: the decode form (m64 tiles
    a block by N) up to M = 64, the prefill route above; at most 8 splits
    of whole 128-row stages that cover K exactly once, each split's K
    range promoted every W8A8_PROMOTE k32 steps from its start."""
    plan = qmatmul.w8a8_plan(m, n, k, 132)
    if m <= 64:
        assert plan.route == "stream"
        assert plan.code == qmatmul.stream_mt(n, 132)
    else:
        assert (plan.route, plan.code) == ("prefill", qmatmul.PREFILL_ROUTE)
    assert 1 <= plan.splits <= 8
    assert plan.kper % (32 * qmatmul.W8A8_STAGE_STEPS) == 0
    assert (plan.splits - 1) * plan.kper < k <= plan.splits * plan.kper
    chunk = 32 * qmatmul.W8A8_PROMOTE
    assert qmatmul.W8A8_PROMOTE % qmatmul.W8A8_STAGE_STEPS == 0
    edges = qmatmul.w8a8_edges(k, plan.kper)
    assert edges[0] == 0 and edges[-1] == k and edges == sorted(set(edges))
    starts = list(range(0, k, plan.kper))
    assert set(starts) <= set(edges)
    for a, b in zip(edges, edges[1:]):
        start = max(z for z in starts if z <= a)
        assert b - a <= chunk and (a - start) % chunk == 0
        assert b - a == chunk or b == min(k, start + plan.kper)


# -- P1's A fragments: a model of w_stream.cuh's fp8_loads / fp8_frags -------

def _swz(rb: int, r: int, c: int) -> int:
    """w_stream.cuh::swz: byte c of row r of a TMA box of rb-byte rows."""
    off = r * rb + c
    return off ^ (((off >> 7) & (rb // 16 - 1)) << 4)


def _fp8_lane_row(lane: int) -> int:
    """w_stream.cuh::fp8_lane_row."""
    i, r = lane >> 3, lane & 7
    return 16 * (i >> 1) + 4 * (r >> 1) + 2 * ((i & 1) ^ (r >> 2)) + (r & 1)


def _ldsm4_trans(smem: np.ndarray, addrs):
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16: lanes 8i .. 8i + 7 give
    the rows of matrix i; thread t's register i holds the b16 elements
    (row 2 (t % 4), col t // 4) (low half) and (row 2 (t % 4) + 1, same
    col) (high half)."""
    regs = np.zeros((32, 4), np.int64)
    for i in range(4):
        rows = [smem[addrs[8 * i + r]:addrs[8 * i + r] + 16].astype(np.int64)
                for r in range(8)]
        for t in range(32):
            q, g = t % 4, t // 4
            lo = rows[2 * q][2 * g:2 * g + 2]
            hi = rows[2 * q + 1][2 * g:2 * g + 2]
            regs[t, i] = lo[0] | lo[1] << 8 | hi[0] << 16 | hi[1] << 24
    return regs


def _byte_perm(x: int, y: int, sel: int) -> int:
    b = [(x >> 8 * i) & 0xFF for i in range(4)] \
        + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(sel >> 4 * n) & 7] << 8 * n for n in range(4))


@pytest.mark.parametrize("mt,rb,warps", [(1, 64, 4), (2, 128, 4),
                                         (1, 128, 8)])
def test_w8a8_a_fragments_are_the_ptx_k32_layout(mt, rb, warps):
    """P1's A operand straight from a raw payload stage (the decode form at
    MT = 1 and 2, and the prefill route's two warpgroups at MT = 1): for
    random stages of 128 K rows x rb columns in TMA's swizzled layout,
    ldmatrix.trans at fp8_lane_row's rows and fp8_frags' two permutes a
    register give every thread the bytes of the PTX .m64nNk32 8-bit A
    layout (register j, byte b of lane (g, q) in warp w of its warpgroup:
    A row 16 w + g + 8 (j & 1), K column 4q + b + 16 (j >> 1)), where A
    row g (g + 8) of tile t is the block's column 16 MT w + 16 t + 2g
    (+ 1): each (column, K row) byte of the stage lands in exactly one
    (thread, register, byte) and equals the numpy transpose.  And each
    8-row phase of an ldmatrix hits 8 distinct 16-byte bank groups."""
    rng = np.random.default_rng(mt * 1000 + rb + warps)
    for _ in range(2):
        w = rng.integers(0, 256, (128, rb), dtype=np.uint8)
        smem = np.zeros(128 * rb, np.uint8)
        for r in range(128):
            for c in range(rb):
                smem[_swz(rb, r, c)] = w[r, c]
        seen = np.zeros((rb, 128), np.int64)
        for warp in range(warps):
            for ks in range(4):
                for t in range(mt):
                    addrs = [_swz(rb, 32 * ks + _fp8_lane_row(lane),
                                  16 * mt * warp + 16 * t)
                             for lane in range(32)]
                    for i in range(4):
                        phase = addrs[8 * i:8 * i + 8]
                        groups = {(a % 128) // 16 for a in phase}
                        assert len(groups) == 8, "bank conflict"
                    v = _ldsm4_trans(smem, addrs)
                    for lane in range(32):
                        g, q = lane >> 2, lane & 3
                        lo = 0x2064 if q >> 1 else 0x6420
                        hi = 0x3175 if q >> 1 else 0x7531
                        a = [_byte_perm(v[lane, 0], v[lane, 1], lo),
                             _byte_perm(v[lane, 0], v[lane, 1], hi),
                             _byte_perm(v[lane, 2], v[lane, 3], lo),
                             _byte_perm(v[lane, 2], v[lane, 3], hi)]
                        for j in range(4):
                            col = 16 * mt * warp + 16 * t + 2 * g + (j & 1)
                            for b in range(4):
                                kr = 32 * ks + 4 * q + b + 16 * (j >> 1)
                                assert (a[j] >> 8 * b) & 0xFF == w.T[col, kr]
                                seen[col, kr] += 1
        np.testing.assert_array_equal(seen, np.ones_like(seen))


def test_w8a8_plain_rejects_bad_shapes_and_keeps_the_scale_order():
    xq = torch.zeros(3, 32, dtype=torch.float8_e4m3fn)
    w8 = torch.zeros(32, 16, dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="one scale a row"):
        qmatmul.w8a8_matmul_plain(xq, torch.ones(2), w8, torch.ones(16))
    with pytest.raises(ValueError, match="row scale"):
        qmatmul.dequant_matmul_plain(torch.zeros(3, 32), w8, torch.ones(16),
                                     row_scale=torch.ones(4))
    # acc * (xs * s), not (acc * xs) * s: the two round differently here
    xq = torch.full((1, 32), 1.0).to(torch.float8_e4m3fn)
    w8 = torch.full((32, 16), 1.5).to(torch.float8_e4m3fn)
    xs, s = torch.tensor([1.0 + 2.0 ** -23]), torch.full((16,), 3.0)
    out = qmatmul.w8a8_matmul_plain(xq, xs, w8, s, torch.float32)
    assert float(out[0, 0]) == float(np.float32(48.0) * (np.float32(xs[0])
                                                         * np.float32(3.0)))


# -- the tiny decoder served with matmul_impl="direct" ----------------------------

def _cfgs(fmt, kv_fmt, **kw):
    jsc, tsc = serve._cfgs(fmt, kv_fmt)
    kw = dict(matmul_impl="direct", **kw)
    return dataclasses.replace(jsc, **kw), dataclasses.replace(tsc, **kw)


def _ring_run(fmt, kv_fmt, n_steps=3):
    """Prefill slot 0, then ``n_steps`` decode steps of two slots, both
    sides fed JAX's greedy tokens: per-call (jax, port) logits, the
    rings."""
    jp, tp = serve._artifact(fmt)
    jsc, tsc = _cfgs(fmt, kv_fmt)
    S = serve.S
    jr = JRing.create(2, 2, S, 2, 16, kv_fmt)
    tr = RingKVCache.create(2, 2, S, 2, 16, kv_fmt, device="cpu")
    prompt = np.array(serve.PROMPT + [0] * (S - len(serve.PROMPT)), np.int32)
    jl, jr = jmodel.prefill(jp, jr, jnp.asarray(prompt), jnp.int32(0),
                            jnp.int32(len(serve.PROMPT)), jsc)
    tl, tr = prefill(tp, tr, torch.from_numpy(prompt), 0, len(serve.PROMPT),
                     tsc)
    pairs = [(np.asarray(jl), tl.numpy())]
    tok = np.array([int(np.argmax(pairs[0][0])), 7], np.int32)
    pos = np.array([len(serve.PROMPT), 0], np.int32)
    for _ in range(n_steps):
        jl, jr = jmodel.decode_step(jp, jr, jnp.asarray(tok),
                                    jnp.asarray(pos), jsc)
        tl, tr = decode_step(tp, tr, torch.from_numpy(tok),
                             torch.from_numpy(pos), tsc)
        pairs.append((np.asarray(jl), tl.numpy()))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    return pairs, jr, tr


@pytest.mark.parametrize("fmt,kv_fmt,jit", [
    ("e4m3", "int8", False), ("int8", "e4m3", False), ("e4m3", "int8", True),
    ("int8", "e4m3", True), ("e5m2", "int8", True), ("bf16", "int8", True)])
def test_direct_ring_decode_matches_jax(fmt, kv_fmt, jit):
    """Prefill and 3 decode steps on the ring: logits within the
    tolerance; against the un-jitted functions the ring's bytes equal on
    at least 0.99 (a k or v one bf16 step off re-rounds a few)."""
    if jit:
        pairs, jr, tr = _ring_run(fmt, kv_fmt)
    else:
        with jax.disable_jit():
            pairs, jr, tr = _ring_run(fmt, kv_fmt)
    if not jit:
        serve._check_run(pairs, jr, tr, EAGER_TOL, 0.99)
        return
    # jitted: the activation codes that XLA's scale flips (DIRECT_JIT_TOL)
    # move single k / v elements by up to an e4m3 step, and a head
    # vector's scale with them (measured up to 7.6%): most scales stay
    # within 3 bf16 steps, every one within 2^-3
    for step, (want, got) in enumerate(pairs):
        assert np.isfinite(got).all()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= DIRECT_JIT_TOL, (step, err)
    assert int(tr.head) == int(jr.head) == len(pairs) - 1
    rel = np.abs(serve.f32(tr.sc) - serve.f32(jr.sc)) / serve.f32(jr.sc)
    assert (rel <= 3 * 2.0 ** -7).mean() >= 0.95 and rel.max() <= 2.0 ** -3
    assert (raw(tr.kv8) == raw(jr.kv8)).mean() >= 0.85


def _paged_run(impl, jit):
    """Two slots, pages of 8, 3 decode steps from positions (5, 2), both
    sides fed JAX's tokens."""
    jp, tp = serve._artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "int8", paged_decode_impl=impl)
    table = np.arange(8, dtype=np.int32).reshape(2, 4)
    j = dataclasses.replace(JPaged.create(8, 8, 2, 2, 4, 2, 16, "int8"),
                            page_table=jnp.asarray(table))
    t = PagedKVCache.create(8, 8, 2, 2, 4, 2, 16, "int8", device="cpu")
    t.page_table = torch.from_numpy(table.copy())
    tok, pos = np.array([3, 4], np.int32), np.array([5, 2], np.int32)
    zero = np.zeros(2, np.float32)

    def jax_run():
        toks, pool = jmodel.decode_steps_paged(
            jp, j, jnp.asarray(tok), jnp.asarray(pos), jax.random.key(0),
            jnp.asarray(zero), 3, jsc, greedy_only=True)
        lg, pool = jmodel.decode_step_paged(jp, pool, toks[:, -1], pos + 3,
                                            jsc)
        return np.asarray(toks), np.asarray(lg), pool

    if jit:
        jt, jl, jpool = jax_run()
    else:
        with jax.disable_jit():
            jt, jl, jpool = jax_run()
    tt, t = decode_steps_paged(tp, t, torch.from_numpy(tok),
                               torch.from_numpy(pos), None,
                               torch.from_numpy(zero), 3, tsc,
                               greedy_only=True)
    tl, t = decode_step_paged(tp, t, torch.from_numpy(jt[:, -1].copy()),
                              torch.from_numpy(pos + 3), tsc)
    return jt, jl, jpool, tt.numpy(), tl.numpy(), t


@pytest.mark.parametrize("impl", tmodel.PAGED_DECODE_IMPLS)
def test_direct_paged_decode_matches_jax_jitted(impl):
    """Every paged mode: the final logits within DIRECT_JIT_TOL, the first
    token of the chunk equal."""
    jt, jl, jpool, tt, tl, t = _paged_run(impl, jit=True)
    assert np.abs(tl - jl).max() <= DIRECT_JIT_TOL * np.abs(jl).max()
    assert (tt[:, 0] == jt[:, 0]).all()
    assert (raw(t.pool) == raw(jpool.pool)).mean() >= 0.85


def test_direct_paged_decode_matches_jax_unjitted():
    jt, jl, jpool, tt, tl, t = _paged_run("kernel", jit=False)
    np.testing.assert_array_equal(tt, jt)
    assert np.abs(tl - jl).max() <= EAGER_TOL * np.abs(jl).max()
    assert (raw(t.pool) == raw(jpool.pool)).mean() >= 0.99


@pytest.mark.parametrize("fmt", ["e4m3", "int8"])
def test_direct_full_logits_matches_jax(fmt):
    jp, tp = serve._artifact(fmt)
    jsc, tsc = _cfgs(fmt, "int8")
    seq = np.array(serve.PROMPT + [89, 79], np.int32)
    got = full_logits(tp, torch.from_numpy(seq), tsc).numpy()
    with jax.disable_jit():
        want = np.asarray(jmodel.full_logits(jp, jnp.asarray(seq), jsc))
    assert np.abs(got - want).max() <= EAGER_TOL * np.abs(want).max()
    want = np.asarray(jax.jit(jmodel.full_logits, static_argnums=2)(
        jp, jnp.asarray(seq), jsc))
    assert np.abs(got - want).max() <= DIRECT_JIT_TOL * np.abs(want).max()


def test_direct_moe_decode_matches_jax():
    """An MoE artifact (4 experts, top-2): each expert quantizes its own
    input, as the vmapped JAX linear does.  Prefill and a ring step against
    the un-jitted JAX functions; the routing of every call equal (no
    choice of these inputs lies at a near tie)."""
    import test_torch_serve_moe as moe
    jp, tp = moe._artifact("e4m3")
    jsc, tsc = moe._cfgs("e4m3", "int8")
    jsc = dataclasses.replace(jsc, matmul_impl="direct")
    tsc = dataclasses.replace(tsc, matmul_impl="direct")
    picks = {"jax": [], "port": []}
    orig_j, orig_t = jmodel._moe_ffn, tmodel._moe_ffn

    def spy(which, orig, probs_of):
        def ffn(x, xs, mcfg, linear):
            picks[which].append(np.argsort(-probs_of(x, xs), axis=-1,
                                           kind="stable")[:, :2])
            return orig(x, xs, mcfg, linear)
        return ffn

    jmodel._moe_ffn = spy("jax", orig_j, lambda x, xs: np.asarray(
        jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                       @ xs["router"].astype(jnp.float32), -1)))
    tmodel._moe_ffn = spy("port", orig_t, lambda x, xs: torch.softmax(
        tmodel._dot_f32(x.reshape(-1, x.shape[-1]).float(), xs["router"]),
        -1).numpy())
    try:
        with jax.disable_jit():
            pairs, jr, tr = _moe_ring(jp, tp, jsc, tsc)
    finally:
        jmodel._moe_ffn, tmodel._moe_ffn = orig_j, orig_t
    for step, (want, got) in enumerate(pairs):
        assert np.abs(got - want).max() <= EAGER_TOL * np.abs(want).max()
    assert len(picks["jax"]) == len(picks["port"]) == 2 * (1 + MOE_STEPS)
    for a, b in zip(picks["jax"], picks["port"]):
        np.testing.assert_array_equal(np.sort(a, -1), np.sort(b, -1))
    assert (raw(tr.kv8) == raw(jr.kv8)).mean() >= 0.99


MOE_STEPS = 1          # decode steps after the prefill (un-jitted JAX: slow)


def _moe_ring(jp, tp, jsc, tsc):
    import test_torch_serve_moe as moe
    jr = JRing.create(2, 2, moe.S, 2, 16, "int8")
    tr = RingKVCache.create(2, 2, moe.S, 2, 16, "int8", device="cpu")
    prompt = np.array(moe.PROMPT + [0] * (moe.S - len(moe.PROMPT)), np.int32)
    jl, jr = jmodel.prefill(jp, jr, jnp.asarray(prompt), jnp.int32(0),
                            jnp.int32(len(moe.PROMPT)), jsc)
    tl, tr = prefill(tp, tr, torch.from_numpy(prompt), 0, len(moe.PROMPT),
                     tsc)
    pairs = [(np.asarray(jl), tl.numpy())]
    tok = np.array([int(np.argmax(pairs[0][0])), 7], np.int32)
    pos = np.array([len(moe.PROMPT), 0], np.int32)
    for _ in range(MOE_STEPS):
        jl, jr = jmodel.decode_step(jp, jr, jnp.asarray(tok),
                                    jnp.asarray(pos), jsc)
        tl, tr = decode_step(tp, tr, torch.from_numpy(tok),
                             torch.from_numpy(pos), tsc)
        pairs.append((np.asarray(jl), tl.numpy()))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    return pairs, jr, tr


def _band_ok(out, prompts, tp, tsc, tol=JIT_TOL):
    """Every emitted token within the margin band of the port's own
    teacher-forced logits (trap 14)."""
    for uid, got in out.items():
        seq = torch.tensor(prompts[uid] + got, dtype=torch.int32)
        lg = full_logits(tp, seq, tsc)[len(prompts[uid]) - 1:-1]
        top = lg.max(-1).values
        picked = lg.gather(1, seq[len(prompts[uid]):, None].long())[:, 0]
        band = 2 * tol * lg.abs().amax(-1)
        assert bool((top - picked <= band).all()), uid


def test_direct_speculation_round_matches_plain_decode():
    """One speculative_decode call (self-draft, k = 3) with direct linears
    in both the draft and the verify pass: greedy tokens within the band
    of the direct model's teacher-forced logits, and equal to plain
    direct decoding unless a step is a near tie."""
    _, tp = serve._artifact("e4m3")
    _, tsc = _cfgs("e4m3", "int8")
    prompt = serve.PROMPT
    got, stats = speculative_decode(tp, tp, prompt, 6, tsc, tsc, k_spec=3)
    assert len(got) == 6 and stats.accepted >= 3
    _band_ok({0: list(got)}, {0: list(prompt)}, tp, tsc, EAGER_TOL)


def test_direct_engine_and_server_match_the_jax_engine():
    """The ring ServingEngine with direct linears against the JAX engine
    (margin rule), and the EngineServer's answers equal to the engine's."""
    jp, tp = serve._artifact("e4m3")
    jsc, tsc = _cfgs("e4m3", "int8")
    prompts = {i: [1 + i, 2 + i, 3 + i, 40 + 2 * i][:2 + i % 3]
               for i in range(4)}
    jout = JServingEngine(jp, jsc, n_slots=2, max_seq=64, chunk_size=4).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in prompts.items()])
    eng = ServingEngine(tp, tsc, n_slots=2, max_seq=64, chunk_size=4,
                        device="cpu")
    out = eng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                   for i, p in prompts.items()])
    assert set(out) == set(jout) and all(len(v) == 6 for v in out.values())
    _band_ok(out, prompts, tp, tsc)
    assert sum(out[u] == jout[u] for u in out) >= 1
    srv = EngineServer(ServingEngine(tp, tsc, n_slots=2, max_seq=64,
                                     chunk_size=4, device="cpu")).start()
    try:
        futs = {i: srv.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                for i, p in prompts.items()}
        served = {i: f.result(timeout=120) for i, f in futs.items()}
    finally:
        srv.stop()
    assert served == out


def test_direct_random_params_decode_on_the_cpu_launch_nothing():
    """A random artifact with direct linears decodes on the CPU through the
    plain versions: no P1 / P2 / K3 launch is counted."""
    cfg = tiny_config(**serve.TINY)
    tp = random_serve_params(cfg, "e4m3", device="cpu")
    before = (qmatmul.w8a8_launches, qmatmul.quantize_launches,
              qmatmul.dequant_launches)
    ring = RingKVCache.create(2, 1, serve.S, 2, 16, "int8", device="cpu")
    tok = torch.zeros(1, dtype=torch.int32)
    logits, _ = decode_step(tp, ring, tok, tok, ServeConfig(
        model=cfg, kv_fmt="int8", matmul_impl="direct"))
    assert bool(torch.isfinite(logits).all())
    assert (qmatmul.w8a8_launches, qmatmul.quantize_launches,
            qmatmul.dequant_launches) == before
    with pytest.raises(ValueError, match="matmul_impl"):
        tmodel.fp8_linear(torch.zeros(1, 64, dtype=torch.bfloat16),
                          tp["q8"][0], tp["qs"][0], "fast")
