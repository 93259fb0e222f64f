"""W8A8's int8 route on the CPU: P2's codes written as f16 values, the pieces of K3's int8 route that the card runs (the int8 -> f16
convert, the f16 A fragments), P2's fast divide, and the direct-int8
decoder against the JAX package.

P2's plain 2-byte codes are held bit for bit to the un-jitted
``fp8tpu/serve/model.py::_quantize_act`` codes converted by JAX; numpy
models of ``csrc/w_stream.cuh``'s int8 -> f16 sequence and fragment
layout are held to every byte and to the PTX layout; a numpy model of
``csrc/w8a8.cu::quot_fast`` (exact f32 fmas) to the correctly rounded
divide.  Serving tolerances as tests/test_torch_w8a8.py."""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_serve_model as serve
from test_torch_w8a8 import (EAGER_TOL, _byte_perm, _cfgs,
                             _ldsm4_trans, _moe_ring, _rows, _swz, raw)
from fp8tpu.serve import PagedKVCache as JPaged
from fp8tpu.serve import model as jmodel
from fp8tpu_torch.kernels import qmatmul
from fp8tpu_torch.serve import (PagedKVCache, decode_step_paged,
                                decode_steps_paged)
from fp8tpu_torch.serve import model as tmodel

FP8 = {"e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
       "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


# -- P2's codes as 2-byte values ----------------------------------------------

@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_plain_codes_match_jax_converted_codes(rng, fmt):
    """``quantize_rows_plain(x, codes_dtype=torch.float16)``: the un-jitted
    _quantize_act codes converted by JAX to f16, bit for bit, on random
    rows and every edge row (zero, NaN, bf16 subnormals, bf16 max, +-inf,
    ties): a NaN code the sign on the quiet NaN.  Scales equal."""
    tdt, jdt = torch.float16, jnp.float16
    xj, xt = _rows(rng)
    with jax.disable_jit():
        jq, js = jmodel._quantize_act(xj, fmt)
        jv = jq.astype(jdt)
    tq, ts = qmatmul.quantize_rows_plain(xt, fmt, codes_dtype=tdt)
    assert tq.dtype == tdt
    np.testing.assert_array_equal(raw(tq), raw(jv))
    np.testing.assert_array_equal(raw(ts), raw(js))
    assert np.isnan(raw(tq).view(jnp.dtype(jdt)).astype(np.float32)).any()
    # the byte codes are the same function: their values are these
    bq, bs = qmatmul.quantize_rows_plain(xt, fmt)
    np.testing.assert_array_equal(raw(qmatmul.codes_as(bq, tdt)), raw(tq))
    # and the model's producer passes codes_dtype on
    mq, _ = tmodel._quantize_act(xt, fmt, codes_dtype=tdt)
    np.testing.assert_array_equal(raw(mq), raw(tq))


@pytest.mark.parametrize("fmt", list(FP8))
def test_tiny_amax_row_codes_are_its_bytes_values(fmt):
    """The tiny-amax row (amax in (0, max_normal 2^-126)) keeps its
    subnormal scale in the port where XLA stores +-max and NaN codes
    (ROADMAP §3), so its f16 codes are held to JAX's convert of the port's
    own byte codes: bit for bit, the scale the byte path's."""
    x = torch.zeros(1, 8)
    x[0, :4] = torch.tensor([1e-37, -3e-38, 0.0, 5e-38])
    x = x.to(torch.bfloat16)
    bq, bs = qmatmul.quantize_rows_plain(x, fmt)
    tq, ts = qmatmul.quantize_rows_plain(x, fmt, codes_dtype=torch.float16)
    want = jnp.asarray(raw(bq)).view(FP8[fmt][1]).astype(jnp.float16)
    np.testing.assert_array_equal(raw(tq), raw(want))
    np.testing.assert_array_equal(raw(ts), raw(bs))
    assert float(bs[0, 0]) < 2.0 ** -126 and bool((tq[0, :2] != 0).all())


def test_codes_as_every_code():
    """Every e4m3 and e5m2 byte to f16: the value where it is a number,
    JAX's convert's bits where it is a NaN."""
    for fdt, jfdt in FP8.values():
        b = np.arange(256, dtype=np.uint8)
        got = qmatmul.codes_as(torch.from_numpy(b).view(fdt), torch.float16)
        want = jnp.asarray(b).view(jfdt).astype(jnp.float16)
        np.testing.assert_array_equal(raw(got), raw(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_quantize_rows_rejects_other_codes_dtypes(dtype):
    """P2 writes its codes as fp8 bytes or f16 and nothing else (bf16
    codes, measured slower as the int8 route's input, are not offered)."""
    x = torch.zeros(2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bytes \\(None\\) or float16"):
        qmatmul.quantize_rows(x, codes_dtype=dtype)
    with pytest.raises(ValueError, match="bytes \\(None\\) or float16"):
        qmatmul.quantize_rows_plain(x, codes_dtype=dtype)


def test_int8_linear_on_f16_codes_equals_the_bf16_codes_route(rng):
    """K3's plain version on f16 codes against the byte codes converted to
    bf16 (the route before f16 codes): one function, the same f32 sums,
    bit for bit; f16 x takes int8 weights only."""
    x = torch.from_numpy(rng.standard_normal((5, 96)).astype(np.float32))
    w8, s = qmatmul.quantize_weights(
        torch.from_numpy(rng.standard_normal((96, 40)).astype(np.float32)),
        "int8")
    xh, xs = qmatmul.quantize_rows(x.to(torch.bfloat16),
                                   codes_dtype=torch.float16)
    xq, _ = qmatmul.quantize_rows(x.to(torch.bfloat16))
    xb = xq.to(torch.bfloat16)
    a = qmatmul.dequant_matmul(xh, w8, s.reshape(-1), torch.float32,
                               xs.reshape(-1))
    b = qmatmul.dequant_matmul(xb, w8, s.reshape(-1), torch.float32,
                               xs.reshape(-1))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError, match="int8 weights only"):
        qmatmul.dequant_matmul_plain(xh, w8.to(torch.float8_e4m3fn),
                                     s.reshape(-1))


# -- K3's int8 route: the convert and the fragments (w_stream.cuh) -----------

I8F16_BIAS = 0x64806480


def _f16x2(word: int):
    """The two f16 values of a 32-bit word (low half first)."""
    return np.array([word & 0xFFFF, word >> 16], np.uint16).view(np.float16)


def _sub_f16x2(a: int, b: int):
    """sub.f16x2 (exact for the values it meets here)."""
    d = (_f16x2(a).astype(np.float32) - _f16x2(b).astype(np.float32))
    h = d.astype(np.float16)
    assert (h.astype(np.float32) == d).all(), "inexact subtract"
    v = h.view(np.uint16).astype(np.int64)
    return int(v[0] | v[1] << 16)


def _int8_f16(x: int, y: int, sel: int) -> int:
    """w_stream.cuh::int8_f16."""
    return _sub_f16x2((_byte_perm(x, y, sel) & 0x00FF00FF) ^ 0x64806480,
                      I8F16_BIAS)


def test_int8_to_f16_magic_gives_every_byte():
    """0x6400 | (v ^ 0x80) is 1024 + (v + 128) in f16, and the subtract of
    1152 leaves v exactly: all 256 bytes, in both halves of a register,
    through the MT = 1 selectors (bytes 0 / 2 and 1 / 3 of one word) and
    the MT = 2 ones (byte j of two words)."""
    for v in range(256):
        s = v - 256 if v >= 128 else v
        other = 255 - v
        o = other - 256 if other >= 128 else other
        word = v | (v << 8) | (other << 16) | (other << 24)
        for sel in (0x3230, 0x3331):
            got = _f16x2(_int8_f16(word, 0, sel)).astype(np.float32)
            np.testing.assert_array_equal(got, [s, o])
        for j in range(4):
            sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12)
            x = v << 8 * j
            y = other << 8 * j
            got = _f16x2(_int8_f16(x, y, sel)).astype(np.float32)
            np.testing.assert_array_equal(got, [s, o])


def _f16_frags_mt1(v0: int, v1: int):
    """convert_step's f16 branch at MT = 1: a word of ldmatrix.trans is
    (row k col c, row k col c + 1, row k + 1 col c, row k + 1 col c + 1)."""
    return [_int8_f16(v0, 0, 0x3230), _int8_f16(v0, 0, 0x3331),
            _int8_f16(v1, 0, 0x3230), _int8_f16(v1, 0, 0x3331)]


def _f16_frags_mt2(w):
    """convert_step's f16 branch at MT = 2: words of one K row's four
    columns, rows (k, k + 1, k + 8, k + 9)."""
    a = [[0] * 4 for _ in range(2)]
    for t in range(2):
        for h in range(2):
            j = 2 * t + h
            sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12)
            a[t][h] = _int8_f16(w[0], w[1], sel)
            a[t][2 + h] = _int8_f16(w[2], w[3], sel)
    return a


@pytest.mark.parametrize("mt,rb,warps", [(1, 64, 4), (2, 128, 4),
                                         (1, 128, 8)])
def test_int8_f16_a_fragments_are_the_ptx_k16_layout(mt, rb, warps):
    """K3's int8 route's A operand straight from a raw stage of int8 bytes
    (the decode form at MT = 1 and 2, the prefill route's two warpgroups
    at MT = 1): load_stage (ldmatrix.trans at MT = 1, four 4-byte loads at
    MT = 2) and convert_step's f16 branch give every thread the values of
    the PTX .m64nNk16 16-bit A layout (register j of lane (g, q) in warp w
    of its warpgroup: A row 16 w + g + 8 (j & 1), K columns 2q + 8 (j >> 1)
    (low half) and the next (high half)), where A row g (g + 8) of tile t
    is the thread's column c + 2t (c + 2t + 1), c = 16 MT w + 2 MT g: each
    (column, K row) of the stage exactly once, equal to the int8 value."""
    rng = np.random.default_rng(mt * 1000 + rb + warps)
    w = rng.integers(0, 256, (128, rb), dtype=np.uint8)
    smem = np.zeros(128 * rb, np.uint8)
    for r in range(128):
        for c in range(rb):
            smem[_swz(rb, r, c)] = w[r, c]
    val = w.astype(np.int64)
    val[val >= 128] -= 256
    seen = np.zeros((rb, 128), np.int64)
    for warp in range(warps):
        for ks in range(8):
            if mt == 1:
                if ks % 2:
                    continue
                regs = _ldsm4_trans(smem, [_swz(rb, 16 * ks + lane, 16 * warp)
                                           for lane in range(32)])
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                c = 16 * mt * warp + 2 * mt * g
                if mt == 1:
                    steps = {ks: _f16_frags_mt1(regs[lane, 0], regs[lane, 1]),
                             ks + 1: _f16_frags_mt1(regs[lane, 2],
                                                    regs[lane, 3])}
                    frags = {s: [a] for s, a in steps.items()}
                else:
                    r = 16 * ks + 2 * q
                    words = [int(smem[_swz(rb, rr, c):_swz(rb, rr, c) + 4]
                                 .view(np.uint32)[0])
                             for rr in (r, r + 1, r + 8, r + 9)]
                    frags = {ks: _f16_frags_mt2(words)}
                for s, a in frags.items():
                    for t in range(mt):
                        for j in range(4):
                            col = c + 2 * t + (j & 1)
                            vals = _f16x2(a[t][j]).astype(np.float32)
                            for half in range(2):
                                kr = 16 * s + 2 * q + 8 * (j >> 1) + half
                                assert vals[half] == val[kr, col]
                                seen[col, kr] += 1
    np.testing.assert_array_equal(seen, np.ones_like(seen))


# -- P2's fast divide: a numpy model of quot_fast ----------------------------

def _rn32(s, e):
    """RN to f32 of the exact s + e (an f64 pair): s's own rounding except
    where s lies on an f32 midpoint and e decides."""
    f = s.astype(np.float32)
    fd = f.astype(np.float64)
    up = np.nextafter(f, np.float32(np.inf)).astype(np.float64)
    dn = np.nextafter(f, np.float32(-np.inf)).astype(np.float64)
    out = f.copy()
    on_up, on_dn = s == (fd + up) / 2, s == (fd + dn) / 2
    out[on_up & (e > 0)] = up[on_up & (e > 0)].astype(np.float32)
    out[on_dn & (e < 0)] = dn[on_dn & (e < 0)].astype(np.float32)
    return out


def _fma32(a, b, c):
    """RN32(a b + c) exactly: the product is exact in f64, the sum exact as
    an f64 pair (TwoSum)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    cc = c.astype(np.float64)
    s = p + cc
    bb = s - p
    return _rn32(s, (p - (s - bb)) + (cc - bb))


def _quot(a, s, y, corrections):
    q = (a.astype(np.float64) * y.astype(np.float64)).astype(np.float32)
    for _ in range(corrections):
        q = _fma32(_fma32(-q, s, a), y, q)
    return q


def test_fma_model_is_exact():
    """The model's fma against exact rational arithmetic."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal(300).astype(np.float32)
    b = rng.standard_normal(300).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(300)
                                        * 2.0 ** -20)).astype(np.float32)
    got = _fma32(a, b, c)
    for i in range(300):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # RN of the rational: the nearer neighbour, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32))
                                         & 1))
        assert got[i] == best, i


def test_quot_fast_two_corrections_are_correctly_rounded():
    """quot_fast over every scale significand a P2 row can take (s = RN(amax
    / 448), amax's 128 bf16 significands) against 2^14 dividend
    significands each (every bf16 one among them): with two corrections
    the correctly rounded quotient everywhere.  One correction needs a
    faithful first quotient (trap 73); this sample holds no divisor where
    it fails, which the last assert records."""
    amax = (256.0 + 2.0 * np.arange(128)).astype(np.float32)
    s = (amax.astype(np.float64) / 448.0).astype(np.float32)
    rng = np.random.default_rng(7)
    sig = np.concatenate([np.arange(128) << 16,
                          rng.integers(0, 1 << 23, (1 << 14) - 128)])
    for e in (-10, 0, 8):
        a = ((np.uint32(e + 127) << 23) | sig.astype(np.uint32)).view(
            np.float32)
        aa, ss = np.meshgrid(a, s)
        aa, ss = aa.ravel(), ss.ravel()
        y = (1.0 / ss.astype(np.float64)).astype(np.float32)
        want = (aa.astype(np.float64) / ss).astype(np.float32)
        np.testing.assert_array_equal(_quot(aa, ss, y, 2), want)
        assert (_quot(aa, ss, y, 1) == want).all()


# -- the direct-int8 decoder against the JAX package ------------------------

def _paged_int8_run():
    jp, tp = serve._artifact("int8")
    jsc, tsc = _cfgs("int8", "int8", paged_decode_impl="kernel")
    table = np.arange(8, dtype=np.int32).reshape(2, 4)
    j = dataclasses.replace(JPaged.create(8, 8, 2, 2, 4, 2, 16, "int8"),
                            page_table=jnp.asarray(table))
    t = PagedKVCache.create(8, 8, 2, 2, 4, 2, 16, "int8", device="cpu")
    t.page_table = torch.from_numpy(table.copy())
    tok, pos = np.array([3, 4], np.int32), np.array([5, 2], np.int32)
    zero = np.zeros(2, np.float32)
    with jax.disable_jit():
        jt, jpool = jmodel.decode_steps_paged(
            jp, j, jnp.asarray(tok), jnp.asarray(pos), jax.random.key(0),
            jnp.asarray(zero), 3, jsc, greedy_only=True)
        jl, jpool = jmodel.decode_step_paged(jp, jpool, jt[:, -1], pos + 3,
                                             jsc)
    tt, t = decode_steps_paged(tp, t, torch.from_numpy(tok),
                               torch.from_numpy(pos), None,
                               torch.from_numpy(zero), 3, tsc,
                               greedy_only=True)
    tl, t = decode_step_paged(tp, t, torch.from_numpy(np.asarray(jt)[:, -1]
                                                      .copy()),
                              torch.from_numpy(pos + 3), tsc)
    return (np.asarray(jt), np.asarray(jl), jpool, tt.numpy(), tl.numpy(),
            t)


def test_direct_int8_paged_decode_matches_jax_unjitted():
    """int8 weights, direct linears, the paged pool through K4's plain
    version: 3 greedy steps and a fourth's logits against the un-jitted
    JAX functions, the pool's bytes."""
    jt, jl, jpool, tt, tl, t = _paged_int8_run()
    np.testing.assert_array_equal(tt, jt)
    assert np.abs(tl - jl).max() <= EAGER_TOL * np.abs(jl).max()
    assert (raw(t.pool) == raw(jpool.pool)).mean() >= 0.99


def test_direct_int8_moe_decode_matches_jax():
    """An int8 MoE artifact with direct linears: prefill and a ring step
    against the un-jitted JAX functions."""
    import test_torch_serve_moe as moe
    jp, tp = moe._artifact("int8")
    jsc, tsc = moe._cfgs("int8", "int8")
    jsc = dataclasses.replace(jsc, matmul_impl="direct")
    tsc = dataclasses.replace(tsc, matmul_impl="direct")
    with jax.disable_jit():
        pairs, jr, tr = _moe_ring(jp, tp, jsc, tsc)
    for want, got in pairs:
        assert np.abs(got - want).max() <= EAGER_TOL * np.abs(want).max()
    assert (raw(tr.kv8) == raw(jr.kv8)).mean() >= 0.99

