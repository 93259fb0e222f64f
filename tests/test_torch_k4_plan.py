"""K4 (paged decode attention, ``fp8tpu_torch/kernels/csrc/
paged_attention.cu``) on the CPU: its host-side plan (``n_splits``,
``token_ranges``), a torch twin of its int8 upcast and the exactness of
its fp8 upcast over all 256 bytes, and a torch twin of its order of work
(each warp's own recurrence over 16-token chunks, the warps merged, then
the splits) held to the plain version and to the Pallas
kernel in interpret mode.  The kernel itself runs only on the card (chip_smoke.py
k4; tests/test_torch_gpu.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fp8tpu.kernels.paged_attention import paged_decode_attention as j_k4
from fp8tpu_torch.kernels import paged_attention as k4

LENS = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 444, 511, 512]
SMS = (132, 114)


@pytest.mark.parametrize("sms", SMS)
def test_plan_covers_every_token_below_lens_once(sms):
    for batch in range(1, 65):
        splits = k4.n_splits(batch, 8, 512, sms)
        assert 1 <= splits <= k4.MAX_SPLITS
        # one wave of BLOCKS_PER_SM blocks an SM, unless one split is more
        assert splits == 1 or batch * 8 * splits <= k4.BLOCKS_PER_SM * sms
        for length in LENS:
            seen = np.zeros(512, np.int64)
            last = -1
            for z, w, lo, hi in k4.token_ranges(length, splits):
                assert 0 <= z < splits and z >= last      # contiguous runs
                assert 0 <= w < k4.WARPS
                assert lo % k4.CHUNK == 0 and 0 < hi - lo <= k4.CHUNK
                seen[lo:hi] += 1
                last = z
            assert (seen[:length] == 1).all() and (seen[length:] == 0).all()


def test_plan_at_the_served_shapes():
    # splits fill one wave of BLOCKS_PER_SM blocks an SM
    assert k4.n_splits(8, 8, 512, 132) == 4
    assert k4.n_splits(64, 8, 512, 132) == 1
    assert k4.n_splits(1, 8, 512, 132) == 8          # no more than rounds
    assert k4.n_splits(33, 8, 512, 132) == 1
    assert k4.n_splits(132, 8, 512, 132) == 1
    # position 444 at 4 splits: 28 chunks, 7 a split, 1-2 a warp
    r = k4.token_ranges(444, 4)
    assert len(r) == 28 and {z for z, *_ in r} == set(range(4))
    assert {(z, w) for z, w, *_ in r} == {(z, w) for z in range(4)
                                          for w in range(4)}


def int8_upcast_twin(w: np.ndarray):
    """paged_attention.cu::upcast4 for int8, on 32-bit words of 4 bytes:
    bytes 0 and 2 (then 1 and 3, shifted down a byte) as the bf16 pair
    0x4300 | (v & 127), minus the pair 0x4300 | (v & 128): 128 + (v & 127)
    minus 128 or 256.  Returns (p02, p13) as f32 pairs; the bf16
    subtraction is exact, so f32 computes it alike."""
    def bf16(bits):
        return (bits.astype(np.uint32) << 16).view(np.float32)

    def pair(x):
        a = (x & 0x007F007F) | 0x43004300
        c = (x & 0x00800080) | 0x43004300
        return np.stack([bf16(a & 0xFFFF) - bf16(c & 0xFFFF),
                         bf16(a >> 16) - bf16(c >> 16)], -1)
    w = w.astype(np.uint32)
    return pair(w), pair(w >> 8)


def test_int8_upcast_twin_over_every_byte():
    b = np.arange(256, dtype=np.uint32)
    # every byte in every position of the word
    words = b | (b[::-1] << 8) | (((b + 85) % 256) << 16) | (
        ((b + 170) % 256) << 24)
    p02, p13 = int8_upcast_twin(words)
    as_int8 = lambda x: (x.astype(np.uint8)).view(np.int8).astype(np.float32)
    np.testing.assert_array_equal(p02[:, 0], as_int8(b))
    np.testing.assert_array_equal(p13[:, 0], as_int8(b[::-1]))
    np.testing.assert_array_equal(p02[:, 1], as_int8((b + 85) % 256))
    np.testing.assert_array_equal(p13[:, 1], as_int8((b + 170) % 256))
    # the pair's values are exact in bf16 (|v| <= 128)
    t = torch.from_numpy(np.concatenate([p02, p13]).ravel())
    assert torch.equal(t.to(torch.bfloat16).to(torch.float32), t)


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_upcast_is_exact_in_bf16(dtype):
    v = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dtype)
    f = v.to(torch.float32)
    keep = ~torch.isnan(f)
    assert torch.equal(f[keep].to(torch.bfloat16).to(torch.float32), f[keep])


def kernel_order_twin(q, pool, sc, table, lens, layer, page, kv, splits):
    """The kernel's order of work in torch, f32: per (slot, kv head) and
    split, each warp's recurrence over its chunks (scale after the dot,
    -1e30 and p = 0 past lens, pv rounded to bf16, alpha rescaling), the
    warps merged in order, then the splits in order."""
    B, KVG, D = q.shape
    G = KVG // kv
    acc = torch.zeros(B, KVG, D)
    m = torch.full((B, KVG), -1e30)
    l = torch.zeros(B, KVG)
    raw = pool.view(torch.uint8 if pool.element_size() == 1 else torch.int16)

    def row(b, kvh, sel, pos):
        pg = int(table[b, pos // page].clamp(min=0))
        t = pos % page
        return raw[pg, sel, layer, t * kv + kvh].view(pool.dtype).float(), \
            float(sc[pg, sel, layer, t * kv + kvh])

    def merge(states):
        mt = torch.stack([s[0] for s in states]).amax(0)
        ws = [torch.exp(s[0] - mt) for s in states]
        return (mt, sum(s[1] * w for s, w in zip(states, ws)),
                sum(s[2] * w[:, None] for s, w in zip(states, ws)))

    for b in range(B):
        length = int(lens[b].clamp(0, table.shape[1] * page))
        plan = k4.token_ranges(length, splits)
        for kvh in range(kv):
            qh = q[b, kvh * G:(kvh + 1) * G].float()
            parts = []
            for z in range(splits):
                warps = []
                for w in range(k4.WARPS):
                    mw = torch.full((G,), -1e30)
                    lw, aw = torch.zeros(G), torch.zeros(G, D)
                    for zz, ww, lo, hi in plan:
                        if (zz, ww) != (z, w):
                            continue
                        k = torch.stack([row(b, kvh, 0, t)[0]
                                         for t in range(lo, hi)])
                        ks = torch.tensor([row(b, kvh, 0, t)[1]
                                           for t in range(lo, hi)])
                        v = torch.stack([row(b, kvh, 1, t)[0]
                                         for t in range(lo, hi)])
                        vs = torch.tensor([row(b, kvh, 1, t)[1]
                                           for t in range(lo, hi)])
                        s = (qh @ k.T) * ks                     # (G, n)
                        m_new = torch.maximum(mw, s.amax(1))
                        alpha = torch.exp(mw - m_new)
                        p = torch.exp(s - m_new[:, None])
                        lw = lw * alpha + p.sum(1)
                        pv = (p * vs).to(torch.bfloat16).float()
                        aw = aw * alpha[:, None] + pv @ v
                        mw = m_new
                    warps.append((mw, lw, aw))
                parts.append(merge(warps))
            mt, lt, at = merge(parts) if splits > 1 else parts[0]
            m[b, kvh * G:(kvh + 1) * G] = mt
            l[b, kvh * G:(kvh + 1) * G] = lt
            acc[b, kvh * G:(kvh + 1) * G] = at
    return acc, m, l


@pytest.mark.parametrize("fmt", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("splits", [1, 3])
def test_kernel_order_twin_matches_plain_and_pallas(fmt, splits):
    """Exact-dot data (q on a 1/8 grid, payloads on a 1/4 grid): m
    bit-equal; l within T * 2^-22 relative and acc within one bf16 step of
    sum |pv v| (the bounds of tests/test_torch_gpu.py)."""
    gen = torch.Generator().manual_seed(8)
    B, KV, G, D, page, MP, L = 3, 2, 2, 16, 8, 9, 2
    P = B * MP + 1
    pool = (torch.randint(-15, 16, (P, 2, L, page * KV, D), generator=gen
                          ).float() * 0.25).to(fmt)
    sc = torch.empty(P, 2, L, page * KV).uniform_(0.004, 0.02, generator=gen)
    q = (torch.randint(-16, 17, (B, KV * G, D), generator=gen).float() / 8
         ).to(torch.bfloat16)
    lens = torch.tensor([0, 17, MP * page], dtype=torch.int32)
    table = torch.randperm(P, generator=gen)[:B * MP].reshape(B, MP).to(
        torch.int32)
    table[torch.arange(MP)[None] * page >= lens[:, None]] = -1
    kw = dict(page_size=page, kv_heads=KV)
    want = k4.paged_decode_attention_plain(q, pool, sc, table, lens, 1, **kw)
    got = kernel_order_twin(q, pool, sc, table, lens, 1, page, KV, splits)
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    rel = MP * page * 2.0 ** -22
    assert bool(((got[2] - want[2]).abs() <= want[2] * rel).all())
    bound = (0.02 * 3.75 * want[2] * (rel + 2.0 ** -7))[..., None] + 1e-30
    assert bool(((got[0] - want[0]).abs() <= bound).all())

    jpool = pool.view(torch.uint8).numpy() if fmt != torch.int8 \
        else pool.numpy()
    if fmt != torch.int8:
        jpool = jnp.asarray(jpool).view(jnp.float8_e4m3fn)
    ja, jm, jl = (np.asarray(t) for t in j_k4(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(jpool), jnp.asarray(sc.numpy()),
        jnp.asarray(table.numpy()), jnp.asarray(lens.numpy()),
        jnp.asarray([1], jnp.int32), page_size=page, kv_heads=KV,
        interpret=True))
    np.testing.assert_array_equal(jm, got[1].numpy())
    assert (np.abs(jl - got[2].numpy()) <= 2 * want[2].numpy() * rel).all()
    assert (np.abs(ja - got[0].numpy()) <= 2 * bound.numpy()).all()
