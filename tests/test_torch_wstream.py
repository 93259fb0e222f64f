"""The streaming loop of the weight GEMMs (``fp8tpu_torch/kernels/csrc/
w_stream.cuh``, run by K3, K5 and T2 for M <= 64) on the CPU: its host-side
plan (``qmatmul.stream_plan``), and torch twins of its in-register converts
held bit-equal to the plain versions.  The kernel itself runs only on the
card (chip_smoke.py's k3, k5 and t2 phases, tests/test_torch_gpu.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fp8tpu_torch.kernels import int4_matmul, qmatmul

# (K, N) of the serving linears at full width: q/o, k/v, gate/up, down.
SERVE_KN = [(4096, 4096), (4096, 1024), (4096, 11008), (11008, 4096)]
SMS = (132, 114)                 # H100 SXM and PCIe


@pytest.mark.parametrize("kind", ["w8", "int4", "bf16"])
@pytest.mark.parametrize("k,n", SERVE_KN + [(512, 256), (640, 272)],
                         ids=lambda v: str(v))
def test_stream_plan_covers_every_k_row_once(k, n, kind):
    bk = qmatmul.STREAM_BK[kind]
    for sms in SMS:
        for m in range(1, 65):
            plan = qmatmul.stream_plan(m, n, k, sms, kind)
            assert plan.bk == bk and plan.mt in (1, 2)
            assert 1 <= plan.splits <= 8
            tiles = -(-n // (64 * plan.mt))
            assert plan.splits == 1 or tiles <= 4096      # tile counters
            assert plan.kper % bk == 0                    # whole stages
            # the splits' ranges [z kper, (z + 1) kper) partition [0, K)
            rows = np.zeros(k, dtype=np.int64)
            for z in range(plan.splits):
                rows[z * plan.kper:min(k, (z + 1) * plan.kper)] += 1
            assert (rows == 1).all(), (m, sms)
            assert (plan.splits - 1) * plan.kper < k
            # promoted chunks: at most 512 rows, never across a split
            edges = qmatmul.promotion_edges(k, plan.kper)
            assert edges[0] == 0 and edges[-1] == k
            assert all(0 < b - a <= qmatmul.STREAM_PROMOTE
                       for a, b in zip(edges, edges[1:]))
            assert set(range(0, k, plan.kper)) <= set(edges)


def test_stream_plan_fills_the_card():
    """Tiles times splits: N = 1024 takes 64-column tiles (16 x 8 blocks),
    and M > 16 takes one block an SM where that needs no more splits."""
    assert qmatmul.stream_plan(8, 1024, 4096, 132)[:1] == (1,)
    assert qmatmul.stream_plan(8, 1024, 4096, 132).splits == 8
    for m, n, k, want in [(8, 11008, 4096, (2, 3)), (64, 11008, 4096, (2, 3)),
                          (8, 4096, 4096, (2, 8)), (64, 4096, 4096, (2, 4)),
                          (64, 4096, 11008, (2, 4))]:
        plan = qmatmul.stream_plan(m, n, k, 132)
        assert (plan.mt, plan.splits) == want, (m, n, k)


def test_streaming_routes_grouped_scales():
    x = torch.zeros(8, 256, dtype=torch.bfloat16)
    wp = torch.zeros(128, 64, dtype=torch.uint8)
    for group, ok in [(None, True), (16, True), (64, True), (128, True),
                      (256, True), (384, True), (8, False), (48, False),
                      (96, False)]:
        assert qmatmul.streams(8, 64, 256, x, wp, group=group) == ok, group


def _bf16_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns (16 bits) of a bf16 tensor."""
    return v.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """bf16 from 16-bit patterns held in int64."""
    return (b & 0xFFFF).to(torch.int32).to(torch.int16).view(torch.bfloat16)


def nibbles_twin(byte: torch.Tensor, next_byte: torch.Tensor):
    """The kernel's nibbles_bf16x2 on __byte_perm(p, p >> 4, sel): the
    byte in bits 0-15, (p >> 4)'s byte (whose high half is the next byte's
    low nibble) in bits 16-31; mask, XOR with 0x43084308 (the bf16 of
    128 + (u ^ 8) in each half), then one bf16 fma by 1 and -136, exact.
    Returns the low- and high-nibble bf16 planes."""
    b = byte.to(torch.int64)
    hb = (b >> 4) | ((next_byte.to(torch.int64) & 0xF) << 4)
    word = b | (b << 8) | (hb << 16) | (hb << 24)
    v = (word & 0x000F000F) ^ 0x43084308
    lo, hi = _from_bits(v), _from_bits(v >> 16)
    return ((lo.float() - 136.0).to(torch.bfloat16),
            (hi.float() - 136.0).to(torch.bfloat16))


def scale_twin(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """scale_bf16x2: fma(w, s, -0) with one rounding to bf16; the product
    of a nibble and a bf16 scale is exact in f32."""
    return (w.float() * s.float() + (-0.0)).to(torch.bfloat16)


def test_int4_sign_extension_twin_is_exact():
    bytes_ = torch.arange(256, dtype=torch.int64)
    nxt = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, 256)).to(torch.int64)
    lo, hi = nibbles_twin(bytes_, nxt)
    want_lo, want_hi = (p.to(torch.bfloat16) for p in int4_matmul.unpack_int4(
        bytes_.to(torch.uint8).reshape(256, 1)))
    assert torch.equal(_bf16_bits(lo), _bf16_bits(want_lo.reshape(-1)))
    assert torch.equal(_bf16_bits(hi), _bf16_bits(want_hi.reshape(-1)))


def _scale_sweep() -> torch.Tensor:
    """bf16 scales: the smallest normal and subnormals, powers of two over
    the whole range, random mantissas, and their negatives."""
    tiny = 2.0 ** -126
    vals = [tiny, tiny * 1.5, 2.0 ** -127, 2.0 ** -133, 3 * 2.0 ** -133,
            127 * 2.0 ** -133, 1.0, 0.0078125, 3.0e38]
    vals += [2.0 ** e for e in range(-126, 128, 7)]
    rng = np.random.default_rng(1)
    vals += list(rng.standard_normal(64) * 10.0 ** rng.integers(-30, 30, 64))
    s = torch.tensor(vals, dtype=torch.float32).to(torch.bfloat16)
    return torch.cat([s, -s])


def test_grouped_scale_twin_matches_the_plain_bf16_multiply():
    s = _scale_sweep()
    bytes_ = torch.arange(256, dtype=torch.int64)
    lo, hi = nibbles_twin(bytes_, bytes_.flip(0))
    plo, phi = (p.to(torch.bfloat16) for p in int4_matmul.unpack_int4(
        bytes_.to(torch.uint8).reshape(256, 1)))
    for twin, plain in ((lo, plo.reshape(-1)), (hi, phi.reshape(-1))):
        got = scale_twin(twin[:, None], s[None, :])
        want = plain[:, None] * s[None, :]       # the plain version's multiply
        assert torch.equal(_bf16_bits(got), _bf16_bits(want))


def test_int8_convert_twin_is_exact():
    """S8<INT8>::cvt2: 0x4300 | (b & 127) is the bf16 of 128 + (b & 127),
    0x4300 | (b & 128) that of 128 or 256, and one bf16 fma (the first
    times -1 plus the second, exact) leaves the signed byte."""
    b = torch.arange(256, dtype=torch.int64)
    pos = _from_bits(0x4300 | (b & 0x7F))
    neg = _from_bits(0x4300 | (b & 0x80))
    f = (neg.float() * -1.0 + pos.float()).to(torch.bfloat16)
    assert torch.equal(_bf16_bits(f), _bf16_bits(
        b.to(torch.uint8).view(torch.int8).to(torch.bfloat16)))
