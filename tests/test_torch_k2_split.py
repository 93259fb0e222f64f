"""K2's tensor-core design, checked through its plain versions on the CPU:
the cast pre-pass (grid values, then the epilogue's descale) against the
plain casts bit for bit; the exact bf16 split; the split product's
distance from the exact product of the cast operands
(``chip_smoke.k2_reference``, with and without the ``lo`` plane); the
implicit conv's scale over the gathered positions against the im2col's.
The kernels themselves are held to the same references on the card
(``chip_smoke.py``'s k2 phase, ``tests/test_torch_gpu.py``)."""

import os
import sys

import numpy as np
import pytest
import torch

from fp8tpu_torch import linen
from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.kernels import qmatmul
from fp8tpu_torch.kernels.cast_kernel import FMT_IDS
from fp8tpu_torch.numerics.formats import RoundMode
from fp8tpu_torch.numerics.scaling import per_tensor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import k2_ratio, k2_reference  # noqa: E402

RNE, SR = RoundMode.RNE, RoundMode.STOCHASTIC

EDGES = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1e-39,
         -3e-39, 2.0 ** -149, 1.1e-38, 2.0 ** -126, 1.0, -1.0, 448.0,
         -480.0, 57344.0, 65504.0, 1e6, -3.0e38, 2.0 ** -16, 3 * 2.0 ** -11]


def _values(seed=0, n=2048):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * np.exp(rng.uniform(-30, 12, n))).astype(
        np.float32)
    v[:len(EDGES)] = EDGES
    return torch.from_numpy(v)


def _bits(t):
    return t.detach().to(torch.float32).contiguous().view(torch.int32)


# Every format under the bit pipeline, the hw route's native formats under
# "hw"; RNE and SR where the format has SR.
PREPASS_CASES = (
    [("bitexact", f, m) for f in FMT_IDS for m in (RNE, SR)
     if not (m == SR and f in ("fp4", "e5m2_noinf", "e5m2_flex"))]
    + [("hw", f, m) for f in qmatmul.HW_KERNEL_FMTS for m in (RNE, SR)]
    + [("hw", "float16", RNE), ("hw", "e3m4", SR)])


@pytest.mark.parametrize("impl,fmt,mode", PREPASS_CASES)
@pytest.mark.parametrize("scale", [1.0, 3.7, 2.0 ** -20])
def test_prepass_then_descale_is_the_cast(impl, fmt, mode, scale):
    """(a) The pre-pass's grid values with the epilogue's descale applied
    are the plain cast bit for bit, NaN, inf, -0 and f32 subnormals
    included; and a 1-plane format's grid values are exact in bf16."""
    v = _values()
    key = qmatmul.sr_key(5, 1, fmt, mode)
    s = torch.tensor(scale)
    want = qmatmul.cast_operand(v, fmt, mode, s, impl, key)
    grid = qmatmul.grid_operand(v, fmt, mode, s, impl, key)
    got = qmatmul.descale(grid, qmatmul.descale_kind(fmt, impl), s)
    assert torch.equal(_bits(got), _bits(want))
    hi, mid, lo = qmatmul.split_bf16(grid)
    finite = torch.isfinite(grid)
    if qmatmul.planes_of(fmt) == 1:
        assert torch.equal(_bits(hi.float())[finite], _bits(grid)[finite])
        assert not bool(mid.float().any()) and not bool(lo.float().any())
    else:
        total = (hi.float() + mid.float()) + lo.float()
        assert torch.equal(total[finite], grid[finite])


def test_bf16_split_is_exact():
    """(b) hi + mid + lo equals the f32 input bit for bit over the range
    where bf16's least subnormal (2^-133) holds lo's bits (|v| >= 2^-110),
    extremes included; smaller values lose at most 2^-134; inf and NaN
    go to hi whole; hi keeps the sign of zero."""
    rng = np.random.default_rng(1)
    e = rng.uniform(-110, 127, 20000)
    v = (np.sign(rng.standard_normal(20000)) * np.exp2(e)
         * rng.uniform(1, 1.99, 20000)).astype(np.float32)
    u = v.view(np.uint32) | rng.integers(0, 2 ** 23, 20000).astype(np.uint32)
    v = u.view(np.float32)
    extremes = np.float32([3.4028235e38, -3.4028235e38, 2.0 ** -110,
                           -(2.0 ** -110), 1.0, -1.0, 1.0000001,
                           1.9999999, 2.0 ** 127 * 1.9999999])
    v = torch.from_numpy(np.concatenate([v[np.isfinite(v)], extremes]))
    hi, mid, lo = qmatmul.split_bf16(v)
    total = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(_bits(total), _bits(v))
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())

    tiny = torch.tensor([1e-40, -3e-39, 2.0 ** -149, 1.1e-38, 2.0 ** -120])
    hi, mid, lo = qmatmul.split_bf16(tiny)
    err = (hi.double() + mid.double() + lo.double() - tiny.double()).abs()
    assert float(err.max()) <= 2.0 ** -134

    special = torch.tensor([np.inf, -np.inf, np.nan, -0.0, 0.0])
    hi, mid, lo = qmatmul.split_bf16(special)
    assert torch.isinf(hi[:2].float()).all() and torch.isnan(hi[2].float())
    assert torch.equal(torch.signbit(hi[3:].float()),
                       torch.tensor([True, False]))
    assert not bool(mid.float().any()) and not bool(lo.float().any())


def _split_product(a, b, keep):
    """sum over plane pairs (i, j) with keep(i, j) of a_i @ b_j, each an
    f32 product of bf16 planes, added in f32 (the kernel's promotion)."""
    pa, pb = qmatmul.split_bf16(a), qmatmul.split_bf16(b)
    out = torch.zeros(a.shape[0], b.shape[1])
    with full_fp32():
        for i in range(3):
            for j in range(3):
                if keep(i, j):
                    out = out + pa[i].float() @ pb[j].float()
    return out


@pytest.mark.parametrize("shape", [(64, 64, 48), (40, 32, 70), (16, 100, 8)])
@pytest.mark.parametrize("cast_x", [True, False])
def test_split_product_within_k2_reference(shape, cast_x):
    """(c) The split product (3 MMAs a product for a cast e4m3 activation
    against an uncast weight, 6 for two uncast operands), descaled as the
    epilogue does, lies within k2_reference of the exact product; with
    the lo plane dropped it lies outside."""
    m, k, n = shape
    g = torch.Generator().manual_seed(k)
    x = torch.randn(m, k, generator=g) * 3
    w = torch.randn(k, n, generator=g) / k ** 0.5
    if cast_x:
        s = per_tensor(x, "e4m3")
        xg = qmatmul.grid_operand(x, "e4m3", RNE, s, "bitexact", None)
        xq = qmatmul.cast_operand(x, "e4m3", RNE, s, "bitexact", None)
        kind, keep_all = 1, (lambda i, j: i == 0)
        keep_no_lo = (lambda i, j: i == 0 and j < 2)
    else:
        s, xg, xq, kind = 1.0, x, x, 0
        keep_all = (lambda i, j: i + j <= 2)
        keep_no_lo = (lambda i, j: i < 2 and j < 2)
    exact, tol = k2_reference(xq, w)
    got = qmatmul.descale(_split_product(xg, w, keep_all), kind, s)
    assert k2_ratio(got, exact, tol) <= 0.5
    dropped = qmatmul.descale(_split_product(xg, w, keep_no_lo), kind, s)
    assert k2_ratio(dropped, exact, tol) > 1.0


# Conv geometries: every conv of resnet50 (1x1 stride 1 and 2, 3x3 stride
# 1 and 2 with pad 1, the 7x7 stem) at its input sizes, SAME and VALID,
# and odd sizes.
GEOMETRIES = (
    [(1, 1, "SAME", h) for h in (56, 28, 14, 7)]
    + [(1, 2, "SAME", h) for h in (56, 28, 14)]
    + [(3, s, [(1, 1), (1, 1)], h) for s in (1, 2) for h in (56, 28, 14, 7)]
    + [(7, 2, [(3, 3), (3, 3)], 224)]
    + [(k, s, p, h) for k in (1, 3) for s in (1, 2) for p in ("SAME", "VALID")
       for h in (9, 15)]
    + [(3, 2, [(1, 1), (1, 1)], h) for h in (9, 13)])


@pytest.mark.parametrize("k,s,padding,h", GEOMETRIES)
def test_conv_scale_over_gathered_positions(k, s, padding, h):
    """(d) The implicit conv's per-tensor scale, taken over the positions
    the im2col gathers, equals per_tensor(im2col) bit for bit, also when
    the largest element lies where a strided 1x1 conv does not look."""
    g = torch.Generator().manual_seed(h * 10 + k)
    x = torch.randn(2, 3, h, h, generator=g)
    x[0, 1, h - 1, h - 1] = 100.0          # skipped by 1x1 stride 2, odd h
    x[1, 2, 1, 1] = -50.0                  # skipped by 1x1 stride 2
    pads = linen.conv_padding(padding, (h, h), (k, k), (s, s))
    col = qmatmul.im2col(x, (k, k), (s, s), pads)[0]
    part = qmatmul.gathered(x, (k, k), (s, s), pads)
    for fmt in ("e4m3", "e5m2"):
        want = per_tensor(col, fmt)
        got = per_tensor(part, fmt)
        assert torch.equal(_bits(got), _bits(want))
    if k == 1 and s == 2:
        assert part.numel() < x.numel()
    x[0, 0, 0, 0] = float("nan")
    assert bool(torch.isnan(per_tensor(qmatmul.gathered(
        x, (k, k), (s, s), pads), "e4m3")))


def test_conv_plain_is_im2col_and_k2_plain():
    """The implicit conv's plain version (the CPU route of qmatmul.conv)
    is im2col followed by K2's plain version, NCHW out."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 9, 9, generator=g).relu()
    w = torch.randn(7, 5, 3, 3, generator=g)
    pads = ((1, 1), (1, 1))
    s = per_tensor(qmatmul.gathered(x, (3, 3), (2, 2), pads), "e4m3")
    got = qmatmul.conv(x, w, (2, 2), pads, "e4m3", RNE, s)
    col, oh, ow = qmatmul.im2col(x, (3, 3), (2, 2), pads)
    want = qmatmul.plain(col, w.reshape(7, -1).t(), "e4m3", RNE, None, RNE,
                         s, 1.0)
    assert torch.equal(got, want.reshape(2, oh, ow, 7).permute(0, 3, 1, 2))
