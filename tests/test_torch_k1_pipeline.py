"""The cast kernel's (K1, ``fp8tpu_torch/kernels/csrc/cast_kernel.cu``)
arithmetic routes on the CPU.

``cast.cuh`` has two routes to the same bits: the bit-level emulation, and
a hardware route that runs the pipeline's ends as single instructions
(``mul.rn.ftz.f32`` for the scale, ``cvt.rn.f16.f32`` to the f16 pattern,
``cvt.f32.f16`` back, a plain multiply by 1/scale) and leaves an element
to the emulation where the scaled value is NaN, or every element where
1/scale fails ``fast_inv``.  Here a torch twin of the hardware route
(torch's own f32 -> f16 convert is round-to-nearest-even, as the card's)
is held bit-equal to :func:`numerics.cast.qdq_plain` for every variant of
``FP8_CAST_VARIANTS``, over a stratified sweep of f32 bit patterns; and
the kernel's multiply-shift division (its broadcast scales) is held to
integer division.  The kernel itself runs only on the card (chip_smoke.py
k1, with every f32 bit pattern; tests/test_torch_gpu.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fp8tpu_torch.kernels import cast_kernel
from fp8tpu_torch.numerics import cast as tcast
from fp8tpu_torch.numerics.formats import RoundMode

_MODES = [RoundMode.RNE, RoundMode.STOCHASTIC, RoundMode.RNAZ,
          RoundMode.RNTZ, RoundMode.RPINF, RoundMode.RNINF, RoundMode.RTZ]

# FP8_CAST_VARIANTS of cast.cuh: (format, mode, daz)
VARIANTS = (
    [("e5m2", m, d) for d in (False, True) for m in _MODES]
    + [(f, m, False) for f in ("e4m3", "e4m3_ieee", "e3m4", "e4m3_v2")
       for m in _MODES]
    + [("fp4", RoundMode.RNE, False), ("bfloat16", RoundMode.RNE, False),
       ("bfloat16", RoundMode.STOCHASTIC, False),
       ("float16", RoundMode.RNE, False), ("float16", RoundMode.RNE, True),
       ("float16", RoundMode.STOCHASTIC, False),
       ("e5m2_noinf", RoundMode.RNE, False),
       ("e5m2_flex", RoundMode.RNE, False)]
)

# cast.cuh::has_hw_route
HW_FORMATS = ("e5m2", "e4m3", "e4m3_ieee", "e3m4", "e4m3_v2", "e5m2_noinf")

# 1/scale at, just inside and just outside fast_inv's edges (2^-102 and
# the largest finite float), and common calibrated scales
SCALES = (1.0, 3.7, 448.0 / 3.7, 1e-3, 6.55e4, 2.0 ** 101, 2.0 ** 102 * 1.5,
          1e36, 1e-37, 2.0 ** -126)


def _f32(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32))


def stratified_sweep() -> torch.Tensor:
    """Every exponent x boundary mantissas (the f16 rounding point at bit
    13, the fp8 ones above it, sticky bits), both signs; f32 and f16
    subnormals; ±0, ±inf; NaN payloads of both signs."""
    cut = [0, 1, 0xFFF, 0x1000, 0x1001, 0x1FFF, 0x2000, 0x3000]
    mants = set(cut)
    for b in (13, 18, 19, 20, 21, 22):      # f16 and fp8 grid points
        for base in (0, 1 << b):
            for d in (-1, 0, 1):
                mants.add((base + (1 << (b - 1)) + d) & 0x7FFFFF)
                mants.add((base | ((1 << b) - 1)) & 0x7FFFFF)
    mants |= {0x7FFFFF, 0x400000, 0x3FFFFF, 0x600000, 0x200000, 0x555555}
    rng = np.random.default_rng(0)
    bits = [e << 23 | m for e in range(255) for m in sorted(mants)]
    bits += [int(v) for v in rng.integers(0, 255 << 23, 4000)]
    bits += [0x7F800000, 0x7F800001, 0x7FC00000, 0x7FFFFFFF, 0x7FA00000,
             0x7F812345]
    bits = np.array(bits, np.uint32)
    return _f32(np.concatenate([bits, bits | 0x80000000]))


class HwRoute:
    """The hardware route's ends as torch ops, patched into the plain
    pipeline; ``bad`` collects the elements whose scaled value is NaN."""

    def __init__(self):
        self.bad = None

    def to_f16_bits(self, x, scale):
        x = x.to(torch.float32)
        r = tcast._flush(tcast._flush(x) * tcast._flush(
            torch.as_tensor(scale, dtype=torch.float32)))     # mul.rn.ftz
        self.bad = torch.isnan(r)
        r = torch.where(self.bad, 0.0, r)
        return r.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF

    @staticmethod
    def from_f16_bits(h, inv):
        g = (h & 0xFFFF).to(torch.int32).to(torch.int16).view(torch.float16)
        return g.to(torch.float32) * inv                      # no flush

    def f32_to_f16_bits(self, f):
        f = f.to(torch.float32)
        self.bad = torch.isnan(f)
        f = torch.where(self.bad, 0.0, f)
        return f.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF

    @staticmethod
    def f16_bits_to_f32(h):
        g = (h & 0xFFFF).to(torch.int32).to(torch.int16).view(torch.float16)
        return g.to(torch.float32)


def fast_inv(scale: float) -> bool:
    inv = tcast._recip(torch.tensor(scale, dtype=torch.float32)).abs()
    return bool((inv >= 2.0 ** -102) & (inv <= torch.finfo(torch.float32).max))


def hw_twin(monkeypatch, x, fmt, mode, daz, scale, rb):
    """What the kernel computes: the hardware route where it applies, the
    emulation (= the plain version) elsewhere."""
    plain = tcast.qdq_plain(x, fmt, mode, scale, daz, random_bits=rb)
    hw_fmt = fmt in HW_FORMATS or (fmt == "float16" and mode == RoundMode.RNE)
    if not hw_fmt or (fmt != "float16" and not fast_inv(scale)):
        return plain, None
    route = HwRoute()
    with monkeypatch.context() as m:
        if fmt == "float16":
            m.setattr(tcast, "f32_to_f16_bits", route.f32_to_f16_bits)
            m.setattr(tcast, "f16_bits_to_f32", route.f16_bits_to_f32)
        else:
            m.setattr(tcast, "_to_f16_bits", route.to_f16_bits)
            m.setattr(tcast, "_from_f16_bits", route.from_f16_bits)
        hw = tcast.qdq_plain(x, fmt, mode, scale, daz, random_bits=rb)
    return torch.where(route.bad, plain, hw), route.bad


@pytest.mark.parametrize("fmt,mode,daz", VARIANTS,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_hw_route_twin_matches_plain(monkeypatch, fmt, mode, daz):
    x = stratified_sweep()
    rb = torch.from_numpy(np.random.default_rng(1).integers(
        0, 65536, x.shape).astype(np.int32))
    routed = 0
    for scale in SCALES:
        want = tcast.qdq_plain(x, fmt, mode, scale, daz, random_bits=rb)
        got, bad = hw_twin(monkeypatch, x, fmt, mode, daz, scale, rb)
        diff = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
        assert diff.numel() == 0, (
            f"scale {scale}: input {x.view(torch.int32)[diff[0]].item():#010x}"
            f" gives {got.view(torch.int32)[diff[0]].item():#010x}, plain "
            f"{want.view(torch.int32)[diff[0]].item():#010x}")
        if bad is not None:
            routed += int((~bad).sum())
            # NaN inputs, and only those, are left to the emulation
            assert torch.equal(bad, torch.isnan(x)) or fmt != "float16"
    if fmt in HW_FORMATS:
        assert routed > 0.9 * len(SCALES) * x.numel() * 0.5


def test_fast_inv_edges():
    assert fast_inv(2.0 ** 101) and not fast_inv(2.0 ** 102 * 1.5)
    assert not fast_inv(0.0) and not fast_inv(float("nan"))
    assert not fast_inv(1e-40)         # flushed to 0: 1/scale is inf
    assert fast_inv(2.0 ** -126) and fast_inv(1.0)


def make_div(d: int):
    """cast_kernel.cu::make_div: (m, shift) with floor(n / d) = (n * m) >>
    shift for 0 <= n < 2^31."""
    l = (d - 1).bit_length()
    shift = 31 + l
    return -(-(1 << shift) // d), shift


@pytest.mark.parametrize("d", [1, 2, 3, 7, 49, 56 * 56, 3136 * 256, 1000003,
                               2 ** 30, 2 ** 31 - 1])
def test_multiply_shift_division(d):
    m, shift = make_div(d)
    assert m < 2 ** 32                   # one 32 x 32 -> 64-bit multiply
    rng = np.random.default_rng(d)
    ns = {0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31 - 2}
    ns |= {k * d + r for k in (1, 2, 1000, (2 ** 31 - 1) // d)
           for r in (-1, 0, 1)}
    ns |= set(int(v) for v in rng.integers(0, 2 ** 31, 2000))
    for n in ns:
        if 0 <= n < 2 ** 31:
            assert (n * m) >> shift == n // d, (n, d)


@pytest.mark.parametrize("n", [1, 3, 5, 4 * 1001 + 1, 8 * 1001 + 7])
def test_vector_path_choice(n):
    """The 16-byte path needs every pointer 16-byte aligned and 32-bit
    indices; an ``x[1:]`` view of an aligned tensor takes the scalar path."""
    x = torch.zeros(n + 1)
    base = x.data_ptr()
    assert base % 16 == 0
    assert cast_kernel.vector_path(n, (base, base))
    assert cast_kernel.vector_path(n, (base, base, None))
    assert not cast_kernel.vector_path(n, (x[1:].data_ptr(), base))
    assert not cast_kernel.vector_path(n, (base, base, base + 4))
    assert not cast_kernel.vector_path(2 ** 31, (base, base))
    assert not cast_kernel.vector_path(n, (base, base), inner=2 ** 31)
