"""The port's framework-free cast references against the JAX package's and
against the port's plain cast.

- ``fp8tpu_torch.numerics.golden`` (a NumPy copy reading the port's format
  table) is equal to ``fp8tpu.numerics.golden`` bit for bit on the inputs
  of tests/test_numerics_golden.py: the boundary vector and seeded normals
  through every format x deterministic mode x DAZ, scaled casts, SR from
  given bits, block scales, blocked casts and mode strings.
- ``fp8tpu_torch.numerics.native_ref`` (the C++ twin, built into
  ``fp8tpu_torch/kernels/_build``) is equal to the port's golden on
  tests/test_native_ref.py's 16 deterministic mode strings and inputs,
  NaN by class.
- The port's plain torch cast (``numerics.cast.qdq_mode_string`` on CPU
  tensors, the plain version of K1) is equal to the port's golden on the
  same mode strings, and on SR given the same bits.
"""

import os

import numpy as np
import pytest
import torch

from fp8tpu.numerics import golden as jgolden
from fp8tpu_torch.numerics import cast as tcast
from fp8tpu_torch.numerics import golden, native_ref
from fp8tpu_torch.numerics.formats import FORMATS, RoundMode

BOUNDARY = np.array(
    [0.0, -0.0, 1.0, -1.0, 57344.0, -57344.0, 61440.0, -61440.0, 65504.0,
     -65504.0, 448.0, -448.0, 480.0, -480.0, 449.0, 240.0, -240.0, 30.0,
     -30.0, 31.0, -31.0, 2.0 ** -16, -(2.0 ** -16), 2.0 ** -9, 2.0 ** -6,
     2.0 ** -2, 1.5e-5, 1.9e-3, 1.5e-2, 0.1, -0.1, 3.14159, -2.71828, 1e6,
     -1e6, 1e-8, -1e-8, np.inf, -np.inf, np.nan], dtype=np.float32)

# tests/test_native_ref.py's deterministic mode strings and input spans.
DET_MODES = [
    "E5M2_RNE", "E5M2_RTZ", "E5M2_RNAZ", "E5M2_RNTZ", "E5M2_RPINF",
    "E5M2_RNINF", "E5M2_DAZ_RNE", "E4M3_RNE", "E4M3_IEEE_RNE", "E3M4_RNE",
    "FP4_NEAREST", "BFLOAT16_RNE", "FLOAT16_RNE", "FLOAT16_DAZ_RNE",
    "E5M2_NOINF_RNE", "E5M2_FLEX_RNE",
]


def span_of(mode):
    return {"E5M2": 57344.0, "E4M3": 448.0, "E4M3_IEEE": 240.0,
            "E3M4": 30.0, "FP4": 1.0, "E5M2_NOINF": 57344.0,
            "E5M2_FLEX": 57344.0}.get(mode.rsplit("_", 1)[0], 1e4)


def native_inputs(rng, span):
    """tests/test_native_ref.py's inputs for one mode string."""
    return np.concatenate([
        rng.normal(0, span / 8, 4096), rng.normal(0, span * 2, 512),
        rng.normal(0, 1e-3, 512),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, span]),
    ]).astype(np.float32)


@pytest.fixture
def native():
    """The native twin, built at first use; skips without a C++
    toolchain (decided in the test, not while the module is imported)."""
    if not native_ref.available():
        pytest.skip("no C++ toolchain")
    return native_ref


def assert_same(got, want):
    """Bit for bit, NaN by class."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.isnan(got[nan]).all()
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


NEAREST = [RoundMode.RNE, RoundMode.RTZ, RoundMode.RNAZ, RoundMode.RNTZ,
           RoundMode.RPINF, RoundMode.RNINF]


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3", "e4m3_ieee", "e3m4",
                                 "bfloat16", "float16", "fp4"])
def test_golden_copy_bit_equal(fmt, rng):
    from fp8tpu.numerics import FORMATS as JFORMATS
    from fp8tpu.numerics import RoundMode as JRoundMode
    x = np.concatenate([BOUNDARY, rng.normal(0, 100, 2048).astype(
        np.float32), rng.normal(0, 1e-3, 512).astype(np.float32)])
    bits = rng.integers(0, 2 ** 16, size=x.shape, dtype=np.uint16)
    tf, jf = FORMATS[fmt], JFORMATS[fmt]
    for mode in NEAREST + [RoundMode.STOCHASTIC]:
        for daz in (False, True):
            for scale in (1.0, 448.0 / 300.0):
                kw = dict(random_bits=bits) if mode == RoundMode.STOCHASTIC \
                    else {}
                try:
                    want = jgolden.cast(x, jf, JRoundMode[mode.name],
                                        scale=scale, daz=daz, **kw)
                except (ValueError, NotImplementedError, AssertionError) as e:
                    with pytest.raises(type(e)):
                        golden.cast(x, tf, mode, scale=scale, daz=daz, **kw)
                    continue
                assert_same(golden.cast(x, tf, mode, scale=scale, daz=daz,
                                        **kw), want)
    for block in (4, 64):
        np.testing.assert_array_equal(golden.block_scales(x[:2048], block, tf),
                                      jgolden.block_scales(x[:2048], block,
                                                           jf))
        assert_same(golden.cast_blocked(x[:2048], tf, RoundMode.RNE, block),
                    jgolden.cast_blocked(x[:2048], jf, JRoundMode.RNE,
                                         block))


@pytest.mark.parametrize("ms", ["E4M3_V2_RNE", "E4M3_V2_RTZ",
                                "E4M3_V2_STOCHASTIC"])
def test_golden_copy_e4m3_v2_bit_equal(ms, rng):
    x = np.concatenate([BOUNDARY, rng.normal(0, 100, 2048).astype(
        np.float32)])
    bits = rng.integers(0, 2 ** 16, size=x.shape, dtype=np.uint16)
    assert_same(golden.cast_mode_string(x, ms, scale=1.7, random_bits=bits),
                jgolden.cast_mode_string(x, ms, scale=1.7, random_bits=bits))


@pytest.mark.parametrize("mode", DET_MODES)
def test_mode_strings_golden_native_and_plain_cast(mode, rng, native):
    """The JAX package's golden, the port's golden, the native twin and the
    port's plain cast agree on every deterministic mode string."""
    x = native_inputs(rng, span_of(mode))
    want = jgolden.cast_mode_string(x, mode)
    assert_same(golden.cast_mode_string(x, mode), want)
    assert_same(tcast.qdq_mode_string(torch.from_numpy(x), mode).numpy(),
                want)
    assert_same(native.cast(x, mode), want)


def test_native_twin_builds_into_the_port(native):
    lib = native.build()
    assert os.path.dirname(lib).endswith(os.path.join(
        "fp8tpu_torch", "kernels", "_build"))
    assert os.path.exists(lib + ".hash")
    assert native.version()


def test_native_scaled_blocked_and_unknown(rng, native):
    x = rng.normal(0, 5, 2048).astype(np.float32)
    np.testing.assert_array_equal(
        native_ref.cast(x, "E4M3_RNE", scale=64.0),
        golden.cast_mode_string(x, "E4M3_RNE", scale=64.0))
    y = rng.normal(0, 3, 1000).astype(np.float32)
    np.testing.assert_array_equal(
        native_ref.cast(y, "E5M2_RNE", block_norm=True, block_size=128),
        golden.cast_mode_string(y, "E5M2_RNE", block_norm=True,
                                block_size=128))
    with pytest.raises(ValueError):
        native_ref.cast(np.ones(4, np.float32), "E9M9_RNE")


def test_native_stochastic_statistics(native):
    x = np.full((20000,), 1.1, np.float32)
    y = native_ref.cast(x, "E5M2_STOCHASTIC", seed=7)
    assert set(np.unique(y)).issubset({np.float32(1.0), np.float32(1.25)})
    assert abs(float((y == 1.25).mean()) - 0.4) < 0.03
    np.testing.assert_array_equal(y, native_ref.cast(x, "E5M2_STOCHASTIC",
                                                     seed=7))
    assert not np.array_equal(y, native_ref.cast(x, "E5M2_STOCHASTIC",
                                                 seed=8))


@pytest.mark.parametrize("ms", ["E5M2_STOCHASTIC", "E4M3_STOCHASTIC",
                                "E3M4_STOCHASTIC", "BFLOAT16_STOCHASTIC",
                                "FLOAT16_STOCHASTIC"])
def test_plain_cast_sr_equals_golden_given_bits(ms, rng):
    x = rng.normal(0, 20, 4096).astype(np.float32)
    bits = rng.integers(0, 2 ** 16, size=x.shape, dtype=np.uint16)
    want = golden.cast_mode_string(x, ms, scale=3.7, random_bits=bits)
    got = tcast.qdq_mode_string(torch.from_numpy(x), ms, scale=3.7,
                                random_bits=torch.from_numpy(
                                    bits.astype(np.int32)))
    assert_same(got.numpy(), want)
