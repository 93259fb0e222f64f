"""Port parity: fp8tpu_torch.numerics against fp8tpu.numerics (JAX on the
CPU), and the cast kernel's wrapper logic.

Inputs are made with numpy from a seed and fed to both packages.  Casts,
SR bits, keys and scales must be bit-equal (compared as uint32 patterns,
so NaN payloads and signed zeros count)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.numerics import cast as jcast
from fp8tpu.numerics import formats as jformats
from fp8tpu.numerics import integer as jinteger
from fp8tpu.numerics import scaling as jscaling
from fp8tpu_torch.kernels import cast_kernel
from fp8tpu_torch.numerics import cast as tcast
from fp8tpu_torch.numerics import formats as tformats
from fp8tpu_torch.numerics import integer as tinteger
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.numerics import scaling as tscaling

BOUNDARY = np.array(
    [
        0.0, -0.0, 1.0, -1.0, 57344.0, -57344.0, 61440.0, -61440.0,
        65504.0, -65504.0, 448.0, -448.0, 480.0, -480.0, 449.0,
        240.0, -240.0, 30.0, -30.0, 31.0, -31.0, 2.0 ** -16, -(2.0 ** -16),
        2.0 ** -9, 2.0 ** -6, 2.0 ** -2, 1.5e-5, 1.9e-3, 1.5e-2,
        0.1, -0.1, 3.14159, -2.71828, 1e6, -1e6, 1e-8, -1e-8,
        np.inf, -np.inf, np.nan,
    ],
    dtype=np.float32,
)
# f32 subnormals: XLA flushes them in arithmetic; the port does so too.
SUBNORMALS = np.array([1e-40, -1e-40, 1e-39, -3e-39, 1.1e-38, 2.0 ** -149],
                      np.float32)

MODE_STRINGS = (
    [f"E5M2_{m}" for m in ("RTZ", "STOCHASTIC", "RNE", "RNAZ", "RNTZ",
                           "RPINF", "RNINF")]
    + [f"E5M2_DAZ_{m}" for m in ("STOCHASTIC", "RNE", "RNAZ", "RNTZ")]
    + [f"{f}_{m}" for f in ("E4M3", "E4M3_IEEE", "E3M4")
       for m in ("RNE", "STOCHASTIC")]
    + ["E4M3_V2_RNE", "E4M3_V2_STOCHASTIC", "E4M3_V2_RTZ", "FP4_NEAREST",
       "BFLOAT16_RNE", "BFLOAT16_STOCHASTIC", "FLOAT16_RNE",
       "FLOAT16_STOCHASTIC", "FLOAT16_DAZ_RNE", "E5M2_NOINF_RNE",
       "E5M2_FLEX_RNE"]
)
# 1e36 makes f32-subnormal inputs reach the fp16 range unless flushed.
SCALES = (1.0, 3.7, 1e-3, 6.55e4, 1e36)


def _inputs(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    rand = (rng.standard_normal(n) * np.exp(rng.uniform(-25, 15, n))
            ).astype(np.float32)
    return np.concatenate([BOUNDARY, SUBNORMALS, rand])


def assert_bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = got.view(np.uint32) != want.view(np.uint32)
    assert not diff.any(), (
        f"{diff.sum()} of {diff.size} differ; first at "
        f"{np.argwhere(diff)[:3].ravel()}: got {got[diff][:3]}, "
        f"want {want[diff][:3]}")


def test_format_table_matches():
    assert tformats.FORMATS.keys() == jformats.FORMATS.keys()
    for name, f in jformats.FORMATS.items():
        t = tformats.FORMATS[name]
        for field in f.__dataclass_fields__:
            assert getattr(t, field) == getattr(f, field), (name, field)
        assert t.valid_round_modes() == tuple(
            tformats.RoundMode(m.value) for m in f.valid_round_modes())
    assert tformats.FP8_FORMATS == jformats.FP8_FORMATS


@pytest.mark.parametrize("ms", [m for m in MODE_STRINGS
                                if "NOINF" not in m and "FLEX" not in m
                                and "V2" not in m])
def test_mode_string_roundtrip(ms):
    f, m, d = tformats.parse_mode_string(ms)
    jf, jm, jd = jformats.parse_mode_string(ms)
    assert (f.name, m.value, d) == (jf.name, jm.value, jd)
    assert tformats.mode_string(f, m, d) == jformats.mode_string(jf, jm, jd)


@pytest.mark.parametrize("ms", MODE_STRINGS)
def test_qdq_mode_string_bit_equal(ms):
    x = _inputs()
    rb = np.random.default_rng(1).integers(0, 65536, x.shape).astype(
        np.uint16)
    sr = "STOCHASTIC" in ms
    for scale in SCALES:
        j = jcast.qdq_mode_string(
            jnp.asarray(x), ms, scale=np.float32(scale),
            **({"random_bits": jnp.asarray(rb)} if sr else {}))
        t = tcast.qdq_mode_string(
            torch.from_numpy(x), ms, scale=scale,
            **({"random_bits": torch.from_numpy(rb.astype(np.int32))}
               if sr else {}))
        assert_bits_equal(t.numpy(), j)


def test_qdq_broadcast_scale_bit_equal():
    x = _inputs(4096 - len(BOUNDARY) - len(SUBNORMALS))[:4096].reshape(
        16, 16, 16)
    for shape in ((16, 1, 1), (1, 16, 1), (16,), (16, 1, 16)):
        s = np.linspace(0.5, 40.0, int(np.prod(shape)),
                        dtype=np.float32).reshape(shape)
        for fmt in ("e5m2", "e4m3", "fp4"):
            j = jcast.qdq(jnp.asarray(x), fmt, scale=jnp.asarray(s))
            t = tcast.qdq(torch.from_numpy(x), fmt, scale=torch.from_numpy(s))
            assert_bits_equal(t.numpy(), j)


@pytest.mark.parametrize("seed,fold", [(0, None), (123, 77), (2 ** 31 - 1, 5),
                                       (7, 0xFFFFFFFF)])
def test_keys_and_sr_bits_bit_equal(seed, fold):
    jk = jax.random.key(seed)
    tk = prng.key(seed)
    if fold is not None:
        jk = jax.random.fold_in(jk, fold)
        tk = prng.fold_in(tk, fold)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(jk)))
    assert tk == kd
    for shape in ((5, 7), (3, 1, 33), (1,)):
        assert np.array_equal(tcast.sr_bits(tk, shape).numpy(),
                              np.asarray(jcast.sr_bits(jk, shape)))


def test_qdq_with_key_bit_equal():
    x = _inputs()
    for ms in ("E5M2_STOCHASTIC", "E4M3_STOCHASTIC", "BFLOAT16_STOCHASTIC"):
        j = jcast.qdq_mode_string(jnp.asarray(x), ms, scale=np.float32(3.0),
                                  key=jax.random.key(9))
        t = tcast.qdq_mode_string(torch.from_numpy(x), ms, scale=3.0,
                                  key=prng.key(9))
        assert_bits_equal(t.numpy(), j)


def test_f16_bit_conversions_bit_equal():
    h = np.arange(65536, dtype=np.int32)
    assert_bits_equal(tcast.f16_bits_to_f32(torch.from_numpy(h)).numpy(),
                      jcast.f16_bits_to_f32(jnp.asarray(h)))
    x = _inputs(8192)
    assert np.array_equal(
        tcast.f32_to_f16_bits(torch.from_numpy(x)).numpy(),
        np.asarray(jcast.f32_to_f16_bits(jnp.asarray(x))))


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3", "e4m3_ieee", "e3m4", "fp4"])
def test_block_scales_and_qdq_blocked_bit_equal(fmt):
    x = _inputs()
    x = x[np.isfinite(x)][:1900]
    # an all-zero block, an all-subnormal block and a tiny-amax block
    x = np.concatenate([x, np.zeros(128, np.float32),
                        np.full(128, 1e-40, np.float32),
                        np.full(128, 3e-38, np.float32)])
    for bs in (128, 32, 100):
        n = (len(x) // bs) * bs
        assert_bits_equal(tcast.block_scales(torch.from_numpy(x[:n]), bs,
                                             fmt).numpy(),
                          jcast.block_scales(jnp.asarray(x[:n]), bs, fmt))
        assert_bits_equal(
            tcast.qdq_blocked(torch.from_numpy(x), fmt, block_size=bs).numpy(),
            jcast.qdq_blocked(jnp.asarray(x), fmt, block_size=bs))
    if fmt != "fp4":
        rb = np.random.default_rng(2).integers(0, 65536, x.shape).astype(
            np.uint16)
        sto = tformats.RoundMode.STOCHASTIC
        jsto = jformats.RoundMode.STOCHASTIC
        assert_bits_equal(
            tcast.qdq_blocked(torch.from_numpy(x), fmt, sto, 128,
                              random_bits=torch.from_numpy(
                                  rb.astype(np.int32))).numpy(),
            jcast.qdq_blocked(jnp.asarray(x), fmt, jsto, 128,
                              random_bits=jnp.asarray(rb)))
        assert_bits_equal(
            tcast.qdq_blocked(torch.from_numpy(x), fmt, sto, 128,
                              key=prng.key(4)).numpy(),
            jcast.qdq_blocked(jnp.asarray(x), fmt, jsto, 128,
                              key=jax.random.key(4)))


def _grid_values(shape, seed):
    """Values whose sums are exact in f32 (multiples of 2^-8 below 4), so
    "mean" scales do not depend on the reduction order."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-1024, 1024, shape) / 256.0).astype(np.float32)


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3", "e3m4", "fp4"])
def test_scaling_bit_equal(fmt):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 8, 3, 3)) * 2.0).astype(np.float32)
    g = _grid_values((6, 8, 3, 3), 4)
    tiny = np.full((4, 4), 1e-7, np.float32)
    cases = [
        (tscaling.per_tensor(torch.from_numpy(x), fmt),
         jscaling.per_tensor(jnp.asarray(x), fmt)),
        (tscaling.per_tensor(torch.from_numpy(tiny), fmt),
         jscaling.per_tensor(jnp.asarray(tiny), fmt)),
        (tscaling.per_tensor(torch.zeros(3), fmt),
         jscaling.per_tensor(jnp.zeros(3), fmt)),
        (tscaling.per_tensor(torch.from_numpy(g), fmt, "mean"),
         jscaling.per_tensor(jnp.asarray(g), fmt, "mean")),
        (tscaling.per_tensor(torch.from_numpy(tiny), fmt, "mean"),
         jscaling.per_tensor(jnp.asarray(tiny), fmt, "mean")),
        (tscaling.fine_grained(torch.from_numpy(x), fmt, 4),
         jscaling.fine_grained(jnp.asarray(x), fmt, 4)),
        (tscaling.fine_grained(torch.from_numpy(g), fmt, 2, "mean"),
         jscaling.fine_grained(jnp.asarray(g), fmt, 2, "mean")),
    ]
    for axis in (0, 1, 3):
        cases.append((tscaling.per_channel(torch.from_numpy(x), fmt,
                                           axis=axis),
                      jscaling.per_channel(jnp.asarray(x), fmt, axis=axis)))
        cases.append((tscaling.per_channel(torch.from_numpy(g), fmt, "mean",
                                           axis=axis),
                      jscaling.per_channel(jnp.asarray(g), fmt, "mean",
                                           axis=axis)))
    for t, j in cases:
        assert_bits_equal(t.numpy(), j)


def test_integer_bit_equal():
    x = _grid_values((64,), 5) * 3.0 + 0.25
    for bits in (8, 4):
        assert_bits_equal(tinteger.qdq_int(torch.from_numpy(x), bits).numpy(),
                          jinteger.qdq_int(jnp.asarray(x), bits))
        for sym in (False, True):
            ts, tz = tinteger.int_qparams(-1.5, 2.25, bits, sym)
            js, jz = jinteger.int_qparams(-1.5, 2.25, bits, sym)
            assert_bits_equal(ts.numpy(), js)
            assert_bits_equal(tz.numpy(), jz)
        assert_bits_equal(
            tinteger.qdq_int_with_qparams(torch.from_numpy(x), ts, tz,
                                          bits).numpy(),
            jinteger.qdq_int_with_qparams(jnp.asarray(x), js, jz, bits))


# -- the cast kernel's wrapper, on the CPU -------------------------------------

def test_variant_codes_cover_the_abi_once():
    """Every (format, mode, daz) the cast pipeline accepts maps to one of
    the kernel's template instances; ignored arguments normalise away."""
    RM = tformats.RoundMode
    codes = set()
    for ms in MODE_STRINGS:
        ml = ms.lower()
        if ml in ("e5m2_noinf_rne", "e5m2_flex_rne"):
            fmt, mode, daz = ml[:-4], RM.RNE, False
        elif ml.startswith("e4m3_v2_"):
            fmt, mode, daz = "e4m3_v2", RM[ml[8:].upper()], False
        else:
            f, mode, daz = tformats.parse_mode_string(ms)
            fmt = f.name
        codes.add(cast_kernel.variant_code(fmt, mode, daz))
    assert len(codes) == len(MODE_STRINGS)
    assert (cast_kernel.variant_code("bfloat16", RM.RTZ)
            == cast_kernel.variant_code("bfloat16", RM.RNE))
    assert (cast_kernel.variant_code("e4m3", RM.RNE, True)
            == cast_kernel.variant_code("e4m3", RM.RNE, False))
    with pytest.raises(ValueError):
        cast_kernel.variant_code("e4m3", RM.NEAREST)
    with pytest.raises(ValueError):
        cast_kernel.variant_code("e5m2_flex", RM.RTZ)


@pytest.mark.parametrize("sshape", [(), (1,), (4, 1, 1), (1, 5, 1), (6,),
                                    (4, 1, 6), (5, 6), (1, 1, 1)])
def test_scale_layout_indexes_like_broadcast(sshape):
    """The kernel reads scales[(i // inner) % nscale]; that must be the
    broadcast scale of element i."""
    x = torch.zeros(4, 5, 6)
    s = torch.arange(1, 1 + int(np.prod(sshape)), dtype=torch.float32
                     ).reshape(sshape)
    flat, inner, nscale = cast_kernel.scale_layout(s, x)
    i = torch.arange(x.numel())
    got = flat[(i // inner) % nscale]
    assert torch.equal(got, torch.broadcast_to(s, x.shape).reshape(-1))


def test_cuda_qdq_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        cast_kernel.cuda_qdq(torch.zeros(4), "e4m3")
