"""fp8tpu_torch.numerics.blockquant against fp8tpu.numerics.blockquant (JAX
on the CPU, un-jitted): payload bytes and scales bit for bit in the four
formats, over zero blocks, blocks whose absmax lies in the f32 subnormal
range, ragged lengths, wide magnitudes and saturating inputs.  (Jitted, XLA
turns ``/ gmax`` into a multiply by the reciprocal and moves some scales
by an ulp; the un-jitted functions are the op-by-op reference.)"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.numerics import blockquant as jbq
from fp8tpu_torch.numerics import blockquant as tbq


def _blocks(block: int) -> np.ndarray:
    rng = np.random.default_rng(block)
    x = (rng.standard_normal((40, block)) * np.exp(
        rng.uniform(-90, 12, (40, 1)))).astype(np.float32)
    x[0] = 0.0                                           # a zero block
    x[1] = 0.0
    x[1, :3] = [1e-40, -3e-39, 2e-45]                    # only subnormals
    x[2] = (1e-39 * rng.standard_normal(block)).astype(np.float32)
    x[3] = (2.0 ** -126 * rng.standard_normal(block)).astype(np.float32)
    x[3, 0] = 1e-38                                       # amax normal
    x[4] *= np.float32(1e30)                              # large
    x[5, :] = np.float32(3.0e38)                          # saturating
    x[5, ::2] *= -1
    x[6, :] = [0.5 + i for i in range(block)]            # int8 ties
    return x


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy() if a.element_size() == 1 else \
            a.view(torch.int16 if a.element_size() == 2 else
                   torch.int32).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.itemsize])


@pytest.mark.parametrize("fmt", ["int8", "e4m3", "e5m2", "bf16"])
@pytest.mark.parametrize("block", [256, 33, 5])
def test_quant_blocks_bit_equal_to_unjitted_jax(fmt, block):
    x = _blocks(block)
    with jax.disable_jit():
        jq, js = jbq.quant_blocks(jnp.asarray(x), fmt)
        jd = jbq.dequant_blocks(jq, js)
    tq, ts = tbq.quant_blocks(torch.from_numpy(x), fmt)
    assert tq.dtype == {"int8": torch.int8, **tbq.WIRE_DTYPES}[fmt]
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(_bytes(ts), _bytes(js))
    td = tbq.dequant_blocks(tq, ts)
    np.testing.assert_array_equal(_bytes(td), _bytes(jd))


def test_zero_block_dequantizes_to_zeros_and_tables_agree():
    q, s = tbq.quant_blocks(torch.zeros(3, 256), "e4m3")
    assert float(s[0]) == np.float32(1e-30) / np.float32(448.0)
    assert torch.equal(tbq.dequant_blocks(q, s), torch.zeros(3, 256))
    assert tbq.GRID_MAX == jbq.GRID_MAX
    assert set(tbq.WIRE_DTYPES) == set(jbq.WIRE_DTYPES)


@pytest.mark.parametrize("fmt", ["int8", "e4m3", "e5m2"])
@pytest.mark.parametrize("nblocks", [2, 16, 64])
def test_nan_blocks_bit_equal_to_unjitted_jax(fmt, nblocks):
    """Blocks holding NaNs (a quiet NaN, one with a payload, a negative
    one): scales, codes and dequantized values as the JAX package's, with
    as many blocks as torch's vectorised loops take (its ``maximum``
    returns 0xFFFFFFFF there, the operand's NaN in its scalar loop)."""
    x = np.random.default_rng(nblocks).standard_normal(
        (nblocks, 256)).astype(np.float32)
    bits = x.view(np.uint32)
    x[1, 7] = np.nan
    bits[1, 9] = 0x7FC01234
    bits[nblocks - 1, 0] = 0xFFC00000
    with jax.disable_jit():
        jq, js = jbq.quant_blocks(jnp.asarray(x), fmt)
        jd = jbq.dequant_blocks(jq, js)
    tq, ts = tbq.quant_blocks(torch.from_numpy(x), fmt)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(_bytes(ts), _bytes(js))
    np.testing.assert_array_equal(_bytes(tbq.dequant_blocks(tq, ts)),
                                  _bytes(jd))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_nan_codes_dequantize_to_xla_nans(fmt):
    """Every fp8 code, NaN codes of both signs included, dequantized bit for
    bit as the JAX package does (0x7FC00000 with the code's sign, where
    torch's own convert gives 0x7FF00000)."""
    codes = np.arange(256, dtype=np.uint8).reshape(1, 256)
    scale = np.array([0.75], np.float32)
    jdt = {"e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2}[fmt]
    with jax.disable_jit():
        jd = jbq.dequant_blocks(jnp.asarray(codes).view(jdt),
                                jnp.asarray(scale))
    td = tbq.dequant_blocks(torch.from_numpy(codes).view(
        tbq.WIRE_DTYPES[fmt]), torch.from_numpy(scale))
    np.testing.assert_array_equal(_bytes(td), _bytes(jd))
