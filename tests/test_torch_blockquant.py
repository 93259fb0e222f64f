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
