"""Port parity for the serving kernels' modules: the weight quantizers
bit-equal to fp8tpu's, and the plain versions of K3 (dequant_matmul), K5
(int4_matmul) and K6 (dyn_store) against the Pallas kernels run in
interpret mode on the CPU, on the same numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fp8tpu.kernels.inplace import dyn_store as j_dyn_store
from fp8tpu.kernels.int4_matmul import int4_matmul as j_int4_matmul
from fp8tpu.kernels.int4_matmul import \
    quantize_weights_int4_grouped as j_quantize_int4_grouped
from fp8tpu.kernels.qmatmul import dequant_matmul as j_dequant_matmul
from fp8tpu.kernels.qmatmul import quantize_weights as j_quantize_weights
from fp8tpu.serve.model import int4_linear as j_int4_linear
from fp8tpu.serve.model import quantize_weights_int4 as j_quantize_int4
from fp8tpu_torch.kernels import inplace, int4_matmul, qmatmul
from fp8tpu_torch.serve.model import (_tensor_from_array, int4_linear,
                                      quantize_weights_int4)

BF16_ULP = 2.0 ** -7      # spacing of bf16 values relative to their size


def raw(a) -> np.ndarray:
    """The bytes of a numpy / ml_dtypes / jax array or a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def weights(rng, k, n, zero_col=True):
    w = (rng.standard_normal((k, n)) * 0.05
         * 2.0 ** rng.integers(-3, 4, (1, n))).astype(np.float32)
    if zero_col:
        w[:, 1] = 0.0
    return w


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
def test_quantize_weights_bit_equal(rng, fmt, axis):
    w = weights(rng, 96, 40)
    if axis == 0:
        w = w.T.copy()
    jp, js = j_quantize_weights(jnp.asarray(w), fmt, axis=axis)
    tp, ts = qmatmul.quantize_weights(torch.from_numpy(w), fmt, axis=axis)
    assert tuple(tp.shape) == jp.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(raw(tp), raw(jp))
    np.testing.assert_array_equal(raw(ts), raw(js))
    # the all-zero channel has scale 1 and payload 0
    assert float(ts.reshape(-1)[1]) == 1.0


def test_quantize_weights_rejects_emulation_formats():
    with pytest.raises(ValueError, match="no hardware dtype"):
        qmatmul.quantize_weights(torch.zeros(4, 4), "e3m4")


@pytest.mark.parametrize("group", [None, 32, 128, 48])
def test_quantize_weights_int4_bit_equal(rng, group):
    # group 48 does not divide K = 128: one group, as in the JAX package
    w = weights(rng, 128, 24)
    jp, js = j_quantize_int4(jnp.asarray(w), group_size=group)
    tp, ts = quantize_weights_int4(torch.from_numpy(w), group_size=group)
    assert tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(raw(tp), raw(jp))
    np.testing.assert_array_equal(raw(ts), raw(js))


@pytest.mark.parametrize("group", [32, 64])
def test_quantize_weights_int4_grouped_bit_equal(rng, group):
    w = weights(rng, 128, 24)
    jp, js = j_quantize_int4_grouped(jnp.asarray(w), group_size=group)
    tp, ts = int4_matmul.quantize_weights_int4_grouped(
        torch.from_numpy(w), group_size=group)
    np.testing.assert_array_equal(raw(tp), raw(jp))
    np.testing.assert_array_equal(raw(ts), raw(js))


def assert_product_close(got, want, out_bf16):
    """f32 results: two f32 sums of the same exact products in different
    orders, 1e-5 of max|out|.  bf16 results: the same, then one rounding,
    which can land one bf16 step apart."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 1e-5 * np.abs(want).max()
    if out_bf16:
        tol = tol + BF16_ULP * np.abs(want)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


# (M, K, N): the aligned and ragged shapes of tests/test_kernels.py
DEQUANT_SHAPES = [(24, 384, 256), (5, 200, 100), (1, 64, 128), (130, 96, 72)]


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("shape", DEQUANT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dequant_matmul_plain_matches_pallas(rng, shape, fmt, out):
    m, k, n = shape
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = weights(rng, k, n)
    jp, js = j_quantize_weights(jnp.asarray(w), fmt, axis=-1)
    want = j_dequant_matmul(
        jnp.asarray(x), jp, js,
        out_dtype=jnp.float32 if out == "f32" else jnp.bfloat16,
        interpret=True)
    tp = _tensor_from_array(np.asarray(jp), "cpu")
    ts = torch.from_numpy(np.asarray(js))
    before = qmatmul.dequant_launches
    got = qmatmul.dequant_matmul(
        torch.from_numpy(x), tp, ts.reshape(-1),
        torch.float32 if out == "f32" else torch.bfloat16)
    assert qmatmul.dequant_launches == before      # CPU: the plain version
    assert_product_close(got.float().numpy(),
                         np.asarray(want.astype(jnp.float32)), out == "bf16")


def test_streaming_kernel_eligibility():
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 32, dtype=torch.int8)
    assert qmatmul.streams(8, 32, 64, x, w)
    assert not qmatmul.streams(65, 32, 64, x, w)           # prefill rows
    assert not qmatmul.streams(8, 24, 64, x, w)            # N % 16
    assert not qmatmul.streams(8, 32, 60, x, w)            # K % 8
    assert not qmatmul.streams(8, 32, 64, x, w.reshape(-1)[1:])  # alignment


def test_dequant_matmul_checks_its_arguments():
    x = torch.zeros(4, 8)
    w8 = torch.zeros(8, 6, dtype=torch.int8)
    with pytest.raises(ValueError, match="one scale per output column"):
        qmatmul.dequant_matmul(x, w8, torch.ones(5))
    with pytest.raises(ValueError, match="payload"):
        qmatmul.dequant_matmul(x, torch.zeros(8, 6), torch.ones(6))
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        qmatmul.dequant_matmul(torch.zeros(4, 7), w8, torch.ones(6))


@pytest.mark.parametrize("m,n,k,sms,stream,want", [
    (8, 4096, 4096, 132, False, (4, 1024)),     # q/o projection at decode
    (8, 1024, 4096, 132, False, (8, 512)),      # k/v projection: 16 tiles
    (64, 11008, 4096, 132, False, (2, 2048)),   # gate/up
    (2048, 1024, 4096, 132, False, (1, 4096)),  # prefill: enough tiles
    (4, 64, 100, 132, False, (1, 128)),         # K too short to split
    (8, 4096, 4096, 132, True, (8, 512)),       # streaming: 128-wide tiles
    (64, 11008, 4096, 132, True, (3, 1408)),
    (64, 4096, 11008, 132, True, (8, 1408)),
])
def test_split_k_policy(m, n, k, sms, stream, want):
    splits, kper = qmatmul.split_k(m, n, k, sms, stream)
    assert (splits, kper) == want
    assert kper % 64 == 0 and (splits - 1) * kper < k <= splits * kper


INT4_SHAPES = [(8, 128, 64), (4, 256, 128), (3, 192, 40)]


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("group", [None, 32, 64])
@pytest.mark.parametrize("shape", INT4_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_int4_matmul_plain_matches_pallas(rng, shape, group, out):
    m, k, n = shape
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = weights(rng, k, n, zero_col=False)
    w = w * np.repeat(2.0 ** rng.integers(-2, 3, (k // 32,)), 32
                      )[:, None].astype(np.float32)
    if group:
        jp, js = j_quantize_int4_grouped(jnp.asarray(w), group_size=group)
    else:
        jp, js = j_quantize_int4(jnp.asarray(w))
    jout = jnp.float32 if out == "f32" else jnp.bfloat16
    want = j_int4_matmul(jnp.asarray(x), jp, js, group_size=group,
                         out_dtype=jout, tn=64, tk2=64, interpret=True)
    tout = torch.float32 if out == "f32" else torch.bfloat16
    before = int4_matmul.launches
    got = int4_matmul.int4_matmul(
        torch.from_numpy(x), torch.from_numpy(np.asarray(jp)),
        torch.from_numpy(np.asarray(js)), group, tout)
    assert int4_matmul.launches == before
    assert_product_close(got.float().numpy(),
                         np.asarray(want.astype(jnp.float32)), out == "bf16")


@pytest.mark.parametrize("group", [None, 64])
def test_int4_linear_cpu_matches_jax_cpu(rng, group):
    """On the CPU both packages' int4_linear compute in f32 (grouped
    scales applied in f32): another function than the kernel's."""
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    w = weights(rng, 128, 48, zero_col=False)
    jp, js = j_quantize_int4(jnp.asarray(w), group_size=group)
    want = j_int4_linear(jnp.asarray(x).astype(jnp.bfloat16), jp, js)
    got = int4_linear(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(np.asarray(jp)),
                      torch.from_numpy(np.asarray(js)))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 48)
    assert_product_close(got.float().numpy(),
                         np.asarray(want.astype(jnp.float32)), True)


def test_int4_matmul_checks_its_arguments():
    x = torch.zeros(2, 64)
    wp = torch.zeros(32, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="grouped scales"):
        int4_matmul.int4_matmul(x, wp, torch.ones(3, 8), 32)
    with pytest.raises(ValueError, match="per-channel scales"):
        int4_matmul.int4_matmul(x, wp, torch.ones(7))
    with pytest.raises(ValueError, match="packed"):
        int4_matmul.int4_matmul(torch.zeros(2, 60), wp, torch.ones(8))


def test_pack_unpack_int4_roundtrip(rng):
    q = torch.from_numpy(rng.integers(-8, 8, (64, 10)).astype(np.int32))
    lo, hi = int4_matmul.unpack_int4(int4_matmul.pack_int4(q))
    assert torch.equal(lo, q[0::2]) and torch.equal(hi, q[1::2])


STORE_TYPES = {
    "int8": (np.int8, jnp.int8, torch.int8),
    "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
    "f32": (np.float32, jnp.float32, torch.float32),
}


@pytest.mark.parametrize("offset", [0, -1, 3], ids=["first", "last", "wrap"])
@pytest.mark.parametrize("kind", list(STORE_TYPES))
def test_dyn_store_plain_matches_jax(rng, kind, offset):
    """idx 0, n - 1 and n + 3 against the Pallas kernel in interpret mode
    (rows of (32, 128) satisfy its alignment rule for all three types); the
    kernel's own ``mod n`` wraps n + 3 to row 3."""
    np_t, j_t, t_t = STORE_TYPES[kind]
    n, row = 8, (32, 128)
    idx = {0: 0, -1: n - 1, 3: n + 3}[offset]
    scale = 100 if kind == "int8" else 1
    buf = (rng.standard_normal((n,) + row) * scale).astype(np_t)
    slab = (rng.standard_normal(row) * scale).astype(np_t)
    jbuf = jnp.asarray(buf).astype(j_t)
    jslab = jnp.asarray(slab).astype(j_t)
    want = j_dyn_store(jbuf, jslab, jnp.int32(idx), interpret=True)
    tbuf = _tensor_from_array(np.asarray(jnp.asarray(buf).astype(j_t)), "cpu")
    tslab = _tensor_from_array(np.asarray(jslab), "cpu")
    ptr = tbuf.data_ptr()
    before = inplace.launches
    out = inplace.dyn_store(tbuf, tslab, torch.tensor(idx, dtype=torch.int32))
    assert inplace.launches == before
    assert out is tbuf and out.data_ptr() == ptr        # in place
    np.testing.assert_array_equal(raw(out), raw(want))


def test_dyn_store_negative_index_and_shape_check():
    buf = torch.zeros(4, 3)
    inplace.dyn_store(buf, torch.ones(3), -1)
    assert buf[3].tolist() == [1.0, 1.0, 1.0] and float(buf[:3].sum()) == 0.0
    with pytest.raises(ValueError, match="not a row"):
        inplace.dyn_store(buf, torch.ones(4), 0)
