"""The port's kernels on a CUDA device: each wrapper launches its kernel
(and counts it) and agrees with its plain torch version on the CPU.

Skipped without a CUDA device.  Imports neither JAX nor the JAX package,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import fp8tpu_torch
from fp8tpu_torch.kernels import cast_kernel, qmatmul
from fp8tpu_torch.models import RESNET_EXEMPT, tiny_resnet
from fp8tpu_torch.numerics import cast as tcast
from fp8tpu_torch.numerics.cast import cast_array
from fp8tpu_torch.numerics.formats import RoundMode
from fp8tpu_torch.quant import config as tconfig
from fp8tpu_torch.quant import fakequant as tfq

pytestmark = pytest.mark.gpu

MODE_STRINGS = (
    "E5M2_RNE", "E5M2_STOCHASTIC", "E5M2_RTZ", "E5M2_DAZ_RNAZ",
    "E5M2_DAZ_STOCHASTIC", "E4M3_RNE", "E4M3_STOCHASTIC", "E4M3_IEEE_RNE",
    "E3M4_RNE", "E4M3_V2_RNE", "FP4_NEAREST", "BFLOAT16_RNE",
    "BFLOAT16_STOCHASTIC", "FLOAT16_RNE", "FLOAT16_DAZ_RNE",
    "FLOAT16_STOCHASTIC", "E5M2_NOINF_RNE", "E5M2_FLEX_RNE",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to build and launch the "
                    "fp8tpu_torch kernels")
    return torch.device("cuda")


def _bits(t):
    return t.detach().cpu().float().contiguous().numpy().view(np.uint32)


def test_cast_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0.0, -0.0, 448.0, 480.0, 57344.0, 65504.0, 1e6, 2.0 ** -9,
                  1e-40, -1e-39, np.inf, -np.inf, np.nan], np.float32),
        (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 12, 4096))
         ).astype(np.float32)])
    rb = rng.integers(0, 65536, x.shape).astype(np.int32)
    xc, rbc = torch.from_numpy(x), torch.from_numpy(rb)
    for ms in MODE_STRINGS:
        before = cast_kernel.launches
        got = tcast.qdq_mode_string(xc.to(cuda), ms, scale=3.7,
                                    random_bits=rbc.to(cuda))
        assert cast_kernel.launches == before + 1
        want = tcast.qdq_mode_string(xc, ms, scale=3.7, random_bits=rbc)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ms)
    got = tcast.qdq_blocked(xc.to(cuda), "e4m3", block_size=128)
    want = tcast.qdq_blocked(xc, "e4m3", block_size=128)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fake_quant_launches_the_cast_kernel(cuda):
    cfg = tconfig.TensorQuantConfig("e4m3", "rne", "per-channel")
    x = torch.randn(64, 33)
    before = cast_kernel.launches
    got = tfq.fake_quant(x.to(cuda), cfg)
    assert cast_kernel.launches == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(tfq.fake_quant(x, cfg)))


def test_qdq_matmul_kernel_matches_plain(cuda):
    x = torch.randn(300, 200, device=cuda)
    w = torch.randn(200, 70, device=cuda)
    before = qmatmul.launches
    got = qmatmul.qdq_matmul(x, w, "e4m3", RoundMode.RNE, "e4m3",
                             RoundMode.RNE, 2.0, 4.0)
    assert qmatmul.launches == before + 1
    want = qmatmul.plain(x, w, "e4m3", RoundMode.RNE, "e4m3", RoundMode.RNE,
                         2.0, 4.0)
    xq = cast_array(x, 2.0, None, "e4m3", RoundMode.RNE).abs()
    wq = cast_array(w, 4.0, None, "e4m3", RoundMode.RNE).abs()
    # two f32 sums of K products in different orders
    bound = 2.0 * x.shape[1] * 2.0 ** -24 * (xq @ wq)
    assert bool(((got - want).abs() <= bound).all())


def test_tiny_ptq_on_the_card_matches_cpu(cuda):
    tm = tiny_resnet(device="cpu", generator=torch.Generator().manual_seed(0))
    tm.eval()
    x = torch.randn(4, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    policy = fp8tpu_torch.get_policy("e4m3").with_hw_patching()
    runs = []
    for device in ("cpu", "cuda"):
        tq = fp8tpu_torch.quantize_model(tm, (x,), policy=policy,
                                         list_exempt_layers=RESNET_EXEMPT,
                                         device=device)
        with torch.no_grad():
            runs.append(tq(x).cpu().numpy())
    # f32 summation order differs (K2, cuDNN vs the CPU); see
    # tests/test_torch_resnet_ptq.py for this tolerance
    np.testing.assert_allclose(runs[1], runs[0], rtol=0,
                               atol=2e-3 * np.abs(runs[0]).max())
