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
from fp8tpu_torch.kernels import cast_kernel, inplace, int4_matmul, qmatmul
from fp8tpu_torch.models import RESNET_EXEMPT, tiny_config, tiny_resnet
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


def _product_bound(x, w_abs, col_scale, want):
    # two f32 sums of K exact products in different orders, then (bf16
    # results) one rounding that may land a bf16 step apart
    k = x.shape[1]
    return (2.0 * k * 2.0 ** -24 * (x.float().abs() @ w_abs) * col_scale
            + 2.0 ** -7 * want.float().abs() + 1e-30)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (3, 200, 100),
                                   (130, 1001, 331)])
def test_dequant_matmul_kernel_matches_plain(cuda, fmt, m, k, n):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda)
    w8, s = qmatmul.quantize_weights(
        (torch.randn(k, n, generator=g) * 0.05).to(cuda), fmt)
    s = s.reshape(-1)
    for out_dtype in (torch.bfloat16, torch.float32):
        before = qmatmul.dequant_launches
        got = qmatmul.dequant_matmul(x, w8, s, out_dtype)
        assert qmatmul.dequant_launches == before + 1
        want = qmatmul.dequant_matmul_plain(x, w8, s, out_dtype)
        bound = _product_bound(x, w8.float().abs(), s[None], want)
        assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (70, 192, 41)])
def test_int4_matmul_kernel_matches_plain(cuda, group, m, k, n):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda)
    wp, s = int4_matmul.quantize_weights_int4_grouped(
        (torch.randn(k, n, generator=g) * 0.05).to(cuda), group or k)
    lo, hi = int4_matmul.unpack_int4(wp)
    w_abs = torch.stack([lo, hi], 1).reshape(k, n).float().abs()
    if group:
        w_abs = w_abs * s.to(torch.bfloat16).float().repeat_interleave(
            group, dim=0)
        col = torch.ones(1, n, device=cuda)
    else:
        s = s.reshape(-1)
        col = s[None]
    before = int4_matmul.launches
    got = int4_matmul.int4_matmul(x, wp, s, group)
    assert int4_matmul.launches == before + 1
    want = int4_matmul.int4_matmul_plain(x, wp, s, group)
    bound = _product_bound(x, w_abs, col, want)
    assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("row", [(4, 16, 128), (7,)])
def test_dyn_store_kernel_matches_plain(cuda, dtype, row):
    g = torch.Generator().manual_seed(2)
    buf = (torch.randn((6,) + row, generator=g) * 50).to(dtype).to(cuda)
    ref = buf.clone()
    ptr = buf.data_ptr()
    for idx in (0, 5, 9, -1):
        slab = (torch.randn(row, generator=g) * 50).to(dtype).to(cuda)
        before = inplace.launches
        out = inplace.dyn_store(buf, slab, torch.tensor(idx, device=cuda,
                                                        dtype=torch.int32))
        assert inplace.launches == before + 1
        assert out is buf and buf.data_ptr() == ptr
        inplace.dyn_store_plain(ref, slab, idx)
        assert torch.equal(buf, ref)


@pytest.mark.parametrize("fmt", ["e4m3", "int4"])
def test_tiny_serving_on_the_card_matches_cpu(cuda, fmt):
    """The tiny decoder's engine on the card (K3 or K5, and K6 launched)
    against the same engine on the CPU (plain versions): token lists agree
    wherever the CPU's teacher-forced top-2 margin is not a near tie."""
    from fp8tpu_torch.serve import (Request, ServeConfig, ServingEngine,
                                    full_logits, random_serve_params)
    cfg = tiny_config(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab_size=128, max_seq_len=64)
    scfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt="int8")
    host = random_serve_params(cfg, fmt, device="cpu")
    if fmt == "int4":                       # weights of a trained size
        host = {k: v * 0.01 if k.endswith("s") and k != "embed_s" else v
                for k, v in host.items()}
    reqs = lambda: [Request(uid=i, prompt=[3 + i, 5, 8], max_new_tokens=6)
                    for i in range(3)]
    want = ServingEngine(host, scfg, n_slots=2, max_seq=64,
                         device="cpu").run(reqs())
    counts = lambda: (qmatmul.dequant_launches, int4_matmul.launches,
                      inplace.launches)
    before = counts()
    got = ServingEngine({k: v.to(cuda) for k, v in host.items()}, scfg,
                        n_slots=2, max_seq=64).run(reqs())
    k3, k5, k6 = (b - a for a, b in zip(before, counts()))
    assert k6 > 0 and (k5 > 0 and k3 == 0 if fmt == "int4"
                       else k3 > 0 and k5 == 0)
    for uid in want:
        assert len(got[uid]) == 6
        if got[uid] == want[uid]:
            continue
        j = next(i for i in range(6) if got[uid][i] != want[uid][i])
        seq = torch.tensor([3 + uid, 5, 8] + want[uid][:j], dtype=torch.int32)
        top2 = full_logits(host, seq, scfg)[-1].topk(2).values
        assert float(top2[0] - top2[1]) < 0.05 * float(top2[0].abs() + 1)


def test_sampling_requests_on_the_card(cuda):
    """Temperature, top-k and top-p requests through the engine on the
    card: budgets, vocabulary range, and the seed fixes the stream."""
    from fp8tpu_torch.serve import (Request, ServeConfig, ServingEngine,
                                    random_serve_params)
    cfg = tiny_config(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=128, max_seq_len=64)
    scfg = ServeConfig(model=cfg, kv_fmt="e4m3")
    params = random_serve_params(cfg, "e4m3")
    reqs = lambda: [
        Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6, temperature=1.0,
                top_k=4),
        Request(uid=1, prompt=[8, 9], max_new_tokens=4, temperature=0.8,
                top_p=0.9),
        Request(uid=2, prompt=[1], max_new_tokens=5, temperature=1.3)]
    runs = [ServingEngine(params, scfg, n_slots=2, max_seq=64, seed=3
                          ).run(reqs()) for _ in range(2)]
    assert runs[0] == runs[1]
    assert [len(runs[0][i]) for i in range(3)] == [6, 4, 5]
    assert all(0 <= t < 128 for v in runs[0].values() for t in v)
