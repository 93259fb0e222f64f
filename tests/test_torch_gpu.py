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
from fp8tpu_torch.kernels import (cast_kernel, fp8_linear_study, inplace,
                                  int4_matmul, kexp_convert, paged_attention,
                                  qmatmul)
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
    # lengths around the 16-byte path's groups of 4 (the scalar tail), and
    # a view 4 bytes past its allocation (the scalar path); a second launch
    # gives the same bits
    xl, rl = torch.cat([xc] * 3).to(cuda), torch.cat([rbc] * 3).to(cuda)
    for n in (1, 3, 5, 4 * 1001 + 1, 8 * 1001 + 7):
        for off in (0, 1):
            xv, rv = xl[off:off + n], rl[off:off + n]
            for ms in ("E4M3_RNE", "E5M2_STOCHASTIC", "E4M3_V2_RNAZ"):
                got = tcast.qdq_mode_string(xv, ms, scale=3.7, random_bits=rv)
                again = tcast.qdq_mode_string(xv, ms, scale=3.7,
                                              random_bits=rv)
                want = tcast.qdq_mode_string(xv.cpu(), ms, scale=3.7,
                                             random_bits=rv.cpu())
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=f"{ms} n={n} {off}")
                np.testing.assert_array_equal(_bits(got), _bits(again))


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


SR, RNE = RoundMode.STOCHASTIC, RoundMode.RNE


@pytest.mark.parametrize("impl,fmt_x,mode_x,fmt_w,mode_w,m,k,n", [
    ("hw", "e4m3", RNE, None, RNE, 300, 200, 70),
    ("hw", "e5m2", RNE, None, RNE, 300, 200, 70),
    ("hw", "bfloat16", SR, "e4m3", SR, 130, 77, 33),
    ("hw", "float16", RNE, "e5m2", SR, 130, 77, 33),
    ("bitexact", "e4m3", SR, "e3m4", SR, 130, 77, 33),
    ("bitexact", None, RNE, None, RNE, 300, 200, 70),
    ("bitexact", None, RNE, None, RNE, 72, 20000, 40),     # split K
])
def test_qdq_matmul_training_variants_match_plain(cuda, impl, fmt_x, mode_x,
                                                  fmt_w, mode_w, m, k, n):
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(m, k, generator=g) * 3).to(cuda)
    w = torch.randn(k, n, generator=g).to(cuda)
    sx, sw = torch.tensor(2.0), torch.linspace(1.0, 8.0, n)
    args = (x, w, fmt_x, mode_x, fmt_w, mode_w, sx.to(cuda), sw.to(cuda), 9)
    before = qmatmul.launches
    got = qmatmul._launch(*args, impl=impl)
    assert qmatmul.launches == before + 1
    want = qmatmul.plain(*args, impl=impl)
    xq = x if fmt_x is None else qmatmul.cast_operand(
        x, fmt_x, mode_x, args[6], impl, qmatmul.sr_key(9, 1, fmt_x, mode_x))
    wq = w if fmt_w is None else qmatmul.cast_operand(
        w, fmt_w, mode_w, args[7].reshape(1, -1), impl,
        qmatmul.sr_key(9, 2, fmt_w, mode_w))
    # within the summation-order tolerance of the exact product, as the
    # plain version is; a split K also against the unsplit kernel
    from chip_smoke import k2_ratio, k2_reference
    exact, tol = k2_reference(xq, wq)
    assert k2_ratio(got, exact, tol) <= 1.0
    assert k2_ratio(want, exact, tol) <= 1.0
    if qmatmul.k2_split(m, n, k, qmatmul.sm_count(0))[0] > 1:
        whole = qmatmul._launch(*args, impl=impl, unsplit=True)
        assert k2_ratio(whole, exact, tol) <= 1.0
        assert k2_ratio(got, whole.double(), tol) <= 1.0
    assert torch.equal(qmatmul._launch(*args, impl=impl), got)  # repeatable
    if fmt_x is not None:
        # the in-kernel cast bit for bit: one exact product per output
        eye = torch.eye(k, device=cuda)
        xk = qmatmul.qdq_matmul(x, eye, fmt_x, mode_x, None, RNE, args[6],
                                seed=9, impl=impl)
        want_x = qmatmul.cast_operand(
            x.cpu(), fmt_x, mode_x, sx, impl,
            qmatmul.sr_key(9, 1, fmt_x, mode_x)) + 0.0
        np.testing.assert_array_equal(_bits(xk), _bits(want_x))


# Small ResNet-like conv geometries: (batch, Cin, H, Cout, kernel, stride,
# pad), a 1x1 stride-2 downsample and a ragged one (Cin not a multiple of 8).
CONV_GEOMETRIES = [(2, 64, 14, 32, 3, 1, 1), (2, 32, 14, 48, 3, 2, 1),
                   (2, 64, 14, 128, 1, 2, 0), (2, 64, 7, 64, 1, 1, 0),
                   (3, 20, 11, 37, 3, 2, 1)]


@pytest.mark.parametrize("impl,fmt", [("bitexact", "e4m3"), ("hw", "e4m3"),
                                      ("hw", "e5m2"), ("bitexact", None)])
@pytest.mark.parametrize("conv", CONV_GEOMETRIES)
def test_implicit_conv_matches_plain(cuda, conv, impl, fmt):
    """The engine conv as K2's implicit GEMM (one activation and one
    weight pre-pass, one GEMM) within the summation-order tolerance of the
    exact product of the cast im2col and the weight, as its plain version
    is."""
    from chip_smoke import k2_conv_operands, k2_ratio, k2_reference
    from fp8tpu_torch.numerics.scaling import per_tensor
    b, cin, h, cout, k, s, p = conv
    g = torch.Generator().manual_seed(cin + h)
    x = torch.randn(b, cin, h, h, generator=g).relu().to(cuda)
    w = (torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** 0.5
         ).to(cuda)
    strides, pads = (s, s), ((p, p), (p, p))
    scale = 1.0 if fmt is None else per_tensor(
        qmatmul.gathered(x, (k, k), strides, pads), fmt)
    args = (x, w, strides, pads, fmt, RNE, scale, 0, impl)
    before = (qmatmul.launches, qmatmul.k2_launches["prepass"])
    got = qmatmul.conv(*args)
    assert (qmatmul.launches, qmatmul.k2_launches["prepass"]) == (
        before[0] + 1, before[1] + 2)
    want = qmatmul.conv_plain(*args)
    assert got.shape == want.shape
    exact, tol = k2_reference(*k2_conv_operands(*args))

    def rows(t):
        return t.permute(0, 2, 3, 1).reshape(-1, cout)

    assert k2_ratio(rows(got), exact, tol) <= 1.0
    assert k2_ratio(rows(want), exact, tol) <= 1.0


@pytest.mark.parametrize("impl,fmt", [("bitexact", "e4m3"), ("hw", "e5m2"),
                                      ("hw", "bfloat16")])
def test_implicit_conv_identity_casts(cuda, impl, fmt):
    """A 1x1 conv against the identity makes each output one exact product:
    the NCHW output is the plain cast of x bit for bit (-0 reads +0)."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(2, 16, 5, 5, generator=g)
         * torch.exp(torch.empty(2, 16, 5, 5).uniform_(-20, 8, generator=g)))
    x[0, 0, 0, :3] = torch.tensor([1e-40, -0.0, 6e4])
    eye = torch.eye(16).reshape(16, 16, 1, 1)
    scale = torch.tensor(3.7)
    got = qmatmul.conv(x.to(cuda), eye.to(cuda), (1, 1), ((0, 0), (0, 0)),
                       fmt, RNE, scale.to(cuda), 0, impl)
    want = qmatmul.cast_operand(x, fmt, RNE, scale, impl, None) + 0.0
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_qdq_matmul_reads_transposed_operands_in_place(cuda):
    """Transposed views (the backward's g @ w^T and col^T @ g) go into the
    pre-pass as they are, with no copy: the same bits as the contiguous
    operands."""
    g = torch.Generator().manual_seed(5)
    for rows in (130, 128):    # an uncast (128, K) view goes to the GEMM
        a = torch.randn(3000, rows, generator=g).to(cuda)
        b = torch.randn(90, 3000, generator=g).to(cuda)
        for fmt_x, fmt_w in ((None, None), ("e4m3", None), ("e5m2", "e4m3")):
            args = (fmt_x, RNE, fmt_w, RNE, 2.0, 4.0)
            got = qmatmul.qdq_matmul(a.t(), b.t(), *args)
            want = qmatmul.qdq_matmul(a.t().contiguous(),
                                      b.t().contiguous(), *args)
            assert torch.equal(got, want)


def test_engine_conv_gradients_on_the_card_match_cpu(cuda):
    """The conv autograd Function on the card (implicit GEMM forward, two
    uncast K2 GEMMs backward) against the CPU route, output and both
    gradients, to the f32 summation order."""
    from fp8tpu_torch.quant import hw_patch
    cfg = tconfig.ModuleQuantConfig(
        iact=tconfig.TensorQuantConfig("e4m3", "rne", "per-tensor",
                                       cast_impl="hw"), patch_ops=True)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 16, 9, 9, generator=g)
    w = torch.randn(24, 16, 3, 3, generator=g) / 12
    r = torch.randn(2, 24, 5, 5, generator=g)
    runs = []
    for device in ("cpu", "cuda"):
        xd = x.to(device).detach().requires_grad_(True)
        wd = w.to(device).detach().requires_grad_(True)
        out = hw_patch.engine_conv(xd, wd, None, 2, [(1, 1), (1, 1)], cfg)
        (out * r.to(device)).sum().backward()
        runs.append([t.detach().cpu() for t in (out, xd.grad, wd.grad)])
    for got, want in zip(runs[1], runs[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_tiny_training_on_the_card_matches_cpu(cuda):
    """Two hybrid FP8 train steps of the tiny ResNet with hw patching, on
    the card and on the CPU from the same weights: 5 "hw" and 10 uncast K2
    launches a step on the card; losses and parameters agree to the f32
    summation order of the kernels (see tests/test_torch_training.py)."""
    import dataclasses
    import torch.nn.functional as F
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.training import init_train_state, make_train_step

    def xent(apply_fn, params, batch):
        return F.cross_entropy(apply_fn(params, batch[0]), batch[1])

    g = torch.Generator().manual_seed(3)
    x, y = torch.randn(4, 3, 8, 8, generator=g), torch.arange(4) % 10
    runs = []
    for device in ("cpu", "cuda"):
        tm = tiny_resnet(device="cpu",
                         generator=torch.Generator().manual_seed(0))
        emu = fp8tpu_torch.initialize(tm, training_algo="hybrid",
                                      exempt_layers=RESNET_EXEMPT,
                                      device=device)
        emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
        tm.train()
        params = dict(tm.named_parameters())
        state = init_train_state(torch.optim.SGD(params.values(), lr=0.1,
                                                 momentum=0.9))
        step = make_train_step(emu, xent)
        losses = []
        for i in range(2):
            k2 = dict(qmatmul.k2_launches)
            params, state, loss = step(params, state,
                                       (x.to(device), y.to(device)),
                                       prng.fold_in(prng.key(1), i))
            if device == "cuda":
                assert qmatmul.k2_launches["hw"] - k2["hw"] == 5
                assert qmatmul.k2_launches["uncast"] - k2["uncast"] == 10
            losses.append(float(loss))
        runs.append((losses, {k: p.detach().cpu() for k, p in params.items()}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for k, p in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][k].numpy(), p.numpy(), rtol=0,
                                   atol=2e-3, err_msg=k)


def _product_bound(x, w_abs, col_scale, want):
    # two f32 sums of K exact products in different orders, then (bf16
    # results) one rounding that may land a bf16 step apart
    k = x.shape[1]
    return (2.0 * k * 2.0 ** -24 * (x.float().abs() @ w_abs) * col_scale
            + 2.0 ** -7 * want.float().abs() + 1e-30)


# M = 1 .. 64 with aligned operands run the streaming loop (each wgmma n
# full and one row past it; N = 1024 takes 64-column tiles), M > 64 its
# prefill route (a ragged token tile, split K, several tiles); the rest the
# general kernel.
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (3, 200, 100),
                                   (130, 1001, 331), (1, 4096, 1024),
                                   (9, 640, 272), (16, 512, 4096),
                                   (17, 1024, 256), (63, 384, 512),
                                   (64, 2048, 1024), (65, 1280, 256),
                                   (300, 2048, 1024), (1024, 512, 4096)])
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
        again = qmatmul.dequant_matmul(x, w8, s, out_dtype)
        assert torch.equal(again.view(torch.uint8), got.view(torch.uint8))


@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (70, 192, 41),
                                   (1, 1024, 1024), (9, 384, 272),
                                   (17, 512, 4096), (64, 2048, 256),
                                   (100, 1280, 256), (600, 1024, 2048)])
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
    again = int4_matmul.int4_matmul(x, wp, s, group)
    assert torch.equal(again.view(torch.uint8), got.view(torch.uint8))


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


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_ring_store_kernel_matches_plain(cuda, dtype):
    """Both slabs and the head in one launch: bytes, head and ticket equal
    to the plain version's, two steps from each start."""
    g = torch.Generator().manual_seed(3)
    n, row8, rows = 8, (2, 2, 4, 16), (2, 2, 4)
    kv8 = torch.randint(-100, 100, (n,) + row8, generator=g).to(dtype)
    sc = torch.rand((n,) + rows, generator=g)
    kv8_g, sc_g = kv8.to(cuda), sc.to(cuda)
    ticket = torch.zeros(1, dtype=torch.int32, device=cuda)
    for idx in (0, n - 1, n + 3, -1):
        head = torch.tensor(idx, dtype=torch.int32)
        head_g = head.to(cuda)
        for _ in range(2):
            slab8 = torch.randint(-100, 100, row8, generator=g).to(dtype)
            slabs = torch.rand(rows, generator=g)
            before = inplace.launches
            inplace.ring_store(kv8_g, slab8.to(cuda), sc_g, slabs.to(cuda),
                               head_g, n, ticket)
            assert inplace.launches == before + 1
            inplace.ring_store_plain(kv8, slab8, sc, slabs, head, n)
            assert torch.equal(kv8_g.cpu().view(torch.uint8),
                               kv8.view(torch.uint8))
            assert torch.equal(sc_g.cpu(), sc)
            assert int(head_g) == int(head) and int(ticket) == 0


@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_ring_store_w_rows_matches_plain(cuda, dtype, rows):
    """The batched ring write: W rows of both slabs in one launch, bit for
    bit against the plain version, the head advanced by W and the ticket
    back at 0, from aligned starts and from starts that wrap (n - 1, and
    past the ring), with no byte written outside it."""
    g = torch.Generator().manual_seed(5)
    n, row8, rows_s = 16, (2, 2, 4, 16), (2, 2, 4)
    guard = 64                          # bytes past the ring, kept as they are
    store8 = torch.randint(-100, 100, (n * 256 + guard,), generator=g
                           ).to(torch.int8).view(torch.uint8)
    store_g = store8.to(cuda)
    kv8 = store8[:n * 256].view(dtype).reshape((n,) + row8)
    kv8_g = store_g[:n * 256].view(dtype).reshape((n,) + row8)
    sc = torch.rand((n,) + rows_s, generator=g)
    sc_g = sc.to(cuda)
    ticket = torch.zeros(1, dtype=torch.int32, device=cuda)
    for idx in (0, rows, n - 1, n + 3, -1):
        head = torch.tensor(idx, dtype=torch.int32)
        head_g = head.to(cuda)
        slab8 = torch.randint(-100, 100, (rows,) + row8, generator=g
                              ).to(dtype)
        slabs = torch.rand((rows,) + rows_s, generator=g)
        before = inplace.launches
        inplace.ring_store(kv8_g, slab8.to(cuda), sc_g, slabs.to(cuda),
                           head_g, n, ticket, rows=rows)
        assert inplace.launches == before + 1
        inplace.ring_store_plain(kv8, slab8, sc, slabs, head, n, rows=rows)
        assert torch.equal(store_g.cpu(), store8)
        assert torch.equal(sc_g.cpu(), sc)
        assert int(head_g) == int(head) == (idx + rows) % n
        assert int(ticket) == 0


def test_moe_ffn_kernels_match_plain(cuda):
    """One serving MoE FFN at a width the streaming loop takes (K = 256 and
    K = 688, a partial promotion chunk): 2E K3 launches against the same
    call with K3's plain version, on the card."""
    from fp8tpu_torch.serve import ServeConfig, random_serve_params
    from fp8tpu_torch.serve import model as smodel
    cfg = tiny_config(n_layers=1, d_model=256, n_heads=4, n_kv_heads=2,
                      d_ff=688, vocab_size=128, max_seq_len=64,
                      n_experts=4, moe_top_k=2)
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8")
    params = random_serve_params(cfg, "e4m3", seed=1, device="cuda")
    xs = smodel._layer_xs(params, 0)
    x = torch.randn(8, 256, generator=torch.Generator(device="cuda")
                    .manual_seed(2), device="cuda").to(torch.bfloat16)
    linear = smodel._make_linear(scfg)
    before = qmatmul.dequant_launches
    got = smodel._moe_ffn(x, xs, cfg, linear)
    assert qmatmul.dequant_launches == before + 2 * cfg.n_experts
    orig = qmatmul.dequant_matmul
    qmatmul.dequant_matmul = qmatmul.dequant_matmul_plain
    try:
        want = smodel._moe_ffn(x, xs, cfg, linear)
    finally:
        qmatmul.dequant_matmul = orig
    assert got.dtype == want.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 ** -6 * float(want.float().abs().max()), err


@pytest.mark.parametrize("fmt", [torch.int8, torch.float8_e4m3fn,
                                 torch.float8_e5m2, torch.bfloat16])
@pytest.mark.parametrize("batch,kv,g,d,page,mp", [(3, 2, 2, 16, 8, 4),
                                                  (9, 8, 4, 128, 64, 5),
                                                  (2, 1, 8, 64, 16, 40),
                                                  (2, 8, 1, 128, 64, 8),
                                                  (33, 8, 4, 128, 64, 8),
                                                  (5, 2, 8, 48, 8, 12)])
def test_paged_attention_kernel_matches_plain(cuda, fmt, batch, kv, g, d,
                                              page, mp):
    """K4 against its plain version on the CPU.  q lies on a 1/8 grid and
    the payload on a 1/4 grid, so every score dot is exact in f32 in any
    order: m is bit-equal, l within T * 2^-22 relative, and acc within one
    bf16 step (2^-7) of sum_t |pv_t v_td|, which bounds it from above by
    the largest |v| times l."""
    gen = torch.Generator().manual_seed(4)
    P, L, R = batch * mp + 2, 2, page * kv
    pool = (torch.randint(-15, 16, (P, 2, L, R, d), generator=gen).float()
            * 0.25).to(fmt)
    sc = torch.empty(P, 2, L, R).uniform_(0.004, 0.02, generator=gen)
    q = (torch.randint(-16, 17, (batch, kv * g, d), generator=gen).float()
         / 8).to(torch.bfloat16)
    lens = torch.randint(1, mp * page + 1, (batch,), generator=gen,
                         dtype=torch.int32)
    lens[0], lens[1] = 0, mp * page
    table = torch.randperm(P, generator=gen)[:batch * mp].reshape(
        batch, mp).to(torch.int32)
    table[torch.arange(mp)[None] * page >= lens[:, None]] = -1
    kw = dict(page_size=page, kv_heads=kv)
    for layer in range(L):
        want = paged_attention.paged_decode_attention_plain(
            q, pool, sc, table, lens, layer, **kw)
        before = paged_attention.launches
        got = paged_attention.paged_decode_attention(
            q.to(cuda), pool.to(cuda), sc.to(cuda), table.to(cuda),
            lens.to(cuda), layer, **kw)
        assert paged_attention.launches == before + 1
        acc, m, l = (t.cpu() for t in got)
        assert torch.equal(m.view(torch.int32), want[1].view(torch.int32))
        rel = mp * page * 2.0 ** -22
        assert bool(((l - want[2]).abs() <= want[2] * rel).all())
        bound = (0.02 * 3.75 * want[2] * (rel + 2.0 ** -7))[..., None] + 1e-30
        assert bool(((acc - want[0]).abs() <= bound).all())
        assert bool((m[0] == -1e30).all() and (l[0] == 0).all()
                    and (acc[0] == 0).all())


def test_paged_attention_kernel_rejects_what_it_does_not_take(cuda):
    pool = torch.zeros(2, 2, 1, 8, 24, dtype=torch.int8, device=cuda)
    sc = torch.ones(2, 2, 1, 8, device=cuda)
    table = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    q = torch.zeros(1, 2, 24, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention.paged_decode_attention(q, pool, sc, table, lens, 0,
                                               page_size=4, kv_heads=2)


@pytest.mark.parametrize("impl", ["kernel", "ringview"])
def test_tiny_paged_serving_on_the_card_matches_cpu(cuda, impl):
    """The tiny decoder's paged engine with the prefix cache on the card
    (K3, and K4 in "kernel" mode) against the same engine on the CPU (plain
    versions): token lists agree wherever the CPU's teacher-forced top-2
    margin is not a near tie, and every page comes back."""
    from fp8tpu_torch.serve import (Request, ServeConfig, ServingEngine,
                                    full_logits, random_serve_params)
    cfg = tiny_config(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab_size=128, max_seq_len=64)
    scfg = ServeConfig(model=cfg, kv_fmt="int8", paged_decode_impl=impl)
    host = random_serve_params(cfg, "e4m3", device="cpu")
    system = list(range(1, 17))
    prompts = {i: system + [30 + i, 5, 8][:1 + i % 3] for i in range(4)}
    reqs = lambda: [Request(uid=i, prompt=list(p), max_new_tokens=6)
                    for i, p in prompts.items()]
    kw = dict(n_slots=2, max_seq=64, chunk_size=4, use_paged=True,
              page_size=8, prefix_cache=True)
    want = ServingEngine(host, scfg, device="cpu", **kw).run(reqs())
    before = (paged_attention.launches, qmatmul.dequant_launches)
    eng = ServingEngine({k: v.to(cuda) for k, v in host.items()}, scfg, **kw)
    got = eng.run(reqs())
    k4 = paged_attention.launches - before[0]
    assert qmatmul.dequant_launches > before[1]
    assert k4 > 0 and k4 % cfg.n_layers == 0 if impl == "kernel" else k4 == 0
    assert eng.page_stats["shared"] > 0 and int(eng._page_ref.sum()) == 0
    for uid in want:
        assert len(got[uid]) == 6
        if got[uid] == want[uid]:
            continue
        j = next(i for i in range(6) if got[uid][i] != want[uid][i])
        seq = torch.tensor(prompts[uid] + want[uid][:j], dtype=torch.int32)
        top2 = full_logits(host, seq, scfg)[-1].topk(2).values
        assert float(top2[0] - top2[1]) < 0.05 * float(top2[0].abs() + 1)


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


# -- speculation ------------------------------------------------------------------

def _spec_model(d_model=128, heads=4, kv=2, seed=0):
    from fp8tpu_torch.serve import ServeConfig, random_serve_params
    cfg = tiny_config(n_layers=2, d_model=d_model, n_heads=heads,
                      n_kv_heads=kv, d_ff=2 * d_model, vocab_size=128,
                      max_seq_len=64)
    return (random_serve_params(cfg, "e4m3", seed=seed, device="cpu"),
            ServeConfig(model=cfg, kv_fmt="int8", paged_decode_impl="kernel"))


def _spec_pool(cfg, batch, seed, device):
    from fp8tpu_torch.serve import PagedKVCache
    g = torch.Generator().manual_seed(seed)
    paged = PagedKVCache.create(batch * 4, 8, cfg.n_layers, batch, 4,
                                cfg.n_kv_heads, cfg.head_dim, "int8",
                                device=device)
    paged.pool.copy_(torch.randint(-127, 128, paged.pool.shape, generator=g,
                                   dtype=torch.int8))
    paged.sc.copy_(torch.rand(paged.sc.shape, generator=g) * 0.02 + 0.004)
    paged.page_table = torch.randperm(batch * 4, generator=g).to(
        torch.int32).reshape(batch, 4).to(device)
    return paged


def test_score_tokens_paged_kernels_match_plain(cuda):
    """The paged verify pass on the card (K3 at M = B * T) against the same
    pass on the CPU: logits within the decode tolerance, the written pool
    rows equal, the padding row's writes dropped."""
    from fp8tpu_torch.serve import speculative as spec
    host, scfg = _spec_model()
    toks = torch.randint(1, 128, (3, 5), generator=torch.Generator(
        ).manual_seed(1), dtype=torch.int32)
    pos = torch.tensor([20, 9, 3], dtype=torch.int32)
    valid = torch.tensor([5, 2, 5], dtype=torch.int32)
    slots = torch.tensor([1, 0, 3], dtype=torch.int32)     # row 2: padding
    want_l, want = spec.score_tokens_paged(
        host, _spec_pool(scfg.model, 3, 2, "cpu"), toks, pos, scfg,
        valid_t=valid, slots=slots)
    before = qmatmul.dequant_launches
    params = {k: v.to(cuda) for k, v in host.items()}
    start = _spec_pool(scfg.model, 3, 2, "cpu").pool
    got_l, got = spec.score_tokens_paged(
        params, _spec_pool(scfg.model, 3, 2, cuda), toks.to(cuda),
        pos.to(cuda), scfg, valid_t=valid.to(cuda), slots=slots.to(cuda))
    assert qmatmul.dequant_launches - before == 7 * scfg.model.n_layers
    err = (got_l.cpu() - want_l)[:2].abs().max() / want_l[:2].abs().max()
    assert float(err) <= 5e-2
    same = (got.pool.cpu() == want.pool).float().mean()
    assert float(same) >= 0.99
    # positions written: 5 of row 0 and 2 of row 1; the padding row's and
    # the masked tokens' rows went to the scratch page
    m = scfg.model
    changed = (got.pool.cpu() != start).reshape(
        12, 2, m.n_layers, 8, m.n_kv_heads, m.head_dim).any(5).any(4).any(
        2).any(1)
    assert int(changed.sum()) == 7


def test_rollback_on_a_cuda_ring(cuda):
    """rollback moves the CUDA ring's own head tensor, with no copy, and a
    verify pass after it writes where the head says."""
    from fp8tpu_torch.serve import RingKVCache
    from fp8tpu_torch.serve import speculative as spec
    host, scfg = _spec_model()
    params = {k: v.to(cuda) for k, v in host.items()}
    m = scfg.model
    ring = RingKVCache.create(m.n_layers, 1, 32, m.n_kv_heads, m.head_dim,
                              "int8")
    head, ptr = ring.head, ring.head.data_ptr()
    k6 = inplace.routes["ring_store"]
    _, ring = spec.score_tokens(params, ring, torch.tensor(
        [[3, 4, 5, 6]], device=cuda, dtype=torch.int32),
        torch.tensor([0], device=cuda, dtype=torch.int32), scfg)
    assert inplace.routes["ring_store"] - k6 == 4 and int(ring.head) == 4
    assert spec.rollback(ring, 3) is ring
    assert ring.head is head and head.data_ptr() == ptr and int(head) == 1
    assert int(ring.ticket[0]) == 0
    spec.rollback(ring, 2)
    assert int(head) == 31                       # wraps


def test_spec_rounds_on_the_card_match_cpu(cuda):
    """Two greedy speculation rounds (a draft of D = 16, G = 2 through K4)
    on the card against the same call on the CPU: accepted counts, drafted
    and bonus tokens equal, or parted at a near tie of the CPU's
    verify logits."""
    from fp8tpu_torch.serve import speculative as spec
    host, scfg = _spec_model()
    dhost, dscfg = _spec_model(d_model=64, heads=4, kv=2, seed=1)
    carry = (torch.tensor([[9, 9], [30, 12]], dtype=torch.int32),
             torch.tensor([1, 2], dtype=torch.int32),
             torch.tensor([12, 7], dtype=torch.int32),
             torch.tensor([12, 6], dtype=torch.int32))
    zeros = torch.zeros(2)
    want = spec.spec_rounds(host, _spec_pool(scfg.model, 2, 3, "cpu"), dhost,
                            _spec_pool(dscfg.model, 2, 4, "cpu"), *carry,
                            None, zeros, 4, 2, scfg, dscfg, any_sampled=False)
    k4 = paged_attention.launches
    got = spec.spec_rounds(
        {k: v.to(cuda) for k, v in host.items()},
        _spec_pool(scfg.model, 2, 3, cuda),
        {k: v.to(cuda) for k, v in dhost.items()},
        _spec_pool(dscfg.model, 2, 4, cuda), *(c.to(cuda) for c in carry),
        None, zeros.to(cuda), 4, 2, scfg, dscfg, any_sampled=False)
    assert paged_attention.launches - k4 == 2 * 4 * dscfg.model.n_layers
    same = [torch.equal(g.cpu(), w) for g, w in zip(got[:7], want[:7])]
    assert all(same), same


# -- the convert studies T1 and T2 ---------------------------------------------

def _t1_case(bkv, seed=3):
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn(bkv, 1, kexp_convert.S, kexp_convert.D, generator=g)
    q = torch.randn(bkv, 1, kexp_convert.G, kexp_convert.D,
                    generator=g).to(torch.bfloat16)
    return q, raw.to(torch.float8_e4m3fn), raw.to(torch.bfloat16)


@pytest.mark.parametrize("mode", kexp_convert.MODES)
def test_kexp_convert_kernel_matches_plain(cuda, mode):
    q, k8, kb = _t1_case(5)
    k = (kb if mode in kexp_convert.BF16_MODES else k8).to(cuda)
    q = q.to(cuda)
    before = kexp_convert.launches
    out, fold = kexp_convert.stream(q, k, mode, reps=3)
    assert kexp_convert.launches == before + 2     # the stream and its merge
    want, want_fold = kexp_convert.stream_plain(q.cpu(), k.cpu(), mode, reps=3)
    out, fold = out.cpu(), fold.cpu()
    assert fold.shape == (3, 5)
    if mode in ("conv-astype", "conv-bits"):
        np.testing.assert_array_equal(_bits(out), _bits(want))
        np.testing.assert_array_equal(_bits(fold), _bits(want_fold))
    else:
        # random-walk bounds on the f64 values: a dropped tile, or one
        # warp's share of a tile's fold, fails them
        exact, tol, fold_exact, fold_tol = kexp_convert.error_bound(
            q.cpu(), k.cpu(), mode, 3)
        assert bool(((out.double() - exact).abs() <= tol).all())
        assert bool(((fold.double() - fold_exact).abs() <= fold_tol).all())
    # a second launch and the cold copies give the same bits
    again = kexp_convert.stream(q, k, mode, reps=3)
    cold = kexp_convert.stream(q, k, mode, reps=3, cold=True)
    for a, b in ((again, (out, fold)), (cold, (out, fold))):
        np.testing.assert_array_equal(_bits(a[0]), _bits(b[0]))
        np.testing.assert_array_equal(_bits(a[1]), _bits(b[1]))


@pytest.mark.parametrize("mode", ["conv-bits", "conv-astype"])
def test_kexp_convert_kernel_converts_every_e4m3_byte(cuda, mode):
    k = torch.zeros(1, 1, 512, 128, dtype=torch.uint8)
    k[0, 0, :2] = torch.arange(256, dtype=torch.int32).reshape(2, 128).to(
        torch.uint8)
    q = torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16)
    out, _ = kexp_convert.stream(q.to(cuda), k.to(cuda), mode, reps=1)
    got = out[:2].reshape(-1).cpu().numpy()
    want = kexp_convert.convert(k[0, 0, :2].reshape(-1), "astype"
                                ).float().numpy()
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    np.testing.assert_array_equal(got[~nan], want[~nan])


def test_kexp_convert_bits_mode_converts_random_bytes(cuda):
    """The packed bits convert through conv-bits on random bytes of every
    sign, subnormals included (|value| < 1, so the f32 sums are exact):
    out and fold bit-equal to the plain version."""
    g = torch.Generator().manual_seed(4)
    k = (torch.randint(0, 0x40, (4, 1, 512, 128), generator=g)
         | (torch.randint(0, 2, (4, 1, 512, 128), generator=g) << 7)
         ).to(torch.uint8)
    q = torch.zeros(4, 1, 8, 128, dtype=torch.bfloat16)
    out, fold = kexp_convert.stream(q.to(cuda), k.to(cuda), "conv-bits",
                                    reps=2)
    want, want_fold = kexp_convert.stream_plain(q, k, "conv-bits", reps=2)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    np.testing.assert_array_equal(_bits(fold), _bits(want_fold))


@pytest.mark.parametrize("m,k,n", [(64, 512, 512), (8, 256, 272),
                                   (17, 1024, 4096)])
def test_fp8_linear_study_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda)
    wf = torch.randn(k, n, generator=g) * 0.02
    outs = {}
    for mode in fp8_linear_study.MODES:
        w = wf.to(torch.bfloat16 if mode == "pl-bf16"
                  else torch.float8_e4m3fn).to(cuda)
        before = fp8_linear_study.launches
        got = fp8_linear_study.linear(x, w, mode, reps=3)
        assert fp8_linear_study.launches == before + 3
        want = fp8_linear_study.linear_plain(x, w, mode)
        w_abs = fp8_linear_study.weight_values(w, mode).float().abs()
        bound = _product_bound(x, w_abs, 1.0, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all())
        cold = fp8_linear_study.linear(x, w, mode, reps=3, cold=True)
        assert torch.equal(cold.view(torch.int16), got.view(torch.int16))
        outs[mode] = got.view(torch.int16)
    assert torch.equal(outs["pl-bits"], outs["pl-astype"])
    assert torch.equal(outs["pl-magic"], outs["pl-astype"])


def test_fp8_linear_study_kernel_converts_every_e4m3_byte(cuda):
    w = torch.zeros(64, 256, dtype=torch.uint8)
    w[0] = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    x = torch.zeros(16, 64, dtype=torch.bfloat16)
    x[:, 0] = 1.0
    want = kexp_convert.convert(w[0], "astype").float().numpy()
    nan = np.isnan(want)
    for mode in ("pl-astype", "pl-bits", "pl-magic"):
        got = fp8_linear_study.linear(x.to(cuda), w.to(cuda), mode, reps=1)
        got = got[0].float().cpu().numpy()
        assert (np.isnan(got) == nan).all(), mode
        np.testing.assert_array_equal(got[~nan], want[~nan], err_msg=mode)


def test_convert_studies_reject_what_they_do_not_take(cuda):
    q, k8, _ = _t1_case(2)
    with pytest.raises(ValueError, match="bf16 k"):
        kexp_convert.stream(q.to(cuda), k8.to(cuda), "dot-bf16")
    x = torch.zeros(65, 64, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(64, 32, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="streaming kernel"):
        fp8_linear_study.linear(x, w, "pl-bits")


# -- P1 / P2: the W8A8 serving linear ------------------------------------------

@pytest.mark.parametrize("m,k", [(1, 4096), (64, 11008), (700, 1001),
                                 (2048, 4096), (8, 11008), (300, 5504),
                                 (5, 40000), (33, 1000)])
def test_quantize_rows_kernel_matches_plain(cuda, m, k):
    """P2 against its plain version on the CPU, codes and scales bit for
    bit, with a zero row, a row of bf16 subnormals, +-inf, a NaN and the
    tiny-amax row, and a second launch bit for bit: rows held in registers
    (K = 4096, 5504, 11008 at several M), a row wider than the registers
    hold (K = 40000) and ragged ones (K = 1001, 1000 at an odd offset) on
    the looped path."""
    gen = torch.Generator().manual_seed(m)
    x = torch.randn(m, k, generator=gen) * 5
    if m > 8:
        x[1] = 0.0
        x[2] = 2.0 ** -130
        x[3, 5], x[4, 7], x[5, 9] = float("inf"), float("-inf"), float("nan")
        x[6] = 0.0
        x[6, :3] = torch.tensor([1e-37, -3e-38, 5e-38])
    xb = x.to(torch.bfloat16)
    xc = xb.to(cuda)
    if k == 1000:       # rows 8-byte aligned only: the scalar accesses
        xc = torch.empty(m * k + 4, dtype=torch.bfloat16,
                         device=cuda)[4:].view(m, k)
        xc.copy_(xb)
    before = qmatmul.quantize_launches
    q, s = qmatmul.quantize_rows(xc)
    q2, s2 = qmatmul.quantize_rows(xc)
    assert qmatmul.quantize_launches == before + 2
    wq, ws = qmatmul.quantize_rows_plain(xb)
    np.testing.assert_array_equal(q.view(torch.uint8).cpu().numpy(),
                                  wq.view(torch.uint8).numpy())
    np.testing.assert_array_equal(s.cpu().view(torch.int32).numpy(),
                                  ws.view(torch.int32).numpy())
    assert torch.equal(q2.view(torch.uint8), q.view(torch.uint8))
    assert torch.equal(s2.view(torch.int32), s.view(torch.int32))


# P1's shapes: both forms of the streaming loop (decode at M <= 64, the
# prefill route above) on the dense k/v and the MoE expert shapes, split and
# unsplit K; then N not a multiple of 128 (a block's last column tile
# partly outside N, TMA's weight box past the edge), on both forms.
W8A8_GPU_SHAPES = [
    (m, k, n) for m in (1, 8, 64, 65, 130, 2047)
    for k, n in ((4096, 1024), (2048, 5504), (5504, 2048))] + [
    (9, 2048, 5504), (700, 512, 272)] + [
    (m, k, n) for m in (8, 65, 700) for k, n in ((4096, 272), (2048, 48))]


def _fp8_sum_allowance(xq, w8, edges):
    """What the fp8 tensor cores' own sums may add to P1's error before its
    scales (their model, chip_smoke.py's fp8_chunk_bound, measured by its
    w8a8_probe): each k32 step keeps 13 bits below its largest addend, so
    it is off by less than 2^-8 (|the chunk so far| + sum |its products|);
    chunks between P1's promotion ``edges``."""
    x, w = xq.double(), w8.double()
    bound = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float64,
                        device=x.device)
    for a, b in zip(edges, edges[1:]):
        run = torch.zeros_like(bound)
        for k0 in range(a, b, 32):
            xa, wa = x[:, k0:k0 + 32], w[k0:k0 + 32]
            bound += run.abs() + xa.abs() @ wa.abs()
            run += xa @ wa
    return (bound * 2.0 ** -8).float()


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("m,k,n", W8A8_GPU_SHAPES)
def test_w8a8_kernel_matches_plain(cuda, m, k, n, fmt, out_dtype):
    """P1 against its plain version on the card (W8A8_GPU_SHAPES): within
    the f32 summation-order bound plus, where it writes bf16, one bf16
    step, or where it writes f32, the fp8 tensor cores' allowance (and
    its f32 values not rounded to bf16); a second launch bit for bit, the
    launch counted by form; a ragged K raises."""
    gen = torch.Generator(device=cuda).manual_seed(k + m)
    x = torch.randn(m, k, device=cuda, generator=gen).to(torch.bfloat16)
    w8, s = qmatmul.quantize_weights(
        torch.randn(k, n, device=cuda, generator=gen) / k ** 0.5, fmt)
    xq, xs = qmatmul.quantize_rows(x)
    before = qmatmul.w8a8_launches
    form = "decode" if m <= 64 else "prefill"
    routes = qmatmul.w8a8_routes[form]
    got = qmatmul.w8a8_matmul(xq, xs.reshape(-1), w8, s.reshape(-1),
                              out_dtype)
    again = qmatmul.w8a8_matmul(xq, xs.reshape(-1), w8, s.reshape(-1),
                                out_dtype)
    assert qmatmul.w8a8_launches == before + 2
    assert qmatmul.w8a8_routes[form] == routes + 2
    want = qmatmul.w8a8_matmul_plain(xq, xs.reshape(-1), w8, s.reshape(-1),
                                     out_dtype)
    mag = xq.float().abs() @ w8.float().abs()
    scale = xs * s.reshape(1, -1)
    tol = 2 * k * 2.0 ** -24 * mag * scale
    if out_dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    else:
        plan = qmatmul.w8a8_plan(m, n, k, qmatmul.sm_count(cuda.index or 0))
        tol = tol + _fp8_sum_allowance(
            xq, w8, qmatmul.w8a8_edges(k, plan.kper)) * scale
        assert float((got == got.to(torch.bfloat16).float()).float()
                     .mean()) < 0.5
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    with pytest.raises(ValueError, match="K % 32"):
        qmatmul.w8a8_matmul(xq[:, :k - 16].contiguous(), xs.reshape(-1),
                            w8[:k - 16], s.reshape(-1))


def _edge_rows(x):
    """x (m, k) f32 with, from row 1 on where there are rows, a zero row,
    bf16 subnormals, +-inf, a NaN and the tiny-amax row."""
    if x.shape[0] > 8:
        x[1] = 0.0
        x[2] = 2.0 ** -130
        x[3, 5], x[4, 7], x[5, 9] = float("inf"), float("-inf"), float("nan")
        x[6] = 0.0
        x[6, :3] = torch.tensor([1e-37, -3e-38, 5e-38])
    return x


@pytest.mark.parametrize("m,k", [(1, 4096), (64, 11008), (700, 1001),
                                 (2048, 4096), (5, 40000), (33, 1000)])
def test_quantize_rows_codes_match_the_bytes(cuda, m, k):
    """P2 writing the codes' values as f16 (the int8 route's input):
    bit for bit its own byte output's values (``codes_as``: a NaN code the
    sign on the quiet NaN) on the card and the plain version on the CPU,
    the same scales, a second launch bit for bit; the register path, the
    looped path (K = 40000), ragged rows (K = 1001) and rows at an odd
    offset (K = 1000: scalar accesses)."""
    gen = torch.Generator().manual_seed(m + k)
    xb = _edge_rows(torch.randn(m, k, generator=gen) * 5).to(torch.bfloat16)
    xc = xb.to(cuda)
    if k == 1000:
        xc = torch.empty(m * k + 4, dtype=torch.bfloat16,
                         device=cuda)[4:].view(m, k)
        xc.copy_(xb)
    codes_dtype = torch.float16
    before = qmatmul.quantize_launches
    q, s = qmatmul.quantize_rows(xc, codes_dtype=codes_dtype)
    q2, s2 = qmatmul.quantize_rows(xc, codes_dtype=codes_dtype)
    qb, sb = qmatmul.quantize_rows(xc)
    assert qmatmul.quantize_launches == before + 3
    assert q.dtype == codes_dtype and q.shape == xc.shape
    wide = qmatmul.codes_as(qb, codes_dtype)
    assert torch.equal(q.view(torch.int16), wide.view(torch.int16))
    assert torch.equal(s.view(torch.int32), sb.view(torch.int32))
    wq, ws = qmatmul.quantize_rows_plain(xb, codes_dtype=codes_dtype)
    np.testing.assert_array_equal(q.view(torch.int16).cpu().numpy(),
                                  wq.view(torch.int16).numpy())
    np.testing.assert_array_equal(s.cpu().view(torch.int32).numpy(),
                                  ws.view(torch.int32).numpy())
    assert torch.equal(q2.view(torch.int16), q.view(torch.int16))
    assert torch.equal(s2.view(torch.int32), s.view(torch.int32))


# K3's int8 route: the decode form (M <= 64) and the prefill route on the
# dense and MoE shapes, N not a multiple of 128 on both, and the general
# kernel where TMA cannot read the operands (K % 8 != 0)
K3_INT8_SHAPES = [
    (m, k, n) for m in (1, 8, 64, 65, 2047)
    for k, n in ((4096, 1024), (2048, 5504))] + [
    (m, k, n) for m in (8, 700) for k, n in ((4096, 272), (2048, 48))] + [
    (9, 1001, 272), (130, 1001, 48)]


@pytest.mark.parametrize("m,k,n", K3_INT8_SHAPES)
def test_k3_int8_route_matches_plain(cuda, m, k, n):
    """K3's int8 route (P2's f16 codes against int8 weights, the f16
    tensor cores) against its plain version: within the f32 summation-order
    bound plus one bf16 step, a second launch bit for bit, counted by
    route; the same sums as the plain version's where they are exact."""
    gen = torch.Generator(device=cuda).manual_seed(k + m + n)
    x = torch.randn(m, k, device=cuda, generator=gen).to(torch.bfloat16)
    w8, s = qmatmul.quantize_weights(
        torch.randn(k, n, device=cuda, generator=gen) / k ** 0.5, "int8")
    s = s.reshape(-1)
    xh, xs = qmatmul.quantize_rows(x, codes_dtype=torch.float16)
    xs = xs.reshape(-1)
    plan = qmatmul.weight_gemm_plan(m, n, k, qmatmul.sm_count(
        cuda.index or 0), "w8", xh, w8)
    before = qmatmul.dequant_routes[plan.route]
    got = qmatmul.dequant_matmul(xh, w8, s, torch.bfloat16, xs)
    again = qmatmul.dequant_matmul(xh, w8, s, torch.bfloat16, xs)
    assert qmatmul.dequant_routes[plan.route] == before + 2
    assert (plan.route == "general") == (k % 8 != 0)
    want = qmatmul.dequant_matmul_plain(xh, w8, s, torch.bfloat16, xs)
    tol = _product_bound(xh, w8.float().abs(), xs.reshape(-1, 1) * s, want)
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def test_k3_int8_route_every_code_byte_pair(cuda):
    """Every (e4m3 code, int8 byte) pair through K3's int8 route, value for
    value (NaN where the code is NaN), in launches of 64 rows (the decode
    form) and of 256 (the prefill route): x (256, 32) holds code i's f16
    value in row i's first column, w8 (32, 256) byte j in column j's first
    row, zeros elsewhere, unit scales."""
    codes = torch.arange(256, device=cuda, dtype=torch.uint8)
    xq = torch.zeros(256, 32, device=cuda, dtype=torch.uint8)
    xq[:, 0] = codes
    xh = qmatmul.codes_as(xq.view(torch.float8_e4m3fn), torch.float16)
    w8 = torch.zeros(32, 256, device=cuda, dtype=torch.uint8)
    w8[0] = codes
    w8 = w8.view(torch.int8)
    ones = torch.ones(256, device=cuda)
    want = qmatmul.dequant_matmul_plain(xh, w8, ones, torch.float32, ones)
    for mb in (64, 256):
        got = torch.cat([qmatmul.dequant_matmul(
            xh[i:i + mb].contiguous(), w8, ones, torch.float32, ones[:mb])
            for i in range(0, 256, mb)])
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        assert bool(same.all()), mb
        assert int(torch.isnan(got).sum()) == 2 * 256


def test_k3_takes_f16_x_with_int8_weights_only(cuda):
    xh = torch.zeros(8, 64, dtype=torch.float16, device=cuda)
    w8 = torch.zeros(64, 32, dtype=torch.float8_e4m3fn, device=cuda)
    with pytest.raises(ValueError, match="int8 weights only"):
        qmatmul.dequant_matmul(xh, w8, torch.ones(32, device=cuda))


def test_direct_int8_decode_step_is_two_launches_a_linear(cuda):
    """A tiny decoder's decode step with int8 weights and
    matmul_impl="direct": one P2 (f16 codes) and one K3 launch a linear and
    no P1; logits close to the plain path's on the CPU."""
    from fp8tpu_torch.serve import (RingKVCache, ServeConfig, decode_step,
                                    random_serve_params)
    cfg = tiny_config(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                      d_ff=512, vocab_size=512, max_seq_len=64)
    params = random_serve_params(cfg, "int8", seed=3)
    scfg = ServeConfig(model=cfg, weight_fmt="int8", kv_fmt="int8",
                       matmul_impl="direct")
    tok = torch.arange(4, device=cuda, dtype=torch.int32)
    ring = RingKVCache.create(2, 4, 64, 2, 64, "int8")
    qmatmul.reset_launches()
    logits, _ = decode_step(params, ring, tok, tok, scfg)
    assert (qmatmul.quantize_launches, qmatmul.dequant_launches,
            qmatmul.w8a8_launches) == (14, 14, 0)
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in params.items()}
    ring_c = RingKVCache.create(2, 4, 64, 2, 64, "int8", device="cpu")
    want, _ = decode_step(cpu, ring_c, tok.cpu(), tok.cpu(), scfg)
    top = float(want.abs().max())
    assert float((logits.float().cpu() - want.float()).abs().max()) \
        <= 4e-2 * top


def test_direct_decode_step_on_the_card_launches_p1_and_p2(cuda):
    """A tiny decoder's decode step with matmul_impl="direct": one P2 and
    one P1 launch a linear, logits within the plain path's reach."""
    from fp8tpu_torch.serve import (RingKVCache, ServeConfig, decode_step,
                                    random_serve_params)
    cfg = tiny_config(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                      d_ff=512, vocab_size=512, max_seq_len=64)
    params = random_serve_params(cfg, "e4m3", seed=3)
    scfg = ServeConfig(model=cfg, kv_fmt="int8", matmul_impl="direct")
    ring = RingKVCache.create(2, 4, 64, 2, 64, "int8")
    tok = torch.arange(4, device=cuda, dtype=torch.int32)
    qmatmul.reset_launches()
    logits, _ = decode_step(params, ring, tok, tok, scfg)
    assert (qmatmul.quantize_launches, qmatmul.w8a8_launches) == (14, 14)
    assert bool(torch.isfinite(logits).all())


def _adam8_case(rng, shape, lo=-18.0, hi=0.0):
    """A leaf, its gradient and a moment state three steps in, made on the
    CPU by the plain version (scales and payloads of every kind)."""
    from fp8tpu_torch.kernels import adam8
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    nb = -(-p.numel() // adam8.BLOCK)
    mq = torch.zeros((nb, adam8.BLOCK), dtype=torch.int8)
    ms = torch.zeros(nb)
    vq = torch.zeros((nb, adam8.BLOCK), dtype=torch.float8_e4m3fn)
    vs = torch.zeros(nb)
    for c in range(1, 4):
        g = torch.from_numpy((rng.standard_normal(shape) * np.exp(
            rng.uniform(lo, hi, shape))).astype(np.float32))
        args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                               *adam8.bias_corrections(0.9, 0.999, c))
        adam8.adam8_update_plain(torch.empty_like(g), g, mq, ms, vq, vs,
                                 args, "store")
    g = torch.from_numpy((rng.standard_normal(shape) * np.exp(
        rng.uniform(lo, hi, shape))).astype(np.float32))
    return p, g, [mq, ms, vq, vs]


def _unaligned(t, dev):
    """``t`` on ``dev`` 4 bytes past a 16-byte boundary (P3 walks it as one
    strided row)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("shape,mode,view,lo", [
    ((300, 257), "apply_decay", False, -18.0),
    ((1,), "apply", False, -18.0),
    ((257,), "store", False, -18.0),
    ((64, 768), "apply_decay", True, -18.0),    # a Dense weight, (in, out)
    ((2048,), "apply", False, -60.0),           # subnormal g * g
    ((1000,), "apply_decay", "unaligned", -18.0),
], ids=["ragged-decay", "one", "store", "transposed-view", "subnormal",
        "unaligned"])
def test_adam8_kernel_matches_plain(cuda, shape, mode, view, lo):
    """P3 against its plain version: the parameter (or update), the payload
    bytes and the scales, bit for bit, on both of its walks (16-byte loads;
    4-byte loads through strides, of a transposed view or of an unaligned
    leaf as one row)."""
    from fp8tpu_torch.kernels import adam8
    rng = np.random.default_rng(11)
    p, g, st = _adam8_case(rng, shape, lo=lo)
    args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                           *adam8.bias_corrections(0.9, 0.999, 4),
                           weight_decay=1e-4, neg_lr=-1e-3)
    pc, gc = p.clone(), g.clone()
    stc = [t.clone() for t in st]
    pk, gk = p.to(cuda), g.to(cuda)
    stk = [t.to(cuda) for t in st]
    if view == "unaligned":
        pk, gk = _unaligned(p, cuda), _unaligned(g, cuda)
    elif view:
        pc, gc, pk, gk = pc.t(), gc.t(), pk.t(), gk.t()
    adam8.adam8_update_plain(pc, gc, *stc, args, mode)
    before = adam8.launches
    adam8.adam8_update(pk, gk, *stk, args, mode)
    torch.cuda.synchronize()
    assert adam8.launches == before + 1
    np.testing.assert_array_equal(_bits(pk), _bits(pc))
    for got, want in zip(stk, stc):
        np.testing.assert_array_equal(
            got.cpu().view(torch.uint8).numpy() if got.element_size() == 1
            else _bits(got),
            want.view(torch.uint8).numpy() if want.element_size() == 1
            else _bits(want))


def _adam8_bytes(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.view(torch.int32).numpy()


def _forced(kind, p, g, st):
    """Make the second block of a (4096,) case take P3's slow route."""
    if kind == "nan-g":
        g[300] = float("nan")
    elif kind == "inf-g":
        g[300] = float("inf")
    elif kind == "big-g":
        g[300] = -(2.0 ** 61)
    elif kind == "big-p":
        p[300] = 2.0 ** 101
    elif kind == "subnormal-scale":
        st[3][1] = 3e-39
    elif kind == "nan-code":
        st[2].view(torch.uint8)[1, 7] = 0xFF


@pytest.mark.parametrize("kind,slow", [
    ("fast", 0), ("nan-g", 1), ("inf-g", 1), ("big-g", 1), ("big-p", 1),
    ("subnormal-scale", 1), ("nan-code", 1)])
def test_adam8_routes_forced_by_data(cuda, kind, slow):
    """Each block of P3 takes its fast or its slow route by its data: a
    NaN or inf gradient, |g| over 2^60, |p| over 2^100, a subnormal old
    scale or a NaN / negative v code sends its block to the slow route;
    either way the bits are the plain version's on the CPU."""
    from fp8tpu_torch.kernels import adam8
    rng = np.random.default_rng(21)
    p, g, st = _adam8_case(rng, (4096,))
    _forced(kind, p, g, st)
    args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                           *adam8.bias_corrections(0.9, 0.999, 4),
                           weight_decay=1e-4, neg_lr=-1e-3)
    pk, gk, stk = p.to(cuda), g.to(cuda), [t.to(cuda) for t in st]
    routes = torch.zeros(2, dtype=torch.int64, device=cuda)
    adam8.adam8_update(pk, gk, *stk, args, "apply_decay", routes=routes)
    adam8.adam8_update_plain(p, g, *st, args, "apply_decay")
    assert routes.tolist() == [16 - slow, slow]
    for got, want in zip([pk] + stk, [p] + st):
        np.testing.assert_array_equal(_adam8_bytes(got), _adam8_bytes(want))


def _adam8_leaves(rng, dev):
    """A table of every kind of leaf (CPU copies and ``dev`` ones): walks
    vector, tile (a Dense weight's view, store mode too), strided (a view
    with rows not of 256, an unaligned leaf), masked and unmasked decay."""
    from fp8tpu_torch.kernels import adam8
    spec = [((1,), "apply", None), ((257,), "apply_decay", None),
            ((7, 11, 3), "store", None), ((512, 64), "apply_decay", "t"),
            ((256, 96), "store", "t"), ((300, 64), "apply", "t"),
            ((1000,), "apply_decay", "unaligned")]
    cpu, card = [], []
    for shape, mode, view in spec:
        p, g, st = _adam8_case(rng, shape)
        pk, gk = p.to(dev), g.to(dev)
        if view == "unaligned":
            pk, gk = _unaligned(p, dev), _unaligned(g, dev)
        elif view:
            p, g, pk, gk = p.t(), g.t(), pk.t(), gk.t()
        cpu.append(adam8.Leaf(p, g, *st, mode=mode))
        card.append(adam8.Leaf(pk, gk, *[t.to(dev) for t in st], mode=mode))
    return cpu, card


def test_adam8_update_many_matches_plain(cuda):
    """Every kind of leaf in one grouped launch: each leaf's parameter
    (through its view), payloads and scales equal to the plain version's
    leaf by leaf; the walks the table chose; one launch counted, covering
    every leaf; a second call with the same table reuses it."""
    from fp8tpu_torch.kernels import adam8
    cpu, card = _adam8_leaves(np.random.default_rng(23), cuda)
    assert [adam8.walk_of(lf.p, lf.g) for lf in card] == [
        "vector", "vector", "vector", "tile", "tile", "strided", "strided"]
    args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                           *adam8.bias_corrections(0.9, 0.999, 4),
                           weight_decay=1e-4, neg_lr=-1e-3)
    before = (adam8.launches, adam8.leaves_covered)
    table = adam8.adam8_update_many(card, args)
    torch.cuda.synchronize()
    assert (adam8.launches - before[0],
            adam8.leaves_covered - before[1]) == (1, len(card))
    for lf in cpu:
        adam8.adam8_update_plain(*lf[:6], args, lf.mode)
    for got, want in zip(card, cpu):
        for a, b in zip(got[:1] + got[2:6], want[:1] + want[2:6]):
            np.testing.assert_array_equal(_adam8_bytes(a), _adam8_bytes(b))
    assert adam8.leaf_table(card, table) is table


@pytest.mark.parametrize("cpu_first", [True, False], ids=["cpu-first",
                                                          "card-first"])
def test_adam8_update_many_refuses_mixed_devices(cuda, cpu_first):
    """A table with a CPU leaf and a card leaf raises before any update:
    the card's tensors never reach the plain version, nor the CPU's the
    kernel."""
    from fp8tpu_torch.kernels import adam8
    cpu, card = _adam8_leaves(np.random.default_rng(31), cuda)
    args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                           *adam8.bias_corrections(0.9, 0.999, 4),
                           weight_decay=1e-4, neg_lr=-1e-3)
    before = [_adam8_bytes(t) for t in cpu[1][:6] + card[0][:6]]
    launches = adam8.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        adam8.adam8_update_many([cpu[1], card[0]] if cpu_first
                                else [card[0], cpu[1]], args)
    torch.cuda.synchronize()
    assert adam8.launches == launches
    for a, t in zip(before, cpu[1][:6] + card[0][:6]):
        np.testing.assert_array_equal(a, _adam8_bytes(t))


@pytest.mark.parametrize("shape,mode", [((768, 2304), "apply_decay"),
                                        ((2304, 768), "apply"),
                                        ((256, 768), "store")],
                         ids=["down", "gate", "kv-store"])
def test_adam8_tile_walk_matches_plain(cuda, shape, mode):
    """The tile walk (a Dense weight (out, in) updated through its (in, out)
    view, staged through shared memory) at the large decoder's shapes."""
    from fp8tpu_torch.kernels import adam8
    rng = np.random.default_rng(29)
    p, g, st = _adam8_case(rng, shape)
    pk, gk = p.to(cuda).t(), g.to(cuda).t()
    stk = [t.to(cuda) for t in st]
    assert adam8.walk_of(pk, gk) == "tile"
    args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                           *adam8.bias_corrections(0.9, 0.999, 4),
                           weight_decay=1e-4, neg_lr=-1e-3)
    adam8.adam8_update(pk, gk, *stk, args, mode)
    adam8.adam8_update_plain(p.t(), g.t(), *st, args, mode)
    for got, want in zip([pk] + stk, [p.t()] + st):
        np.testing.assert_array_equal(_adam8_bytes(got), _adam8_bytes(want))


def test_adamw_8bit_steps_on_the_card(cuda):
    """adamw_8bit over CUDA tensors launches P3 once a step, covering every
    leaf, and leaves the parameters the plain version's, bit for bit."""
    from fp8tpu_torch.kernels import adam8
    from fp8tpu_torch.training import adamw_8bit
    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal((96, 40)).astype(np.float32),
            "b": rng.standard_normal(40).astype(np.float32)}
    runs = {}
    for dev in ("cpu", cuda):
        params = {k: torch.from_numpy(v.copy()).to(dev)
                  for k, v in init.items()}
        opt = adamw_8bit(params, 1e-3, mask={"w": True, "b": False})
        gr = np.random.default_rng(4)
        before = (adam8.launches, adam8.leaves_covered)
        for _ in range(3):
            for p in params.values():
                p.grad = torch.from_numpy(gr.standard_normal(
                    tuple(p.shape)).astype(np.float32)).to(dev)
            opt.step()
        runs[str(dev)] = (params, (adam8.launches - before[0],
                                   adam8.leaves_covered - before[1]))
    assert runs["cuda"][1] == (3, 6) and runs["cpu"][1] == (0, 0)
    for k in init:
        np.testing.assert_array_equal(_bits(runs["cuda"][0][k]),
                                      _bits(runs["cpu"][0][k]))


# -- the sparsity engine and the shaped PRNG draws ---------------------------

# tests/test_torch_sparse.py's THRESHOLD_RTOL: the stochastic-pruning
# threshold goes through erf / exp / log and a long f32 sum, whose last
# bits differ between implementations.
SPARSE_THRESHOLD_RTOL = 1e-5


def test_uniform_and_randint_on_cuda_equal_the_cpu(cuda):
    from fp8tpu_torch.numerics import prng
    for seed in (0, 7):
        k = prng.fold_in(prng.key(seed), 3)
        for shape in ((1,), (1000,), (64, 257)):
            for lo, hi in ((0.0, 1.0), (-2.0, 3.5)):
                a = prng.uniform(k, shape, lo, hi, device=cuda)
                assert a.is_cuda
                np.testing.assert_array_equal(
                    _bits(a), _bits(prng.uniform(k, shape, lo, hi)))
            for lo, hi in ((0, 2048), (-5, 10 ** 6), (0, 2 ** 31 - 1)):
                a = prng.randint(k, lo, hi, shape, device=cuda)
                assert a.is_cuda
                assert torch.equal(a.cpu(), prng.randint(k, lo, hi, shape))


@pytest.mark.parametrize("cfg", [("e4m3", "rne", "none"),
                                 ("e4m3", "rne", "per-tensor"),
                                 ("e4m3", "stochastic", "none")])
def test_fake_quant_sparse_on_cuda_is_k1(cfg, cuda):
    from fp8tpu_torch.numerics import prng
    dtype, scheme, scaling = cfg
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (300, 257)).astype(np.float32)
    x[rng.random(x.shape) < 0.6] = 0.0
    sp = torch.from_numpy(x).to_sparse_coo()
    c = tconfig.TensorQuantConfig(dtype, scheme, scaling=scaling)
    key = prng.key(4) if scheme == "stochastic" else None
    before = cast_kernel.launches
    got = tfq.fake_quant_sparse(sp.to(cuda), c, key)
    assert cast_kernel.launches == before + 1
    want = tfq.fake_quant_sparse(sp, c, key)
    assert torch.equal(got.indices().cpu(), want.indices())
    np.testing.assert_array_equal(_bits(got.values()), _bits(want.values()))


def test_stochastic_prune_threshold_on_cuda(cuda):
    from fp8tpu_torch.sparse import (sparsify_weight, stochastic_prune,
                                     stochastic_prune_threshold,
                                     SparseConfig, SparseState)
    from fp8tpu_torch.numerics import prng
    g = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1e-2, (512, 1024)).astype(np.float32))
    for sparsity in (0.3, 0.5, 0.9):
        want = float(stochastic_prune_threshold(g, sparsity))
        got = float(stochastic_prune_threshold(g.to(cuda), sparsity))
        assert abs(got - want) <= SPARSE_THRESHOLD_RTOL * want
    alpha = torch.tensor(0.004)
    np.testing.assert_array_equal(
        _bits(stochastic_prune(g.to(cuda), alpha.to(cuda), prng.key(1))),
        _bits(stochastic_prune(g, alpha, prng.key(1))))
    cfg = SparseConfig(weight=True, weight_sparsity=0.5, alpha_window=10)
    st = SparseState.create()
    st.step = torch.tensor(10, dtype=torch.int32)
    a, aa = sparsify_weight(g, cfg, st, prng.key(3))
    st_c = SparseState(st.weight_alpha.to(cuda), st.outgrad_alpha.to(cuda),
                       st.step.to(cuda))
    b, ba = sparsify_weight(g.to(cuda), cfg, st_c, prng.key(3))
    assert _bits(ba).tolist() == _bits(aa).tolist()
    np.testing.assert_array_equal(_bits(b), _bits(a))


# -- the vision families and BERT on the card (chip_smoke's vision and bert
# phases at full width) -----------------------------------------------------

def _engine_convs(model, policy):
    """Paths of the non-exempt dense convs hw patching sends to K2, and of
    the grouped ones it must not."""
    from fp8tpu_torch.linen import Conv
    from fp8tpu_torch.quant.hw_patch import engine_convs
    return engine_convs(model, policy), {
        n.replace(".", "/") for n, m in model.named_modules()
        if isinstance(m, Conv) and m.feature_group_count != 1}


def _corr(a, b):
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


@pytest.mark.parametrize("name", ["tiny_vgg", "tiny_mobilenet",
                                  "tiny_inception", "tiny_densenet",
                                  "tiny_shufflenet", "tiny_squeezenet",
                                  "tiny_mbconv", "tiny_vit"])
def test_vision_family_on_the_card(cuda, name):
    """e4m3 PTQ with hw patching on the card: one K2 GEMM (and two
    pre-passes) a forward for each non-exempt dense conv and none for a
    grouped one, K1 on every quantized Dense input of ViT; the logits
    against the CPU run of the same quantized model (per-tensor scales
    turn summation-order ulps into e4m3 steps, so the card is held by
    correlation, > 0.999, and within 5e-2 of max|logit|)."""
    from fp8tpu_torch.models import vision
    model = getattr(vision, name)(8, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    model.eval()
    exempt = {"tiny_vgg": vision.VGG_EXEMPT,
              "tiny_vit": vision.VIT_EXEMPT}.get(name, ("conv_stem",
                                                        "classifier"))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    policy = fp8tpu_torch.get_policy("e4m3", training=False) \
        .with_hw_patching()
    dense, grouped = _engine_convs(model, policy.with_exempt(*exempt))
    runs, counts = [], {}
    for device in ("cpu", "cuda"):
        qm = fp8tpu_torch.quantize_model(model, (x,), policy=policy,
                                         list_exempt_layers=exempt,
                                         device=device)
        k1, k2 = cast_kernel.launches, qmatmul.launches
        pre = qmatmul.k2_launches["prepass"]
        with torch.no_grad():
            runs.append(qm(x).cpu().numpy())
        counts = {"K1": cast_kernel.launches - k1,
                  "K2": qmatmul.launches - k2,
                  "prepass": qmatmul.k2_launches["prepass"] - pre}
    assert counts["K2"] == len(dense) and counts["prepass"] == 2 * len(dense)
    if name == "tiny_vit":
        assert counts["K1"] == 12 and not dense
    if name in ("tiny_mobilenet", "tiny_shufflenet", "tiny_mbconv"):
        assert grouped
    assert _corr(runs[1], runs[0]) > 0.999
    assert np.abs(runs[1] - runs[0]).max() <= 5e-2 * np.abs(runs[0]).max()


def test_bert_hw_patching_on_the_card(cuda):
    """tiny BERT's hybrid recipe with hw patching on the card: one K2 GEMM
    a (batch, head) slice of both BatchMatmuls, none elsewhere; the start
    logits against the CPU run by correlation, > 0.99 (measured 0.9984:
    per-tensor scales of every Dense, add and product input turn
    summation-order ulps into e4m3 steps, as in the CPU tests)."""
    from fp8tpu_torch.models import bert
    cfg = bert.tiny_bert()
    model = bert.bert_for_qa(cfg, "cpu", torch.Generator().manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 24:] = 0
    policy = fp8tpu_torch.get_policy("hybrid", training=False) \
        .with_hw_patching()
    runs = []
    for device in ("cpu", "cuda"):
        qm = fp8tpu_torch.quantize_model(
            model, (ids, mask), policy=policy,
            list_exempt_layers=bert.BERT_QA_EXEMPT,
            list_layers_output_fused=bert.BERT_OUTPUT_FUSED, device=device)
        k2 = qmatmul.launches
        with torch.no_grad():
            runs.append(qm(ids, mask)[0].cpu().numpy())
        launched = qmatmul.launches - k2
    assert launched == 2 * cfg.n_layers * 2 * cfg.n_heads
    assert _corr(runs[1], runs[0]) > 0.99


# -- tensor parallelism inside the decoder, a world of one over NCCL ---------

@pytest.fixture
def world1(cuda):
    """A one-rank NCCL world (the card is one H100) and its data 1 x model
    1 mesh; the world stays up for the file's later tests."""
    from fp8tpu_torch.parallel import init_world, make_mesh
    init_world("cuda")
    return make_mesh(data=1, model=1)


def test_tp_ptq_forward_on_the_card_matches_the_unsharded_one(world1):
    """The TP form of the tiny decoder under e4m3 PTQ on a one-rank mesh:
    K1 launches, weights and logits bit-equal to the unsharded forward (a
    group of one holds every product whole)."""
    from fp8tpu_torch.models.transformer import Decoder, decoder
    from fp8tpu_torch.parallel import DECODER_PARAM_RULES, local_shards
    from fp8tpu_torch.quant import interceptor as icp
    from fp8tpu_torch.quant.policy import e4m3_inference_policy
    cfg = tiny_config(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab_size=256, max_seq_len=64)
    full = decoder(cfg, "cuda", torch.Generator("cuda").manual_seed(0))
    sd = {k: v.detach() for k, v in full.state_dict().items()}
    tpm = Decoder(cfg, mesh=world1).cuda()
    local = local_shards(sd, world1, DECODER_PARAM_RULES,
                         icp.build_module_table(full))
    toks = torch.randint(0, 256, (4, 32), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    pol = e4m3_inference_policy()
    before = cast_kernel.launches
    with torch.no_grad():
        got = icp.quantized_apply(tpm, pol, toks, params=local, mesh=world1)
        launched = cast_kernel.launches - before
        want = icp.quantized_apply(full, pol, toks, params=sd)
    assert launched > 0
    assert torch.equal(got, want)


def test_tp_engines_on_the_card_match_the_unsharded_ones(world1):
    """The ring engine and the self-draft paged engine (K4's page walk)
    over a one-rank mesh: K3, K4 and K6 launched, the unsharded engines'
    tokens and speculation counts."""
    import dataclasses
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.serve import (Request, ServeConfig, ServingEngine,
                                    random_serve_params)
    cfg = tiny_config(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab_size=128, max_seq_len=64)
    scfg = ServeConfig(model=cfg, kv_fmt="int8")
    kcfg = dataclasses.replace(scfg, paged_decode_impl="kernel")
    params = random_serve_params(cfg, "e4m3")
    reqs = lambda: [Request(uid=i, prompt=[3 + i, 5, 8], max_new_tokens=6)
                    for i in range(3)]
    counts = lambda: (qmatmul.dequant_launches, k4.launches,
                      inplace.launches)
    for c, kw in ((scfg, {}), (kcfg, dict(use_paged=True, page_size=16,
                                          draft_params=params, draft_cfg=kcfg,
                                          k_spec=3))):
        before = counts()
        eng = ServingEngine(params, c, n_slots=2, max_seq=64, mesh=world1,
                            **kw)
        got = eng.run(reqs())
        k3, k4n, k6 = (b - a for a, b in zip(before, counts()))
        ref = ServingEngine(params, c, n_slots=2, max_seq=64, **kw)
        assert got == ref.run(reqs())
        assert k3 > 0 and (k4n > 0 if kw else k6 > 0)
        if kw:
            assert (eng.spec_accepted, eng.spec_drafted) == \
                (ref.spec_accepted, ref.spec_drafted)


@pytest.mark.parametrize("split", [4, 8])
def test_k3_and_k4_at_the_serve_cell_shard_shapes(cuda, split):
    """K3 at a model-4 / model-8 split of the serve cell: a gate column
    shard (bf16 out) and a down row shard (f32 out, unit scales, as the
    row-parallel linear runs it) at decode M = 8; K4 on 8 / split KV heads.
    Each against its plain version."""
    from fp8tpu_torch.kernels import paged_attention as k4
    g = torch.Generator().manual_seed(split)
    x = torch.randn(8, 4096, generator=g).to(torch.bfloat16).to(cuda)
    w8, s = qmatmul.quantize_weights(
        (torch.randn(4096, 11008 // split, generator=g) * 0.02).to(cuda),
        "e4m3")
    s = s.reshape(-1)
    got = qmatmul.dequant_matmul(x, w8, s)
    want = qmatmul.dequant_matmul_plain(x, w8, s)
    assert bool(((got.float() - want.float()).abs()
                 <= _product_bound(x, w8.float().abs(), s[None],
                                   want)).all())
    h = torch.randn(8, 11008 // split, generator=g).to(torch.bfloat16
                                                         ).to(cuda)
    d8, _ = qmatmul.quantize_weights(
        (torch.randn(11008 // split, 4096, generator=g) * 0.02).to(cuda),
        "e4m3")
    ones = torch.ones(4096, device=cuda)
    got = qmatmul.dequant_matmul(h, d8, ones, torch.float32)
    want = qmatmul.dequant_matmul_plain(h, d8, ones, torch.float32)
    assert bool(((got - want).abs()
                 <= _product_bound(h, d8.float().abs(), ones[None],
                                   want)).all())
    kv, G, D, page, mp = 8 // split, 4, 128, 64, 8
    pool = torch.randint(-127, 128, (8 * mp, 2, 1, page * kv, D),
                         generator=g, dtype=torch.int8).to(cuda)
    sc = (torch.rand(pool.shape[:-1], generator=g) * 0.02 + 0.004).to(cuda)
    q = (torch.randn(8, kv * G, D, generator=g) * 0.7).to(
        torch.bfloat16).to(cuda)
    table = torch.arange(8 * mp, dtype=torch.int32, device=cuda
                         ).reshape(8, mp)
    lens = torch.full((8,), 444, dtype=torch.int32, device=cuda)
    args = (q, pool, sc, table, lens, 0)
    acc, m, l = k4.paged_decode_attention(*args, page_size=page,
                                          kv_heads=kv)
    acc_p, m_p, l_p = k4.paged_decode_attention_plain(*args, page_size=page,
                                                      kv_heads=kv)
    assert float((m - m_p).abs().max()) <= 1e-3 * float(m_p.abs().max())
    assert float((l - l_p).abs().max()) <= 1e-3 * float(l_p.abs().max())
    assert float((acc - acc_p).abs().max()) <= 2e-2 * float(
        acc_p.abs().max())


# -- the model-parallel training step (ROADMAP 7c) ----------------------------

@pytest.mark.parametrize("case", ["column", "seq", "odd", "contiguous"])
def test_k1_block_route_matches_plain(cuda, case):
    """K1's block route (SR bits hashed at each element's global index,
    computed in the kernel from the block's runs) against its plain
    version, bit for bit: a column block, an uneven seq chunk, a block of
    odd extents (the scalar path), and a contiguous block, which is also
    the salt_at route's cast."""
    from fp8tpu_torch.parallel.data import Block
    shape, blk = {
        "column": ((64, 24), Block((64, 96), (0, 48))),
        "seq": ((2, 7, 12), Block((2, 15, 12), (0, 8, 0))),
        "odd": ((3, 5), Block((6, 17), (3, 5))),
        "contiguous": ((2, 15, 12), Block((4, 15, 12), (2, 0, 0)))}[case]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)) * 4
    sr = RoundMode.STOCHASTIC
    before = cast_kernel.block_launches
    got = cast_kernel.cuda_qdq(x.to(cuda), "e5m2", sr, 2.0, salt=1234,
                               block=blk)
    assert cast_kernel.block_launches == before + 1
    want = tcast.qdq_plain(x, "e5m2", sr, 2.0, salt=1234, block=blk)
    assert np.array_equal(_bits(got), _bits(want))
    if case == "contiguous":
        off = blk.contiguous_offset(shape)
        today = cast_kernel.cuda_qdq(x.to(cuda), "e5m2", sr, 2.0,
                                     salt=tcast.salt_at(1234, off))
        assert np.array_equal(_bits(got), _bits(today))


@pytest.mark.parametrize("impl", ["bitexact", "hw"])
@pytest.mark.parametrize("case", ["column", "seq", "odd"])
def test_k2_block_route_matches_plain(cuda, case, impl):
    """K2's pre-pass block route (a stochastic operand that is a block of a
    split tensor: SR bits at each element's global index) through an
    identity, bit for bit against its plain version on the CPU and against
    the block of the whole operand's K2 call."""
    from fp8tpu_torch.parallel.data import Block
    (h, w), blk = {"column": ((64, 24), Block((64, 96), (0, 48))),
                   "seq": ((7, 32), Block((15, 32), (8, 0))),
                   "odd": ((3, 5), Block((6, 17), (3, 5)))}[case]
    whole = torch.randn(blk.shape, generator=torch.Generator().manual_seed(5))
    r0, c0 = blk.start
    x = whole[r0:r0 + h, c0:c0 + w].contiguous()
    sr, rne = RoundMode.STOCHASTIC, RoundMode.RNE
    args = ("e5m2", sr, None, rne, 0.25)
    before = qmatmul.k2_launches["prepass_block"]
    got = qmatmul.qdq_matmul(x.to(cuda), torch.eye(w, device=cuda), *args,
                             seed=77, impl=impl, block_x=blk)
    assert qmatmul.k2_launches["prepass_block"] == before + 1
    want = qmatmul.plain(x, torch.eye(w), *args, seed=77, impl=impl,
                         block_x=blk)
    assert np.array_equal(_bits(got + 0.0), _bits(want + 0.0))
    full = qmatmul.qdq_matmul(whole.to(cuda),
                              torch.eye(blk.shape[1], device=cuda), *args,
                              seed=77, impl=impl)
    assert np.array_equal(_bits(got + 0.0),
                          _bits(full[r0:r0 + h, c0:c0 + w] + 0.0))


def test_p3_split_route_matches_one_pass_p3(cuda):
    """P3's split-block route on the column shards (4) of a (50, 60) leaf
    read through transposed views (blocks of 256 cross the shards; the
    last block is padded), the shards' partial absmax maxed as the
    all-reduce would: parameters, each shard's codes and every block's
    scales bit-equal to one-pass P3 on the whole leaf and to the route's
    plain version on the CPU."""
    from fp8tpu_torch.kernels import adam8
    from fp8tpu_torch.parallel.data import Block
    gen = torch.Generator().manual_seed(4)
    K, N, T = 50, 60, 4
    w, nb = N // T, -(-K * N // 256)
    args = lambda c: adam8.Adam8Args(
        0.9, 0.999, 1e-8, *adam8.bias_corrections(0.9, 0.999, c),
        weight_decay=1e-4, neg_lr=-1e-3)
    p = torch.randn(K, N, generator=gen) * 0.02
    st = [torch.zeros(nb, 256, dtype=torch.int8), torch.zeros(nb),
          torch.zeros(nb, 256, dtype=torch.float8_e4m3fn), torch.zeros(nb)]
    adam8.adam8_update(p, torch.randn(K, N, generator=gen) * 1e-2, *st,
                       args(1), "apply_decay")
    g = torch.randn(K, N, generator=gen) * 1e-2
    ref_p, ref = p.clone(), [t.clone() for t in st]
    adam8.adam8_update(ref_p, g, *ref, args(2), "apply_decay")
    for dev, amax_fn, apply_fn in (
            (cuda, adam8.adam8_split_amax, adam8.adam8_split_apply),
            ("cpu", adam8.adam8_split_amax_plain,
             adam8.adam8_split_apply_plain)):
        leaves = []
        for r in range(T):
            idx = Block((K, N), (0, r * w)).index((K, w))
            pt = p[:, r * w:(r + 1) * w].t().contiguous().to(dev)
            gt = g[:, r * w:(r + 1) * w].t().contiguous().to(dev)
            leaves.append((adam8.SplitLeaf(
                pt.t(), gt.t(), st[0].reshape(-1)[idx].to(dev),
                st[1].clone().to(dev), st[2].reshape(-1)[idx].to(dev),
                st[3].clone().to(dev), 0, r * w, N, "apply_decay"), idx))
        amax = torch.zeros((2, nb), dtype=torch.int32, device=dev)
        for lf, _ in leaves:
            part = torch.zeros_like(amax)
            amax_fn(lf, args(2), part)
            amax = torch.maximum(amax, part)
        for r, (lf, idx) in enumerate(leaves):
            apply_fn(lf, args(2), amax)
            for a, b in zip([lf.p, lf.mq, lf.ms, lf.vq, lf.vs],
                            [ref_p[:, r * w:(r + 1) * w],
                             ref[0].reshape(-1)[idx], ref[1],
                             ref[2].reshape(-1)[idx], ref[3]]):
                assert torch.equal(a.cpu().contiguous().view(torch.uint8),
                                   b.contiguous().view(torch.uint8))


def test_one_rank_model_parallel_step_matches_the_plain_step(world1):
    """``train_fp8``'s step (hybrid-gemm, fp16 master, 8-bit AdamW, e4m3
    embedding) over a data 1 x seq 1 x model 1 mesh, 2 steps of the tiny
    decoder: parameters, moment bytes, losses and loss scales bit-equal to
    the plain step's (a group of one holds every product whole); K1 and P3
    launched."""
    from fp8tpu_torch.kernels import adam8
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.parallel import make_mesh
    from fp8tpu_torch.tools.bench_tp import lm_tokens, run_steps, trainer
    from fp8tpu_torch.training.mpt import lm_batch
    cfg = tiny_config(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab_size=256, max_seq_len=64)
    mesh = make_mesh(data=1, seq=1, model=1)
    toks = [lm_tokens(cfg, 4, i, "cuda") for i in range(2)]
    runs = []
    for m in (mesh, None):
        _, params, opt, step, state = trainer(cfg, torch.device("cuda"), m)
        k1, p3 = cast_kernel.launches, adam8.launches
        params, state, losses, _ = run_steps(
            step, params, state, [lm_batch(t, m) for t in toks],
            prng.key(1), torch.cuda.synchronize)
        assert cast_kernel.launches > k1 and adam8.launches == p3 + 2
        runs.append((params, opt, state, losses))
    (pm, om, sm, lm), (pp, op, sp, lp) = runs
    assert lm == lp and sm[1] == sp[1]
    for n in pp:
        assert torch.equal(pm[n].detach().view(torch.int32),
                           pp[n].detach().view(torch.int32)), n
        for w in ("m", "v"):
            for a, b in zip(om.state[pm[n]][w], op.state[pp[n]][w]):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
