"""The prefill route of the weight GEMMs K3 and K5 (``fp8tpu_torch/kernels/
csrc/w_stream.cuh::launch_prefill``, M > 64) on the CPU: which kernel a
shape takes (``qmatmul.weight_gemm_plan``), the route's split of K
(``qmatmul.prefill_plan``) and its promoted chunks, and a torch twin of
its order of work held against the plain versions and the Pallas kernels
in interpret mode.  The kernel itself runs only on the card
(chip_smoke.py's k3 and k5 phases, tests/test_torch_gpu.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fp8tpu.kernels.int4_matmul import int4_matmul as j_int4_matmul
from fp8tpu.kernels.qmatmul import dequant_matmul as j_dequant_matmul
from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.kernels import int4_matmul, qmatmul

# (K, N) of the serving linears at full width: q/o, k/v, gate/up, down.
SERVE_KN = [(4096, 4096), (4096, 1024), (4096, 11008), (11008, 4096)]
PREFILL_MS = (65, 100, 128, 256, 512, 700, 2048, 4096)
SMS = (132, 114)                 # H100 SXM and PCIe


def _buf(nbytes: int, offset: int = 0) -> torch.Tensor:
    """A stand-in operand: the plan reads only its pointer's alignment."""
    return torch.empty(nbytes + 16, dtype=torch.uint8)[offset:offset + nbytes]


# (M, K, N, kind, group, misaligned operand) -> route
ROUTES = [
    (1, 4096, 4096, "w8", None, None, "stream"),
    (64, 4096, 11008, "w8", None, None, "stream"),
    (65, 4096, 11008, "w8", None, None, "prefill"),
    (512, 4096, 1024, "w8", None, None, "prefill"),
    (2048, 11008, 4096, "w8", None, None, "prefill"),
    (100, 4096, 4096, "int4", 128, None, "prefill"),
    (700, 4096, 1024, "int4", None, None, "prefill"),
    (100, 1001, 331, "w8", None, None, "general"),         # K % 8, N % 16
    (512, 4096, 1000, "w8", None, None, "general"),        # N % 16
    (512, 4092, 1024, "w8", None, None, "general"),        # K % 8
    (512, 4096, 1024, "int4", 48, None, "general"),        # the group
    (512, 4096, 1024, "w8", None, 0, "general"),           # x 8 bytes off
    (512, 4096, 1024, "w8", None, 1, "general"),           # w 8 bytes off
    (64, 4096, 1024, "int4", 128, 2, "general"),           # scales too
]


@pytest.mark.parametrize("m,k,n,kind,group,bad,route", ROUTES)
def test_weight_gemm_route(m, k, n, kind, group, bad, route):
    ops = [_buf(64, 8 if i == bad else 0) for i in range(3)]
    plan = qmatmul.weight_gemm_plan(m, n, k, 132, kind, *ops, group=group)
    assert plan.route == route
    if route == "stream":
        assert plan.code == qmatmul.stream_mt(n, 132) in (1, 2)
    else:
        assert plan.code == (qmatmul.PREFILL_ROUTE if route == "prefill"
                             else 0)
    assert (plan.route == "stream") == qmatmul.streams(m, n, k, *ops,
                                                       group=group)
    assert (plan.route == "prefill") == qmatmul.prefills(m, n, k, *ops,
                                                         group=group)


@pytest.mark.parametrize("kind", ["w8", "int4"])
@pytest.mark.parametrize("k,n", SERVE_KN + [(512, 256), (640, 272)],
                         ids=lambda v: str(v))
def test_prefill_plan_covers_every_k_row_once(k, n, kind):
    bk = qmatmul.STREAM_BK[kind]
    for sms in SMS:
        for m in PREFILL_MS:
            plan = qmatmul.prefill_plan(m, n, k, sms, kind)
            assert plan.np == qmatmul.PREFILL_NP and plan.bk == bk
            assert 1 <= plan.splits <= 8
            tiles = -(-m // plan.np) * -(-n // qmatmul.PREFILL_COLS)
            if plan.splits > 1:
                # splits only where the tiles leave SMs idle, and never
                # more tiles than tile counters
                assert tiles < sms and tiles <= 4096
            assert plan.kper % bk == 0                    # whole stages
            rows = np.zeros(k, dtype=np.int64)
            for z in range(plan.splits):
                rows[z * plan.kper:min(k, (z + 1) * plan.kper)] += 1
            assert (rows == 1).all(), (m, sms)
            assert (plan.splits - 1) * plan.kper < k
            edges = qmatmul.promotion_edges(k, plan.kper)
            assert edges[0] == 0 and edges[-1] == k
            assert all(0 < b - a <= qmatmul.STREAM_PROMOTE
                       for a, b in zip(edges, edges[1:]))


# (M, N, K) -> splits on 132 SMs: k/v at M = 512 is 32 tiles, 4 ways
# (128 blocks); gate at M = 128 is 86 tiles, 3 ways (2 waves of a third of
# K rather than 1 of all of it); outputs of at least 132 tiles never split.
SPLITS = [
    (512, 1024, 4096, 4), (128, 11008, 4096, 3), (128, 1024, 4096, 8),
    (256, 4096, 4096, 2), (512, 4096, 4096, 1), (512, 11008, 4096, 1),
    (2048, 4096, 11008, 1), (2048, 1024, 4096, 1),
]


@pytest.mark.parametrize("m,n,k,splits", SPLITS)
def test_prefill_plan_splits(m, n, k, splits):
    plan = qmatmul.prefill_plan(m, n, k, 132)
    assert plan.splits == splits
    assert plan.kper == -(-k // (splits * 128)) * 128


@pytest.mark.parametrize("m,n,k,edges", [
    (512, 1024, 4096, list(range(0, 4097, 512))),
    (128, 11008, 4096, [0, 512, 1024, 1408, 1920, 2432, 2816, 3328, 3840,
                        4096]),
    (512, 4096, 11008, list(range(0, 11008, 512)) + [11008]),
])
def test_prefill_promotion_edges(m, n, k, edges):
    """The K rows where the route adds a chunk into its f32 sum: every 512
    rows from each split's start (chip_smoke.stream_reference walks the
    same edges)."""
    plan = qmatmul.prefill_plan(m, n, k, 132)
    assert qmatmul.promotion_edges(k, plan.kper) == edges


def prefill_twin(x, wq, col_scale, kper, out_dtype):
    """The prefill route's order of work in torch: each split's K range in
    512-row chunks from its start, each chunk's product in f32 added in
    order into an f32 sum, the splits' sums added in split order, then
    the column scale in f32 and one rounding.  ``wq`` holds the bf16
    weights the kernel multiplies (the converted payload, grouped int4
    scales already applied)."""
    k = x.shape[1]
    xf, wf = x.to(torch.bfloat16).float(), wq.float()
    total = None
    for kb in range(0, k, kper):
        ke = min(k, kb + kper)
        part = torch.zeros(x.shape[0], wq.shape[1])
        for a in range(kb, ke, qmatmul.STREAM_PROMOTE):
            b = min(ke, a + qmatmul.STREAM_PROMOTE)
            with full_fp32():
                part = part + xf[:, a:b] @ wf[a:b]
        total = part if total is None else total + part
    return (total * col_scale.reshape(1, -1).float()).to(out_dtype)


def assert_order_close(got, want, x, wq, col_scale, out_bf16):
    """Two f32 sums of the same exact bf16 x bf16 products in different
    orders differ by at most 2 K 2^-24 sum|x w| (times the scale); a bf16
    result may land one bf16 step (2^-7 relative) away."""
    got, want = got.float(), want.float()
    k = x.shape[1]
    with full_fp32():
        mag = x.to(torch.bfloat16).float().abs() @ wq.float().abs()
    tol = 2.0 * k * 2.0 ** -24 * mag * col_scale.reshape(1, -1).abs() + 1e-30
    if out_bf16:
        tol = tol + 2.0 ** -7 * want.abs()
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


# a ragged token tile; on 8 SMs two splits of 640 rows, four chunks
M_TWIN, K_TWIN, N_TWIN = 96, 1280, 64


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
def test_k3_prefill_twin_matches_plain_and_pallas(rng, fmt, out):
    x = rng.standard_normal((M_TWIN, K_TWIN)).astype(np.float32)
    w = (rng.standard_normal((K_TWIN, N_TWIN)) * 0.05).astype(np.float32)
    w8, s = qmatmul.quantize_weights(torch.from_numpy(w), fmt)
    s = s.reshape(-1)
    out_dtype = torch.float32 if out == "f32" else torch.bfloat16
    plan = qmatmul.prefill_plan(M_TWIN, N_TWIN, K_TWIN, 8)
    assert plan.splits == 2             # 1 tile on 8 SMs: K split in two
    xt = torch.from_numpy(x)
    got = prefill_twin(xt, w8.to(torch.bfloat16), s, plan.kper, out_dtype)
    want = qmatmul.dequant_matmul_plain(xt, w8, s, out_dtype)
    assert_order_close(got, want, xt, w8, s, out == "bf16")
    jw = jnp.asarray(w8.view(torch.uint8).numpy().view(np.dtype(
        {"e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2,
         "int8": jnp.int8}[fmt])))
    pallas = j_dequant_matmul(jnp.asarray(x), jw, jnp.asarray(s.numpy()),
                              out_dtype=jnp.float32 if out == "f32"
                              else jnp.bfloat16, interpret=True)
    assert_order_close(got, torch.from_numpy(np.array(
        pallas.astype(jnp.float32))), xt, w8, s, out == "bf16")


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("group", [None, 128])
def test_k5_prefill_twin_matches_plain_and_pallas(rng, group, out):
    x = rng.standard_normal((M_TWIN, K_TWIN)).astype(np.float32)
    w = (rng.standard_normal((K_TWIN, N_TWIN)) * 0.05).astype(np.float32)
    wp, s = int4_matmul.quantize_weights_int4_grouped(
        torch.from_numpy(w), group or K_TWIN)
    if not group:
        s = s.reshape(-1)
    out_dtype = torch.float32 if out == "f32" else torch.bfloat16
    lo, hi = int4_matmul.unpack_int4(wp)
    wq = torch.stack([lo, hi], 1).reshape(K_TWIN, N_TWIN).to(torch.bfloat16)
    if group:
        wq = wq * s.to(torch.bfloat16).repeat_interleave(group, dim=0)
        col = torch.ones(N_TWIN)
    else:
        col = s
    plan = qmatmul.prefill_plan(M_TWIN, N_TWIN, K_TWIN, 8, "int4")
    xt = torch.from_numpy(x)
    got = prefill_twin(xt, wq, col, plan.kper, out_dtype)
    want = int4_matmul.int4_matmul_plain(xt, wp, s, group, out_dtype)
    assert_order_close(got, want, xt, wq, col, out == "bf16")
    pallas = j_int4_matmul(jnp.asarray(x), jnp.asarray(wp.numpy()),
                           jnp.asarray(s.numpy()), group_size=group,
                           out_dtype=jnp.float32 if out == "f32"
                           else jnp.bfloat16, tn=64, tk2=128, interpret=True)
    assert_order_close(got, torch.from_numpy(np.array(
        pallas.astype(jnp.float32))), xt, wq, col, out == "bf16")
