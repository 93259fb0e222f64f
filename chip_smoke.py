#!/usr/bin/env python3
"""Drive the fp8tpu_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--phases build,k1,k2,main,time]

Phases, each printing its own lines; any failure exits non-zero:

1. build  nvcc builds every kernel from ``fp8tpu_torch/kernels/csrc``, one
          process per source, in parallel; prints seconds and registers.
2. k1     the cast kernel (K1) against its plain torch version (on the
          CPU), bit-exact,
          over every format x mode x DAZ of the mode-string ABI, scalar /
          per-channel / broadcast / per-block scales, the golden boundary
          vector, f32 subnormals, and SR from explicit bits and from a salt;
          then scalar, per-channel, per-block and SR casts of a tensor
          large enough that each thread of the capped grid loops three times.
3. k2     the fused fake-quant GEMM (K2) against its plain version at
          ResNet-50 conv shapes, within the f32 summation-order bound.
4. main   ResNet-50 (full width, 1000 classes, random weights from a
          seed), batch 32 at 224x224: BN statistics from 2 train-mode
          passes, then quantize_model(e4m3, hw patching, BN folding,
          2 calibration batches, conv1/fc exempt), 1 warm-up and 3 timed
          quantized batches.  Launch counts per forward, logits against
          fp32 (correlation > 0.95), quantized weights bit-equal to the
          CPU path's, and a torch.profiler breakdown of one forward.
5. time   each kernel at the main path's shapes: kernel, plain version,
          bound, and a PyTorch yardstick where one exists; K1 bit-exact
          at the largest residual_add operand.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Details go to the JSON
file that ``--out`` names (default ``chip_smoke_out/chip_smoke.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BATCH = 32                     # images per batch on the main path
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_SIMT_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores

BOUNDARY = [
    0.0, -0.0, 1.0, -1.0, 57344.0, -57344.0, 61440.0, -61440.0,
    65504.0, -65504.0, 448.0, -448.0, 480.0, -480.0, 449.0,
    240.0, -240.0, 30.0, -30.0, 31.0, -31.0, 2.0 ** -16, -(2.0 ** -16),
    2.0 ** -9, 2.0 ** -6, 2.0 ** -2, 1.5e-5, 1.9e-3, 1.5e-2,
    0.1, -0.1, 3.14159, -2.71828, 1e6, -1e6, 1e-8, -1e-8,
    float("inf"), float("-inf"), float("nan"),
]
SUBNORMALS = [1e-40, -1e-40, 1e-39, -3e-39, 1.1e-38, 2.0 ** -149]

MODE_STRINGS = (
    [f"E5M2_{m}" for m in ("RTZ", "STOCHASTIC", "RNE", "RNAZ", "RNTZ",
                           "RPINF", "RNINF")]
    + [f"E5M2_DAZ_{m}" for m in ("STOCHASTIC", "RNE", "RNAZ", "RNTZ",
                                 "RPINF", "RNINF", "RTZ")]
    + [f"{f}_{m}" for f in ("E4M3", "E4M3_IEEE", "E3M4")
       for m in ("RNE", "STOCHASTIC", "RNAZ", "RNTZ", "RPINF", "RNINF",
                 "RTZ")]
    + [f"E4M3_V2_{m}" for m in ("RNE", "STOCHASTIC", "RNAZ", "RNTZ",
                                "RPINF", "RNINF", "RTZ")]
    + ["FP4_NEAREST", "BFLOAT16_RNE", "BFLOAT16_STOCHASTIC", "FLOAT16_RNE",
       "FLOAT16_STOCHASTIC", "FLOAT16_DAZ_RNE", "E5M2_NOINF_RNE",
       "E5M2_FLEX_RNE"]
)

def resnet50_conv_gemms(batch: int):
    """(M, K, N) of the 52 patched convs of one ResNet-50 forward (the
    stem conv is exempt), in order."""
    shapes, in_f, hw = [], 64, 56
    for stage, (blocks, f) in enumerate(zip((3, 4, 6, 3),
                                            (64, 128, 256, 512))):
        for b in range(blocks):
            out = hw // (2 if stage > 0 and b == 0 else 1)
            shapes += [(batch * hw * hw, in_f, f),
                       (batch * out * out, f * 9, f),
                       (batch * out * out, f, 4 * f)]
            if b == 0:
                shapes.append((batch * out * out, in_f, 4 * f))
            in_f, hw = 4 * f, out
    return shapes


# Representative ResNet-50 conv GEMMs (batch 32): (name, M, K, N).
K2_SHAPES = [
    ("stage0 3x3", BATCH * 56 * 56, 64 * 9, 64),
    ("stage0 1x1 expand", BATCH * 56 * 56, 64, 256),
    ("stage3 1x1", BATCH * 7 * 7, 2048, 512),
    ("stage3 3x3", BATCH * 7 * 7, 512 * 9, 512),
]


class PhaseError(Exception):
    pass


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi gave no output"


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bits_equal(a, b) -> int:
    """Number of elements whose f32 bit patterns differ."""
    import torch
    a = a.to(torch.float32).contiguous().view(torch.int32)
    b = b.to(torch.float32).contiguous().view(torch.int32)
    return int((a != b).sum())


# -- phase 1 ----------------------------------------------------------------

def phase_build(record):
    from fp8tpu_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {name}: {r['seconds']:.1f} s")
        for ln in regs[:4]:
            print(f"  ptxas {ln}")
        record.setdefault("build", {})[name] = r
    print(f"build: all kernels ready in {seconds:.1f} s")


# -- phase 2 ----------------------------------------------------------------

def phase_k1(record):
    import numpy as np
    import torch
    from fp8tpu_torch.kernels import cast_kernel
    from fp8tpu_torch.numerics.cast import qdq_plain
    from fp8tpu_torch.numerics.formats import parse_mode_string, RoundMode

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rand = (rng.standard_normal(4096)
            * np.exp(rng.uniform(-25, 15, 4096))).astype(np.float32)
    x = torch.from_numpy(np.concatenate([
        np.array(BOUNDARY + SUBNORMALS, np.float32), rand])).to(dev)
    rb = torch.from_numpy(rng.integers(0, 65536, x.shape).astype(np.int32)
                          ).to(dev)

    def variant(ms):
        ml = ms.lower()
        if ml in ("e5m2_noinf_rne", "e5m2_flex_rne"):
            return ml[:-4], RoundMode.RNE, False
        if ml.startswith("e4m3_v2_"):
            return "e4m3_v2", RoundMode[ml[8:].upper()], False
        fmt, mode, daz = parse_mode_string(ms)
        return fmt.name, mode, daz

    cases = mismatches = 0
    failures = []

    def check(label, xx, fmt, mode, daz, **kw):
        # The plain version runs on the CPU: it is the one the tests hold
        # against the JAX package, NaN payloads included.
        nonlocal cases, mismatches
        got = cast_kernel.cuda_qdq(xx, fmt, mode, daz=daz, **kw)
        want = qdq_plain(xx.cpu(), fmt, mode, daz=daz,
                         **{k: v.cpu() if torch.is_tensor(v) else v
                            for k, v in kw.items()})
        got = got.cpu()
        bad = bits_equal(got, want)
        cases += 1
        if bad:
            mismatches += bad
            failures.append(f"{label}: {bad} elements differ")

    for ms in MODE_STRINGS:
        fmt, mode, daz = variant(ms)
        sr = mode == RoundMode.STOCHASTIC
        bits = [dict(random_bits=rb), dict(salt=0x9E3779B9)] if sr \
            else [dict()]
        for scale in (1.0, 3.7, 1e-3, 6.55e4, 1e36):
            for b in bits:
                check(f"{ms} scale={scale} {list(b)}", x, fmt, mode, daz,
                      scale=torch.tensor(scale, device=dev), **b)
        x2 = x[:4096].reshape(16, 16, 16)
        per_axis = {
            "axis0": torch.linspace(0.5, 40.0, 16, device=dev).reshape(16, 1, 1),
            "axis1": torch.linspace(0.5, 40.0, 16, device=dev).reshape(1, 16, 1),
            "axis2": torch.linspace(0.5, 40.0, 16, device=dev),
            "axes0,2": torch.linspace(0.5, 40.0, 256, device=dev).reshape(16, 1, 16),
        }
        for label, s in per_axis.items():
            check(f"{ms} {label}", x2, fmt, mode, daz, scale=s,
                  **({"salt": 7} if sr else {}))
        if fmt in ("e5m2", "e4m3", "e4m3_ieee", "e3m4", "fp4"):
            for bs in (128, 32, 100):
                for b in bits:
                    check(f"{ms} block={bs} {list(b)}", x[:4000], fmt, mode,
                          daz, block_size=bs,
                          **({k: (v[:4000] if torch.is_tensor(v) else v)
                              for k, v in b.items()}))

    # Past the grid's cap of 64 blocks of 256 threads per SM, so that every
    # thread's grid-stride loop (and every warp's block loop) takes three
    # passes.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_big = 3 * 64 * 256 * sms
    g = torch.Generator(device=dev).manual_seed(3)
    big = torch.randn(n_big // 256, 256, device=dev, generator=g) * torch.exp(
        torch.empty(n_big // 256, 256, device=dev).uniform_(-20, 12,
                                                             generator=g))
    big_rb = torch.randint(0, 65536, big.shape, device=dev, generator=g,
                           dtype=torch.int32)
    s37 = torch.tensor(3.7, device=dev)
    for label, fmt, mode, kw in (
            ("scalar", "e4m3", RoundMode.RNE, dict(scale=s37)),
            ("scalar SR bits", "e4m3", RoundMode.STOCHASTIC,
             dict(scale=s37, random_bits=big_rb)),
            ("scalar SR salt", "e5m2", RoundMode.STOCHASTIC,
             dict(scale=s37, salt=0x9E3779B9)),
            ("per-channel", "e4m3", RoundMode.RNE,
             dict(scale=torch.linspace(0.5, 40.0, 256, device=dev))),
            ("block=32", "e4m3", RoundMode.RNE, dict(block_size=32))):
        check(f"{n_big} elements {fmt} {label}", big, fmt, mode, False, **kw)
    record["k1"] = {"cases": cases, "mismatched_elements": mismatches,
                    "failures": failures[:50]}
    print(f"k1: {cases} cases over {len(MODE_STRINGS)} mode strings, "
          f"{mismatches} mismatched elements (bit-exact required)")
    if failures:
        for f in failures[:10]:
            print(f"  k1 FAIL {f}")
        raise PhaseError("K1 disagrees with its plain version")


# -- phase 3 ----------------------------------------------------------------

def k2_tolerance(xq, wq):
    """Summation-order bound for f32 dot products of length K: both sums
    carry at most K*2^-24 relative error of sum|x_i w_i|."""
    import torch
    from fp8tpu_torch._device import full_fp32
    k = xq.shape[1]
    with full_fp32():
        mag = torch.matmul(xq.abs(), wq.abs())
    return 2.0 * k * 2.0 ** -24 * mag + 1e-30


def phase_k2(record):
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.cast import cast_array
    from fp8tpu_torch.numerics.formats import RoundMode

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    # The main path's variants at its shapes, then the runtime-selected
    # variants (any other format pair) at a ragged shape.
    variants = [("e4m3", None), ("e4m3", "e4m3")]
    cases = [(s, fx, fw) for s in K2_SHAPES for fx, fw in variants]
    cases += [(("ragged", 1000, 100, 70), fx, fw) for fx, fw in
              variants + [("e5m2", None), ("e3m4", "e3m4"), ("fp4", "e4m3"),
                          ("bfloat16", "float16"), (None, "e5m2"),
                          (None, None)]]
    rne = RoundMode.RNE
    for (name, m, k, n), fmt_x, fmt_w in cases:
        x = torch.randn(m, k, device="cuda", generator=gen).relu_()
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        sx = 0.5 / x.abs().amax() if fmt_x == "fp4" else 448.0 / x.abs().amax()
        sw = 448.0 / w.abs().amax(0)
        got = qmatmul.qdq_matmul(x, w, fmt_x, rne, fmt_w, rne, sx, sw)
        want = qmatmul.plain(x, w, fmt_x, rne, fmt_w, rne, sx, sw)
        xq = x if fmt_x is None else cast_array(x, sx, None, fmt_x, rne)
        wq = w if fmt_w is None else cast_array(w, sw.reshape(1, -1), None,
                                                fmt_w, rne)
        tol = k2_tolerance(xq, wq)
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
        rows.append({"shape": name, "m": m, "k": k, "n": n, "fmt_x": fmt_x,
                     "fmt_w": fmt_w, "max_abs_err": float(err.max()),
                     "max_err_over_bound": float((err / tol).max()),
                     "ok": ok})
        print(f"k2 {name} M={m} K={k} N={n} x={fmt_x} w={fmt_w}: max|err| "
              f"{float(err.max()):.3e}, max err/bound "
              f"{float((err / tol).max()):.3e} -> {'ok' if ok else 'FAIL'}")
    record["k2"] = rows
    if not all(r["ok"] for r in rows):
        raise PhaseError("K2 disagrees with its plain version beyond the "
                         "summation-order bound")


# -- phase 4 ----------------------------------------------------------------

def phase_main(record, batch: int):
    import torch
    import fp8tpu_torch as ft
    from fp8tpu_torch.kernels import cast_kernel, qmatmul
    from fp8tpu_torch.models import RESNET_EXEMPT, resnet50
    from fp8tpu_torch.ops.scale_shift import fold_batchnorm
    from fp8tpu_torch.quant.interceptor import quantize_params

    gen = torch.Generator().manual_seed(0)
    cgen = torch.Generator(device="cuda").manual_seed(0)
    model = resnet50(device="cuda", generator=gen)
    inf_model = resnet50(device="cuda", norm_mode="scale_shift")
    batches = [torch.randn(batch, 3, 224, 224, device="cuda", generator=cgen)
               for _ in range(3)]
    calib, x = batches[:2], batches[2]
    with torch.no_grad():
        model.train()
        for b in calib:
            model(b)
        model.eval()
        ref = model(x)
    policy = ft.get_policy("e4m3").with_hw_patching()

    cast_kernel.reset_launches()
    qmatmul.reset_launches()
    t0 = time.perf_counter()
    qm = ft.quantize_model(model, (x,), dtype="e4m3", policy=policy,
                           fuse_bn=True, inference_model=inf_model,
                           calibration_batches=calib,
                           list_exempt_layers=RESNET_EXEMPT)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    with torch.no_grad():
        k1_0, k2_0 = cast_kernel.launches, qmatmul.launches
        out = qm(x)                                # warm-up
        torch.cuda.synchronize()
        per_fwd = {"cast_kernel": cast_kernel.launches - k1_0,
                   "qdq_matmul": qmatmul.launches - k2_0}
        times = []
        for _ in range(3):
            t = time.perf_counter()
            out = qm(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    launches = {"cast_kernel": cast_kernel.launches,
                "qdq_matmul": qmatmul.launches}
    ms = 1000.0 * sum(times) / len(times)
    record["profile"] = profile_forward(qm, x, ms)
    print(f"main: ResNet-50 e4m3 hw-patched PTQ, batch {batch}, 224x224: "
          f"quantize_model {quantize_s:.2f} s, {ms:.2f} ms/batch, "
          f"{batch / (ms / 1000.0):.1f} images/s "
          f"(batches: {', '.join(f'{1000 * t:.2f}' for t in times)} ms)")
    print(f"main: launches per forward {per_fwd}; in the whole run "
          f"{launches}")

    finite = bool(torch.isfinite(out).all())
    corr = float(torch.corrcoef(torch.stack(
        [out.flatten().double(), ref.flatten().double()]))[0, 1])
    agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"main: logits {tuple(out.shape)} finite={finite}, corr vs fp32 "
          f"{corr:.5f}, top-1 agreement {agree:.3f}")

    # The quantized weights (K1 on the card) against the CPU path's (plain
    # casts, held against the JAX package by the tests): bit-equal.
    host = fold_batchnorm({k: v.detach().cpu()
                           for k, v in model.state_dict().items()})
    host_q = quantize_params(host, qm.policy, qm.module_table)
    w_diff = sum(bits_equal(host_q[k], qm.variables[k].cpu()) for k in host_q)
    print(f"main: quantized weights, card vs CPU path: {w_diff} elements "
          f"differ (bit-exact required)")

    record["main"] = {
        "batch": batch, "ms_per_batch": ms, "images_per_s": batch / (ms / 1e3),
        "batch_ms": [1000 * t for t in times], "quantize_model_s": quantize_s,
        "launches_per_forward": per_fwd, "launches": launches,
        "corr_vs_fp32": corr, "top1_agreement": agree, "finite": finite,
        "weight_mismatches": w_diff,
    }
    problems = []
    if tuple(out.shape) != (batch, 1000) or not finite:
        problems.append("logits not finite or of the wrong shape")
    if corr <= 0.95:
        problems.append(f"correlation {corr} <= 0.95")
    if per_fwd["qdq_matmul"] != 52:
        problems.append(f"{per_fwd['qdq_matmul']} K2 launches per forward, "
                        "expected 52")
    if per_fwd["cast_kernel"] != 32:
        problems.append(f"{per_fwd['cast_kernel']} K1 launches per forward, "
                        "expected 32")
    if not all(launches.values()):
        problems.append(f"a kernel was not launched: {launches}")
    if w_diff:
        problems.append("quantized weights differ between card and CPU")
    if problems:
        raise PhaseError("; ".join(problems))
    return launches


def profile_forward(qm, x, forward_ms: float):
    """Device time of one quantized forward by kernel, from torch.profiler;
    fails if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as p:
        qm(x)
        torch.cuda.synchronize()
    by_name = {}
    for e in p.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None) or e.cuda_time
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + us / 1000.0, n + 1)
    rows = sorted(((t, n, k) for k, (t, n) in by_name.items()), reverse=True)
    busy = sum(t for t, _, _ in rows)
    if not busy > 0:
        raise PhaseError("torch.profiler recorded no device time")
    print(f"profile: one forward, {busy:.2f} ms of kernels on the device "
          f"against {forward_ms:.2f} ms per batch (busy share "
          f"{busy / forward_ms:.3f}); top kernels:")
    for t, n, k in rows[:8]:
        print(f"  {t:8.3f} ms {n:4d}x  {k[:90]}")
    return {"device_ms": busy, "forward_ms": forward_ms,
            "kernels": [{"name": k, "ms": t, "count": n}
                        for t, n, k in rows]}


# -- phase 5 ----------------------------------------------------------------

def phase_time(record, batch: int, launches):
    import torch
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.kernels import cast_kernel, qmatmul
    from fp8tpu_torch.numerics.cast import cast_array, qdq_plain
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.numerics.scaling import per_tensor

    gen = torch.Generator(device="cuda").manual_seed(2)
    kernels = []

    # K1 at the largest residual_add operand, (batch, 256, 56, 56), held
    # bit-exact against the plain version on the CPU.
    x = torch.randn(batch, 256, 56, 56, device="cuda", generator=gen)
    s = per_tensor(x, "e4m3")
    want = qdq_plain(x.cpu(), "e4m3", RoundMode.RNE, s.cpu())
    got = cast_kernel.cuda_qdq(x, "e4m3", RoundMode.RNE, s).cpu()
    k1_bad = bits_equal(got, want)
    k1_err = float((got - want).abs().max())
    if k1_bad:
        raise PhaseError(f"K1 at {tuple(x.shape)}: {k1_bad} elements differ "
                         "from the plain version")
    k1_ms = cuda_ms(lambda: cast_kernel.cuda_qdq(x, "e4m3", RoundMode.RNE, s))
    k1_plain = cuda_ms(lambda: qdq_plain(x, "e4m3", RoundMode.RNE, s),
                       iters=3, warmup=1)
    k1_bound = 8.0 * x.numel() / HBM_BYTES_PER_S * 1e3
    print(f"time k1 cast e4m3 per-tensor {tuple(x.shape)}: kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain:.4f} ms, bound {k1_bound:.4f} ms "
          f"(bytes), no PyTorch call computes this bit-exact cast")
    kernels.append({
        "name": "cast_kernel", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/cast_kernel.cu",
        "replaces": "fp8tpu/kernels/cast_kernel.py:45",
        "launches": launches["cast_kernel"], "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
        "bound_by": "bytes", "library_ms": None,
    })

    rows = []
    for name, m, k, n in K2_SHAPES:
        xx = torch.randn(m, k, device="cuda", generator=gen).relu_()
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        sx = per_tensor(xx, "e4m3")

        def kern():
            return qmatmul.qdq_matmul(xx, w, "e4m3", RoundMode.RNE, None,
                                      RoundMode.RNE, sx)

        def plain():
            return qmatmul.plain(xx, w, "e4m3", RoundMode.RNE, None,
                                 RoundMode.RNE, sx)

        xq = cast_array(xx, sx, None, "e4m3", RoundMode.RNE)

        def library():
            with full_fp32():
                return torch.matmul(xq, w)

        err = float((kern() - plain()).abs().max())
        t_k = cuda_ms(kern, iters=5)
        t_p = cuda_ms(plain, iters=3, warmup=1)
        t_l = cuda_ms(library, iters=5)
        t_bytes = 4.0 * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * m * n * k / F32_SIMT_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        rows.append({"shape": name, "m": m, "k": k, "n": n, "ms": t_k,
                     "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "max_abs_err": err,
                     "tflops": 2.0 * m * n * k / t_k / 1e9})
        print(f"time k2 {name} M={m} K={k} N={n}: kernel {t_k:.4f} ms "
              f"({2.0 * m * n * k / t_k / 1e9:.2f} TFLOP/s), plain "
              f"{t_p:.4f} ms, bound {bound:.4f} ms, f32 torch.matmul on the "
              f"cast operands (yardstick of the contraction alone) "
              f"{t_l:.4f} ms")
    # K2 over all 52 patched convs of one forward, kernel time only.
    shapes = resnet50_conv_gemms(batch)
    total = 0.0
    for m, k, n in shapes:
        xx = torch.randn(m, k, device="cuda", generator=gen).relu_()
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        sx = per_tensor(xx, "e4m3")
        total += cuda_ms(lambda: qmatmul.qdq_matmul(
            xx, w, "e4m3", RoundMode.RNE, None, RoundMode.RNE, sx), iters=5)
    flops = sum(2.0 * m * n * k for m, k, n in shapes)
    print(f"time k2 all {len(shapes)} convs of one forward: {total:.3f} ms "
          f"({flops / total / 1e9:.2f} TFLOP/s; f32 bound "
          f"{flops / F32_SIMT_FLOPS * 1e3:.3f} ms)")
    record["time"] = {"k2_shapes": rows, "k2_forward_ms": total,
                      "k2_forward_bound_ms": flops / F32_SIMT_FLOPS * 1e3}
    head = rows[0]
    kernels.append({
        "name": "qdq_matmul", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/qmatmul.cu",
        "replaces": "fp8tpu/kernels/qmatmul.py:193",
        "launches": launches["qdq_matmul"], "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    })
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,k1,k2,main,time")
    ap.add_argument("--out", default="chip_smoke_out/chip_smoke.json")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import fp8tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the fp8tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    record = {"card": card, "phases": {}}
    launches = None
    kernels = []
    ok = True
    for phase in phases:
        t0 = time.perf_counter()
        try:
            if phase == "build":
                phase_build(record)
            elif phase == "k1":
                phase_k1(record)
            elif phase == "k2":
                phase_k2(record)
            elif phase == "main":
                launches = phase_main(record, BATCH)
            elif phase == "time":
                if launches is None:
                    raise PhaseError("the time phase needs the main phase")
                kernels = phase_time(record, BATCH, launches)
            else:
                raise PhaseError(f"unknown phase {phase!r}")
            status = "ok"
        except Exception as e:  # report every phase, then fail the run
            import traceback
            traceback.print_exc()
            status = f"FAIL: {type(e).__name__}: {e}"
            ok = False
        seconds = time.perf_counter() - t0
        record["phases"][phase] = {"status": status, "seconds": seconds}
        print(f"phase {phase}: {status} ({seconds:.1f} s)", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=str)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    if kernels:
        print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
