"""Device times of the weight-streaming GEMMs K3, K5 and T2 at the serving
shapes, for comparing two checkouts of the port on one card.

    python3 fp8tpu_torch/tools/bench_wgemm.py [--tree PATH] [--label NAME]
                                              [--out FILE]

``--tree`` names the checkout whose ``fp8tpu_torch`` is measured (default:
the one this file lies in), so that one call can time a parent commit and
a change in turns (parent, change, change, parent) on the same card: the
kernels' wrappers keep their signatures across the two.  Each time is a
device time (CUDA-graph replay, ``tools.device_ms``) of one call, with the
weights rotating over R copies so that a launch finds them in device
memory, not in the 50 MB L2 (cold): K3 (e4m3) and K5 (int4, groups of
128) at the four full-width serving linears and M = 8 and 64 (decode, the
streaming loop) and 128, 256, 512 and 2048 (prefill); T2's four modes at
its tool's shape (M = 64, 4096 x 11008), a time per rep.  Each K3 / K5
row has its bound (the larger of its bytes over 3.35 TB/s and 2 M N K
over the bf16 tensor-core rate, 989 TFLOP/s) and two PyTorch yardsticks,
used nowhere in the port: the weight converted in the call and scaled
(``(x @ w.to(bf16)) * s``, K3 only) and ``x @ wb`` with the bf16 weight
converted beforehand.  Then one paged prefill of 8 prompts of 256 tokens
(``prefill_batch_paged`` of the full-width serving decoder, random e4m3
weights from a seed, 2048 rows a linear, 112 K3 launches) and the same
with the bf16 twin's weights: wall clock (best of 3) and, from
torch.profiler, the device time and K3's part of it.  Prints one JSON
object with the card's name and power limit; ``--out`` appends it to a
file.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (K, N) of the serving linears at full width: q/o, k/v, gate/up, down.
SHAPES = {"q/o": (4096, 4096), "k/v": (4096, 1024),
          "gate/up": (4096, 11008), "down": (11008, 4096)}
MS = (8, 64, 128, 256, 512, 2048)
R = 8
PREFILL = (8, 256)              # prompts x tokens of the timed prefill
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12


def bound_us(m: int, n: int, k: int, w_bytes: float, s_bytes: float):
    """(least time in us, "bytes" or "operations") of x (M, K) bf16 @ a
    weight of ``w_bytes`` with ``s_bytes`` of scales, bf16 out."""
    t_bytes = (2.0 * m * k + w_bytes + s_bytes + 2.0 * m * n) \
        / HBM_BYTES_PER_S * 1e6
    t_ops = 2.0 * m * n * k / BF16_TC_FLOPS * 1e6
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def paged_prefill(fmt: str) -> dict:
    """ms of one paged prefill (PREFILL) of the full-width serving decoder
    with ``fmt`` weights on an int8 pool: wall clock (best of 3, host
    included) and the device time of its kernels, K3's part apart."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fp8tpu_torch.models import DecoderConfig
    from fp8tpu_torch.serve import (PagedKVCache, ServeConfig,
                                    prefill_batch_paged, random_serve_params)

    cfg = DecoderConfig(vocab_size=32768, d_model=4096, n_layers=16,
                        n_heads=32, n_kv_heads=8, d_ff=11008,
                        max_seq_len=1024)
    b, t, page = PREFILL[0], PREFILL[1], 64
    params = random_serve_params(cfg, fmt, seed=0)
    scfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt="int8",
                       paged_decode_impl="kernel")
    paged = PagedKVCache.create(b * t // page, page, cfg.n_layers, b,
                                t // page, cfg.n_kv_heads, cfg.head_dim,
                                "int8")
    paged.page_table = torch.arange(b * t // page, device="cuda",
                                    dtype=torch.int32).reshape(b, -1)
    gen = torch.Generator(device="cuda").manual_seed(15)
    prompts = torch.randint(1, cfg.vocab_size, (b, t), device="cuda",
                            generator=gen, dtype=torch.int32)
    lengths = torch.full((b,), t, device="cuda", dtype=torch.int32)
    slots = torch.arange(b, device="cuda", dtype=torch.int32)
    zeros = torch.zeros(b, device="cuda")
    zi = torch.zeros(b, device="cuda", dtype=torch.int32)

    def run():
        prefill_batch_paged(params, paged, prompts, slots, lengths, None,
                            zeros, None, None, zi, zi.clone(), scfg)

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = k3 = 0.0
    k3_n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (getattr(e, "device_time", None) or e.cuda_time) / 1000.0
        device += ms
        if "stream_kernel" in e.name or "w_gemm" in e.name:
            k3 += ms
            k3_n += 1
    del params, paged
    torch.cuda.empty_cache()
    return {"wall_ms": min(walls), "device_ms": device, "k3_ms": k3,
            "k3_launches": k3_n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_wgemm: no CUDA device", file=sys.stderr)
        return 2
    import fp8tpu_torch
    from fp8tpu_torch.kernels import fp8_linear_study as t2
    from fp8tpu_torch.kernels import int4_matmul as k5
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.tools import card_line, device_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"label": args.label, "tree": os.path.abspath(args.tree),
           "package": os.path.dirname(fp8tpu_torch.__file__),
           "card": card_line(), "us": {}, "rows": []}

    def rotating(fn, *stacks):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % stacks[0].shape[0]
            return fn(*(st[state["i"]] for st in stacks))
        return call

    for name, (k, n) in SHAPES.items():
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        w8, s8 = qmatmul.quantize_weights(w, "e4m3")
        s8 = s8.reshape(-1)
        w8s = torch.stack([w8.view(torch.uint8)] * R).view(w8.dtype)
        wp, s4 = k5.quantize_weights_int4_grouped(w, 128)
        wps = torch.stack([wp] * R)
        lo, hi = k5.unpack_int4(wp)
        w4b = (torch.stack([lo, hi], 1).reshape(k, n).to(torch.bfloat16)
               * s4.to(torch.bfloat16).repeat_interleave(128, dim=0))
        w8b = w8.to(torch.bfloat16)
        w8bs = torch.stack([w8b] * R)
        w4bs = torch.stack([w4b] * R)
        del w, w8, wp, lo, hi, w8b, w4b
        for m in MS:
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            for kern, fn, stack, lib_b, w_bytes, s_bytes in (
                    ("k3", lambda w: qmatmul.dequant_matmul(x, w, s8), w8s,
                     w8bs, float(k * n), 4.0 * n),
                    ("k5", lambda w: k5.int4_matmul(x, w, s4, 128), wps,
                     w4bs, k * n / 2.0, 4.0 * s4.numel())):
                t = 1e3 * device_ms(rotating(fn, stack))
                b, by = bound_us(m, n, k, w_bytes, s_bytes)
                row = {"kernel": kern, "shape": name, "m": m, "k": k, "n": n,
                       "us": t, "bound_us": b, "bound_by": by,
                       "library_bf16_us": 1e3 * device_ms(rotating(
                           lambda wb: torch.matmul(x, wb), lib_b))}
                if kern == "k3":
                    row["library_convert_us"] = 1e3 * device_ms(rotating(
                        lambda w: torch.matmul(x, w.to(torch.bfloat16)) * s8,
                        w8s))
                res["rows"].append(row)
                res["us"][f"{kern} {name} M={m}"] = t
                print(json.dumps(row), file=sys.stderr, flush=True)
        del w8s, wps, w8bs, w4bs
        torch.cuda.empty_cache()

    k, n = SHAPES["gate/up"]
    x = torch.randn(64, k, device="cuda", generator=gen).to(torch.bfloat16)
    wf = torch.randn(k, n, device="cuda", generator=gen) * 0.02
    for mode in t2.MODES:
        w = wf.to(torch.bfloat16 if mode == "pl-bf16"
                  else torch.float8_e4m3fn)
        stack = t2.rep_weights(w, R, cold=True)
        res["us"][f"t2 {mode} M=64"] = 1e3 * device_ms(
            lambda: t2.linear(x, stack, mode), iters=4) / R
        del stack
        torch.cuda.empty_cache()
    for fmt in ("e4m3", "bf16"):
        res[f"prefill_{fmt}"] = paged_prefill(fmt)
        print(f"paged prefill {PREFILL[0]} x {PREFILL[1]}, {fmt} weights: "
              f"{res[f'prefill_{fmt}']}", file=sys.stderr, flush=True)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
