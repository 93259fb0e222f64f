"""T2: can a hand kernel that converts the fp8 weight in registers beat the
library's operand convert at the decode MLP shape?

    python -m fp8tpu_torch.tools.bench_fp8_linear [--device cuda|cpu]

The counterpart of ``tools/bench_pallas_linear.py`` (JAX, TPU).  ``x (64,
4096) @ conv(w (4096, N))`` through ``fp8tpu_torch.kernels.fp8_linear_study
.linear``, which is K3's streaming kernel with only the convert changed:
pl-astype (K3's hardware convert), pl-bits, pl-magic (the tool's integer
converts) on e4m3 weights, pl-bf16 on bf16 weights.  Prints the tool's
lines: the bits and magic products against the astype product (they must
be bit-identical), the torch controls (``xla-fp8`` is ``x @
w8.to(torch.bfloat16)``, ``xla-bf16`` is ``x @ wb``: yardsticks, called by
nothing of the port), then per mode the ms a pass and GB/s on the stored
weight bytes, warm (one copy re-read R times, from L2 where it fits: the
tool's layout) and cold (R copies, each read once from HBM); then the
card's name and power limit.  Also the three converts in the kernel over
all 256 e4m3 bytes.  Times are device times (CUDA-graph replay).  On the
CPU it runs the plain versions and prints no time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.kernels import fp8_linear_study as t2
from fp8tpu_torch.kernels.kexp_convert import convert

from . import card_line, device_ms

B, K, N = 64, 4096, 11008      # the tool's shape


def make_inputs(k: int, n: int, device):
    """(x, w8, wb): the tool's recipe, from numpy seed 0."""
    rng = np.random.default_rng(0)
    wf = torch.from_numpy((rng.standard_normal((k, n)) * 0.02)
                          .astype(np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal((B, k)).astype(np.float32))
    return (x.to(torch.bfloat16).to(device), wf.to(torch.float8_e4m3fn),
            wf.to(torch.bfloat16))


def all_bytes_case(k: int, n: int, device):
    """(x, w): w's row 0 holds the 256 e4m3 byte patterns in its first 256
    columns and x = e_0 in every row, so out[:, :256] is the converted
    bytes (each product is exact, and so is its bf16 rounding)."""
    w = torch.zeros((k, n), dtype=torch.uint8)
    w[0, :256] = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    x = torch.zeros((B, k), dtype=torch.bfloat16)
    x[:, 0] = 1.0
    return x.to(device), w.to(device).view(torch.float8_e4m3fn)


def run(device="cuda", n: int = N, reps: int = 64) -> dict:
    """Print the study's lines; return the mismatch counts, the torch
    controls' ms and, by mode, the output and (on the card) the warm and
    cold ms a pass.  ``n`` and ``reps`` are the tool's; tests make them
    smaller."""
    dev = resolve_device(device)
    result = {"device": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu", "modes": {}}

    xe, we = all_bytes_case(K, max(n, 256), dev)
    want = convert(we[0, :256], "astype").float().cpu()
    line = "convert mismatches over the 256 e4m3 bytes, through linear:"
    for mode in ("pl-astype", "pl-bits", "pl-magic"):
        got = t2.linear(xe, we, mode, reps=1)[0, :256].float().cpu()
        bad = (got != want) & ~(torch.isnan(got) & torch.isnan(want))
        result[f"{mode} mismatches"] = int(bad.sum())
        line += f" {mode[3:]} {int(bad.sum())}"
    print(line)
    del xe, we

    x, w8, wb = make_inputs(K, n, dev)
    want = t2.linear(x, w8, "pl-astype", reps=1)
    result["modes"]["pl-astype"] = {"out": want}
    for mode in ("pl-bits", "pl-magic"):
        got = t2.linear(x, w8, mode, reps=1)
        bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        result["modes"][mode] = {"out": got, "vs_astype": bad}
        print(f"{mode}: {'exact' if bad == 0 else f'{bad} MISMATCHES'} "
              f"vs in-kernel astype dot")
    result["modes"]["pl-bf16"] = {"out": t2.linear(x, wb, "pl-bf16", reps=1)}

    fp8_bytes = K * n
    if dev.type == "cuda":
        for name, fn, bytes_ in (
                ("xla-fp8", lambda: x @ w8.to(torch.bfloat16), fp8_bytes),
                ("xla-bf16", lambda: x @ wb, 2 * fp8_bytes)):
            ms = device_ms(fn)
            result[name + "_ms"] = ms
            print(f"{name:10s} {ms:7.4f} ms/pass  "
                  f"{bytes_ / ms / 1e6:5.0f} GB/s stored-weight", flush=True)
        for mode in t2.MODES:
            w = wb if mode == "pl-bf16" else w8
            bytes_ = w.numel() * w.element_size()
            row = result["modes"][mode]
            line = f"{mode:10s}"
            for temp in ("warm", "cold"):
                wr = t2.rep_weights(w, reps, temp == "cold")
                ms = device_ms(lambda: t2.linear(x, wr, mode), iters=2,
                               replays=3) / reps
                row[f"{temp}_ms"] = ms
                line += (f" {temp} {ms:7.4f} ms/pass "
                         f"{bytes_ / ms / 1e6:5.0f} GB/s stored-weight;")
                del wr
            print(line.rstrip(";"), flush=True)
    print(card_line())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
