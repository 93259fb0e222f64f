"""T1: fp8 -> bf16 convert throughput and the decode-attention dot
orientation on the card.

    python -m fp8tpu_torch.tools.kexp_convert [--device cuda|cpu]

The counterpart of ``tools/kexp_convert.py`` (JAX, TPU).  q (BKV, 1, 8,
128) bf16 against (512 x 128) e4m3 or bf16 K tiles, R reps, through
``fp8tpu_torch.kernels.kexp_convert.stream`` in the tool's seven modes
(convert only, q . k^T only, and a whole flash block with the bits
convert) and one more, the flash block with the hardware convert.
Prints the tool's lines: the
bits-convert mismatches over all 256 e4m3 bytes, then per mode the ms a
rep and GB/s on the stored K bytes, warm (one copy re-read R times, from
L2 where it fits: the tool's layout) and cold (R copies, each read once
from HBM); then the card's name and power limit.  Times are device times
(CUDA-graph replay).  On the CPU it runs the plain versions and prints no
time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.kernels import kexp_convert as t1

from . import card_line, device_ms

B, KV = 32, 16                 # the tool's tiles: B * KV = 512


def make_inputs(bkv: int, device):
    """(q, k8, kb): the tool's recipe, from numpy seed 0."""
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(
        rng.standard_normal((bkv, 1, t1.S, t1.D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((bkv, 1, t1.G, t1.D))
                         .astype(np.float32)).to(torch.bfloat16)
    raw = raw.to(device)
    return (q.to(device), raw.to(torch.float8_e4m3fn),
            raw.to(torch.bfloat16))


def all_bytes_tile(device):
    """(q, k): one e4m3 tile whose corner rows 0 and 1 hold the 256 byte
    patterns, the rest zero; the conv modes' output returns them
    converted."""
    k = torch.zeros((1, 1, t1.S, t1.D), dtype=torch.uint8)
    k[0, 0, :2] = torch.arange(256, dtype=torch.int32).reshape(2, 128).to(
        torch.uint8)
    q = torch.zeros((1, 1, t1.G, t1.D), dtype=torch.bfloat16)
    return q.to(device), k.to(device)


def convert_mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements whose values differ; NaN matches NaN."""
    got, want = got.float().cpu(), want.float().cpu()
    bad = (got != want) & ~(torch.isnan(got) & torch.isnan(want))
    return int(bad.sum())


def run(device="cuda", bkv: int = B * KV, reps: int = 8) -> dict:
    """Print the study's lines; return the mismatch counts and, by mode,
    the outputs and (on the card) the warm and cold ms a rep.  ``bkv`` and
    ``reps`` are the tool's; tests make them smaller."""
    dev = resolve_device(device)
    want = t1.convert(torch.arange(256, dtype=torch.int32).to(torch.uint8),
                      "astype").cpu()
    q1, k1 = all_bytes_tile(dev)
    result = {"device": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu", "modes": {}}
    for mode in ("conv-bits", "conv-astype"):
        out, _ = t1.stream(q1, k1, mode, reps=1)
        bad = convert_mismatches(out[:2].reshape(-1), want)
        result[f"{mode} mismatches"] = bad
    print("bits-convert mismatches:", result["conv-bits mismatches"])
    print("astype-convert mismatches:", result["conv-astype mismatches"])

    q, k8, kb = make_inputs(bkv, dev)
    for mode in t1.MODES:
        arr = kb if mode in t1.BF16_MODES else k8
        row = {"k_bytes": arr.numel() * arr.element_size(),
               "q_bytes": q.numel() * q.element_size()}
        out, fold = t1.stream(q, arr, mode, reps=reps)
        row["out"], row["fold"] = out, fold
        if dev.type == "cuda":
            gb = row["k_bytes"] / 1e9
            line = f"{mode:16s}:"
            for temp in ("warm", "cold"):
                qr, kr = t1.rep_inputs(q, arr, reps, temp == "cold")
                ms = device_ms(lambda: t1.stream(qr, kr, mode)) / reps
                row[f"{temp}_ms"] = ms
                line += (f" {temp} {ms:7.4f} ms for {gb:.3f} GB -> "
                         f"{gb / ms * 1e3:5.0f} GB/s;")
                del qr, kr
            print(line.rstrip(";"), flush=True)
        result["modes"][mode] = row
    print(card_line())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
