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
128) at the four full-width serving linears and M = 8, 64 and 512; T2's
four modes at its tool's shape (M = 64, 4096 x 11008), a time per rep.
Prints one JSON object with the card's name and power limit; ``--out``
appends it to a file.  Needs a card.
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
MS = (8, 64, 512)
R = 8


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
           "card": card_line(), "us": {}}

    def rotating(fn, stack):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % stack.shape[0]
            return fn(stack[state["i"]])
        return call

    for name, (k, n) in SHAPES.items():
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        w8, s8 = qmatmul.quantize_weights(w, "e4m3")
        s8 = s8.reshape(-1)
        w8s = torch.stack([w8.view(torch.uint8)] * R).view(w8.dtype)
        wp, s4 = k5.quantize_weights_int4_grouped(w, 128)
        wps = torch.stack([wp] * R)
        del w, w8, wp
        for m in MS:
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            res["us"][f"k3 {name} M={m}"] = 1e3 * device_ms(rotating(
                lambda w: qmatmul.dequant_matmul(x, w, s8), w8s))
            res["us"][f"k5 {name} M={m}"] = 1e3 * device_ms(rotating(
                lambda w: k5.int4_matmul(x, w, s4, 128), wps))
        del w8s, wps
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
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
