"""Device times of K1 (the cast kernel), K2's cast pre-pass and K4 (paged
decode attention) at their main paths' shapes, for comparing two
checkouts of the port on one card.

    python3 fp8tpu_torch/tools/bench_k1k4.py [--tree PATH] [--label NAME]
                                             [--out FILE] [--skip k4]

``--tree`` names the checkout whose ``fp8tpu_torch`` is measured (default:
the one this file lies in), so that one call can time a parent commit and
a change in turns (parent, change, change, parent) on the same card; the
wrappers keep their signatures across the two.  Device times are
CUDA-graph replays (``tools.device_ms``) of one call:

  k1 (32, 256, 56, 56)   e4m3 RNE with a per-tensor scale, the largest
                         operand of a ResNet-50 residual add at batch 32;
                         beside it the event-timed eager call (the
                         wrapper's host time included);
  k1 residual sum        the 32 operands of one PTQ forward's 16 residual
                         adds, one call each, summed;
  k2 pre-pass            the stage-0 activation (32, 64, 56, 56) cast to
                         K2's bf16 grid planes (``qmatmul.conv_prepass``);
  k4 8 / 64 slots        one layer of the served decoder's int8 paged pool
                         (8 KV heads x 4 queries of 128, pages of 64) at
                         position 444, the 16 layers read in turn so that a
                         launch finds its pages in device memory.

Prints one JSON object with the card's name and power limit; ``--out``
appends it to a file.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

K1_SHAPE = (32, 256, 56, 56)
# (channels, size, operands) of the residual adds of one ResNet-50 forward
# at batch 32: 3, 4, 6 and 3 bottleneck blocks, two operands each.
RESIDUAL = ((256, 56, 6), (512, 28, 8), (1024, 14, 12), (2048, 7, 6))
K4_LAYERS, K4_KV, K4_G, K4_D, K4_PAGE, K4_POS, K4_CACHE = \
    16, 8, 4, 128, 64, 444, 512


def residual_shapes(batch: int = 32):
    return [(batch, c, s, s) for c, s, k in RESIDUAL for _ in range(k)]


def k4_inputs(gen, batch: int):
    """The int8 pool, scales, table, lengths and queries of one timed
    decode step at ``batch`` slots."""
    import torch
    mp = K4_CACHE // K4_PAGE
    P = batch * mp
    pool = torch.randint(-127, 128, (P, 2, K4_LAYERS, K4_PAGE * K4_KV, K4_D),
                         device="cuda", generator=gen, dtype=torch.int8)
    sc = torch.empty((P, 2, K4_LAYERS, K4_PAGE * K4_KV),
                     device="cuda").uniform_(0.004, 0.02, generator=gen)
    table = torch.randperm(P, device="cuda", generator=gen).to(
        torch.int32).reshape(batch, mp)
    lens = torch.full((batch,), K4_POS, device="cuda", dtype=torch.int32)
    q = (torch.randn(batch, K4_KV * K4_G, K4_D, device="cuda", generator=gen)
         * 0.7).to(torch.bfloat16)
    return q, pool, sc, table, lens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--skip", default="", help="comma-separated: k1, k2, k4")
    args = ap.parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_k1k4: no CUDA device", file=sys.stderr)
        return 2
    import fp8tpu_torch
    from fp8tpu_torch.kernels import cast_kernel, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.numerics.scaling import per_tensor
    from fp8tpu_torch.tools import card_line, device_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"label": args.label, "tree": os.path.abspath(args.tree),
           "package": os.path.dirname(fp8tpu_torch.__file__),
           "card": card_line(), "us": {}}
    rne = RoundMode.RNE
    if "k1" not in skip:
        total = 0.0
        for i, shape in enumerate(residual_shapes()):
            x = torch.randn(shape, device="cuda", generator=gen)
            s = per_tensor(x, "e4m3")
            t = 1e3 * device_ms(lambda: cast_kernel.cuda_qdq(x, "e4m3", rne,
                                                              s))
            total += t
            if i == 0:
                res["us"]["k1 (32, 256, 56, 56)"] = t
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                for _ in range(3):
                    cast_kernel.cuda_qdq(x, "e4m3", rne, s)
                start.record()
                for _ in range(20):
                    cast_kernel.cuda_qdq(x, "e4m3", rne, s)
                end.record()
                torch.cuda.synchronize()
                res["us"]["k1 (32, 256, 56, 56) event-timed"] = \
                    1e3 * start.elapsed_time(end) / 20
            del x
        res["us"]["k1 residual sum (32 calls)"] = total
    if "k2" not in skip:
        x = torch.randn(32, 64, 56, 56, device="cuda", generator=gen).relu_()
        pads = ((1, 1), (1, 1))
        sx = per_tensor(qmatmul.gathered(x, (3, 3), (1, 1), pads), "e4m3")
        res["us"]["k2 pre-pass stage-0 activation"] = 1e3 * device_ms(
            lambda: qmatmul.conv_prepass(x, "e4m3", rne, sx, "bitexact"))
        del x
    if "k4" not in skip:
        for batch in (8, 64):
            q, pool, sc, table, lens = k4_inputs(gen, batch)
            layer = {"i": 0}

            def kern():
                layer["i"] = (layer["i"] + 1) % K4_LAYERS
                return k4.paged_decode_attention(
                    q, pool, sc, table, lens, layer["i"],
                    page_size=K4_PAGE, kv_heads=K4_KV)
            res["us"][f"k4 {batch} slots"] = 1e3 * device_ms(kern)
            del pool, sc
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
