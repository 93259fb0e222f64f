"""What bounds K4 (paged decode attention) on the card: the kernel beside
two throwaway copies of it, built from this checkout's
``paged_attention.cu`` with one part taken out, timed at the served shapes.

    python3 fp8tpu_torch/tools/k4_probe.py [--out FILE]

  kernel        K4 as it is;
  loads_only    its page-table reads and cp.async loads, no arithmetic (each
                chunk is waited for, then skipped);
  compute_only  its arithmetic on whatever the rings hold, no payload or
                scale loads (the page-table reads stay).

Each at 8 and 64 slots of the int8 pool of ``bench_k1k4`` (position 444,
one layer a launch, the wrapper's split plan), device time by CUDA-graph
replay, beside the bytes bound.  The copies' results are meaningless and
not checked; the kernel's is held to the plain version.  Prints one JSON
object with the card's name and power limit; ``--out`` appends it to a
file.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# (text in paged_attention.cu, its replacement) for each probe
PROBES = {
    "kernel": [],
    "loads_only": [("        const int tok0 = tok_of(k);\n",
                    "        const int tok0 = tok_of(k);\n"
                    "        if (A.layer >= 0) { __syncwarp(); continue; }\n")],
    "compute_only": [("        if (c < cpr)\n",
                      "        if (c < cpr && A.layer < 0)\n"),
                     ('"r"(row == NO_ROW ? 0 : 4)', '"r"(0)')],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fp8tpu_torch.kernels import _build
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.tools import bench_k1k4 as bk
    from fp8tpu_torch.tools import card_line, device_ms

    src = (_build.CSRC / "paged_attention.cu").read_text()
    procs = {}
    for name, subs in PROBES.items():
        work = _build.BUILD_DIR / "k4_probe" / name
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(_build.CSRC, work)
        text = src
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"k4_probe {name}: the kernel source no "
                                   f"longer holds {a!r}")
            text = text.replace(a, b)
        (work / "paged_attention.cu").write_text(text)
        out = work / "lib.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
             str(work / "paged_attention.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"k4_probe {name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(out)).fp8_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        fns[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(page_size=bk.K4_PAGE, kv_heads=bk.K4_KV)
    res = {"card": card_line(), "us": {}, "bound_us": {}}
    built = k4._fn
    try:
        for batch in (8, 64):
            q, pool, sc, table, lens = bk.k4_inputs(gen, batch)
            tokens = int(lens.sum())
            nbytes = tokens * bk.K4_KV * 2 * (bk.K4_D + 4)
            res["bound_us"][f"{batch} slots"] = nbytes / 3.35e12 * 1e6
            want = k4.paged_decode_attention_plain(q, pool, sc, table, lens,
                                                   1, **kw)
            for name, fn in fns.items():
                k4._fn = lambda fn=fn: fn
                layer = {"i": 0}

                def call():
                    layer["i"] = (layer["i"] + 1) % bk.K4_LAYERS
                    return k4.paged_decode_attention(q, pool, sc, table,
                                                     lens, layer["i"], **kw)
                if name == "kernel":
                    got = k4.paged_decode_attention(q, pool, sc, table, lens,
                                                    1, **kw)
                    if not torch.allclose(got[2], want[2], rtol=1e-4):
                        raise RuntimeError("k4_probe: the kernel disagrees "
                                           "with the plain version")
                res["us"][f"{name} {batch} slots"] = 1e3 * device_ms(call)
            del pool, sc
    finally:
        k4._fn = built
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
