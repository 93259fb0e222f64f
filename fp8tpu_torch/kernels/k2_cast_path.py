"""Time K2's two cast paths against each other on one GPU.

    python3 -m fp8tpu_torch.kernels.k2_cast_path [--out FILE]

K2 (``csrc/qmatmul.cu``) casts the main path's operands (e4m3 RNE
activations, uncast weights) with the variant as a template parameter, at
the tile ``launch_shaped`` picks; every other variant goes through the
runtime 50-way switch.  This builds ``qmatmul.cu`` once more with one extra
entry point that runs the runtime switch at the same tiles, checks that
both give the same bits, and times them at ResNet-50 conv shapes (batch
32), interleaved A B B A in one process.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from fp8tpu_torch.numerics.formats import RoundMode
from fp8tpu_torch.numerics.scaling import per_tensor

from . import _build
from .cast_kernel import variant_code

SHAPES = [  # (name, M, K, N), batch 32
    ("stage0 3x3", 32 * 56 * 56, 64 * 9, 64),
    ("stage0 1x1 expand", 32 * 56 * 56, 64, 256),
    ("stage3 1x1", 32 * 7 * 7, 2048, 512),
    ("stage3 3x3", 32 * 7 * 7, 512 * 9, 512),
]

WRAPPER = """#include "qmatmul.cu"
extern "C" int fp8_qdq_matmul_runtime_cast(
    const float* x, const float* w, float* out, int m, int n, int k,
    int code_x, const float* sx, int code_w, const float* sw, void* stream) {
  if (m == 0 || n == 0) return 0;
  launch_shaped<kRuntime, kRuntime>(x, w, out, m, n, k, code_x, sx, code_w,
                                    sw, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
"""
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def build():
    """Both entry points from one translation unit; returns (templated,
    runtime) and the ptxas report."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "k2_cast_path.cu"
    lib = _build.BUILD_DIR / f"libk2_cast_path-{os.getpid()}.so"
    src.write_text(WRAPPER)
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                          "-I", str(_build.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    so = ctypes.CDLL(str(lib))
    fns = []
    for name in ("fp8_qdq_matmul", "fp8_qdq_matmul_runtime_cast"):
        fn = getattr(so, name)
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
        fns.append(fn)
    return fns, out.stdout + out.stderr


def cuda_ms(fn, iters: int = 20) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chip_smoke_out/k2_cast_path.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_cast_path: no CUDA device")
    (templated, runtime), log = build()
    print("\n".join(ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))))
    gen = torch.Generator(device="cuda").manual_seed(0)
    code_x = variant_code("e4m3", RoundMode.RNE)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, m, k, n in SHAPES:
        x = torch.randn(m, k, device="cuda", generator=gen).relu_()
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        sx = per_tensor(x, "e4m3").reshape(1).contiguous()
        sw = torch.ones(n, device="cuda")
        outs = [torch.empty(m, n, device="cuda") for _ in range(2)]

        def run(i, fn=(templated, runtime)):
            err = fn[i](x.data_ptr(), w.data_ptr(), outs[i].data_ptr(), m, n,
                        k, code_x, sx.data_ptr(), -1, sw.data_ptr(), stream)
            _build.check(err, "qdq_matmul kernel")

        run(0)
        run(1)
        a0 = cuda_ms(lambda: run(0))
        b0 = cuda_ms(lambda: run(1))
        b1 = cuda_ms(lambda: run(1))
        a1 = cuda_ms(lambda: run(0))
        same = bool(torch.equal(outs[0].view(torch.int32),
                                outs[1].view(torch.int32)))
        row = {"shape": name, "m": m, "k": k, "n": n,
               "templated_ms": [a0, a1], "runtime_ms": [b0, b1],
               "runtime_over_templated": (b0 + b1) / (a0 + a1),
               "bit_equal": same}
        rows.append(row)
        print(f"{name} M={m} K={k} N={n}: templated {a0:.4f} / {a1:.4f} ms, "
              f"runtime switch {b0:.4f} / {b1:.4f} ms, ratio "
              f"{row['runtime_over_templated']:.3f}, bit-equal {same}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0 if all(r["bit_equal"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
