"""Device times of T1's modes, T2's modes and K6's ring write, the SASS
instructions a byte of the three e4m3 converts, and the launch floor, for
comparing two checkouts of the port on one card.

    python3 fp8tpu_torch/tools/bench_t1k6.py [--tree PATH] [--label NAME]
                                             [--out FILE] [--skip t1,t2,k6]

``--tree`` names the checkout whose ``fp8tpu_torch`` (and whose
``csrc/e4m3_convert.cuh``) is measured (default: the one this file lies
in), so that one call can time a parent commit and a change in turns
(parent, change, change, parent) on the same card; the wrappers keep their
signatures across the two.  Device times are CUDA-graph replays
(``tools.device_ms``):

  t1 <mode> warm / cold  T1's eight modes at the tool's shapes (512 tiles
                         of 512 x 128, 8 reps), µs a rep: one copy re-read
                         (warm) or 8 copies (cold);
  t2 <mode> warm / cold  T2's four modes at the tool's shape (64 x 4096 @
                         4096 x 11008, 64 reps), µs a pass;
  k6 <n> slots 2 x dyn_store + head ops
                         the ring write of one decode step as the parent
                         makes it: the payload and the scale slab of the
                         served decoder (16 layers, 8 KV heads of 128,
                         int8, 512 rows) at n = 8 and 64 slots, each by
                         dyn_store, then head = (head + 1) mod 512 by two
                         torch ops;
  k6 <n> slots ring_store
                         the same write as one ring_store launch, where
                         the tree has it;
  empty launch           a kernel that does nothing, <<<1, 32>>>: the
                         floor of any launch timed this way.

The probe library (built here with nvcc from the tree's header) also gives
``sass_per_byte``: the static SASS instructions a byte of each convert, as
T1 converts a loaded word (two byte pairs), from ``cuobjdump -sass``: the
loop of a kernel that converts four words an iteration, less the same
loop without the converts, over its 16 bytes; and ``pair_mismatches``:
every one of the 65536 byte pairs through the bits convert at each byte
position T1 uses, against the tool's table.  Prints one JSON object with
the card's name and power limit; ``--out`` appends it to a file.  Needs a
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

RING_ROWS, RING_LAYERS, RING_KV, RING_D = 512, 16, 8, 128

PROBE = r'''
#include <cstdint>
#include <cuda_runtime.h>
#include "e4m3_convert.cuh"

__global__ void empty_kernel() {}

// Four words an iteration, made in registers; HAS_PICK: the header picks a
// word's byte pairs itself (T1's cvt_half), else T1 masks and shifts.
template <int CONV>
__device__ __forceinline__ uint32_t word(uint32_t w) {
#ifdef HAS_PICK
    return e4m3::cvt_half<CONV, 0>(w) ^ e4m3::cvt_half<CONV, 1>(w);
#else
    return e4m3::cvt2<CONV>(w & 0xFFFFu) ^ e4m3::cvt2<CONV>(w >> 16);
#endif
}

// CONV < 0: the same loop without the converts.
template <int CONV>
__device__ __forceinline__ void conv_loop(uint32_t* y, uint32_t n) {
    uint32_t acc = 0;
#pragma unroll 1
    for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        const uint32_t w = i * 0x9E3779B1u;
#pragma unroll
        for (uint32_t u = 0; u < 4; ++u) {
            if constexpr (CONV < 0) {
                acc += (w + u) ^ 0x5A5A5A5Au;
            } else {
                acc += word<CONV>(w + u);
            }
        }
    }
    y[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void conv_base(uint32_t* y, uint32_t n) { conv_loop<-1>(y, n); }
__global__ void conv_astype(uint32_t* y, uint32_t n) {
    conv_loop<e4m3::ASTYPE>(y, n);
}
__global__ void conv_bits(uint32_t* y, uint32_t n) {
    conv_loop<e4m3::BITS>(y, n);
}
__global__ void conv_magic(uint32_t* y, uint32_t n) {
    conv_loop<e4m3::MAGIC>(y, n);
}

// y[2 i + k]: the bits convert of byte pair (i & 0xFF, i >> 8) placed at
// bytes (0, 1) and (2, 3) of a word whose other bytes are 0xA5.
__global__ void pairs(uint32_t* y) {
    const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 65536) return;
#ifdef HAS_PICK
    y[2 * i] = e4m3::cvt_half<e4m3::BITS, 0>(0xA5A50000u | i);
    y[2 * i + 1] = e4m3::cvt_half<e4m3::BITS, 1>((i << 16) | 0xA5A5u);
#else
    y[2 * i] = y[2 * i + 1] = e4m3::cvt2<e4m3::BITS>(i);
#endif
}

extern "C" int probe_empty(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" int probe_pairs(uint32_t* y, void* stream) {
    pairs<<<256, 256, 0, (cudaStream_t)stream>>>(y);
    return (int)cudaGetLastError();
}
'''

@functools.cache
def build_probe(tree: str):
    """(ctypes library, SASS text) of the probe, built against ``tree``'s
    ``csrc`` headers into the running package's build directory."""
    from fp8tpu_torch.kernels import _build
    csrc = os.path.join(os.path.abspath(tree), "fp8tpu_torch", "kernels",
                        "csrc")
    pick = "cvt_half" in open(os.path.join(csrc, "e4m3_convert.cuh")).read()
    work = _build.BUILD_DIR / f"t1k6_probe_{abs(hash(csrc)) % 10 ** 8}"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "probe.cu"
    src.write_text(PROBE)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-I", csrc] + (["-DHAS_PICK"] if pick else [])
    nvcc = _build.nvcc_path()
    procs = [subprocess.Popen([nvcc, *flags, *extra, str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for extra in (["-shared", "-Xcompiler", "-fPIC", "-o",
                            str(work / "libprobe.so")],
                           ["-cubin", "-o", str(work / "probe.cubin")])]
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"probe build failed:\n{log}")
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(work / "probe.cubin")],
                          capture_output=True, text=True, check=True).stdout
    lib = ctypes.CDLL(str(work / "libprobe.so"))
    lib.probe_empty.argtypes = [ctypes.c_void_p]
    lib.probe_pairs.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, sass


def sass_per_byte(sass: str) -> dict:
    """SASS instructions a byte of each convert (16 bytes a loop)."""
    from fp8tpu_torch.tools.k1_probe import loop_size
    base = loop_size(sass, "conv_base")
    return {name: (loop_size(sass, f"conv_{name}") - base) / 16.0
            for name in ("astype", "bits", "magic")}


def pair_mismatches(lib) -> dict:
    """Byte pairs whose bits convert differs from the tool's table, at the
    byte positions (0, 1) and (2, 3) of a word."""
    import torch
    from fp8tpu_torch.kernels import kexp_convert as t1
    y = torch.empty(2 * 65536, dtype=torch.int32, device="cuda")
    err = lib.probe_pairs(y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe pairs: CUDA error {err}")
    got = y.cpu().to(torch.int64).reshape(65536, 2) & 0xFFFFFFFF
    tab = t1.e4m3_bits_to_bf16(torch.arange(256).to(torch.uint8)).to(
        torch.int64)
    i = torch.arange(65536)
    want = tab[i & 0xFF] | (tab[i >> 8] << 16)
    return {pos: int((got[:, k] != want).sum())
            for k, pos in enumerate(("0,1", "2,3"))}


def empty_launch_ms(lib) -> float:
    import torch
    from fp8tpu_torch.tools import device_ms

    def call():
        err = lib.probe_empty(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe empty: CUDA error {err}")
    return device_ms(call)


def ring_slabs(gen, slots: int):
    """(kv8, slab8, sc, slabs) of the served decoder's int8 ring at
    ``slots`` slots."""
    import torch
    bk = slots * RING_KV
    kv8 = torch.zeros((RING_ROWS, 2, RING_LAYERS, bk, RING_D),
                      dtype=torch.int8, device="cuda")
    sc = torch.ones((RING_ROWS, 2, RING_LAYERS, bk), device="cuda")
    slab8 = torch.randint(-127, 128, kv8.shape[1:], device="cuda",
                          generator=gen, dtype=torch.int8)
    slabs = torch.rand(sc.shape[1:], device="cuda", generator=gen)
    return kv8, slab8, sc, slabs


def ring_write_bound_ms(slots: int) -> float:
    """Bytes of both slabs, read once and written once, at 3.35 TB/s."""
    bk = slots * RING_KV
    nbytes = 2 * RING_LAYERS * bk * (RING_D + 4)
    return 2.0 * nbytes / 3.35e12 * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--skip", default="", help="comma-separated: t1, t2, k6")
    args = ap.parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_t1k6: no CUDA device", file=sys.stderr)
        return 2
    import fp8tpu_torch
    from fp8tpu_torch.kernels import fp8_linear_study as t2
    from fp8tpu_torch.kernels import inplace
    from fp8tpu_torch.kernels import kexp_convert as t1
    from fp8tpu_torch.tools import bench_fp8_linear, card_line, device_ms
    from fp8tpu_torch.tools import kexp_convert as t1_tool

    lib, sass = build_probe(args.tree)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(os.path.splitext(args.out)[0] + f"_{args.label}.sass",
                  "w") as f:
            f.write(sass)
    res = {"label": args.label, "tree": os.path.abspath(args.tree),
           "package": os.path.dirname(fp8tpu_torch.__file__),
           "card": card_line(), "sass_per_byte": sass_per_byte(sass),
           "pair_mismatches": pair_mismatches(lib), "us": {}}
    us = res["us"]
    us["empty launch"] = 1e3 * empty_launch_ms(lib)
    if "t1" not in skip:
        q, k8, kb = t1_tool.make_inputs(t1_tool.B * t1_tool.KV, "cuda")
        reps = 8
        for mode in t1.MODES:
            arr = kb if mode in t1.BF16_MODES else k8
            for temp in ("warm", "cold"):
                qr, kr = t1.rep_inputs(q, arr, reps, temp == "cold")
                us[f"t1 {mode} {temp}"] = 1e3 * device_ms(
                    lambda: t1.stream(qr, kr, mode)) / reps
                del qr, kr
        del q, k8, kb
    if "t2" not in skip:
        x, w8, wb = bench_fp8_linear.make_inputs(bench_fp8_linear.K,
                                                 bench_fp8_linear.N, "cuda")
        reps = 64
        for mode in t2.MODES:
            w = wb if mode == "pl-bf16" else w8
            for temp in ("warm", "cold"):
                wr = t2.rep_weights(w, reps, temp == "cold")
                us[f"t2 {mode} {temp}"] = 1e3 * device_ms(
                    lambda: t2.linear(x, wr, mode), iters=2, replays=3) / reps
                del wr
        del x, w8, wb
    if "k6" not in skip:
        gen = torch.Generator(device="cuda").manual_seed(6)
        for slots in (8, 64):
            kv8, slab8, sc, slabs = ring_slabs(gen, slots)
            state = {"head": torch.zeros((), dtype=torch.int32,
                                         device="cuda")}

            def parent_form():
                inplace.dyn_store(kv8, slab8, state["head"])
                inplace.dyn_store(sc, slabs, state["head"])
                state["head"] = torch.remainder(state["head"] + 1, RING_ROWS)
            us[f"k6 {slots} slots 2 x dyn_store + head ops"] = \
                1e3 * device_ms(parent_form)
            if hasattr(inplace, "ring_store"):
                head = torch.zeros((), dtype=torch.int32, device="cuda")
                ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
                us[f"k6 {slots} slots ring_store"] = 1e3 * device_ms(
                    lambda: inplace.ring_store(kv8, slab8, sc, slabs, head,
                                               RING_ROWS, ticket))
            res[f"k6 {slots} slots bound_us"] = 1e3 * ring_write_bound_ms(
                slots)
            del kv8, sc
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
