"""What bounds K1 (the cast kernel) on the card: throwaway probe kernels
built from a checkout's ``cast.cuh``, timed at (32, 256, 56, 56).

    python3 fp8tpu_torch/tools/k1_probe.py [--tree PATH] [--label NAME]
                                           [--out FILE]

Probes, each over the same 25.7 M elements with K1's launch geometry:

  copy_scalar  K1's first design's loads and stores with no cast: a
               grid-stride loop, one 4-byte element a thread per step,
               64-bit indices, 64 blocks of 256 threads an SM;
  copy_vec     the redesign's: two 16-byte loads a thread in flight,
               streaming stores, 32-bit indices, 8 blocks an SM;
  emulated     the bit-level emulation of e4m3 RNE per-tensor on data made
               in registers (no loads; each thread stores one word);
  hw_route     the hardware route on the same data, four elements at a
               time, with the NaN check (checkouts whose cast.cuh has it).

For each it prints the device time (CUDA-graph replay) and the static
SASS instruction count of its hottest loop (``cuobjdump -sass``), with the
card's SM clock and its maximum (``nvidia-smi``).  ``--tree`` names the
checkout whose ``cast.cuh`` is included, so one call can probe a parent
and a change.  Prints one JSON object; ``--out`` appends it to a file.
Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPE = (32, 256, 56, 56)

PROBES = r'''
#include <cstdint>
#include <cuda_runtime.h>
#include "cast.cuh"

__device__ __forceinline__ float made(uint32_t i) {
  // a normal value of either sign, exponents 2^-8 .. 2^7, from a hash of i
  const uint32_t h = i * 0x9E3779B1u;
  return __uint_as_float((h & 0x807FFFFFu) | ((119u + (h >> 27)) << 23));
}

__global__ void copy_scalar(const float* x, float* y, long long n) {
  const long long nt = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += nt)
    y[i] = x[i];
}

__global__ void copy_vec(const float* x, float* y, uint32_t n, uint32_t per) {
  const uint32_t ng = n / 4, g0 = blockIdx.x * per;
  const uint32_t g1 = min(g0 + per, ng);
  for (uint32_t g = g0 + threadIdx.x; g < g1; g += 2 * blockDim.x) {
    const uint32_t g2 = g + blockDim.x;
    const float4 a = __ldg(reinterpret_cast<const float4*>(x) + g);
    float4 b;
    if (g2 < g1) b = __ldg(reinterpret_cast<const float4*>(x) + g2);
    __stcs(reinterpret_cast<float4*>(y) + g, a);
    if (g2 < g1) __stcs(reinterpret_cast<float4*>(y) + g2, b);
  }
}

__global__ void emulated(uint32_t* y, uint32_t n, float s) {
  const uint32_t nt = gridDim.x * blockDim.x;
  const float inv = fp8::recip_ftz(s);
  uint32_t acc = 0;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += nt) {
#ifdef HAS_HW_ROUTE
    acc ^= __float_as_uint(
        fp8::cast_emulated<fp8::E4M3, fp8::RNE, false>(made(i), s, inv, 0u));
#else
    acc ^= __float_as_uint(
        fp8::cast_elem<fp8::E4M3, fp8::RNE, false>(made(i), s, inv, 0u));
#endif
  }
  y[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

#ifdef HAS_HW_ROUTE
__global__ void hw_route(uint32_t* y, uint32_t n, float s) {
  const uint32_t nt = gridDim.x * blockDim.x;
  const float inv = fp8::recip_ftz(s);
  uint32_t acc = 0;
  bool bad = false;
  for (uint32_t i = 4 * (blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc ^= __float_as_uint(fp8::cast_route<fp8::E4M3, fp8::RNE, false, true>(
          made(i + e), s, inv, 0u, bad));
  }
  y[blockIdx.x * blockDim.x + threadIdx.x] = acc ^ (uint32_t)bad;
}
#endif

extern "C" int probe(int which, const float* x, float* y, long long n,
                     float s, int sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t n32 = (uint32_t)n;
  if (which == 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > 64LL * sms) blocks = 64LL * sms;
    copy_scalar<<<(unsigned)blocks, 256, 0, st>>>(x, y, n);
  } else if (which == 1) {
    const uint32_t ng = n32 / 4, step = 512;
    uint32_t blocks = (ng + step - 1) / step;
    if (blocks > 8u * sms) blocks = 8u * sms;
    const uint32_t per = ((ng + blocks - 1) / blocks + step - 1) / step * step;
    copy_vec<<<(ng + per - 1) / per, 256, 0, st>>>(x, y, n32, per);
  } else if (which == 2) {
    emulated<<<64 * sms, 256, 0, st>>>((uint32_t*)y, n32, s);
  } else {
#ifdef HAS_HW_ROUTE
    hw_route<<<64 * sms, 256, 0, st>>>((uint32_t*)y, n32, s);
#else
    return -1;
#endif
  }
  return (int)cudaGetLastError();
}
'''


def loop_size(sass: str, kernel: str) -> int:
    """Instructions in the largest backward-branch loop of ``kernel``'s
    SASS (cuobjdump -sass)."""
    body, on = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            on = f"_Z{len(kernel)}{kernel}" in ln
            continue
        if on:
            body.append(ln)
    labels, addrs = {}, []
    for ln in body:
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            labels[m.group(1)] = len(addrs)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*)", ln)
        if m:
            addrs.append((int(m.group(1), 16), m.group(2)))
    index = {a: i for i, (a, _) in enumerate(addrs)}
    best = 0
    for pos, (_, text) in enumerate(addrs):
        m = re.search(r"BRA\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if not m:
            continue
        t = m.group(1)
        start = labels.get(t) if t.startswith(".L") else index.get(int(t, 16))
        if start is not None and start <= pos:
            best = max(best, pos - start + 1)
    return best


def clocks() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import ctypes
    import torch
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from fp8tpu_torch.kernels import _build
    from fp8tpu_torch.tools import card_line, device_ms

    csrc = os.path.join(os.path.abspath(args.tree), "fp8tpu_torch", "kernels",
                        "csrc")
    hw = "cast_route" in open(os.path.join(csrc, "cast.cuh")).read()
    work = _build.BUILD_DIR / f"k1_probe_{abs(hash(csrc)) % 10 ** 8}"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "probe.cu"
    src.write_text(PROBES)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-I", csrc] + (["-DHAS_HW_ROUTE"] if hw else [])
    nvcc = _build.nvcc_path()
    subprocess.run([nvcc, *flags, "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(work / "libprobe.so"), str(src)], check=True)
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(work / "probe.cubin"),
                    str(src)], check=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(work / "probe.cubin")],
                          capture_output=True, text=True, check=True).stdout
    if args.out:
        with open(os.path.splitext(args.out)[0] + f"_{args.label}.sass",
                  "w") as f:
            f.write(sass)
    lib = ctypes.CDLL(str(work / "libprobe.so"))
    lib.probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p]
    lib.probe.restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, device="cuda", generator=gen)
    y = torch.empty_like(x)
    n = x.numel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"label": args.label, "tree": os.path.abspath(args.tree),
           "card": card_line(), "shape": list(SHAPE), "us": {},
           "loop_instructions": {}}
    names = ["copy_scalar", "copy_vec", "emulated"] + (["hw_route"] if hw
                                                       else [])
    for which, name in enumerate(names):
        def call(which=which):
            err = lib.probe(which, x.data_ptr(), y.data_ptr(), n, 3.7, sms,
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe {name}: CUDA error {err}")
        res["us"][name] = 1e3 * device_ms(call)
        res["loop_instructions"][name] = loop_size(sass, name)
        if name.startswith("copy"):
            assert torch.equal(x, y), name
    res["clocks_sm_and_max"] = clocks()
    res["bound_us"] = 8.0 * n / 3.35e12 * 1e6
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
