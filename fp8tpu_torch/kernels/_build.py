"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` (the hash covers the sources and flags, so
an edited source is rebuilt) and loaded with ctypes.  Sources have a plain
C interface, so a build takes seconds.  Builds happen at first use, or all
at once, in parallel, through :func:`build_all`.

No ``--use_fast_math`` and no ``-ftz=true``: the cast pipeline must see
subnormals as the plain torch version does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("cast_kernel", "qmatmul", "dequant_matmul", "int4_matmul",
           "inplace", "paged_attention", "kexp_convert", "fp8_linear_study",
           "w8a8", "adam8")
# Libraries built from another's source with more flags, at first use only
# (not in build_all's default): {name: (source, flags)}.  w8a8_probe is P1
# with tensor-core chunks inside a stage, for the accumulation probes.
VARIANTS = {"w8a8_probe": ("w8a8", ("-DP1_CHUNK_PROBE",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from the CUDA toolkit that PyTorch finds (CUDA_HOME, PATH or
    the toolkit's default location)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the fp8tpu_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _source(name: str):
    """(the .cu file, the nvcc flags) of library ``name``."""
    src, extra = VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", (*NVCC_FLAGS, *extra)


def lib_path(name: str) -> Path:
    cu, flags = _source(name)
    h = hashlib.sha256()
    for src in sorted(CSRC.iterdir()):
        if src == cu or src.suffix == ".cuh":
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source that is not built yet, one nvcc per source, all
    started together.  Returns {name: {"seconds", "log"}}; raises if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cu, flags = _source(name)
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu`` or a VARIANTS
    entry), built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
