"""Device selection and float32 precision for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Raises when a CUDA device is
    asked for (the default) and none is present: the CPU runs only when the
    caller asks for it."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the CPU")
    return d


@contextlib.contextmanager
def full_fp32():
    """Run float32 matmuls and convolutions in IEEE float32, not TF32
    (cuDNN convolutions default to TF32), as the JAX package's HIGHEST
    precision contractions do."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
