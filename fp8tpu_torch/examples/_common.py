"""What the example scripts share: a log of printed lines, the device
flag, and random models built on the device they run on."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from fp8tpu_torch._device import resolve_device

# Where a flag of a JAX script waits for a part the port does not have.
MOE_PARALLEL = ("capacity routing over the global batch needs the MoE "
                "decoder under MOE_PARAM_RULES (ROADMAP §1 item 7d)")


class Log:
    """Prints lines (unless ``quiet``: a data-parallel rank other than 0)
    and keeps them, for ``main``'s result."""

    def __init__(self, quiet: bool = False):
        self.lines: List[str] = []
        self.quiet = quiet

    def __call__(self, line: str) -> None:
        if not self.quiet:
            print(line, flush=True)
        self.lines.append(line)


def add_device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: the hand-written kernels) or "
                        "'cpu' (their plain torch versions)")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Wall seconds of a piece of work on ``device``, the device drained
    at both ends."""

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.seconds = time.perf_counter() - self.t0


def random_decoder(cfg, device, seed: int):
    """``models.decoder`` drawn on ``device`` from a generator there seeded
    with ``seed``."""
    from fp8tpu_torch.models import decoder
    dev = resolve_device(device)
    return decoder(cfg, dev, torch.Generator(dev).manual_seed(seed))


def from_flax(model: torch.nn.Module, variables: Optional[Dict]):
    """``model`` with the Flax-layout ``variables`` loaded, when given."""
    if variables is not None:
        from fp8tpu_torch.models import variables_from_flax
        dev = next(model.parameters()).device
        model.load_state_dict({k: v.to(dev) for k, v in
                               variables_from_flax(variables).items()})
    return model
