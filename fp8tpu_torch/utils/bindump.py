"""Binary tensor dumps for offline numerics analysis: the port of
``fp8tpu/utils/bindump.py``.

Tensors are written as raw bit patterns to files named
``{step}_{module}_{role}_{dims}_{dtype}.bin`` (the JAX package's names and
bytes: numpy's dtype names, bf16 and fp8 as ml_dtypes name them), between a
start and an end step."""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

# numpy-style names of the dtypes numpy lacks (ml_dtypes' names, which the
# JAX package's files carry)
_EXT_NAMES = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
              torch.float8_e5m2: "float8_e5m2"}


@dataclasses.dataclass
class BindumpSchedule:
    """Dump window [start_step, end_step)."""

    start_step: int = 0
    end_step: int = 0
    directory: str = "./bindump"

    def enabled(self, step: int) -> bool:
        return self.start_step <= step < self.end_step


def _raw(tensor):
    """(a numpy array with the tensor's bytes, its dtype name)."""
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach().cpu().contiguous()
        if t.dtype in _EXT_NAMES:
            return t.reshape(-1).view(torch.uint8).numpy(), _EXT_NAMES[
                t.dtype]
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(tensor)
    return arr, arr.dtype.name


def bindump_tensor(tensor, step: int, module_name: str, role: str,
                   directory: str = "./bindump") -> str:
    """Write one tensor's raw bits."""
    arr, dtype = _raw(tensor)
    os.makedirs(directory, exist_ok=True)
    dims = "x".join(str(d) for d in tuple(tensor.shape))
    safe = module_name.replace("/", ".")
    path = os.path.join(directory, f"{step}_{safe}_{role}_{dims}_{dtype}.bin")
    arr.tofile(path)
    return path


def bindump_tree(tree, step: int, role: str,
                 directory: str = "./bindump") -> list:
    """Dump every leaf of a nest of dicts / lists (a state_dict, gradients),
    named by its "/"-joined path."""
    from .stats import _leaves
    return [bindump_tensor(leaf, step, name, role, directory)
            for name, leaf in _leaves(tree)]


class TensorDumpHelper:
    """Pickle-based tensor archiving: accumulate named tensors (as numpy
    arrays), dump once."""

    def __init__(self, directory: str = "./tensordump"):
        self.directory = directory
        self._store: dict = {}

    def add(self, name: str, role: str, tensor) -> None:
        arr = (tensor.detach().cpu().numpy()
               if isinstance(tensor, torch.Tensor) else np.asarray(tensor))
        self._store.setdefault(name, {}).setdefault(role, []).append(arr)

    def dump(self, filename: str = "tensors.pkl") -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, filename)
        with open(path, "wb") as f:
            pickle.dump(self._store, f)
        self._store = {}
        return path
