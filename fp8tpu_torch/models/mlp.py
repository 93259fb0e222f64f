"""Minimal MLP classifier, the smallest end-to-end PTQ slice."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.linen import Dense, Module, init_params


class MLP(Module):
    """``dense_0 … dense_{n-1}`` with ReLU, then ``head``; inputs are
    flattened per example."""

    def __init__(self, in_features: int, features: Sequence[int] = (256, 256),
                 num_classes: int = 10):
        super().__init__()
        self.names = []
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(in_features, f))
            self.names.append(f"dense_{i}")
            in_features = f
        self.head = Dense(in_features, num_classes)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for name in self.names:
            x = F.relu(getattr(self, name)(x))
        return self.head(x)


def mlp(in_features: int, features: Sequence[int] = (256, 256),
        num_classes: int = 10, device="cuda",
        generator: Optional[torch.Generator] = None) -> MLP:
    model = MLP(in_features, features, num_classes)
    if generator is not None:
        init_params(model, generator)
    return model.to(resolve_device(device))
