"""Quantizable op wrappers: thin named modules that turn functional ops into
interceptable call sites, so residual adds, attention matmuls and the like
get per-layer policy by path (the reference's ``module_wrappers``)."""

from __future__ import annotations

import torch

from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.linen import Module


class Matmul(Module):
    """y = a @ b."""

    def forward(self, a, b):
        with full_fp32():
            return torch.matmul(a, b)


class AddMatmul(Module):
    """y = inp + a @ b."""

    def forward(self, inp, a, b):
        with full_fp32():
            return inp + torch.matmul(a, b)


class BatchMatmul(Module):
    """Batched matmul; policy quantizes inputs only."""

    def forward(self, a, b):
        with full_fp32():
            return torch.matmul(a, b)


class EltwiseAdd(Module):
    def forward(self, a, b):
        return a + b


class EltwiseMul(Module):
    def forward(self, a, b):
        return a * b


class EltwiseDiv(Module):
    def forward(self, a, b):
        return a / b


class Norm(Module):
    """p-norm reduction."""

    def __init__(self, ord: int = 2, axis: int = -1, keepdims: bool = False):
        super().__init__()
        self.ord, self.axis, self.keepdims = ord, axis, keepdims

    def forward(self, x):
        return torch.linalg.vector_norm(x, ord=self.ord, dim=self.axis,
                                        keepdim=self.keepdims)


class Mean(Module):
    """Mean reduction."""

    def __init__(self, axis: int = -1, keepdims: bool = False):
        super().__init__()
        self.axis, self.keepdims = axis, keepdims

    def forward(self, x):
        return x.mean(dim=self.axis, keepdim=self.keepdims)
