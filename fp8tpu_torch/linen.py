"""Interceptable module base class and the core layers of the port: the
counterpart of what the JAX package takes from ``flax.linen``.

Forward hooks cannot replace a module's contraction, so calls are
intercepted the way ``flax.linen.intercept_methods`` does it: inside
:func:`intercept_methods`, every call of a :class:`Module` that belongs to
the given root goes through the interceptor, which receives the call's
``next_fun``, arguments and a :class:`CallContext` naming the module and its
Flax-style path (``stage0_block0/conv1``).

Layers keep PyTorch layouts (NCHW activations, OIHW and (out, in)
weights) and Flax's semantics where they differ from torch's
(``padding="SAME"``, BatchNorm's biased variance and momentum 0.9).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from fp8tpu_torch._device import full_fp32


@dataclasses.dataclass(frozen=True)
class CallContext:
    module: "Module"
    path: str


# Active (interceptor, {id(module): path}) pairs, innermost last.
_ACTIVE: contextvars.ContextVar[Tuple] = contextvars.ContextVar(
    "fp8tpu_torch_interceptors", default=())


def module_paths(root: nn.Module) -> Dict[int, str]:
    """{id(module): "a/b/c"} for every submodule of ``root`` (not root)."""
    return {id(m): name.replace(".", "/")
            for name, m in root.named_modules() if name}


@contextlib.contextmanager
def intercept_methods(interceptor: Callable, root: nn.Module):
    """Route every call of a :class:`Module` under ``root`` through
    ``interceptor(next_fun, args, kwargs, context)`` while the context is
    open."""
    token = _ACTIVE.set(_ACTIVE.get() + ((interceptor, module_paths(root)),))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


class Module(nn.Module):
    """``torch.nn.Module`` whose calls an active interceptor can wrap."""

    def __call__(self, *args, **kwargs):
        call = super().__call__
        for interceptor, paths in _ACTIVE.get():
            path = paths.get(id(self))
            if path is None:
                continue
            call = _wrap(interceptor, call, CallContext(self, path))
        return call(*args, **kwargs)


def _wrap(interceptor, next_fun, context):
    return lambda *a, **kw: interceptor(next_fun, a, kw, context)


@contextlib.contextmanager
def _interceptors(state: Tuple):
    token = _ACTIVE.set(state)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def remat(module: nn.Module, *args):
    """``module(*args)`` with its activations recomputed in the backward
    instead of kept (``flax.linen.remat``), through
    ``torch.utils.checkpoint``.  The recompute runs during the backward,
    after :func:`intercept_methods` and ``functional_call`` have exited, so
    it is given back the interceptors (and with them the SR keys) and the
    parameter tensors that are active now; without them it would
    recompute another function (the module's own, unquantized weights,
    no casts) and train on its activations without a word."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint

    def bound(name):
        obj = module
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    names = [n for n, _ in module.named_parameters()] \
        + [n for n, _ in module.named_buffers()]
    tensors = {n: bound(n) for n in names}
    state = _ACTIVE.get()
    return checkpoint(
        lambda *a: functional_call(module, tensors, a), *args,
        use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _interceptors(state)))


# -- layers --------------------------------------------------------------------

PaddingLike = Union[str, int, Sequence[int], Sequence[Tuple[int, int]]]


def conv_padding(padding: PaddingLike, in_hw: Sequence[int],
                 kernel: Sequence[int], strides: Sequence[int]):
    """Flax padding spec → ((top, bottom), (left, right))."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return ((0, 0), (0, 0))
        if p != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        pads = []
        for size, k, s in zip(in_hw, kernel, strides):
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple((p, p) if isinstance(p, int) else tuple(p)
                 for p in padding)


class Dense(Module):
    """y = x @ weight.T + bias; ``weight`` is (out, in).  With ``dtype`` set,
    input and parameters are cast to it for the contraction, as Flax's
    ``Dense(dtype=...)`` does."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_features))

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        with full_fp32():
            return F.linear(x, w, b)


class Embed(Module):
    """Token embedding with Flax's ``Embed`` semantics: ``forward`` looks
    rows up, ``attend`` contracts a query with the table (the tied LM
    head), both in ``dtype`` when it is set."""

    def __init__(self, num_embeddings: int, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        nn.init.normal_(self.embedding, std=1.0 / math.sqrt(features))

    def _table(self):
        e = self.embedding
        return e if self.dtype is None else e.to(self.dtype)

    def forward(self, tokens):
        return self._table()[tokens]

    def attend(self, query):
        table = self._table()
        with full_fp32():
            return torch.matmul(query.to(table.dtype), table.t())


class Conv(Module):
    """2-D convolution on NCHW inputs with an OIHW ``weight`` and Flax's
    padding specs."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides=1,
                 padding: PaddingLike = "SAME", use_bias: bool = True,
                 feature_group_count: int = 1):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = ((strides,) * 2 if isinstance(strides, int)
                        else tuple(strides))
        self.padding = padding
        self.use_bias = use_bias
        self.feature_group_count = feature_group_count
        fan_in = in_features // feature_group_count
        self.weight = nn.Parameter(
            torch.empty(features, fan_in, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(
            fan_in * math.prod(self.kernel_size)))

    def forward(self, x):
        (pt, pb), (pl, pr) = conv_padding(self.padding, x.shape[-2:],
                                          self.kernel_size, self.strides)
        with full_fp32():
            return F.conv2d(F.pad(x, (pl, pr, pt, pb)), self.weight,
                            self.bias, self.strides,
                            groups=self.feature_group_count)


class BatchNorm(Module):
    """Batch normalisation over the channel dim 1 with Flax's semantics:
    in training mode it normalises with the batch's biased variance, taken
    as Flax takes it, ``max(E[x^2] - E[x]^2, 0)``, and updates
    ``running_* = momentum * running_* + (1 - momentum) * batch``; in eval
    mode it uses the running statistics."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = tuple(i for i in range(x.ndim) if i != 1)
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)


class LayerNorm(Module):
    """Layer normalisation over the last dim with Flax's semantics and
    parameter names (``scale``, ``bias``): statistics in f32 at least, the
    variance taken as ``max(E[x^2] - E[x]^2, 0)`` (Flax's fast variance),
    ``y = (x - mean) * (rsqrt(var + epsilon) * scale) + bias``, and the
    result in ``dtype``, or else in the type of ``x`` and the parameters
    together."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 use_bias: bool = True, use_scale: bool = True, dtype=None):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.scale = nn.Parameter(torch.ones(features)) if use_scale \
            else None
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.epsilon)
        dtype = x.dtype
        if self.scale is not None:
            mul = mul * self.scale
            dtype = torch.promote_types(dtype, self.scale.dtype)
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias
            dtype = torch.promote_types(dtype, self.bias.dtype)
        return y.to(self.dtype or dtype)


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every Dense and Conv weight of ``module`` from ``generator``
    (normal, std 1/sqrt(fan_in)), so random models are reproducible."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Dense, Conv)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
    return module
