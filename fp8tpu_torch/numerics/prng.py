"""Counter-based PRNG keys for stochastic rounding.

A key is a pair of uint32 words, the same data ``jax.random.key_data``
holds for a threefry key, so a stream derived here (``key``, ``fold_in``,
then :func:`fp8tpu_torch.numerics.cast.sr_bits`) is bit-equal to the JAX
package's stream from the same seed.  Keys are plain Python ints: folding
happens on the host, and only the final 32-bit salt reaches a kernel.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

PRNGKey = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> PRNGKey:
    """Threefry-2x32 with 20 rounds on one counter pair."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_bits32(k: PRNGKey, n: int, device=None,
                    offset: int = 0,
                    index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` as int64 values: element ``i``
    hashes the 64-bit counter ``i`` as the word pair ``(i >> 32, i mod
    2^32)`` and xors the two output words (the partitionable layout,
    trap 24).  Counters of a row-major shape are its flat indices, so a
    draw of any shape is this stream reshaped; a uint16 draw keeps the
    LOW 16 bits of each word.  ``offset`` starts the counters there: the
    elements ``offset ..`` of a larger draw; ``index`` (int64, ``n``
    counters) gives each element's counter instead (a block of a larger
    draw that is not one range)."""
    if index is not None:
        i = index.to(device=device, dtype=torch.int64)
        n = i.numel()
    else:
        i = torch.arange(offset, offset + max(n, 1), dtype=torch.int64,
                         device=device)
    k0, k1 = k[0] & _M32, k[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = ((i >> 32) + ks[0]) & _M32
    x1 = ((i & _M32) + ks[1]) & _M32
    for r5 in range(5):
        for r in _ROT[r5 % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(r5 + 1) % 3]) & _M32
        x1 = (x1 + ks[(r5 + 2) % 3] + r5 + 1) & _M32
    return (x0 ^ x1)[:n]


def key(seed: int) -> PRNGKey:
    """Key from a 32-bit integer seed (``jax.random.key(seed)``)."""
    return (0, int(seed) & _M32)


def fold_in(k: PRNGKey, data: int) -> PRNGKey:
    """Derive a new key from ``k`` and an integer (``jax.random.fold_in``)."""
    return _threefry2x32(k[0], k[1], 0, int(data) & _M32)


def split(k: PRNGKey, num: int = 2) -> List[PRNGKey]:
    """``num`` keys from ``k`` (``jax.random.split``).  With
    ``jax_threefry_partitionable`` on (the default since jax 0.5) key ``i``
    hashes the 64-bit counter ``i`` as the word pair (0, i), which is the
    same word pair :func:`fold_in` hashes; the old layout hashed
    ``iota(2 num)`` instead."""
    return [_threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def _rem(a, b: int):
    return a % b if b else a       # XLA's unsigned remainder by zero


def randint(k: PRNGKey, minval: int, maxval: int, shape=(), device=None):
    """``jax.random.randint(k, shape, minval, maxval, jnp.int32)``: two
    32-bit draws of ``shape`` from the two halves of ``split(k)``, folded
    into the span with uint32 arithmetic (in int64 with masks).  The
    values come back as an int64 tensor of ``shape`` on ``device``, or as
    one Python int when ``shape`` is ``()``."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
    n = math.prod(shape)
    lo, hi = -2 ** 31, 2 ** 31 - 1
    out_of_range = maxval > hi
    minval, maxval = min(max(minval, lo), hi), min(max(maxval, lo), hi)
    k1, k2 = split(k)
    higher = threefry_bits32(k1, n, device)
    lower = threefry_bits32(k2, n, device)
    span = (maxval - minval) & _M32
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    mult = _rem(1 << 16, span)
    mult = _rem((mult * mult) & _M32, span)
    offset = (_rem(higher, span) * mult + _rem(lower, span)) & _M32
    out = (minval + _rem(offset, span)) & _M32
    out = torch.where(out > hi, out - 2 ** 32, out).reshape(shape)
    return int(out) if shape == () else out


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``fma(a, b, c)`` of f32 values, rounded once to f32 (XLA fuses the
    jitted ``floats * span + minval`` into one).  The product is exact in
    f64 and the sum is ``s + e`` exactly (TwoSum); rounding it to odd in
    f64 (``s``, or its odd neighbour toward ``e`` when ``e != 0`` and
    ``s`` is even) and then to f32 rounds the exact sum once, as f64 has
    more than 24 + 2 bits."""
    p = a.double() * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((e != 0) & even, torch.nextafter(s, s + e), s)
    return s.float()


def uniform(k: PRNGKey, shape=(), minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``: the
    top 23 bits of each 32-bit draw as the mantissa of a float in [1, 2),
    less 1, then ``fma(., maxval - minval, minval)`` and ``max(minval,
    .)``, in f32 as the jitted JAX function computes them."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
    bits = (threefry_bits32(k, math.prod(shape), device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = float(torch.tensor(minval, dtype=torch.float32))
    span = float(torch.tensor(maxval, dtype=torch.float32)
                 - torch.tensor(lo, dtype=torch.float32))
    out = floats if (lo, span) == (0.0, 1.0) else _fma_f32(floats, span, lo)
    return torch.clamp_min(out, lo).reshape(shape)


def salt_of(k: PRNGKey) -> int:
    """The 32-bit salt that seeds :func:`~fp8tpu_torch.numerics.cast.sr_bits`."""
    return ((k[0] * 0x9E3779B9) & _M32) ^ k[-1]


def permutation(k: PRNGKey, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(k, n)`` as int64: ``ceil(3 ln n / ln(2^32 -
    1))`` rounds of ``k, sub = split(k)`` and a *stable* sort of the
    elements by 32 bits of ``sub`` each (jax's ``_shuffle``).  The keys
    are int64 values of uint32 words (torch has no uint32 arithmetic), so
    the order, ties included, is the uint32 sort's."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(threefry_bits32(sub, n, device), stable=True
                           ).indices
        x = x[order]
    return x


def choice(k: PRNGKey, n: int, size: int, replace: bool = False,
           device=None) -> torch.Tensor:
    """``jax.random.choice(k, n, (size,), replace=False)``: the first
    ``size`` elements of :func:`permutation`."""
    if replace:
        raise NotImplementedError("choice with replacement is not ported")
    if size > n:
        raise ValueError(f"Cannot take a larger sample (size {size}) than "
                         f"population (size {n}) when 'replace=False'")
    return permutation(k, n, device)[:size]
