"""Counter-based PRNG keys for stochastic rounding.

A key is a pair of uint32 words, the same data ``jax.random.key_data``
holds for a threefry key, so a stream derived here (``key``, ``fold_in``,
then :func:`fp8tpu_torch.numerics.cast.sr_bits`) is bit-equal to the JAX
package's stream from the same seed.  Keys are plain Python ints: folding
happens on the host, and only the final 32-bit salt reaches a kernel.
"""

from __future__ import annotations

from typing import Tuple

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


def key(seed: int) -> PRNGKey:
    """Key from a 32-bit integer seed (``jax.random.key(seed)``)."""
    return (0, int(seed) & _M32)


def fold_in(k: PRNGKey, data: int) -> PRNGKey:
    """Derive a new key from ``k`` and an integer (``jax.random.fold_in``)."""
    return _threefry2x32(k[0], k[1], 0, int(data) & _M32)


def salt_of(k: PRNGKey) -> int:
    """The 32-bit salt that seeds :func:`~fp8tpu_torch.numerics.cast.sr_bits`."""
    return ((k[0] * 0x9E3779B9) & _M32) ^ k[-1]
