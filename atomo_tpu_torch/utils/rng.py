"""Integer keys for the port's random streams.

The JAX package splits and folds ``jax.random`` keys; torch has no such
keys, and its generators cannot reproduce threefry. The port keeps the same
discipline with plain 63-bit integers: :func:`fold_in` derives an independent
key from (key, data) with the SplitMix64 finaliser, and a key seeds either a
``torch.Generator`` or the Philox generator inside a CUDA kernel.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1
_MASK63 = (1 << 63) - 1


def _mix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and ``data``; fits a torch int64 (63 bits)."""
    return _mix64(_mix64(int(key) & _MASK64) ^ (int(data) & _MASK64)) & _MASK63


def split3(key: int) -> tuple[int, int, int]:
    """Three independent keys, the port's ``jax.random.split(key, 3)``."""
    return fold_in(key, 0), fold_in(key, 1), fold_in(key, 2)


def generator(key: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(key))
