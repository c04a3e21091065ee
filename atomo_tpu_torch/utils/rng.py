"""Integer keys for the port's random streams.

The JAX package splits and folds ``jax.random`` keys; torch has no such
keys, and its generators cannot reproduce threefry. The port keeps the same
discipline with plain 63-bit integers: :func:`fold_in` derives an independent
key from (key, data) with the SplitMix64 finaliser, and a key seeds either a
``torch.Generator`` or the Philox generator inside a CUDA kernel, which
can also take the key from device memory and fold the leaf index in itself
(:class:`FoldedSeeds`).
"""

from __future__ import annotations

from collections.abc import Sequence

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


class FoldedSeeds(Sequence):
    """The leaf seeds ``fold_in(key, i)`` for ``i`` in ``idxs``, with ``key``
    a 0-d int64 tensor: the device form of a step's codec seeds. A CUDA
    graph replays one captured step, so a key that changes from step to
    step cannot ride a launch's arguments; the QSGD encode kernel reads
    ``key`` from device memory and folds each leaf's index in itself
    (``csrc/qsgd_kernels.cu fold_in``). Indexing gives the ints (a host read
    of ``key``), for the plain versions on the CPU."""

    def __init__(self, key: torch.Tensor, idxs: Sequence[int]):
        if key.dim() != 0 or key.dtype != torch.int64:
            raise ValueError(f"key must be a 0-d int64 tensor, got {key.dtype} "
                             f"{tuple(key.shape)}")
        self.key = key
        self.idxs = tuple(int(i) for i in idxs)

    def __len__(self) -> int:
        return len(self.idxs)

    def __getitem__(self, j: int) -> int:
        return fold_in(int(self.key), self.idxs[j])

    def subset(self, positions: Sequence[int]) -> "FoldedSeeds":
        return FoldedSeeds(self.key, [self.idxs[p] for p in positions])
