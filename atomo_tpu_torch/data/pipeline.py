"""Input pipeline: host-side batching and on-device augmentation.

Counterpart of ``atomo_tpu/data/pipeline.py``. :class:`BatchIterator` is the
same numpy shuffle (``RandomState(seed)``), so the port and the JAX package
see the same batches in the same order; batches stay NHWC numpy arrays.
:func:`augment_batch` runs on the device on an NCHW tensor and draws crop
offsets and flips from an explicit ``torch.Generator`` (it cannot reproduce
``jax.random``'s draws; parity runs turn augmentation off). Batches of
row ids (zipf, (B, slots)) pass through unpermuted.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from atomo_tpu_torch.data.datasets import ArrayDataset


def augment_batch(images: torch.Tensor, gen: torch.Generator, pad: int = 4) -> torch.Tensor:
    """Pad-reflect -> per-image random crop -> random horizontal flip, on an
    (N, C, H, W) batch."""
    n, c, h, w = images.shape
    dev = images.device
    padded = F.pad(images, (pad, pad, pad, pad), mode="reflect")
    offsets = torch.randint(0, 2 * pad + 1, (n, 2), generator=gen, device=dev)
    flips = torch.rand((n,), generator=gen, device=dev) < 0.5
    rows = offsets[:, :1] + torch.arange(h, device=dev)
    cols = offsets[:, 1:] + torch.arange(w, device=dev)
    cols = torch.where(flips[:, None], cols.flip(1), cols)
    idx_n = torch.arange(n, device=dev)[:, None, None, None]
    idx_c = torch.arange(c, device=dev)[None, :, None, None]
    return padded[idx_n, idx_c, rows[:, None, :, None], cols[:, None, None, :]]


class BatchIterator:
    """Epoch-shuffled batch stream over an in-memory dataset."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self.images = dataset.normalized()
        self.labels = dataset.labels

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_sels(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield idx[s : s + self.batch_size]

    def epoch(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for sel in self._epoch_sels():
            yield self.images[sel], self.labels[sel]

    def forever(self, skip: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Endless epoch stream. ``skip`` discards that many leading batches
        without materialising them (index stream only) while consuming the
        same shuffle draws: a resumed run's batches line up with those of
        the run it continues, at one index shuffle per skipped epoch."""
        while True:
            for sel in self._epoch_sels():
                if skip > 0:
                    skip -= 1
                    continue
                yield self.images[sel], self.labels[sel]


def to_device(images: np.ndarray, labels: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An NHWC numpy batch as (NCHW float32, int64 labels) on ``device``; a
    batch of another rank (the (B, slots) row ids of zipf) goes as it is."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(device)
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(np.asarray(labels, dtype=np.int64)).to(device)
    return x, y
