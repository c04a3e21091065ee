"""Input pipeline: host-side batching and on-device augmentation.

Counterpart of ``atomo_tpu/data/pipeline.py``. :class:`BatchIterator` is the
same numpy shuffle (``RandomState(seed)``), so the port and the JAX package
see the same batches in the same order; batches stay NHWC numpy arrays.
:func:`augment_batch` runs on the device on an NCHW tensor and draws crop
offsets and flips from an explicit ``torch.Generator`` (it cannot reproduce
``jax.random``'s draws; parity runs turn augmentation off); the draw
(:func:`augment_draws`) and the apply (:func:`augment_apply`) are separate
functions, so that a CUDA graph can apply draws made outside it. Batches of
row ids (zipf, (B, slots)) pass through unpermuted.

Superstep blocks (``--superstep K``): :class:`BlockStream` stacks K
consecutive batches of the stream into one (K, batch, ...) block, and
:class:`SuperstepFeed` stages the next block on the device behind the
running one (:func:`block_to_device`: pinned host memory, a
``non_blocking`` copy on a side stream, an event the compute stream waits
on before it reads the block).
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
    offsets, flips = augment_draws(images.shape[0], gen, images.device, pad)
    return augment_apply(images, offsets, flips, pad)


def augment_draws(n: int, gen: torch.Generator, device, pad: int = 4):
    """The crop offsets ((n, 2) int64, each in [0, 2 pad]) and flips ((n,)
    bool) of :func:`augment_batch`, drawn from ``gen`` in its order."""
    offsets = torch.randint(0, 2 * pad + 1, (n, 2), generator=gen, device=device)
    flips = torch.rand((n,), generator=gen, device=device) < 0.5
    return offsets, flips


def augment_apply(images: torch.Tensor, offsets: torch.Tensor, flips: torch.Tensor,
                  pad: int = 4) -> torch.Tensor:
    """:func:`augment_batch` with its draws given."""
    n, c, h, w = images.shape
    dev = images.device
    padded = F.pad(images, (pad, pad, pad, pad), mode="reflect")
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

    def snapshot_rng(self):
        """The shuffle RNG's state; take it right before the first
        :meth:`forever` call and hand it to :meth:`restream`."""
        return self._rng.get_state()

    def rng_signature(self) -> int:
        """A CRC32 fingerprint of the shuffle RNG's state (the JAX
        package's: two streams from one seed with one consumption history
        fingerprint alike)."""
        import zlib

        kind, keys, pos, has_gauss, cached = self._rng.get_state()
        h = zlib.crc32(f"{kind}:{pos}:{has_gauss}".encode())
        return zlib.crc32(np.asarray(keys).tobytes(), h)

    def restream(self, rng_state, skip: int = 0):
        """A fresh stream for an in-process rollback: the shuffle RNG
        restored to ``rng_state`` (:meth:`snapshot_rng`), ``skip`` batches
        skipped, so the replay is a restarted process's ``forever(skip)``
        batch for batch."""
        self._rng.set_state(rng_state)
        return self.forever(skip=skip)


def to_device(images: np.ndarray, labels: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An NHWC numpy batch as (NCHW float32, int64 labels) on ``device``; a
    batch of another rank (the (B, slots) row ids of zipf) goes as it is."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(device)
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(np.asarray(labels, dtype=np.int64)).to(device)
    return x, y


class BlockStream:
    """Stack consecutive batches of an endless stream into ``(K, batch,
    ...)`` superstep blocks (``atomo_tpu/data/pipeline.py:143``).

    Step t of a K-block is the batch a per-step loop would have fed at step
    t, so superstep runs replay (and resume) bit for bit against K = 1 runs.
    ``take(k)`` takes a different ``k`` each call: the loops shrink the last
    block to ``max_steps``."""

    def __init__(self, stream: Iterator[tuple[np.ndarray, np.ndarray]]):
        self._stream = stream

    def take(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        pairs = [next(self._stream) for _ in range(k)]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


class _Staged:
    """A block on the device and the event its copy recorded (None: it was
    made on the compute stream)."""

    def __init__(self, k: int, images, labels, ready=None):
        self.k, self.images, self.labels, self.ready = k, images, labels, ready


def block_to_device(images: np.ndarray, labels: np.ndarray, device) -> _Staged:
    """Stage a numpy (K, B, ...) block on ``device`` as (K, B, C, H, W)
    float32 images (row ids as they are) and (K, B) int64 labels, step k's
    images with the strides :func:`to_device` gives its batch (a size-1
    channel axis keeps the permute's stride), so that the convolutions pick
    the same algorithms. On CUDA the arrays go to pinned host memory and the
    copy (and the permute) runs ``non_blocking`` on a side stream, behind
    whatever the compute stream is running; the block carries the event the
    compute stream must wait on (:meth:`SuperstepFeed.take`)."""
    dev = torch.device(device)
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
    y = torch.from_numpy(np.asarray(labels, dtype=np.int64))

    def put(x, y):
        x = x.to(dev, non_blocking=True)
        if x.dim() == 5:
            x = x.permute(0, 1, 4, 2, 3).contiguous()
        return x, y.to(dev, non_blocking=True)

    if dev.type != "cuda":
        return _Staged(images.shape[0], *put(x, y))
    side = _side_stream(dev)  # its allocations come from its own pool
    with torch.cuda.stream(side):
        x, y = put(x.pin_memory(), y.pin_memory())
        ready = torch.cuda.Event()
        ready.record(side)
    compute = torch.cuda.current_stream(dev)
    x.record_stream(compute)  # made on the side stream, read on the compute one
    y.record_stream(compute)
    return _Staged(images.shape[0], x, y, ready)


_SIDE: dict = {}


def _side_stream(dev: torch.device):
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    return _SIDE[dev]


class SuperstepFeed:
    """One-block device lookahead over a :class:`BlockStream`
    (``atomo_tpu/data/pipeline.py:165``). ``start(k)`` stacks the next k
    batches and hands them to ``put_fn`` (:func:`block_to_device`, or a
    rank's shard of it) at once; called right after a block is launched,
    the next block's copy runs behind it. ``take()`` returns the staged
    block as ``(k, images, labels)``, after making the current stream wait
    for its copy."""

    def __init__(self, blocks: BlockStream, put_fn):
        self._blocks = blocks
        self._put = put_fn
        self._staged = None

    def start(self, k: int) -> None:
        if k > 0:
            self._staged = self._put(*self._blocks.take(k))

    def drop(self) -> int:
        """Discard the staged block (a rollback: it belongs to the timeline
        just abandoned); returns its step count (0 when none was staged)."""
        staged, self._staged = self._staged, None
        if staged is not None and staged.ready is not None:
            staged.ready.synchronize()  # its copy is done before the memory goes
        return 0 if staged is None else staged.k

    def take(self):
        staged, self._staged = self._staged, None
        if staged.ready is not None:
            torch.cuda.current_stream(staged.images.device).wait_event(staged.ready)
        return staged.k, staged.images, staged.labels
