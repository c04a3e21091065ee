"""Seeded power-law (Zipf) row-access sampler: the sparse workload's data.

The port's own copy of ``atomo_tpu/data/zipf.py`` (numpy only, as there):
:func:`zipf_dataset` draws a ``(size, slots)`` float32 array of row ids from
``p_i ∝ 1/(i+1)^alpha`` with ``RandomState(seed + (0 | 1)).choice``, the same
calls as the JAX package's, so the two packages' arrays are equal bit for
bit. The ids ride :class:`~atomo_tpu_torch.data.pipeline.BatchIterator`
(identity normalization: ``normalized()`` returns them exactly, which holds
for any table of at most 2^24 rows), so ``forever(skip=...)`` replays them
as it replays images. Labels are ``first-row id mod num_classes``: the
tower has real signal to fit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from atomo_tpu_torch.data.datasets import ArrayDataset, DatasetSpec

ZIPF_ROWS = 4096
ZIPF_SLOTS = 8
ZIPF_ALPHA = 1.1
ZIPF_TRAIN_SIZE = 4096
ZIPF_TEST_SIZE = 1024
ZIPF_CLASSES = 10


def zipf_spec(slots: int = ZIPF_SLOTS, num_classes: int = ZIPF_CLASSES) -> DatasetSpec:
    """The zipf spec: ``image_shape`` is ``(slots,)`` and the normalization
    the identity, so ``normalized()`` gives the float row ids unchanged."""
    return DatasetSpec(
        name="zipf", image_shape=(int(slots),), num_classes=int(num_classes),
        train_size=ZIPF_TRAIN_SIZE, test_size=ZIPF_TEST_SIZE, mean=(0.0,), std=(1.0,),
    )


def zipf_probs(rows: int, alpha: float = ZIPF_ALPHA) -> np.ndarray:
    """``p_i ∝ 1/(i+1)^alpha`` over ``rows`` ids, normalized in float64."""
    w = 1.0 / np.power(np.arange(1, int(rows) + 1, dtype=np.float64), alpha)
    return w / w.sum()


def zipf_dataset(
    train: bool = True,
    *,
    rows: int = ZIPF_ROWS,
    slots: int = ZIPF_SLOTS,
    alpha: float = ZIPF_ALPHA,
    num_classes: int = ZIPF_CLASSES,
    size: Optional[int] = None,
    seed: int = 0,
) -> ArrayDataset:
    """Deterministic power-law row-access dataset: the same ``(seed, rows,
    slots, alpha, size)`` give the same arrays; train and test draw from
    seeds ``seed`` and ``seed + 1``."""
    if rows > (1 << 24):
        raise ValueError(
            f"zipf rows={rows} exceeds 2^24: float32 batches could not "
            "carry the row ids exactly"
        )
    spec = zipf_spec(slots=slots, num_classes=num_classes)
    n = int(size) if size is not None else (spec.train_size if train else spec.test_size)
    rng = np.random.RandomState(seed + (0 if train else 1))
    ids = rng.choice(int(rows), size=(n, int(slots)), p=zipf_probs(rows, alpha)).astype(
        np.float32)
    labels = (ids[:, 0].astype(np.int64) % num_classes).astype(np.int32)
    return ArrayDataset(spec=spec, images=ids, labels=labels, synthetic=True)
