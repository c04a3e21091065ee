"""The port's zipf data (``atomo_tpu_torch/data/zipf.py``) against the JAX package.

The sampler is the same numpy calls in both packages, so the arrays must be
equal bit for bit (tolerance: none). The ids ride the port's
``BatchIterator`` and ``to_device`` as 2-D (B, slots) batches, unpermuted.
"""

import numpy as np
import pytest

from atomo_tpu.data import BatchIterator as JaxBatchIterator
from atomo_tpu.data import SPECS as JAX_SPECS
from atomo_tpu.data import load_dataset as jax_load_dataset
from atomo_tpu.data import zipf_dataset as jax_zipf_dataset
from atomo_tpu.data.zipf import zipf_probs as jax_zipf_probs
from atomo_tpu.data.zipf import zipf_spec as jax_zipf_spec
from atomo_tpu_torch.data import (
    SPECS,
    BatchIterator,
    canonical_name,
    load_dataset,
    synthetic_dataset,
    to_device,
    zipf_dataset,
    zipf_probs,
    zipf_spec,
)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(rows=65536, slots=4, alpha=1.3, seed=5, size=300),
    dict(rows=97, slots=12, alpha=0.8, num_classes=7, seed=2, size=50),
])
def test_zipf_arrays_equal_jax_bit_for_bit(train, kw):
    got, want = zipf_dataset(train, **kw), jax_zipf_dataset(train, **kw)
    assert got.images.dtype == want.images.dtype == np.float32
    assert got.images.tobytes() == want.images.tobytes()
    assert got.labels.dtype == want.labels.dtype
    assert got.labels.tobytes() == want.labels.tobytes()
    np.testing.assert_array_equal(got.normalized(), want.normalized())
    assert got.normalized().tobytes() == got.images.tobytes()  # identity normalization


def test_zipf_spec_and_probs_match_jax():
    for slots, classes in ((8, 10), (3, 5)):
        a, b = zipf_spec(slots, classes), jax_zipf_spec(slots, classes)
        assert (a.name, tuple(a.image_shape), a.num_classes, a.train_size, a.test_size,
                a.mean, a.std) == (b.name, tuple(b.image_shape), b.num_classes,
                                   b.train_size, b.test_size, b.mean, b.std)
    assert zipf_probs(4096, 1.1).tobytes() == jax_zipf_probs(4096, 1.1).tobytes()
    spec, jspec = SPECS["zipf"], JAX_SPECS["zipf"]
    assert tuple(spec.image_shape) == tuple(jspec.image_shape) == (8,)
    assert canonical_name("Zipf") == "zipf"
    # the registry entry points hand back the same deterministic stream
    for train in (True, False):
        a, b = load_dataset("zipf", train=train), jax_load_dataset("zipf", train=train)
        assert a.images.tobytes() == b.images.tobytes()
        assert synthetic_dataset(spec, train, size=40).images.tobytes() == \
            jax_zipf_dataset(train, size=40).images.tobytes()


def test_zipf_rows_above_2_24_raise_in_both_packages():
    for fn in (zipf_dataset, jax_zipf_dataset):
        with pytest.raises(ValueError, match="exceeds 2\\^24"):
            fn(True, rows=(1 << 24) + 1, size=4)


def test_zipf_batches_and_forever_skip_replay_match_jax():
    """The same shuffled 2-D batches in both packages, and ``forever(skip)``
    lines a resumed stream up with the straight one."""
    ds = zipf_dataset(True, size=96, seed=3)
    jds = jax_zipf_dataset(True, size=96, seed=3)
    a = BatchIterator(ds, 16, seed=4).forever()
    b = JaxBatchIterator(jds, 16, seed=4).forever()
    straight = [next(a) for _ in range(9)]  # across an epoch boundary (6 a epoch)
    for x, y in straight:
        jx, jy = next(b)
        assert x.shape == (16, 8) and x.tobytes() == np.asarray(jx).tobytes()
        assert y.tobytes() == np.asarray(jy).tobytes()
    resumed = BatchIterator(ds, 16, seed=4).forever(skip=5)
    for x, y in straight[5:]:
        rx, ry = next(resumed)
        assert rx.tobytes() == x.tobytes() and ry.tobytes() == y.tobytes()


def test_to_device_passes_id_batches_unpermuted():
    ds = zipf_dataset(True, size=8)
    x, y = to_device(ds.images, ds.labels, "cpu")
    assert tuple(x.shape) == (8, 8) and str(x.dtype) == "torch.float32"
    assert x.numpy().tobytes() == ds.images.tobytes()
    np.testing.assert_array_equal(y.numpy(), ds.labels.astype(np.int64))
    img = np.random.default_rng(0).random((2, 4, 5, 3), dtype=np.float32)
    xi, _ = to_device(img, np.zeros(2, np.int32), "cpu")
    assert tuple(xi.shape) == (2, 3, 4, 5)  # NHWC batches still become NCHW


def test_zipf_is_power_law_sparse():
    ds = zipf_dataset(True)
    ids = ds.images.astype(np.int64)
    counts = np.bincount(ids.ravel(), minlength=4096)
    assert counts[0] > counts[10] > counts[1000]
    # a batch of 32 x 8 lookups touches a few percent of the rows
    assert len(np.unique(ids[:32])) / 4096 < 0.1
