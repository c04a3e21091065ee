"""Datasets: MNIST / CIFAR-10 / CIFAR-100 / SVHN, from disk or synthesized.

The port's own copy of ``atomo_tpu/data/datasets.py`` (the JAX package's
module imports no JAX, but the port imports nothing of it). It is the same
numpy code, so :func:`synthetic_dataset` gives bit-identical data for the
same seed, and the on-disk parsers read the same files. Images stay NHWC
float32 in [0, 1] here, as in the JAX package; the trainer moves a batch to
NCHW on the device. "zipf" is the sparse workload's power-law row ids
(:mod:`atomo_tpu_torch.data.zipf`), synthetic by design: its arrays are
(n, slots) float32 ids, which the trainer hands to the model as they are.

Normalization constants are the reference's:
  MNIST  mean 0.1307 std 0.3081
  CIFAR  mean [125.3,123.0,113.9]/255, std [63.0,62.1,66.7]/255
  SVHN   ToTensor only (0-1 range)
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
import struct
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DatasetSpec:
    name: str
    image_shape: tuple[int, ...]  # H, W, C; (slots,) for zipf
    num_classes: int
    train_size: int
    test_size: int
    mean: tuple[float, ...]
    std: tuple[float, ...]


SPECS = {
    "mnist": DatasetSpec("mnist", (28, 28, 1), 10, 60000, 10000, (0.1307,), (0.3081,)),
    "cifar10": DatasetSpec(
        "cifar10", (32, 32, 3), 10, 50000, 10000,
        (125.3 / 255, 123.0 / 255, 113.9 / 255),
        (63.0 / 255, 62.1 / 255, 66.7 / 255),
    ),
    "cifar100": DatasetSpec(
        "cifar100", (32, 32, 3), 100, 50000, 10000,
        (125.3 / 255, 123.0 / 255, 113.9 / 255),
        (63.0 / 255, 62.1 / 255, 66.7 / 255),
    ),
    "svhn": DatasetSpec(
        "svhn", (32, 32, 3), 10, 73257, 26032, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    ),
    # data/zipf.py's defaults (a module-load import of zipf here would be
    # circular)
    "zipf": DatasetSpec("zipf", (8,), 10, 4096, 1024, (0.0,), (1.0,)),
}

# reference CLI spellings (distributed_nn.py --dataset choices)
_ALIASES = {"mnist": "mnist", "cifar10": "cifar10", "cifar100": "cifar100", "svhn": "svhn",
            "zipf": "zipf"}


def canonical_name(name: str) -> str:
    key = name.lower().replace("-", "")
    if key not in _ALIASES:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(SPECS)}")
    return _ALIASES[key]


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: images float32 NHWC in [0,1], int32 labels."""

    spec: DatasetSpec
    images: np.ndarray
    labels: np.ndarray
    synthetic: bool = False

    def __len__(self) -> int:
        return self.images.shape[0]

    def normalized(self) -> np.ndarray:
        mean = np.asarray(self.spec.mean, np.float32)
        std = np.asarray(self.spec.std, np.float32)
        return (self.images - mean) / std


# --------------------------------------------------------------- file parsers


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        _, dtype_code, ndim = magic
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: str, names: list[str]) -> Optional[str]:
    for n in names:
        for cand in (os.path.join(root, n), os.path.join(root, n + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def _load_mnist(root: str, train: bool) -> Optional[tuple[np.ndarray, np.ndarray]]:
    prefix = "train" if train else "t10k"
    img = _find(root, [f"{prefix}-images-idx3-ubyte", f"MNIST/raw/{prefix}-images-idx3-ubyte"])
    lbl = _find(root, [f"{prefix}-labels-idx1-ubyte", f"MNIST/raw/{prefix}-labels-idx1-ubyte"])
    if not img or not lbl:
        return None
    images = _read_idx(img).astype(np.float32)[..., None] / 255.0
    labels = _read_idx(lbl).astype(np.int32)
    return images, labels


def _load_cifar(root: str, train: bool, coarse100: bool) -> Optional[tuple[np.ndarray, np.ndarray]]:
    if coarse100:
        sub = _find(root, ["cifar-100-python/train" if train else "cifar-100-python/test",
                           "train" if train else "test"])
        files = [sub] if sub else []
        label_key = b"fine_labels"
    else:
        base = ["cifar-10-batches-py/", ""]
        names = (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        )
        files = []
        for n in names:
            f = _find(root, [b + n for b in base])
            if f:
                files.append(f)
        if len(files) != len(names):
            return None
        label_key = b"labels"
    if not files:
        return None
    xs, ys = [], []
    for f in files:
        with open(f, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[label_key]))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0, np.concatenate(ys).astype(np.int32)


def _load_svhn(root: str, train: bool) -> Optional[tuple[np.ndarray, np.ndarray]]:
    name = "train_32x32.mat" if train else "test_32x32.mat"
    path = _find(root, [name])
    if not path:
        return None
    try:
        from scipy import io as sio
    except ImportError:
        return None
    mat = sio.loadmat(path)
    x = mat["X"].transpose(3, 0, 1, 2).astype(np.float32) / 255.0
    y = mat["y"].reshape(-1).astype(np.int32)
    y[y == 10] = 0  # reference label remap (src/datasets.py:171-173)
    return x, y


# --------------------------------------------------------------- public API


def synthetic_dataset(spec: DatasetSpec, train: bool, size: Optional[int] = None, seed: int = 0) -> ArrayDataset:
    """Deterministic class-structured synthetic data.

    Images are class-dependent Gaussian blobs so that models can actually
    fit them (loss decreases, accuracy rises above chance) — making the
    end-to-end trainer testable offline. The zipf spec gives its power-law
    row ids instead (:func:`~atomo_tpu_torch.data.zipf.zipf_dataset`).
    """
    if spec.name == "zipf":
        from atomo_tpu_torch.data.zipf import zipf_dataset  # zipf imports this module

        return zipf_dataset(train, slots=int(spec.image_shape[0]),
                            num_classes=spec.num_classes, size=size, seed=seed)
    n = size or (spec.train_size if train else spec.test_size)
    n = min(n, 10000 if train else 2000) if size is None else n
    rng = np.random.RandomState(seed + (0 if train else 1))
    labels = rng.randint(0, spec.num_classes, size=n).astype(np.int32)
    h, w, c = spec.image_shape
    proto_rng = np.random.RandomState(12345)  # shared between train/test
    prototypes = proto_rng.rand(spec.num_classes, h, w, c).astype(np.float32)
    noise = rng.randn(n, h, w, c).astype(np.float32) * 0.15
    images = np.clip(prototypes[labels] + noise, 0.0, 1.0)
    return ArrayDataset(spec=spec, images=images, labels=labels, synthetic=True)


def load_dataset(
    name: str,
    root: str = "./data",
    train: bool = True,
    synthetic_fallback: bool = True,
    synthetic_size: Optional[int] = None,
) -> ArrayDataset:
    key = canonical_name(name)
    spec = SPECS[key]
    if key == "zipf":  # no on-disk format: synthetic by design
        return synthetic_dataset(spec, train, size=synthetic_size)
    loaded = None
    if os.path.isdir(root):
        if key == "mnist":
            loaded = _load_mnist(root, train)
        elif key == "cifar10":
            loaded = _load_cifar(root, train, coarse100=False)
        elif key == "cifar100":
            loaded = _load_cifar(root, train, coarse100=True)
        elif key == "svhn":
            loaded = _load_svhn(root, train)
    if loaded is not None:
        images, labels = loaded
        return ArrayDataset(spec=spec, images=images, labels=labels)
    if not synthetic_fallback:
        raise FileNotFoundError(f"{key} not found under {root!r} and synthetic_fallback=False")
    return synthetic_dataset(spec, train, size=synthetic_size)
