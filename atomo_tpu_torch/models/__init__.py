"""Model zoo of the port, name-dispatched like ``atomo_tpu.models``.

Every name of the JAX registry: the reference CLI's LeNet, FC, ResNet18/34,
DenseNet (BC-190, k = 40), VGG11 (vgg11_bn) and AlexNet, the JAX package's
superset (ResNet50/101/152/110, DenseNet100, VGG13/16/19 with BatchNorm and
the ``*_plain`` VGGs) and the embedding family (``embedding``, 4096 x 16;
``embedding_wide``, 65536 x 32; the CLI sizes ``embedding`` by
``--emb-rows``/``--emb-dim``). The transformer LM is built by the ``lm``
verb, not by name.
"""

from __future__ import annotations

import functools
from typing import Callable

from torch import nn

from atomo_tpu_torch.models.alexnet import AlexNet, alexnet  # noqa: F401
from atomo_tpu_torch.models.densenet import (  # noqa: F401
    DenseNet,
    densenet_bc_100,
    densenet_reference,
)
from atomo_tpu_torch.models.dropout import Dropout, dropout_stream  # noqa: F401
from atomo_tpu_torch.models.embedding import EmbeddingTower, embedding_tower  # noqa: F401
from atomo_tpu_torch.models.lenet import FCNN, LeNet  # noqa: F401
from atomo_tpu_torch.models.resnet import (  # noqa: F401
    BasicBlock,
    BatchNorm,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet110,
    ResNet152,
)
from atomo_tpu_torch.models.vgg import (  # noqa: F401
    VGG,
    vgg11,
    vgg11_bn,
    vgg13,
    vgg13_bn,
    vgg16,
    vgg16_bn,
    vgg19,
    vgg19_bn,
)

_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "lenet": LeNet,
    "fc": FCNN,
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "densenet": densenet_reference,
    "vgg11": vgg11_bn,  # the reference's VGG11 is vgg11_bn
    "alexnet": alexnet,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
    "resnet110": ResNet110,
    "densenet100": densenet_bc_100,
    "vgg11_plain": vgg11,
    "vgg13": vgg13_bn,
    "vgg16": vgg16_bn,
    "vgg19": vgg19_bn,
    "vgg13_plain": vgg13,
    "vgg16_plain": vgg16,
    "vgg19_plain": vgg19,
    "embedding": embedding_tower,
    "embedding_wide": functools.partial(embedding_tower, rows=65536, dim=32),
}


def get_model(name: str, num_classes: int = 10, image_shape=(28, 28, 1)) -> nn.Module:
    """Build a model by CLI name (case-insensitive) for inputs of
    ``image_shape`` (H, W, C), which Flax infers at init and torch needs up
    front."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown network {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](num_classes, image_shape=image_shape)


def model_names() -> list[str]:
    return sorted(_REGISTRY)
