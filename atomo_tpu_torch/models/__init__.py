"""Model zoo of the port, name-dispatched like ``atomo_tpu.models``.

Ported so far: LeNet, FC and the ResNets; the rest of the JAX zoo (VGG,
AlexNet, DenseNet, the embedding tower, the transformer) comes with later
slices.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

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

_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "lenet": LeNet,
    "fc": FCNN,
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
    "resnet110": ResNet110,
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
