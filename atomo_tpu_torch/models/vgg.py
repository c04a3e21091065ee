"""CIFAR VGG 11/13/16/19, with and without BatchNorm, NCHW.

Counterpart of ``atomo_tpu/models/vgg.py``: feature configs A/B/D/E (3x3
convs padded 1, ``'M'`` a 2x2 max pool), then the classifier Dropout -> 512
-> ReLU -> Dropout -> 512 -> ReLU -> num_classes. Submodules carry the Flax
auto-names in creation order (``Conv_0..``, ``BatchNorm_0..``, ``Dense_0..2``)
so that :mod:`atomo_tpu_torch.convert` derives the Flax tree from them. The
features are flattened in the Flax (NHWC) order before ``Dense_0``. The
convs initialise as the JAX package's, He-normal over the fan-out
(``variance_scaling(2, fan_out, truncated normal)``), the Dense layers with
Flax's defaults.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from atomo_tpu_torch.models.dropout import Dropout
from atomo_tpu_torch.models.lenet import _flatten_nhwc
from atomo_tpu_torch.models.resnet import BatchNorm

CFGS: dict[str, list] = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512,
          "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512,
          512, 512, 512, "M"],
}


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[Union[int, str]], batch_norm: bool = False,
                 num_classes: int = 10, image_shape=(32, 32, 3)):
        super().__init__()
        h, w, c = image_shape
        self.cfg = tuple(cfg)
        self.batch_norm = batch_norm
        n_conv = 0
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            conv = nn.Conv2d(c, int(v), 3, padding=1)
            conv.variance_scaling = (2.0, "fan_out")  # read by trainer.init_params
            self.add_module(f"Conv_{n_conv}", conv)
            if batch_norm:
                self.add_module(f"BatchNorm_{n_conv}", BatchNorm(int(v)))
            c = int(v)
            n_conv += 1
        self.n_conv = n_conv
        self.Dropout_0 = Dropout(0.5)
        self.Dense_0 = nn.Linear(h * w * c, 512)
        self.Dropout_1 = Dropout(0.5)
        self.Dense_1 = nn.Linear(512, 512)
        self.Dense_2 = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2)
                continue
            x = getattr(self, f"Conv_{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = F.relu(x)
            i += 1
        x = self.Dropout_0(_flatten_nhwc(x))
        x = self.Dropout_1(F.relu(self.Dense_0(x)))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


def _vgg(cfg: str, bn: bool, num_classes: int, image_shape) -> VGG:
    return VGG(CFGS[cfg], batch_norm=bn, num_classes=num_classes, image_shape=image_shape)


def vgg11(num_classes: int = 10, image_shape=(32, 32, 3)) -> VGG:
    return _vgg("A", False, num_classes, image_shape)


def vgg11_bn(num_classes: int = 10, image_shape=(32, 32, 3)) -> VGG:
    return _vgg("A", True, num_classes, image_shape)


def vgg13(num_classes: int = 10, image_shape=(32, 32, 3)) -> VGG:
    return _vgg("B", False, num_classes, image_shape)


def vgg13_bn(num_classes: int = 10, image_shape=(32, 32, 3)) -> VGG:
    return _vgg("B", True, num_classes, image_shape)


def vgg16(num_classes: int = 10, image_shape=(32, 32, 3)) -> VGG:
    return _vgg("D", False, num_classes, image_shape)


def vgg16_bn(num_classes: int = 10, image_shape=(32, 32, 3)) -> VGG:
    return _vgg("D", True, num_classes, image_shape)


def vgg19(num_classes: int = 10, image_shape=(32, 32, 3)) -> VGG:
    return _vgg("E", False, num_classes, image_shape)


def vgg19_bn(num_classes: int = 10, image_shape=(32, 32, 3)) -> VGG:
    return _vgg("E", True, num_classes, image_shape)
