"""CIFAR-style ResNets (18/34/50/101/152) and ResNet-110, NCHW.

Counterpart of ``atomo_tpu/models/resnet.py``. Submodules carry the Flax
auto-names (``Conv_0``, ``BatchNorm_1``, ``BasicBlock_3``, ...), so the
canonical leaf order and the weight conversion follow from the names
(:mod:`atomo_tpu_torch.convert`).

Layout: Flax runs NHWC with HWIO kernels, this port NCHW with OIHW. The 1x1
stride-2 shortcut has ``padding='SAME'`` in Flax, which is no padding on
even inputs; the 3x3 convs pad 1 on both. The global average pool is a mean
over H and W.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, its arithmetic
    written out.

    Flax takes the biased batch variance in one pass,
    ``max(mean(x^2) - mean(x)^2, 0)``, normalizes as
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` and differentiates
    through that. ``torch.nn.BatchNorm2d`` normalizes with a two-pass
    variance, has its own backward, and updates its running variance with
    the unbiased one. Where a channel's spread is small against its mean,
    which the synthetic data makes common, the two differ by percents in
    the gradient, so this module repeats Flax's formulas. ``weight`` and
    ``bias`` are Flax's ``scale`` and ``bias``; the buffers its ``mean`` and
    ``var``."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1, -1] + [1] * (x.dim() - 2)
        # statistics and normalization in float32 whatever the input's type,
        # as Flax's force_float32_reductions: in bfloat16 mean(x^2) -
        # mean(x)^2 cancels badly. The result takes the input's type.
        xf = x.float()
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            mean = xf.mean(dim=dims)
            var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv(in_planes, planes, 3, stride)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = _conv(planes, planes, 3)
        self.BatchNorm_1 = BatchNorm(planes)
        self.shortcut = stride != 1 or in_planes != planes
        if self.shortcut:
            self.Conv_2 = _conv(in_planes, planes, 1, stride)
            self.BatchNorm_2 = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        if self.shortcut:
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.Conv_0 = _conv(in_planes, planes, 1)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = _conv(planes, planes, 3, stride)
        self.BatchNorm_1 = BatchNorm(planes)
        self.Conv_2 = _conv(planes, out_planes, 1)
        self.BatchNorm_2 = BatchNorm(out_planes)
        self.shortcut = stride != 1 or in_planes != out_planes
        if self.shortcut:
            self.Conv_3 = _conv(in_planes, out_planes, 1, stride)
            self.BatchNorm_3 = BatchNorm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        if self.shortcut:
            x = self.BatchNorm_3(self.Conv_3(x))
        return F.relu(out + x)


class ResNet(nn.Module):
    """Stem conv + BN, stages of ``block``, global average pool, linear head.
    ``planes`` are the stage widths: (64, 128, 256, 512) for the 4-stage
    CIFAR ResNets, (16, 32, 64) for ResNet-110."""

    def __init__(self, block: type, num_blocks: Sequence[int], num_classes: int = 10,
                 planes: Sequence[int] = (64, 128, 256, 512), image_shape=(32, 32, 3)):
        super().__init__()
        self.Conv_0 = _conv(image_shape[2], planes[0], 3)
        self.BatchNorm_0 = BatchNorm(planes[0])
        width = planes[0]
        k = 0
        for stage, (p, n) in enumerate(zip(planes, num_blocks)):
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                self.add_module(f"{block.__name__}_{k}", block(width, p, stride))
                width = p * block.expansion
                k += 1
        self.n_blocks = k
        self.block_name = block.__name__
        self.Dense_0 = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        for k in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{k}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def ResNet18(num_classes: int = 10, image_shape=(32, 32, 3)) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, image_shape=image_shape)


def ResNet34(num_classes: int = 10, image_shape=(32, 32, 3)) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, image_shape=image_shape)


def ResNet50(num_classes: int = 10, image_shape=(32, 32, 3)) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, image_shape=image_shape)


def ResNet101(num_classes: int = 10, image_shape=(32, 32, 3)) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, image_shape=image_shape)


def ResNet152(num_classes: int = 10, image_shape=(32, 32, 3)) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, image_shape=image_shape)


def ResNet110(num_classes: int = 10, image_shape=(32, 32, 3)) -> ResNet:
    return ResNet(BasicBlock, (18, 18, 18), num_classes, planes=(16, 32, 64),
                  image_shape=image_shape)
