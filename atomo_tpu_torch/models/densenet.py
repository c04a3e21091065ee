"""DenseNet-BC for CIFAR, NCHW.

Counterpart of ``atomo_tpu/models/densenet.py``: pre-activation dense
layers (BN-ReLU-Conv1x1(4k)-BN-ReLU-Conv3x3(k) with the bottleneck,
BN-ReLU-Conv3x3(k) without), each concatenating its k new channels to its
input on the channel axis; three dense blocks of (depth - 4) / 3 layers
(halved with the bottleneck), the first two followed by a transition
BN-ReLU-Conv1x1(floor(c * reduction))-AvgPool2; then BN-ReLU, the mean over
H and W and a linear head. It returns logits, as the JAX package does (the
reference applies ``log_softmax`` before its cross-entropy loss).

Flax's ``@nn.compact`` closures name the submodules flat, by type, in call
order: the stem ``Conv_0``, then per bottleneck layer ``BatchNorm_i,
Conv_j, BatchNorm_i+1, Conv_j+1``, and so on. This module registers them
under exactly those names on itself: the canonical leaf order sorts the
names as strings (``BatchNorm_10`` before ``BatchNorm_2``) and the codecs
key leaf ``i`` by ``fold_in(key, i)``, so another name would be another
key. Convs have no bias and initialise with Flax's defaults.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from atomo_tpu_torch.models.resnet import BatchNorm


class DenseNet(nn.Module):
    def __init__(self, growth_rate: int = 12, depth: int = 100, reduction: float = 0.5,
                 num_classes: int = 10, bottleneck: bool = True, image_shape=(32, 32, 3)):
        super().__init__()
        k = growth_rate
        n_layers = (depth - 4) // 3
        if bottleneck:
            n_layers //= 2
        self.counts = {"Conv": 0, "BatchNorm": 0}
        # the forward as a program over the registered names:
        # ("layer", bn names, conv names) / ("transition", bn, conv)
        self.program: list[tuple] = []
        channels = 2 * k
        self.stem = self._add("Conv", nn.Conv2d(image_shape[2], channels, 3, padding=1,
                                                bias=False))
        c = channels
        for block in range(3):
            for _ in range(n_layers):
                bns, convs = [self._add("BatchNorm", BatchNorm(c))], []
                cin = c
                if bottleneck:
                    convs.append(self._add("Conv", nn.Conv2d(c, 4 * k, 1, bias=False)))
                    bns.append(self._add("BatchNorm", BatchNorm(4 * k)))
                    cin = 4 * k
                convs.append(self._add("Conv", nn.Conv2d(cin, k, 3, padding=1, bias=False)))
                self.program.append(("layer", bns, convs))
                c += k
            channels += n_layers * k
            if block < 2:
                channels = int(math.floor(channels * reduction))
                bn = self._add("BatchNorm", BatchNorm(c))
                conv = self._add("Conv", nn.Conv2d(c, channels, 1, bias=False))
                self.program.append(("transition", [bn], [conv]))
                c = channels
        self.final_bn = self._add("BatchNorm", BatchNorm(c))
        self.Dense_0 = nn.Linear(c, num_classes)

    def _add(self, kind: str, module: nn.Module) -> str:
        name = f"{kind}_{self.counts[kind]}"
        self.counts[kind] += 1
        self.add_module(name, module)
        return name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._modules
        x = m[self.stem](x)
        for kind, bns, convs in self.program:
            if kind == "transition":
                out = m[convs[0]](F.relu(m[bns[0]](x)))
                x = F.avg_pool2d(out, 2)
                continue
            out = x
            for bn, conv in zip(bns, convs):
                out = m[conv](F.relu(m[bn](out)))
            x = torch.cat([x, out], dim=1)
        x = F.relu(m[self.final_bn](x))
        return self.Dense_0(x.mean(dim=(2, 3)))


def densenet_bc_100(num_classes: int = 10, image_shape=(32, 32, 3)) -> DenseNet:
    return DenseNet(growth_rate=12, depth=100, num_classes=num_classes, image_shape=image_shape)


def densenet_reference(num_classes: int = 10, image_shape=(32, 32, 3)) -> DenseNet:
    """The reference CLI's DenseNet-BC-190, k = 40."""
    return DenseNet(growth_rate=40, depth=190, reduction=0.5, num_classes=num_classes,
                    image_shape=image_shape)
