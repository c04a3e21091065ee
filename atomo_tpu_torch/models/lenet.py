"""LeNet and FC_NN, the reference's small MNIST nets, NCHW.

Counterpart of ``atomo_tpu/models/lenet.py``. Activations are flattened in
the Flax (NHWC) order before the dense layers, so a Dense kernel carried over
from the JAX package needs only a transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class LeNet(nn.Module):
    """conv(1->20, k5) -> maxpool2 -> relu -> conv(20->50, k5) -> maxpool2 ->
    relu -> fc 500 -> fc 10 (pooling before relu, as the reference)."""

    def __init__(self, num_classes: int = 10, image_shape=(28, 28, 1)):
        super().__init__()
        h, w, c = image_shape
        flat = ((h - 4) // 2 - 4) // 2 * (((w - 4) // 2 - 4) // 2) * 50
        self.Conv_0 = nn.Conv2d(c, 20, 5)
        self.Conv_1 = nn.Conv2d(20, 50, 5)
        self.Dense_0 = nn.Linear(flat, 500)
        self.Dense_1 = nn.Linear(500, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(F.max_pool2d(self.Conv_0(x), 2))
        x = F.relu(F.max_pool2d(self.Conv_1(x), 2))
        return self.Dense_1(self.Dense_0(_flatten_nhwc(x)))


class FCNN(nn.Module):
    """784 -> 800 -> 500 -> 10, relu/relu/sigmoid (the reference's quirk)."""

    def __init__(self, num_classes: int = 10, image_shape=(28, 28, 1)):
        super().__init__()
        h, w, c = image_shape
        self.Dense_0 = nn.Linear(h * w * c, 800)
        self.Dense_1 = nn.Linear(800, 500)
        self.Dense_2 = nn.Linear(500, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _flatten_nhwc(x)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return torch.sigmoid(self.Dense_2(x))
