"""AlexNet, NCHW.

Counterpart of ``atomo_tpu/models/alexnet.py`` (the torchvision 'one weird
trick' variant): five convs (11x11 stride 4 padded 2, 5x5 padded 2, three
3x3 padded 1) with three 3x3 stride-2 max pools (no padding), then the
classifier Dropout -> 4096 -> ReLU -> Dropout -> 4096 -> ReLU ->
num_classes. The features are flattened in the Flax (NHWC) order: at
224x224 they are 6x6x256, so ``Dense_0`` carried over from the JAX package
needs only a transpose. Inputs under 63x63 collapse the features to no
pixels and raise the JAX package's ``ValueError``; the model is sized for
``image_shape`` up front, so that happens at construction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from atomo_tpu_torch.models.dropout import Dropout
from atomo_tpu_torch.models.lenet import _flatten_nhwc


def _features_hw(h: int, w: int) -> tuple[int, int]:
    """The spatial size of the last feature map for an h x w input."""

    def conv(n, k, s, p):
        return (n + 2 * p - k) // s + 1

    def pool(n):
        return (n - 3) // 2 + 1 if n >= 3 else 0

    out = []
    for n in (h, w):
        n = pool(conv(n, 11, 4, 2))
        n = pool(conv(n, 5, 1, 2)) if n > 0 else 0
        out.append(pool(n) if n > 0 else 0)
    return out[0], out[1]


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000, image_shape=(224, 224, 3)):
        super().__init__()
        h, w, c = image_shape
        fh, fw = _features_hw(h, w)
        if fh <= 0 or fw <= 0:
            raise ValueError(
                f"AlexNet features collapsed to spatial size {(max(fh, 0), max(fw, 0))}; "
                "input must be >= 63x63 (224x224 canonical).")
        self.Conv_0 = nn.Conv2d(c, 64, 11, stride=4, padding=2)
        self.Conv_1 = nn.Conv2d(64, 192, 5, padding=2)
        self.Conv_2 = nn.Conv2d(192, 384, 3, padding=1)
        self.Conv_3 = nn.Conv2d(384, 256, 3, padding=1)
        self.Conv_4 = nn.Conv2d(256, 256, 3, padding=1)
        self.Dropout_0 = Dropout(0.5)
        self.Dense_0 = nn.Linear(fh * fw * 256, 4096)
        self.Dropout_1 = Dropout(0.5)
        self.Dense_1 = nn.Linear(4096, 4096)
        self.Dense_2 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 3, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 3, 2)
        x = F.relu(self.Conv_2(x))
        x = F.relu(self.Conv_3(x))
        x = F.max_pool2d(F.relu(self.Conv_4(x)), 3, 2)
        x = self.Dropout_0(_flatten_nhwc(x))
        x = self.Dropout_1(F.relu(self.Dense_0(x)))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


def alexnet(num_classes: int = 1000, image_shape=(224, 224, 3)) -> AlexNet:
    return AlexNet(num_classes, image_shape=image_shape)
