"""Identity (dense) codec, the reference's ``--code sgd`` path.

Counterpart of ``atomo_tpu/codecs/dense.py``: the payload is the float32
gradient itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch


class DensePayload(NamedTuple):
    values: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DenseCodec:
    name: str = "sgd"

    def leaf_payload_bytes(self, grad_shape: tuple[int, ...]) -> int:
        """Wire bytes of one leaf: its float32 values."""
        return 4 * math.prod(int(d) for d in grad_shape)

    def encode_stack(
        self, x: torch.Tensor, seeds: Sequence[int],
        uniforms: Optional[torch.Tensor] = None,
        *,
        shape: Optional[Sequence[int]] = None,
    ) -> DensePayload:
        del seeds, uniforms, shape
        return DensePayload(values=x.to(torch.float32))

    def decode_stack(self, payload: DensePayload, n: int, *,
                     shape: Optional[Sequence[int]] = None) -> torch.Tensor:
        del shape
        return payload.values.reshape(payload.values.shape[0], n)
