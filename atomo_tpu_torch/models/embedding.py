"""Embedding tower: the row-sparse workload's model.

Counterpart of ``atomo_tpu/models/embedding.py``: a lookup table whose
per-step gradient touches only the rows the batch looked up, feeding a
small dense tower. The input is a (batch, slots) float32 tensor of row ids
(the zipf data, :mod:`atomo_tpu_torch.data.zipf`); the model casts it to
integers and looks rows up with ``F.embedding``, whose backward is a dense
scatter-add into the table, as ``jnp.take``'s is. Each sample touches at
most ``slots`` rows, the bound :func:`atomo_tpu_torch.sparse.infer_row_bounds`
turns into the lossless row budget.

The table is a parameter held on the model itself, named ``table`` as in
Flax (the hybrid planner's name hints match it); its leaf lies alike in
both packages (``convert.jax_layouts`` leaves it untransposed), and
``init_params`` draws it from ``normal(0.02)``, Flax's initializer here.
Flax infers the tower's input width at init; torch needs it up front, so
the model takes ``slots``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# float32 holds integers exactly only up to 2^24: a bigger table would
# silently alias row ids in the data pipeline's float batches
MAX_F32_EXACT_ROWS = 1 << 24
TABLE_INIT_STD = 0.02  # Flax's nn.initializers.normal(0.02)


class EmbeddingTower(nn.Module):
    """Table lookup -> concat -> Dense_0 (hidden, ReLU) -> Dense_1 (classes)."""

    def __init__(self, num_classes: int = 10, rows: int = 4096, dim: int = 16,
                 hidden: int = 64, slots: int = 8):
        super().__init__()
        if rows > MAX_F32_EXACT_ROWS:
            raise ValueError(
                f"EmbeddingTower rows={rows} exceeds 2^24: the "
                "float32 data pipeline cannot carry row ids exactly"
            )
        self.rows, self.dim = int(rows), int(dim)
        self.table = nn.Parameter(torch.empty(self.rows, self.dim))
        self.Dense_0 = nn.Linear(int(slots) * self.dim, hidden)
        self.Dense_1 = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (batch, slots) ids; a float32 id is exact below 2^24, and a
        # bfloat16 one (``--bf16`` casts floating inputs) below 2^8, as in
        # the JAX package, where a rounded id can reach ``rows``
        emb = _take_rows(self.table, x.to(torch.int64))
        h = F.relu(self.Dense_0(emb.reshape(emb.shape[0], -1)))
        return self.Dense_1(h)


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` with its default index mode: a
    negative id counts from the end, an id out of range gives a row of NaN
    (and no gradient). The lookup is ``F.embedding``, whose backward is the
    dense scatter-add."""
    rows = table.shape[0]
    idx = torch.where(idx < 0, idx + rows, idx)
    out_of_range = (idx < 0) | (idx >= rows)
    emb = F.embedding(idx.clamp(0, rows - 1), table)
    return torch.where(out_of_range[..., None], torch.full((), float("nan"), dtype=emb.dtype,
                                                           device=emb.device), emb)


def embedding_tower(num_classes: int = 10, image_shape=(8,), *, rows: int = 4096,
                    dim: int = 16) -> EmbeddingTower:
    """The registry's constructor: ``image_shape`` is the zipf spec's
    ``(slots,)`` (any shape: its size is the ids per sample)."""
    slots = 1
    for d in image_shape:
        slots *= int(d)
    return EmbeddingTower(num_classes=num_classes, rows=rows, dim=dim, slots=slots)
