"""Lossless sparse-row codec: (row-index, row-value) pairs on the wire.

Counterpart of ``atomo_tpu/sparse/rowcodec.py``. An embedding table's
gradient is row-sparse: a step touches only the rows its batch looked up.
The codec ships those rows and nothing else:

* static shapes: the payload holds a fixed ``max_rows`` budget, so every
  size is known before the step and the encode needs no host sync. The
  nonzero rows are selected in ascending order by one sort of a two-band
  key (nonzero row i -> i, empty row i -> R + i), the JAX package's
  selection;
* lossless: padding slots point at row 0 with exact zeros, and the decode
  is a scatter-ADD (``index_add_``) into zeros, so ``decode(encode(g)) ==
  g`` exactly whenever the nonzero rows fit the budget (signed zeros come
  back as +0.0: ``-0.0 + 0.0 = +0.0``, as in the JAX package). The rows of
  one payload are distinct, so the scatter has no two values for one row
  but the exact zeros of padding;
* honest overflow: a gradient with more nonzero rows than the budget keeps
  the first ``max_rows`` of them and counts the rest in ``overflow``.

The mean over replicas (:meth:`RowCodec.decode_mean`) decodes each
replica's payload into its own dense table and sums the decodes in replica
order, then divides: the order of ``ops.qsgd_kernels.replica_mean`` and of
the JAX package's ``jnp.mean(vmap(decode)(gathered), 0)``. It is never one
scatter of every replica into one table, whose atomic adds would sum
duplicate rows in no fixed order.

Wire bytes: ``max_rows x (ncols x itemsize + 4) + 4``
(:func:`row_payload_bytes`), which the hybrid plan prices leaves with.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch


class RowPayload(NamedTuple):
    rows: torch.Tensor  # (max_rows,) int32 row indices; padding slots 0
    values: torch.Tensor  # (max_rows, ncols) row values; padding slots 0.0
    overflow: torch.Tensor  # () int32: nonzero rows dropped (budget exceeded)


def row_payload_bytes(max_rows: int, ncols: int, itemsize: int = 4) -> int:
    """Wire bytes of one :class:`RowPayload`: values, int32 indices and the
    int32 overflow counter."""
    return int(max_rows) * (int(ncols) * int(itemsize) + 4) + 4


@dataclasses.dataclass(frozen=True)
class RowCodec:
    """The sparse-row wire format over one 2-D ``(rows, ncols)`` leaf with a
    static per-step budget of ``max_rows`` rows."""

    max_rows: int

    def encode(self, seed: int, grad: torch.Tensor) -> RowPayload:
        """The first ``max_rows`` nonzero rows of ``grad`` in ascending order
        (``seed`` is unused: nothing is sampled)."""
        del seed
        if grad.dim() != 2:
            raise ValueError(
                f"RowCodec encodes 2-D (rows, ncols) leaves; got shape "
                f"{tuple(grad.shape)} — the hybrid plan assigns only "
                "row-sparse table leaves here"
            )
        n_rows = grad.shape[0]
        k = min(int(self.max_rows), int(n_rows))
        nz = (grad != 0).any(dim=1)
        idx = torch.arange(n_rows, device=grad.device, dtype=torch.int32)
        # the two-band key: nonzero rows first, each band ascending
        order = torch.argsort(torch.where(nz, idx, idx + n_rows))
        sel = order[:k]
        live = nz[sel]
        rows = torch.where(live, sel, torch.zeros_like(sel)).to(torch.int32)
        values = torch.where(live[:, None], grad[sel], torch.zeros((), dtype=grad.dtype,
                                                                   device=grad.device))
        overflow = (nz.sum(dtype=torch.int32) - live.sum(dtype=torch.int32)).to(torch.int32)
        return RowPayload(rows=rows, values=values, overflow=overflow)

    def decode(self, payload: RowPayload, grad_shape: Sequence[int],
               dtype=torch.float32) -> torch.Tensor:
        """The dense table: zeros, with each payload row added at its index."""
        out = torch.zeros(tuple(grad_shape), dtype=dtype, device=payload.values.device)
        return out.index_add_(0, payload.rows.to(torch.int64), payload.values.to(dtype))

    def decode_mean(self, gathered: RowPayload, grad_shape: Sequence[int], n_replicas: int,
                    dtype=torch.float32) -> torch.Tensor:
        """Mean of the decodes of a gathered payload (each field with a
        leading replica axis of ``n_replicas``): replica r's payload decoded
        into its own table, the tables summed in order 0..N-1, then divided
        by N (one replica is its own decode). Holds two tables at a time."""
        acc = None
        for r in range(n_replicas):
            dec = self.decode(RowPayload(*(f[r] for f in gathered)), grad_shape, dtype)
            acc = dec if acc is None else acc.add_(dec)
        if n_replicas == 1:
            return acc
        # a tensor divisor: on CUDA a Python scalar divisor is a product with
        # its reciprocal, which is not the division for every N
        return acc / torch.full_like(acc, n_replicas)
