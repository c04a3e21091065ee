"""The survivor-exact mean over a gathered roster.

Counterpart of the device half of ``atomo_tpu/elastic/shrink.py``
(``:102-167``). The guard's historical rescale (the masked mean over N,
then times N/kept) rounds twice; this operator is the one-division
statement of "the mean over the surviving roster": absent replicas masked
(``where``, never a product: NaN times 0 is NaN), every replica decoded
alone, the decodes summed in roster order from replica 0 on, one division
by max(kept, 1). A masked replica decodes to exact zeros and ``x + 0.0``
is exact, so the N-row fold gives the bits of the fold over the survivors
alone.

On the card QSGD's fused path is one launch of row 2 in its survivor mode
over the gathered buffer read in place (``ops.qsgd_kernels.
unpack_dequantize_tree(survivor=True)``: the kernel counts the flags and
divides by max(kept, 1), and never reads a flagged-out replica's bytes);
on the CPU its plain twin. SVD and QSGD's pack path decode each replica
with the codec's canonical decode, fold and divide once; the fused SVD
mean is not used here, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from atomo_tpu_torch.codecs.base import decode_mean_tree, mask_gathered


def mask_absent(gathered: Sequence, okg: torch.Tensor) -> list:
    """The gathered payloads (each field with a leading replica axis) with
    every field of a replica whose flag in ``okg`` is not above 0 zeroed:
    the guard's masking (:func:`~atomo_tpu_torch.codecs.base.
    mask_gathered`), one implementation for both."""
    return mask_gathered(gathered, okg)


def roster_fold_sum(rows: torch.Tensor) -> torch.Tensor:
    """``rows[0] + rows[1] + ...`` of an (N, ...) stack, left to right: the
    pinned reduction every survivor mean uses (no reassociation by the row
    count)."""
    acc = rows[0]
    for i in range(1, rows.shape[0]):
        acc = acc + rows[i]
    return acc


def survivor_decode_mean(codec, gathered: Sequence, okg: torch.Tensor,
                         grads_like: Sequence[torch.Tensor],
                         layouts: Optional[Sequence[bool]] = None) -> list:
    """The mean over the surviving roster of gathered payloads (each leaf's
    fields with a leading axis of the N replicas of ``okg``, views of a
    gathered buffer included), in the port layout of ``grads_like``: the
    replicas whose flag in the (N,) float32 ``okg`` is not above 0 left out,
    the others decoded, summed in roster order and divided once by max(kept,
    1). The caller does not rescale."""
    return decode_mean_tree(codec, gathered, grads_like, okg.shape[0], layouts, fused=False,
                            replica_ok=okg, survivor=True)
