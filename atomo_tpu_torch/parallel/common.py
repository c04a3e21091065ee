"""Payload packing and the ring rotation shared by the exchange.

Counterpart of ``atomo_tpu/parallel/common.py:34,99`` (``pack_tree_buckets``
/ ``unpack_tree_buckets``) and of ``atomo_tpu/mesh/collectives.py:19``
(``ring_perm``).

The JAX package packs a payload tree into one buffer per dtype. The port
packs it into ONE contiguous byte buffer per rank: every field of every
leaf's payload (QSGD words and scales, SVD factors, ...) at a static byte
offset, aligned to its element size and to 4 bytes (so QSGD's and float32
SVD's fields follow each other with no gap), the buffer's length to 16. So
the gather is one ``all_gather_into_tensor`` a step, whatever the model's
depth, and a ring hop rotates one buffer; packing is one concatenation.
Unpacking is one strided view per field: of a rank's (B,) buffer it gives
the payloads as they were; of a gathered (N, B) buffer it gives each field
with a leading replica axis of stride B bytes, which the tree decode reads
in place (no copy into a replica-contiguous layout). Packing and unpacking
are a relayout with no arithmetic, so the round trip is exact.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

_ALIGN = 16  # bytes: the buffer's length is a multiple of it


class PackSpec(NamedTuple):
    """Static layout of a packed payload tree (see :func:`pack_tree_buckets`).

    ``types[i]`` is leaf i's payload class (a NamedTuple); ``fields[i]``
    holds one ``(offset, nbytes, dtype, shape, strides)`` per field of it:
    its first byte in the rank's buffer, its bytes, and its contiguous
    shape and strides (elements); ``nbytes`` is the buffer's length.
    """

    types: tuple
    fields: tuple
    nbytes: int


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def _strides(shape: tuple) -> tuple:
    out, step = [], 1
    for d in reversed(shape):
        out.append(step)
        step *= d
    return tuple(reversed(out))


def pack_spec(payloads: Sequence) -> PackSpec:
    """The layout :func:`pack_tree_buckets` gives ``payloads``: fields in
    leaf order, then field order, each aligned to its element size and to
    4 bytes."""
    off = 0
    fields = []
    for p in payloads:
        leaf = []
        for t in p:
            off = _round_up(off, max(t.element_size(), 4))
            nbytes = t.numel() * t.element_size()
            leaf.append((off, nbytes, t.dtype, tuple(t.shape), _strides(tuple(t.shape))))
            off += nbytes
        fields.append(tuple(leaf))
    return PackSpec(tuple(type(p) for p in payloads), tuple(fields), _round_up(off, _ALIGN))


def pack_tree_buckets(payloads: Sequence) -> tuple[torch.Tensor, PackSpec]:
    """Pack a list of payloads (NamedTuples of tensors, one per leaf) into
    one (B,) uint8 buffer on their device, in one concatenation; returns
    ``(buffer, spec)``. Padding bytes are zero."""
    spec = pack_spec(payloads)
    zeros = torch.zeros(_ALIGN, dtype=torch.uint8, device=payloads[0][0].device)
    parts = []
    at = 0
    for p, leaf in zip(payloads, spec.fields):
        for t, (off, nbytes, *_) in zip(p, leaf):
            if off > at:
                parts.append(zeros[: off - at])
            parts.append(t.contiguous().reshape(-1).view(torch.uint8))
            at = off + nbytes
    if spec.nbytes > at:
        parts.append(zeros[: spec.nbytes - at])
    return torch.cat(parts), spec


def unpack_tree_buckets(buf: torch.Tensor, spec: PackSpec) -> list:
    """Exact inverse of :func:`pack_tree_buckets`, by views: ``buf`` is one
    rank's (B,) buffer, or an (N, B) stack of N ranks' buffers, whose fields
    come back with a leading replica axis (stride B bytes, not contiguous
    across replicas)."""
    rows = buf.reshape(-1, spec.nbytes)
    lead = tuple(buf.shape[:-1])
    typed: dict = {}  # the rows as each dtype, one view each
    out = []
    for cls, leaf in zip(spec.types, spec.fields):
        vals = []
        for off, _, dtype, shape, strides in leaf:
            t = typed.get(dtype)
            if t is None:
                t = typed[dtype] = rows.view(dtype)
            es = t.element_size()
            vals.append(t.as_strided(lead + shape, tuple(t.stride()[:len(lead)]) + strides,
                                     t.storage_offset() + off // es))
        out.append(cls(*vals))
    return out


def ring_perm(n: int) -> list[tuple[int, int]]:
    """The canonical ring rotation ``i -> i-1 (mod n)`` as (source,
    destination) pairs: after t hops rank i holds the payload of source
    ``(i + t) % n`` (the one definition; the ring's staging index assumes
    exactly this direction)."""
    return [(i, (i - 1) % n) for i in range(n)]


def hop_pieces(nbytes: int, ring_bucket_size: int) -> list[tuple[int, int]]:
    """The (start, stop) byte ranges of one ring hop's messages: at most
    ``ring_bucket_size`` 4-byte elements each (the reference's elements per
    rotation bucket); ``ring_bucket_size <= 0`` sends the buffer as one
    message. Any cap gives the same bytes at the other end."""
    cap = 4 * ring_bucket_size if ring_bucket_size > 0 else nbytes
    cap = max(cap, 1)
    return [(s, min(s + cap, nbytes)) for s in range(0, nbytes, cap)] or [(0, 0)]
