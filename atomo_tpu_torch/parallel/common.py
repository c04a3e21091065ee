"""Payload packing, layer buckets, the ring rotation, and the collectives of the sp axis.

Counterpart of ``atomo_tpu/parallel/common.py:34,99,131`` (``pack_tree_buckets``
/ ``unpack_tree_buckets``, ``plan_layer_buckets``) and of ``atomo_tpu/mesh/collectives.py:19,28``
(``ring_perm``, ``ppermute_ring``), with the tiled ``all_to_all`` that
``atomo_tpu/parallel/ring.py`` calls. :func:`ring_hop` and
:func:`all_to_all` are differentiable, as ``jax.lax.ppermute`` and
``all_to_all`` are: a hop's backward sends the cotangent along the inverse
rotation, an all-to-all's is the all-to-all of the cotangent. Over a group
of one process each is the identity, as the JAX collective is over an axis
of size one.

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

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

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


class LayerBucketPlan(NamedTuple):
    """Ordered layer-axis partition of a gradient tree, the unit of
    ``--stream-encode`` (see :func:`plan_layer_buckets`). ``buckets[b]`` is
    a tuple of GLOBAL leaf indices (canonical order); every leaf is in
    exactly one bucket."""

    n_leaves: int
    buckets: tuple

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def plan_layer_buckets(leaves: Sequence[torch.Tensor], bucket_bytes: int = 0) -> LayerBucketPlan:
    """The JAX package's ``plan_layer_buckets`` over a list of leaves in
    canonical order (``jax_leaf_order``): the leaves walked in REVERSE
    canonical order and packed greedily into buckets of at most
    ``bucket_bytes`` dense bytes (a larger leaf is a bucket of its own);
    ``bucket_bytes <= 0`` gives one bucket of the whole tree. A pure
    function of the leaves' sizes and dtypes.

    The canonical order is the sorted order of the Flax parameter names,
    not the order of the layers: on ResNet-18 at 4 MiB, bucket 0 holds
    ``Dense_0`` together with the stem (``Conv_0``, ``BatchNorm_0``), so it
    is complete only when backward ends. The step keeps the plan (the same
    buckets and payloads as the JAX package) and issues each bucket when
    its last gradient is ready, not in plan order."""
    buckets: list[tuple[int, ...]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i in reversed(range(len(leaves))):
        nbytes = leaves[i].numel() * leaves[i].element_size()
        if bucket_bytes > 0 and cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(tuple(cur))
    return LayerBucketPlan(n_leaves=len(leaves), buckets=tuple(buckets))


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


def _send_recv(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to group rank ``to`` and receive its like from ``frm``,
    in one ``batch_isend_irecv``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n: int):
        ctx.group, ctx.n = group, n
        i = dist.get_rank(group)
        return _send_recv(x, group, (i - 1) % n, (i + 1) % n)

    @staticmethod
    def backward(ctx, grad):
        i, n = dist.get_rank(ctx.group), ctx.n
        return _send_recv(grad, ctx.group, (i + 1) % n, (i - 1) % n), None, None


def ring_hop(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """One hop of ``x`` along :func:`ring_perm` over the ``n`` ranks of
    ``group`` (group rank i sends to i - 1 and receives from i + 1): the
    port's ``ppermute_ring``. Differentiable; the identity at ``n = 1``."""
    if n == 1:
        return x
    if group is None:
        raise ValueError(f"a ring of {n} ranks needs their process group")
    return _RingHop.apply(x, group, n)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group: Optional[object], n: int) -> torch.Tensor:
    """Chunk ``j`` of ``x``'s leading axis (of ``n``) goes to group rank
    ``j``; row ``i`` of the result came from group rank ``i``.
    Differentiable (its own inverse); the identity at ``n = 1``."""
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {n} ranks needs a leading axis of {n}, "
                         f"got {tuple(x.shape)}")
    if n == 1:
        return x
    if group is None:
        raise ValueError(f"an all-to-all over {n} ranks needs their process group")
    return _AllToAll.apply(x, group)
