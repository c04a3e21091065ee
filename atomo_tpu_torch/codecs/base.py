"""Codec interface and whole-tree encode/decode.

Counterpart of ``atomo_tpu/codecs/base.py`` (the whole-tree path, the
subset encode ``encode_leaf_subset`` that the sparse-row hybrid exchange
runs over its dense-assigned leaves and ``--stream-encode`` runs per layer
bucket, ``encode_tree_streamed``, and the mean decode over a leading
replica axis).

A gradient "tree" here is a list of tensors in the canonical leaf order,
which is the order ``jax.tree_util.tree_flatten`` gives the Flax parameter
dict (see :func:`atomo_tpu_torch.convert.jax_leaf_order`). The wire contract
with the JAX package:

* leaf ``i`` is encoded under key ``fold_in(key, i)``, so its stream depends
  on (key, leaf) alone;
* each leaf is flattened in the JAX layout (``convert.jax_view``: a conv weight
  OIHW is read as HWIO, a linear weight (out, in) as (in, out), an embedding
  table as it lies; ``layouts`` says per leaf whether the view transposes), so
  a payload of the port decodes in the JAX package and the reverse, given the
  same random draws;
* same-shape leaves are stacked into one codec call, the counterpart of
  ``encode_leaf_subset``'s vmap over shape groups; a codec with a tree-wide
  encode (decode) takes every leaf in one call instead (QSGD: one kernel
  launch over the whole tree each way, with no stack copied).

A codec implements ``encode_stack(x, seeds, draws, shape=...)`` over an
(L, n) stack of flattened leaves of one JAX-layout ``shape`` and
``decode_stack(payload, n, shape=...)``; its payload is a NamedTuple of
tensors with a leading L axis. ``draws`` is the codec's parity hook (QSGD:
its uniforms; SVD: a dict of its random draws), ``None`` in training.
A codec may add ``encode_leaves(views, seeds, draws)``, which encodes the
JAX-layout views of all leaves at once and returns one payload per leaf, its
mirror ``decode_leaves(payloads, grads_like, layouts, n_replicas)``, which
decodes (and averages over replicas) all leaves at once into the port
layout, and ``decode_mean_stack`` for a fused mean over replicas.

Per-leaf codecs (``leaf_codec``, ``codec_subset``): a wrapper with a
``codec_for(i)`` method (:class:`atomo_tpu_torch.budget.PerLeafCodec`, an
allocation's per-layer SVD ranks or QSGD widths) resolves the codec of GLOBAL
leaf ``i``. The tree walkers group the leaves by their resolved codec, in
first-seen leaf order, and run each group as the plain codec runs a tree
(QSGD: one launch per distinct width; SVD: its shape groups split where ranks
differ); every leaf keeps its global seed ``fold_in(key, i)``. At uniform
knobs there is one group, the whole tree, so the payloads equal the plain
codec's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, Sequence

import torch

from atomo_tpu_torch.convert import from_jax_view, jax_view
from atomo_tpu_torch.ops.qsgd_kernels import replica_mean, survivor_divisor
from atomo_tpu_torch.utils.rng import FoldedSeeds, fold_in

Payload = Any  # a NamedTuple of tensors


class Codec(Protocol):
    name: str

    def encode_stack(
        self, x: torch.Tensor, seeds: Sequence[int], draws: Any = None, *,
        shape: Optional[Sequence[int]] = None,
    ) -> Payload: ...

    def decode_stack(self, payload: Payload, n: int, *,
                     shape: Optional[Sequence[int]] = None) -> torch.Tensor: ...


def leaf_codec(codec, i: int):
    """The codec of leaf ``i`` (global canonical index): a plain codec is
    itself for every leaf; a per-leaf wrapper (one with ``codec_for``)
    resolves it."""
    fn = getattr(codec, "codec_for", None)
    return codec if fn is None else fn(i)


def codec_subset(codec, idxs: Sequence[int]):
    """The codec of a sub-list of leaves named by global indices ``idxs``:
    a per-leaf wrapper re-indexed so that local position ``j`` resolves to
    leaf ``idxs[j]``; a plain codec as it is. Wherever a walker takes a
    partial leaf list with local indices (the hybrid's dense sub-list)."""
    fn = getattr(codec, "subset", None)
    if fn is None or getattr(codec, "codec_for", None) is None:
        return codec
    return fn(tuple(int(i) for i in idxs))


def _codec_groups(codec, idxs: Sequence[int]) -> dict:
    """Positions of ``idxs`` (global leaf indices) grouped by their
    resolved codec, in first-seen order; None for a plain codec (one group,
    the whole list, taken by the caller as it is)."""
    if getattr(codec, "codec_for", None) is None:
        return None
    groups: dict = {}
    for j, i in enumerate(idxs):
        groups.setdefault(leaf_codec(codec, i), []).append(j)
    return groups


def tree_nbytes(tensors: Sequence[torch.Tensor]) -> int:
    """Byte size of a list of tensors (e.g. a dense gradient)."""
    return int(sum(t.numel() * t.element_size() for t in tensors))


def payload_nbytes(payload: Payload) -> int:
    """Byte size of a payload, the reference's Msg(MB)."""
    return tree_nbytes(payload)


@dataclasses.dataclass(frozen=True)
class CodecStats:
    """Per-encode compression accounting."""

    dense_bytes: int
    payload_bytes: int

    @property
    def reduction(self) -> float:
        return self.dense_bytes / max(self.payload_bytes, 1)


def _shape_groups(shapes) -> dict:
    """Leaf indices grouped by (JAX-layout shape, dtype), in first-seen
    order. The walkers call it with one resolved codec (a per-leaf codec is
    split by :func:`_codec_groups` first), so the key (resolved codec, shape,
    dtype) of the JAX package's grouping holds: leaves of one shape at
    different knobs never share a stack."""
    groups: dict = {}
    for i, key in enumerate(shapes):
        groups.setdefault(key, []).append(i)
    return groups


def _views(tensors: Sequence[torch.Tensor], layouts: Optional[Sequence[bool]]):
    if layouts is None:
        return [jax_view(t) for t in tensors]
    return [jax_view(t, tr) for t, tr in zip(tensors, layouts)]


def stack_leaves(grads: Sequence[torch.Tensor], layouts: Optional[Sequence[bool]] = None):
    """Yield ``(leaf indices, (L, n) stack)`` per shape group: the leaves of
    one JAX-layout shape and dtype, each flattened in the JAX layout, in
    first-seen order. One group is one ``encode_stack`` call.
    ``layouts`` (per leaf, :func:`~atomo_tpu_torch.convert.jax_layouts`)
    says which leaves the JAX view transposes; by default every 2-D and 4-D
    one."""
    return _stacks(_views(grads, layouts))


def _stacks(views: Sequence[torch.Tensor]):
    for idxs in _shape_groups((tuple(v.shape), v.dtype) for v in views).values():
        yield idxs, torch.stack([views[i].reshape(-1) for i in idxs])


def _stack_draws(draws: Sequence[Any], idxs: Sequence[int]):
    """The per-leaf parity draws of a group, stacked: tensors, or dicts of
    tensors stacked key by key."""
    first = draws[idxs[0]]
    if isinstance(first, dict):
        return {k: torch.stack([draws[i][k] for i in idxs]) for k in first}
    return torch.stack([draws[i] for i in idxs])


def _stack(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """torch.stack, with uint32 words moved as int32 (the same bits): not
    every torch build stacks uint32 on CUDA."""
    if parts[0].dtype == torch.uint32:
        return torch.stack([p.view(torch.int32) for p in parts]).view(torch.uint32)
    return torch.stack(list(parts))


def encode_groups(
    codec: Codec,
    views: Sequence[torch.Tensor],
    seeds: Sequence[int],
    draws: Optional[Sequence[Any]] = None,
) -> list:
    """One ``encode_stack`` call per shape group of the JAX-layout ``views``
    (leaf ``i`` draws from ``seeds[i]``); one payload per leaf."""
    payloads: list = [None] * len(views)
    for idxs, x in _stacks(views):
        d = None if draws is None else _stack_draws(draws, idxs)
        sub = seeds.subset(idxs) if isinstance(seeds, FoldedSeeds) else [seeds[i] for i in idxs]
        batch = codec.encode_stack(x, sub, d,
                                   shape=tuple(views[idxs[0]].shape))
        for j, i in enumerate(idxs):
            payloads[i] = type(batch)(*(a[j] for a in batch))
    return payloads


def encode_tree(
    codec: Codec,
    key: int,
    grads: Sequence[torch.Tensor],
    draws: Optional[Sequence[Any]] = None,
    layouts: Optional[Sequence[bool]] = None,
) -> tuple[list, CodecStats]:
    """Encode every leaf of ``grads`` (canonical order, port layout): in one
    ``encode_leaves`` call where the codec has one, else one ``encode_stack``
    call per shape group.

    ``draws`` (one entry per leaf: a (n_buckets, bucket_size) uniforms tensor
    for QSGD, a dict of draws for SVD) replaces the codec's own draws: the
    parity hook through which the tests feed the port what JAX drew."""
    payloads = encode_leaf_subset(codec, key, grads, range(len(grads)), draws, layouts)
    stats = CodecStats(
        dense_bytes=tree_nbytes(grads),
        payload_bytes=sum(payload_nbytes(p) for p in payloads),
    )
    return payloads, stats


def encode_tree_streamed(
    codec: Codec,
    key: int,
    grads: Sequence[torch.Tensor],
    plan,
    draws: Optional[Sequence[Any]] = None,
    layouts: Optional[Sequence[bool]] = None,
) -> tuple[list, CodecStats]:
    """Per-layer-bucket encode of a gradient list (``--stream-encode``):
    one :func:`encode_leaf_subset` call per bucket of ``plan`` (a
    :class:`~atomo_tpu_torch.parallel.common.LayerBucketPlan`), in plan
    order. Every leaf is keyed by its global index, so the payloads equal
    :func:`encode_tree`'s bit for bit for any plan; the data-parallel step
    issues the same per-bucket calls from backward hooks instead."""
    if plan.n_leaves != len(grads):
        raise ValueError(
            f"bucket plan covers {plan.n_leaves} leaves but the gradient "
            f"tree has {len(grads)} — plan and tree must come from the "
            "same structure")
    payloads: list = [None] * len(grads)
    for idxs in plan.buckets:
        for j, p in zip(idxs, encode_leaf_subset(codec, key, grads, idxs, draws, layouts)):
            payloads[j] = p
    stats = CodecStats(
        dense_bytes=tree_nbytes(grads),
        payload_bytes=sum(payload_nbytes(p) for p in payloads),
    )
    return payloads, stats


def encode_leaf_subset(
    codec: Codec,
    key: int,
    grads: Sequence[torch.Tensor],
    idxs: Sequence[int],
    draws: Optional[Sequence[Any]] = None,
    layouts: Optional[Sequence[bool]] = None,
) -> list:
    """Encode the leaves of ``grads`` named by GLOBAL indices ``idxs``; one
    payload per index, in ``idxs`` order. Leaf ``i`` draws from
    ``fold_in(key, i)`` (and ``draws[i]`` where given: ``draws`` has one
    entry per leaf of the whole tree), its index in the FULL tree, so any
    subset's payloads equal those of :func:`encode_tree` for its leaves, bit
    for bit. The subset goes through the whole-tree path: one
    ``encode_leaves`` call (QSGD: one launch, the subset's seeds in its
    arguments), else one ``encode_stack`` call per shape group of the
    subset. A per-leaf codec runs that once per group of leaves that share
    a resolved codec, each leaf under its global seed. ``key`` is an int, or
    a 0-d int64 tensor whose value is read on the device
    (:class:`~atomo_tpu_torch.utils.rng.FoldedSeeds`)."""
    idxs = list(idxs)
    if not idxs:
        return []
    groups = _codec_groups(codec, idxs)
    if groups is not None:
        out: list = [None] * len(idxs)
        for c, pos in groups.items():
            for j, p in zip(pos, encode_leaf_subset(c, key, grads, [idxs[j] for j in pos],
                                                    draws, layouts)):
                out[j] = p
        return out
    lay = None if layouts is None else [layouts[i] for i in idxs]
    views = _views([grads[i] for i in idxs], lay)
    # a 0-d int64 tensor key is the device form a CUDA graph replays: the
    # QSGD kernel folds each leaf's index into it on the card
    seeds = FoldedSeeds(key, idxs) if torch.is_tensor(key) else [fold_in(key, i) for i in idxs]
    sub_draws = None if draws is None else [draws[i] for i in idxs]
    encode_leaves = getattr(codec, "encode_leaves", None)
    if encode_leaves is not None:
        return encode_leaves(views, seeds, sub_draws)
    return encode_groups(codec, views, seeds, sub_draws)


def _decode_groups(codec: Codec, payloads, grads_like, layouts, decode):
    """Run ``decode(stacked payload, n, shape) -> (L, n)`` once per shape
    group and lay each leaf back out like ``grads_like`` (port layout)."""
    shapes = [tuple(v.shape) for v in _views(grads_like, layouts)]
    out: list = [None] * len(grads_like)
    for (shape, _), idxs in _shape_groups(
        (s, g.dtype) for s, g in zip(shapes, grads_like)
    ).items():
        p0 = payloads[idxs[0]]
        stacked = type(p0)(*(_stack(parts) for parts in
                             zip(*(payloads[i] for i in idxs))))
        vals = decode(stacked, grads_like[idxs[0]].numel(), shape)
        for j, i in enumerate(idxs):
            g = grads_like[i]
            tr = True if layouts is None else layouts[i]
            out[i] = from_jax_view(vals[j].reshape(shape), tr).to(g.dtype).contiguous()
    return out


def _per_codec(codec, payloads, grads_like, layouts, decode) -> Optional[list]:
    """A per-leaf codec's decode: ``decode(plain codec, payloads, grads_like,
    layouts)`` once per group of leaves that share a resolved codec, the
    results put back in leaf order; None for a plain codec."""
    groups = _codec_groups(codec, range(len(grads_like)))
    if groups is None:
        return None
    out: list = [None] * len(grads_like)
    for c, pos in groups.items():
        lay = None if layouts is None else [layouts[j] for j in pos]
        for j, v in zip(pos, decode(c, [payloads[j] for j in pos],
                                    [grads_like[j] for j in pos], lay)):
            out[j] = v
    return out


def decode_tree(
    codec: Codec, payloads: Sequence[Payload], grads_like: Sequence[torch.Tensor],
    layouts: Optional[Sequence[bool]] = None,
) -> list[torch.Tensor]:
    """Decode payloads back to gradients shaped like ``grads_like`` (port
    layout): in one ``decode_leaves`` call where the codec has one, else one
    codec call per shape group; a per-leaf codec, once per resolved codec."""
    out = _per_codec(codec, payloads, grads_like, layouts, decode_tree)
    if out is not None:
        return out
    decode_leaves = getattr(codec, "decode_leaves", None)
    if decode_leaves is not None:
        return decode_leaves(payloads, grads_like, layouts)
    return _decode_groups(codec, payloads, grads_like, layouts,
                          lambda p, n, shape: codec.decode_stack(p, n, shape=shape))


def mask_gathered(gathered: Sequence[Payload], replica_ok: torch.Tensor) -> list:
    """The gathered payloads with every field of an unhealthy replica (its
    flag in the (N,) ``replica_ok`` not above 0) zeroed: the JAX package's
    ``_mask_gathered`` (:func:`~atomo_tpu_torch.ops.qsgd_kernels.
    mask_replica_rows`); a zeroed payload decodes to zero under every codec."""
    from atomo_tpu_torch.ops.qsgd_kernels import mask_replica_rows

    return [type(p)(*(mask_replica_rows(t, replica_ok) for t in p)) for p in gathered]


def decode_mean_tree(
    codec: Codec, gathered: Sequence[Payload], grads_like: Sequence[torch.Tensor],
    n_replicas: int, layouts: Optional[Sequence[bool]] = None, fused: bool = True,
    replica_ok: Optional[torch.Tensor] = None, survivor: bool = False,
) -> list[torch.Tensor]:
    """Decode gathered payloads (each leaf's with a leading replica axis of
    ``n_replicas``, the fields of a gathered buffer included) and average
    them: in one ``decode_leaves`` call where the codec has one (QSGD: one
    launch over the tree), else one codec call per shape group, the codec's
    fused ``decode_mean_stack`` where it has one and ``fused`` holds (SVD:
    one (m, N*k) @ (N*k, n) product), else decode every replica and sum the
    decodes in replica order, then divide: the ring's order, as the JAX
    package's ``fused=False``. A per-leaf codec runs this once per resolved
    codec, each leaf's fields read where they lie. ``replica_ok`` (the
    guard: an (N,) float32 flag per replica) leaves the unhealthy replicas
    out as the JAX package's masked decode does: the fused QSGD kernel
    adds a zero at their place and never reads their fields; every other
    codec decodes :func:`mask_gathered`'s payloads. ``survivor`` (with
    ``replica_ok``) is the survivor-exact mean: each sum divided once by
    max(kept, 1) in place of ``n_replicas``, every replica decoded alone and
    the decodes summed in replica order (no fused mean)."""
    out = _per_codec(codec, gathered, grads_like, layouts,
                     lambda c, p, g, lay: decode_mean_tree(c, p, g, n_replicas, lay, fused,
                                                           replica_ok, survivor))
    if out is not None:
        return out
    decode_leaves = getattr(codec, "decode_leaves", None)
    if decode_leaves is not None:
        return decode_leaves(gathered, grads_like, layouts, n_replicas, replica_ok=replica_ok,
                             survivor=survivor)
    divisor = survivor_divisor(replica_ok) if survivor else None
    if replica_ok is not None:
        gathered = mask_gathered(gathered, replica_ok)
    fused_mean = getattr(codec, "decode_mean_stack", None) if fused and not survivor else None

    def mean(stacked, n, shape):
        if fused_mean is not None:
            return fused_mean(stacked, n, n_replicas, shape=shape)
        n_leaves = stacked[0].shape[0]
        flat = type(stacked)(*(a.reshape(n_leaves * n_replicas, *a.shape[2:])
                               for a in stacked))
        vals = codec.decode_stack(flat, n, shape=shape)
        return replica_mean(vals.reshape(n_leaves, n_replicas, n).transpose(0, 1), divisor)

    return _decode_groups(codec, gathered, grads_like, layouts, mean)
