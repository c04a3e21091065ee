"""Codec interface and whole-tree encode/decode.

Counterpart of ``atomo_tpu/codecs/base.py`` (the whole-tree path: the
streamed encode and ``decode_mean_tree`` come with the multi-GPU slice).

A gradient "tree" here is a list of tensors in the canonical leaf order,
which is the order ``jax.tree_util.tree_flatten`` gives the Flax parameter
dict (see :func:`atomo_tpu_torch.convert.jax_leaf_order`). The wire contract
with the JAX package:

* leaf ``i`` is encoded under key ``fold_in(key, i)``, so its stream depends
  on (key, leaf) alone;
* each leaf is flattened in the JAX layout (``convert.jax_view``: a conv weight
  OIHW is read as HWIO, a linear weight (out, in) as (in, out)), so a payload
  of the port decodes in the JAX package and the reverse, byte-identical
  given the same uniforms;
* same-shape leaves are stacked into one codec call (one kernel launch), the
  counterpart of ``encode_leaf_subset``'s vmap over shape groups.

A codec implements ``encode_stack(x, seeds, uniforms)`` over an (L, n) stack
of flattened leaves and ``decode_stack(payload, n)``; its payload is a
NamedTuple of tensors with a leading L axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, Sequence

import torch

from atomo_tpu_torch.convert import from_jax_view, jax_view
from atomo_tpu_torch.utils.rng import fold_in

Payload = Any  # a NamedTuple of tensors


class Codec(Protocol):
    name: str

    def encode_stack(
        self, x: torch.Tensor, seeds: Sequence[int],
        uniforms: Optional[torch.Tensor] = None,
    ) -> Payload: ...

    def decode_stack(self, payload: Payload, n: int) -> torch.Tensor: ...


def payload_nbytes(payload: Payload) -> int:
    """Byte size of a payload, the reference's Msg(MB)."""
    return int(sum(a.numel() * a.element_size() for a in payload))


@dataclasses.dataclass(frozen=True)
class CodecStats:
    """Per-encode compression accounting."""

    dense_bytes: int
    payload_bytes: int

    @property
    def reduction(self) -> float:
        return self.dense_bytes / max(self.payload_bytes, 1)


def _shape_groups(shapes) -> dict:
    """Leaf indices grouped by (JAX-layout shape, dtype), in first-seen order."""
    groups: dict = {}
    for i, key in enumerate(shapes):
        groups.setdefault(key, []).append(i)
    return groups


def stack_leaves(grads: Sequence[torch.Tensor]):
    """Yield ``(leaf indices, (L, n) stack)`` per shape group: the leaves of
    one JAX-layout shape and dtype, each flattened in the JAX layout, in
    first-seen order. One group is one codec call (one kernel launch)."""
    views = [jax_view(g) for g in grads]
    for idxs in _shape_groups((tuple(v.shape), v.dtype) for v in views).values():
        yield idxs, torch.stack([views[i].reshape(-1) for i in idxs])


def _stack(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """torch.stack, with uint32 words moved as int32 (the same bits): not
    every torch build stacks uint32 on CUDA."""
    if parts[0].dtype == torch.uint32:
        return torch.stack([p.view(torch.int32) for p in parts]).view(torch.uint32)
    return torch.stack(list(parts))


def encode_tree(
    codec: Codec,
    key: int,
    grads: Sequence[torch.Tensor],
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[list, CodecStats]:
    """Encode every leaf of ``grads`` (canonical order, port layout).

    ``uniforms`` (one (n_buckets, bucket_size) tensor per leaf) replaces the
    codec's own draws: the bit-parity hook through which the tests feed the
    port the uniforms JAX drew."""
    payloads: list = [None] * len(grads)
    for idxs, x in stack_leaves(grads):
        u = None if uniforms is None else torch.stack([uniforms[i] for i in idxs])
        batch = codec.encode_stack(x, [fold_in(key, i) for i in idxs], u)
        for j, i in enumerate(idxs):
            payloads[i] = type(batch)(*(a[j] for a in batch))
    stats = CodecStats(
        dense_bytes=sum(g.numel() * g.element_size() for g in grads),
        payload_bytes=sum(payload_nbytes(p) for p in payloads),
    )
    return payloads, stats


def decode_tree(
    codec: Codec, payloads: Sequence[Payload], grads_like: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """Decode payloads back to gradients shaped like ``grads_like`` (port
    layout), one codec call per shape group."""
    shapes = [tuple(jax_view(g).shape) for g in grads_like]
    out: list = [None] * len(grads_like)
    for (shape, _), idxs in _shape_groups(
        (s, g.dtype) for s, g in zip(shapes, grads_like)
    ).items():
        p0 = payloads[idxs[0]]
        stacked = type(p0)(*(_stack(parts) for parts in
                             zip(*(payloads[i] for i in idxs))))
        n = grads_like[idxs[0]].numel()
        vals = codec.decode_stack(stacked, n)
        for j, i in enumerate(idxs):
            g = grads_like[i]
            out[i] = from_jax_view(vals[j].reshape(shape)).to(g.dtype).contiguous()
    return out
