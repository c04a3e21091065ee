"""Run a planned two-level aggregation inside the data-parallel step.

Counterpart of ``atomo_tpu/topology/execute.py``. :func:`planned_two_level_mean`
runs any :class:`~atomo_tpu_torch.topology.schedule.AggregationPlan` over
the process groups of a two-tier :class:`~atomo_tpu_torch.mesh.spec.
ProcessMesh` (``(dp=K, ici=N/K)``: rank ``r`` at outer index ``r // (N/K)``,
inner index ``r % (N/K)``, one group a line of each axis): the inner stage
over this rank's ``ici`` group (a dense ``all_reduce`` mean, or the encode
under the per-card inner key and ``parallel.replicated.ring_stream_mean``),
then the outer stage over its ``dp`` group (the boundary re-encode under the
per-group outer key and a payload ``all_gather`` with one tree decode over
the K rows, or the ring, or the dense ``all_reduce`` fallback).

Keys (the unbiasedness-by-composition contract, the JAX package's):

* INNER keys are per card, ``inner_codec_key(step_key, chip_id)``: each card
  encodes its RAW gradient independently;
* OUTER keys are per GROUP, ``outer_codec_key(step_key, outer_index)``, the
  same on every card of an inner group, so the boundary re-encode gives the
  same payload group-wide and the replicas stay alike with no extra
  exchange;
* the two streams fold disjoint sentinels, so the boundary re-encode is a
  fresh draw independent of the inner draws.

The guard (``guard=``) screens the INNER-REDUCED gradient, which is the same
on every card of a group: one bad card poisons its group's reduction, and
the whole group is the unit masked out of the slow-tier exchange, the
survivors' mean rescaled by K/kept.

:func:`two_level_canonical_mean` is the canonical decode-order oracle over
the same groups (an ``all_gather`` and the unfused decode at every
compressed tier, a mean at every dense one); :func:`two_level_mean_host` is
the reference without collectives. Both take an explicit ``device`` (CUDA
unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

from atomo_tpu_torch.codecs import decode_mean_tree, decode_tree, encode_tree, tree_nbytes
from atomo_tpu_torch.utils.rng import fold_in

# codec-key sentinels: folds beyond any chip id keep these streams disjoint
# from the per-chip dropout/augment streams and from each other
OUTER_KEY_SENTINEL = 1 << 20
INNER_KEY_SENTINEL = (1 << 20) + 1


def outer_codec_key(step_key: int, outer_index: int) -> int:
    """The boundary re-encode's per-GROUP key (the legacy hierarchical
    construction: the sentinel, then the outer index)."""
    return fold_in(fold_in(step_key, OUTER_KEY_SENTINEL), outer_index)


def inner_codec_key(step_key: int, chip_id: int) -> int:
    """The inner compressed ring's per-CARD key (a disjoint sentinel)."""
    return fold_in(fold_in(step_key, INNER_KEY_SENTINEL), chip_id)


def split_draws(draws) -> tuple[Optional[Sequence[Any]], Optional[Sequence[Any]]]:
    """(inner draws, outer draws) of a two-level step's ``draws=`` hook: a
    list is the outer encode's (the only encode of a psum inner), a dict
    holds ``inner`` and ``outer``."""
    if draws is None:
        return None, None
    if isinstance(draws, dict):
        return draws.get("inner"), draws.get("outer")
    return None, draws


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _views(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return [p.view(t.shape) for p, t in zip(flat.split([t.numel() for t in like]), like)]


def _mean_over(tensors: Sequence[torch.Tensor], n: int, group) -> list[torch.Tensor]:
    """The dense mean over the ``n`` ranks of ``group``: one ``all_reduce``
    of the flat buffer, then a true division (none at n = 1)."""
    if n <= 1:
        return list(tensors)
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    return _views(flat / torch.full_like(flat, n), tensors)


def _all_cards_finite(grads: Sequence[torch.Tensor], n: int, group) -> torch.Tensor:
    """0-d bool: every leaf of every rank's ``grads`` in ``group`` finite
    (this rank's finiteness flag, a MIN ``all_reduce`` over the group)."""
    from atomo_tpu_torch.training.resilience import grad_ok

    flag = grad_ok(grads).to(torch.float32).reshape(1)
    if n > 1:
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return flag[0] > 0


def _tiers(mesh, axis: str, inner_axis: str):
    return ((mesh.group(inner_axis), mesh.size(inner_axis), mesh.index(inner_axis)),
            (mesh.group(axis), mesh.size(axis), mesh.index(axis)))


def planned_two_level_mean(codec, plan, grads: Sequence[torch.Tensor], k_inner, k_outer, *,
                           mesh, axis: str = "dp", inner_axis: str = "ici", guard=None,
                           ring_bucket_size: int = 65536,
                           layouts: Optional[Sequence[bool]] = None, draws=None,
                           encodable=None, unfused_decode: bool = False):
    """One plan's two-level aggregation on this rank (the module docstring).

    Returns ``(mean, ok, kept, msg_bytes)``: the global mean estimate (port
    layout), the group-level guard flag and the surviving group count
    (None unguarded), and this rank's bytes on the SLOW tier (the payload
    for a compressed outer, the dense bytes for the psum fallback).
    ``draws`` is the step's hook (:func:`split_draws`); ``encodable`` maps a
    gradient list to the encode's input (the step's non-finite scrub under
    the guard); ``unfused_decode`` decodes the outer gather replica by
    replica, summed in order (the canonical order)."""
    from atomo_tpu_torch.parallel.overlap import gather_flags
    from atomo_tpu_torch.parallel.replicated import gather_payloads, ring_stream_mean
    from atomo_tpu_torch.parallel.common import unpack_tree_buckets
    from atomo_tpu_torch.training.resilience import grad_ok, masked_mean, rescale_by_survivors

    (g_in, n_inner, r_in), (g_out, n_outer, r_out) = _tiers(mesh, axis, inner_axis)
    d_inner, d_outer = split_draws(draws)
    enc = encodable if encodable is not None else (lambda t: t)
    # ---- inner stage: reduce over the fast tier (the ranges the flat
    # exchange opens, so the timeline attributes both tiers alike)
    if plan.inner == "psum":
        with record_function("step.exchange"):
            grads_in = _mean_over(grads, n_inner, g_in)
    else:  # cring: per-card keys over the raw gradient
        with record_function("step.encode"):
            payloads_in, _ = encode_tree(codec, k_inner, enc(grads), d_inner, layouts)
        with record_function("step.ring_exchange_decode"):
            grads_in = ring_stream_mean(codec, payloads_in, grads, rank=r_in, world=n_inner,
                                        n_contrib=n_inner, ring_bucket_size=ring_bucket_size,
                                        layouts=layouts, group=g_in)
    ok = kept = None
    if guard is not None:
        # the group-level screen on the inner-reduced gradient
        ok = grad_ok(grads_in, guard.max_grad_norm)
        if plan.inner == "cring":
            # ``encodable`` may have zeroed a card's non-finite entries
            # before its inner encode, so its group's mean can be finite:
            # the group also fails when any card's raw gradient does (the
            # JAX package encodes the raw gradient, whose mean is then NaN)
            ok = ok & _all_cards_finite(grads, n_inner, g_in)
    dense_bytes = tree_nbytes(grads)
    # ---- outer stage: exchange across the slow tier
    if plan.outer == "psum":  # the dense fallback: no boundary re-encode
        with record_function("step.exchange"):
            if guard is not None:
                mean, kept = masked_mean(grads_in, ok, n_outer, group=g_out)
            else:
                mean = _mean_over(grads_in, n_outer, g_out)
        return mean, ok, kept, dense_bytes
    with record_function("step.encode"):
        # the boundary re-encode: a fresh per-group draw over the inner mean
        payloads, stats = encode_tree(codec, k_outer, enc(grads_in), d_outer, layouts)
    if plan.outer == "gather":
        with record_function("step.exchange"):
            gathered, spec = gather_payloads(payloads, n_outer, g_out)
            okg = gather_flags(ok, n_outer, g_out) if ok is not None else None
        with record_function("step.decode_mean"):
            mean = decode_mean_tree(codec, unpack_tree_buckets(gathered, spec), grads_in,
                                    n_outer, layouts, fused=not unfused_decode, replica_ok=okg)
            if okg is not None:
                kept = okg.sum()
                mean = rescale_by_survivors(mean, n_outer, kept)
    else:  # the ring's streamed schedule on the slow axis
        with record_function("step.ring_exchange_decode"):
            mean = ring_stream_mean(codec, payloads, grads_in, rank=r_out, world=n_outer,
                                    n_contrib=n_outer, ring_bucket_size=ring_bucket_size,
                                    layouts=layouts, group=g_out, ok=ok)
            if ok is not None:
                mean, kept = mean
                mean = rescale_by_survivors(mean, n_outer, kept)
    return mean, ok, kept, stats.payload_bytes


def _all_gather_payloads(payloads, n: int, group):
    from atomo_tpu_torch.parallel.common import unpack_tree_buckets
    from atomo_tpu_torch.parallel.replicated import gather_payloads

    gathered, spec = gather_payloads(payloads, n, group)
    return unpack_tree_buckets(gathered, spec)


def two_level_canonical_mean(codec, plan, grads: Sequence[torch.Tensor], k_inner, k_outer, *,
                             mesh, axis: str = "dp", inner_axis: str = "ici",
                             layouts: Optional[Sequence[bool]] = None, draws=None,
                             device=None) -> list[torch.Tensor]:
    """The canonical decode-order oracle over the mesh's groups: every
    compressed tier an ``all_gather`` and ``decode_mean_tree(fused=False)``
    (each replica decoded, the decodes summed in replica order, one
    division), every dense tier an ``all_reduce`` mean. ``grads`` go to
    ``device`` first (CUDA unless the caller asks for the CPU)."""
    from atomo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    grads = [torch.as_tensor(g).to(dev) for g in grads]
    (g_in, n_inner, _), (g_out, n_outer, _) = _tiers(mesh, axis, inner_axis)
    d_inner, d_outer = split_draws(draws)
    if plan.inner == "psum":
        gm = _mean_over(grads, n_inner, g_in)
    else:
        p_in, _ = encode_tree(codec, k_inner, grads, d_inner, layouts)
        gm = decode_mean_tree(codec, _all_gather_payloads(p_in, n_inner, g_in), grads, n_inner,
                              layouts, fused=False)
    if plan.outer == "psum":
        return _mean_over(gm, n_outer, g_out)
    p_out, _ = encode_tree(codec, k_outer, gm, d_outer, layouts)
    return decode_mean_tree(codec, _all_gather_payloads(p_out, n_outer, g_out), gm, n_outer,
                            layouts, fused=False)


def _stack_payloads(payloads_by_rank: Sequence[Sequence]) -> list:
    """Per leaf, the payloads of every rank stacked on a leading replica
    axis (the gathered form ``decode_mean_tree`` reads)."""
    out = []
    for leaf in zip(*payloads_by_rank):
        first = leaf[0]
        out.append(type(first)(*(torch.stack(fs) if torch.is_tensor(fs[0]) else fs[0]
                                 for fs in zip(*leaf))))
    return out


def two_level_mean_host(codec, plan, grads_by_chip: Sequence[Sequence[torch.Tensor]],
                        step_key: int, *, n_outer: int, n_inner: int,
                        layouts: Optional[Sequence[bool]] = None, draws=None,
                        device=None) -> list[torch.Tensor]:
    """One plan's two-level mean without collectives: card ``o * n_inner +
    i`` belongs to outer group ``o``, the keys come from the step's helpers,
    and every decode-mean is the canonical unfused order (each payload
    decoded, the decodes averaged in source order). The semantics and
    unbiasedness reference. ``draws`` replaces the codec's draws: a dict
    with ``inner`` (per card, per leaf) and ``outer`` (per group, per
    leaf). Runs on ``device`` (CUDA unless the caller asks for the CPU)."""
    from atomo_tpu_torch.utils.device import resolve_device

    if len(grads_by_chip) != n_outer * n_inner:
        raise ValueError(f"{len(grads_by_chip)} cards' gradients for a {n_outer}x{n_inner} "
                         "mesh")
    dev = resolve_device(device)
    chips = [[torch.as_tensor(g).to(dev) for g in tree] for tree in grads_by_chip]
    d_inner = (draws or {}).get("inner")
    d_outer = (draws or {}).get("outer")

    def canonical_mean(trees):
        n = len(trees)
        out = []
        for leaf in zip(*trees):
            acc = leaf[0].clone()
            for x in leaf[1:]:
                acc = acc + x
            out.append(acc / torch.full_like(acc, n) if n > 1 else acc)
        return out

    group_means = []
    for o in range(n_outer):
        members = chips[o * n_inner:(o + 1) * n_inner]
        if plan.inner == "psum":
            group_means.append(canonical_mean(members))
            continue
        decoded = []
        for i, g in enumerate(members):
            c = o * n_inner + i
            p, _ = encode_tree(codec, inner_codec_key(step_key, c), g,
                               d_inner[c] if d_inner is not None else None, layouts)
            decoded.append(decode_tree(codec, p, g, layouts))
        group_means.append(canonical_mean(decoded))
    if plan.outer == "psum":
        return canonical_mean(group_means)
    payloads = [encode_tree(codec, outer_codec_key(step_key, o), gm,
                            d_outer[o] if d_outer is not None else None, layouts)[0]
                for o, gm in enumerate(group_means)]
    return decode_mean_tree(codec, _stack_payloads(payloads), group_means[0], n_outer, layouts,
                            fused=False)
