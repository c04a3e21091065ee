"""Compressed data-parallel training over ``torch.distributed``.

Counterpart of the flat core of ``atomo_tpu/parallel/replicated.py:847
make_distributed_train_step`` (blocking, and stale-by-one with the carry of
``:95-206``), with ``shard_batch`` (:4629),
``replicate_state`` (:4645) and ``make_distributed_eval_step`` (:2721). The
JAX package runs one SPMD program over a mesh; the port runs one process per
device in a process group (:mod:`atomo_tpu_torch.parallel.launch`), each
holding a replica, and the collectives of the program become calls of
``torch.distributed``. Every step, on every rank:

* keys: ``step_key = fold_in(key, step)``, then ``k_aug, k_drop, k_codec =
  split3(fold_in(step_key, rank))`` (``:1502-1503``); ``k_drop`` drives the
  model's ``Dropout`` layers; ``draws=`` hands the codec the draws a parity
  test wants (the JAX package's for this replica), ``dropout_masks=`` the
  dropout keep-masks;
* forward and backward on this rank's rows of the global batch, or, with
  ``grad_accum`` K (``:1515-1569``), on K microbatches of them in order:
  the BatchNorm statistics carried from one to the next, microbatch i's
  dropout under ``fold_in(k_drop, i)``, the gradients summed from zero and
  divided by K, loss and prec@1/5 the microbatch means; under mixed
  precision the parameters are cast once for the K microbatches and each
  microbatch's gradient is added to the float32 sum;
* the exchange, by ``aggregate``:

  - ``gather`` (``:1743-1798``): the payload tree packed into one byte
    buffer (:func:`~atomo_tpu_torch.parallel.common.pack_tree_buckets`), one
    ``all_gather_into_tensor``, and ``decode_mean_tree`` over the gathered
    (N, bytes) buffer, whose rows the QSGD tree decode reads in place (one
    launch); SVD takes its fused (m, N*k) @ (N*k, n) product;
  - ``ring`` (``_ring_stream_mean`` :481-625): N - 1 hops of the packed
    buffer to rank ``rank - 1`` (``ring_perm``) by ``batch_isend_irecv``,
    each arrival decoded (one tree launch) while the next hop is on the
    wire, the decode's slice of this rank's segment of the flat gradient
    (JAX layout, ``ravel_pytree``'s order) staged at the source's canonical
    index ``(rank + t) % N``; one in-order sum over the staged rows, one
    division, and one ``all_gather_into_tensor`` of the segments republishes
    the mean. Each element is summed by one rank, so replicas agree bit for
    bit by construction; ``ring_bucket_size`` caps a hop's message;
  - ``psum`` (``:1831-1840``): the local decode, one ``all_reduce`` of the
    decoded tree, divided by N; its wire is the dense bytes. With no codec
    this is the dense all-reduce (``:1629-1632``), and gather or ring
    without a codec become psum (``:1211-1212``);

* ``hierarchical`` (``:1155-1210,1630-1680``): the two-tier exchange over a
  ``(dp=K, ici=N/K)`` mesh's process groups, a plan of
  :mod:`atomo_tpu_torch.topology` (the legacy plan: a dense mean over this
  rank's ``ici`` group, the boundary encode under the group's key, one
  ``all_gather`` over its ``dp`` group and one tree decode over the K
  rows); ``msg_bytes`` is the slow tier's;
* ``num_aggregate`` k (``:1205``): the mean over the rotating subset
  ``(step + arange(k)) % N`` (gather and ring only, as the reference);
* ``hybrid`` (a :class:`~atomo_tpu_torch.sparse.HybridPlan`; ``_hybrid_mean``
  :691-800): the per-layer sparse-row exchange. The dense-assigned leaves
  are encoded by ``encode_leaf_subset`` under their global leaf keys and
  ride the codec's gather or ring; each sparse-assigned leaf (an embedding
  table) moves as lossless (row, value) pairs, gathered, decoded replica by
  replica and averaged in replica order. Under gather the dense payloads
  and the rows share one packed buffer and one ``all_gather_into_tensor``;
  under ring the dense sub-list rotates (its segmentation follows the
  sub-list, as the JAX package's does) and the rows are gathered.
  ``msg_bytes`` is ``plan.payload_bytes()``; ``metrics["row_overflow"]``
  sums the rows the budget dropped over the ranks (read off the gathered
  payloads: no extra collective);
* ``error_feedback`` (``:1590-1620``, ``:1716-1726``, ``:1972-1990``): each
  rank carries a residual e shaped like the gradient (``TrainState.residual``,
  float32, port layout, on its device; None is the zero it starts from). The
  encode takes g + e, the rank decodes its own payloads (before any
  exchange, so no collective is waited on) and the next residual is
  (g + e) - decode(encode(g + e)); ``metrics["ef_res_norm"]`` is the mean
  over ranks of the residual's L2 norm. It needs a codec and does not
  compose with ``hybrid`` or ``num_aggregate`` (``:1277-1330``);
* per-leaf codecs (:class:`~atomo_tpu_torch.budget.PerLeafCodec`) ride every
  exchange: the tree walkers resolve each leaf's codec, and ``msg_bytes`` is
  the sum of the per-leaf payloads, the allocation's predicted bytes;
* ``stream_encode`` and ``overlap="delayed"``
  (:mod:`atomo_tpu_torch.parallel.overlap`): the layer buckets encoded from
  backward hooks on a side stream (each bucket on the wire at once), and the
  stale-by-one step whose carried payloads are exchanged and decoded on a
  side stream under this step's forward and backward;
* momentum SGD on the mean, then the dp mean of the BatchNorm statistics
  (``:1879``) and of loss and prec@1/5 (``:1881-1883``), one
  ``all_reduce`` over a packed buffer each; under ``zero1`` or
  ``sharded_update`` (:mod:`atomo_tpu_torch.mesh.update`) the update runs on
  this rank's slice of the flat parameter vector.

Phases are ``record_function`` ranges named as the reference's
``named_phase`` scopes: ``step.forward_backward``, ``step.encode``,
``step.exchange``, ``step.decode_mean`` (psum: ``step.decode``), the error
feedback's ``step.ef_decode``, the quality probe's ``step.quality``, the
bucket encodes' ``step.encode_bucket``, the delayed consume's
``step.delayed_exchange``, ``step.delayed_decode_mean`` and
``step.delayed_ring_exchange_decode``, the ring's
``step.ring_exchange_decode``, the hybrid's ``step.hybrid_exchange`` around
its encode, exchange and decode, ``step.update``, and the sharded update's
``step.materialize_params`` and ``step.sharded_update``. No collective needs a host
sync: every size is static.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from atomo_tpu_torch.codecs import (
    codec_subset,
    decode_mean_tree,
    decode_tree,
    encode_leaf_subset,
    encode_tree,
    payload_nbytes,
    tree_nbytes,
)
from atomo_tpu_torch.convert import from_jax_view, jax_layouts, jax_leaf_order, jax_view
from atomo_tpu_torch.elastic.shrink import survivor_decode_mean
from atomo_tpu_torch.models.dropout import dropout_stream
from atomo_tpu_torch.obs.quality import quality_from_decoded, quality_probe
from atomo_tpu_torch.ops.qsgd_kernels import replica_mean, to_port_layout
from atomo_tpu_torch.parallel.common import (
    hop_pieces,
    pack_tree_buckets,
    plan_layer_buckets,
    ring_perm,
    unpack_tree_buckets,
)
from atomo_tpu_torch.parallel.overlap import (
    BucketStream,
    BucketWire,
    OverlapCarry,
    consume,
    encode_syncs,
    gather_flags,
    init_carry,
    issue_consume,
    join,
    pack_payloads,
    side_stream,
)
from atomo_tpu_torch.quorum.schedule import DROPPED
from atomo_tpu_torch.topology.execute import (
    inner_codec_key,
    outer_codec_key,
    planned_two_level_mean,
)
from atomo_tpu_torch.topology.schedule import LEGACY_PLAN
from atomo_tpu_torch.training.optim import Optimizer
from atomo_tpu_torch.training import graph as G
from atomo_tpu_torch.training.resilience import (
    apply_remedy,
    global_sq_norm,
    grad_ok,
    masked_mean,
    rescale_by_survivors,
    zero_if,
)
from atomo_tpu_torch.training.trainer import (
    Guarded,
    TrainState,
    augment_with,
    forward,
    leaf_params,
)
from atomo_tpu_torch.utils.metrics import accuracy
from atomo_tpu_torch.utils.rng import fold_in, split3

AGGREGATES = ("gather", "ring", "psum", "hierarchical")


def _group() -> tuple[int, int]:
    """(rank, world size) of the process group the step runs in."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call atomo_tpu_torch.parallel.launch."
                           "initialize first (the distributed step runs in one)")
    return dist.get_rank(), dist.get_world_size()


def shard_batch(images: np.ndarray, labels: np.ndarray, rank: int, world_size: int):
    """This rank's rows ``[rank * b/N, (rank + 1) * b/N)`` of a global batch
    that every rank drew alike: what the reference's mesh feeds chip
    ``rank``. Raises on a batch that N does not divide."""
    bs = images.shape[0]
    if bs % world_size:
        raise ValueError(
            f"batch size {bs} is not divisible by the {world_size}-device 'dp' "
            "mesh axis; choose --batch-size as a multiple of the device count "
            "(or trim the batch)")
    per = bs // world_size
    return images[rank * per:(rank + 1) * per], labels[rank * per:(rank + 1) * per]


def shard_superbatch(images: np.ndarray, labels: np.ndarray, rank: int, world_size: int):
    """:func:`shard_batch` for a superstep block (``:4636``): ``images`` and
    ``labels`` carry a leading (K, batch, ...) step axis, and this rank takes
    its rows of every step of the block."""
    bs = images.shape[1]
    if bs % world_size:
        raise ValueError(
            f"batch size {bs} is not divisible by the {world_size}-device 'dp' "
            "mesh axis; choose --batch-size as a multiple of the device count "
            "(or trim the batch)")
    per = bs // world_size
    return (images[:, rank * per:(rank + 1) * per],
            labels[:, rank * per:(rank + 1) * per])


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _mean(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` as a true division (on CUDA a Python scalar divisor
    is a product with its reciprocal)."""
    return total / torch.full_like(total, n) if n > 1 else total


def _all_reduce_mean(flat: torch.Tensor, world: int, group=None) -> torch.Tensor:
    dist.all_reduce(flat, group=group)
    return _mean(flat, world)


def _views_like(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    parts = flat.split([t.numel() for t in like])
    return [p.view(t.shape) for p, t in zip(parts, like)]


@torch.no_grad()
def replicate_state(state: TrainState) -> TrainState:
    """Broadcast rank 0's parameters and buffers (one packed buffer) to
    every rank: the replicas start alike."""
    _group()
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    if tensors:
        flat = _flat(tensors)
        dist.broadcast(flat, src=0)
        for t, v in zip(tensors, _views_like(flat, tensors)):
            t.copy_(v)
    return state


def _rotating_rows(x: torch.Tensor, start: int, k: int) -> torch.Tensor:
    """Rows ``(start + i) % N`` of ``x`` for i < k, in that order: a view,
    or two slices joined where the window wraps."""
    n = x.shape[0]
    end = start + k
    if end <= n:
        return x[start:end]
    return torch.cat([x[start:], x[: end - n]])


def gather_payloads(payloads: Sequence, world: int, group=None):
    """One ``all_gather_into_tensor`` of the packed payload tree over the
    ``world`` ranks of ``group`` (the default group when None): every
    rank's payloads as views of one (N, bytes) buffer (the fields with a
    leading replica axis at a stride of one rank's bytes)."""
    buf, spec = pack_tree_buckets(payloads)
    gathered = torch.empty((world * spec.nbytes,), dtype=torch.uint8, device=buf.device)
    dist.all_gather_into_tensor(gathered, buf, group=group)
    return gathered.view(world, spec.nbytes), spec


def ring_stream_mean(codec, payloads: Sequence, grads: Sequence[torch.Tensor], *, rank: int,
                     world: int, sel_start: Optional[int] = None, n_contrib: int,
                     ring_bucket_size: int = 65536,
                     layouts: Optional[Sequence[bool]] = None, group=None, ok=None,
                     survivor_exact: bool = False):
    """The ring's decode-mean (``_ring_stream_mean``): rotate the packed
    payloads N - 1 hops to ``rank - 1``, decode each arrival into this
    rank's segment of the flat JAX-layout gradient at its source's
    canonical row, sum the rows (the ``n_contrib`` selected from
    ``sel_start`` on, or all) in order, divide, and republish the segments
    with one ``all_gather_into_tensor``. Returns the mean, port layout
    (``layouts`` as for :func:`~atomo_tpu_torch.codecs.encode_tree`).
    ``rank`` and ``world`` are this rank's place in ``group`` (the default
    group when None); a world of one makes no collective call. ``ok`` (the
    guard: this rank's 0-d health flag) rotates with the payload, each
    arrival's staged slice masked by its source's flag before the sum
    (``where``, not a product: NaN times 0 is NaN); the call then returns
    ``(mean, kept)``, kept the selected sources' flags summed.
    ``survivor_exact`` (with ``ok``) divides the in-order sum of the staged
    rows by max(kept, 1) in place of the row count (``:607-619``): the
    survivor-exact mean, which the caller does not rescale."""
    numels = [g.numel() for g in grads]
    d_flat = sum(numels)
    chunk = -(-d_flat // world)
    lo = rank * chunk
    hi = min(lo + chunk, d_flat)
    buf, spec = pack_tree_buckets(payloads)
    nxt = torch.empty_like(buf)
    stage = torch.zeros((world, chunk), dtype=torch.float32, device=buf.device)
    ok_t = ok_nxt = ok_stage = None
    if ok is not None:
        ok_t = ok.to(torch.float32).reshape(1).clone()
        ok_nxt = torch.empty_like(ok_t)
        ok_stage = torch.zeros((world,), dtype=torch.float32, device=buf.device)
    send_to, recv_from = ring_perm(world)[rank][1], (rank + 1) % world
    if world > 1 and group is not None:  # P2P peers are global ranks
        send_to, recv_from = (dist.get_global_rank(group, r) for r in (send_to, recv_from))
    # decoded in the JAX layout (no leaf transposed), so that the flat
    # order is the reference's ravel_pytree order
    flat_layouts = [False] * len(grads)
    for t in range(world):
        reqs = []
        if t < world - 1:  # the hop starts before this arrival's decode
            ops = []
            for a, b in hop_pieces(spec.nbytes, ring_bucket_size):
                ops.append(dist.P2POp(dist.isend, buf[a:b], send_to, group))
                ops.append(dist.P2POp(dist.irecv, nxt[a:b], recv_from, group))
            if ok_t is not None:  # the flag travels with its payload
                ops.append(dist.P2POp(dist.isend, ok_t, send_to, group))
                ops.append(dist.P2POp(dist.irecv, ok_nxt, recv_from, group))
            reqs = dist.batch_isend_irecv(ops)
        src = (rank + t) % world
        decoded = decode_tree(codec, unpack_tree_buckets(buf, spec), grads, flat_layouts)
        if hi > lo:
            sl = torch.cat([v.reshape(-1) for v in decoded])[lo:hi]
            if ok_t is not None:
                sl = torch.where(ok_t > 0, sl, torch.zeros((), dtype=sl.dtype, device=sl.device))
            stage[src, : hi - lo] = sl
        if ok_t is not None:
            ok_stage[src] = ok_t[0]
        for r in reqs:
            r.wait()
        buf, nxt = nxt, buf
        if ok_t is not None and t < world - 1:
            ok_t, ok_nxt = ok_nxt, ok_t
    rows = stage if sel_start is None else _rotating_rows(stage, sel_start, n_contrib)
    kept_rows = None
    if ok is not None:
        kept_rows = ok_stage if sel_start is None else _rotating_rows(
            ok_stage.view(world, 1), sel_start, n_contrib).reshape(-1)
    survivors = survivor_exact and kept_rows is not None
    seg = replica_mean(rows, torch.clamp(kept_rows.sum(), min=1.0) if survivors else None)
    if world == 1:  # this rank's segment is the whole mean
        full = seg.reshape(-1)
    else:
        full = torch.empty((world * chunk,), dtype=torch.float32, device=seg.device)
        dist.all_gather_into_tensor(full, seg.contiguous(), group=group)
    layouts = [True] * len(grads) if layouts is None else layouts
    mean = [to_port_layout(v, g.shape, tr) for v, g, tr in
            zip(full[:d_flat].split(numels), grads, layouts)]
    if ok is None:
        return mean
    return mean, kept_rows.sum()


def hybrid_mean(codec, plan, grads: Sequence[torch.Tensor], k_codec: int, *, rank: int,
                world: int, aggregate: str, ring_bucket_size: int = 65536,
                layouts: Optional[Sequence[bool]] = None, draws: Optional[Sequence[Any]] = None,
                group=None, track_quality: bool = False):
    """The hybrid exchange of one step (``_hybrid_mean``): the mean gradient
    in the port layout, the wire bytes, and the nonzero rows the row budgets
    dropped, summed over the ranks (a 0-d float32 tensor). ``plan`` covers
    the leaves of ``grads`` (canonical order; ``layouts`` as for
    ``encode_tree``); ``draws`` (one entry per leaf of the whole tree) feed
    the dense-assigned encode. ``track_quality`` adds a fourth value, the
    per-layer quality series of this rank's own payloads (the dense-assigned
    leaves by one tree decode, each sparse-assigned leaf by its row codec,
    which is lossless: those read exactly 0), else None."""
    layouts = [True] * len(grads) if layouts is None else list(layouts)
    d_idxs, s_idxs = list(plan.dense_idxs), list(plan.sparse_idxs)
    d_codec = codec_subset(codec, d_idxs)  # the sub-list decodes with local indices
    d_grads = [grads[i] for i in d_idxs]
    d_layouts = [layouts[i] for i in d_idxs]
    with record_function("step.encode"):
        d_payloads = encode_leaf_subset(codec, k_codec, grads, d_idxs, draws, layouts)
        # the rows of each table as the JAX package holds it (a table lies
        # alike in both packages, so the view is the tensor itself)
        s_payloads = [plan.row_codec(i).encode(k_codec, jax_view(grads[i], layouts[i]))
                      for i in s_idxs]
    msg_bytes = sum(payload_nbytes(p) for p in d_payloads + s_payloads)
    out: list = [None] * len(grads)
    mean_d: list = []
    with record_function("step.exchange"):
        if aggregate == "gather":  # one buffer: the dense payloads, then the rows
            gathered, spec = gather_payloads(d_payloads + s_payloads, world, group)
            parts = unpack_tree_buckets(gathered, spec)
        elif s_idxs:
            gathered, spec = gather_payloads(s_payloads, world, group)
            parts = [None] * len(d_idxs) + unpack_tree_buckets(gathered, spec)
        else:
            parts = [None] * len(d_idxs)
    with record_function("step.decode_mean"):
        if d_idxs and aggregate == "gather":
            mean_d = decode_mean_tree(d_codec, parts[:len(d_idxs)], d_grads, world, d_layouts)
        elif d_idxs:
            mean_d = ring_stream_mean(d_codec, d_payloads, d_grads, rank=rank, world=world,
                                      n_contrib=world, ring_bucket_size=ring_bucket_size,
                                      layouts=d_layouts, group=group)
        overflow = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for i, p in zip(s_idxs, parts[len(d_idxs):]):
            view = jax_view(grads[i], layouts[i])
            mean = plan.row_codec(i).decode_mean(p, view.shape, world, grads[i].dtype)
            out[i] = from_jax_view(mean, layouts[i]).contiguous()
            overflow = overflow + p.overflow.sum().to(torch.float32)
    for i, m in zip(d_idxs, mean_d):
        out[i] = m
    qm = None
    if track_quality:
        decoded: list = [None] * len(grads)
        if d_idxs:
            for i, d in zip(d_idxs, decode_tree(d_codec, d_payloads, d_grads, d_layouts)):
                decoded[i] = d
        for i, p in zip(s_idxs, s_payloads):
            dec = plan.row_codec(i).decode(p, jax_view(grads[i], layouts[i]).shape,
                                           grads[i].dtype)
            decoded[i] = from_jax_view(dec, layouts[i])
        qm = quality_from_decoded(decoded, grads)
    return out, msg_bytes, overflow, qm


def _check_hybrid(plan, n_leaves: int, codec, aggregate: str, num_aggregate: int,
                  world: int, overlap: str = "off", stream_encode: bool = False,
                  guard=None) -> None:
    """The step factory's refusals of ``hybrid=`` (``:1328-1370``) for the
    arguments the port's step has, and of a plan over another tree."""
    if aggregate == "hierarchical":
        raise ValueError(
            "hybrid= (sparse-row per-layer exchange) does not compose "
            "with aggregate='hierarchical': the boundary re-encode "
            "composes a second estimator per layer and is not "
            "row-aware yet — rejected honestly rather than silently "
            "degraded")
    if plan.n_leaves != n_leaves:
        raise ValueError(
            f"hybrid plan covers {plan.n_leaves} leaves but the gradient "
            f"tree has {n_leaves} — plan and tree must come from the "
            "same structure")
    if codec is None or aggregate not in ("gather", "ring"):
        raise ValueError(
            "hybrid= (sparse-row per-layer exchange) needs a codec "
            "with aggregate='gather' or 'ring': a dense psum wire "
            "degenerates the row exchange (the rows would ride a "
            "full dense all-reduce), and dense-only training has no "
            "per-leaf payload path to hybridize")
    if overlap == "delayed":
        raise ValueError(
            "hybrid= does not compose with overlap='delayed': the "
            "carried payload's shapes are assignment-specific and "
            "the consume chain is not row-aware yet")
    if stream_encode:
        raise ValueError(
            "hybrid= does not compose with stream_encode: the "
            "layer-bucket encode pipeline is not assignment-aware yet")
    if guard is not None:
        raise ValueError(
            "hybrid= does not compose with the guard (and therefore "
            "elastic membership): the row exchange has no "
            "skip-and-rescale masking yet — run the guard all-dense")
    if 0 < num_aggregate < world:
        raise ValueError(
            "hybrid= does not compose with num_aggregate: the "
            "rotating replica subset is not wired into the row "
            "exchange")


def _check_error_feedback(codec, hybrid, k_agg: int, overlap: str = "off",
                          guard=None, hierarchical: bool = False) -> None:
    """The step factory's refusals of ``error_feedback`` (``:1277-1330``)
    for the arguments the port's step has."""
    if codec is None:
        raise ValueError(
            "error_feedback accumulates the codec's compression "
            "residual; dense training has no residual to accumulate")
    if hierarchical:
        raise ValueError(
            "error_feedback needs flat aggregation: the hierarchical "
            "boundary re-encode composes two estimators per layer "
            "and its unbiased-by-composition argument does not "
            "survive the EF bias — rejected honestly")
    if overlap == "delayed":
        raise ValueError(
            "error_feedback does not compose with overlap='delayed': "
            "the carried payload is consumed one step late, so the "
            "residual would describe a stale encode — the carry "
            "semantics are unproven; rejected honestly")
    if guard is not None:
        raise ValueError(
            "error_feedback does not compose with the guard (and "
            "therefore elastic membership): skip-and-rescale rests "
            "on the unbiasedness EF trades away, and a skipped "
            "step's residual semantics are unproven — run EF "
            "unguarded")
    if hybrid is not None:
        raise ValueError(
            "error_feedback does not compose with hybrid= (the "
            "sparse rows are lossless — a zero residual — but the "
            "mixed per-leaf carry is untested); run one or the other")
    if k_agg:
        raise ValueError(
            "error_feedback does not compose with num_aggregate: a "
            "rotating subset consumes only some replicas' payloads, "
            "so the residual of an unconsumed encode would be "
            "mis-attributed")


def _check_overlap(codec, aggregate: str, overlap: str, stream_encode: bool) -> None:
    """The step factory's refusals of ``overlap`` and ``stream_encode``
    (``atomo_tpu/parallel/replicated.py:1213-1236``), ``aggregate`` the one
    in effect."""
    if overlap not in ("off", "delayed"):
        raise ValueError(f"unknown overlap mode {overlap!r}; expected 'off' or 'delayed'")
    if overlap == "delayed" and (codec is None or aggregate not in ("gather", "ring")):
        raise ValueError(
            "overlap='delayed' needs a compressing codec with "
            "aggregate='gather' or 'ring' — the mode takes the encoded "
            "exchange+decode off the critical path; psum and every "
            "two-level hierarchical schedule (the legacy plan and the "
            "topology.schedule re-encoded plans alike) have no delayed "
            "form")
    if stream_encode and (codec is None or aggregate not in ("gather", "ring")):
        raise ValueError(
            "stream_encode needs a compressing codec with "
            "aggregate='gather' or 'ring': the layer-bucket pipeline "
            "restructures the ENCODED exchange — dense psum has no encode "
            "to stream, and the two-level hierarchical schedules "
            "(legacy plan and the topology re-encoded plans alike) "
            "re-encode at the fabric boundary, which is not bucket-aware "
            "yet — rejected honestly rather than silently degraded")


def _check_partition(zero1, sharded_update, hybrid, world: int, parts: bool,
                     survivor_exact: bool = False):
    """The step factory's refusals of ``zero1`` and ``sharded_update``
    (``atomo_tpu/parallel/replicated.py:1368-1405``); returns the specs in
    effect, or None for the replicated update."""
    if sharded_update is not None:
        if zero1 is not None:
            raise ValueError(
                "sharded_update supersedes zero1 (ZeRO-1 is its "
                "shard-state-only degenerate point); pass one, not both")
        if hybrid is not None:
            raise ValueError(
                "sharded_update does not compose with hybrid= yet: the "
                "per-layer row exchange is untested against the flat "
                "master layout — run hybrid with the replicated or "
                "zero1 update")
        if survivor_exact:
            raise ValueError(
                "sharded_update does not compose with elastic membership "
                "(track_ok_bits/survivor_exact): a reshape re-shards the "
                "live state via mesh.reshard instead — the elastic loop "
                "runs the replicated update")
    part = sharded_update if sharded_update is not None else zero1
    if part is None:
        return None
    if parts:
        raise ValueError(
            "the oracle and phase programs drive the replicated update; the "
            "partitions are drilled against the replicated trajectory instead "
            "(bit-identical per codec)")
    if part.n_shards != world:
        raise ValueError(
            f"{part.partition} specs shard over {part.n_shards} ranks but this "
            f"step's group has {world} — build the state with "
            f"{'sharded_update_state' if sharded_update is not None else 'zero1_state'} "
            "in this group")
    return part


def _check_hierarchical(codec, aggregate: str, mesh, inner_axis, plan, world: int, *,
                         track_ok_bits: bool, survivor_exact: bool,
                         track_quality: bool) -> None:
    """The step factory's refusals of ``aggregate='hierarchical'``,
    ``inner_axis`` and ``plan=`` (``atomo_tpu/parallel/replicated.py:
    1181-1275``) for the arguments the port's step has; the mesh must be the
    group's."""
    hierarchical = aggregate == "hierarchical"
    if hierarchical:
        if codec is None or inner_axis is None:
            raise ValueError(
                "aggregate='hierarchical' needs a codec and inner_axis "
                "(dense psum over the fast fabric, factors over the slow "
                "one); use aggregate='psum' for fully-dense exchange")
        names = mesh.spec.names if mesh is not None else ()
        if inner_axis not in names:
            raise ValueError(f"inner_axis {inner_axis!r} not in mesh axes {names}")
        if mesh.spec.n_devices != world:
            raise ValueError(f"a {mesh.spec.describe()} mesh needs {mesh.spec.n_devices} "
                             f"ranks; this step's group has {world}")
    elif inner_axis is not None:
        raise ValueError("inner_axis only applies to aggregate='hierarchical'")
    if plan is not None and not hierarchical:
        raise ValueError(
            "plan= selects a two-level hierarchical schedule "
            "(topology.schedule) and only applies to "
            "aggregate='hierarchical'")
    if not hierarchical:
        return
    if track_ok_bits:
        raise ValueError(
            "track_ok_bits needs flat blocking aggregation: "
            "hierarchical mode drops whole inner groups (membership "
            "tracks single replicas) and the delayed carry is shaped "
            "by the world size")
    if survivor_exact:
        raise ValueError(
            "survivor_exact only applies to flat aggregation (the "
            "hierarchical guard's drop unit is an inner group)")
    if track_quality:
        raise ValueError(
            "track_quality needs flat blocking aggregation: the "
            "hierarchical boundary re-encode composes two estimators "
            "per layer and the delayed carry's payload describes the "
            "PREVIOUS step — neither is per-layer-probe-aware yet; "
            "rejected honestly rather than silently mis-attributed")


def _check_aggregate(codec, aggregate: str, num_aggregate: int, world: int):
    """(aggregate in effect, k of num_aggregate or 0), as the reference
    resolves them (``:1205-1212``); ``world`` the ways the exchange averages
    over (the outer groups under ``hierarchical``)."""
    if aggregate not in AGGREGATES:
        raise ValueError(f"unknown aggregate mode {aggregate!r}; expected one of "
                         f"{'|'.join(AGGREGATES)}")
    k_agg = num_aggregate if 0 < num_aggregate < world else 0
    if k_agg and (codec is None or aggregate not in ("gather", "ring")):
        raise ValueError(
            "num_aggregate requires a codec with aggregate='gather' or "
            "'ring' (a dense psum cannot subset replicas)")
    if codec is None and aggregate in ("gather", "ring"):
        aggregate = "psum"  # dense gather/ring would be strictly worse
    return aggregate, k_agg


def init_delayed_state(state: TrainState, codec, *, group=None) -> TrainState:
    """``state`` with a fresh :class:`~atomo_tpu_torch.parallel.overlap.
    OverlapCarry` (``init_delayed_state``, ``:191``): the zero payload this
    codec gives the model's leaves, all-ones flags, ``valid`` False. The
    port's ``DelayedState`` is the :class:`TrainState` with its ``carry``
    set; a step of ``overlap='delayed'`` takes and returns it."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    model = state.model
    return dataclasses.replace(state, carry=init_carry(codec, leaf_params(model), world,
                                                       jax_layouts(model)))


@dataclasses.dataclass
class QuorumCarry:
    """The bounded-staleness payload history of ``--quorum``
    (``atomo_tpu/parallel/replicated.py:290-320``), in the packed-payload
    form of :class:`~atomo_tpu_torch.parallel.overlap.OverlapCarry`:
    ``ring`` is this rank's last K + 1 encoded payloads, a (K+1, B) uint8
    buffer (``spec`` the layout of a row), slot ``t mod (K+1)`` holding the
    payload produced at step counter t; ``ring_ok`` (K+1,) float32 the
    producing step's guard flag a slot (1.0 without the guard) and the
    warm-up gate: a slot never written stays 0.0, so a staleness reaching
    before the run's history selects nothing. Both are updated in place."""

    ring: torch.Tensor
    ring_ok: torch.Tensor
    spec: Any


# The JAX package's QuorumState (``:323-344``) is TrainState + QuorumCarry;
# the port's is the TrainState with its ``ring`` set, as its DelayedState is
# the TrainState with its ``carry`` set.
QuorumState = TrainState


def init_quorum_state(state: TrainState, codec, staleness: int) -> TrainState:
    """``state`` with a fresh :class:`QuorumCarry` (``init_quorum_state``,
    ``:373-392``): K + 1 zero payloads of the size this codec gives the
    model's leaves and all-zero flags, every slot unwritten."""
    model = state.model
    fresh = init_carry(codec, leaf_params(model), 1, jax_layouts(model))
    depth = staleness + 1
    ring = torch.zeros((depth, fresh.payload.numel()), dtype=torch.uint8,
                       device=fresh.payload.device)
    ring_ok = torch.zeros((depth,), dtype=torch.float32, device=ring.device)
    return dataclasses.replace(state, ring=QuorumCarry(ring=ring, ring_ok=ring_ok,
                                                       spec=fresh.spec))


def gather_ring(carry: QuorumCarry, world: int, group=None) -> dict:
    """The checkpoint form of a ring: every rank's ring as one (N, K+1, B)
    uint8 tensor and its flags as one (N, K+1) float32 tensor (two
    all-gathers over ``group``)."""
    ring, ok = carry.ring.contiguous(), carry.ring_ok.contiguous()
    if world > 1:
        out = torch.empty((world * ring.numel(),), dtype=torch.uint8, device=ring.device)
        dist.all_gather_into_tensor(out, ring.reshape(-1), group=group)
        out_ok = torch.empty((world * ok.numel(),), dtype=torch.float32, device=ok.device)
        dist.all_gather_into_tensor(out_ok, ok, group=group)
    else:
        out, out_ok = ring, ok
    return {"ring": out.view((world,) + tuple(ring.shape)),
            "ring_ok": out_ok.view(world, ok.numel())}


def ring_from_saved(fresh: QuorumCarry, saved, rank: int, world: int):
    """(carry, why): ``fresh`` with this rank's rows of a saved ring
    (:func:`gather_ring`'s dict) copied in, or ``fresh`` and the reason the
    saved one does not fit (None saved: no ring in the checkpoint)."""
    if saved is None:
        return fresh, "no quorum_carry in the checkpoint"
    want = (world,) + tuple(fresh.ring.shape)
    if tuple(saved["ring"].shape) != want:
        return fresh, f"its ring is {tuple(saved['ring'].shape)}, this run needs {want}"
    with torch.no_grad():
        fresh.ring.copy_(saved["ring"][rank])
        fresh.ring_ok.copy_(saved["ring_ok"][rank])
    return fresh, None


def _check_quorum(quorum, codec, aggregate: str, world: int, *, overlap: str, hybrid,
                  partition, error_feedback: bool, survivor_exact: bool, k_agg: int,
                  superstep: int, stream_encode: bool, track_quality: bool,
                  oracle: bool) -> None:
    """The step factory's quorum refusals (``atomo_tpu/parallel/replicated.py:
    1405-1480``) for the arguments the port's step has."""
    if codec is None or aggregate not in ("gather", "ring"):
        raise ValueError(
            "quorum= needs a compressing codec with "
            "aggregate='gather' or 'ring': the staleness ring carries "
            "ENCODED payloads (dense psum has no payload to carry, "
            "and the hierarchical boundary re-encode is not "
            "staleness-aware)")
    if not 1 <= quorum.quorum <= world:
        raise ValueError(
            f"quorum Q={quorum.quorum} out of range for the "
            f"{world}-replica mesh (need 1 <= Q <= {world})")
    if overlap == "delayed":
        raise ValueError(
            "quorum= does not compose with overlap='delayed': the "
            "staleness ring GENERALIZES the stale-by-one carry — "
            "quorum with K>=1 already consumes stale payloads; "
            "stacking both would apply staleness twice")
    if hybrid is not None:
        raise ValueError(
            "quorum= does not compose with hybrid= (sparse rows): "
            "the staleness ring's slots are codec-payload-shaped and "
            "the row exchange is not ring-carry-aware yet")
    if partition is not None:
        raise ValueError(
            "quorum= does not compose with sharded-update/ZeRO-1 "
            "yet: the staleness ring is untested against the sharded "
            "state templates — run the replicated update")
    if error_feedback:
        raise ValueError(
            "quorum= does not compose with error_feedback: a "
            "dropped-or-stale payload would orphan its residual and "
            "the telescoping bound no longer holds — run one or the "
            "other")
    if survivor_exact:
        raise ValueError(
            "quorum= does not compose with elastic membership "
            "(track_ok_bits/survivor_exact): elastic SHRINKS the "
            "roster while quorum rides out stragglers at fixed "
            "membership — the two disagree about who is in the mean")
    if k_agg:
        raise ValueError(
            "quorum= does not compose with num_aggregate: the "
            "arrival schedule already decides which replicas "
            "contribute each step — a second rotating subset would "
            "double-select")
    if superstep > 1:
        raise ValueError(
            "quorum= needs superstep=1: the host rig feeds each "
            "step's arrival vector at dispatch time, and a fused "
            "K-step scan has no per-step host boundary to feed it "
            "through")
    if stream_encode:
        raise ValueError(
            "quorum= does not compose with stream_encode yet: the "
            "layer-bucket encode pipeline is not ring-carry-aware")
    if track_quality:
        raise ValueError(
            "quorum= does not compose with track_quality: the "
            "per-layer probe describes THIS step's encode while the "
            "consumed payloads may be stale — mis-attribution, "
            "rejected honestly")
    if oracle:
        raise ValueError("_oracle_parts drives the delayed-overlap oracle only")


def make_distributed_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    codec=None,
    *,
    aggregate: str = "gather",
    augment: bool = False,
    num_aggregate: int = 0,
    ring_bucket_size: int = 65536,
    compute_dtype=None,
    grad_accum: int = 1,
    hybrid=None,
    error_feedback: bool = False,
    superstep: int = 1,
    overlap: str = "off",
    stream_encode: bool = False,
    stream_bucket_bytes: int = 4 << 20,
    guard=None,
    chaos=None,
    remedy=None,
    track_grad_norm: bool = False,
    track_ok_bits: bool = False,
    survivor_exact: bool = False,
    track_quality: bool = False,
    zero1=None,
    sharded_update=None,
    quorum=None,
    mesh=None,
    inner_axis: Optional[str] = None,
    plan=None,
    _oracle_parts: bool = False,
    _phase_parts: bool = False,
):
    """Build the step ``(state, key, images, labels, draws=None,
    dropout_masks=None) -> (state, metrics)`` of this rank, over ``model``
    (which ``state.model`` must be) in the initialized process group.

    ``images`` (NCHW float32) and ``labels`` are this rank's shard
    (:func:`shard_batch`) on the model's device. ``draws`` (one entry per
    leaf, as :func:`~atomo_tpu_torch.codecs.encode_tree` takes them) and
    ``dropout_masks`` (one keep-mask per ``Dropout`` call, in call order
    over the microbatches) replace the step's own draws: the hooks through
    which a parity test hands each rank the JAX package's draws for its
    replica. ``metrics`` holds the dp means of ``loss``, ``prec1`` and
    ``prec5`` as 0-d tensors (no host sync) and ``msg_bytes`` and
    ``dense_bytes`` as ints. ``compute_dtype`` runs forward and backward in
    mixed precision (:func:`~atomo_tpu_torch.training.trainer.forward`);
    the exchange sees float32 gradients either way. ``grad_accum`` K > 1
    splits this rank's batch into K microbatches (it raises a
    ``ValueError`` when K does not divide the batch). ``hybrid`` (a
    :class:`~atomo_tpu_torch.sparse.HybridPlan` over this model's leaves)
    runs the per-layer sparse-row exchange (:func:`hybrid_mean`; gather or
    ring with a codec, no ``num_aggregate``) and adds ``row_overflow`` to
    ``metrics``. ``error_feedback`` feeds each rank's residual
    (``state.residual``) into its encode, carries the new one in the
    returned state and adds ``ef_res_norm`` to ``metrics``.

    ``stream_encode`` (gather or ring with a codec) encodes the gradient
    per layer bucket of ``stream_bucket_bytes`` dense bytes
    (:func:`~atomo_tpu_torch.parallel.common.plan_layer_buckets`), each
    bucket issued from a backward hook when its last gradient is ready
    (:class:`~atomo_tpu_torch.parallel.overlap.BucketStream`): under gather
    its payloads go out in an ``all_gather`` of their own as soon as they
    are encoded, and one tree decode reads every bucket's gathered rows in
    place; under ring each bucket rotates in a mini-ring of its own
    (``_ring_stream_mean_layered``). The payloads, and so the trajectory,
    equal ``stream_encode=False``'s bit for bit for any bucket size.
    ``step.stream_log`` is the last step's readiness and issue log.

    ``overlap='delayed'`` (gather or ring with a codec; no error feedback,
    no hybrid) is the stale-by-one step: at step t the rank encodes grads_t
    on the current parameters into its carry, while the optimizer applies
    the mean of the payloads the ranks carried out of step t - 1, exchanged
    and decoded on a side stream issued at the step's start. The state must
    carry an :class:`~atomo_tpu_torch.parallel.overlap.OverlapCarry`
    (:func:`init_delayed_state`). Step 0 (the carry not valid yet) applies
    nothing: parameters, optimizer state and BatchNorm statistics hold, and
    ``metrics["skipped"]`` is 1; ``num_aggregate`` picks its subset by the
    producing step's counter; ``stream_encode`` streams the produce side.
    ``_oracle_parts`` returns instead ``{"produce", "apply"}``, the two
    halves as plain calls (:func:`make_delayed_oracle_steps`).

    ``superstep`` K > 1 returns the block step over this rank's shard of
    each step of a (K, batch, ...) block (:func:`shard_superbatch`), as
    :func:`~atomo_tpu_torch.training.trainer.make_train_step` returns it:
    the K sequential steps, (K,) metrics, the hooks lists of per-step
    values; a step that :func:`~atomo_tpu_torch.training.graph.graph_rule`
    qualifies (NCCL, a codec with a device form, no ``num_aggregate``, no
    ring above one rank, no stream-encode) is one CUDA graph replayed K
    times.

    The guard (``atomo_tpu/parallel/replicated.py:1490-1840``): ``chaos``
    poisons this rank's raw gradient at its steps (replica ``rank``; a
    starred fault every rank); ``guard`` screens it (finiteness, the norm
    ceiling) and masks an unhealthy rank's contribution out of the
    exchange, the survivors' mean rescaled by n/kept: gather all-gathers
    the flags and decodes with them (the QSGD tree kernel leaves a flagged
    replica out, other codecs decode masked payloads; with
    ``num_aggregate`` the flags take the payloads' rotating subset), the
    ring rotates each payload's flag with it and masks the arrival before
    staging, psum sums ``where(ok, g, 0)`` and the survivors' count in one
    all-reduce. Under ``stream_encode`` the flags reach the gathered rows'
    decode, and the ring's bucket rings wait for the flag (after
    backward); under ``overlap="delayed"`` the producing step's flags
    travel with the carried payload and the consuming step masks with
    them. A step with no survivor holds parameters, optimizer state and
    BatchNorm statistics (``metrics["skipped"]`` 1); ``metrics["dropped"]``
    counts the masked contributions; loss, precision, grad norm and the
    BatchNorm statistics are means over the healthy ranks. ``remedy``
    scales the mean by the rewarm ramp; ``track_grad_norm`` adds
    ``metrics["grad_norm"]``.

    ``track_quality`` (``atomo_tpu/parallel/replicated.py:1261-1275,
    1730-1737,1948-1957``) adds ``metrics["q_err2"]`` and ``metrics["q_rel"]``:
    each rank's per-layer error of its own encode (the encode's input: g, or
    g + e under error feedback), (L,) in the canonical leaf order, averaged
    over the ranks (over the healthy ranks under the guard) in the one
    all-reduce the step makes for its metrics. The error-feedback decode and
    psum's local decode are this rank's own, so the probe shares them;
    gather and ring decode the rank's payloads once more (one tree decode,
    one replica), the hybrid decodes its row leaves losslessly (they read
    0). It needs a codec and the blocking step: ``overlap='delayed'``'s
    carry describes the previous step.

    ``zero1`` and ``sharded_update`` (the specs of
    :func:`~atomo_tpu_torch.mesh.update.zero1_state` or
    :func:`~atomo_tpu_torch.mesh.update.sharded_update_state`, one or the
    other; ``atomo_tpu/parallel/replicated.py:399-463,1849-1876,2181-2195``)
    partition the update over the group's ranks. ZeRO-1 updates this rank's
    slice of the flat parameter vector with its flat optimizer slice (the
    mean gradient's matching slice) and one ``all_gather_into_tensor``
    rebuilds the replicated parameters. The sharded update steps a
    :class:`~atomo_tpu_torch.mesh.update.ShardedUpdateState`: at the
    step's start one ``all_gather_into_tensor`` of the masters fills the
    working buffer whose views the parameters are
    (``step.materialize_params``), after the exchange this rank's (master,
    optimizer) slice is updated (``step.sharded_update``) with no closing
    gather, and the eager step releases the working buffer and the
    gradients after it (a graph keeps them: static graph memory). Both
    compose with every exchange, ``num_aggregate``, ``stream_encode``,
    ``superstep``, chaos, the quality probe, mixed precision,
    ``grad_accum``, the guard (a skipped step holds the slices) and
    ``overlap='delayed'``; ZeRO-1 with ``hybrid`` too. Their trajectories
    equal the replicated one's bit for bit.

    ``aggregate='hierarchical'`` (``atomo_tpu/parallel/replicated.py:
    1155-1210,1486-1510,1630-1680``) runs the two-tier exchange over
    ``mesh``, the group's two-tier :class:`~atomo_tpu_torch.mesh.spec.
    ProcessMesh` (``MeshSpec.from_world(N, K).build()``), with
    ``inner_axis`` its fast axis (``"ici"``) and a codec:
    :func:`~atomo_tpu_torch.topology.execute.planned_two_level_mean` runs
    ``plan`` (an :class:`~atomo_tpu_torch.topology.schedule.AggregationPlan`;
    None is the legacy plan, ``psum+gather``: a dense mean over the ``ici``
    group, the group-keyed boundary encode, one ``all_gather`` over the
    ``dp`` group and one tree decode over its K rows). Every rank is its own
    data shard and dropout stream (rank = chip id = outer * N/K + inner);
    the codec keys are the per-group outer key and, under a ``cring``
    inner, the per-card inner key, and ``draws=`` takes a dict of
    ``inner`` and ``outer`` draws (a list is the outer encode's). The guard
    screens the inner-reduced gradient, so an inner group is the unit
    dropped (``metrics["dropped"]`` counts groups) and the survivors' mean
    is rescaled by K/kept; the BatchNorm statistics and the metrics are
    means over the whole world, ZeRO-1 and the sharded update slice over
    it. ``msg_bytes`` is this rank's bytes on the slow tier. It refuses
    delayed overlap, stream-encode, error feedback, ``hybrid``,
    ``track_quality``, ``survivor_exact``, ``quorum`` and
    ``num_aggregate`` with the JAX package's texts."""
    if superstep < 1:
        raise ValueError(f"superstep must be >= 1, got {superstep}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    rank, world = _group()
    params = leaf_params(model)
    hier = aggregate == "hierarchical"
    _check_hierarchical(codec, aggregate, mesh, inner_axis, plan, world,
                        track_ok_bits=track_ok_bits and guard is not None,
                        survivor_exact=survivor_exact, track_quality=track_quality)
    # the ways the exchange averages over: the outer groups when two-tier
    n_ways = mesh.size("dp") if hier else world
    if track_ok_bits and guard is None:
        raise ValueError(
            "track_ok_bits reports the guard's per-replica screen "
            "verdicts; arm guard= (the elastic membership layer has "
            "nothing to observe without the screen)")
    if track_ok_bits:
        raise ValueError(
            "track_ok_bits belongs to the elastic membership layer, which is not "
            "ported (ROADMAP queue 1 item 11)")
    if track_quality:
        if codec is None:
            raise ValueError(
                "track_quality (--obs-quality) probes the codec's "
                "estimator error; dense training has no estimator to "
                "probe — drop one")
        if overlap == "delayed":
            raise ValueError(
                "track_quality needs flat blocking aggregation: the "
                "hierarchical boundary re-encode composes two estimators "
                "per layer and the delayed carry's payload describes the "
                "PREVIOUS step — neither is per-layer-probe-aware yet; "
                "rejected honestly rather than silently mis-attributed")
    if error_feedback:
        k_pre = num_aggregate if 0 < num_aggregate < n_ways else 0
        _check_error_feedback(codec, hybrid, k_pre, overlap, guard, hier)
        if zero1 is not None or sharded_update is not None:
            raise ValueError(
                "error_feedback does not compose with zero1/"
                "sharded-update yet: the residual carry is untested "
                "against the sharded state templates")
    part = _check_partition(zero1, sharded_update, hybrid, world,
                            _oracle_parts or _phase_parts, survivor_exact)
    su = sharded_update
    if hybrid is not None:
        _check_hybrid(hybrid, len(params), codec, aggregate, num_aggregate, world, overlap,
                      stream_encode, guard)
    if quorum is not None:
        _check_quorum(quorum, codec, aggregate, world, overlap=overlap, hybrid=hybrid,
                      partition=part, error_feedback=error_feedback,
                      survivor_exact=survivor_exact,
                      k_agg=num_aggregate if 0 < num_aggregate < world else 0,
                      superstep=superstep, stream_encode=stream_encode,
                      track_quality=track_quality, oracle=_oracle_parts)
    aggregate, k_agg = _check_aggregate(codec, aggregate, num_aggregate, n_ways)
    _check_overlap(codec, aggregate, overlap, stream_encode)
    if hier and (_oracle_parts or _phase_parts):
        raise ValueError("the oracle and phase programs drive the flat exchange")
    two_tier_plan = LEGACY_PLAN if plan is None else plan
    if _oracle_parts and (overlap != "delayed" or guard is not None):
        raise ValueError("_oracle_parts only applies to overlap='delayed', unguarded")
    n_contrib = k_agg or n_ways
    names = jax_leaf_order(model)
    layouts = jax_layouts(model)
    stats = list(model.buffers())  # the BatchNorm statistics, Flax's batch_stats
    device = params[0].device
    plan = plan_layer_buckets(params, stream_bucket_bytes) if stream_encode else None
    # a codec whose encode syncs has its buckets encoded after backward
    hooked = stream_encode and encode_syncs(codec) is None
    enc_stream = side_stream(device) if hooked else None
    cons_stream = side_stream(device) if overlap == "delayed" else None
    log_holder: dict = {}
    if chaos is not None:
        chaos.prepare(device)
    guarded = Guarded(optimizer, params, stats, device) if guard is not None else None
    if part is not None and part.flat.device != device:
        raise ValueError(f"the partition's flat buffer is on {part.flat.device}, the model on "
                         f"{device}: build the specs from this model")
    # svd's eigh refuses non-finite input where XLA's returns NaN: under the
    # guard its encode takes the gradient with non-finite entries zeroed (an
    # unhealthy replica's payload is masked out either way, and a healthy
    # one's gradient is finite, so every output is the same; a two-tier
    # ``cring`` inner screens each card's raw gradient for that reason)
    finite_encode = guard is not None and encode_syncs(codec) is not None

    def encodable(grads):
        return [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for g in grads] \
            if finite_encode else grads

    def poison(grads, step_index):
        """This rank's gradient with its chaos faults (1-based step)."""
        return grads if chaos is None else chaos.inject_grads(grads, step_index + 1,
                                                              replica=rank)

    def probe(payloads, grads, own):
        """The quality series of this rank's payloads (``own`` its decode
        when the step has one), or None when the probe is off."""
        if not track_quality:
            return None
        with record_function("step.quality"):
            if own is not None:
                return quality_from_decoded(own, grads)
            return quality_probe(codec, payloads, grads, layouts)

    def exchange(state: TrainState, k_codec: int, grads, draws, dense_bytes: int, ok=None):
        """(mean gradient in the port layout, message bytes, this rank's own
        decode of its payloads under ``error_feedback``, else None, the
        surviving contributions under the guard, else None, and the quality
        series under ``track_quality``, else None)."""
        if codec is None:
            with record_function("step.exchange"):
                if ok is not None:
                    mean, kept = masked_mean(grads, ok, world)
                    return mean, dense_bytes, None, kept, None
                return (_views_like(_all_reduce_mean(_flat(grads), world), grads), dense_bytes,
                        None, None, None)
        with record_function("step.encode"):
            payloads, cstats = encode_tree(codec, k_codec, encodable(grads), draws, layouts)
        own = None
        if error_feedback and aggregate != "psum":
            with record_function("step.ef_decode"):
                own = decode_tree(codec, payloads, grads, layouts)
        qm = probe(payloads, grads, own) if aggregate != "psum" else None
        sel_start = state.step % world if k_agg else None
        kept = None
        if aggregate == "gather":
            with record_function("step.exchange"):
                gathered, spec = gather_payloads(payloads, world)
                okg = gather_flags(ok, world) if ok is not None else None
            with record_function("step.decode_mean"):
                if k_agg:
                    gathered = _rotating_rows(gathered, sel_start, k_agg)
                    if okg is not None:
                        okg = _rotating_rows(okg.view(world, 1), sel_start, k_agg).reshape(-1)
                parts = unpack_tree_buckets(gathered, spec)
                if okg is not None and survivor_exact:
                    # one division by the kept count: the caller does not rescale
                    mean = survivor_decode_mean(codec, parts, okg, grads, layouts)
                else:
                    mean = decode_mean_tree(codec, parts, grads, n_contrib, layouts,
                                            replica_ok=okg)
                if okg is not None:
                    kept = okg.sum()
                    if not survivor_exact:
                        mean = rescale_by_survivors(mean, n_contrib, kept)
            return mean, cstats.payload_bytes, own, kept, qm
        if aggregate == "ring":
            with record_function("step.ring_exchange_decode"):
                mean = ring_stream_mean(codec, payloads, grads, rank=rank, world=world,
                                        sel_start=sel_start, n_contrib=n_contrib,
                                        ring_bucket_size=ring_bucket_size, layouts=layouts,
                                        ok=ok, survivor_exact=survivor_exact)
                if ok is not None:
                    mean, kept = mean
                    if not survivor_exact:
                        mean = rescale_by_survivors(mean, n_contrib, kept)
            return mean, cstats.payload_bytes, own, kept, qm
        with record_function("step.decode"):
            decoded = decode_tree(codec, payloads, grads, layouts)
        qm = probe(payloads, grads, decoded)
        with record_function("step.exchange"):
            if ok is not None:
                mean, kept = masked_mean(decoded, ok, world)
            else:
                mean = _views_like(_all_reduce_mean(_flat(decoded), world), grads)
        # the all-reduce moves dense gradients; its local decode is the own one
        return mean, dense_bytes, decoded if error_feedback else None, kept, qm

    def bucket_stream(state: TrainState, k_codec, draws, wire: bool,
                      step_index=0) -> BucketStream:
        """This step's :class:`BucketStream`; ``wire`` puts each bucket on
        the gather's or the ring's wire as soon as it is encoded (the
        blocking step, its :class:`BucketWire` as ``bs.wire``), else the
        payloads wait for the carry (delayed). Chaos poisons each leaf as
        it is fed (its faults are elementwise)."""
        residual = state.residual if error_feedback else None
        bw = BucketWire(codec, plan, layouts, aggregate=aggregate, rank=rank, world=world,
                        n_contrib=n_contrib, ring_bucket_size=ring_bucket_size,
                        sel_start=state.step % world if k_agg else None,
                        stream=enc_stream, deferred=guarded is not None,
                        survivor=survivor_exact) if wire else None

        def feed(i, g):
            g = poison([g], step_index)[0]
            return g if residual is None else g + residual[i]

        if finite_encode:
            raw = feed
            feed = lambda i, g: encodable([raw(i, g)])[0]  # noqa: E731

        bs = BucketStream(plan, codec, k_codec, layouts=layouts, draws=draws, feed=feed,
                          on_encoded=bw, hooked=hooked, stream=enc_stream)
        bs.wire = bw
        return bs

    def accumulate(images, labels, k_drop: int, dropout_masks, bs: Optional[BucketStream]):
        """(mean gradient over the microbatches, mean loss, prec@1, prec@5).
        With ``bs`` the last microbatch's gradients reach the bucket stream,
        whose feed adds them and takes the mean (the encode's input)."""
        b = images.shape[0]
        if b % grad_accum:
            raise ValueError(f"per-chip batch {b} not divisible by grad_accum={grad_accum}")
        mb = b // grad_accum
        if compute_dtype is None:
            run, targets = model, params
        else:  # the parameters cast once for the K microbatches
            cast = {n: p.detach().to(compute_dtype).requires_grad_()
                    for n, p in zip(names, params)}
            targets = [cast[n] for n in names]

            def run(x):
                return functional_call(model, cast, (x.to(compute_dtype),)).float()

        g_sum = [torch.zeros_like(p) for p in params]
        if bs is not None:
            fed = bs.feed
            bs.feed = lambda i, g: fed(i, _mean(g_sum[i].add_(g.float()), grad_accum))
        sums = torch.zeros(3, dtype=torch.float32, device=images.device)
        # given masks run through the microbatches in call order; else
        # microbatch i draws under fold_in(k_drop, i)
        given = dropout_masks is not None
        with dropout_stream(masks=dropout_masks) if given else contextlib.nullcontext():
            for i in range(grad_accum):
                x, y = images[i * mb:(i + 1) * mb], labels[i * mb:(i + 1) * mb]
                last = bs is not None and i == grad_accum - 1
                if last:  # only the last microbatch completes a bucket
                    bs.arm(targets)
                with contextlib.nullcontext() if given else dropout_stream(fold_in(k_drop, i)):
                    logits = run(x)
                    loss = F.cross_entropy(logits, y)
                    if last:
                        # the same gradient, into the targets' .grad: the
                        # readiness hooks do not take autograd.grad's leaves
                        loss.backward(inputs=list(targets))
                    else:
                        grads = torch.autograd.grad(loss, targets)
                if not last:
                    for a, g in zip(g_sum, grads):
                        a.add_(g.float())
                prec1, prec5 = accuracy(logits.detach(), y)
                sums += torch.stack([loss.detach(), prec1, prec5])
        m = _mean(sums, grad_accum)
        if bs is not None:
            return None, m[0], m[1], m[2]
        return [_mean(g, grad_accum) for g in g_sum], m[0], m[1], m[2]

    def forward_backward(images, labels, k_drop, dropout_masks, bs: Optional[BucketStream]):
        """(gradients, loss, prec@1, prec@5) of this rank's shard; with
        ``bs`` the bucket stream is armed on the tensors whose gradients
        the step takes, and the gradients come back None (its inputs are
        the encode's)."""
        with record_function("step.forward_backward"):
            if grad_accum > 1:
                return accumulate(images, labels, k_drop, dropout_masks, bs)
            with dropout_stream(k_drop, dropout_masks):
                if bs is not None:
                    bs.arm(params)
                logits = forward(model, images, compute_dtype)
                loss = F.cross_entropy(logits, labels)
                loss.backward()
            prec1, prec5 = accuracy(logits.detach(), labels)
            return [p.grad for p in params], loss.detach(), prec1, prec5

    def begin(images, aug):
        if augment:
            images = augment_with(images, aug)
        model.train()
        for p in params:
            p.grad = None
        return images

    def materialize(state: TrainState) -> None:
        """The sharded update's working parameters from every rank's master."""
        if su is None:
            return
        if getattr(state, "master", None) is None:
            raise ValueError("sharded_update steps a ShardedUpdateState: build it with "
                             "mesh.update.sharded_update_state")
        with record_function("step.materialize_params"):
            su.materialize(state.master)

    def apply_update(state: TrainState, mean, opt_scalars):
        """The optimizer's update of the partition in effect; returns the
        optimizer state."""
        if su is not None:  # this rank's (master, optimizer) slice, no gather
            with record_function("step.sharded_update"):
                return optimizer.update([su.grad_slice(mean)], state.opt_state, [state.master],
                                        scalars=opt_scalars)
        with record_function("step.update"):
            if zero1 is None:
                return optimizer.update(mean, state.opt_state, params, scalars=opt_scalars)
            own = zero1.own(zero1.flat)  # this rank's slice of the parameters, a view
            opt_state = optimizer.update([zero1.grad_slice(mean)], state.opt_state, [own],
                                         scalars=opt_scalars)
            if world > 1:  # the updated slices rebuild the replicated parameters
                dist.all_gather_into_tensor(zero1.flat, own.clone())
            return opt_state

    def update_and_stats(state: TrainState, mean, opt_scalars, local=None, ok=None,
                         with_stats: bool = True):
        """The optimizer's update, then the dp means of the BatchNorm
        statistics and of the ``local`` metrics (scalars, then any per-layer
        series, flattened in order; one ``all_reduce`` each);
        with ``ok`` (the guard) means over the healthy ranks only, the
        JAX package's ``_healthy_mean``: ``where(ok, x, 0)`` summed with the
        healthy count, divided by max(count, 1). Returns (optimizer state,
        metric means, healthy ranks or None). ``mean`` None updates nothing,
        ``with_stats`` False leaves the statistics alone."""
        if mean is not None:
            opt_state = apply_update(state, mean, opt_scalars)
        else:
            opt_state = state.opt_state
        with torch.no_grad():
            if ok is None:
                if stats and with_stats:
                    flat = _all_reduce_mean(_flat(stats), world)
                    for s, v in zip(stats, _views_like(flat, stats)):
                        s.copy_(v)
                m = None if local is None else _all_reduce_mean(_flat(local), world)
                return opt_state, m, None
            okf = ok.to(torch.float32).reshape(1)
            kept_chips = None
            if stats and with_stats:
                flat = torch.cat([_flat(zero_if(~ok, stats)), okf])
                if world > 1:
                    dist.all_reduce(flat)
                kept_chips = flat[-1]
                for s, v in zip(stats, _views_like(flat[:-1] / torch.clamp(kept_chips, min=1.0),
                                                   stats)):
                    s.copy_(v)
            m = None
            if local is not None:
                flat = torch.cat([_flat(zero_if(~ok, local)), okf])
                if world > 1:
                    dist.all_reduce(flat)
                kept_chips = flat[-1]
                m = flat[:-1] / torch.clamp(kept_chips, min=1.0)
        return opt_state, m, kept_chips

    def core(state: TrainState, images, labels, *, aug, k_drop, k_codec, opt_scalars=None,
             step_t=None, count_t=None, draws: Optional[Sequence[Any]] = None,
             dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        """The step on given keys (ints, or the device form: ``aug`` drawn,
        ``k_codec`` a 0-d device tensor, ``opt_scalars`` the optimizer's
        device values, ``step_t`` and ``count_t`` the step and the
        optimizer's count as 0-d device integers)."""
        materialize(state)
        images = begin(images, aug)
        step_index = state.step if step_t is None else step_t  # 0-based
        if guarded is not None:
            guarded.snapshot(state)  # before forward: it moves the statistics
        bs = (bucket_stream(state, k_codec, draws, wire=True, step_index=step_index)
              if stream_encode else None)
        grads, loss, prec1, prec5 = forward_backward(images, labels, k_drop, dropout_masks, bs)
        if bs is not None:
            with record_function("step.encode"):
                payloads = bs.finish()
            log_holder["log"] = bs.log
            grads = bs.inputs  # the encode's input: g, or g + e
        else:
            grads = poison(grads, step_index)
            if error_feedback and state.residual is not None:
                # the encode's input is g + e (a fresh carry is zero: g as it is)
                grads = [g + e for g, e in zip(grads, state.residual)]
        gnorm = torch.sqrt(global_sq_norm(grads)) if track_grad_norm else None
        # the raw gradient is screened before the encode: a codec carries
        # NaN and Inf into its payloads, where they could not be told apart
        # (two-tier: the inner-reduced gradient is, inside the exchange)
        ok = grad_ok(grads, guard.max_grad_norm) if guarded is not None and not hier else None
        dense_bytes = tree_nbytes(grads)
        overflow = residual = kept = qm = None
        if hier:
            k_inner, k_outer = k_codec
            mean, ok, kept, msg_bytes = planned_two_level_mean(
                codec, two_tier_plan, grads, k_inner, k_outer, mesh=mesh, inner_axis=inner_axis,
                guard=guard if guarded is not None else None, ring_bucket_size=ring_bucket_size,
                layouts=layouts, draws=draws, encodable=encodable)
        elif hybrid is not None:
            with record_function("step.hybrid_exchange"):
                mean, msg_bytes, overflow, qm = hybrid_mean(
                    codec, hybrid, grads, k_codec, rank=rank, world=world,
                    aggregate=aggregate, ring_bucket_size=ring_bucket_size, layouts=layouts,
                    draws=draws, track_quality=track_quality)
        elif bs is not None:
            own = None
            if error_feedback:
                with record_function("step.ef_decode"):
                    own = decode_tree(codec, payloads, grads, layouts)
            qm = probe(payloads, grads, own)
            mean = bs.wire.mean(grads, ok=ok)
            if ok is not None:
                mean, kept = mean
                if not survivor_exact:
                    mean = rescale_by_survivors(mean, n_contrib, kept)
            msg_bytes = sum(payload_nbytes(p) for p in payloads)
        else:
            mean, msg_bytes, own, kept, qm = exchange(state, k_codec, grads, draws, dense_bytes,
                                                      ok)
        if remedy is not None:
            mean = apply_remedy(remedy, step_index, mean)
        local = [loss, prec1, prec5] + ([gnorm] if gnorm is not None else [])
        if error_feedback:
            with torch.no_grad():
                # the part of the fed gradient that the wire did not carry
                residual = [g.float() - d.float() for g, d in zip(grads, own)]
                if state.residual is not None:
                    # in place, as the momentum buffers: a CUDA graph reads
                    # the same buffers at every replay
                    for r, new in zip(state.residual, residual):
                        r.copy_(new)
                    residual = state.residual
                local.append(torch.sqrt(sum(torch.sum(r * r) for r in residual)))
        held = None
        if guarded is not None:
            held = guarded.held(state)
            opt_scalars = guarded.opt_scalars(state, held, count_t)
        n_scalars = len(local)
        if qm is not None:  # the per-layer series ride the metrics' one reduce
            local = local + [qm["q_err2"], qm["q_rel"]]
        opt_state, m, _ = update_and_stats(state, mean, opt_scalars, local, ok)
        if qm is not None:  # the rank means of the series
            qm = dict(zip(("q_err2", "q_rel"), m[n_scalars:].view(2, -1)))
            m = m[:n_scalars]
        metrics = {"loss": m[0], "prec1": m[1], "prec5": m[2], "msg_bytes": msg_bytes,
                   "dense_bytes": dense_bytes, **(qm or {})}
        if gnorm is not None:
            metrics["grad_norm"] = m[3]
        if overflow is not None:
            metrics["row_overflow"] = overflow
        if error_feedback:
            metrics["ef_res_norm"] = m[-1]
        if guarded is not None:
            ok_step = kept > 0  # any survivor: the rescaled mean applies
            guarded.hold(ok_step, state, held)
            metrics["skipped"] = 1.0 - ok_step.to(torch.float32)
            metrics["dropped"] = n_contrib - kept
        return dataclasses.replace(state, step=state.step + 1, model=model, opt_state=opt_state,
                                   residual=residual, held=held), metrics

    # ---------------------------------------------- overlap='delayed'

    def produce(state: TrainState, images, labels, *, aug, k_drop, k_codec, draws,
                dropout_masks, step_index=None):
        """Forward, backward and encode on the CURRENT parameters (the
        JAX package's ``delayed_produce``): (payloads, encode input, loss,
        prec@1, prec@5). The BatchNorm statistics are this step's forward's,
        in place. Chaos poisons the gradient before the encode."""
        step_index = state.step if step_index is None else step_index
        images = begin(images, aug)
        bs = (bucket_stream(state, k_codec, draws, wire=False, step_index=step_index)
              if stream_encode else None)
        grads, loss, prec1, prec5 = forward_backward(images, labels, k_drop, dropout_masks, bs)
        with record_function("step.encode"):
            if bs is not None:
                payloads = bs.finish()
                log_holder["log"] = bs.log
                grads = bs.inputs
            else:
                grads = poison(grads, step_index)
                payloads, _ = encode_tree(codec, k_codec, encodable(grads), draws, layouts)
        return payloads, grads, loss, prec1, prec5

    def consume_carry(state: TrainState, carry: OverlapCarry):
        """The mean of the payloads the ranks carried out of step
        ``state.step - 1`` (its counter picks the ``num_aggregate`` subset);
        under the guard ``(mean rescaled by the survivors, kept)``, masked
        by the producing step's flags."""
        sel_start = (state.step - 1) % world if k_agg else None
        out = consume(codec, carry, [p.detach() for p in params], aggregate=aggregate,
                      rank=rank, world=world, sel_start=sel_start, n_contrib=n_contrib,
                      ring_bucket_size=ring_bucket_size, layouts=layouts,
                      guard=guarded is not None)
        if guarded is None:
            return out
        mean, kept = out
        return rescale_by_survivors(mean, n_contrib, kept), kept

    def skip_metrics(skipped: bool) -> dict:
        # device constants (fills, not host copies): a graph captures them
        z = torch.zeros((), dtype=torch.float32, device=device)
        return {"skipped": z + 1 if skipped else z, "dropped": torch.zeros_like(z)}

    def delayed_core(state: TrainState, images, labels, *, aug, k_drop, k_codec,
                     opt_scalars=None, step_t=None, count_t=None,
                     draws: Optional[Sequence[Any]] = None,
                     dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        carry = state.carry
        if not isinstance(carry, OverlapCarry):
            raise ValueError("overlap='delayed' steps a state that carries its in-flight "
                             "payload: build it with init_delayed_state")
        step_index = state.step if step_t is None else step_t
        materialize(state)
        if guarded is not None:
            guarded.snapshot(state)
        mean = None
        if carry.valid:  # the exchange and decode run under forward and backward
            mean = issue_consume(cons_stream, lambda: consume_carry(state, carry))
        held = None if carry.valid or not stats else [s.clone() for s in stats]
        payloads, grads, loss, prec1, prec5 = produce(
            state, images, labels, aug=aug, k_drop=k_drop, k_codec=k_codec, draws=draws,
            dropout_masks=dropout_masks, step_index=step_index)
        buf, _, msg_bytes = pack_payloads(payloads)
        dense_bytes = tree_nbytes(grads)
        gnorm = torch.sqrt(global_sq_norm(grads)) if track_grad_norm else None
        ok = okg = kept = count_held = None
        if guarded is not None:
            ok = grad_ok(grads, guard.max_grad_norm)
            okg = gather_flags(ok, world)  # travels with this step's payload
        local = [loss, prec1, prec5] + ([gnorm] if gnorm is not None else [])
        consume_ok = None
        if carry.valid:
            join(cons_stream, mean)
            if guarded is not None:
                mean, kept = mean
                count_held = guarded.held(state)
                opt_scalars = guarded.opt_scalars(state, count_held, count_t)
            if remedy is not None:  # the consuming step's counter drives the ramp
                mean = apply_remedy(remedy, step_index, mean)
            opt_state, m, kept_chips = update_and_stats(state, mean, opt_scalars, local, ok)
            if guarded is not None:
                consume_ok = kept > 0
                # this step's statistics apply only with a healthy forward
                guarded.hold(consume_ok, state, count_held,
                             stats_ok=consume_ok & (kept_chips > 0))
        else:  # step 0 applies nothing: the statistics come back too
            with torch.no_grad():
                for s, h in zip(stats, held or ()):
                    s.copy_(h)
            opt_state, m, _ = update_and_stats(state, None, None, local, ok, with_stats=False)
            count_held = state.held
        with torch.no_grad():
            carry.payload.copy_(buf)  # after the join: the consume read it
            if okg is not None:
                carry.ok.copy_(okg)
        metrics = {"loss": m[0], "prec1": m[1], "prec5": m[2], "msg_bytes": msg_bytes,
                   "dense_bytes": dense_bytes, **skip_metrics(not carry.valid)}
        if gnorm is not None:
            metrics["grad_norm"] = m[3]
        if guarded is not None:
            if consume_ok is not None:
                metrics["skipped"] = 1.0 - consume_ok.to(torch.float32)
                metrics["dropped"] = n_contrib - kept
            if track_grad_norm:
                # the doctor follows this forward, not the consumed payload
                metrics["sample_skipped"] = 1.0 - (okg.sum() > 0).to(torch.float32)
        return dataclasses.replace(state, step=state.step + 1, model=model,
                                   opt_state=opt_state,
                                   carry=dataclasses.replace(carry, valid=True),
                                   held=count_held), metrics

    # ----------------------------------------------------------- quorum=

    k_bound = quorum.staleness if quorum is not None else 0
    depth = k_bound + 1
    held_q = None
    if quorum is not None:
        # a kept count of zero holds the parameters and the optimizer state,
        # guard or not: the guard's fixed snapshot buffers serve that hold
        held_q = guarded if guarded is not None else Guarded(optimizer, params, stats, device)

    def quorum_core(state: TrainState, images, labels, arrivals, *, aug, k_drop, k_codec,
                    draws: Optional[Sequence[Any]] = None,
                    dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        """The bounded-staleness quorum step (``spmd_quorum``,
        ``atomo_tpu/parallel/replicated.py:2331-2540``). ``arrivals`` is the
        host rig's (N,) staleness vector: this rank's entry sigma picks the
        payload produced sigma steps ago from its ring; a sigma outside [0,
        K] (dropped, absent, or a corrupted schedule) or an unwritten or
        unhealthy slot contributes nothing."""
        carry = state.ring
        if not isinstance(carry, QuorumCarry):
            raise ValueError("quorum= steps a state that carries its staleness ring: build "
                             "it with init_quorum_state")
        arrivals = [int(a) for a in np.asarray(arrivals).reshape(-1)]
        if len(arrivals) != world:
            raise ValueError(f"arrivals has {len(arrivals)} entries for a {world}-rank group")
        step_index = state.step
        images = begin(images, aug)
        held_q.snapshot(state)  # before forward: it moves the statistics
        grads, loss, prec1, prec5 = forward_backward(images, labels, k_drop, dropout_masks,
                                                     None)
        grads = poison(grads, step_index)
        gnorm = torch.sqrt(global_sq_norm(grads)) if track_grad_norm else None
        ok = grad_ok(grads, guard.max_grad_norm) if guarded is not None else None
        dense_bytes = tree_nbytes(grads)
        with record_function("step.encode"):
            payloads, cstats = encode_tree(codec, k_codec, encodable(grads), draws, layouts)
            buf, _ = pack_tree_buckets(payloads)
        with torch.no_grad():
            # this step's payload into slot step mod (K+1), its health beside it
            slot = step_index % depth
            carry.ring[slot].copy_(buf)
            if ok is not None:
                carry.ring_ok[slot].copy_(ok.to(torch.float32))
            else:
                carry.ring_ok[slot].fill_(1.0)
            sigma = arrivals[rank]
            sel = (step_index - sigma) % depth
            sel_payload = carry.ring[sel]
            # the staleness bound and the warm-up gate: sigma outside [0, K]
            # masks out, and an unwritten slot's flag is 0
            present = carry.ring_ok[sel] * float(0 <= sigma <= k_bound)
        if aggregate == "gather":
            with record_function("step.quorum_exchange"):
                # one payload a rank, whatever its staleness: blocking's wire
                rows = sel_payload.view(1, -1)
                if world > 1:
                    rows = torch.empty((world, sel_payload.numel()), dtype=torch.uint8,
                                       device=sel_payload.device)
                    dist.all_gather_into_tensor(rows.view(-1), sel_payload)
                okg = gather_flags(present, world)
            kept = okg.sum()
            with record_function("step.quorum_decode_mean"):
                mean = survivor_decode_mean(codec, unpack_tree_buckets(rows, carry.spec), okg,
                                            grads, layouts)
        else:
            with record_function("step.quorum_ring_exchange_decode"):
                mean, kept = ring_stream_mean(
                    codec, unpack_tree_buckets(sel_payload, carry.spec), grads, rank=rank,
                    world=world, n_contrib=world, ring_bucket_size=ring_bucket_size,
                    layouts=layouts, ok=present, survivor_exact=True)
        if remedy is not None:
            mean = apply_remedy(remedy, step_index, mean)
        held = held_q.held(state)
        opt_scalars = held_q.opt_scalars(state, held)
        local = [loss, prec1, prec5] + ([gnorm] if gnorm is not None else [])
        opt_state, m, kept_chips = update_and_stats(state, mean, opt_scalars, local, ok)
        ok_step = kept > 0  # no payload kept: the step holds
        # the statistics are this step's forward's (the healthy mean under
        # the guard), held with the update, and with no healthy forward
        held_q.hold(ok_step, state, held,
                    stats_ok=None if ok is None else ok_step & (kept_chips > 0))
        metrics = {"loss": m[0], "prec1": m[1], "prec5": m[2],
                   "msg_bytes": cstats.payload_bytes, "dense_bytes": dense_bytes,
                   "skipped": 1.0 - ok_step.to(torch.float32),
                   # contributions absent from this mean, whatever the cause
                   "dropped": world - kept, "quorum_kept": kept,
                   # the schedule's staleness-bound drops alone
                   "stale_dropped": float(sum(1 for a in arrivals if a == DROPPED))}
        if gnorm is not None:
            metrics["grad_norm"] = m[3]
        return dataclasses.replace(state, step=state.step + 1, model=model,
                                   opt_state=opt_state, held=held), metrics

    if _oracle_parts:
        return _oracle(produce, consume_carry, update_and_stats, skip_metrics, stats, world,
                       split_keys=lambda key, s: split3(fold_in(fold_in(key, s), rank)))
    if _phase_parts:
        return _phase_programs(codec, model, begin, forward_backward, update_and_stats, stats,
                               world, layouts,
                               split_keys=lambda key, s: split3(fold_in(fold_in(key, s), rank)))

    def keys(key: int, step_index: int):
        """(k_aug, k_drop, k_codec) of this rank at step ``step_index``;
        two-tier, k_codec is the pair (per-card inner key, per-group outer
        key) of ``topology.execute``."""
        k_aug, k_drop, k_codec = split3(fold_in(fold_in(key, step_index), rank))
        if hier:
            step_key = fold_in(key, step_index)
            k_codec = (inner_codec_key(step_key, rank),
                       outer_codec_key(step_key, mesh.index("dp")))
        return k_aug, k_drop, k_codec

    if quorum is not None:
        def quorum_step(state: TrainState, key: int, images, labels, arrivals,
                        draws: Optional[Sequence[Any]] = None,
                        dropout_masks: Optional[Sequence[torch.Tensor]] = None):
            k_aug, k_drop, k_codec = keys(key, state.step)
            return quorum_core(state, images, labels, arrivals, aug=k_aug, k_drop=k_drop,
                               k_codec=k_codec, draws=draws, dropout_masks=dropout_masks)

        quorum_step.core = quorum_core
        quorum_step.keys = keys
        quorum_step.stream_log = None
        quorum_step.plan = None
        quorum_step.partition = None
        quorum_step.skips = lambda st: False
        quorum_step.quorum = quorum
        quorum_step.reserve = held_q.table.reserve
        return quorum_step

    run_core = delayed_core if overlap == "delayed" else core

    def step(state: TrainState, key: int, images, labels, draws: Optional[Sequence[Any]] = None,
             dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        k_aug, k_drop, k_codec = keys(key, state.step)
        out = run_core(state, images, labels, aug=k_aug, k_drop=k_drop, k_codec=k_codec,
                       draws=draws, dropout_masks=dropout_masks)
        step.stream_log = log_holder.get("log")
        if su is not None:  # between eager steps a rank holds its slices alone
            su.release(params)
        return out

    step.core = run_core
    step.keys = keys
    step.stream_log = None
    step.plan = plan
    step.partition = part
    # a delayed step whose carry holds nothing yet applies no update
    step.skips = lambda st: overlap == "delayed" and not st.carry.valid
    # the Dropout streams: one a step, or microbatch i's under fold_in(k_drop, i)
    step.drop_keys = (lambda k_drop, n: [k_drop] if grad_accum == 1
                      else [fold_in(k_drop, i) for i in range(n)])
    if guarded is not None:
        step.reserve = guarded.table.reserve
    if superstep == 1:
        return step
    rule = G.graph_rule(device=device, codec=codec, backend=dist.get_backend(), world=world,
                        aggregate=aggregate, k_agg=k_agg, stream_encode=stream_encode)
    return G.make_block_step(step, superstep, optimizer=optimizer, augment=augment,
                             device=device, rule=rule, probe=track_quality)


def _oracle(produce, consume_carry, update_and_stats, skip_metrics, stats, world, split_keys):
    """The two halves of the delayed step as plain calls (see
    :func:`make_delayed_oracle_steps`), built from the step's own closures."""

    def produce_step(state: TrainState, key: int, images, labels, draws=None,
                     dropout_masks=None):
        k_aug, k_drop, k_codec = split_keys(key, state.step)
        held = [s.clone() for s in stats]
        payloads, grads, loss, prec1, prec5 = produce(
            state, images, labels, aug=k_aug, k_drop=k_drop, k_codec=k_codec, draws=draws,
            dropout_masks=dropout_masks)
        buf, spec, msg_bytes = pack_payloads(payloads)
        with torch.no_grad():
            stats_x = [s.clone() for s in stats]
            for s, h in zip(stats, held):  # the statistics wait for the apply
                s.copy_(h)
            m = _all_reduce_mean(torch.stack([loss, prec1, prec5]), world)
        carry = OverlapCarry(payload=buf, spec=spec,
                             ok=torch.ones((world,), dtype=torch.float32, device=buf.device),
                             valid=True)
        return carry, stats_x, {"loss": m[0], "prec1": m[1], "prec5": m[2],
                                "msg_bytes": msg_bytes, "dense_bytes": tree_nbytes(grads)}

    def apply_step(state: TrainState, carry: OverlapCarry, stats_x):
        opt_state = state.opt_state
        if carry.valid:
            mean = consume_carry(state, carry)
            with torch.no_grad():
                for s, v in zip(stats, stats_x):
                    s.copy_(v)
            opt_state, _, _ = update_and_stats(state, mean, None)
        return (dataclasses.replace(state, step=state.step + 1, opt_state=opt_state),
                skip_metrics(not carry.valid))

    return {"produce": produce_step, "apply": apply_step}


def make_delayed_oracle_steps(model: nn.Module, optimizer: Optimizer, codec, **kwargs) -> dict:
    """The two-call oracle of ``overlap='delayed'``
    (``make_delayed_oracle_steps``, ``:2571``): ``produce(state, key,
    images, labels, draws=None, dropout_masks=None) -> (carry, stats_x,
    metrics)`` runs forward, backward and encode on the current parameters
    and returns this rank's payload as a valid :class:`OverlapCarry`, the
    BatchNorm statistics of its forward (the model's own come back to
    their values before it) and the loss metrics; ``apply(state, carry,
    stats_x) -> (state, metrics)`` exchanges and decodes a carry produced
    EARLIER, applies the update and the dp mean of ``stats_x`` when the
    carry is valid, and holds everything otherwise. Driving ``apply`` on
    step t - 1's carry after ``produce`` of step t is the delayed schedule
    with each half its own call; start from :func:`init_delayed_state`'s
    carry. ``kwargs`` are :func:`make_distributed_train_step`'s."""
    return make_distributed_train_step(model, optimizer, codec, overlap="delayed",
                                       _oracle_parts=True, **kwargs)


def _phase_programs(codec, model, begin, forward_backward, update_and_stats, stats, world: int,
                    layouts, split_keys) -> dict:
    """The four phases of the gather step as plain calls (see
    :func:`make_phase_train_steps`), built from the step's own closures."""

    def comp(state: TrainState, key: int, images, labels):
        k_aug, k_drop, _ = split_keys(key, state.step)
        images = begin(images, k_aug)
        grads, loss, prec1, prec5 = forward_backward(images, labels, k_drop, None, None)
        with torch.no_grad():  # the dp means the fused step takes after its update
            if stats:
                flat = _all_reduce_mean(_flat(stats), world)
                for s, v in zip(stats, _views_like(flat, stats)):
                    s.copy_(v)
            m = _all_reduce_mean(_flat([loss, prec1, prec5]), world)
        return grads, {"loss": m[0], "prec1": m[1], "prec5": m[2],
                       "dense_bytes": tree_nbytes(grads)}

    def encode(state: TrainState, key: int, grads):
        _, _, k_codec = split_keys(key, state.step)
        with record_function("step.encode"):
            payloads, cstats = encode_tree(codec, k_codec, grads, None, layouts)
        return payloads, cstats.payload_bytes

    def comm(wire):
        with record_function("step.exchange"):
            if codec is None:  # the dense gradient's all-reduce mean
                return _views_like(_all_reduce_mean(_flat(wire), world), wire)
            return gather_payloads(wire, world)

    def update(state: TrainState, wire, grads) -> TrainState:
        mean = wire
        if codec is not None:
            gathered, spec = wire
            with record_function("step.decode_mean"):
                mean = decode_mean_tree(codec, unpack_tree_buckets(gathered, spec), grads, world,
                                        layouts)
        opt_state, _, _ = update_and_stats(state, mean, None, with_stats=False)
        return TrainState(step=state.step + 1, model=model, opt_state=opt_state)

    fns = {"comp": comp, "comm": comm, "update": update}
    if codec is not None:
        fns["encode"] = encode
    return fns


def make_phase_train_steps(model: nn.Module, optimizer: Optimizer, codec=None, *,
                           augment: bool = False, compute_dtype=None) -> dict:
    """The gather step split into four calls so that the host can time each
    phase (``make_phase_train_steps``, ``atomo_tpu/parallel/replicated.py:
    2620-2700``): the reference log line's worker Comp/Encode/Comm and master
    Gather/Decode (``src/distributed_worker.py:228-247``,
    ``src/sync_replicas_master_nn.py:197-221``), which the fused step cannot
    show.

    * ``comp(state, key, images, labels) -> (grads, metrics)``: forward and
      backward on this rank's shard, then the dp means of the BatchNorm
      statistics and of loss and prec@1/5;
    * ``encode(state, key, grads) -> (payloads, msg_bytes)`` (with a codec);
    * ``comm(payloads) -> (gathered, spec)``: the payloads'
      ``all_gather_into_tensor``; without a codec ``comm(grads)`` is the
      dense all-reduce mean;
    * ``update(state, wire, grads) -> state``: ``decode_mean_tree`` over the
      gathered rows (with a codec), then the optimizer's update.

    Each runs the fused step's own operations (the same closures), so the
    phases run in order give the fused gather step's parameters bit for
    bit; only the host fences between them differ."""
    return make_distributed_train_step(model, optimizer, codec, aggregate="gather",
                                       augment=augment, compute_dtype=compute_dtype,
                                       _phase_parts=True)


def _fence(t: torch.Tensor) -> None:
    """A host read of one element of ``t``: the call waits for the work
    that made it (one copy of four bytes, no kernel)."""
    t.reshape(-1)[-1:].cpu()


def make_phased_step(model: nn.Module, optimizer: Optimizer, codec=None, *,
                     augment: bool = False, compute_dtype=None):
    """``(state, key, images, labels) -> (state, metrics, phase_seconds)``:
    :func:`make_phase_train_steps`'s calls in order, each fenced by a host
    read and timed on the host (``_make_phased_step_fn``,
    ``atomo_tpu/parallel/replicated.py:4062-4110``); ``phase_seconds`` has
    ``comp``, ``encode`` (0 without a codec), ``gather`` and ``decode``
    (the decode-mean and the update)."""
    import time

    fns = make_phase_train_steps(model, optimizer, codec, augment=augment,
                                 compute_dtype=compute_dtype)

    def step_fn(state: TrainState, key: int, images, labels):
        ph = {}
        t0 = time.perf_counter()
        grads, metrics = fns["comp"](state, key, images, labels)
        _fence(metrics["loss"])
        ph["comp"] = time.perf_counter() - t0
        if codec is not None:
            t0 = time.perf_counter()
            wire, msg_bytes = fns["encode"](state, key, grads)
            _fence(_leaf_tensor(wire[-1]))
            ph["encode"] = time.perf_counter() - t0
        else:
            wire, msg_bytes = grads, metrics["dense_bytes"]
            ph["encode"] = 0.0
        t0 = time.perf_counter()
        gathered = fns["comm"](wire)
        _fence(gathered[0] if codec is not None else gathered[-1])
        ph["gather"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = fns["update"](state, gathered, grads)
        _fence(leaf_params(model)[-1])
        ph["decode"] = time.perf_counter() - t0
        return state, {**metrics, "msg_bytes": msg_bytes}, ph

    return step_fn


def _leaf_tensor(payload) -> torch.Tensor:
    """One tensor of a leaf's payload (a tuple of fields), to fence on."""
    for v in payload:
        if torch.is_tensor(v):
            return v
    raise TypeError(f"payload {type(payload).__name__} holds no tensor")


def make_distributed_eval_step(model: nn.Module):
    """``(images, labels) -> {loss, prec1, prec5}`` on this rank's shard,
    each the mean over ranks (0-d tensors)."""
    _, world = _group()

    @torch.no_grad()
    def eval_step(images, labels):
        model.eval()
        logits = model(images)
        prec1, prec5 = accuracy(logits, labels)
        m = _all_reduce_mean(torch.stack([F.cross_entropy(logits, labels), prec1, prec5]),
                             world)
        return {"loss": m[0], "prec1": m[1], "prec5": m[2]}

    return eval_step
