"""Compressed data-parallel training over ``torch.distributed``.

Counterpart of the flat, blocking core of ``atomo_tpu/parallel/replicated.py:847
make_distributed_train_step``, with ``shard_batch`` (:4629),
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

* ``num_aggregate`` k (``:1205``): the mean over the rotating subset
  ``(step + arange(k)) % N`` (gather and ring only, as the reference);
* momentum SGD on the mean, then the dp mean of the BatchNorm statistics
  (``:1879``) and of loss and prec@1/5 (``:1881-1883``), one
  ``all_reduce`` over a packed buffer each.

Phases are ``record_function`` ranges named as the reference's
``named_phase`` scopes: ``step.forward_backward``, ``step.encode``,
``step.exchange``, ``step.decode_mean`` (psum: ``step.decode``), the ring's
``step.ring_exchange_decode``, ``step.update``. No collective needs a host
sync: every size is static.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from atomo_tpu_torch.codecs import decode_mean_tree, decode_tree, encode_tree, tree_nbytes
from atomo_tpu_torch.convert import jax_layouts, jax_leaf_order
from atomo_tpu_torch.data.pipeline import augment_batch
from atomo_tpu_torch.models.dropout import dropout_stream
from atomo_tpu_torch.ops.qsgd_kernels import replica_mean, to_port_layout
from atomo_tpu_torch.parallel.common import (
    hop_pieces,
    pack_tree_buckets,
    ring_perm,
    unpack_tree_buckets,
)
from atomo_tpu_torch.training.optim import Optimizer
from atomo_tpu_torch.training.trainer import TrainState, forward, leaf_params
from atomo_tpu_torch.utils.metrics import accuracy
from atomo_tpu_torch.utils.rng import fold_in, generator, split3

AGGREGATES = ("gather", "ring", "psum")


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
                     layouts: Optional[Sequence[bool]] = None, group=None) -> list[torch.Tensor]:
    """The ring's decode-mean (``_ring_stream_mean``): rotate the packed
    payloads N - 1 hops to ``rank - 1``, decode each arrival into this
    rank's segment of the flat JAX-layout gradient at its source's
    canonical row, sum the rows (the ``n_contrib`` selected from
    ``sel_start`` on, or all) in order, divide, and republish the segments
    with one ``all_gather_into_tensor``. Returns the mean, port layout
    (``layouts`` as for :func:`~atomo_tpu_torch.codecs.encode_tree`).
    ``rank`` and ``world`` are this rank's place in ``group`` (the default
    group when None); a world of one makes no collective call."""
    numels = [g.numel() for g in grads]
    d_flat = sum(numels)
    chunk = -(-d_flat // world)
    lo = rank * chunk
    hi = min(lo + chunk, d_flat)
    buf, spec = pack_tree_buckets(payloads)
    nxt = torch.empty_like(buf)
    stage = torch.zeros((world, chunk), dtype=torch.float32, device=buf.device)
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
            reqs = dist.batch_isend_irecv(ops)
        src = (rank + t) % world
        decoded = decode_tree(codec, unpack_tree_buckets(buf, spec), grads, flat_layouts)
        if hi > lo:
            stage[src, : hi - lo] = torch.cat([v.reshape(-1) for v in decoded])[lo:hi]
        for r in reqs:
            r.wait()
        buf, nxt = nxt, buf
    rows = stage if sel_start is None else _rotating_rows(stage, sel_start, n_contrib)
    seg = replica_mean(rows)
    if world == 1:  # this rank's segment is the whole mean
        full = seg.reshape(-1)
    else:
        full = torch.empty((world * chunk,), dtype=torch.float32, device=seg.device)
        dist.all_gather_into_tensor(full, seg.contiguous(), group=group)
    layouts = [True] * len(grads) if layouts is None else layouts
    return [to_port_layout(v, g.shape, tr) for v, g, tr in
            zip(full[:d_flat].split(numels), grads, layouts)]


def _check_aggregate(codec, aggregate: str, num_aggregate: int, world: int):
    """(aggregate in effect, k of num_aggregate or 0), as the reference
    resolves them (``:1205-1212``)."""
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
    ``ValueError`` when K does not divide the batch)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    rank, world = _group()
    aggregate, k_agg = _check_aggregate(codec, aggregate, num_aggregate, world)
    n_contrib = k_agg or world
    params = leaf_params(model)
    names = jax_leaf_order(model)
    layouts = jax_layouts(model)
    stats = list(model.buffers())  # the BatchNorm statistics, Flax's batch_stats

    def exchange(state: TrainState, k_codec: int, grads, draws, dense_bytes: int):
        """(mean gradient in the port layout, message bytes)."""
        if codec is None:
            with record_function("step.exchange"):
                return _views_like(_all_reduce_mean(_flat(grads), world), grads), dense_bytes
        with record_function("step.encode"):
            payloads, cstats = encode_tree(codec, k_codec, grads, draws, layouts)
        sel_start = state.step % world if k_agg else None
        if aggregate == "gather":
            with record_function("step.exchange"):
                gathered, spec = gather_payloads(payloads, world)
            with record_function("step.decode_mean"):
                if k_agg:
                    gathered = _rotating_rows(gathered, sel_start, k_agg)
                mean = decode_mean_tree(codec, unpack_tree_buckets(gathered, spec), grads,
                                        n_contrib, layouts)
            return mean, cstats.payload_bytes
        if aggregate == "ring":
            with record_function("step.ring_exchange_decode"):
                mean = ring_stream_mean(codec, payloads, grads, rank=rank, world=world,
                                        sel_start=sel_start, n_contrib=n_contrib,
                                        ring_bucket_size=ring_bucket_size, layouts=layouts)
            return mean, cstats.payload_bytes
        with record_function("step.decode"):
            decoded = decode_tree(codec, payloads, grads, layouts)
        with record_function("step.exchange"):
            mean = _views_like(_all_reduce_mean(_flat(decoded), world), grads)
        return mean, dense_bytes  # the all-reduce moves dense gradients

    def accumulate(images, labels, k_drop: int, dropout_masks):
        """(mean gradient over the microbatches, mean loss, prec@1, prec@5)."""
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
        sums = torch.zeros(3, dtype=torch.float32, device=images.device)
        # given masks run through the microbatches in call order; else
        # microbatch i draws under fold_in(k_drop, i)
        given = dropout_masks is not None
        with dropout_stream(masks=dropout_masks) if given else contextlib.nullcontext():
            for i in range(grad_accum):
                x, y = images[i * mb:(i + 1) * mb], labels[i * mb:(i + 1) * mb]
                with contextlib.nullcontext() if given else dropout_stream(fold_in(k_drop, i)):
                    logits = run(x)
                    loss = F.cross_entropy(logits, y)
                    grads = torch.autograd.grad(loss, targets)
                for a, g in zip(g_sum, grads):
                    a.add_(g.float())
                prec1, prec5 = accuracy(logits.detach(), y)
                sums += torch.stack([loss.detach(), prec1, prec5])
        m = _mean(sums, grad_accum)
        return [_mean(g, grad_accum) for g in g_sum], m[0], m[1], m[2]

    def step(state: TrainState, key: int, images, labels, draws: Optional[Sequence[Any]] = None,
             dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        step_key = fold_in(key, state.step)
        k_aug, k_drop, k_codec = split3(fold_in(step_key, rank))
        if augment:
            images = augment_batch(images, generator(k_aug, images.device))
        model.train()
        for p in params:
            p.grad = None
        with record_function("step.forward_backward"):
            if grad_accum > 1:
                grads, loss, prec1, prec5 = accumulate(images, labels, k_drop, dropout_masks)
            else:
                with dropout_stream(k_drop, dropout_masks):
                    logits = forward(model, images, compute_dtype)
                    loss = F.cross_entropy(logits, labels)
                    loss.backward()
                grads = [p.grad for p in params]
                loss = loss.detach()
                prec1, prec5 = accuracy(logits.detach(), labels)
        dense_bytes = tree_nbytes(grads)
        mean, msg_bytes = exchange(state, k_codec, grads, draws, dense_bytes)
        with record_function("step.update"):
            opt_state = optimizer.update(mean, state.opt_state, params)
        with torch.no_grad():
            if stats:
                flat = _all_reduce_mean(_flat(stats), world)
                for s, v in zip(stats, _views_like(flat, stats)):
                    s.copy_(v)
            m = _all_reduce_mean(torch.stack([loss, prec1, prec5]), world)
        metrics = {"loss": m[0], "prec1": m[1], "prec5": m[2], "msg_bytes": msg_bytes,
                   "dense_bytes": dense_bytes}
        return TrainState(step=state.step + 1, model=model, opt_state=opt_state), metrics

    return step


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
