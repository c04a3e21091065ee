"""LM training on a dp x sp mesh of processes with the compressed dp exchange.

Counterpart of ``atomo_tpu/parallel/lm.py`` (``make_lm_train_step`` and its
blocking dp tails). The JAX package runs one SPMD program over a (dp, sp)
mesh; the port runs one process per device, placed on the mesh by
:func:`~atomo_tpu_torch.parallel.launch.dp_sp_mesh`, and each collective of
the program becomes a call over the process's sp or dp group. Each step:

* this rank's (B/dp, S/sp) block of the global batch (:func:`shard_tokens`)
  through :class:`~atomo_tpu_torch.models.transformer.TransformerLM` with
  the chosen sequence-parallel attention (``ATTENTION_IMPLS``) over the sp
  group, its positions from ``pos_offset = rank_sp * S/sp`` (``:626``);
  with ``compute_dtype`` on parameters cast to it and float32 logits
  (``:619-623``);
* the exact global loss (``:628-634``): each shard's last target is the
  next shard's first token (:func:`sp_boundary_targets_and_mask`), the
  global final column masked; the loss is the sp sum of ``sum(ce * valid)``
  over the sp sum of ``sum(valid)``;
* the gradient of one replica (``:636-642``). The JAX package seeds every
  shard's backward with the replicated loss, so under ``shard_map`` each
  shard's gradient carries a factor n_sp, and it takes the sp mean. The
  port's backward on each rank starts from its own term of the loss, and
  the cotangents that the collectives carry back (the ring's hops, the
  all-to-alls) give each rank its parameters' share of the whole gradient:
  the sp sum is the gradient, with no factor to take out;
* the dp tail (:func:`dp_exchange_tail`): the codec key
  ``fold_in(fold_in(key, step), rank_dp)`` (``:612-614``), the same on every
  sp rank of a replica, so that they encode, exchange and update alike; the
  exchange over the dp group, by ``gather`` (the payload all_gather and
  ``decode_mean_tree``), ``psum`` (the dense mean of the decode) or, through
  :class:`DpExchange`, ``ring`` (the streamed ring of
  ``parallel.replicated.ring_stream_mean``); then the optimizer;
* :class:`DpExchange`'s ``stream_encode`` (``:174-290``): the layer-bucket
  encode. At sp 1 each bucket is issued from a backward hook on the
  transformer's parameters (:class:`~atomo_tpu_torch.parallel.overlap.
  BucketStream`) and goes on the gather's or the ring's wire at once; at
  sp > 1 a gradient is complete only after the sp reduce, so the buckets
  are encoded there, one after another (``encode_tree_streamed``). The
  payloads are the monolithic encode's bit for bit;
* its ``overlap="delayed"`` (``:317-570``, the JAX package's
  ``delayed_dp_exchange``): the stale-by-one dp exchange. The step's state carries its replica's
  previous payload (:func:`init_model_axis_delayed_state`); the exchange
  and decode of the carried payloads over the dp group run on a side
  stream from the step's start, under forward and backward (the flash
  kernel's forward included), and the update waits for backward. Step 0
  applies nothing and ``metrics["skipped"]`` is 1.

The dp tail is :func:`make_model_axis_step`, which every layout's family
(``tp``, ``moe``, ``pp``) builds on with its own gradient function.

Phases are ``record_function`` ranges: ``step.forward_backward``,
``step.sp_reduce``, ``step.encode``, ``step.exchange``,
``step.decode_mean``, ``step.ring_exchange_decode``, ``step.update``, and
under delayed ``step.delayed_exchange``, ``step.delayed_decode_mean``,
``step.delayed_ring_exchange_decode``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from atomo_tpu_torch.codecs import (
    codec_subset,
    decode_mean_tree,
    decode_tree,
    encode_tree,
    encode_tree_streamed,
    payload_nbytes,
    tree_nbytes,
)
from atomo_tpu_torch.convert import jax_layouts
from atomo_tpu_torch.models.transformer import TransformerLM
from atomo_tpu_torch.parallel.common import plan_layer_buckets, ring_hop, unpack_tree_buckets
from atomo_tpu_torch.parallel.launch import DpSpMesh
from atomo_tpu_torch.parallel.overlap import (
    BucketStream,
    BucketWire,
    OverlapCarry,
    consume,
    encode_syncs,
    init_carry,
    issue_consume,
    join,
    pack_payloads,
    side_stream,
)
from atomo_tpu_torch.parallel.replicated import (
    _all_reduce_mean,
    _flat,
    _views_like,
    gather_payloads,
    ring_stream_mean,
)
from atomo_tpu_torch.parallel.ring import ATTENTION_IMPLS
from atomo_tpu_torch.training.optim import Optimizer
from atomo_tpu_torch.training.trainer import TrainState, create_state, forward, leaf_params
from atomo_tpu_torch.utils.rng import fold_in

AGGREGATES = ("gather", "psum", "ring")


@dataclasses.dataclass(frozen=True)
class DpExchange:
    """The dp exchange of a model-axis step as one value (``lm.py:127``):
    ``aggregate`` gather | psum | ring, ``ring_bucket_size`` the ring's
    4-byte elements per message (<= 0: one message a hop),
    ``stream_encode`` the layer-bucket encode over buckets of
    ``stream_bucket_bytes`` dense bytes, ``overlap`` off | delayed (the
    stale-by-one exchange, gather or ring)."""

    aggregate: str = "gather"
    ring_bucket_size: int = 0
    stream_encode: bool = False
    stream_bucket_bytes: int = 4 << 20
    overlap: str = "off"

    def __post_init__(self):
        if self.aggregate not in AGGREGATES:
            raise ValueError(f"unknown aggregate mode {self.aggregate!r}; the model-axis "
                             "dp exchange ships gather | psum | ring")
        if self.overlap not in ("off", "delayed"):
            raise ValueError(f"unknown overlap mode {self.overlap!r}; the model-axis dp "
                             "exchange ships off | delayed")
        if self.overlap == "delayed" and self.aggregate == "psum":
            raise ValueError(
                "overlap='delayed' carries an ENCODED payload between "
                "steps; the dense psum exchange has no payload to carry — "
                "use aggregate='gather' or 'ring'")


def create_lm_state(lm_config: dict, optimizer: Optimizer, seed: int, device) -> TrainState:
    """A fresh :class:`TransformerLM` (``lm_config`` are its kwargs) with
    Flax's initialisers drawn from ``seed``, on ``device``."""
    return create_state(TransformerLM(**lm_config), optimizer, seed, device)


def shard_tokens(tokens, mesh: DpSpMesh) -> Any:
    """This rank's (B/dp, S/sp) block of a global (B, S) batch that every
    rank drew alike: what ``shard_tokens`` (``lm.py:673``) places on mesh
    position (rank_dp, rank_sp)."""
    b, s = tokens.shape
    if b % mesh.n_dp or s % mesh.n_sp:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split over the "
                         f"{mesh.describe()} mesh")
    pb, ps = b // mesh.n_dp, s // mesh.n_sp
    return tokens[mesh.rank_dp * pb:(mesh.rank_dp + 1) * pb,
                  mesh.rank_sp * ps:(mesh.rank_sp + 1) * ps]


def sp_boundary_targets_and_mask(tokens: torch.Tensor, n_sp: int = 1, group=None):
    """Next-token targets and the valid mask of a sequence shard: the
    shard's last target is the first token of the next shard (one ring hop
    over the sp group; on one shard, its own first token), and the global
    final position, the last shard's last column, is masked out. Returns
    (targets, valid), both (B, S/sp)."""
    nxt = ring_hop(tokens[:, :1].contiguous(), group, n_sp)
    targets = torch.cat([tokens[:, 1:], nxt], dim=1)
    valid = torch.ones(targets.shape, device=tokens.device)
    if n_sp == 1 or dist.get_rank(group) == n_sp - 1:
        valid[:, -1] = 0.0
    return targets, valid


def _dp_gather(payloads, mesh: DpSpMesh):
    """Every replica's payloads, each field with a leading replica axis: the
    views of one all_gather over the dp group, or, where no process group
    is up (one replica), this replica's own fields under an axis of one."""
    if mesh.dp_group is None:
        return [type(p)(*(a[None] for a in p)) for p in payloads]
    return unpack_tree_buckets(*gather_payloads(payloads, mesh.n_dp, group=mesh.dp_group))


def _dp_mean(flat: torch.Tensor, mesh: DpSpMesh) -> torch.Tensor:
    """The dp mean of ``flat`` (itself on one replica)."""
    if mesh.n_dp == 1:
        return flat
    return _all_reduce_mean(flat, mesh.n_dp, mesh.dp_group)


def _exchange(codec, k_codec: int, grads, draws, layouts, mesh: DpSpMesh,
              exchange: DpExchange):
    """(mean gradient in the port layout, message bytes) of one dp
    exchange; ``codec=None`` is the dense mean."""
    dense_bytes = tree_nbytes(grads)
    agg = exchange.aggregate
    if codec is None:
        if agg == "ring":
            raise ValueError("aggregate='ring' needs a codec: the ring streams encoded "
                             "payloads; a dense ring would just be a slower pmean")
        with record_function("step.exchange"):
            return _views_like(_dp_mean(_flat(grads), mesh), grads), dense_bytes
    if agg == "psum":
        with record_function("step.encode"):
            payloads, _ = encode_tree(codec, k_codec, grads, draws, layouts)
            decoded = decode_tree(codec, payloads, grads, layouts)
        with record_function("step.exchange"):
            mean = _views_like(_dp_mean(_flat(decoded), mesh), grads)
        return mean, dense_bytes  # the wire truly carries dense bytes here
    with record_function("step.encode"):
        payloads, stats = encode_tree(codec, k_codec, grads, draws, layouts)
    if agg == "gather":
        with record_function("step.exchange"):
            gathered = _dp_gather(payloads, mesh)
        with record_function("step.decode_mean"):
            mean = decode_mean_tree(codec, gathered, grads, mesh.n_dp, layouts)
        return mean, stats.payload_bytes
    with record_function("step.ring_exchange_decode"):
        mean = ring_stream_mean(codec, payloads, grads, rank=mesh.rank_dp, world=mesh.n_dp,
                                n_contrib=mesh.n_dp, ring_bucket_size=exchange.ring_bucket_size,
                                layouts=layouts, group=mesh.dp_group)
    return mean, stats.payload_bytes


def _update(optimizer: Optimizer, state: TrainState, mean, loss, params, mesh: DpSpMesh,
            msg_bytes: int, dense_bytes: int):
    with record_function("step.update"):
        opt_state = optimizer.update(mean, state.opt_state, params)
    metrics = {"loss": _dp_mean(loss.detach().reshape(1), mesh)[0], "msg_bytes": msg_bytes,
               "dense_bytes": dense_bytes}
    return TrainState(step=state.step + 1, model=state.model, opt_state=opt_state), metrics


def compressed_dp_update(
    optimizer: Optimizer,
    codec,
    state: TrainState,
    k_codec: int,
    grads: Sequence[torch.Tensor],
    loss: torch.Tensor,
    *,
    params: Sequence[torch.Tensor],
    layouts: Optional[Sequence[bool]] = None,
    mesh: Optional[DpSpMesh] = None,
    aggregate: str = "gather",
    draws: Optional[Sequence[Any]] = None,
):
    """The legacy dp tail (``lm.py:63``): encode this replica's completed
    gradient, all_gather the payloads over dp and take their mean decode
    (``gather``), or decode and take the dense mean (``psum``); ``codec=None``
    is the dense mean. Updates ``params`` in place; returns (new state,
    metrics) with the dp mean of the loss and ``msg_bytes`` as the wire
    carries them (dense bytes for ``psum``)."""
    if aggregate not in ("gather", "psum"):
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    return compressed_dp_exchange(optimizer, codec, state, k_codec, grads, loss, params=params,
                                  layouts=layouts, mesh=mesh, exchange=DpExchange(aggregate),
                                  draws=draws)


def compressed_dp_exchange(
    optimizer: Optimizer,
    codec,
    state: TrainState,
    k_codec: int,
    grads: Sequence[torch.Tensor],
    loss: torch.Tensor,
    *,
    params: Sequence[torch.Tensor],
    layouts: Optional[Sequence[bool]] = None,
    mesh: Optional[DpSpMesh] = None,
    exchange: DpExchange = DpExchange(),
    draws: Optional[Sequence[Any]] = None,
):
    """The dp tail of :class:`DpExchange` (``lm.py:174``): as
    :func:`compressed_dp_update`, with ``ring`` besides (the payloads
    rotate over the dp group, each arrival decoded into this replica's
    segment of the mean, which one all_gather republishes)."""
    mesh = mesh or DpSpMesh()
    dense_bytes = tree_nbytes(grads)
    mean, msg_bytes = _exchange(codec, k_codec, grads, draws, layouts, mesh, exchange)
    return _update(optimizer, state, mean, loss, params, mesh, msg_bytes, dense_bytes)


def dp_exchange_tail(optimizer, codec, state, k_codec, grads, loss, *, params, layouts=None,
                     mesh=None, aggregate: str = "gather",
                     exchange: Optional[DpExchange] = None, draws=None):
    """:func:`compressed_dp_update` when ``exchange`` is None,
    :func:`compressed_dp_exchange` otherwise (``lm.py:290``)."""
    kw = dict(params=params, layouts=layouts, mesh=mesh, draws=draws)
    if exchange is None:
        return compressed_dp_update(optimizer, codec, state, k_codec, grads, loss,
                                    aggregate=aggregate, **kw)
    return compressed_dp_exchange(optimizer, codec, state, k_codec, grads, loss,
                                  exchange=exchange, **kw)


def _sp_sum(t: torch.Tensor, mesh: DpSpMesh) -> torch.Tensor:
    if mesh.n_sp > 1:
        dist.all_reduce(t, group=mesh.sp_group)
    return t


def init_model_axis_delayed_state(state: TrainState, codec) -> TrainState:
    """``state`` with a fresh carry for the delayed model-axis step
    (``init_model_axis_delayed_state``, ``lm.py:453``): the zero payload
    this codec gives the LM's leaves, all-ones flags over the process
    group's ranks (one row each, as the JAX carry has one per device),
    ``valid`` False."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return dataclasses.replace(state, carry=init_carry(
        codec, leaf_params(state.model), world, jax_layouts(state.model)))


def make_lm_train_step(
    model: TransformerLM,
    optimizer: Optimizer,
    codec=None,
    *,
    attn_impl: str = "ring",
    aggregate: str = "gather",
    exchange: Optional[DpExchange] = None,
    mesh: Optional[DpSpMesh] = None,
    compute_dtype=None,
):
    """Build ``step(state, key, tokens, draws=None) -> (state, metrics)``
    of this rank over ``model`` (which ``state.model`` must be), on
    ``mesh`` (one device when None). ``tokens`` is this rank's int64
    (B/dp, S/sp) block (:func:`shard_tokens`) on the model's device;
    ``draws`` (one entry per leaf, canonical order) is the codec's parity
    hook. ``metrics`` holds the loss as a 0-d tensor (no host sync) and
    ``msg_bytes``/``dense_bytes`` as ints. ``exchange`` with
    ``stream_encode`` encodes per layer bucket; with ``overlap="delayed"``
    the step takes and returns a state with its carry
    (:func:`init_model_axis_delayed_state`) and adds ``skipped`` to the
    metrics."""
    if attn_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attn_impl {attn_impl!r}; expected one of {sorted(ATTENTION_IMPLS)}"
        )
    mesh = mesh or DpSpMesh()
    attention = partial(ATTENTION_IMPLS[attn_impl], axis_name="sp", axis_size=mesh.n_sp,
                        causal=True, group=mesh.sp_group)
    params = leaf_params(model)

    def grads_fn(state: TrainState, tokens: torch.Tensor, bs):
        """(this replica's completed gradient, loss)."""
        model.train()
        for p in params:
            p.grad = None
        with record_function("step.forward_backward"):
            if bs is not None:
                bs.arm(params)
            logits = forward(model, tokens, compute_dtype,
                             pos_offset=mesh.rank_sp * tokens.shape[1], attention_fn=attention)
            targets, valid = sp_boundary_targets_and_mask(tokens, mesh.n_sp, mesh.sp_group)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                                 reduction="none").view(valid.shape)
            total = _sp_sum(valid.sum(), mesh)
            num = (ce * valid).sum()
            (num / total).backward()
        grads = [p.grad for p in params]
        if mesh.n_sp > 1:
            # the sp sum completes this replica's gradient; the loss's
            # numerator rides in the same all_reduce
            with record_function("step.sp_reduce"):
                flat = _sp_sum(torch.cat([_flat(grads), num.detach().reshape(1)]), mesh)
                grads = _views_like(flat[:-1], grads)
                num = flat[-1]
        return grads, num / total

    return make_model_axis_step(params, optimizer, codec, grads_fn, mesh=mesh,
                                layouts=jax_layouts(model), aggregate=aggregate,
                                exchange=exchange, hookable=mesh.n_sp == 1)


def make_model_axis_step(
    params: Sequence[torch.Tensor],
    optimizer: Optimizer,
    codec,
    grads_fn,
    *,
    mesh,
    layouts: Sequence[bool],
    aggregate: str = "gather",
    exchange: Optional[DpExchange] = None,
    hookable: bool = True,
):
    """The dp tail of every LM layout around a family's ``grads_fn(state,
    tokens, bs) -> (completed gradient, replica loss)`` (``lm.py:290``
    ``dp_exchange_tail`` and ``make_delayed_model_axis_step``): ``params``
    are this rank's leaves in the family tree's canonical order, ``mesh``
    gives ``n_dp``, ``rank_dp`` and ``dp_group``. The codec key is
    ``fold_in(fold_in(key, step), rank_dp)``, so every model-axis rank of a
    replica encodes its own slice under its replica's key. ``hookable``
    says whether a leaf's gradient is whole when backward leaves it (no
    model-axis reduce after backward, one backward a step): only then may
    ``--stream-encode`` issue its buckets from backward hooks (``grads_fn``
    arms ``bs`` on ``params`` before its backward); otherwise the buckets
    are encoded one after another after the completion. Returns
    ``step(state, key, tokens, draws=None) -> (state, metrics)``."""
    device = params[0].device
    delayed = exchange is not None and exchange.overlap == "delayed"
    if delayed and codec is None:
        raise ValueError(
            "overlap='delayed' needs a codec: the carry holds encoded "
            "payloads (a dense delayed exchange has nothing to carry)")
    streamed = (exchange is not None and exchange.stream_encode and codec is not None
                and exchange.aggregate != "psum")
    plan = plan_layer_buckets(params, exchange.stream_bucket_bytes) if streamed else None
    hooked = streamed and hookable and encode_syncs(codec) is None
    enc_stream = side_stream(device) if hooked else None
    cons_stream = side_stream(device) if delayed else None

    def codec_key(key: int, state: TrainState) -> int:
        # the same on every model-axis rank of a replica (lm.py:612-614)
        return fold_in(fold_in(key, state.step), mesh.rank_dp)

    def bucket_stream(k_codec, draws, wire: bool) -> Optional[BucketStream]:
        """The step's hook-driven bucket encodes, or None."""
        if not streamed or not hookable:
            return None
        bw = BucketWire(codec, plan, layouts, aggregate=exchange.aggregate, rank=mesh.rank_dp,
                        world=mesh.n_dp, n_contrib=mesh.n_dp,
                        ring_bucket_size=exchange.ring_bucket_size, group=mesh.dp_group,
                        stream=enc_stream) if wire else None
        return BucketStream(plan, codec, k_codec, layouts=layouts, draws=draws,
                            feed=lambda i, g: g, on_encoded=bw, hooked=hooked,
                            stream=enc_stream)

    def encode(bs, k_codec, grads, draws) -> list:
        """This replica's payloads: the bucket stream's, the buckets one
        after another, or the monolithic encode."""
        with record_function("step.encode"):
            if bs is not None:
                return bs.finish()
            if streamed:
                return encode_tree_streamed(codec, k_codec, grads, plan, draws, layouts)[0]
            return encode_tree(codec, k_codec, grads, draws, layouts)[0]

    def streamed_tail(state, bs, k_codec, grads, loss, draws):
        """The blocking dp tail of a streamed step (``compressed_dp_exchange``
        with ``stream_encode``)."""
        payloads = encode(bs, k_codec, grads, draws)
        msg_bytes = sum(payload_nbytes(p) for p in payloads)
        if bs is not None:
            mean = bs.on_encoded.mean(grads)
        elif exchange.aggregate == "gather":
            with record_function("step.exchange"):
                gathered = _dp_gather(payloads, mesh)
            with record_function("step.decode_mean"):
                mean = decode_mean_tree(codec, gathered, grads, mesh.n_dp, layouts)
        else:  # one mini-ring a bucket (_ring_stream_mean_layered)
            mean = [None] * len(grads)
            with record_function("step.ring_exchange_decode"):
                for idxs in plan.buckets:
                    for i, m in zip(idxs, ring_stream_mean(
                            codec_subset(codec, idxs), [payloads[i] for i in idxs],
                            [grads[i] for i in idxs], rank=mesh.rank_dp, world=mesh.n_dp,
                            n_contrib=mesh.n_dp, ring_bucket_size=exchange.ring_bucket_size,
                            layouts=[layouts[i] for i in idxs], group=mesh.dp_group)):
                        mean[i] = m
        return _update(optimizer, state, mean, loss, params, mesh, msg_bytes,
                       tree_nbytes(grads))

    def delayed_step(state: TrainState, key: int, tokens: torch.Tensor, draws=None):
        """:func:`delayed_dp_exchange` around this step's forward and
        backward."""
        carry = state.carry
        if not isinstance(carry, OverlapCarry):
            raise ValueError("overlap='delayed' steps a state that carries its in-flight "
                             "payload: build it with init_model_axis_delayed_state")
        mean = None
        if carry.valid:  # the carried exchange and decode run under forward and backward
            mean = issue_consume(cons_stream, lambda: consume(
                codec, carry, [p.detach() for p in params], aggregate=exchange.aggregate,
                rank=mesh.rank_dp, world=mesh.n_dp, sel_start=None, n_contrib=mesh.n_dp,
                ring_bucket_size=exchange.ring_bucket_size, layouts=layouts,
                group=mesh.dp_group))
        k_codec = codec_key(key, state)
        bs = bucket_stream(k_codec, draws, wire=False)
        grads, loss = grads_fn(state, tokens, bs)
        buf, _, msg_bytes = pack_payloads(encode(bs, k_codec, grads, draws))
        opt_state = state.opt_state
        if carry.valid:
            join(cons_stream, mean)
            with record_function("step.update"):
                opt_state = optimizer.update(mean, state.opt_state, params)
        with torch.no_grad():
            carry.payload.copy_(buf)  # after the join: the consume read it
        skipped = torch.zeros((), dtype=torch.float32, device=device)
        metrics = {"loss": _dp_mean(loss.detach().reshape(1), mesh)[0], "msg_bytes": msg_bytes,
                   "dense_bytes": tree_nbytes(grads),
                   "skipped": skipped if carry.valid else skipped + 1}
        return TrainState(step=state.step + 1, model=state.model, opt_state=opt_state,
                          carry=dataclasses.replace(carry, valid=True)), metrics

    def step(state: TrainState, key: int, tokens: torch.Tensor,
             draws: Optional[Sequence[Any]] = None):
        if delayed:
            return delayed_step(state, key, tokens, draws)
        k_codec = codec_key(key, state)
        bs = bucket_stream(k_codec, draws, wire=True)
        grads, loss = grads_fn(state, tokens, bs)
        if streamed:
            return streamed_tail(state, bs, k_codec, grads, loss, draws)
        return dp_exchange_tail(optimizer, codec, state, k_codec, grads, loss,
                                params=params, layouts=layouts, mesh=mesh,
                                aggregate=aggregate, exchange=exchange, draws=draws)

    return step
