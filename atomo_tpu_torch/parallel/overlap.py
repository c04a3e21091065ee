"""Layer buckets encoded under backward, and the stale-by-one carry.

The two schedules the JAX package leaves to XLA's scheduler
(``atomo_tpu/parallel/replicated.py:1700-1720, 2006-2330``,
``atomo_tpu/parallel/lm.py:174-570``), written out for eager PyTorch:

* **stream-encode** (:class:`BucketStream`). The gradient list is cut into
  the JAX package's layer buckets
  (:func:`~atomo_tpu_torch.parallel.common.plan_layer_buckets`). One
  ``torch.autograd.graph.register_multi_grad_hook(..., mode="all")`` per
  bucket, over the tensors whose gradients the step takes, fires when the
  bucket's last gradient is ready. The hook records an event on the
  backward stream and issues the bucket's encode (``encode_leaf_subset``:
  one row-1 tree launch per width under QSGD) on a side stream that waits
  on it; the step's own ``on_encoded`` then puts the bucket on the wire
  (gather: its packed payloads in one ``all_gather_into_tensor`` with
  ``async_op=True``; ring: the bucket's own mini-ring). The main stream
  waits on the side stream before the decode. Every leaf is keyed by its
  global index, so the payloads equal the monolithic encode's bit for bit,
  whatever the bucket size and whatever order the buckets are issued in.
  A hook runs on autograd's thread, where a host sync stalls backward: a
  codec whose encode syncs (svd: one ``eigh`` convergence flag per shape
  group) has its hooks record readiness only, and its buckets are encoded
  right after backward in the order they became ready. That is a rule
  fixed before the step runs (:func:`encode_syncs`), and the payloads are
  the same.
* **delayed** (:class:`OverlapCarry`). Step t encodes its gradient and
  keeps the payload, packed as the gather ships it (one (B,) byte
  buffer), in the carry; the exchange and decode of step t - 1's payload
  read only step-start values, so the step issues them on a side stream at
  its start, underneath forward and backward, and the optimizer's in-place
  update waits for both. Step 0 (``valid`` False) applies nothing.

On the CPU there are no streams: the same calls run in program order.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

from atomo_tpu_torch.codecs import (
    DenseCodec,
    QsgdCodec,
    SvdCodec,
    decode_mean_tree,
    encode_leaf_subset,
    encode_tree,
)
from atomo_tpu_torch.parallel.common import PackSpec, pack_tree_buckets, unpack_tree_buckets


def encode_syncs(codec) -> Optional[str]:
    """Why ``codec``'s encode makes a host sync (so a backward hook may not
    run it), or None when it makes none."""
    leaves = getattr(codec, "codecs", None)
    if getattr(codec, "codec_for", None) is not None and leaves is not None:
        for c in dict.fromkeys(leaves):  # the distinct resolved codecs
            why = encode_syncs(c)
            if why is not None:
                return why
        return None
    if isinstance(codec, (QsgdCodec, DenseCodec)):
        return None
    if isinstance(codec, SvdCodec):
        return "svd: eigh reads its convergence flag on the host once per shape group"
    return f"the {getattr(codec, 'name', type(codec).__name__)} codec is not known to be sync-free"


def side_stream(device) -> Optional[torch.cuda.Stream]:
    """A new side stream on ``device``, or None off the card."""
    device = torch.device(device)
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def join(stream, tensors: Sequence[torch.Tensor] = ()) -> None:
    """The current stream waits on ``stream``; ``tensors`` made there are
    marked as used on the current stream (the allocator keeps them until
    its work is done)."""
    if stream is None:
        return
    cur = torch.cuda.current_stream(stream.device)
    cur.wait_stream(stream)
    if torch.cuda.is_current_stream_capturing():
        return  # a graph's tensors live in its private pool, kept across replays
    for t in tensors:
        t.record_stream(cur)


class BucketStream:
    """One step's layer-bucket encodes, issued as the buckets become ready.

    ``plan`` is the step's :class:`~atomo_tpu_torch.parallel.common.
    LayerBucketPlan`, ``feed(i, g)`` turns leaf ``i``'s incoming gradient
    into the encode's input (the microbatch mean, error feedback's g + e),
    ``on_encoded(b, idxs, inputs, payloads)`` is the step's wire for a
    bucket (it runs on the side stream, right after the encode). ``hooked``
    False defers every bucket to :meth:`finish` (a codec whose encode
    syncs). ``log`` records ``("ready", b)`` when bucket b's last gradient
    arrives and ``("issue", b)`` when its encode is issued."""

    def __init__(self, plan, codec, key, *, layouts, draws=None,
                 feed: Callable[[int, torch.Tensor], torch.Tensor],
                 on_encoded: Optional[Callable] = None, hooked: bool = True,
                 stream=None):
        self.plan, self.codec, self.key = plan, codec, key
        self.layouts, self.draws = layouts, draws
        self.feed, self.on_encoded, self.hooked = feed, on_encoded, hooked
        self.stream = stream
        self.inputs: list = [None] * plan.n_leaves
        self.payloads: list = [None] * plan.n_leaves
        self.log: list = []
        self._pending: dict = {}
        self._handles: list = []

    def arm(self, targets: Sequence[torch.Tensor]) -> "BucketStream":
        """One readiness hook per bucket over ``targets`` (one tensor per
        leaf, canonical order: the tensors whose gradients the step takes)."""
        for b, idxs in enumerate(self.plan.buckets):
            self._handles.append(torch.autograd.graph.register_multi_grad_hook(
                [targets[i] for i in idxs], lambda grads, b=b: self._ready(b, grads),
                mode="all"))
        return self

    def _ready(self, b: int, grads) -> None:
        self.log.append(("ready", b))
        if any(g is None for g in grads):
            raise RuntimeError(f"layer bucket {b}: a leaf of {self.plan.buckets[b]} got no "
                               "gradient (stream-encode needs every leaf in the graph)")
        if self.hooked:
            self._issue(b, grads)
        else:
            self._pending[b] = grads

    def _issue(self, b: int, grads) -> None:
        idxs = self.plan.buckets[b]
        self.log.append(("issue", b))
        if self.stream is not None:
            # the encode waits on the backward stream's work up to this hook
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.stream.device))
            self.stream.wait_event(ev)
            for g in grads:
                g.record_stream(self.stream)
        with _on(self.stream), record_function("step.encode_bucket"):
            for i, g in zip(idxs, grads):
                self.inputs[i] = self.feed(i, g)
            payloads = encode_leaf_subset(self.codec, self.key, self.inputs, idxs, self.draws,
                                          self.layouts)
            for i, p in zip(idxs, payloads):
                self.payloads[i] = p
            if self.on_encoded is not None:
                self.on_encoded(b, idxs, [self.inputs[i] for i in idxs], payloads)

    def finish(self) -> list:
        """After backward: the deferred buckets issued in the order they
        became ready, every bucket checked present, the current stream
        joined to the side stream. Returns the payloads (canonical order)."""
        for h in self._handles:
            h.remove()
        self._handles = []
        for b in [b for ev, b in self.log if ev == "ready" and b in self._pending]:
            self._issue(b, self._pending.pop(b))
        missing = [b for b in range(self.plan.n_buckets)
                   if ("issue", b) not in self.log]
        if missing:
            raise RuntimeError(f"layer buckets {missing} never became ready in backward")
        join(self.stream, [t for p in self.payloads for t in p]
             + [t for t in self.inputs])
        return self.payloads


class BucketWire:
    """The wire of a blocking streamed step, fed bucket by bucket (a
    :class:`BucketStream`'s ``on_encoded``): under gather each bucket's
    packed payloads go out in one ``all_gather_into_tensor`` with
    ``async_op=True``; under ring each bucket runs a mini-ring of its own
    (``_ring_stream_mean_layered``: the staged mean is elementwise, so the
    buckets' rings give the whole ring's mean bit for bit). :meth:`mean`,
    after the stream's ``finish``, waits on the gathers and decodes every
    bucket's rows in one tree decode (read in place), or returns the
    mini-rings' means. ``sel_start`` is the ``num_aggregate`` subset's
    first replica, None for all. ``deferred`` (the guard) holds the ring's
    buckets until :meth:`mean`, where this rank's health flag is known and
    rotates with each bucket's payload; the gather's buckets go out as
    before and the flags reach their decode. ``survivor`` (with the guard)
    takes the survivor-exact mean: one division by the kept count, which
    the caller does not rescale."""

    def __init__(self, codec, plan, layouts, *, aggregate: str, rank: int, world: int,
                 n_contrib: int, ring_bucket_size: int, sel_start: Optional[int] = None,
                 group=None, stream=None, deferred: bool = False, survivor: bool = False):
        self.codec, self.plan, self.layouts = codec, plan, layouts
        self.aggregate, self.rank, self.world, self.group = aggregate, rank, world, group
        self.n_contrib, self.sel_start = n_contrib, sel_start
        self.ring_bucket_size, self.stream = ring_bucket_size, stream
        self.deferred, self.survivor = deferred, survivor
        self.gathered: dict = {}
        self.rings: dict = {}
        self.means: list = [None] * plan.n_leaves

    def __call__(self, b: int, idxs, inputs, payloads) -> None:
        if self.aggregate == "gather":
            buf, spec = pack_tree_buckets(payloads)
            if not dist.is_initialized():  # one replica and no group: its own row
                self.gathered[b] = (buf.view(1, spec.nbytes), spec, None, buf)
                return
            out = torch.empty((self.world * spec.nbytes,), dtype=torch.uint8, device=buf.device)
            work = dist.all_gather_into_tensor(out, buf, group=self.group, async_op=True)
            self.gathered[b] = (out.view(self.world, spec.nbytes), spec, work, buf)
            return
        if self.deferred:
            self.rings[b] = (idxs, inputs, payloads)
            return
        self._ring(idxs, inputs, payloads)

    def _ring(self, idxs, inputs, payloads, ok=None):
        from atomo_tpu_torch.codecs import codec_subset
        from atomo_tpu_torch.parallel.replicated import ring_stream_mean

        out = ring_stream_mean(codec_subset(self.codec, idxs), payloads, inputs,
                               rank=self.rank, world=self.world, sel_start=self.sel_start,
                               n_contrib=self.n_contrib, ring_bucket_size=self.ring_bucket_size,
                               layouts=[self.layouts[i] for i in idxs], group=self.group, ok=ok,
                               survivor_exact=self.survivor and ok is not None)
        mean_b, kept = out if ok is not None else (out, None)
        for i, m in zip(idxs, mean_b):
            self.means[i] = m
        return kept

    def mean(self, like: Sequence[torch.Tensor], ok: Optional[torch.Tensor] = None):
        """The mean gradient (port layout), on the current stream; with
        ``ok`` (this rank's guard flag) ``(mean over the healthy replicas'
        slots, the survivors' count)``, the caller rescaling by n/kept."""
        from atomo_tpu_torch.parallel.replicated import _rotating_rows

        cur = None if self.stream is None else torch.cuda.current_stream(self.stream.device)
        if self.aggregate == "ring":
            kept = None
            for b in sorted(self.rings):
                kept = self._ring(*self.rings.pop(b), ok=ok)
            for m in self.means:
                if cur is not None:
                    m.record_stream(cur)
            return list(self.means) if ok is None else (list(self.means), kept)
        parts: list = [None] * self.plan.n_leaves
        okg = None
        with record_function("step.exchange"):
            for b, (rows, spec, work, _) in sorted(self.gathered.items()):
                if work is not None:
                    work.wait()
                if cur is not None:
                    rows.record_stream(cur)
                if self.sel_start is not None:
                    rows = _rotating_rows(rows, self.sel_start, self.n_contrib)
                for i, p in zip(self.plan.buckets[b], unpack_tree_buckets(rows, spec)):
                    parts[i] = p
            if ok is not None:
                okg = gather_flags(ok, self.world, self.group)
                if self.sel_start is not None:
                    okg = _rotating_rows(okg.view(self.world, 1), self.sel_start,
                                         self.n_contrib).reshape(-1)
        with record_function("step.decode_mean"):
            surv = self.survivor and okg is not None
            mean = decode_mean_tree(self.codec, parts, like, self.n_contrib, self.layouts,
                                    fused=not surv, replica_ok=okg, survivor=surv)
        return mean if ok is None else (mean, okg.sum())


def gather_flags(ok: torch.Tensor, world: int, group=None) -> torch.Tensor:
    """Every rank's guard flag, (N,) float32 in rank order."""
    okg = torch.empty((world,), dtype=torch.float32, device=ok.device)
    flag = ok.to(torch.float32).reshape(1)
    if world > 1 and dist.is_initialized():
        dist.all_gather_into_tensor(okg, flag, group=group)
    else:
        okg.copy_(flag)
    return okg


def issued_under_backward(log: Sequence) -> int:
    """How many buckets a :class:`BucketStream` log issued before the
    step's last readiness hook fired (0 when every encode waited for the
    end of backward)."""
    last_ready = max((k for k, (ev, _) in enumerate(log) if ev == "ready"), default=-1)
    return sum(1 for k, (ev, _) in enumerate(log) if ev == "issue" and k < last_ready)


# ------------------------------------------------------------ the carry


@dataclasses.dataclass
class OverlapCarry:
    """The in-flight aggregation of ``--overlap delayed`` (the JAX
    package's ``OverlapCarry``): ``payload`` is this rank's encoded gradient
    of the previous step, packed as the gather ships it (one (B,) uint8
    buffer, ``spec`` its layout), updated in place each step (a CUDA graph
    reads the same buffer at every replay); ``ok`` the producing step's
    per-rank guard flags, (N,) float32 (all ones without the guard), which
    the consume masks the payloads with; ``valid`` False until a payload is in flight: the step that
    consumes an invalid carry applies nothing. A loaded checkpoint leaves
    in ``TrainState.carry`` instead the dict it saved (every rank's payload
    as one (N, B) tensor), which :func:`carry_from_saved` takes apart."""

    payload: torch.Tensor
    spec: PackSpec
    ok: torch.Tensor
    valid: bool = False


def init_carry(codec, params: Sequence[torch.Tensor], world: int, layouts=None) -> OverlapCarry:
    """A fresh carry: a zero payload of the size this codec gives these
    leaves (its layout read off one encode of the parameters themselves,
    finite values of the gradient's shapes; the JAX package takes the
    shapes by ``eval_shape``), all-ones flags, ``valid`` False."""
    with torch.no_grad():
        payloads, _ = encode_tree(codec, 0, [p.detach() for p in params], None, layouts)
        buf, spec = pack_tree_buckets(payloads)
    return OverlapCarry(payload=torch.zeros_like(buf), spec=spec,
                        ok=torch.ones((world,), dtype=torch.float32, device=buf.device))


def gather_carry(carry: OverlapCarry, world: int, group=None) -> dict:
    """The checkpoint form of a carry: every rank's payload as one (N, B)
    uint8 tensor (one all-gather over ``group``), ``ok`` and ``valid`` as
    float32 tensors."""
    buf = carry.payload
    if world > 1:
        out = torch.empty((world * buf.numel(),), dtype=torch.uint8, device=buf.device)
        dist.all_gather_into_tensor(out, buf, group=group)
    else:
        out = buf
    return {"payload": out.view(world, -1), "ok": carry.ok,
            "valid": torch.tensor(float(carry.valid), dtype=torch.float32)}


def carry_from_saved(fresh: OverlapCarry, saved, rank: int, world: int):
    """(carry, why): ``fresh`` with this rank's row of a saved carry
    (:func:`gather_carry`'s dict) copied in, or ``fresh`` and the reason the
    saved one does not fit (None saved: no carry in the checkpoint)."""
    if saved is None:
        return fresh, "no overlap_carry in the checkpoint"
    payload = saved["payload"]
    want = (world, fresh.payload.numel())
    if tuple(payload.shape) != want:
        return fresh, f"its carry is {tuple(payload.shape)}, this run needs {want}"
    with torch.no_grad():
        fresh.payload.copy_(payload[rank])
        fresh.ok.copy_(saved["ok"])
    return dataclasses.replace(fresh, valid=bool(float(saved["valid"]) > 0)), None


def consume(codec, carry: OverlapCarry, like: Sequence[torch.Tensor], *, aggregate: str,
            rank: int, world: int, sel_start: Optional[int], n_contrib: int,
            ring_bucket_size: int, layouts, group=None, guard: bool = False):
    """The carried payload's exchange and decode-mean (the JAX package's
    ``delayed_apply`` consume section): gather, one ``all_gather`` of the
    packed buffer and one tree decode of the rows (the rotating subset from
    ``sel_start`` under ``num_aggregate``); ring, the staged ring mean.
    ``like`` gives the leaves' shapes (the parameters). With ``guard`` the
    carry's flags (the producing step's, every rank's) mask the decode and
    the call returns ``(mean, kept)``."""
    from atomo_tpu_torch.parallel.replicated import _rotating_rows, ring_stream_mean

    spec = carry.spec
    okg = carry.ok if guard else None
    if okg is not None and sel_start is not None:
        okg = _rotating_rows(okg.view(world, 1), sel_start, n_contrib).reshape(-1)
    if aggregate == "gather":
        with record_function("step.delayed_exchange"):
            if world > 1:
                out = torch.empty((world * spec.nbytes,), dtype=torch.uint8,
                                  device=carry.payload.device)
                dist.all_gather_into_tensor(out, carry.payload, group=group)
            else:
                out = carry.payload
            rows = out.view(world, spec.nbytes)
        with record_function("step.delayed_decode_mean"):
            if sel_start is not None:
                rows = _rotating_rows(rows, sel_start, n_contrib)
            mean = decode_mean_tree(codec, unpack_tree_buckets(rows, spec), like, n_contrib,
                                    layouts, replica_ok=okg)
            return mean if okg is None else (mean, okg.sum())
    with record_function("step.delayed_ring_exchange_decode"):
        # this rank's flag rotates with its payload
        return ring_stream_mean(codec, unpack_tree_buckets(carry.payload, spec), like,
                                rank=rank, world=world, sel_start=sel_start,
                                n_contrib=n_contrib, ring_bucket_size=ring_bucket_size,
                                layouts=layouts, group=group,
                                ok=carry.ok[rank] if guard else None)


def issue_consume(stream, fn: Callable[[], list]) -> list:
    """Run ``fn`` (a consume) on ``stream`` after the work the current
    stream has issued (a step's start), or in place off the card."""
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(stream.device))
    with _on(stream):
        return fn()


def pack_payloads(payloads: Sequence[Any]):
    """(packed buffer, spec, msg bytes) of a produced payload list."""
    from atomo_tpu_torch.codecs import payload_nbytes

    buf, spec = pack_tree_buckets(payloads)
    return buf, spec, sum(payload_nbytes(p) for p in payloads)
