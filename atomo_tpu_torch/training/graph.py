"""Superstep blocks: K steps a call, as one captured CUDA graph replayed K
times or as an eager K-step loop.

The JAX package fuses K optimizer steps into one ``jax.jit(lax.scan(
step_core))`` dispatch (``atomo_tpu/training/trainer.py:284-296``,
``atomo_tpu/parallel/replicated.py:2539-2551``). The port's form of that on
CUDA is a graph of ONE step, captured once per run and replayed once per step
of a block: the host issues one launch a step instead of the step's hundreds,
and the tail block needs no second capture. Both block forms keep the JAX
contract: K steps per call on a (K, batch, ...) block already on the device,
per-step keys from ``fold_in(key, state.step)`` (so the block is the
sequential steps and nothing else, bit for bit for any partition), and
metrics as (K,) device tensors (``msg_bytes`` a per-step constant), which the
loops fetch once a block.

**The rule** (:func:`graph_rule`). A step qualifies for the graph when it
makes no host sync and every per-step host value has a device form; it runs
the eager block otherwise. The per-step host values and their device forms:

* the codec key: a 0-d int64 device tensor (one word of a static buffer
  written before each replay); the QSGD encode kernel folds each leaf's index
  into it on the card (:class:`~atomo_tpu_torch.utils.rng.FoldedSeeds`);
* the learning rate and Adam's bias corrections: float32 device scalars
  beside the key (:meth:`~atomo_tpu_torch.training.optim.Sgd.step_scalars`);
* augmentation: the crop offsets and flips are drawn from the step's
  generator before the replay into static buffers, and the graph applies
  them (:func:`~atomo_tpu_torch.data.pipeline.augment_apply`);
* dropout: the keep-masks likewise (the step's ``dropout_masks=`` hook),
  drawn in the order the warm-up step recorded;
* error feedback's residual and ``--overlap delayed``'s carried payload:
  written in place into the buffers the next replay reads, as the momentum
  buffers are (a delayed step with nothing in flight, which applies no
  update, can only be the run's first step, the eager warm-up);
* the launch counters: a replay adds the launches the capture counted;
* the quality probes (``--obs-quality``): device outputs only, their (L,)
  per-layer series packed with the step's other metrics at fixed
  addresses, so the step keeps the graph and the mode line says the probes
  ride it;
* the step counter and the optimizer's count (the guard, chaos and the
  rewarm remedy read them): int32 device words beside the key, so a
  replayed step selects its own chaos fault and its own held optimizer
  count (:mod:`atomo_tpu_torch.training.resilience`).

By that rule the single-device step, the data-parallel step over NCCL, the
fused QSGD/TernGrad kernels, ``sgd`` (dense), per-leaf QSGD widths, the
hybrid exchange (its row codec sorts on the device), error feedback,
``--overlap delayed`` (its consume on a side stream forks from and joins the
captured stream) and both partitions of the update (``--partition
zero1|sharded-update``: ZeRO-1's closing gather and the sharded update's
materialize are NCCL collectives in the capture; the sharded update's
working buffer, which the eager step releases after each step, is then
static graph memory, held between replays) qualify. These run the eager block, each for the reason the mode line names:
a tensor not on a CUDA device; ``svd`` (``eigh`` reads its convergence flag
on the host once per shape group, and its draws come from generators seeded
on the host); the pack path's torch quantizer (its uniforms come from one
host-seeded generator per leaf); a gloo group (its collectives run on the
host); ``num_aggregate`` (the rotating subset's first replica is a host
value of each step); the ring at N > 1 (its point-to-point hops wait on
work objects the capture does not take); ``--stream-encode`` (its bucket
encodes are issued from backward hooks; the rule keeps that schedule
eager); ``aggregate='hierarchical'`` (its two tiers run over NCCL
subgroups, and no captured graph over subgroups has been tried). The
decision is made by this rule
before the run; a step that qualified and then fails to warm up, capture or
replay raises, it never runs eagerly instead.

**The mechanism** (:class:`GraphBlock`). Static input buffers hold one step's
images, labels, scalars (key and optimizer values), augmentation draws and
dropout masks. The first step of the run is the warm-up: it runs the device
form of the step eagerly on a side stream under
``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises). The next
step is captured with ``torch.cuda.CUDAGraph`` on the same stream and every
step from then on is a replay: before each, device-side copies move step k's
rows of the block (and of the block's precomputed scalars) into the static
buffers, and after it one copy moves the step's metrics into the block's
(K, n) metric tensor. Parameters, BatchNorm statistics, optimizer state and
the residual are updated in place, so nothing the graph reads is rebound;
gradients and payloads live in the graph's private pool at fixed addresses.
Under ``torch.profiler`` a replayed step shows as one graph launch: the
``record_function`` phase ranges do not exist inside a replay. So, when a
profile is armed (``phase_map_dir``, set by the loops under
``--profile-dir``), the capture itself runs under the profiler, and the
phase of each node it recorded, in capture order (the innermost ``step.*``
range around each launch call, :func:`atomo_tpu_torch.obs.timeline.
capture_phase_map`), is written to ``phase_map_dir/graph_phase_map.json``:
the timeline gives each replayed event the phase of its place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from atomo_tpu_torch.codecs import DenseCodec, QsgdCodec, SvdCodec
from atomo_tpu_torch.data.pipeline import augment_draws
from atomo_tpu_torch.models.dropout import record_dropout_calls
from atomo_tpu_torch.utils.rng import generator

def _codec_reason(codec) -> Optional[str]:
    """Why ``codec``'s encode has no device form, or None when it has one."""
    if codec is None:
        return None
    leaves = getattr(codec, "codecs", None)
    if getattr(codec, "codec_for", None) is not None and leaves is not None:
        for c in dict.fromkeys(leaves):  # the distinct resolved codecs
            why = _codec_reason(c)
            if why is not None:
                return why
        return None
    if isinstance(codec, QsgdCodec):
        if codec.use_kernel is False:
            return ("the pack path's torch quantizer draws its uniforms from a "
                    "generator seeded on the host per leaf")
        return None
    if isinstance(codec, SvdCodec):
        return ("svd: eigh reads its convergence flag on the host once per shape "
                "group, and its draws come from generators seeded on the host")
    if isinstance(codec, DenseCodec):
        return None
    return f"the {codec.name} codec has no device form"


def graph_rule(*, device, codec, backend: Optional[str] = None, world: int = 1,
               aggregate: str = "gather", k_agg: int = 0,
               stream_encode: bool = False) -> tuple[bool, str]:
    """(qualifies, why): whether a step may run as a replayed CUDA graph by
    the rule of this module's docstring. ``backend`` is the process group's
    (None for the single-device step); ``aggregate``, ``k_agg`` and
    ``stream_encode`` the data-parallel step's exchange, ``num_aggregate``
    in effect and layer-bucket encode. ``overlap='delayed'`` changes
    nothing here: its carry is device state written in place; nor does a
    partition of the update: its gathers are the group's collectives."""
    if torch.device(device).type != "cuda":
        return False, "not on a CUDA device"
    why = _codec_reason(codec)
    if why is not None:
        return False, why
    if backend is not None and backend != "nccl":
        return False, f"a {backend} group: its collectives run on the host"
    if k_agg:
        return False, ("num_aggregate: the rotating subset's first replica is a host "
                       "value of each step")
    if aggregate == "ring" and world > 1:
        return False, ("the ring at N > 1: its point-to-point hops wait on work "
                       "objects that a capture does not take")
    if stream_encode:
        return False, ("stream-encode: its bucket encodes are issued from backward hooks, "
                       "each on an event of the backward stream; the rule keeps that "
                       "schedule eager")
    if aggregate == "hierarchical":
        return False, ("hierarchical: the two-tier exchange runs over NCCL subgroups, and "
                       "no captured graph over subgroups has been tried")
    return True, "sync-free, every per-step value in device memory"


def eager_block(step: Callable, superstep: int):
    """The eager K-step block over ``step`` (a step of
    :func:`~atomo_tpu_torch.training.trainer.make_train_step` or
    :func:`~atomo_tpu_torch.parallel.replicated.make_distributed_train_step`):
    ``(state, key, images (K, B, ...), labels (K, B), **hooks) -> (state,
    metrics)``, each hook (``uniforms=``, ``draws=``, ``dropout_masks=``) a
    list of the per-step values; tensor metrics stacked to (K,) (the
    quality probe's (L,) series to (K, L)), ints (``msg_bytes``,
    ``dense_bytes``) the last step's (a per-step constant)."""

    def block(state, key, images, labels, **hooks):
        per_step = []
        for k in range(images.shape[0]):
            state, m = step(state, key, images[k], labels[k],
                            **{n: v[k] for n, v in hooks.items() if v is not None})
            per_step.append(m)
        return state, {name: torch.stack([m[name] for m in per_step]) if torch.is_tensor(v)
                       else v for name, v in per_step[-1].items()}

    block.superstep = superstep
    return block


@dataclasses.dataclass
class _Static:
    """The graph's inputs and outputs at fixed addresses."""

    images: torch.Tensor
    labels: torch.Tensor
    scalars: torch.Tensor  # int32: the key's two words, float32 bits, step, count
    key: torch.Tensor  # 0-d int64 view of scalars[:2]
    opt: torch.Tensor  # float32 view of scalars[2:-2]
    step: torch.Tensor  # 0-d int32: the state's 0-based step
    count: torch.Tensor  # 0-d int32: the optimizer's host count
    aug: Optional[tuple]  # (offsets, flips)
    masks: Optional[list]  # dropout keep-masks, call order
    metrics: Optional[torch.Tensor] = None  # every tensor metric flattened, float32


def _counters() -> list:
    """Every kernel wrapper's launch counter (a function attribute)."""
    from atomo_tpu_torch.ops import attention_kernels, qsgd_kernels

    return list(qsgd_kernels.KERNELS) + [attention_kernels.flash_attention_forward]


class GraphBlock:
    """The block step that replays one captured step (see the module
    docstring). ``step`` is a step function with the attributes the step
    factories set: ``core`` (the step on given keys, draws and scalars),
    ``keys(key, step) -> (k_aug, k_drop, k_codec)`` and ``drop_keys(k_drop,
    n_streams)``; ``augment`` says whether it augments, ``optimizer`` gives
    the scalars."""

    def __init__(self, step: Callable, superstep: int, *, optimizer, augment: bool, device):
        self.step = step
        self.superstep = superstep
        self.optimizer = optimizer
        self.augment = augment
        self.device = torch.device(device)
        self.static: Optional[_Static] = None
        self.names: Optional[list] = None  # the tensor metrics, packed in this order
        self.shapes: list = []  # each one's per-step shape: () or the probe's (L,)
        self.consts: dict = {}  # the int metrics (per-step constants)
        self.drop_calls: list = []  # (stream index, shape, keep_prob) of each Dropout call
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.launch_delta: list = []  # launches of one replay, per counter
        self.stream: Optional[torch.cuda.Stream] = None
        self.phase_map_dir: Optional[str] = None  # a profile is armed: record the capture's phases

    # ---------------------------------------------------------- per block

    def _scalars(self, key: int, step0: int, counts: list) -> torch.Tensor:
        """The block's per-step scalars, one row a step, on the device by one
        copy: the codec key's two int32 words, the optimizer's float32
        values' bits at each step's optimizer count, then the step and the
        count."""
        kb = len(counts)
        keys = np.array([self.step.keys(key, step0 + k)[2] for k in range(kb)], dtype=np.int64)
        opt = np.array([self.optimizer.step_scalars(c) for c in counts], dtype=np.float32)
        tail = np.array([[step0 + k, c] for k, c in enumerate(counts)], dtype=np.int32)
        rows = np.concatenate([keys.view(np.int32).reshape(kb, 2), opt.view(np.int32), tail],
                              axis=1)
        return torch.from_numpy(rows).pin_memory().to(self.device, non_blocking=True)

    def _alloc(self, images: torch.Tensor, labels: torch.Tensor, width: int) -> _Static:
        scalars = torch.zeros((width,), dtype=torch.int32, device=self.device)
        n = images.shape[0]
        aug = None
        if self.augment:
            aug = (torch.zeros((n, 2), dtype=torch.int64, device=self.device),
                   torch.zeros((n,), dtype=torch.bool, device=self.device))
        return _Static(images=torch.empty_like(images), labels=torch.empty_like(labels),
                       scalars=scalars, key=scalars[:2].view(torch.int64)[0],
                       opt=scalars[2:-2].view(torch.float32), step=scalars[-2],
                       count=scalars[-1], aug=aug, masks=None)

    def _draw(self, k_aug: int, k_drop: int) -> None:
        """This step's augmentation draws and dropout masks into the static
        buffers, from the generators the eager step would draw them from."""
        st = self.static
        if st.aug is not None:
            off, flip = augment_draws(st.images.shape[0], generator(k_aug, self.device),
                                      self.device)
            st.aug[0].copy_(off)
            st.aug[1].copy_(flip)
        if st.masks:
            keys = self.step.drop_keys(k_drop, 1 + max(c[0] for c in self.drop_calls))
            gens: dict = {}
            for mask, (j, shape, keep_prob) in zip(st.masks, self.drop_calls):
                if j not in gens:
                    gens[j] = generator(keys[j], self.device)
                mask.copy_(torch.rand(shape, generator=gens[j], device=self.device) < keep_prob)

    def _pack(self, metrics: dict) -> torch.Tensor:
        return torch.cat([metrics[n].to(torch.float32).reshape(-1) for n in self.names])

    def _core(self, state, k_drop, masks):
        st = self.static
        return self.step.core(state, st.images, st.labels, aug=st.aug, k_drop=k_drop,
                              k_codec=st.key, opt_scalars=st.opt, step_t=st.step,
                              count_t=st.count, dropout_masks=masks)

    def _warmup(self, state, k_drop: int):
        """One eager step of the device form on the side stream, no host
        sync allowed; records the Dropout calls and the metric layout."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        prior = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(self.stream), record_dropout_calls() as calls:
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, m = self._core(state, k_drop, None)
            finally:
                torch.cuda.set_sync_debug_mode(prior)
            if self.names is None:
                self.names = sorted(n for n, v in m.items() if torch.is_tensor(v))
                self.shapes = [tuple(m[n].shape) for n in self.names]
                self.consts = {n: v for n, v in m.items() if not torch.is_tensor(v)}
                self.drop_calls = calls
            row = self._pack(m)
        cur.wait_stream(self.stream)
        row.record_stream(cur)
        return state, row

    def _capture(self, state) -> None:
        """Capture one step on the static buffers; the launch counters come
        back to their values before it (a capture runs nothing)."""
        st = self.static
        if self.drop_calls:
            st.masks = [torch.zeros(shape, dtype=torch.bool, device=self.device)
                        for _, shape, _ in self.drop_calls]
        before = [fn.launches for fn in _counters()]
        self.graph = torch.cuda.CUDAGraph()
        with self._phase_map():
            with torch.cuda.graph(self.graph, stream=self.stream):
                _, m = self._core(state, None, st.masks)
                st.metrics = self._pack(m)
        after = [fn.launches for fn in _counters()]
        self.launch_delta = [a - b for a, b in zip(after, before)]
        for fn, b in zip(_counters(), before):
            fn.launches = b

    @contextlib.contextmanager
    def _phase_map(self):
        """With ``phase_map_dir`` set, profile the capture and write the
        phase of each captured node, in capture order, beside the trace the
        loop is about to take; otherwise nothing."""
        if not self.phase_map_dir:
            yield
            return
        from atomo_tpu_torch.obs.timeline import GRAPH_PHASE_MAP_NAME, capture_phase_map
        from atomo_tpu_torch.utils.tracing import TRACE_SUFFIX, profile, write_json_atomic

        with tempfile.TemporaryDirectory() as tmp:
            with profile(tmp, device=self.device):
                yield
            trace = next(os.path.join(tmp, f) for f in os.listdir(tmp)
                         if f.endswith(TRACE_SUFFIX))
            entries = capture_phase_map(trace)
        write_json_atomic(os.path.join(self.phase_map_dir, GRAPH_PHASE_MAP_NAME),
                          {"kind": "graph_phase_map", "superstep": self.superstep,
                           "n": len(entries), "entries": entries})

    def _replay(self, state):
        self.graph.replay()
        self.replays += 1
        for fn, d in zip(_counters(), self.launch_delta):
            fn.launches += d
        # the graph updated everything in place; the host's counters move on
        opt = dataclasses.replace(state.opt_state, count=state.opt_state.count + 1)
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt)

    def __call__(self, state, key, images, labels, **hooks: Any):
        if any(v is not None for v in hooks.values()):
            raise ValueError("the graph block takes no draws or masks: its steps draw "
                             "their own (run the eager block for a parity hook)")
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        kb = images.shape[0]
        step0, count0 = state.step, state.opt_state.count
        # a first step that applies nothing (a delayed step with no payload
        # in flight: the run's first, the warm-up) leaves the count as it is
        skip0 = int(getattr(self.step, "skips", lambda st: False)(state))
        if skip0 and self.names is not None:
            raise RuntimeError("a replayed step applies its update: only the run's first "
                               "step (the warm-up) may be a delayed step with nothing in "
                               "flight")
        scalars = self._scalars(key, step0, [count0 + max(k - skip0, 0) for k in range(kb)])
        # a guarded step's table of optimizer values must cover the block's
        # counts; a table reallocated under a captured graph means a capture
        reserve = getattr(self.step, "reserve", None)
        if reserve is not None and reserve(count0 + kb + 1) and self.graph is not None:
            self.graph = None
        rows = []
        for k in range(kb):
            k_aug, k_drop, _ = self.step.keys(key, step0 + k)
            if self.static is None:
                self.static = self._alloc(images[k], labels[k], scalars.shape[1])
            st = self.static
            st.images.copy_(images[k])
            st.labels.copy_(labels[k])
            st.scalars.copy_(scalars[k])
            if self.names is None:  # the run's first step is the warm-up
                self._draw(k_aug, k_drop)  # augmentation only: masks come later
                state, row = self._warmup(state, k_drop)
                rows.append(row)
                continue
            if self.graph is None:
                self._capture(state)
            self._draw(k_aug, k_drop)
            state = self._replay(state)
            rows.append(st.metrics.clone())
        packed = torch.stack(rows)
        metrics, at = {}, 0
        for n, shape in zip(self.names, self.shapes):
            size = int(np.prod(shape, dtype=np.int64))
            metrics[n] = packed[:, at:at + size].reshape(kb, *shape)
            at += size
        metrics.update(self.consts)
        return state, metrics


def make_block_step(step: Callable, superstep: int, *, optimizer, augment: bool, device,
                    rule: tuple[bool, str], probe: bool = False):
    """The K-step block over ``step``: a :class:`GraphBlock` when ``rule``
    (from :func:`graph_rule`) qualifies the step, else :func:`eager_block`.
    The block carries ``mode`` ('graph' or 'eager') and ``why`` (the rule's
    reason), which :func:`mode_line` prints, and ``probe``: the step runs
    the quality probes (``--obs-quality``), which change nothing in the rule
    (they add device outputs only: in the graph, the (L,) series are static
    outputs of the captured step, gathered into the block's (K, L))."""
    ok, why = rule
    if ok:
        block = GraphBlock(step, superstep, optimizer=optimizer, augment=augment,
                           device=device)
    else:
        block = eager_block(step, superstep)
    block.mode = "graph" if ok else "eager"
    block.why = why
    block.probe = probe
    return block


def mode_line(block) -> str:
    """The line the loops print naming the block's mode."""
    if block.mode == "graph":
        if getattr(block, "probe", False):
            return (f"Superstep: K={block.superstep}, graph (quality probes armed: their "
                    "per-layer series are outputs of the graph)")
        return f"Superstep: K={block.superstep}, graph"
    return f"Superstep: K={block.superstep}, eager block ({block.why})"
