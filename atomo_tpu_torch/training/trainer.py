"""Trainers: one device with the codec in the loop, and the data-parallel loop.

Counterpart of ``atomo_tpu/training/trainer.py`` ("compression on, comm
off"): each step runs forward and backward, encodes the gradient list with
the codec, decodes it again, and applies the momentum-SGD update, so a
single card does exactly the work of one worker of the compressed
data-parallel path. :func:`distributed_train_loop` is the counterpart of
``atomo_tpu/parallel/replicated.py:2749 distributed_train_loop``, its flat
blocking core: one process per device, the step of
:mod:`atomo_tpu_torch.parallel.replicated`. Both loops save CRC checkpoints
every ``save_freq`` steps into ``train_dir`` and resume from the newest valid
one (:mod:`atomo_tpu_torch.training.checkpoint`), replaying the data stream
past the batches already taken, so a resumed run continues the interrupted
one bit for bit. ``superstep`` K > 1 runs blocks of K steps with one metric
fetch a block (``_superstep_steps``, ``atomo_tpu/training/trainer.py:709``):
on the card a step that qualifies is one CUDA graph replayed K times, any
other step an eager K-step block (:mod:`atomo_tpu_torch.training.graph`).
The resilience stack rides both loops (``guard``, ``chaos``,
``health_timeout``, ``diverge``; :mod:`atomo_tpu_torch.training.resilience`):
the guarded step skips (one device) or masks and rescales (data-parallel) a
non-finite or exploding gradient without a host sync, chaos injects faults
at exact steps, a watchdog thread ends a run whose heartbeat stops, and the
divergence doctor rolls the run back to its newest healthy checkpoint.
``recorder`` (a :class:`~atomo_tpu_torch.obs.recorder.FlightRecorder`)
writes one ``metrics.jsonl`` record a step from the fetch the loop makes
anyway (one host copy a step, or a block), and ``track_quality`` adds the
per-layer estimator-quality probes to the step
(:mod:`atomo_tpu_torch.obs.quality`). The tuner is not ported yet.

Mixed precision (``compute_dtype=torch.bfloat16``, the CLI's ``--bf16``) is
the JAX package's (``cast_compute_inputs`` / ``cast_compute_outputs``):
forward and backward run on bfloat16 copies of the parameters and the
images; master parameters, optimizer state, gradients, loss and BatchNorm
statistics stay float32, so the codecs and the wire see float32 gradients.

The phases of a step are ``torch.profiler.record_function`` ranges
(``step.forward_backward``, ``step.encode``, ``step.decode``,
``step.update``), so a profiler trace splits the step's time by phase:
:func:`distributed_train_loop`'s ``profile_dir`` takes such a trace, which
``report timeline`` reads (:mod:`atomo_tpu_torch.obs.timeline`).

PyTorch idiom: the model is an ``nn.Module`` updated in place (its
parameters and BatchNorm statistics); :class:`TrainState` carries it with the
step counter and the optimizer state. Random streams follow the JAX step:
the step key is ``fold_in(key, step)`` split three ways (augmentation,
dropout, codec), with integer keys (:mod:`atomo_tpu_torch.utils.rng`); the
dropout key seeds the generator of the step's ``Dropout`` layers.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from atomo_tpu_torch.codecs import decode_tree, encode_tree
from atomo_tpu_torch.convert import jax_leaf_order
from atomo_tpu_torch.data.pipeline import (
    BlockStream,
    SuperstepFeed,
    augment_apply,
    augment_batch,
    block_to_device,
    to_device,
)
from atomo_tpu_torch.models.dropout import dropout_stream
from atomo_tpu_torch.models.embedding import TABLE_INIT_STD, EmbeddingTower
from atomo_tpu_torch.models.resnet import BatchNorm
from atomo_tpu_torch.models.transformer import LayerNorm
from atomo_tpu_torch.obs.quality import quality_from_decoded, quality_meta
from atomo_tpu_torch.obs.recorder import emit_worker_line
from atomo_tpu_torch.training import graph as G
from atomo_tpu_torch.training.checkpoint import latest_step, load_checkpoint
from atomo_tpu_torch.training.optim import Optimizer, OptState
from atomo_tpu_torch.utils.device import resolve_device
from atomo_tpu_torch.utils.metrics import StepMetrics, Timer, accuracy
from atomo_tpu_torch.utils.rng import fold_in, generator, split3


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: OptState
    # --error-feedback's carry: this rank's residual per leaf (port layout,
    # float32, on its device), None for the zero it starts from. A loaded
    # checkpoint leaves there every rank's residual as one (N, d) CPU tensor
    # (training.checkpoint), which distributed_train_loop takes apart.
    residual: Optional[list] = None
    # --overlap delayed's in-flight payload (parallel.overlap.OverlapCarry),
    # None outside that mode. A loaded checkpoint leaves there the dict it
    # saved (every rank's payload as one (N, B) tensor, ok, valid).
    carry: Optional[Any] = None
    # --quorum's staleness ring (parallel.replicated.QuorumCarry), None
    # outside that mode. A loaded checkpoint leaves there the dict it saved
    # (every rank's ring as one (N, K+1, B) tensor and its (N, K+1) flags).
    ring: Optional[Any] = None
    # the guard's count of skipped steps (0-d int64 on the device), None for
    # the zero it starts from: the optimizer's count is opt_state.count minus
    # it, as the JAX package holds optax's count on a skipped step
    held: Optional[torch.Tensor] = None


def leaf_params(model: nn.Module) -> list[torch.Tensor]:
    """The model's parameters in the canonical (JAX flatten) order."""
    named = dict(model.named_parameters())
    return [named[n] for n in jax_leaf_order(model)]


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> None:
    """Flax's default initialisers, drawn from one ``torch.Generator``:
    kernels LeCun-normal (truncated at 2 sigma, fan-in of the HWIO/(in, out)
    kernel), or ``variance_scaling(scale, mode, truncated normal)`` where
    the layer carries a ``variance_scaling = (scale, mode)`` attribute (the
    VGG convs' He fan-out); biases zero, BatchNorm scale 1, bias 0, mean
    0, var 1; embeddings normal with variance 1/features (``nn.Embed``'s
    ``variance_scaling(1, fan_in, normal, out_axis=0)``), LayerNorm scale 1;
    the embedding tower's table ``normal(0.02)``, its Flax initializer."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            scale, mode = getattr(m, "variance_scaling", (1.0, "fan_in"))
            # fan-in: a kernel's values per output; fan-out: per input
            fan = m.weight[0].numel() if mode == "fan_in" else m.weight[:, 0].numel()
            # 0.8796... = std of a unit normal truncated at +-2
            std = math.sqrt(scale / fan) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, math.sqrt(1.0 / m.embedding_dim), generator=gen)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, EmbeddingTower):
            nn.init.normal_(m.table, 0.0, TABLE_INIT_STD, generator=gen)


def create_state(model: nn.Module, optimizer: Optimizer, seed: int, device) -> TrainState:
    # the draws come from a CPU generator: a model already on a card (a
    # rollback's fresh start) is drawn on the CPU and moved back
    model.cpu()
    init_params(model, seed)
    model.to(device)
    return TrainState(step=0, model=model, opt_state=optimizer.init(leaf_params(model)))


def forward(model: nn.Module, images: torch.Tensor, compute_dtype=None, **kwargs) -> torch.Tensor:
    """The model's float32 logits (``kwargs`` go to the model). With
    ``compute_dtype`` the forward (and so the backward) runs on copies of the
    parameters and of floating inputs (the images; token ids stay integers)
    cast to it: the gradient reaches the float32 master parameters through
    the casts, and the BatchNorm statistics stay float32 (the JAX package
    casts every floating parameter so, ``cast_params``, not the per-op
    policy of autocast)."""
    if compute_dtype is None:
        return model(images, **kwargs)
    cast = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
    if images.is_floating_point():
        images = images.to(compute_dtype)
    return functional_call(model, cast, (images,), kwargs).float()


def augment_with(images: torch.Tensor, aug) -> torch.Tensor:
    """The step's augmentation: ``aug`` an int key (the draws from its
    generator, :func:`augment_batch`) or the device form's drawn
    ``(offsets, flips)``."""
    if isinstance(aug, tuple):
        return augment_apply(images, *aug)
    return augment_batch(images, generator(aug, images.device))


def opt_buffers(opt_state) -> list:
    """Every tensor of an optimizer state (momentum trace, Adam's moments),
    in field order: what the guard's skip holds."""
    out = []
    for f in dataclasses.fields(opt_state):
        v = getattr(opt_state, f.name)
        if isinstance(v, list):
            out.extend(v)
    return out


class Guarded:
    """The guard's per-step machinery over one model and optimizer
    (:mod:`atomo_tpu_torch.training.resilience`): fixed buffers that take
    the pre-step parameters, optimizer buffers and BatchNorm statistics
    (:meth:`snapshot`), the skip written back in place (:meth:`hold`), and
    the optimizer's values at the held count from a device table
    (:meth:`opt_scalars`). Every call is a device op: no host sync."""

    def __init__(self, optimizer, params, stats, device):
        from atomo_tpu_torch.training.resilience import OptScalarTable

        self.params, self.stats = list(params), list(stats)
        self.table = OptScalarTable(optimizer, device)
        self.device = torch.device(device)
        self.before: Optional[list] = None

    def live(self, state) -> list:
        # a sharded-update state holds its master slice in the parameters' place
        master = getattr(state, "master", None)
        params = self.params if master is None else [master]
        return params + opt_buffers(state.opt_state) + self.stats

    @torch.no_grad()
    def snapshot(self, state) -> list:
        live = self.live(state)
        if self.before is None or len(self.before) != len(live):
            self.before = [torch.empty_like(t) for t in live]
        torch._foreach_copy_(self.before, live)
        return self.before

    def held(self, state) -> torch.Tensor:
        """The state's device count of skipped steps (a fresh zero)."""
        if state.held is None:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return state.held

    def opt_scalars(self, state, held: torch.Tensor, count_t=None) -> torch.Tensor:
        """The optimizer's values at count ``count - held``: ``count_t`` the
        graph's device count, else the state's host count."""
        if count_t is None:
            self.table.reserve(state.opt_state.count + 1)
            count = torch.full((), state.opt_state.count, dtype=torch.int64,
                               device=self.device)
        else:
            count = count_t.to(torch.int64)
        return self.table.row(count - held)

    @torch.no_grad()
    def hold(self, ok: torch.Tensor, state, held: torch.Tensor, stats_ok=None) -> None:
        """Keep the step's new values where ``ok``, else the snapshot's (the
        statistics by ``stats_ok`` when given), and count a held step."""
        from atomo_tpu_torch.training.resilience import hold_

        live = self.live(state)
        n = len(live) - len(self.stats)
        hold_(ok, live[:n], self.before[:n])
        hold_(ok if stats_ok is None else stats_ok, live[n:], self.before[n:])
        held.add_((~ok).to(torch.int64))


def make_train_step(model: nn.Module, optimizer: Optimizer, codec=None, augment: bool = False,
                    compute_dtype=None, superstep: int = 1, guard=None, chaos=None,
                    remedy=None, track_grad_norm: bool = False, track_quality: bool = False):
    """Build the step ``(state, key, images, labels, uniforms=None,
    dropout_masks=None) -> (state, metrics)`` over ``model`` (which
    ``state.model`` must be), in float32 or, with ``compute_dtype``, mixed
    precision (:func:`forward`).

    ``images`` is an (N, C, H, W) float32 batch and ``labels`` int64, both on
    the model's device. The step's dropout key drives every ``Dropout`` of
    the model (:func:`~atomo_tpu_torch.models.dropout.dropout_stream`).
    ``uniforms`` (the codec's draws: for QSGD one (n_buckets, bucket_size)
    tensor per leaf, canonical order) and ``dropout_masks`` (one keep-mask
    per ``Dropout`` call, in call order) replace the step's own draws: the
    test hooks through which a parity run hands the port what the JAX step
    drew. ``metrics`` holds 0-d tensors (no host sync) and ``msg_bytes`` as
    an int.

    The resilience hooks (``atomo_tpu/training/trainer.py:115-298``), in the
    JAX step's order: ``chaos`` (a :class:`~atomo_tpu_torch.utils.chaos.
    ChaosInjector`) poisons the raw gradient of its steps; ``track_grad_norm``
    adds ``metrics["grad_norm"]``, its global L2; ``guard`` (a
    :class:`~atomo_tpu_torch.training.resilience.GuardConfig`) screens it
    (:func:`~atomo_tpu_torch.training.resilience.grad_ok`), zeroes a failing
    gradient before the codec and the update, and holds parameters,
    optimizer state (its count included) and BatchNorm statistics at their
    pre-step values on such a step, ``metrics["skipped"]`` 1 (the step
    counter still advances: the batch was consumed); ``remedy`` (a
    :class:`~atomo_tpu_torch.training.resilience.RemedyConfig`) scales the
    decoded gradient by the rewarm ramp. None of them reads a device value
    on the host.

    ``track_quality`` (``atomo_tpu/training/trainer.py:241-246``) adds
    ``metrics["q_err2"]`` and ``metrics["q_rel"]``, (L,) float32 device
    tensors in the canonical leaf order: the per-layer error of this step's
    own encode (:func:`~atomo_tpu_torch.obs.quality.quality_from_decoded`
    over the decode the step makes anyway). It needs a codec.

    ``superstep`` K > 1 returns the block step ``(state, key, images (K, B,
    ...), labels (K, B), uniforms=None, dropout_masks=None) -> (state,
    metrics)``: the K sequential steps (keys from ``fold_in(key,
    state.step)`` as always), each metric a (K,) tensor, ``msg_bytes`` the
    per-step constant, the hooks lists of per-step values. On the card a
    step that :func:`~atomo_tpu_torch.training.graph.graph_rule` qualifies
    is one captured CUDA graph replayed K times, any other an eager K-step
    loop; the block carries ``mode`` and ``why``."""
    from atomo_tpu_torch.training.resilience import (
        apply_remedy,
        global_sq_norm,
        grad_ok,
        zero_if,
    )

    if superstep < 1:
        raise ValueError(f"superstep must be >= 1, got {superstep}")
    if track_quality and codec is None:
        raise ValueError(
            "track_quality probes the codec's estimator error; dense "
            "training has no estimator to probe — drop one")
    params = leaf_params(model)
    device = params[0].device
    if chaos is not None:
        chaos.prepare(device)
    guarded = Guarded(optimizer, params, model.buffers(), device) if guard is not None else None

    def core(state: TrainState, images, labels, *, aug, k_drop, k_codec, opt_scalars=None,
             step_t=None, count_t=None,
             uniforms: Optional[Sequence[torch.Tensor]] = None,
             dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        """The step on given keys (ints, or the device form: ``aug`` drawn,
        ``k_codec`` a 0-d device tensor, ``opt_scalars`` the optimizer's
        device values, ``step_t`` and ``count_t`` the step and the
        optimizer's count as 0-d device integers)."""
        if augment:
            images = augment_with(images, aug)
        model.train()
        for p in params:
            p.grad = None
        if guarded is not None:
            guarded.snapshot(state)  # before forward: it moves the statistics
        with record_function("step.forward_backward"), dropout_stream(k_drop, dropout_masks):
            logits = forward(model, images, compute_dtype)
            loss = F.cross_entropy(logits, labels)
            loss.backward()
        grads = [p.grad for p in params]
        step_index = state.step if step_t is None else step_t  # 0-based
        if chaos is not None:
            grads = chaos.inject_grads(grads, step_index + 1)
        gnorm = torch.sqrt(global_sq_norm(grads)) if track_grad_norm else None
        ok = None
        if guarded is not None:
            ok = grad_ok(grads, guard.max_grad_norm)
            grads = zero_if(~ok, grads)
        msg_bytes = 0
        qm = None
        if codec is not None:
            with record_function("step.encode"):
                payloads, stats = encode_tree(codec, k_codec, grads, uniforms)
            with record_function("step.decode"):
                decoded = decode_tree(codec, payloads, grads)
            if track_quality:
                # the step's own decode is this replica's: no second decode
                qm = quality_from_decoded(decoded, grads)
            grads = decoded
            msg_bytes = stats.payload_bytes
        if remedy is not None:
            grads = apply_remedy(remedy, step_index, grads)
        held = None
        if guarded is not None:
            held = guarded.held(state)
            opt_scalars = guarded.opt_scalars(state, held, count_t)
        with record_function("step.update"):
            opt_state = optimizer.update(grads, state.opt_state, params, scalars=opt_scalars)
        prec1, prec5 = accuracy(logits.detach(), labels)
        metrics = {"loss": loss.detach(), "prec1": prec1, "prec5": prec5,
                   "msg_bytes": msg_bytes}
        if guarded is not None:
            guarded.hold(ok, state, held)
            metrics["skipped"] = 1.0 - ok.to(torch.float32)
        if gnorm is not None:
            metrics["grad_norm"] = gnorm
        if qm is not None:
            metrics.update(qm)
        return TrainState(step=state.step + 1, model=model, opt_state=opt_state,
                          held=held), metrics

    def keys(key: int, step_index: int) -> tuple[int, int, int]:
        """(k_aug, k_drop, k_codec) of step ``step_index``."""
        return split3(fold_in(key, step_index))

    def step(state: TrainState, key: int, images, labels,
             uniforms: Optional[Sequence[torch.Tensor]] = None,
             dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        k_aug, k_drop, k_codec = keys(key, state.step)
        return core(state, images, labels, aug=k_aug, k_drop=k_drop, k_codec=k_codec,
                    uniforms=uniforms, dropout_masks=dropout_masks)

    step.core = core
    step.keys = keys
    step.drop_keys = lambda k_drop, n: [k_drop]  # one stream drives every Dropout
    if guarded is not None:
        step.reserve = guarded.table.reserve
    if superstep == 1:
        return step
    return G.make_block_step(step, superstep, optimizer=optimizer, augment=augment,
                             device=device, rule=G.graph_rule(device=device, codec=codec),
                             probe=track_quality)


@torch.no_grad()
def evaluate(model: nn.Module, test_iter, device) -> dict[str, float]:
    """Full-test-set loss and prec@1/5 (the reference validate)."""
    model.eval()
    totals = {"loss": 0.0, "prec1": 0.0, "prec5": 0.0}
    n = 0
    for images, labels in test_iter.epoch():
        x, y = to_device(images, labels, device)
        logits = model(x)
        prec1, prec5 = accuracy(logits, y)
        bs = x.shape[0]
        totals["loss"] += float(F.cross_entropy(logits, y)) * bs
        totals["prec1"] += float(prec1) * bs
        totals["prec5"] += float(prec5) * bs
        n += bs
    return {k: v / max(n, 1) for k, v in totals.items()}


def _resume(state: TrainState, train_dir: Optional[str], resume: bool, log_fn) -> TrainState:
    """``state`` restored from the newest valid checkpoint in ``train_dir``
    when ``resume`` is set and the directory holds one, with the JAX
    package's log lines; otherwise ``state``."""
    if not (resume and train_dir and latest_step(train_dir) is not None):
        return state
    try:
        state = load_checkpoint(train_dir, state)
    except FileNotFoundError as exc:
        # files exist but none passed the checks: a fresh start beats dying
        log_fn(f"Resume requested but {exc}; starting fresh")
        return state
    log_fn(f"Resumed from {train_dir} at step {state.step}")
    return state


def gather_residual(state: TrainState, world: int) -> torch.Tensor:
    """Every rank's residual as one (world, d) float32 tensor (canonical
    leaf order, port layout, flattened), by one all-gather."""
    flat = torch.cat([r.reshape(-1) for r in state.residual])
    out = torch.empty((world * flat.numel(),), dtype=flat.dtype, device=flat.device)
    torch.distributed.all_gather_into_tensor(out, flat)
    return out.view(world, -1)


def own_residual(state: TrainState, model: nn.Module, rank: int, world: int,
                  dev) -> TrainState:
    """``state`` with this rank's residual: its row of a loaded (world, d)
    carry on ``dev``; None (a zero start) for a fresh run, and, with the
    JAX package's warning, for a checkpoint without a carry of this shape."""
    if state.step == 0:  # a fresh start: its residual is the zero one
        return state
    params = leaf_params(model)
    d = sum(p.numel() for p in params)
    saved = state.residual
    if saved is None or tuple(saved.shape) != (world, d):
        why = ("no ef_residual in the checkpoint" if saved is None else
               f"its carry is {tuple(saved.shape)}, this run needs ({world}, {d})")
        warnings.warn(
            "--error-feedback resume: checkpoint has no residual "
            f"carry ({why}); restoring the train state only — "
            "the first resumed step starts from a zero residual")
        return dataclasses.replace(state, residual=None)
    row = saved[rank].to(dev)
    return dataclasses.replace(state, residual=[
        v.view(p.shape) for v, p in zip(row.split([p.numel() for p in params]), params)])


def _check_loop_modes(codec, aggregate: str, overlap: str, stream_encode: bool,
                      error_feedback: bool) -> None:
    """The JAX loop's refusals of ``overlap``, ``stream_encode``, error
    feedback's exchange and their compositions (``atomo_tpu/parallel/
    replicated.py:2975-3025, 3085-3100``)."""
    if error_feedback and (codec is None or aggregate == "hierarchical"):
        raise ValueError(
            "--error-feedback needs a compressing codec with flat "
            "gather/ring/psum aggregation (the hierarchical boundary "
            "re-encode's composition argument does not survive the "
            "EF bias)")
    if overlap not in ("off", "delayed"):
        raise ValueError(f"unknown overlap mode {overlap!r}; expected 'off' or 'delayed'")
    if overlap == "delayed" and (codec is None or aggregate not in ("gather", "ring")):
        raise ValueError(
            "--overlap delayed needs a compressing codec with "
            "--aggregate gather or ring (psum and the two-level "
            "hierarchical schedules — legacy plan or the "
            "topology re-encoded plans — have no delayed form)")
    if error_feedback and overlap == "delayed":
        raise ValueError(
            "--error-feedback does not compose with --overlap "
            "delayed: the stale carry's residual semantics are "
            "unproven — rejected honestly")
    if stream_encode and (codec is None or aggregate not in ("gather", "ring")):
        raise ValueError(
            "--stream-encode needs a compressing codec with "
            "--aggregate gather or ring (psum has no encode to "
            "stream; the hierarchical boundary re-encode is not "
            "bucket-aware yet — rejected rather than silently "
            "degraded)")


def _crossed(cadence: int, lo: int, hi: int) -> bool:
    """True iff a multiple of ``cadence`` lies in (lo, hi]: the boundary test
    that snaps every per-step cadence (log, eval, save) to superstep block
    boundaries (``atomo_tpu/training/trainer.py:666``); the event fires at
    ``hi``, the block's last step."""
    return bool(cadence) and hi // cadence > lo // cadence


def _block_log_record(s, m, train_iter, n_train, lap, last_logged) -> StepMetrics:
    """The ``Worker:`` record of a block boundary (``:688``): loss and
    precision averaged over the block's steps (``msg_bytes`` is a per-step
    constant), ``time_cost`` the per-step average of the span since the last
    log. ``m`` holds the block's fetched numpy series."""
    return StepMetrics(
        rank=0,
        step=s,
        epoch=s * train_iter.batch_size // max(n_train, 1),
        samples_seen=(s * train_iter.batch_size) % max(n_train, 1),
        dataset_size=n_train,
        loss=float(np.mean(m["loss"])),
        time_cost=lap / max(s - last_logged, 1),
        msg_bytes=int(np.asarray(m["msg_bytes"]).reshape(-1)[-1]),
        prec1=float(np.mean(m["prec1"])),
        prec5=float(np.mean(m["prec5"])),
    )


def _chaos_corrupt_range(chaos, path, lo: int, hi: int) -> None:
    """Apply the checkpoint faults aimed at any step in (lo, hi] to the file
    written at ``hi`` (``atomo_tpu/training/trainer.py:676``): a fault
    snaps to the block boundary as kill and sleep do."""
    if chaos is None or path is None:
        return
    for t in range(lo + 1, hi + 1):
        chaos.maybe_corrupt_checkpoint(path, t)


def _host_faults(chaos, lo: int, hi: int, world: int = 0) -> None:
    """The chaos host faults aimed at steps (lo, hi], before they run: kill,
    sleep and, with ``world`` ranks, the stragglers' lag."""
    if chaos is None:
        return
    for t in range(lo + 1, hi + 1):
        chaos.maybe_die(t)
        chaos.maybe_sleep(t)
        if world:
            chaos.maybe_sleep_replica(t, world)


def fetch_metrics(metrics: dict, names: Optional[Sequence[str]] = None) -> dict:
    """The named tensor metrics (with ``names`` None every tensor metric,
    and the ints as they are) on the host by one copy, every tensor
    flattened into one float32 buffer: a 0-d metric as a float, a series
    (a block's (K,), the probes' (L,) or (K, L)) as a numpy array of its
    shape. A step's or a block's one host sync."""
    out = {}
    if names is None:
        out = {n: v for n, v in metrics.items() if not torch.is_tensor(v)}
        names = [n for n, v in metrics.items() if torch.is_tensor(v)]
    have = [n for n in names if n in metrics]
    if not have:
        return out
    flat = torch.cat([metrics[n].to(torch.float32).reshape(-1) for n in have]).cpu().numpy()
    at = 0
    for n in have:
        shape = tuple(metrics[n].shape)
        size = int(np.prod(shape, dtype=np.int64))
        v = flat[at:at + size].reshape(shape)
        out[n] = float(v) if v.ndim == 0 else v
        at += size
    return out


DOCTOR_SERIES = ("loss", "skipped", "sample_skipped", "grad_norm")


def _superstep_steps(state, block_fn, key, stream, put_fn, *, train_iter, n_train: int,
                     start_step: int, max_steps: int, superstep: int, log_every: int,
                     log_fn, eval_freq: int, evaluate_fn, save_freq: int, train_dir,
                     save_fn, timer: Timer, monitor=None, chaos=None, rig=None,
                     guard_line=None, world: int = 0, before_recover=None, recorder=None,
                     profile_dir: Optional[str] = None, device=None, retune=None):
    """The block loop of both train loops (``_superstep_steps`` :709 and
    ``_distributed_superstep_steps``, ``atomo_tpu/parallel/replicated.py:4391``):
    one ``block_fn`` call per K steps on a block :class:`SuperstepFeed`
    staged behind the previous one (``put_fn`` puts a numpy block on the
    device), the last block shrunk to ``max_steps``, one metric fetch a
    block; the ``Worker:`` line, ``evaluate_fn(step)`` and ``save_fn(state,
    step) -> path or None`` fire at the boundary of a block that crossed
    their cadence, and the final state is saved when the last save came
    before ``max_steps``. Resilience at block boundaries: chaos kill and
    sleep aimed anywhere in a block fire before it runs, checkpoint faults
    after the boundary save; the watchdog ``monitor`` beats once a block;
    ``guard_line(step, kb, m)`` gives the block's ``Guard:`` line (or None);
    ``rig`` (a :class:`~atomo_tpu_torch.training.resilience.RecoveryRig`)
    folds the block's series at its one fetch and, on an alarm, rolls back:
    the feed's staged block is dropped and the feed rebuilt on the replayed
    stream (``before_recover()`` first, a barrier over the ranks).
    ``recorder`` writes the block's K step records from its one fetch, the
    block's host wall as K equal shares, before the doctor observes it (a
    diverged block lands in the timeline and the rollback's prune cuts it);
    the ``Worker:`` line goes through its sink. ``profile_dir`` traces the
    second block (the first warms up and captures) with
    :func:`~atomo_tpu_torch.utils.tracing.profile` and records its
    ``profile_window``; a graph block records its capture's phase map there
    (:class:`~atomo_tpu_torch.training.graph.GraphBlock`). ``retune(step)``
    runs after each boundary save and returns a rebuilt block function or
    None."""
    from atomo_tpu_torch.utils.tracing import profile

    log_fn(G.mode_line(block_fn))
    if profile_dir and getattr(block_fn, "mode", None) == "graph":
        block_fn.phase_map_dir = profile_dir
    feed = SuperstepFeed(BlockStream(stream), put_fn)
    s = last_saved = last_logged = start_step
    block_idx = 0
    prof_ctx = None
    t_rec = time.perf_counter()  # the recorder's wall anchor
    feed.start(min(superstep, max_steps - s))
    while s < max_steps:
        kb, images, labels = feed.take()
        b0, s = s, s + kb
        block_idx += 1
        _host_faults(chaos, b0, s, world)
        if profile_dir and block_idx == 2 and prof_ctx is None:
            # block 1 warms up (and captures a graph); trace the second block
            prof_ctx = profile(profile_dir, device=device)
            prof_ctx.__enter__()
            log_fn(f"Profiling superstep block {b0 + 1}..{s} -> {profile_dir}")
            if recorder is not None:
                # the `report timeline` join key (per-step-loop twin)
                recorder.write_meta({"what": "profile_window", "first_step": b0 + 1,
                                     "last_step": s, "profile_dir": profile_dir})
        state, mblk = block_fn(state, key, images, labels)
        feed.start(min(superstep, max_steps - s))  # the next copy runs behind this block
        m = fetch_metrics(mblk)
        if monitor is not None:
            monitor.beat(s)
        if recorder is not None:
            now_r = time.perf_counter()
            recorder.record_block(b0 + 1, m, wall_s=now_r - t_rec,
                                  generation=rig.doctor.generation if rig is not None else None)
            t_rec = now_r
        if prof_ctx is not None:
            prof_ctx.__exit__(None, None, None)
            prof_ctx = None
            block_fn.phase_map_dir = None
        if rig is not None:
            alarm_step, reason = rig.observe(b0 + 1, m)
            if reason is not None:
                if before_recover is not None:
                    before_recover()
                state, stream, block_fn, chaos, s = rig.recover(alarm_step, reason, chaos)
                last_saved, last_logged = min(last_saved, s), min(last_logged, s)
                feed.drop()  # the lookahead belongs to the abandoned timeline
                feed = SuperstepFeed(BlockStream(stream), put_fn)
                feed.start(min(superstep, max_steps - s))
                t_rec = time.perf_counter()  # recovery is not step time
                continue
            new_fn = rig.maybe_end_densify(s)
            if new_fn is not None:
                block_fn = new_fn
        if guard_line is not None and _crossed(log_every, b0, s):
            line = guard_line(s, kb, m)
            if line:
                log_fn(line)
        if _crossed(log_every, b0, s):
            emit_worker_line(recorder, _block_log_record(s, m, train_iter, n_train, timer.lap(),
                                                         last_logged), log_fn)
            last_logged = s
        if eval_freq and evaluate_fn is not None and _crossed(eval_freq, b0, s):
            evaluate_fn(s)
        if save_freq and train_dir and _crossed(save_freq, b0, s):
            path = save_fn(state, s)
            last_saved = s
            if rig is not None:
                rig.note_save(s)
            _chaos_corrupt_range(chaos, path, b0, s)
            if retune is not None:
                # a re-allocation snaps to the checkpoint: the rebuilt block
                # (a fresh capture under a graph) runs from the next block
                new_fn = retune(s)
                if new_fn is not None:
                    block_fn = new_fn
        t_rec = time.perf_counter()  # boundary work (eval, save) is not step time
    if save_freq and train_dir and last_saved < max_steps:
        path = save_fn(state, max_steps)
        if rig is not None:
            rig.note_save(max_steps)
        _chaos_corrupt_range(chaos, path, last_saved, max_steps)
    return state


def _incidents(train_dir, armed: bool):
    """The run's incident log when it has a ``train_dir`` and either a
    doctor or a supervisor above it, else None."""
    from atomo_tpu_torch.training.resilience import SUPERVISED_ENV
    from atomo_tpu_torch.utils.tracing import IncidentLog

    if train_dir and (armed or os.environ.get(SUPERVISED_ENV) == "1"):
        return IncidentLog.for_train_dir(train_dir)
    return None


def _check_diverge(diverge, *, train_dir, codec, save_freq, keep_ckpts, **kw) -> None:
    if diverge is None:
        return
    from atomo_tpu_torch.training.resilience import diverge_conflict

    reason = diverge_conflict(diverge.remedy, train_dir=train_dir, codec=codec,
                              keep_ckpts=keep_ckpts, save_freq=save_freq,
                              window=diverge.detector.window, **kw)
    if reason:
        raise ValueError(reason)


def _arm_recorder(recorder, track_quality: bool, codec, model, start_step: int, *,
                  aggregate: Optional[str] = None, hybrid=None,
                  stream_bucket_bytes: Optional[int] = None) -> None:
    """Ready ``recorder`` for a run from ``start_step``: the aggregate
    column (``local`` on one device unless set), the tail past the
    resumed step cut before the replay re-records it, and with
    ``track_quality`` the per-layer byte split written once."""
    if recorder is None:
        return
    if aggregate is None:
        recorder.context.setdefault("aggregate", "local")
    else:
        recorder.set_context(aggregate=aggregate)
    recorder.prune_past(start_step)
    if track_quality:
        recorder.write_meta(quality_meta(codec, model, stream_bucket_bytes=stream_bucket_bytes,
                                         hybrid=hybrid))


def train_loop(
    model: nn.Module,
    optimizer: Optimizer,
    train_iter,
    test_iter=None,
    *,
    codec=None,
    augment: bool = False,
    max_steps: int = 100,
    eval_freq: int = 0,
    seed: int = 0,
    train_dir: Optional[str] = None,
    save_freq: int = 0,
    resume: bool = False,
    keep_ckpts: int = 0,
    compress_ckpt: bool = True,
    compute_dtype=None,
    log_fn=print,
    log_every: int = 1,
    device=None,
    superstep: int = 1,
    guard=None,
    chaos=None,
    health_timeout: float = 0.0,
    on_health_failure=None,
    diverge=None,
    track_quality: bool = False,
    recorder=None,
) -> TrainState:
    """The reference train-and-validate loop: ``Worker:`` lines every
    ``log_every`` steps, ``Validation:`` lines every ``eval_freq`` steps, a
    checkpoint into ``train_dir`` every ``save_freq`` steps (keeping the
    newest ``keep_ckpts`` when > 0, lossless-compressed with
    ``compress_ckpt``, saved with retries) and of the final state when the
    last save came before ``max_steps``. ``resume`` continues from the newest
    valid checkpoint there: the data stream skips the batches already taken,
    so the run goes on as the interrupted one would have. ``superstep`` K > 1
    runs blocks of K steps (:func:`make_train_step`'s block step), one
    metric fetch a block, every cadence snapped to the block boundaries;
    trajectories are those of K = 1 bit for bit, and resume works at any
    step. Runs on CUDA unless ``device='cpu'``.

    The resilience stack (``atomo_tpu/training/trainer.py:327-668``):
    ``guard`` skips a step whose gradient fails the screen (a ``Guard:``
    line at the log cadence); ``chaos`` (default: the ATOMO_CHAOS env)
    injects its faults (crashloop at the start, kill and sleep before their
    step, checkpoint damage after the save); ``health_timeout`` > 0 arms
    the heartbeat watchdog (beaten once a step, once a block scaled by K);
    ``diverge`` (a :class:`~atomo_tpu_torch.training.resilience.
    DivergeConfig`) arms the doctor, which folds the loss, skip and grad-norm
    series (one fetch a step, or the block's), grants healthy tags and rolls
    back to the newest healthy checkpoint with the data stream replayed and
    the chaos generation bumped; its budget spent, it raises
    :class:`~atomo_tpu_torch.training.resilience.DivergenceError`.

    ``recorder`` (:class:`~atomo_tpu_torch.obs.recorder.FlightRecorder`,
    ``atomo_tpu/training/trainer.py:484-497,548-567``) arms the flight
    recorder: the file is cut past the resumed step before the replay, one
    ``step`` record a step (a block's K from its one fetch) with the host
    wall, before the doctor observes it, and each ``Worker:`` line mirrored
    as a ``log`` record. ``track_quality`` arms the step's quality probes
    (:func:`make_train_step`) and records their per-layer byte split once as
    a ``meta`` line. Disarmed, the loop prints exactly what it printed."""
    from atomo_tpu_torch.training.resilience import (
        DivergenceDoctor,
        RecoveryRig,
        heartbeat_watchdog,
        resolve_chaos,
        retrying_saver,
    )

    if track_quality and codec is None:
        raise ValueError(
            "track_quality (--obs-quality) probes the codec's estimator "
            "error; dense training has no estimator — drop one")
    chaos = resolve_chaos(chaos)
    if chaos is not None:
        chaos.maybe_die_crashloop()
    dev = resolve_device(device)
    state = _resume(create_state(model, optimizer, seed, dev), train_dir, resume, log_fn)
    start_step = state.step
    _check_diverge(diverge, train_dir=train_dir, codec=codec, save_freq=save_freq,
                   keep_ckpts=keep_ckpts)
    incidents = _incidents(train_dir, diverge is not None)

    def build_step(generation=0, remedy_cfg=None, densify=False):
        chaos_now = chaos.with_generation(generation) if chaos is not None and generation \
            else chaos
        return make_train_step(model, optimizer, codec=None if densify else codec,
                               augment=augment, compute_dtype=compute_dtype,
                               superstep=superstep, guard=guard, chaos=chaos_now,
                               remedy=remedy_cfg, track_grad_norm=diverge is not None,
                               # the densify window runs dense: no estimator to probe
                               track_quality=track_quality and not densify)

    _arm_recorder(recorder, track_quality, codec, model, start_step)
    step_fn = build_step()
    saver = retrying_saver(log_fn, incidents)

    def save_fn(st, step):
        return saver(train_dir, st, step, compress=compress_ckpt, keep=keep_ckpts)

    key = seed + 1
    timer = Timer()
    # the replay anchor of a rollback, taken before forever() draws
    rng_snapshot = train_iter.snapshot_rng() if diverge is not None else None
    stream = train_iter.forever(skip=start_step)
    n_train = len(train_iter.dataset)
    rig = None
    if diverge is not None:
        def _reload(target):
            st = create_state(model, optimizer, seed, dev)
            return st if target <= 0 else load_checkpoint(train_dir, st, step=target)

        rig = RecoveryRig(DivergenceDoctor(diverge, train_dir, incidents, log_fn), diverge,
                          _reload, lambda target: train_iter.restream(rng_snapshot, skip=target),
                          build_step)

    def validate(step: int) -> None:
        ev = evaluate(model, test_iter, dev)
        log_fn("Validation: Step: {}, Loss: {:.4f}, Prec@1: {:.4f}, Prec@5: {:.4f}".format(
            step, ev["loss"], ev["prec1"], ev["prec5"]))

    if superstep > 1:
        def guard_line(s, kb, m):
            n_skipped = float(np.sum(m["skipped"]))
            if n_skipped <= 0:
                return None
            return (f"Guard: Step: {s}, Dropped: {int(n_skipped)}/{kb}, "
                    "Action: skip (anomalous gradient inside the superstep; "
                    "params/opt state held for those steps)")

        # one beat a block: the budget scales by K
        with heartbeat_watchdog(health_timeout * superstep, on_health_failure) as monitor:
            return _superstep_steps(
                state, step_fn, key, stream, lambda x, y: block_to_device(x, y, dev),
                train_iter=train_iter, n_train=n_train, start_step=start_step,
                max_steps=max_steps, superstep=superstep, log_every=log_every, log_fn=log_fn,
                eval_freq=eval_freq, evaluate_fn=validate if test_iter is not None else None,
                save_freq=save_freq, train_dir=train_dir, timer=timer, save_fn=save_fn,
                monitor=monitor, chaos=chaos, rig=rig,
                guard_line=guard_line if guard is not None else None, recorder=recorder)
    last_saved = start_step
    with heartbeat_watchdog(health_timeout, on_health_failure) as monitor:
        step = start_step
        t_rec = time.perf_counter()  # the recorder's wall anchor
        while step < max_steps:
            step += 1
            _host_faults(chaos, step - 1, step)
            images, labels = to_device(*next(stream), dev)
            state, metrics = step_fn(state, key, images, labels)
            if monitor is not None:
                float(metrics["loss"])  # the step is done before it counts
                monitor.beat(step)
            host = None
            if recorder is not None:
                # one fetch a step, recorded before the doctor observes it
                host = fetch_metrics(metrics)
                now_r = time.perf_counter()
                recorder.record_block(step, host, wall_s=now_r - t_rec,
                                      generation=rig.doctor.generation if rig else None)
                t_rec = now_r
            if rig is not None:
                # one fetch a step: per-step rollback granularity's price
                alarm_step, reason = rig.observe(
                    step, host if host is not None else fetch_metrics(metrics, DOCTOR_SERIES))
                if reason is not None:
                    state, stream, step_fn, chaos, step = rig.recover(alarm_step, reason, chaos)
                    last_saved = min(last_saved, step)
                    t_rec = time.perf_counter()  # recovery is not step time
                    continue
                new_fn = rig.maybe_end_densify(step)
                if new_fn is not None:
                    step_fn = new_fn
            # the guard's diagnostics share the log cadence: no fetch a step
            if (guard is not None and log_every and step % log_every == 0
                    and float(metrics["skipped"]) > 0):
                log_fn(f"Guard: Step: {step}, Dropped: 1/1, Action: skip "
                       "(anomalous gradient; params/opt state held)")
            if log_every and step % log_every == 0:
                rec = StepMetrics(
                    rank=0,
                    step=step,
                    epoch=step * train_iter.batch_size // max(n_train, 1),
                    samples_seen=(step * train_iter.batch_size) % max(n_train, 1),
                    dataset_size=n_train,
                    loss=float(metrics["loss"]),
                    time_cost=timer.lap(),
                    msg_bytes=int(metrics["msg_bytes"]),
                    prec1=float(metrics["prec1"]),
                    prec5=float(metrics["prec5"]),
                )
                emit_worker_line(recorder, rec, log_fn)
            if eval_freq and test_iter is not None and step % eval_freq == 0:
                validate(step)
            if save_freq and train_dir and step % save_freq == 0:
                path = save_fn(state, step)
                last_saved = step
                if rig is not None:
                    rig.note_save(step)
                if chaos is not None:
                    chaos.maybe_corrupt_checkpoint(path, step)
            t_rec = time.perf_counter()  # boundary work (eval, save) is not step time
        # the final state, so that a restart never replays the tail (strictly
        # below: a resume past max_steps runs no step and writes nothing)
        if save_freq and train_dir and last_saved < max_steps:
            path = save_fn(state, max_steps)
            if rig is not None:
                rig.note_save(max_steps)
            if chaos is not None:  # checkpoint faults aim at the autosave too
                chaos.maybe_corrupt_checkpoint(path, max_steps)
    return state


def distributed_train_loop(
    model: nn.Module,
    optimizer: Optimizer,
    train_iter,
    test_iter=None,
    *,
    codec=None,
    aggregate: str = "gather",
    augment: bool = False,
    num_aggregate: int = 0,
    ring_bucket_size: int = 65536,
    grad_accum: int = 1,
    hybrid=None,
    error_feedback: bool = False,
    overlap: str = "off",
    stream_encode: bool = False,
    stream_bucket_bytes: int = 4 << 20,
    max_steps: int = 100,
    eval_freq: int = 0,
    seed: int = 0,
    train_dir: Optional[str] = None,
    save_freq: int = 0,
    resume: bool = False,
    keep_ckpts: int = 0,
    compress_ckpt: bool = True,
    compute_dtype=None,
    log_fn=print,
    log_every: int = 1,
    device=None,
    superstep: int = 1,
    guard=None,
    chaos=None,
    health_timeout: float = 0.0,
    on_health_failure=None,
    diverge=None,
    track_quality: bool = False,
    recorder=None,
    phase_metrics: bool = False,
    lr_fn=None,
    profile_dir: Optional[str] = None,
    profile_steps: int = 3,
    budget_tuner=None,
    partition: str = "replicated",
    quorum=None,
    quorum_replay: Optional[str] = None,
    mesh=None,
    plan=None,
) -> TrainState:
    """The data-parallel train-and-validate loop of this rank, in the
    process group that :func:`atomo_tpu_torch.parallel.launch.initialize`
    brought up. Every rank draws the same global batch from ``train_iter``
    (the same seeded shuffle) and trains on its rows of it; rank 0 prints
    the reference's ``Worker:`` lines every ``log_every`` steps and
    ``Validation:`` lines every ``eval_freq`` steps (the test set evaluated
    over the ranks, each batch trimmed to a multiple of them). Checkpoints
    as :func:`train_loop`'s: rank 0 writes each file and every rank waits at
    a barrier until it is in place; on resume every rank loads the same
    file. ``grad_accum`` K splits each rank's rows into K microbatches
    (:func:`~atomo_tpu_torch.parallel.replicated.make_distributed_train_step`),
    and ``hybrid`` (a :class:`~atomo_tpu_torch.sparse.HybridPlan`) runs the
    per-layer sparse-row exchange there. ``error_feedback`` carries each
    rank's compression residual from step to step, starting from zero; the
    checkpoints hold every rank's residual (gathered to rank 0), and a
    resume gives each rank its own back, so the resumed run equals the
    straight one bit for bit; a checkpoint without one (or of another world
    size) warns and starts from a zero residual. ``superstep`` K > 1 runs
    blocks of K steps, each rank on its rows of every step of the block, as
    :func:`train_loop` does; the residual rides from
    step to step inside a block and is gathered into the checkpoints at
    block boundaries. ``overlap='delayed'`` runs the stale-by-one step
    (``init_delayed_state``: step 0 applies nothing); its checkpoints hold
    every rank's in-flight payload, so a delayed resume of a delayed
    checkpoint continues bit for bit, a delayed resume of a blocking one
    warns and re-skips its first step, and a blocking resume of a delayed
    one restores the train state alone, with a warning. ``stream_encode``
    encodes layer buckets of ``stream_bucket_bytes`` under backward (the
    same trajectory). Both are validated as the JAX loop validates them
    (``atomo_tpu/parallel/replicated.py:2975-3100``). Runs on CUDA unless
    ``device='cpu'``.

    The resilience stack as :func:`train_loop`'s, over the ranks
    (``atomo_tpu/parallel/replicated.py:2749-``, guard, chaos, watchdog and
    doctor): ``guard`` masks a replica whose gradient fails the screen out
    of the exchange and rescales the survivors' mean (a ``Guard:`` line
    with the dropped count at the log cadence); chaos targets replica 0
    unless a fault is starred, and ``slow@S:R:SEC`` holds every rank's step
    for the straggler; every rank's doctor folds the same dp-mean series
    and so decides alike, rank 0 alone writes tags, prunes and incidents,
    and a rollback starts at a barrier.

    ``track_quality`` and ``recorder`` as :func:`train_loop`'s
    (``atomo_tpu/parallel/replicated.py:3927-3945``): every rank runs the
    probes and the reduce of their series, and rank 0 alone writes (a
    recorder given to another rank is not used); the ``aggregate`` column
    is the exchange in effect, and the byte split carries the hybrid plan's
    columns and, under ``stream_encode``, the bucket size.

    ``profile_dir`` (``atomo_tpu/parallel/replicated.py:4117-4175``) traces
    ``profile_steps`` steps from ``start_step + 2`` (under ``superstep`` the
    second block) on rank 0 with :func:`~atomo_tpu_torch.utils.tracing.
    profile`, logs ``Profiling steps a..b -> DIR`` and records the window as
    a ``profile_window`` meta line: what ``report timeline`` reads.
    ``phase_metrics`` runs the phased gather step
    (:func:`~atomo_tpu_torch.parallel.replicated.make_phased_step`): the
    ``Worker:`` line carries real Comp/Encode/Comm seconds and rank 0 adds the
    reference's ``Master:`` line with its Gather and Decode seconds and
    ``lr_fn(step)``; it refuses every mode the phased step cannot describe,
    with the JAX loop's texts. ``budget_tuner`` (a :class:`~atomo_tpu_torch.
    budget.BudgetRetuner`) re-solves the allocation at each checkpoint
    boundary (``:3054-3072,3882-3920``) and, when it changed, the step is
    rebuilt from the new codec (a fresh capture under a graph); it needs
    the recorded quality series and a save cadence, and refuses the
    doctor.

    ``partition`` (``atomo_tpu/parallel/replicated.py:3294-3480``) picks
    the weight update: ``replicated``, ``zero1`` (the optimizer state
    sharded over the ranks) or ``sharded-update`` (the parameters too:
    :mod:`atomo_tpu_torch.mesh.update`). Their checkpoints hold the
    gathered flat optimizer buffers (and the sharded update's gathered
    master in the parameters' place, with ``--overlap delayed``'s carry),
    written by rank 0 after the gather; a resume of one restores it bit for
    bit, a replicated (or ZeRO-1) checkpoint resumed into a sharded-update
    run restores the parameters and re-initializes the sharded optimizer
    state with the JAX loop's warning, as does a ZeRO-1 resume whose
    optimizer layout does not match. Evaluation and the final state read
    parameters materialized from the masters. The refusals are the JAX
    loop's (:func:`_check_loop_partition`).

    ``quorum`` (a :class:`~atomo_tpu_torch.quorum.QuorumConfig`; ``--quorum
    Q --staleness K``, ``atomo_tpu/parallel/replicated.py:2945-2960``) runs
    the bounded-staleness quorum step: every rank builds a
    :class:`~atomo_tpu_torch.quorum.QuorumRig` on the same chaos table, so
    each derives the same arrival vector a step (and sleeps the same
    exposed wait; the chaos blocking sleep stands down), and rank 0 alone
    writes ``arrival_schedule.jsonl`` and the ``staleness_exceeded``
    incidents; ``quorum_replay`` (``--replay-arrivals PATH``) feeds a
    recorded schedule instead. The checkpoints hold every rank's staleness
    ring, so a resume replays the same stale selections bit for bit (a
    checkpoint without a matching ring warns and warms the ring up from
    empty); a resume cuts the schedule past its step. The refusals are the
    JAX loop's (:func:`_check_loop_quorum`).

    ``aggregate='hierarchical'`` runs the two-tier exchange over ``mesh``,
    the group's two-tier :class:`~atomo_tpu_torch.mesh.spec.ProcessMesh`
    (``MeshSpec.from_world(N, K).build()``, built once by the caller, as
    every rank must make the groups in the same order), with ``plan`` (an
    :class:`~atomo_tpu_torch.topology.schedule.AggregationPlan`; None the
    legacy plan): every rank is its own data shard by its full chip id, the
    state stays replicated (checkpoints and resume as the flat run's), and
    the ``Worker:`` line's Msg(MB) is the bytes on the slow tier."""
    from atomo_tpu_torch.utils.metrics import master_line
    from atomo_tpu_torch.utils.tracing import PHASE_METRICS_HINT, profile
    # imported here: the step's module builds on this one's TrainState
    from atomo_tpu_torch.parallel.overlap import gather_carry
    from atomo_tpu_torch.parallel.replicated import (
        gather_ring,
        make_distributed_eval_step,
        make_distributed_train_step,
        make_phased_step,
        shard_batch,
        shard_superbatch,
    )
    from atomo_tpu_torch.training.resilience import (
        DivergenceDoctor,
        RecoveryRig,
        heartbeat_watchdog,
        resolve_chaos,
        retrying_saver,
    )

    _check_loop_modes(codec, aggregate, overlap, stream_encode, error_feedback)
    _check_loop_partition(partition, overlap=overlap, resume=resume,
                          error_feedback=error_feedback, phase_metrics=phase_metrics,
                          diverge=diverge, hybrid=hybrid)
    if phase_metrics and overlap == "delayed":
        raise ValueError(
            "--phase-metrics times blocking phase programs and cannot "
            "describe the overlapped step; drop one of the flags"
            + PHASE_METRICS_HINT)
    if error_feedback and phase_metrics:
        raise ValueError(
            "--error-feedback needs the fused step (the residual "
            "rides its carry); --phase-metrics has no fused step"
            + PHASE_METRICS_HINT)
    if budget_tuner is not None:
        if diverge is not None:
            raise ValueError(
                "--budget-alloc variance online re-allocation does not "
                "compose with --on-diverge: a rollback would replay "
                "pre-reallocation steps under the post-reallocation "
                "program — freeze the allocation (drop --obs-record or "
                "--obs-quality) or drop --on-diverge")
        # the recorder is rank 0's (the others read what it writes)
        has_recorder = recorder is not None or (torch.distributed.is_initialized()
                                                and torch.distributed.get_rank() != 0)
        if not (track_quality and has_recorder and train_dir):
            raise ValueError(
                "budget_tuner needs its signal on disk: --obs-quality + "
                "--obs-record + a --train-dir (the recorded q_err2 "
                "series is what the boundary re-solve folds)")
        if not save_freq:
            raise ValueError(
                "budget_tuner re-allocates at checkpoint boundaries and "
                "needs a save cadence (--save-freq or --eval-freq > 0)")
    if track_quality and phase_metrics:
        raise ValueError(
            "--obs-quality probes the fused step's encode in-graph; "
            "--phase-metrics has no fused step — drop one"
            + PHASE_METRICS_HINT)
    if stream_encode and phase_metrics:
        raise ValueError(
            "--phase-metrics times a monolithic encode phase program "
            "and cannot describe the bucket-streamed schedule; drop "
            "one of the flags"
            + PHASE_METRICS_HINT)
    if error_feedback and guard is not None:
        raise ValueError(
            "--error-feedback does not compose with --grad-guard / "
            "--elastic: skip-and-rescale rests on the unbiasedness "
            "EF trades away")
    if error_feedback and diverge is not None:
        raise ValueError(
            "--error-feedback does not compose with --on-diverge: "
            "the rollback reload does not rebuild the residual "
            "template yet — drop one")
    _check_diverge(diverge, train_dir=train_dir, codec=codec, save_freq=save_freq,
                   keep_ckpts=keep_ckpts, aggregate=aggregate, overlap=overlap,
                   num_aggregate=num_aggregate, phase_metrics=phase_metrics,
                   zero1=partition == "zero1")
    if quorum is not None:
        _check_loop_quorum(codec, aggregate, overlap=overlap, hybrid=hybrid,
                           partition=partition, error_feedback=error_feedback,
                           phase_metrics=phase_metrics, superstep=superstep, diverge=diverge,
                           num_aggregate=num_aggregate, stream_encode=stream_encode,
                           track_quality=track_quality, budget_tuner=budget_tuner)
    elif quorum_replay:
        raise ValueError(
            "--replay-arrivals replays a recorded quorum schedule and "
            "needs --quorum (with the recorded Q/K — the rig refuses a "
            "mismatch)")
    chaos = resolve_chaos(chaos)
    if phase_metrics:
        _check_phase_metrics(superstep, guard, chaos, grad_accum, hybrid, num_aggregate, codec,
                             aggregate, zero1=partition == "zero1")
    if chaos is not None:
        chaos.maybe_die_crashloop()
    dev = resolve_device(device)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    if aggregate == "hierarchical" and (mesh is None or not mesh.spec.is_two_tier):
        raise ValueError("aggregate='hierarchical' runs over the group's two-tier mesh: pass "
                         "mesh=MeshSpec.from_world(N, K).build() (K > 1)")
    if quorum is not None and world < 2:
        raise ValueError(
            "--quorum needs a multi-replica mesh: with one replica "
            "there is nobody to be late (use --n-devices >= 2 or a "
            "forced multi-device CPU mesh)")
    quiet = log_fn if rank == 0 else (lambda _: None)
    part = None  # the partition's flat layout (mesh.update), None when replicated
    if partition == "replicated":
        state = _start_replica(model, optimizer, seed, dev, codec, overlap, error_feedback,
                               rank, world, resume=resume, train_dir=train_dir, log_fn=quiet,
                               quorum=quorum)
    else:
        state, part = _start_partition(model, optimizer, seed, dev, codec, overlap, partition,
                                       resume=resume, train_dir=train_dir, log_fn=quiet)
    sharded = partition == "sharded-update"
    master = state.master if sharded else None  # updated in place for the whole run
    start_step = state.step
    incidents = (_incidents(train_dir, diverge is not None or quorum is not None)
                 if rank == 0 else None)
    qrig = None
    if quorum is not None:
        from atomo_tpu_torch.quorum.rig import QuorumRig

        # every rank derives (or replays) the same vectors and sleeps the
        # same waits; rank 0 alone writes the schedule and the incidents
        qrig = QuorumRig(quorum, n_dev=world, train_dir=train_dir, chaos=chaos,
                         incidents=incidents, replay_path=quorum_replay, log_fn=quiet,
                         write=rank == 0)
        qrig.prune_past(start_step)  # a resume re-records the steps above its checkpoint

    # the budget retuner may re-allocate the per-leaf knobs mid-run: every
    # (re)build reads the codec in effect from this cell
    codec_cell = {"codec": codec}

    def build_step(generation=0, remedy_cfg=None, densify=False):
        chaos_now = chaos.with_generation(generation) if chaos is not None and generation \
            else chaos
        codec = codec_cell["codec"]
        return make_distributed_train_step(
            model, optimizer, None if densify else codec,
            aggregate="psum" if densify else aggregate, augment=augment,
            num_aggregate=0 if densify else num_aggregate, ring_bucket_size=ring_bucket_size,
            compute_dtype=compute_dtype, grad_accum=grad_accum, hybrid=hybrid,
            error_feedback=error_feedback, superstep=superstep, overlap=overlap,
            stream_encode=stream_encode and not densify,
            stream_bucket_bytes=stream_bucket_bytes, guard=guard, chaos=chaos_now,
            remedy=remedy_cfg, track_grad_norm=diverge is not None,
            track_quality=track_quality and not densify,
            zero1=part if partition == "zero1" else None,
            sharded_update=part if sharded else None, quorum=quorum, plan=plan,
            **({"mesh": mesh, "inner_axis": mesh.spec.inner_axis}
               if aggregate == "hierarchical" else {}))

    recorder = recorder if rank == 0 else None
    _arm_recorder(recorder, track_quality, codec, model, start_step, aggregate=aggregate,
                  hybrid=hybrid, stream_bucket_bytes=stream_bucket_bytes if stream_encode else None)
    if phase_metrics:
        step_fn = make_phased_step(model, optimizer, codec, augment=augment,
                                   compute_dtype=compute_dtype)
    else:
        step_fn = build_step()
    eval_fn = make_distributed_eval_step(model)
    prof_dir = profile_dir if rank == 0 else None  # rank 0 alone traces and writes
    key = seed + 1
    timer = Timer()
    rng_snapshot = train_iter.snapshot_rng() if diverge is not None else None
    stream = train_iter.forever(skip=start_step)
    n_train = len(train_iter.dataset)
    saver = retrying_saver(quiet, incidents)

    def save(st: TrainState, step: int):
        saved = st
        if error_feedback:  # every rank's residual, in rank order, to rank 0
            saved = dataclasses.replace(st, residual=gather_residual(st, world))
        if overlap == "delayed":  # every rank's in-flight payload, likewise
            saved = dataclasses.replace(saved, carry=gather_carry(st.carry, world))
        if quorum is not None:  # every rank's staleness ring, likewise
            saved = dataclasses.replace(saved, ring=gather_ring(st.ring, world))
        if part is not None:  # every rank's slices as full flat vectors
            saved = _gathered_partition(saved, part)
        path = None
        if rank == 0:
            path = saver(train_dir, saved, step, compress=compress_ckpt, keep=keep_ckpts)
        torch.distributed.barrier()  # no rank goes on before the file is in place
        return path

    def validate(step: int) -> None:
        if master is not None:  # the parameters, from every rank's master
            part.materialize(master)
        totals = {"loss": 0.0, "prec1": 0.0, "prec5": 0.0}
        n = 0
        for ti, tl in test_iter.epoch():
            trim = (ti.shape[0] // world) * world
            if trim == 0:
                continue
            m = eval_fn(*to_device(*shard_batch(ti[:trim], tl[:trim], rank, world), dev))
            for k in totals:
                totals[k] += float(m[k]) * trim
            n += trim
        if rank == 0:
            log_fn("Validation: Step: {}, Loss: {:.4f}, Prec@1: {:.4f}, Prec@5: {:.4f}"
                   .format(step, *(totals[k] / max(n, 1) for k in ("loss", "prec1",
                                                                    "prec5"))))

    rig = None
    if diverge is not None:
        def _reload(target):
            return _start_replica(model, optimizer, seed, dev, codec, overlap, False, rank,
                                  world, load_step=target if target > 0 else None,
                                  train_dir=train_dir, log_fn=quiet)

        # every rank plans alike from the same series; rank 0 alone tags and prunes
        rig = RecoveryRig(
            DivergenceDoctor(diverge, train_dir, incidents, quiet, owner=rank == 0),
            diverge, _reload, lambda target: train_iter.restream(rng_snapshot, skip=target),
            build_step)

    def dropped_line(step, n_drop, n_skip, where):
        action = "skip" if n_skip > 0 else "rescale"
        return f"Guard: Step: {step}, Dropped: {int(n_drop)}, Action: {action} ({where})"

    retune = None
    if budget_tuner is not None:
        budget_tuner.bind(incidents=_incidents(train_dir, True) if rank == 0 else None,
                          recorder=recorder, log_fn=quiet)

        def retune(step):
            """The checkpoint-boundary re-solve: a rebuilt step when the
            allocation changed (the payload shapes with it), else None."""
            new_codec = budget_tuner.maybe_realloc(step)
            if new_codec is None:
                return None
            codec_cell["codec"] = new_codec
            return build_step()

    if superstep > 1:
        def guard_line(s, kb, m):
            n_drop = float(np.sum(m.get("dropped", 0.0)))
            if n_drop <= 0:
                return None
            return dropped_line(s, n_drop, float(np.sum(m.get("skipped", 0.0))),
                                "anomalous contributions masked inside the superstep")

        with heartbeat_watchdog(health_timeout * superstep, on_health_failure) as monitor:
            state = _superstep_steps(
                state, step_fn, key, stream,
                lambda x, y: block_to_device(*shard_superbatch(x, y, rank, world), dev),
                train_iter=train_iter, n_train=n_train, start_step=start_step,
                max_steps=max_steps, superstep=superstep, log_every=log_every,
                log_fn=quiet, eval_freq=eval_freq,
                evaluate_fn=validate if test_iter is not None else None, save_freq=save_freq,
                train_dir=train_dir, save_fn=save, timer=timer, monitor=monitor, chaos=chaos,
                rig=rig, guard_line=guard_line if guard is not None else None, world=world,
                before_recover=torch.distributed.barrier, recorder=recorder,
                profile_dir=prof_dir, device=dev, retune=retune)
        if master is not None:  # the returned model holds the trained parameters
            part.materialize(master)
        return state
    last_saved = start_step
    # trace steady-state steps only: step 1 pays the first-call costs
    prof_first = start_step + 2 if prof_dir else None
    prof_ctx = None
    with heartbeat_watchdog(health_timeout, on_health_failure) as monitor:
        step = start_step
        t_rec = time.perf_counter()  # the recorder's wall anchor
        while step < max_steps:
            step += 1
            # the rig owns the straggler wait: the blocking sleep stands down
            _host_faults(chaos, step - 1, step, 0 if qrig is not None else world)
            if prof_first is not None and step == prof_first:
                prof_ctx = profile(prof_dir, device=dev)
                prof_ctx.__enter__()
                quiet(f"Profiling steps {step}..{step + profile_steps - 1} -> {prof_dir}")
                if recorder is not None:
                    # the artifact-side join key for `report timeline`
                    recorder.write_meta({"what": "profile_window", "first_step": step,
                                         "last_step": step + profile_steps - 1,
                                         "profile_dir": prof_dir})
            images, labels = shard_batch(*next(stream), rank, world)
            # the rig decides (or replays) this step's staleness vector,
            # sleeps its exposed wait and records it; the step consumes it
            extra = () if qrig is None else (qrig.begin_step(step),)
            out = step_fn(state, key, *to_device(images, labels, dev), *extra)
            state, metrics = out[0], out[1]
            phases = out[2] if len(out) > 2 else None
            if monitor is not None:
                float(metrics["loss"])
                monitor.beat(step)
            host = None
            if recorder is not None:
                host = fetch_metrics(metrics)
                now_r = time.perf_counter()
                recorder.record_block(step, host, wall_s=now_r - t_rec,
                                      generation=rig.doctor.generation if rig else None)
                t_rec = now_r
            if prof_ctx is not None and step >= prof_first + profile_steps - 1:
                prof_ctx.__exit__(None, None, None)
                prof_ctx = None
            if rig is not None:
                alarm_step, reason = rig.observe(
                    step, host if host is not None else fetch_metrics(metrics, DOCTOR_SERIES))
                if reason is not None:
                    if prof_ctx is not None:  # close the trace before the timeline jumps
                        prof_ctx.__exit__(None, None, None)
                        prof_ctx = None
                    prof_first = None  # the replayed window is not traced twice
                    torch.distributed.barrier()
                    state, stream, step_fn, chaos, step = rig.recover(alarm_step, reason, chaos)
                    last_saved = min(last_saved, step)
                    t_rec = time.perf_counter()
                    continue
                new_fn = rig.maybe_end_densify(step)
                if new_fn is not None:
                    step_fn = new_fn
            if guard is not None and log_every and step % log_every == 0:
                g = fetch_metrics(metrics, ("dropped", "skipped"))
                if g.get("dropped", 0.0) > 0:
                    quiet(dropped_line(step, g["dropped"], g.get("skipped", 0.0),
                                       "anomalous contribution masked from the aggregate"))
            if log_every and step % log_every == 0:
                loss = float(metrics["loss"])  # every rank waits for its step here
                if rank == 0:
                    emit_worker_line(recorder, StepMetrics(
                        rank=0,
                        step=step,
                        epoch=step * train_iter.batch_size // max(n_train, 1),
                        samples_seen=(step * train_iter.batch_size) % max(n_train, 1),
                        dataset_size=n_train,
                        loss=loss,
                        time_cost=timer.lap(),
                        comp_dur=phases["comp"] if phases else 0.0,
                        encode_dur=phases["encode"] if phases else 0.0,
                        comm_dur=phases["gather"] if phases else 0.0,
                        msg_bytes=int(metrics["msg_bytes"]),
                        prec1=float(metrics["prec1"]),
                        prec5=float(metrics["prec5"]),
                    ), log_fn)
                    if phases:
                        log_fn(master_line(step, phases["decode"],
                                           float(lr_fn(step)) if lr_fn is not None else 0.0,
                                           phases["gather"]))
            if eval_freq and test_iter is not None and step % eval_freq == 0:
                validate(step)
            if save_freq and train_dir and step % save_freq == 0:
                path = save(state, step)
                last_saved = step
                if rig is not None:
                    rig.note_save(step)
                if chaos is not None and path is not None:
                    chaos.maybe_corrupt_checkpoint(path, step)
                if retune is not None:
                    # the re-solve snaps to the checkpoint just written, so a
                    # resume from it replays the new epoch exactly
                    new_fn = retune(step)
                    if new_fn is not None:
                        step_fn = new_fn
            t_rec = time.perf_counter()  # boundary work is not step time
        if prof_ctx is not None:  # a window cut short by max_steps
            prof_ctx.__exit__(None, None, None)
        if save_freq and train_dir and last_saved < max_steps:
            path = save(state, max_steps)
            if rig is not None:
                rig.note_save(max_steps)
            if chaos is not None and path is not None:
                chaos.maybe_corrupt_checkpoint(path, max_steps)
    if master is not None:  # the returned model holds the trained parameters
        part.materialize(master)
    return state


PARTITIONS = ("replicated", "zero1", "sharded-update")


def _check_loop_partition(partition: str, *, overlap: str, resume: bool, error_feedback: bool,
                          phase_metrics: bool, diverge, hybrid) -> None:
    """The JAX loop's refusals of ``zero1`` and ``sharded_update``
    (``atomo_tpu/parallel/replicated.py:2993-2999,3036-3040,3154-3183``),
    text for text."""
    from atomo_tpu_torch.utils.tracing import PHASE_METRICS_HINT

    if partition not in PARTITIONS:
        raise ValueError(f"unknown partition {partition!r}; expected one of "
                         f"{'|'.join(PARTITIONS)}")
    if overlap == "delayed" and partition == "zero1" and resume:
        raise ValueError(
            "--overlap delayed cannot resume a --zero1 run (the "
            "legacy sharded optimizer template cannot carry the "
            "overlap payload); drop --resume or --zero1 — or use "
            "--partition sharded-update, whose checkpoints hold the "
            "in-flight payload as a sharded carry leaf and resume "
            "bit-exact")
    if error_feedback and partition != "replicated":
        raise ValueError(
            "--error-feedback does not compose with --zero1 / "
            "--partition sharded-update yet: the residual carry is "
            "untested against the sharded state templates")
    if partition != "sharded-update":
        return
    if phase_metrics:
        raise ValueError(
            "--partition sharded-update is not supported with "
            "--phase-metrics (the phased update program assumes a "
            "replicated optimizer state)" + PHASE_METRICS_HINT)
    if diverge is not None:
        raise ValueError(
            "--on-diverge rollback rebuilds replicated templates and "
            "cannot re-thread the sharded master layout yet; drop "
            "--partition sharded-update or --on-diverge")
    if hybrid is not None:
        raise ValueError(
            "--partition sharded-update does not compose with "
            "--sparse-rows yet (the row exchange is untested against "
            "the flat master layout)")


def _gathered_partition(state, part):
    """``state`` with every rank's optimizer slices (and the sharded
    update's masters) as full flat CPU vectors: the checkpoint form.
    Collective over the group."""
    from atomo_tpu_torch.mesh.update import gather_host

    host = gather_host(state, part)
    opt = dataclasses.replace(state.opt_state, **{
        k: v for k, v in host["opt"].items() if isinstance(v, list)})
    out = dataclasses.replace(state, opt_state=opt)
    if "master" in host:
        out = dataclasses.replace(out, master=host["master"])
    return out


def _flat_layout_matches(saved_opt: dict, template, part) -> bool:
    """Whether a checkpoint's optimizer fields are this run's flat layout:
    the same fields, each buffer list one full ``(N * chunk,)`` vector."""
    names = [f.name for f in dataclasses.fields(template)]
    if sorted(saved_opt) != sorted(names):
        return False
    for name in names:
        want, got = getattr(template, name), saved_opt[name]
        if isinstance(want, list) or isinstance(got, list):
            if not (isinstance(want, list) and isinstance(got, list) and len(got) == len(want)
                    and all(g.numel() == part.n_shards * part.chunk for g in got)):
                return False
    return True


@torch.no_grad()
def _start_partition(model, optimizer, seed: int, dev, codec, overlap: str, partition: str, *,
                     resume: bool = False, train_dir=None, log_fn=print):
    """This rank's partitioned state and the run's flat layout: the seeded
    init broadcast from rank 0, partitioned (:mod:`atomo_tpu_torch.mesh.
    update`), then with ``resume`` the newest valid checkpoint of
    ``train_dir`` as the JAX loop restores it (``atomo_tpu/parallel/
    replicated.py:3294-3480``) and the delayed carry set up."""
    from atomo_tpu_torch.mesh import update as U
    from atomo_tpu_torch.parallel.overlap import carry_from_saved
    from atomo_tpu_torch.parallel.replicated import init_delayed_state, replicate_state
    from atomo_tpu_torch.training.checkpoint import read_checkpoint

    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    state = replicate_state(create_state(model, optimizer, seed, dev))
    d = None
    if resume and train_dir and latest_step(train_dir) is not None:
        try:
            d = read_checkpoint(train_dir)
        except FileNotFoundError as exc:
            log_fn(f"Resume requested but {exc}; starting fresh")
    saved_carry = None
    if partition == "sharded-update":
        if d is not None and "master" not in d:
            # a replicated (or ZeRO-1) checkpoint: its parameters carry over
            warnings.warn(
                "--partition sharded-update resume: checkpoint "
                "layout does not match (it holds per-leaf params, not a "
                "master vector); restoring params only, optimizer state "
                "re-initialized sharded")
            model.load_state_dict(d["model"])
            state = dataclasses.replace(state, step=int(d["step"]))
            state, part = U.sharded_state_from_params(state, optimizer)
        else:
            state, part = U.sharded_update_state(state, optimizer)
            if d is not None:
                want = (part.n_shards * part.chunk,)
                if tuple(d["master"].shape) != want:
                    raise ValueError(
                        "--partition sharded-update resume: checkpoint master "
                        f"vector has shape {tuple(d['master'].shape)} but this "
                        f"model/mesh expects {want} — the mesh shape changed; "
                        "re-shard via mesh.reshard or restart without "
                        "--resume")
                if not _flat_layout_matches(d["opt_state"], state.opt_state, part):
                    raise ValueError(
                        f"the checkpoint's optimizer state has {sorted(d['opt_state'])}, "
                        "not this optimizer's flat layout: resume with the optimizer it "
                        "was written with")
                named = dict(model.named_buffers())
                for k, v in d["buffers"].items():
                    named[k].copy_(v)
                state = U.place_sharded_update(state, {"step": d["step"], "master": d["master"],
                                                       "opt": d["opt_state"]}, part)
                saved_carry = d.get("overlap_carry")
                if (saved_carry is None) != (overlap != "delayed"):
                    why = ("no overlap_carry in the checkpoint" if saved_carry is None
                           else "the checkpoint holds an overlap_carry, this run is blocking")
                    warnings.warn(
                        "--partition sharded-update resume: checkpoint "
                        f"overlap-carry layout does not match ({why}); "
                        "restoring the sharded train state only — any "
                        "in-flight payload is discarded (a delayed "
                        "resume re-skips its first step)")
                    saved_carry = None
    else:
        if d is not None and "model" not in d:
            raise ValueError(
                "--zero1 resume: the checkpoint was written by --partition "
                "sharded-update (a master vector, no per-leaf params); resume it "
                "with --partition sharded-update")
        if d is not None:
            model.load_state_dict(d["model"])
        state, part = U.zero1_state(state, optimizer)
        if d is not None:
            if _flat_layout_matches(d["opt_state"], state.opt_state, part):
                state = U.place_sharded_update(state, {"step": d["step"], "opt": d["opt_state"]},
                                               part)
            else:
                # a replicated checkpoint (or a ZeRO-1 one of another world)
                warnings.warn(
                    "--zero1 resume: checkpoint optimizer layout does not "
                    "match this mesh's zero1 layout; params restored, "
                    "optimizer state re-initialized sharded")
                state = dataclasses.replace(state, step=int(d["step"]))
    if d is not None:
        log_fn(f"Resumed from {train_dir} at step {state.step}")
    if overlap == "delayed":
        state = init_delayed_state(state, codec)
        if state.step > 0:  # resumed: the payload that the next step consumes
            carry, _ = carry_from_saved(state.carry, saved_carry, rank, world)
            state = dataclasses.replace(state, carry=carry)
    return state, part


def _check_phase_metrics(superstep: int, guard, chaos, grad_accum: int, hybrid,
                         num_aggregate: int, codec, aggregate: str, zero1: bool = False) -> None:
    """The JAX loop's refusals and warnings of ``phase_metrics``
    (``atomo_tpu/parallel/replicated.py:3677-3720``), text for text."""
    from atomo_tpu_torch.utils.tracing import PHASE_METRICS_HINT

    if superstep > 1:
        raise ValueError(
            "--phase-metrics times individual phase programs and cannot "
            "run under a fused superstep scan; drop --phase-metrics or "
            "use --superstep 1"
            + PHASE_METRICS_HINT)
    if guard is not None or chaos is not None:
        raise ValueError(
            "--phase-metrics is an observability mode without the "
            "anomaly-guard/chaos hooks; drop --phase-metrics to use "
            "--grad-guard / --chaos")
    if zero1:
        raise ValueError(
            "--zero1 is not supported with --phase-metrics (the phased "
            "update program assumes a replicated optimizer state)")
    if grad_accum > 1:
        raise ValueError(
            "--grad-accum is not supported with --phase-metrics (the "
            "phase split assumes one fused compute program)")
    if hybrid is not None:
        raise ValueError(
            "--sparse-rows is not supported with --phase-metrics "
            "(the phased programs assume one whole-tree codec "
            "exchange; there is no row-aware phase split)"
            + PHASE_METRICS_HINT)
    if num_aggregate:
        warnings.warn("--phase-metrics uses full aggregation; ignoring --num-aggregate")
    if codec is not None and aggregate != "gather":
        warnings.warn(
            "--phase-metrics always uses gather aggregation (its phase "
            "split is gather/decode); ignoring --aggregate "
            f"{aggregate!r} — drop --phase-metrics to time the psum path")


def _check_loop_quorum(codec, aggregate: str, *, overlap: str, hybrid, partition: str,
                       error_feedback: bool, phase_metrics: bool, superstep: int, diverge,
                       num_aggregate: int, stream_encode: bool, track_quality: bool,
                       budget_tuner) -> None:
    """The JAX loop's quorum refusals (``atomo_tpu/parallel/replicated.py:
    3185-3290``) for the knobs the port's loop has (the multi-replica check
    waits for the group's size)."""
    from atomo_tpu_torch.utils.tracing import PHASE_METRICS_HINT

    if codec is None or aggregate not in ("gather", "ring"):
        raise ValueError(
            "--quorum needs a compressing codec with --aggregate "
            "gather or ring: the staleness ring carries ENCODED "
            "payloads — dense psum has no payload to carry, and the "
            "hierarchical boundary re-encode is not staleness-aware")
    if overlap == "delayed":
        raise ValueError(
            "--quorum does not compose with --overlap delayed: the "
            "staleness ring GENERALIZES the stale-by-one carry "
            "(quorum with K>=1 already consumes stale payloads); "
            "stacking both would apply staleness twice")
    if hybrid is not None:
        raise ValueError(
            "--quorum does not compose with --sparse-rows: the "
            "staleness ring's slots are codec-payload-shaped and "
            "the row exchange is not ring-carry-aware yet")
    if partition != "replicated":
        raise ValueError(
            "--quorum does not compose with --partition "
            "sharded-update / --zero1 yet: the staleness ring is "
            "untested against the sharded state templates — run "
            "the replicated update")
    if error_feedback:
        raise ValueError(
            "--quorum does not compose with --error-feedback: a "
            "dropped-or-stale payload would orphan its residual "
            "and the telescoping bound no longer holds")
    if phase_metrics:
        raise ValueError(
            "--quorum needs the fused step (the staleness ring "
            "rides its carry); --phase-metrics has no fused step"
            + PHASE_METRICS_HINT)
    if superstep > 1:
        raise ValueError(
            "--quorum needs --superstep 1: the host rig feeds each "
            "step's arrival vector at dispatch time, and a fused "
            "K-step scan has no per-step host boundary")
    if diverge is not None:
        raise ValueError(
            "--quorum does not compose with --on-diverge: the "
            "rollback replay does not rewind the arrival schedule "
            "or the staleness ring template yet — drop one")
    if num_aggregate:
        raise ValueError(
            "--quorum does not compose with --num-aggregate: the "
            "arrival schedule already decides which replicas "
            "contribute each step — a second rotating subset "
            "would double-select")
    if stream_encode:
        raise ValueError(
            "--quorum does not compose with --stream-encode yet: "
            "the layer-bucket encode pipeline is not "
            "ring-carry-aware")
    if track_quality:
        raise ValueError(
            "--quorum does not compose with --obs-quality: the "
            "per-layer probe describes THIS step's encode while "
            "the consumed payloads may be stale — mis-attribution, "
            "rejected honestly")
    if budget_tuner is not None:
        raise ValueError(
            "--quorum does not compose with the online budget "
            "re-allocation: a mid-run codec swap would change the "
            "ring's payload shapes under carried stale slots — "
            "freeze the allocation or drop --quorum")


def _start_replica(model, optimizer, seed: int, dev, codec, overlap: str, error_feedback: bool,
                   rank: int, world: int, *, resume: bool = False, load_step=None,
                   train_dir=None, log_fn=print, quorum=None) -> TrainState:
    """This rank's replica: the seeded init broadcast from rank 0, then (with
    ``resume``) the newest valid checkpoint of ``train_dir``, or (with
    ``load_step``) that step's, with the error-feedback residual, the
    delayed carry and the quorum ring taken apart as the run needs them."""
    from atomo_tpu_torch.parallel.overlap import carry_from_saved
    from atomo_tpu_torch.parallel.replicated import (
        init_delayed_state,
        init_quorum_state,
        replicate_state,
        ring_from_saved,
    )

    state = replicate_state(create_state(model, optimizer, seed, dev))
    if load_step is not None:
        state = load_checkpoint(train_dir, state, step=load_step)
    else:
        state = _resume(state, train_dir, resume, log_fn)
    start_step = state.step
    if error_feedback:
        state = own_residual(state, model, rank, world, dev)
    saved_carry, state = state.carry, dataclasses.replace(state, carry=None)
    saved_ring, state = state.ring, dataclasses.replace(state, ring=None)
    if quorum is not None:
        state = init_quorum_state(state, codec, quorum.staleness)
        if start_step > 0:  # resumed: the ring the steps above start_step select from
            ring, why = ring_from_saved(state.ring, saved_ring, rank, world)
            if why is not None:
                warnings.warn(
                    "--quorum resume: checkpoint has no matching "
                    f"staleness ring ({why}); restoring the train state "
                    "only — the resumed steps warm the ring up from "
                    "empty (recorded K must match to resume the ring)")
            state = dataclasses.replace(state, ring=ring)
    if overlap == "delayed":
        state = init_delayed_state(state, codec)
        if start_step > 0:  # resumed: the payload that step start_step + 1 consumes
            carry, why = carry_from_saved(state.carry, saved_carry, rank, world)
            if why is not None:
                warnings.warn(
                    "--overlap delayed resume: checkpoint has no overlap "
                    f"carry ({why}); restoring the train state only — the "
                    "first resumed step applies a zero (skipped) update")
            state = dataclasses.replace(state, carry=carry)
    elif saved_carry is not None:
        warnings.warn(
            "resume: checkpoint was written by --overlap delayed "
            "(it holds an overlap_carry); restoring its train state and discarding "
            "the in-flight payload — pass --overlap delayed to "
            "resume the overlapped run exactly")
    return state
