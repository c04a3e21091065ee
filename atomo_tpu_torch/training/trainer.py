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
one bit for bit. Guard, chaos, superstep, doctor, recorder and tuner are not
ported yet.

Mixed precision (``compute_dtype=torch.bfloat16``, the CLI's ``--bf16``) is
the JAX package's (``cast_compute_inputs`` / ``cast_compute_outputs``):
forward and backward run on bfloat16 copies of the parameters and the
images; master parameters, optimizer state, gradients, loss and BatchNorm
statistics stay float32, so the codecs and the wire see float32 gradients.

The phases of a step are ``torch.profiler.record_function`` ranges
(``step.forward_backward``, ``step.encode``, ``step.decode``,
``step.update``), so a profiler trace splits the step's time by phase.

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
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from atomo_tpu_torch.codecs import decode_tree, encode_tree
from atomo_tpu_torch.convert import jax_leaf_order
from atomo_tpu_torch.data.pipeline import augment_batch, to_device
from atomo_tpu_torch.models.dropout import dropout_stream
from atomo_tpu_torch.models.resnet import BatchNorm
from atomo_tpu_torch.models.transformer import LayerNorm
from atomo_tpu_torch.training.checkpoint import latest_step, load_checkpoint, save_checkpoint
from atomo_tpu_torch.training.optim import Optimizer, OptState
from atomo_tpu_torch.utils.device import resolve_device
from atomo_tpu_torch.utils.metrics import StepMetrics, Timer, accuracy
from atomo_tpu_torch.utils.rng import fold_in, generator, split3


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: OptState


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
    ``variance_scaling(1, fan_in, normal, out_axis=0)``), LayerNorm scale 1."""
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


def create_state(model: nn.Module, optimizer: Optimizer, seed: int, device) -> TrainState:
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


def make_train_step(model: nn.Module, optimizer: Optimizer, codec=None, augment: bool = False,
                    compute_dtype=None):
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
    an int."""
    params = leaf_params(model)

    def step(state: TrainState, key: int, images, labels,
             uniforms: Optional[Sequence[torch.Tensor]] = None,
             dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        k_aug, k_drop, k_codec = split3(fold_in(key, state.step))
        if augment:
            images = augment_batch(images, generator(k_aug, images.device))
        model.train()
        for p in params:
            p.grad = None
        with record_function("step.forward_backward"), dropout_stream(k_drop, dropout_masks):
            logits = forward(model, images, compute_dtype)
            loss = F.cross_entropy(logits, labels)
            loss.backward()
        grads = [p.grad for p in params]
        msg_bytes = 0
        if codec is not None:
            with record_function("step.encode"):
                payloads, stats = encode_tree(codec, k_codec, grads, uniforms)
            with record_function("step.decode"):
                grads = decode_tree(codec, payloads, grads)
            msg_bytes = stats.payload_bytes
        with record_function("step.update"):
            opt_state = optimizer.update(grads, state.opt_state, params)
        prec1, prec5 = accuracy(logits.detach(), labels)
        metrics = {"loss": loss.detach(), "prec1": prec1, "prec5": prec5,
                   "msg_bytes": msg_bytes}
        return TrainState(step=state.step + 1, model=model, opt_state=opt_state), metrics

    return step


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
) -> TrainState:
    """The reference train-and-validate loop: ``Worker:`` lines every
    ``log_every`` steps, ``Validation:`` lines every ``eval_freq`` steps, a
    checkpoint into ``train_dir`` every ``save_freq`` steps (keeping the
    newest ``keep_ckpts`` when > 0, lossless-compressed with
    ``compress_ckpt``) and of the final state when the last save came
    before ``max_steps``. ``resume`` continues from the newest valid
    checkpoint there: the data stream skips the batches already taken, so
    the run goes on as the interrupted one would have. Runs on CUDA unless
    ``device='cpu'``."""
    dev = resolve_device(device)
    state = _resume(create_state(model, optimizer, seed, dev), train_dir, resume, log_fn)
    start_step = state.step
    step_fn = make_train_step(model, optimizer, codec=codec, augment=augment,
                              compute_dtype=compute_dtype)
    key = seed + 1
    timer = Timer()
    stream = train_iter.forever(skip=start_step)
    n_train = len(train_iter.dataset)
    last_saved = start_step
    while state.step < max_steps:
        images, labels = to_device(*next(stream), dev)
        state, metrics = step_fn(state, key, images, labels)
        step = state.step
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
            log_fn(rec.worker_line())
        if eval_freq and test_iter is not None and step % eval_freq == 0:
            ev = evaluate(model, test_iter, dev)
            log_fn(
                "Validation: Step: {}, Loss: {:.4f}, Prec@1: {:.4f}, Prec@5: {:.4f}".format(
                    step, ev["loss"], ev["prec1"], ev["prec5"]
                )
            )
        if save_freq and train_dir and step % save_freq == 0:
            save_checkpoint(train_dir, state, step, compress=compress_ckpt, keep=keep_ckpts)
            last_saved = step
    # the final state, so that a restart never replays the tail (strictly
    # below: a resume past max_steps runs no step and writes nothing)
    if save_freq and train_dir and last_saved < max_steps:
        save_checkpoint(train_dir, state, max_steps, compress=compress_ckpt, keep=keep_ckpts)
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
    (:func:`~atomo_tpu_torch.parallel.replicated.make_distributed_train_step`).
    Runs on CUDA unless ``device='cpu'``."""
    # imported here: the step's module builds on this one's TrainState
    from atomo_tpu_torch.parallel.replicated import (
        make_distributed_eval_step,
        make_distributed_train_step,
        replicate_state,
        shard_batch,
    )

    dev = resolve_device(device)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    state = replicate_state(create_state(model, optimizer, seed, dev))
    state = _resume(state, train_dir, resume, log_fn if rank == 0 else (lambda _: None))
    start_step = state.step
    step_fn = make_distributed_train_step(
        model, optimizer, codec, aggregate=aggregate, augment=augment,
        num_aggregate=num_aggregate, ring_bucket_size=ring_bucket_size,
        compute_dtype=compute_dtype, grad_accum=grad_accum)
    eval_fn = make_distributed_eval_step(model)
    key = seed + 1
    timer = Timer()
    stream = train_iter.forever(skip=start_step)
    n_train = len(train_iter.dataset)
    last_saved = start_step

    def save(step: int) -> None:
        if rank == 0:
            save_checkpoint(train_dir, state, step, compress=compress_ckpt, keep=keep_ckpts)
        torch.distributed.barrier()  # no rank goes on before the file is in place

    while state.step < max_steps:
        images, labels = shard_batch(*next(stream), rank, world)
        state, metrics = step_fn(state, key, *to_device(images, labels, dev))
        step = state.step
        if log_every and step % log_every == 0:
            loss = float(metrics["loss"])  # every rank waits for its step here
            if rank == 0:
                log_fn(StepMetrics(
                    rank=0,
                    step=step,
                    epoch=step * train_iter.batch_size // max(n_train, 1),
                    samples_seen=(step * train_iter.batch_size) % max(n_train, 1),
                    dataset_size=n_train,
                    loss=loss,
                    time_cost=timer.lap(),
                    msg_bytes=int(metrics["msg_bytes"]),
                    prec1=float(metrics["prec1"]),
                    prec5=float(metrics["prec5"]),
                ).worker_line())
        if eval_freq and test_iter is not None and step % eval_freq == 0:
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
        if save_freq and train_dir and step % save_freq == 0:
            save(step)
            last_saved = step
    if save_freq and train_dir and last_saved < max_steps:
        save(max_steps)
    return state
