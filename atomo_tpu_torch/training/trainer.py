"""Trainers: one device with the codec in the loop, and the data-parallel loop.

Counterpart of ``atomo_tpu/training/trainer.py`` ("compression on, comm
off"): each step runs forward and backward, encodes the gradient list with
the codec, decodes it again, and applies the momentum-SGD update, so a
single card does exactly the work of one worker of the compressed
data-parallel path. :func:`distributed_train_loop` is the counterpart of
``atomo_tpu/parallel/replicated.py:2749 distributed_train_loop``, its flat
blocking core: one process per device, the step of
:mod:`atomo_tpu_torch.parallel.replicated`. Guard, chaos, superstep,
doctor, recorder and tuner are not ported yet.

The phases of a step are ``torch.profiler.record_function`` ranges
(``step.forward_backward``, ``step.encode``, ``step.decode``,
``step.update``), so a profiler trace splits the step's time by phase.

PyTorch idiom: the model is an ``nn.Module`` updated in place (its
parameters and BatchNorm statistics); :class:`TrainState` carries it with the
step counter and the optimizer state. Random streams follow the JAX step:
the step key is ``fold_in(key, step)`` split three ways (augmentation,
dropout, codec), with integer keys (:mod:`atomo_tpu_torch.utils.rng`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from atomo_tpu_torch.codecs import decode_tree, encode_tree
from atomo_tpu_torch.convert import jax_leaf_order
from atomo_tpu_torch.data.pipeline import augment_batch, to_device
from atomo_tpu_torch.models.resnet import BatchNorm
from atomo_tpu_torch.models.transformer import LayerNorm
from atomo_tpu_torch.training.optim import Sgd, SgdState
from atomo_tpu_torch.utils.device import resolve_device
from atomo_tpu_torch.utils.metrics import StepMetrics, Timer, accuracy
from atomo_tpu_torch.utils.rng import fold_in, generator, split3


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: SgdState


def leaf_params(model: nn.Module) -> list[torch.Tensor]:
    """The model's parameters in the canonical (JAX flatten) order."""
    named = dict(model.named_parameters())
    return [named[n] for n in jax_leaf_order(model)]


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> None:
    """Flax's default initialisers, drawn from one ``torch.Generator``:
    kernels LeCun-normal (truncated at 2 sigma, fan-in of the HWIO/(in, out)
    kernel), biases zero, BatchNorm scale 1, bias 0, mean 0, var 1;
    embeddings normal with variance 1/features (``nn.Embed``'s
    ``variance_scaling(1, fan_in, normal, out_axis=0)``), LayerNorm scale 1."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # 0.8796... = std of a unit normal truncated at +-2
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
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


def create_state(model: nn.Module, optimizer: Sgd, seed: int, device) -> TrainState:
    init_params(model, seed)
    model.to(device)
    return TrainState(step=0, model=model, opt_state=optimizer.init(leaf_params(model)))


def make_train_step(model: nn.Module, optimizer: Sgd, codec=None, augment: bool = False):
    """Build the step ``(state, key, images, labels, uniforms=None) ->
    (state, metrics)`` over ``model`` (which ``state.model`` must be).

    ``images`` is an (N, C, H, W) float32 batch and ``labels`` int64, both on
    the model's device. ``uniforms`` (one (n_buckets, bucket_size) tensor per
    leaf, canonical order) feeds the codec given stochastic-rounding
    uniforms: the test hook through which a parity run hands the port the
    uniforms the JAX step drew. ``metrics`` holds 0-d tensors (no host sync)
    and ``msg_bytes`` as an int."""
    params = leaf_params(model)

    def step(state: TrainState, key: int, images, labels,
             uniforms: Optional[Sequence[torch.Tensor]] = None):
        k_aug, _k_drop, k_codec = split3(fold_in(key, state.step))
        if augment:
            images = augment_batch(images, generator(k_aug, images.device))
        model.train()
        for p in params:
            p.grad = None
        with record_function("step.forward_backward"):
            logits = model(images)
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


def train_loop(
    model: nn.Module,
    optimizer: Sgd,
    train_iter,
    test_iter=None,
    *,
    codec=None,
    augment: bool = False,
    max_steps: int = 100,
    eval_freq: int = 0,
    seed: int = 0,
    log_fn=print,
    log_every: int = 1,
    device=None,
) -> TrainState:
    """The reference train-and-validate loop: ``Worker:`` lines every
    ``log_every`` steps, ``Validation:`` lines every ``eval_freq`` steps.
    Runs on CUDA unless ``device='cpu'``."""
    dev = resolve_device(device)
    state = create_state(model, optimizer, seed, dev)
    step_fn = make_train_step(model, optimizer, codec=codec, augment=augment)
    key = seed + 1
    timer = Timer()
    stream = train_iter.forever()
    n_train = len(train_iter.dataset)
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
    return state


def distributed_train_loop(
    model: nn.Module,
    optimizer: Sgd,
    train_iter,
    test_iter=None,
    *,
    codec=None,
    aggregate: str = "gather",
    augment: bool = False,
    num_aggregate: int = 0,
    ring_bucket_size: int = 65536,
    max_steps: int = 100,
    eval_freq: int = 0,
    seed: int = 0,
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
    over the ranks, each batch trimmed to a multiple of them). Runs on CUDA
    unless ``device='cpu'``."""
    # imported here: the step's module builds on this one's TrainState
    from atomo_tpu_torch.parallel.replicated import (
        make_distributed_eval_step,
        make_distributed_train_step,
        replicate_state,
        shard_batch,
    )

    dev = resolve_device(device)
    state = replicate_state(create_state(model, optimizer, seed, dev))
    step_fn = make_distributed_train_step(
        model, optimizer, codec, aggregate=aggregate, augment=augment,
        num_aggregate=num_aggregate, ring_bucket_size=ring_bucket_size)
    eval_fn = make_distributed_eval_step(model)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    key = seed + 1
    timer = Timer()
    stream = train_iter.forever()
    n_train = len(train_iter.dataset)
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
    return state
