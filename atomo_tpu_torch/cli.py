"""Command line of the port: ``python -m atomo_tpu_torch train|evaluate|lm ...``.

Counterpart of the ``train``, ``evaluate`` and ``lm`` verbs of
``atomo_tpu/cli.py``, with the flags ported so far. The defaults are the JAX
package's. ``train`` trains any model of the registry (``--network``, case
blind: LeNet, FC, the ResNets, the VGGs, DenseNet, DenseNet100, AlexNet) on
one device, or data-parallel over N processes, one per device, as ``torchrun
--nproc-per-node N -m atomo_tpu_torch train --n-devices N ...`` starts them
(``--aggregate gather|ring|psum``, ``--num-aggregate``,
``--ring-bucket-size``, ``--grad-accum``), with the reference's optimizer and
schedule flags, the SVD knobs (``--svd-mode`` an alias over ``--svd-algo``),
CRC checkpoints into ``--train-dir`` (``--save-freq``, ``--resume``,
``--keep-ckpts``, ``--compress``) and ``--bf16``. ``--budget-alloc variance``
measures per-layer gradient spectra on a probe batch and spreads the wire
budget (``--budget-bytes``) over the layers to minimise the estimator's
variance (SVD ranks under ``--sample fixed_k``, QSGD bit widths 1-16), with
``budget_alloc.json`` reused on ``--resume``; ``--error-feedback`` carries
each replica's compression residual into its next encode. The reference's
parity flags ``--comm-type``, ``--enable-gpu`` and ``--no-cuda`` are taken
and ignored, with the JAX verb's warnings. ``--dataset zipf
--network embedding`` is the sparse workload (``--emb-rows``, ``--emb-dim``,
``--zipf-slots``, ``--zipf-alpha``), and ``--sparse-rows auto|on`` its
per-layer sparse-row exchange over the data-parallel step: the table leaf
moves as lossless rows, the others keep the codec. ``--n-devices 0`` (the
default) is the whole process group. A process group that is up (or a
``torchrun`` launch) takes even one process through the data-parallel step,
which is how one card runs ``--grad-accum`` and ``--error-feedback``.
``evaluate`` polls a checkpoint directory and prints the test metrics of
each new file. ``lm`` runs the layouts ``dp`` and ``dp-sp`` on one device or
over N processes (``--n-devices N --ways S``: dp = N/S replicas of S
sequence shards, ``--attn-impl ring|ulysses|ulysses-flash``, ``--aggregate
gather|psum|ring``), with ``--optimizer``, ``--bf16`` and checkpoints
(``--train-dir``, ``--save-freq``, ``--resume``, ``--compress``); the other
layouts come with later slices. Both verbs take ``--stream-encode`` (layer
buckets encoded under backward; ``train --stream-bucket-mb``, ``lm
--stream-bucket-bytes``) and ``--overlap delayed`` (the stale-by-one
exchange, its in-flight payload in the checkpoints), with the JAX verbs'
refusals.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from atomo_tpu_torch.budget import budgeted_codec
from atomo_tpu_torch.codecs import DenseCodec, get_codec
from atomo_tpu_torch.data import (
    SPECS,
    BatchIterator,
    canonical_name,
    load_dataset,
    synthetic_dataset,
    zipf_dataset,
)
from atomo_tpu_torch.models import embedding_tower, get_model
from atomo_tpu_torch.models.transformer import lm_loss
from atomo_tpu_torch.parallel import launch
from atomo_tpu_torch.parallel.lm import (
    LATER,
    DpExchange,
    create_lm_state,
    init_model_axis_delayed_state,
    make_lm_train_step,
    shard_tokens,
)
from atomo_tpu_torch.parallel.overlap import carry_from_saved, gather_carry
from atomo_tpu_torch.parallel.replicated import replicate_state
from atomo_tpu_torch.training import distributed_train_loop, make_optimizer, train_loop
from atomo_tpu_torch.training.checkpoint import latest_step, load_checkpoint, save_checkpoint
from atomo_tpu_torch.training.evaluator import CheckpointEvaluator
from atomo_tpu_torch.utils.rng import fold_in

DENSE_CODES = ("sgd", "dense", "none")
LM_LAYOUTS = ("dp", "dp-sp", "dp-tp", "dp-ep", "dp-pp", "dp-tp-sp")


def _svd_flags(p: argparse.ArgumentParser, rank_help: str) -> None:
    p.add_argument("--svd-rank", type=int, default=0, help=rank_help)
    p.add_argument("--sample", type=str, default="fixed_k",
                   choices=["fixed_k", "bernoulli_budget", "bernoulli", "topk"],
                   help="SVD atom sampling mode")
    p.add_argument("--svd-algo", type=str, default="auto",
                   choices=["auto", "exact", "gram", "randomized"],
                   help="auto = Halko sketch for large matrices, gram for small ones")
    p.add_argument("--svd-wire", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = stochastically rounded factors on the wire")


def _svd_algo(args: argparse.Namespace) -> str:
    """``--svd-algo``, or ``--svd-mode`` where that is pinned; both pinned
    to different algorithms is refused."""
    mode = args.svd_mode
    if mode == "auto":
        return args.svd_algo
    if args.svd_algo not in ("auto", mode):
        raise SystemExit(
            f"--svd-mode {mode} and --svd-algo {args.svd_algo} disagree "
            "(they select the same decomposition knob); pin one")
    return mode


def _model_flags(p: argparse.ArgumentParser) -> None:
    """The flags ``train`` and ``evaluate`` share: model, data, device."""
    p.add_argument("--network", type=str, default="LeNet")
    p.add_argument("--dataset", type=str, default="MNIST")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="force the synthetic dataset (offline runs)")
    p.add_argument("--data-root", type=str, default="./data")
    p.add_argument("--test-batch-size", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    p.add_argument("--train-dir", type=str, default="output/models/",
                   help="checkpoint directory (model_step_N files); '' = none")
    p.add_argument("--emb-rows", type=int, default=4096, metavar="R",
                   help="--network embedding: lookup-table rows (must match the "
                        "--dataset zipf id range; <= 2^24 so float32 batches carry "
                        "ids exactly)")
    p.add_argument("--emb-dim", type=int, default=16, metavar="D",
                   help="--network embedding: embedding dimension")
    p.add_argument("--zipf-slots", type=int, default=8, metavar="S",
                   help="--dataset zipf: lookups per sample (bounds the lossless row "
                        "budget: batch/chip x slots)")
    p.add_argument("--zipf-alpha", type=float, default=1.1, metavar="A",
                   help="--dataset zipf: power-law exponent of the row access "
                        "distribution (p_i ~ 1/i^A)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="atomo_tpu_torch",
        description="PyTorch/CUDA port of atomo_tpu (compressed data-parallel SGD)",
    )
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("train", help="train a model on one device or data-parallel")
    _model_flags(p)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--no-augment", action="store_true", default=False)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--lr-shrinkage", type=float, default=0.95)
    p.add_argument("--shrinkage-freq", type=int, default=50,
                   help="steps between lr shrinks (lr * lr-shrinkage each time)")
    p.add_argument("--optimizer", type=str, default="sgd", choices=["sgd", "adam"])
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--nesterov", action="store_true", default=False)
    p.add_argument("--adam-beta1", type=float, default=0.9)
    p.add_argument("--adam-beta2", type=float, default=0.999)
    p.add_argument("--adam-eps", type=float, default=1e-8)
    p.add_argument("--amsgrad", action="store_true", default=False,
                   help="AMSGrad: the running max of the bias-corrected second moment")
    p.add_argument("--save-freq", type=int, default=0,
                   help="checkpoint every N steps (0 = at --eval-freq)")
    p.add_argument("--resume", action="store_true", default=False,
                   help="continue from the newest valid checkpoint in --train-dir")
    p.add_argument("--keep-ckpts", type=int, default=0, metavar="K",
                   help="retain only the newest K model_step_N checkpoints (0 = all)")
    p.add_argument("--compress", action="store_true", default=False,
                   help="lossless-compress checkpoints (the port's host codec)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="mixed precision: forward and backward in bfloat16; master "
                        "params, optimizer state, gradients, loss and BatchNorm "
                        "statistics stay float32, so the wire is unchanged")
    p.add_argument("--code", type=str, default="sgd",
                   help="codec: sgd | svd | svd_budget | qsgd | terngrad")
    p.add_argument("--quantization-level", type=int, default=4)
    p.add_argument("--bucket-size", type=int, default=512)
    p.add_argument("--qsgd-path", type=str, default="fused", choices=["fused", "pack"],
                   help="fused = one quantize+pack kernel and one decode kernel; "
                        "pack = torch quantizer with the pack/unpack kernels")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--eval-freq", type=int, default=50)
    p.add_argument("--n-devices", type=int, default=0, metavar="N",
                   help="processes in the dp group, one per device (start them with "
                        "torchrun --nproc-per-node N); 0 = the whole process group, or "
                        "the single-device loop when there is none")
    p.add_argument("--aggregate", type=str, default="auto",
                   choices=["auto", "gather", "ring", "psum"],
                   help="gradient exchange: gather = payload all_gather (compressed "
                        "wire), ring = its streamed form (payloads rotate, each hop's "
                        "decode overlaps the next transfer), psum = dense all-reduce; "
                        "auto = gather")
    p.add_argument("--num-aggregate", type=int, default=None, metavar="N",
                   help="aggregate only K replicas per step (rotating subset; gather "
                        "and ring); unset = all")
    p.add_argument("--ring-bucket-size", type=int, default=65536, metavar="N",
                   help="ring aggregation: 4-byte elements per message of a hop; "
                        "<= 0 sends the packed payloads as one message (any value "
                        "gives the same result)")
    p.add_argument("--grad-accum", type=int, default=1, metavar="K",
                   help="accumulate gradients over K microbatches per device before "
                        "the one encode and exchange: activation memory shrinks to one "
                        "microbatch at a fixed --batch-size (the data-parallel step "
                        "only: --n-devices above 1, or a process group that is up)")
    p.add_argument("--overlap", type=str, default="off", choices=["off", "delayed"],
                   help="delayed = stale-by-one overlapped aggregation: at "
                        "step t each chip computes and encodes grads_t "
                        "while the optimizer applies the step-(t-1) "
                        "decoded mean, so the gather/ring exchange and the "
                        "decode run underneath fwd/bwd+update and leave "
                        "the critical path (needs a compressing --code and "
                        "--aggregate gather|ring on a multi-device mesh). "
                        "Step 0 applies a zero (skipped) update; "
                        "checkpoints carry the in-flight payload so resume "
                        "is exact. off (default) = the blocking program, "
                        "byte-for-byte as before")
    p.add_argument("--stream-encode", type=str, default="off", choices=["off", "on"],
                   help="on = backward-interleaved layer-streamed encode: "
                        "the gradient tree is partitioned DDP-style into "
                        "size-bounded layer buckets (--stream-bucket-mb, "
                        "reverse-topological so the last-computed layers "
                        "form the first-ready buckets) and each bucket's "
                        "encode — and, under --aggregate ring, its first "
                        "hops — depends only on that bucket's "
                        "gradients, so encode runs under backprop and the "
                        "wire starts before backward finishes. The bucket "
                        "plan is a layout knob: payloads and trajectories "
                        "are bit-identical to off for any bucket size "
                        "(per-leaf codec keys fold from the global leaf "
                        "index). Needs a compressing --code with "
                        "--aggregate gather|ring on a multi-device mesh; "
                        "composes with --superstep and --overlap delayed. "
                        "off (default) = the monolithic "
                        "encode, byte-for-byte as before")
    p.add_argument("--stream-bucket-mb", type=float, default=4.0, metavar="MB",
                   help="--stream-encode: dense megabytes per layer bucket "
                        "(<= 0 packs the whole tree into one bucket — "
                        "stream off's dataflow with stream on's code path). "
                        "Any value is bit-identical (layout only; tested); "
                        "smaller buckets pipeline finer at more dispatches")
    p.add_argument("--sparse-rows", type=str, default="off", choices=["off", "auto", "on"],
                   help="per-layer sparse-row hybrid exchange: lookup-table leaves whose "
                        "lossless (row, value) payload beats the dense path's bytes move "
                        "as rows (the SparCML crossover, stated per layer); the other "
                        "leaves keep the gather/ring exchange. auto = plan from a probe "
                        "gradient and use it when a leaf is sparse-assignable; on = "
                        "require it. Needs --n-devices above 1 and gather or ring")
    p.add_argument("--budget-alloc", type=str, default="uniform",
                   choices=["uniform", "variance"],
                   help="per-layer byte allocation: uniform = the fixed --svd-rank "
                        "(or --quantization-level) on every layer; variance = ATOMO's "
                        "water-filling allocation from per-layer gradient spectra of a "
                        "probe batch, minimising the estimator's variance under the "
                        "wire budget, recorded in train_dir/budget_alloc.json (reused "
                        "on --resume). Needs --code svd --sample fixed_k or --code qsgd")
    p.add_argument("--budget-bytes", type=float, default=0.0, metavar="B",
                   help="wire-byte budget per replica for --budget-alloc variance "
                        "(0 = the uniform allocation's total: equal wire bytes)")
    p.add_argument("--error-feedback", action="store_true", default=False,
                   help="carry each replica's compression residual e' = (g + e) - "
                        "decode(encode(g + e)) into its next encode (checkpointed with "
                        "the state). Biased: pairs with --code svd --sample topk; "
                        "refused with --sparse-rows and --num-aggregate")
    p.add_argument("--superstep", type=int, default=0, metavar="K",
                   help="run K optimizer steps per call on device-resident (K, batch, "
                        "...) data blocks, with one metric fetch per block: on the card "
                        "a step that makes no host sync is one CUDA graph replayed K "
                        "times, any other an eager K-step block (the run prints which). "
                        "Log/eval/checkpoint cadence snaps to block boundaries; "
                        "trajectories are bit-identical across K (resume works at any "
                        "step, boundary or not). 0 (default) = auto: 1 here (the JAX "
                        "verb's 8 is for TPU backends); 1 = the per-step loop exactly "
                        "as before")
    p.add_argument("--comm-type", type=str, default="Bcast", metavar="N",
                   help="accepted for parity with the reference and ignored")
    p.add_argument("--enable-gpu", action="store_true", default=False,
                   help="accepted for parity with the reference and ignored")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="accepted for parity with the reference and ignored (--device "
                        "picks the device)")
    _svd_flags(p, "0 = rank 3 for the fixed-budget samplers (the reference's "
                  "rank-0 mode only with --sample bernoulli)")
    p.add_argument("--svd-mode", type=str, default="auto",
                   choices=["auto", "exact", "randomized"],
                   help="alias over --svd-algo (the two must agree when both are "
                        "pinned): randomized = the Halko sketch at every size, exact = "
                        "the exact SVD, auto = --svd-algo's choice")
    p.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate", help="poll a checkpoint directory and evaluate")
    _model_flags(e)
    e.add_argument("--model-dir", type=str, default="",
                   help="checkpoint directory (default: --train-dir)")
    e.add_argument("--poll-interval", type=float, default=10.0)
    e.add_argument("--max-polls", type=int, default=0, help="0 = forever")
    e.add_argument("--stop-when-idle", action="store_true", default=False)
    e.set_defaults(fn=cmd_evaluate)

    q = sub.add_parser("lm", help="train the transformer LM on one device or a dp x sp mesh")
    q.add_argument("--layout", type=str, default="dp", choices=LM_LAYOUTS,
                   help="dp | dp-sp; the others come with later slices")
    q.add_argument("--ways", type=int, default=2, metavar="N",
                   help="model-axis size (the sp shards of dp-sp)")
    q.add_argument("--attn-impl", type=str, default="ring",
                   choices=["ring", "ulysses", "ulysses-flash"],
                   help="dp-sp attention; ulysses-flash runs the flash-attention kernel")
    q.add_argument("--data-file", type=str, default="",
                   help="byte-level text corpus (raw bytes = tokens, needs "
                        "--vocab-size >= 256); default: synthetic token streams")
    q.add_argument("--vocab-size", type=int, default=256)
    q.add_argument("--seq-len", type=int, default=128)
    q.add_argument("--width", type=int, default=128)
    q.add_argument("--depth", type=int, default=4)
    q.add_argument("--num-heads", type=int, default=4)
    q.add_argument("--batch-size", type=int, default=8)
    q.add_argument("--max-steps", type=int, default=50)
    q.add_argument("--log-interval", type=int, default=10)
    q.add_argument("--n-devices", type=int, default=0,
                   help="processes, one per device (start them with torchrun "
                        "--nproc-per-node N); 0 = all in the process group")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--lr", type=float, default=0.1)
    q.add_argument("--momentum", type=float, default=0.9)
    q.add_argument("--nesterov", action="store_true", default=False)
    q.add_argument("--weight-decay", type=float, default=0.0)
    q.add_argument("--lr-shrinkage", type=float, default=1.0)
    q.add_argument("--shrinkage-freq", type=int, default=50)
    q.add_argument("--optimizer", type=str, default="sgd", choices=["sgd", "adam"])
    q.add_argument("--code", type=str, default="svd")
    q.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 forward/backward, float32 master state")
    q.add_argument("--eval-freq", type=int, default=0,
                   help="validation PPL every N steps on held-out data, by the "
                        "single-device forward; 0 = off")
    q.add_argument("--train-dir", type=str, default="",
                   help="checkpoint dir (model_step_N naming); empty = no checkpoints")
    q.add_argument("--save-freq", type=int, default=0,
                   help="checkpoint every N steps (0 = only at the end)")
    q.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in --train-dir")
    q.add_argument("--compress", action="store_true", default=False,
                   help="lossless-compress checkpoints (the port's host codec)")
    _svd_flags(q, "0 (default) = width-scaled auto rank max(2, ceil(width * 6 / 64))")
    q.add_argument("--quantization-level", type=int, default=2)
    q.add_argument("--bucket-size", type=int, default=512)
    q.add_argument("--aggregate", type=str, default="auto",
                   choices=["auto", "gather", "psum", "ring"],
                   help="dp exchange: factor all_gather, dense all-reduce or the "
                        "streamed ring; auto = gather until the comm-cost model is "
                        "ported")
    q.add_argument("--ring-bucket-size", type=int, default=0, metavar="B",
                   help="--aggregate ring: 4-byte elements per message (0 = one "
                        "message a hop)")
    q.add_argument("--stream-encode", action="store_true", default=False,
                   help="interleave per-layer encode with the factor "
                        "exchange (gather/ring; the replicated path's "
                        "stream-encode, now on the model-axis layouts)")
    q.add_argument("--stream-bucket-bytes", type=int, default=4 << 20, metavar="B",
                   help="layer-bucket coalescing bound for "
                        "--stream-encode")
    q.add_argument("--overlap", type=str, default="off", choices=["off", "delayed"],
                   help="delayed = stale-by-one overlapped dp exchange "
                        "on the model-axis layouts: each step applies "
                        "the PREVIOUS step's encoded payload, so the "
                        "gather/ring exchange+decode runs underneath "
                        "this step's fwd/bwd. "
                        "Needs a compressing --code and "
                        "--aggregate gather/ring; step 0 skips (carry "
                        "starts empty)")
    q.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    q.set_defaults(fn=cmd_lm)
    return parser


def _dataset(args: argparse.Namespace, train: bool):
    name = canonical_name(args.dataset)
    if name == "zipf":  # sized by the table flags, so ids and model agree
        return zipf_dataset(train, rows=args.emb_rows, slots=args.zipf_slots,
                            alpha=args.zipf_alpha, seed=args.seed)
    if args.synthetic:
        return synthetic_dataset(SPECS[name], train)
    return load_dataset(name, args.data_root, train=train)


def _model_and_test_iter(args: argparse.Namespace):
    """The model (``--network embedding`` sized by ``--emb-rows`` and
    ``--emb-dim``) and the test batches: ``_build_common``'s."""
    test_ds = _dataset(args, False)
    spec = test_ds.spec
    test_iter = BatchIterator(test_ds, args.test_batch_size, shuffle=False,
                              drop_last=False, seed=args.seed)
    if args.network.lower() == "embedding":
        model = embedding_tower(spec.num_classes, spec.image_shape, rows=args.emb_rows,
                                dim=args.emb_dim)
    else:
        model = get_model(args.network, spec.num_classes, image_shape=spec.image_shape)
    return model, test_iter


def _overlap_preflight(args: argparse.Namespace) -> None:
    """The JAX verb's argv refusals of ``--overlap delayed`` and
    ``--stream-encode on`` (``atomo_tpu/cli.py:1013-1084``) for the flags
    the port has."""
    if args.overlap == "delayed":
        if args.code.lower() in DENSE_CODES:
            raise SystemExit(
                "--overlap delayed needs a compressing --code (the mode "
                "overlaps the encoded exchange+decode; dense training has "
                "no delayed form)")
        if args.n_devices == 1:
            raise SystemExit(
                "--overlap delayed needs a multi-device mesh: single-device "
                "training has no exchange to take off the critical path")
        if args.aggregate == "psum":
            raise SystemExit(
                f"--overlap delayed does not compose with --aggregate "
                f"{args.aggregate} (only the compressed flat gather/ring "
                "exchanges have a delayed form; no two-level topology "
                "plan — legacy or re-encoded — does)")
    if args.stream_encode == "on":
        if args.code.lower() in DENSE_CODES:
            raise SystemExit(
                "--stream-encode needs a compressing --code (the mode "
                "pipelines the per-bucket ENCODE under backprop; dense "
                "training has no encode to stream)")
        if args.n_devices == 1:
            raise SystemExit(
                "--stream-encode needs a multi-device mesh: single-device "
                "training has no exchange whose encode is on the critical "
                "path")
        if args.aggregate == "psum":
            raise SystemExit(
                f"--stream-encode does not compose with --aggregate "
                f"{args.aggregate}: psum ships dense gradients (no encode "
                "to stream), and the hierarchical boundary re-encode is "
                "not bucket-aware yet — the honest reject until it is; "
                "use --aggregate gather or ring")


def _resolved_single(args: argparse.Namespace) -> None:
    """The JAX verb's refusals that need the resolved device count
    (``:2730-2742``): delayed and stream-encode on one device."""
    if args.overlap == "delayed":
        raise SystemExit(
            "--overlap delayed needs a multi-device mesh: single-device "
            "training has no exchange to take off the critical path")
    if args.stream_encode == "on":
        raise SystemExit(
            "--stream-encode needs a multi-device mesh: single-device "
            "training has no exchange whose encode is on the critical path")


def _stream_bucket_bytes(args: argparse.Namespace) -> int:
    """--stream-bucket-mb -> bytes (<= 0 means the single-bucket plan)."""
    mb = float(args.stream_bucket_mb)
    return int(mb * (1 << 20)) if mb > 0 else 0


def _sparse_preflight(args: argparse.Namespace) -> None:
    """The JAX verb's argv refusals of ``--sparse-rows`` for the flags the
    port has."""
    if args.sparse_rows == "off":
        return
    if args.n_devices == 1 and args.sparse_rows == "on":
        raise SystemExit(
            "--sparse-rows needs a multi-device mesh: single-device "
            "training has no exchange to save wire on")
    if args.aggregate == "psum":
        raise SystemExit(
            "--sparse-rows does not compose with --aggregate psum: "
            "the row payloads would ride a full dense all-reduce "
            "wire, so the sparse exchange degenerates (the SparCML "
            "crossover can never pay); use --aggregate gather or ring")
    if args.overlap == "delayed":
        raise SystemExit(
            "--sparse-rows does not compose with --overlap delayed: "
            "the carried payload's shapes are assignment-specific "
            "and the consume chain is not row-aware yet")
    if args.stream_encode == "on":
        raise SystemExit(
            "--sparse-rows does not compose with --stream-encode: "
            "the layer-bucket encode pipeline is not "
            "assignment-aware yet; drop one")
    if args.num_aggregate is not None:
        raise SystemExit(
            "--sparse-rows does not compose with --num-aggregate: "
            "the rotating replica subset is not wired into the row "
            "exchange")


def _budget_preflight(args: argparse.Namespace) -> None:
    """The JAX verb's argv refusals of ``--budget-alloc``, ``--budget-bytes``
    and ``--error-feedback`` (``:1197-1350``) for the flags the port has,
    and its warning for error feedback on an unbiased estimator."""
    code = args.code.lower()
    if args.budget_bytes and args.budget_alloc != "variance":
        raise SystemExit(
            "--budget-bytes sizes the variance allocation's global wire "
            "budget and needs --budget-alloc variance (uniform spends "
            "the fixed --svd-rank budget per layer by definition)")
    if args.budget_alloc == "variance":
        if code in DENSE_CODES:
            raise SystemExit(
                "--budget-alloc variance allocates a compressing codec's "
                "per-layer budget; dense training has no budget to "
                "allocate")
        if code not in ("svd", "qsgd"):
            raise SystemExit(
                f"--budget-alloc variance needs --code svd (the fixed_k "
                "rank law A/k) or --code qsgd (the bit law "
                f"B/(2^b-1)^2); per-layer allocation for {args.code!r} "
                "is the same machinery with a different pricing/"
                "variance pair and is not stated yet — rejected "
                "honestly (terngrad's max-norm scale + sigma clip "
                "included)")
        if code == "svd" and args.sample != "fixed_k":
            raise SystemExit(
                f"--budget-alloc variance with --code svd needs "
                f"--sample fixed_k (the stated variance law is the "
                f"with-replacement sampler's A/k; --sample "
                f"{args.sample} has a different law)")
        if args.sparse_rows != "off":
            raise SystemExit(
                "--budget-alloc variance with --sparse-rows is a JOINT "
                "decision: the hybrid planner must re-price its dense "
                "sub-list under the allocated per-leaf codec, and the "
                "two single deciders each assume the other's knob is at "
                "its default. --auto controller prices and probes "
                "exactly that cross term (the +sp+ab candidates) — use "
                "it; the static pairing stays rejected")
    if not args.error_feedback:
        return
    if code in DENSE_CODES:
        raise SystemExit(
            "--error-feedback accumulates the codec's compression "
            "residual; dense training (--code sgd) has none")
    if args.n_devices == 1:
        raise SystemExit(
            "--error-feedback needs a multi-device mesh: the "
            "residual compensates the exchanged estimator's error, "
            "and single-device training has no exchange")
    if args.overlap == "delayed":
        raise SystemExit(
            "--error-feedback does not compose with --overlap "
            "delayed: the stale carry's residual semantics are "
            "unproven — rejected honestly")
    if args.sparse_rows != "off":
        raise SystemExit(
            "--error-feedback does not compose with --sparse-rows "
            "(the mixed per-leaf residual carry is untested)")
    if args.num_aggregate is not None:
        raise SystemExit(
            "--error-feedback does not compose with --num-aggregate: "
            "an unconsumed encode's residual would be mis-attributed")
    if not (code == "svd" and args.sample == "topk"):
        warnings.warn(
            "--error-feedback pairs with a CONTRACTION compressor "
            "(--code svd --sample topk): the unbiased random "
            "estimators make the residual a random walk (measured "
            "divergent on the LeNet recipe); proceeding, but "
            "svd+topk is the supported pairing")


def _warn_dead_flags(args: argparse.Namespace) -> None:
    """The JAX verb's warnings for flags it takes and ignores
    (``atomo_tpu/cli.py:578-595``)."""
    if args.comm_type != "Bcast":
        warnings.warn(
            "--comm-type is accepted for parity but ignored (it is a fake "
            "parameter in the reference too, README.md:111)")
    if args.num_aggregate is not None and (
            args.aggregate not in ("gather", "ring", "auto") or args.code.lower() in DENSE_CODES):
        warnings.warn(
            "--num-aggregate only applies to compressed gather/ring "
            "aggregation (a dense psum cannot subset replicas); ignoring it "
            "— note the reference ignores it always "
            "(sync_replicas_master_nn.py:113,124)")
    if args.enable_gpu or args.no_cuda:
        warnings.warn("--enable-gpu/--no-cuda are ignored: device selection is JAX's")


def _num_aggregate(args: argparse.Namespace, aggregate: str, codec, n_dev: int) -> int:
    """k of ``--num-aggregate`` as the JAX verb resolves it (``:3034-3045``):
    0 (every replica) unless gather or ring carries a codec and 0 < k < N."""
    if args.num_aggregate is None or aggregate not in ("gather", "ring") or codec is None:
        return 0
    k_agg = args.num_aggregate
    if not 0 < k_agg < n_dev:
        warnings.warn(
            f"--num-aggregate {k_agg} is outside (0, {n_dev}) for this "
            f"{n_dev}-device mesh; aggregating all replicas")
        return 0
    return k_agg


def budget_allocation(args: argparse.Namespace, model, codec, train_iter, log_fn,
                      write: bool = True):
    """``--budget-alloc variance``: (spectra, allocation) as the JAX verb
    makes and prints them (``:2565-2645``). The probe gradient is taken over
    a direct slice of the training arrays, so the batch stream does not
    advance; ``--resume`` reuses a recorded ``budget_alloc.json`` that fits,
    else solves again. ``write`` (rank 0) writes the artifact."""
    from atomo_tpu_torch.budget import (
        Allocation,
        alloc_path,
        alloc_reusable,
        latest_epoch,
        measure_spectra,
        new_alloc_doc,
        read_alloc,
        solve_allocation,
        write_alloc,
    )
    from atomo_tpu_torch.convert import jax_layouts, jax_leaf_paths
    from atomo_tpu_torch.sparse import hybrid

    probe_n = min(max(args.batch_size, 8), len(train_iter.images))
    grads = hybrid.probe_gradient(model, train_iter.images[:probe_n],
                                  train_iter.labels[:probe_n])
    spectra = measure_spectra(codec, grads, jax_leaf_paths(model), jax_layouts(model))
    budget_b = int(args.budget_bytes) if args.budget_bytes > 0 else None
    alloc = None
    if args.resume and args.train_dir:
        # a resume replays the recorded allocation, never a fresh solve
        prior = read_alloc(args.train_dir)
        ok_reuse, why = alloc_reusable(prior, codec_name=codec.name, n_leaves=len(spectra))
        if ok_reuse:
            ep = latest_epoch(prior)
            alloc = Allocation(
                mode=str(ep.get("mode", "variance")),
                ks=tuple(int(k) for k in ep["ks"]),
                payload_bytes=int(ep["payload_bytes"]),
                budget_bytes=int(ep.get("budget_bytes", prior["budget_bytes"])),
                predicted_variance=float(ep.get("predicted_variance", 0.0)),
                epoch=int(ep["epoch"]),
            )
            log_fn(f"Budget: {why} (budget_alloc.json)")
        elif prior is not None:
            log_fn(f"Budget: NOT reusing budget_alloc.json: {why}")
    if alloc is None:
        alloc = solve_allocation(codec, spectra, budget_bytes=budget_b, mode="variance")
        if args.train_dir:
            if write:
                write_alloc(args.train_dir, new_alloc_doc(codec, spectra, alloc))
            log_fn(f"Budget: allocation artifact -> {alloc_path(args.train_dir)}")
    log_fn(alloc.describe())
    for l in spectra:
        log_fn(f"  [{l.index}] {l.name}: k={alloc.ks[l.index]}"
               + ("" if l.adaptive else " (dense at any rank — fixed)"))
    return spectra, alloc


def sparse_plan(args: argparse.Namespace, model, codec, train_iter, n_dev: int, log_fn):
    """``--sparse-rows auto|on``'s plan over ``n_dev`` ranks, printed as the
    JAX verb prints it, or None (all-dense). The probe gradient is taken
    over a direct slice of the training arrays, so the batch stream does
    not advance."""
    from atomo_tpu_torch.sparse import plan_for_model

    if train_iter.images.ndim != 2:
        msg = ("--sparse-rows: this workload's batches are not row-id "
               "shaped, so no leaf has a provable per-step row bound "
               "(row-id workloads: --dataset zipf --network embedding)")
        if args.sparse_rows == "on":
            raise SystemExit(msg + "; drop --sparse-rows")
        log_fn(msg + " — running all-dense")
        return None
    probe_n = min(max(args.batch_size, 8), len(train_iter.images))
    plan = plan_for_model(codec if codec is not None else DenseCodec(), model,
                          train_iter.images[:probe_n], train_iter.labels[:probe_n],
                          max(args.batch_size // n_dev, 1), int(train_iter.images.shape[1]))
    if plan.any_sparse:
        log_fn(plan.describe())
    if plan.any_sparse or args.sparse_rows == "on":
        for a in plan.assignments:
            log_fn(f"  [{a.index}] {a.name}: {a.reason}")
    if plan.any_sparse:
        return plan
    if args.sparse_rows == "on":
        raise SystemExit(
            "--sparse-rows on: the hybrid planner assigned no "
            "leaf sparse for this model/codec/batch (per-leaf "
            "reasons above); drop --sparse-rows or shrink the "
            "dense path's payload")
    log_fn("--sparse-rows auto: the planner assigned no leaf sparse — running all-dense")
    return None


def _superstep(args: argparse.Namespace) -> int:
    """``--superstep`` as the JAX verb takes it (``atomo_tpu/cli.py:930-934``,
    ``:2401-2407``): a negative K refused, 0 resolved to 1 (the JAX verb's
    off-TPU default)."""
    if args.superstep < 0:
        raise SystemExit(
            f"--superstep {args.superstep}: must be >= 1 (or 0 for the "
            "per-backend auto default)")
    return args.superstep or 1


def cmd_train(args: argparse.Namespace, log_fn=print):
    superstep = _superstep(args)
    _overlap_preflight(args)
    _sparse_preflight(args)
    _budget_preflight(args)
    _warn_dead_flags(args)
    name = canonical_name(args.dataset)
    train_ds = _dataset(args, True)
    train_iter = BatchIterator(train_ds, args.batch_size, seed=args.seed)
    model, test_iter = _model_and_test_iter(args)
    optimizer = make_optimizer(
        args.optimizer, lr=args.lr, lr_shrinkage=args.lr_shrinkage,
        shrinkage_freq=args.shrinkage_freq, momentum=args.momentum, nesterov=args.nesterov,
        weight_decay=args.weight_decay, beta1=args.adam_beta1, beta2=args.adam_beta2,
        eps=args.adam_eps, amsgrad=args.amsgrad,
    )
    fused = args.qsgd_path == "fused"
    svd_rank = args.svd_rank
    if svd_rank == 0 and args.sample != "bernoulli":
        # rank 0 is the reference's p_i = s_i/s_0 mode, which only the
        # bernoulli sampler has; the fixed-budget samplers take rank 3
        if args.code.lower() == "svd":
            warnings.warn(
                "--svd-rank 0 maps to the reference's rank-0 mode only with "
                "--sample bernoulli; using rank 3 for the fixed-budget sampler"
            )
        svd_rank = 3
    codec = get_codec(
        args.code, svd_rank=svd_rank, quantization_level=args.quantization_level,
        bucket_size=args.bucket_size, sample=args.sample, algorithm=_svd_algo(args),
        wire_dtype=args.svd_wire,
        use_kernel=None if fused else False, pack_kernel=None if fused else True,
    )
    if codec.name == "sgd":
        codec = None  # dense: no encode/decode in the step, as the JAX trainer
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    common = dict(augment=name.startswith("cifar") and not args.no_augment,
                  max_steps=min(args.max_steps, args.epochs * steps_per_epoch),
                  eval_freq=args.eval_freq, seed=args.seed, log_fn=log_fn,
                  log_every=args.log_interval, device=args.device,
                  train_dir=args.train_dir, save_freq=args.save_freq or args.eval_freq,
                  resume=args.resume, keep_ckpts=args.keep_ckpts, compress_ckpt=args.compress,
                  compute_dtype=torch.bfloat16 if args.bf16 else None, superstep=superstep)
    # one process runs the single-device loop unless a process group is up
    # or torchrun started it (one device over NCCL: a torchrun of one process)
    if args.n_devices <= 1 and not (dist.is_initialized() or "WORLD_SIZE" in os.environ):
        _resolved_single(args)
        if args.sparse_rows != "off":
            log_fn("--sparse-rows auto: single device, no exchange — running dense")
        if args.num_aggregate is not None:
            warnings.warn("--num-aggregate needs a multi-device mesh; single-device "
                          "training has no replicas to subset — ignoring it")
        if args.grad_accum > 1:
            warnings.warn("--grad-accum is only wired into the multi-device step; "
                          "single-device training ignores it")
        if args.error_feedback:
            warnings.warn("--error-feedback needs a multi-device mesh; single-device "
                          "training has no exchanged estimator to compensate — "
                          "ignoring it")
        if args.budget_alloc == "variance":
            codec = budgeted_codec(codec, budget_allocation(
                args, model, codec, train_iter, log_fn)[1].ks)
        return train_loop(model, optimizer, train_iter, test_iter, codec=codec, **common)
    was_up = torch.distributed.is_initialized()
    ctx = launch.initialize(args.device)
    try:
        n_dev = args.n_devices or ctx.world_size
        if ctx.world_size != n_dev:
            raise SystemExit(
                f"--n-devices {n_dev} needs {n_dev} processes, one per "
                f"device; this group has {ctx.world_size}: run torchrun --nproc-per-node "
                f"{n_dev} -m atomo_tpu_torch train --n-devices {n_dev} ...")
        if n_dev <= 1:
            _resolved_single(args)
        rank_log = log_fn if ctx.rank == 0 else (lambda _: None)
        plan = None
        if args.sparse_rows != "off" and n_dev <= 1:
            rank_log("--sparse-rows auto: single device, no exchange — running dense")
        elif args.sparse_rows != "off":
            plan = sparse_plan(args, model, codec, train_iter, n_dev, rank_log)
            if plan is not None and codec is None:
                # --code sgd: the dense-assigned leaves ride the payload
                # exchange as uncompressed DenseCodec payloads
                codec = DenseCodec()
        if args.budget_alloc == "variance":
            codec = budgeted_codec(codec, budget_allocation(
                args, model, codec, train_iter, rank_log, write=ctx.rank == 0)[1].ks)
        # auto resolves to gather until the comm-cost model is ported
        aggregate = "gather" if args.aggregate == "auto" else args.aggregate
        return distributed_train_loop(
            model, optimizer, train_iter, test_iter, codec=codec, aggregate=aggregate,
            num_aggregate=_num_aggregate(args, aggregate, codec, n_dev),
            ring_bucket_size=args.ring_bucket_size, grad_accum=args.grad_accum, hybrid=plan,
            error_feedback=args.error_feedback, overlap=args.overlap,
            stream_encode=args.stream_encode == "on",
            stream_bucket_bytes=_stream_bucket_bytes(args), **{**common, "device": ctx.device})
    finally:
        if not was_up:
            launch.shutdown()


def cmd_evaluate(args: argparse.Namespace, log_fn=print) -> int:
    """Evaluate each new checkpoint of ``--model-dir`` (``--train-dir``) with
    the reference's ``Evaluator:`` line, every ``--poll-interval`` seconds."""
    model, test_iter = _model_and_test_iter(args)
    ev = CheckpointEvaluator(model, test_iter, args.model_dir or args.train_dir,
                             poll_interval=args.poll_interval, log_fn=log_fn,
                             device=args.device)
    ev.run(max_polls=args.max_polls or None, stop_when_idle=args.stop_when_idle)
    return 0


def _lm_rank(args: argparse.Namespace, log_fn) -> int:
    """The LM's SVD rank: 0 scales it to the width, ceil(width * 6/64) with
    a floor of 2 (the verified rank-6/width-64 operating point of the JAX
    package); an explicit rank below that floor runs, with a warning."""
    rank_floor = max(2, -(-args.width * 6 // 64))
    if args.svd_rank <= 0:
        log_fn(f"--svd-rank auto -> {rank_floor} for width {args.width} "
               "(anchored at the verified rank-6/width-64 operating point, "
               "artifacts/LM_CONVERGENCE.md)")
        return rank_floor
    if args.svd_rank < rank_floor:
        warnings.warn(
            f"--svd-rank {args.svd_rank} is below the width-scaled floor "
            f"{rank_floor} for --width {args.width}: expect a loss floor; use "
            "--svd-rank 0 for the width-scaled default"
        )
    return args.svd_rank


def lm_data(args: argparse.Namespace):
    """(next_batch, eval_tokens): the JAX package's token streams as int
    numpy arrays. Synthetic: arithmetic progressions mod the vocabulary with
    random starts and strides 1-3 from ``--seed``, eval from seed + 10000.
    ``--data-file``: its bytes in seq-len chunks, the last 10 % held out for
    eval when ``--eval-freq`` is set."""
    rng = np.random.default_rng(args.seed)

    def synth(r, n):
        starts = r.integers(0, args.vocab_size, size=(n, 1))
        strides = r.integers(1, 4, size=(n, 1))
        return ((starts + strides * np.arange(args.seq_len)) % args.vocab_size).astype(np.int32)

    if not args.data_file:
        eval_tokens = (synth(np.random.default_rng(args.seed + 10_000), args.batch_size)
                       if args.eval_freq else None)
        return (lambda: synth(rng, args.batch_size)), eval_tokens
    if args.vocab_size < 256:
        raise SystemExit(f"--data-file tokenizes raw bytes: --vocab-size "
                         f"{args.vocab_size} < 256 cannot embed them")
    try:
        with open(args.data_file, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
    except OSError as e:
        raise SystemExit(f"--data-file: {e}") from None
    n_seq = len(raw) // args.seq_len
    if n_seq < args.batch_size:
        raise SystemExit(f"--data-file holds only {n_seq} sequences of length "
                         f"{args.seq_len}; need at least --batch-size {args.batch_size}")
    chunks = raw[: n_seq * args.seq_len].reshape(n_seq, args.seq_len)
    n_hold = max(1, n_seq // 10) if args.eval_freq else 0
    train_chunks = chunks[: n_seq - n_hold]
    eval_tokens = chunks[n_seq - n_hold :].astype(np.int32) if n_hold else None
    if len(train_chunks) < args.batch_size:
        raise SystemExit(f"--data-file leaves only {len(train_chunks)} training sequences "
                         f"after the --eval-freq holdout ({n_hold}); need at least "
                         f"--batch-size {args.batch_size}")

    def next_batch():
        idx = rng.integers(0, len(train_chunks), size=args.batch_size)
        return train_chunks[idx].astype(np.int32)

    return next_batch, eval_tokens


def cmd_lm(args: argparse.Namespace, log_fn=print):
    """LM training, ``--layout dp`` or ``dp-sp``: on one device, or on a
    (dp, sp) mesh of N processes, one per device, as ``torchrun
    --nproc-per-node N -m atomo_tpu_torch lm --n-devices N --layout dp-sp
    --ways S ...`` starts them (dp = N/S, sp = S). Rank 0 prints the JAX
    package's ``LM:`` lines letter for letter and writes the checkpoints;
    every rank loads them on ``--resume``. As in the JAX package, a resumed
    run draws its batches from a fresh ``--seed`` stream (it does not replay
    the batches taken before the checkpoint) and folds step i's key from i.
    Returns this rank's final train state."""
    if args.layout not in ("dp", "dp-sp"):
        raise SystemExit(f"--layout {args.layout} {LATER}; this one runs dp and dp-sp")
    if args.layout == "dp" and args.ways != 2:  # 2 is the default
        warnings.warn(f"--ways {args.ways} only applies to layouts with a model axis; "
                      "--layout dp is pure data parallelism, ignoring it")
    if args.layout == "dp" and args.attn_impl != "ring":
        warnings.warn(f"--attn-impl only applies to layout dp-sp/dp-tp-sp; "
                      f"ignored for --layout {args.layout}")
    ways = args.ways if args.layout == "dp-sp" else 1
    was_up = dist.is_initialized()
    ctx = launch.initialize(args.device)
    try:
        n_dev = args.n_devices or ctx.world_size
        if n_dev != ctx.world_size:
            raise SystemExit(
                f"--n-devices {n_dev} needs {n_dev} processes, one per device; this group "
                f"has {ctx.world_size}: run torchrun --nproc-per-node {n_dev} -m "
                f"atomo_tpu_torch lm --n-devices {n_dev} ...")
        if ways < 1 or n_dev % ways:
            raise SystemExit(f"--ways {ways} does not divide {n_dev} devices")
        if args.batch_size % (n_dev // ways):
            raise SystemExit(f"--batch-size {args.batch_size} not divisible by "
                             f"dp={n_dev // ways}")
        if args.seq_len % ways:
            raise SystemExit(f"--seq-len must be divisible by sp ways={ways}")
        mesh = launch.dp_sp_mesh(ways)
        return _lm_loop(args, mesh, ctx.device, log_fn if ctx.rank == 0 else (lambda _: None))
    finally:
        if not was_up:
            launch.shutdown()


def lm_codec(args: argparse.Namespace, log_fn=print):
    """The ``lm`` verb's codec (None for a dense code)."""
    if args.code.lower() in DENSE_CODES:
        return None
    svd_rank = _lm_rank(args, log_fn) if args.code.lower().startswith("svd") else args.svd_rank
    return get_codec(
        args.code, svd_rank=svd_rank, quantization_level=args.quantization_level,
        bucket_size=args.bucket_size, sample=args.sample, algorithm=args.svd_algo,
        wire_dtype=args.svd_wire,
    )


def lm_config(args: argparse.Namespace) -> dict:
    """The ``lm`` verb's :class:`TransformerLM` arguments."""
    return dict(vocab_size=args.vocab_size, max_len=args.seq_len, width=args.width,
                depth=args.depth, num_heads=args.num_heads)


def lm_optimizer(args: argparse.Namespace):
    """The ``lm`` verb's optimizer."""
    return make_optimizer(
        args.optimizer, lr=args.lr, lr_shrinkage=args.lr_shrinkage,
        shrinkage_freq=args.shrinkage_freq, momentum=args.momentum,
        nesterov=args.nesterov, weight_decay=args.weight_decay,
    )


def _lm_loop(args: argparse.Namespace, mesh, dev, log_fn):
    """The steps of :func:`cmd_lm` on this rank's place in ``mesh``;
    ``log_fn`` prints (rank 0) or drops (the others)."""
    codec = lm_codec(args, log_fn)
    optimizer = lm_optimizer(args)
    next_batch, eval_tokens = lm_data(args)
    aggregate = args.aggregate
    if aggregate == "ring" and codec is None:
        raise SystemExit("--aggregate ring streams CODEC payloads around the dp axis; a "
                         "dense code has no payloads to rotate: use psum (or pick a "
                         "compressing --code)")
    if args.stream_encode and codec is None:
        warnings.warn(
            "--stream-encode interleaves CODEC encode with the exchange; "
            "a dense code has nothing to encode — ignoring it")
    if args.overlap == "delayed":
        # the model-axis delayed preflight, in the JAX verb's words
        if codec is None:
            raise SystemExit(
                "--overlap delayed carries the ENCODED payload between "
                "steps; a dense --code has no payload to carry — pick a "
                "compressing --code, or drop --overlap")
        if mesh.n_dp <= 1:
            raise SystemExit(
                f"--overlap delayed needs a multi-replica dp axis; "
                f"--layout {args.layout} at {mesh.n_dp * mesh.n_sp} devices resolves to "
                "dp=1 — no dp exchange to take off the critical path")
        if aggregate == "psum":
            raise SystemExit(
                "--overlap delayed does not compose with --aggregate "
                "psum: the dense all-reduce has no encoded payload to "
                "carry between steps — use gather or ring")
    if aggregate == "auto":
        aggregate = "gather"
        log_fn("--aggregate auto -> gather (the comm-cost model that chooses among "
               "gather, psum and ring is not ported yet)")
    exchange = None
    if args.stream_encode and codec is not None and aggregate == "psum":
        warnings.warn(
            "--stream-encode interleaves encode with the FACTOR exchange "
            "(gather/ring); psum moves the dense decoded tree — ignoring it")
    elif (aggregate == "ring" or (args.stream_encode and codec is not None)
          or args.overlap == "delayed"):
        exchange = DpExchange(aggregate, args.ring_bucket_size,
                              stream_encode=bool(args.stream_encode and codec is not None),
                              stream_bucket_bytes=args.stream_bucket_bytes,
                              overlap=args.overlap)
    state = create_lm_state(lm_config(args), optimizer, args.seed, dev)
    if dist.is_initialized():
        state = replicate_state(state)
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    start = 0
    saved_carry = None
    if args.train_dir and args.resume and latest_step(args.train_dir) is not None:
        state = load_checkpoint(args.train_dir, state)
        saved_carry, state = state.carry, dataclasses.replace(state, carry=None)
        start = state.step
        log_fn(f"Resumed from {args.train_dir} at step {start}")
    delayed = exchange is not None and exchange.overlap == "delayed"
    if delayed:
        state = init_model_axis_delayed_state(state, codec)
        if start:  # the payload that step start + 1 consumes
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
    step = make_lm_train_step(state.model, optimizer, codec,
                              attn_impl=args.attn_impl if args.layout == "dp-sp" else "ring",
                              aggregate=aggregate, exchange=exchange, mesh=mesh,
                              compute_dtype=torch.bfloat16 if args.bf16 else None)
    for i in range(start + 1, args.max_steps + 1):
        t0 = time.time()
        # every rank draws the global batch alike and takes its block
        tokens = np.ascontiguousarray(shard_tokens(next_batch(), mesh))
        state, metrics = step(state, fold_in(args.seed, i),
                              torch.from_numpy(tokens).to(dev, torch.int64))
        loss = float(metrics["loss"])  # device sync: honest step timing
        if i % args.log_interval == 0 or i == args.max_steps:
            log_fn(
                f"LM: Step: {i}, Layout: {args.layout}({mesh.describe()}), "
                f"Loss: {loss:.4f}, PPL: {math.exp(min(loss, 30.0)):.2f}, "
                f"Time Cost: {time.time() - t0:.4f}, "
                f"Msg(MB): {metrics['msg_bytes'] / 1e6:.4f}, "
                f"Dense(MB): {metrics['dense_bytes'] / 1e6:.4f}"
            )
        if args.eval_freq and i % args.eval_freq == 0 and (mesh.rank_dp, mesh.rank_sp) == (0, 0):
            # the single-device forward on the replicated parameters
            state.model.eval()
            with torch.no_grad():
                toks = torch.from_numpy(eval_tokens[: args.batch_size]).to(dev, torch.int64)
                vl = float(lm_loss(state.model(toks), toks))
            log_fn(f"LM Validation: Step: {i}, Loss: {vl:.4f}, "
                   f"PPL: {math.exp(min(vl, 30.0)):.2f}")
        if args.train_dir and ((args.save_freq and i % args.save_freq == 0)
                               or i == args.max_steps):
            saved = state
            if delayed:  # every rank's in-flight payload, one row each (cli.py:3541-3560)
                saved = dataclasses.replace(state, carry=gather_carry(state.carry, world))
            if (mesh.rank_dp, mesh.rank_sp) == (0, 0):
                save_checkpoint(args.train_dir, saved, compress=args.compress)
            if dist.is_initialized():
                dist.barrier()  # no rank goes on before the file is in place
    return state


def main(argv: Optional[list[str]] = None, log_fn=print) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "fn", None) is None:
        build_parser().print_help()
        return 2
    args.fn(args, log_fn=log_fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
