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
each new file. ``lm`` runs the six layouts of the JAX verb on one device or
over N processes (``--n-devices N --ways W``): ``dp``, ``dp-sp`` (sequence
shards, ``--attn-impl ring|ulysses|ulysses-flash``), ``dp-tp`` (Megatron
tensor parallel), ``dp-ep`` (switch MoE, ``--num-experts``), ``dp-pp``
(GPipe, ``--microbatches``) and ``dp-tp-sp`` (``--ways`` tp x ``--sp-ways``
sp), with ``--optimizer``, ``--bf16``, ``--eval-freq`` (each family's
single-device forward) and checkpoints (``--train-dir``, ``--save-freq``,
``--resume``, ``--compress``; a family's full tree in the JAX layout). Both
verbs take ``--stream-encode`` (layer buckets encoded under backward;
``train --stream-bucket-mb``, ``lm --stream-bucket-bytes``) and ``--overlap
delayed`` (the stale-by-one exchange, its in-flight payload in the
checkpoints), with the JAX verbs' refusals. ``--aggregate auto`` (the
default of both) is the comm-cost model's pick (``utils/comm_model.py``)
for the byte budget, the device count and ``--fabric`` (``--codec-tax-ms``),
printed as the JAX verb prints it: psum for a dense code or one device,
gather or ring by wire bytes otherwise; where the JAX verb would pick its
unported two-tier hierarchical mode (a group that spans hosts) the port
refuses.
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
    DpExchange,
)
from atomo_tpu_torch.parallel.overlap import carry_from_saved
from atomo_tpu_torch.training import distributed_train_loop, make_optimizer, train_loop
from atomo_tpu_torch.training.checkpoint import latest_step
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


def _fabric_flags(p: argparse.ArgumentParser) -> None:
    """``--fabric`` and ``--codec-tax-ms``, what ``--aggregate auto``
    prices from."""
    p.add_argument("--fabric", type=str, default="auto", metavar="F",
                   help="the fabric --aggregate auto prices the wire on: auto "
                        "(nvlink on one host, dcn across hosts) | nvlink | ici (the JAX "
                        "package's name, = nvlink) | dcn | eth10g | a per-device GB/s "
                        "number")
    p.add_argument("--codec-tax-ms", type=float, default=None, metavar="MS",
                   help="measured single-device codec tax for --aggregate auto's "
                        "advisory; default scales the ResNet-18 anchor measured on the "
                        "H100 (utils/comm_model.py) by gradient size")


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
                        "auto = the comm-cost model's pick for this byte budget, "
                        "device count and --fabric, printed with its reason (psum for "
                        "a dense code; the two-tier hierarchical pick is refused: not "
                        "ported)")
    _fabric_flags(p)
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
                   help="mesh composition: dp (data parallel), dp-sp (sequence "
                        "parallel), dp-tp (Megatron tensor parallel), dp-ep (switch-MoE "
                        "expert parallel), dp-pp (GPipe pipeline), dp-tp-sp (tensor x "
                        "sequence)")
    q.add_argument("--ways", type=int, default=2, metavar="N",
                   help="model-axis size (tp for dp-tp-sp, whose sp is --sp-ways)")
    q.add_argument("--sp-ways", type=int, default=2, metavar="N",
                   help="--layout dp-tp-sp: the sequence axis's size")
    q.add_argument("--num-experts", type=int, default=8,
                   help="--layout dp-ep: experts per MoE layer (sharded over ep)")
    q.add_argument("--microbatches", type=int, default=2,
                   help="--layout dp-pp: GPipe microbatches per replica batch")
    q.add_argument("--attn-impl", type=str, default="ring",
                   choices=["ring", "ulysses", "ulysses-flash"],
                   help="dp-sp / dp-tp-sp attention; ulysses-flash runs the "
                        "flash-attention kernel")
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
                        "streamed ring; auto = the comm-cost model's pick over the dp "
                        "axis (priced on the unsharded LM), printed with its reason")
    _fabric_flags(q)
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


def hosts_in_group() -> int:
    """Hosts the process group spans: its world over ``LOCAL_WORLD_SIZE``
    (the processes ``torchrun`` starts on this host; the world when unset).
    The JAX package's ``jax.process_count()`` counts hosts, and the port runs
    one process per device, so a world above one is not a mesh that crosses
    hosts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or world)
    return max(1, world // max(local, 1))


def resolve_auto_aggregate(args: argparse.Namespace, codec, model, n_dev: int, *,
                           allow_hierarchical: bool = True, log=print) -> str:
    """``--aggregate auto`` as the JAX verbs resolve it
    (``atomo_tpu/cli.py:726-810``): the comm-cost model's pick for this
    byte budget (``model``'s leaves under ``codec``), ``n_dev`` ways and
    ``--fabric``, logged as the JAX line ``--aggregate auto -> <mode>
    (<reason>)``. A mesh that crosses hosts is hierarchical in the JAX
    package, whose two-tier schedule is not ported: refused, never
    replaced."""
    from atomo_tpu_torch.tuning.probe import byte_budget
    from atomo_tpu_torch.utils.comm_model import choose_aggregate, resolve_fabric

    n_hosts = hosts_in_group()
    cross_host = n_hosts > 1 and allow_hierarchical
    dense_b, payload_b = byte_budget(codec, model) if codec is not None else (0, 0)
    if cross_host and codec is not None:
        raise SystemExit(
            f"--aggregate auto: this group spans {n_hosts} hosts (WORLD_SIZE over "
            "LOCAL_WORLD_SIZE), where the JAX verb picks --aggregate hierarchical "
            "(the two-tier schedule), which this port does not have yet; pass "
            "--aggregate gather, ring or psum")
    try:
        bw = resolve_fabric(args.fabric, n_proc=n_hosts)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    mode, reason = choose_aggregate(
        has_codec=codec is not None, dense_bytes=dense_b, payload_bytes=payload_b,
        ways=n_dev, fabric_bw=bw,
        tax_s=None if args.codec_tax_ms is None else args.codec_tax_ms / 1e3,
        cross_host=cross_host)
    log(f"--aggregate auto -> {mode} ({reason})")
    return mode


def _hybrid_auto_aggregate(args: argparse.Namespace, plan, n_dev: int, log) -> str:
    """``--aggregate auto`` under a sparse-row plan (``atomo_tpu/cli.py:
    2890-2930``): the plan's wire bytes decide, and a psum pick falls back
    to gather out loud (the row payloads need the payload path)."""
    from atomo_tpu_torch.utils.comm_model import choose_aggregate, resolve_fabric

    try:
        bw = resolve_fabric(args.fabric, n_proc=hosts_in_group())
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    mode, reason = choose_aggregate(
        has_codec=True, dense_bytes=sum(a.dense_bytes for a in plan.assignments),
        payload_bytes=plan.payload_bytes(), ways=n_dev, fabric_bw=bw,
        tax_s=None if args.codec_tax_ms is None else args.codec_tax_ms / 1e3)
    if mode not in ("gather", "ring"):
        reason = (f"{mode} pick overridden — the sparse-row exchange "
                  f"needs the payload path ({reason})")
        mode = "gather"
    log(f"--aggregate auto -> {mode} (sparse-row hybrid plan: {reason})")
    return mode


def _train_aggregate(args: argparse.Namespace, codec, model, plan, n_dev: int, log) -> str:
    """The train verb's exchange: ``--aggregate`` as given, or auto resolved
    as the JAX verb resolves it over more than one device, with the JAX
    verb's refusals after it (``:2932-2990``). One device runs the
    single-device program, where the JAX verb resolves nothing: the port's
    data-parallel step at world 1 takes gather, which is that program."""
    if args.aggregate != "auto":
        return args.aggregate
    if n_dev <= 1:
        return "gather"
    if plan is not None:
        return _hybrid_auto_aggregate(args, plan, n_dev, log)
    aggregate = resolve_auto_aggregate(args, codec, model, n_dev,
                                       allow_hierarchical=args.overlap != "delayed", log=log)
    if args.overlap == "delayed" and aggregate not in ("gather", "ring"):
        raise SystemExit(
            "--overlap delayed: --aggregate auto resolved to "
            f"{aggregate!r} for this byte budget; pass "
            "--aggregate gather or ring explicitly to keep the "
            "overlapped schedule, or drop --overlap")
    if args.stream_encode == "on" and aggregate not in ("gather", "ring"):
        raise SystemExit(
            "--stream-encode: --aggregate auto resolved to "
            f"{aggregate!r} for this deployment; pass "
            "--aggregate gather or ring explicitly to keep the "
            "bucket-streamed encode, or drop --stream-encode")
    if (args.num_aggregate is not None and codec is not None
            and aggregate not in ("gather", "ring")):
        warnings.warn(
            "--num-aggregate only applies to gather/ring "
            f"aggregation; --aggregate auto resolved to "
            f"{aggregate!r} — pass --aggregate gather "
            "explicitly to subset replicas")
    return aggregate


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
        aggregate = _train_aggregate(args, codec, model, plan, n_dev, rank_log)
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
    """LM training in any of the six layouts (``cmd_lm``,
    ``atomo_tpu/cli.py:3138-3480``): on one device, or on a mesh of N
    processes, one per device, as ``torchrun --nproc-per-node N -m
    atomo_tpu_torch lm --n-devices N --layout L --ways W ...`` starts them
    (``--ways`` sizes the model axis, ``--sp-ways`` dp-tp-sp's sequence
    axis; dp = N / model ways). Rank 0 prints the JAX package's lines
    letter for letter and writes the checkpoints (a family's full tree in
    the JAX layout); every rank loads them on ``--resume``. As in the JAX
    package, a resumed run draws its batches from a fresh ``--seed`` stream
    (it does not replay the batches taken before the checkpoint) and folds
    step i's key from i. Returns this rank's final train state."""
    layout = args.layout
    if layout == "dp" and args.ways != 2:  # 2 is the default
        warnings.warn(f"--ways {args.ways} only applies to layouts with a model axis; "
                      "--layout dp is pure data parallelism — ignoring it")
    if args.sp_ways != 2 and layout != "dp-tp-sp":  # 2 is the default
        warnings.warn("--sp-ways only applies to --layout dp-tp-sp (the 2-D layouts "
                      "size their one model axis with --ways); ignoring it")
    if layout == "dp-tp-sp":
        ways_arg, ways = (args.ways, args.sp_ways), args.ways * args.sp_ways
    else:
        ways = 1 if layout == "dp" else args.ways
        ways_arg = ways
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
        dp = n_dev // ways
        if args.batch_size % n_dev and layout == "dp-ep":
            raise SystemExit(f"--batch-size {args.batch_size} must divide over all "
                             f"{n_dev} chips for dp-ep")
        if args.batch_size % dp:
            raise SystemExit(f"--batch-size {args.batch_size} not divisible by dp={dp}")
        return _lm_loop(args, n_dev, ways_arg, dp, ctx,
                        log_fn if ctx.rank == 0 else (lambda _: None))
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


def _lm_eval(args, prog, state, cfg: dict, eval_tokens, dev, dp: int, ways: int):
    """(held-out mean CE, the line's suffix) by the layout's single-device
    forward on the gathered parameters (``eval_ppl``, ``:3450-3520``), on
    rank 0, or None on the other ranks; collective for a family (its
    parameters are gathered). dp-ep evaluates at the eval batch's own
    capacity and also at the training capacity, per training-sized chunk."""
    from atomo_tpu_torch.convert import jax_leaf_order
    from atomo_tpu_torch.parallel import model_axes as MA
    from atomo_tpu_torch.parallel import moe
    from atomo_tpu_torch.training.trainer import leaf_params

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    toks = torch.from_numpy(eval_tokens[: args.batch_size]).to(dev, torch.int64)
    if prog.splits is None:
        if not rank0:
            return None
        state.model.eval()
        with torch.no_grad():
            return float(lm_loss(state.model(toks), toks)), ""
    full = MA.gather_leaves(leaf_params(state.model), prog.splits, prog.mesh)
    if not rank0:
        return None
    tree = MA.tree_of(jax_leaf_order(state.model), full)
    extra = ""
    with torch.no_grad():
        if args.layout == "dp-ep":
            logits = MA.oracle_logits(args.layout, tree, toks, cfg,
                                      capacity=moe.expert_capacity(toks.numel(),
                                                                   cfg["num_experts"]))
            chunk_b = max(1, args.batch_size // (dp * ways))
            cap_train = moe.expert_capacity(chunk_b * args.seq_len, cfg["num_experts"])
            n_full = (toks.shape[0] // chunk_b) * chunk_b
            ces = [float(lm_loss(MA.oracle_logits(args.layout, tree, toks[i:i + chunk_b], cfg,
                                                  capacity=cap_train), toks[i:i + chunk_b]))
                   for i in range(0, n_full, chunk_b)]
            if ces:
                extra = f", Loss@TrainCap: {sum(ces) / len(ces):.4f} (C={cap_train})"
        else:
            logits = MA.oracle_logits(args.layout, tree, toks, cfg)
        return float(lm_loss(logits, toks)), extra


def _lm_loop(args: argparse.Namespace, n_dev: int, ways_arg, dp: int, ctx, log_fn):
    """The steps of :func:`cmd_lm` on this rank; ``log_fn`` prints (rank 0)
    or drops (the others)."""
    from atomo_tpu_torch.mesh.spec import MeshSpec
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.parallel import model_axes as MA

    layout, dev = args.layout, ctx.device
    ways = n_dev // dp
    codec = lm_codec(args, log_fn)
    optimizer = lm_optimizer(args)
    next_batch, eval_tokens = lm_data(args)
    cfg = lm_config(args)
    aggregate = args.aggregate
    if aggregate == "ring" and codec is None:
        raise SystemExit("--aggregate ring streams CODEC payloads around the dp axis; a "
                         "dense code has no payloads to rotate — use psum (or pick a "
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
        if dp <= 1:
            raise SystemExit(
                f"--overlap delayed needs a multi-replica dp axis; "
                f"--layout {layout} at {n_dev} devices resolves to "
                "dp=1 — no dp exchange to take off the critical path")
        if aggregate == "psum":
            raise SystemExit(
                "--overlap delayed does not compose with --aggregate "
                "psum: the dense all-reduce has no encoded payload to "
                "carry between steps — use gather or ring")
    if aggregate == "auto":
        # priced over the dp axis on the UNSHARDED LM (the model axes shard
        # both sides of the ratio alike); no hierarchical: the model axes
        # own the second mesh dimension
        aggregate = resolve_auto_aggregate(args, codec, TransformerLM(**cfg), dp,
                                           allow_hierarchical=False, log=log_fn)
        if args.overlap == "delayed" and aggregate not in ("gather", "ring"):
            raise SystemExit(
                "--overlap delayed: --aggregate auto resolved to "
                f"{aggregate!r} for this byte budget; pass --aggregate "
                "gather or ring explicitly to keep the overlapped "
                "schedule, or drop --overlap")
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
    # layout-inapplicable flags: warned, not silently ignored
    defaults = {"attn_impl": "ring", "num_experts": 8, "microbatches": 2}
    applicable = {"attn_impl": ("dp-sp", "dp-tp-sp"), "num_experts": ("dp-ep",),
                  "microbatches": ("dp-pp",)}
    for flag, default in defaults.items():
        if getattr(args, flag) != default and layout not in applicable[flag]:
            warnings.warn(f"--{flag.replace('_', '-')} only applies to layout "
                          f"{'/'.join(applicable[flag])}; ignored for --layout {layout}")
    sp_size = ways if layout == "dp-sp" else (args.sp_ways if layout == "dp-tp-sp" else 1)
    if args.seq_len % sp_size:
        raise SystemExit(f"--seq-len must be divisible by sp ways={sp_size}")
    if layout == "dp-ep":
        cfg["num_experts"] = args.num_experts
    if layout == "dp-pp":
        if args.depth % ways:
            raise SystemExit(f"--depth {args.depth} must be divisible by pp ways={ways}")
        if (args.batch_size // dp) % args.microbatches:
            raise SystemExit(f"per-replica batch {args.batch_size // dp} not divisible "
                             f"by --microbatches {args.microbatches}")
    try:
        spec = MeshSpec.from_layout(layout, n_dev, ways_arg)
        prog = MA.build_model_axis_program(
            spec, cfg, optimizer, args.seed, codec, layout=layout, attn_impl=args.attn_impl,
            num_microbatches=args.microbatches, aggregate=aggregate, exchange=exchange,
            compute_dtype=torch.bfloat16 if args.bf16 else None, device=dev)
    except ValueError as e:  # sizing errors -> a clean one-liner
        raise SystemExit(str(e)) from None
    state = prog.state
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    delayed = exchange is not None and exchange.overlap == "delayed"
    start = 0
    if args.train_dir and args.resume and latest_step(args.train_dir) is not None:
        state, saved_carry = MA.load_program_checkpoint(prog, args.train_dir)
        start = state.step
        log_fn(f"Resumed from {args.train_dir} at step {start}")
        if delayed:  # the payload that step start + 1 consumes
            carry, why = carry_from_saved(prog.state.carry, saved_carry, rank, world)
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
    for i in range(start + 1, args.max_steps + 1):
        t0 = time.time()
        # every rank draws the global batch alike and takes its block
        tokens = np.ascontiguousarray(prog.shard_tokens(next_batch()))
        state, metrics = prog.step(state, fold_in(args.seed, i),
                                   torch.from_numpy(tokens).to(dev, torch.int64))
        loss = float(metrics["loss"])  # device sync: honest step timing
        if i % args.log_interval == 0 or i == args.max_steps:
            log_fn(
                f"LM: Step: {i}, Layout: {layout}({spec.describe()}), "
                f"Loss: {loss:.4f}, PPL: {math.exp(min(loss, 30.0)):.2f}, "
                f"Time Cost: {time.time() - t0:.4f}, "
                f"Msg(MB): {metrics['msg_bytes'] / 1e6:.4f}, "
                f"Dense(MB): {metrics['dense_bytes'] / 1e6:.4f}"
            )
        if args.eval_freq and i % args.eval_freq == 0:
            got = _lm_eval(args, prog, state, cfg, eval_tokens, dev, dp, ways)
            if got is not None:
                vl, extra = got
                log_fn(f"LM Validation: Step: {i}, Loss: {vl:.4f}, "
                       f"PPL: {math.exp(min(vl, 30.0)):.2f}" + extra)
        if args.train_dir and ((args.save_freq and i % args.save_freq == 0)
                               or i == args.max_steps):
            MA.save_program_checkpoint(prog, state, args.train_dir, compress=args.compress)
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
