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
``--keep-ckpts``, ``--compress``) and ``--bf16``. A process group that is up
(or a ``torchrun`` launch) takes even ``--n-devices 1`` through the
data-parallel step, which is how one card runs ``--grad-accum``.
``evaluate`` polls a checkpoint directory and prints the test metrics of
each new file. ``lm`` runs the layouts ``dp`` and ``dp-sp`` on one device or
over N processes (``--n-devices N --ways S``: dp = N/S replicas of S
sequence shards, ``--attn-impl ring|ulysses|ulysses-flash``, ``--aggregate
gather|psum|ring``), with ``--optimizer``, ``--bf16`` and checkpoints
(``--train-dir``, ``--save-freq``, ``--resume``, ``--compress``); the other
layouts, ``--stream-encode`` and ``--overlap`` come with later slices.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.data import SPECS, BatchIterator, canonical_name, load_dataset, synthetic_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.models.transformer import lm_loss
from atomo_tpu_torch.parallel import launch
from atomo_tpu_torch.parallel.lm import (
    LATER,
    DpExchange,
    create_lm_state,
    make_lm_train_step,
    shard_tokens,
)
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
    p.add_argument("--n-devices", type=int, default=1, metavar="N",
                   help="processes in the dp group, one per device (start them with "
                        "torchrun --nproc-per-node N); 1 = the single-device loop")
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
                   help="not ported yet")
    q.add_argument("--overlap", type=str, default="off", choices=["off", "delayed"],
                   help="not ported yet")
    q.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    q.set_defaults(fn=cmd_lm)
    return parser


def _dataset(args: argparse.Namespace, train: bool):
    name = canonical_name(args.dataset)
    if args.synthetic:
        return synthetic_dataset(SPECS[name], train)
    return load_dataset(name, args.data_root, train=train)


def _model_and_test_iter(args: argparse.Namespace):
    spec = SPECS[canonical_name(args.dataset)]
    test_iter = BatchIterator(_dataset(args, False), args.test_batch_size, shuffle=False,
                              drop_last=False, seed=args.seed)
    return get_model(args.network, spec.num_classes, image_shape=spec.image_shape), test_iter


def cmd_train(args: argparse.Namespace, log_fn=print):
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
    common = dict(codec=codec, augment=name.startswith("cifar") and not args.no_augment,
                  max_steps=min(args.max_steps, args.epochs * steps_per_epoch),
                  eval_freq=args.eval_freq, seed=args.seed, log_fn=log_fn,
                  log_every=args.log_interval, device=args.device,
                  train_dir=args.train_dir, save_freq=args.save_freq or args.eval_freq,
                  resume=args.resume, keep_ckpts=args.keep_ckpts, compress_ckpt=args.compress,
                  compute_dtype=torch.bfloat16 if args.bf16 else None)
    # one process runs the single-device loop unless a process group is up
    # or torchrun started it (one device over NCCL: train --n-devices 1)
    if args.n_devices <= 1 and not (dist.is_initialized() or "WORLD_SIZE" in os.environ):
        if args.grad_accum > 1:
            warnings.warn("--grad-accum is only wired into the multi-device step; "
                          "single-device training ignores it")
        return train_loop(model, optimizer, train_iter, test_iter, **common)
    was_up = torch.distributed.is_initialized()
    ctx = launch.initialize(args.device)
    try:
        if ctx.world_size != args.n_devices:
            raise SystemExit(
                f"--n-devices {args.n_devices} needs {args.n_devices} processes, one per "
                f"device; this group has {ctx.world_size}: run torchrun --nproc-per-node "
                f"{args.n_devices} -m atomo_tpu_torch train --n-devices {args.n_devices} ...")
        return distributed_train_loop(
            model, optimizer, train_iter, test_iter,
            # auto resolves to gather until the comm-cost model is ported
            aggregate="gather" if args.aggregate == "auto" else args.aggregate,
            num_aggregate=args.num_aggregate or 0, ring_bucket_size=args.ring_bucket_size,
            grad_accum=args.grad_accum, **{**common, "device": ctx.device})
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
    if args.stream_encode:
        raise SystemExit(f"--stream-encode {LATER}")
    if args.overlap != "off":
        raise SystemExit(f"--overlap {args.overlap} {LATER}")
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
    if aggregate == "auto":
        aggregate = "gather"
        log_fn("--aggregate auto -> gather (the comm-cost model that chooses among "
               "gather, psum and ring is not ported yet)")
    exchange = DpExchange(aggregate, args.ring_bucket_size) if aggregate == "ring" else None
    state = create_lm_state(lm_config(args), optimizer, args.seed, dev)
    if dist.is_initialized():
        state = replicate_state(state)
    start = 0
    if args.train_dir and args.resume and latest_step(args.train_dir) is not None:
        state = load_checkpoint(args.train_dir, state)
        start = state.step
        log_fn(f"Resumed from {args.train_dir} at step {start}")
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
            if (mesh.rank_dp, mesh.rank_sp) == (0, 0):
                save_checkpoint(args.train_dir, state, compress=args.compress)
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
