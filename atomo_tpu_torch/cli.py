"""Command line of the port: ``python -m atomo_tpu_torch train|lm ...``.

Counterpart of the ``train`` and ``lm`` verbs of ``atomo_tpu/cli.py`` on one
device, with the flags ported so far. The defaults are the JAX package's.
``lm`` runs the layouts ``dp`` and ``dp-sp`` at one replica and one sequence
shard; the other layouts, more devices, ``--bf16``, checkpoints and resume,
``--stream-encode`` and ``--overlap`` come with later slices.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
import warnings
from typing import Optional

import numpy as np
import torch

from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.data import SPECS, BatchIterator, canonical_name, load_dataset, synthetic_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.models.transformer import lm_loss
from atomo_tpu_torch.parallel.lm import create_lm_state, make_lm_train_step
from atomo_tpu_torch.training import make_optimizer, train_loop
from atomo_tpu_torch.utils.device import resolve_device
from atomo_tpu_torch.utils.rng import fold_in

TEST_BATCH_SIZE = 1000
EPOCHS = 100
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="atomo_tpu_torch",
        description="PyTorch/CUDA port of atomo_tpu (compressed SGD, one device)",
    )
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("train", help="train a model on one device")
    p.add_argument("--network", type=str, default="LeNet")
    p.add_argument("--dataset", type=str, default="MNIST")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="force the synthetic dataset (offline runs)")
    p.add_argument("--data-root", type=str, default="./data")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--code", type=str, default="sgd",
                   help="codec: sgd | svd | svd_budget | qsgd | terngrad")
    p.add_argument("--quantization-level", type=int, default=4)
    p.add_argument("--bucket-size", type=int, default=512)
    p.add_argument("--qsgd-path", type=str, default="fused", choices=["fused", "pack"],
                   help="fused = one quantize+pack kernel and one decode kernel; "
                        "pack = torch quantizer with the pack/unpack kernels")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--eval-freq", type=int, default=50)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    _svd_flags(p, "0 = rank 3 for the fixed-budget samplers (the reference's "
                  "rank-0 mode only with --sample bernoulli)")
    p.set_defaults(fn=cmd_train)

    q = sub.add_parser("lm", help="train the transformer LM on one device")
    q.add_argument("--layout", type=str, default="dp", choices=LM_LAYOUTS,
                   help="dp | dp-sp on one device; the others come with later slices")
    q.add_argument("--ways", type=int, default=2, metavar="N",
                   help="model-axis size (the sp shards of dp-sp; 1 on one device)")
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
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--lr", type=float, default=0.1)
    q.add_argument("--momentum", type=float, default=0.9)
    q.add_argument("--nesterov", action="store_true", default=False)
    q.add_argument("--weight-decay", type=float, default=0.0)
    q.add_argument("--lr-shrinkage", type=float, default=1.0)
    q.add_argument("--shrinkage-freq", type=int, default=50)
    q.add_argument("--code", type=str, default="svd")
    q.add_argument("--eval-freq", type=int, default=0,
                   help="validation PPL every N steps on held-out data; 0 = off")
    _svd_flags(q, "0 (default) = width-scaled auto rank max(2, ceil(width * 6 / 64))")
    q.add_argument("--quantization-level", type=int, default=2)
    q.add_argument("--bucket-size", type=int, default=512)
    q.add_argument("--aggregate", type=str, default="auto",
                   choices=["auto", "gather", "psum"],
                   help="dp exchange: factor gather or dense mean; auto = gather "
                        "on one device")
    q.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    q.set_defaults(fn=cmd_lm)
    return parser


def cmd_train(args: argparse.Namespace, log_fn=print):
    name = canonical_name(args.dataset)
    spec = SPECS[name]
    if args.synthetic:
        train_ds, test_ds = synthetic_dataset(spec, True), synthetic_dataset(spec, False)
    else:
        train_ds = load_dataset(name, args.data_root, train=True)
        test_ds = load_dataset(name, args.data_root, train=False)
    train_iter = BatchIterator(train_ds, args.batch_size, seed=args.seed)
    test_iter = BatchIterator(test_ds, TEST_BATCH_SIZE, shuffle=False,
                              drop_last=False, seed=args.seed)
    model = get_model(args.network, spec.num_classes, image_shape=spec.image_shape)
    optimizer = make_optimizer("sgd", lr=args.lr, momentum=args.momentum)
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
        bucket_size=args.bucket_size, sample=args.sample, algorithm=args.svd_algo,
        wire_dtype=args.svd_wire,
        use_kernel=None if fused else False, pack_kernel=None if fused else True,
    )
    if codec.name == "sgd":
        codec = None  # dense: no encode/decode in the step, as the JAX trainer
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    return train_loop(
        model, optimizer, train_iter, test_iter,
        codec=codec, augment=name.startswith("cifar"),
        max_steps=min(args.max_steps, EPOCHS * steps_per_epoch),
        eval_freq=args.eval_freq, seed=args.seed, log_fn=log_fn,
        log_every=args.log_interval, device=args.device,
    )


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


def _lm_data(args: argparse.Namespace):
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
    """LM training on one device: ``--layout dp`` or ``dp-sp`` at one
    replica and one sequence shard, with the ``LM:`` log line of the JAX
    package, letter for letter."""
    if args.layout not in ("dp", "dp-sp"):
        raise SystemExit(f"--layout {args.layout} comes with a later slice of the port; "
                         "this one runs dp and dp-sp on one device")
    if args.layout == "dp-sp" and args.ways != 1:
        raise SystemExit(f"--ways {args.ways}: sequence parallelism comes with the "
                         "multi-GPU slice; use --ways 1 on one device")
    if args.layout == "dp" and args.attn_impl != "ring":
        warnings.warn(f"--attn-impl only applies to layout dp-sp/dp-tp-sp; "
                      f"ignored for --layout {args.layout}")
    dev = resolve_device(args.device)
    codec = None
    if args.code.lower() not in DENSE_CODES:
        svd_rank = _lm_rank(args, log_fn) if args.code.lower().startswith("svd") else args.svd_rank
        codec = get_codec(
            args.code, svd_rank=svd_rank, quantization_level=args.quantization_level,
            bucket_size=args.bucket_size, sample=args.sample, algorithm=args.svd_algo,
            wire_dtype=args.svd_wire,
        )
    optimizer = make_optimizer(
        "sgd", lr=args.lr, lr_shrinkage=args.lr_shrinkage,
        shrinkage_freq=args.shrinkage_freq, momentum=args.momentum,
        nesterov=args.nesterov, weight_decay=args.weight_decay,
    )
    next_batch, eval_tokens = _lm_data(args)
    aggregate = "gather" if args.aggregate == "auto" else args.aggregate
    cfg = dict(vocab_size=args.vocab_size, max_len=args.seq_len, width=args.width,
               depth=args.depth, num_heads=args.num_heads)
    state = create_lm_state(cfg, optimizer, args.seed, dev)
    attn_impl = args.attn_impl if args.layout == "dp-sp" else "ring"
    step = make_lm_train_step(state.model, optimizer, codec, attn_impl=attn_impl,
                              aggregate=aggregate)
    for i in range(1, args.max_steps + 1):
        t0 = time.time()
        tokens = torch.from_numpy(next_batch()).to(dev, torch.int64)
        state, metrics = step(state, fold_in(args.seed, i), tokens)
        loss = float(metrics["loss"])  # device sync: honest step timing
        if i % args.log_interval == 0 or i == args.max_steps:
            log_fn(
                f"LM: Step: {i}, Layout: {args.layout}(dp1xsp1), "
                f"Loss: {loss:.4f}, PPL: {math.exp(min(loss, 30.0)):.2f}, "
                f"Time Cost: {time.time() - t0:.4f}, "
                f"Msg(MB): {metrics['msg_bytes'] / 1e6:.4f}, "
                f"Dense(MB): {metrics['dense_bytes'] / 1e6:.4f}"
            )
        if args.eval_freq and i % args.eval_freq == 0:
            state.model.eval()
            with torch.no_grad():
                toks = torch.from_numpy(eval_tokens[: args.batch_size]).to(dev, torch.int64)
                vl = float(lm_loss(state.model(toks), toks))
            log_fn(f"LM Validation: Step: {i}, Loss: {vl:.4f}, "
                   f"PPL: {math.exp(min(vl, 30.0)):.2f}")
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
