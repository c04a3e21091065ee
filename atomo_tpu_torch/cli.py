"""Command line of the port: ``python -m atomo_tpu_torch train ...``.

Counterpart of the ``train`` verb of ``atomo_tpu/cli.py`` on one device,
with the flags this slice needs. The defaults are the JAX package's.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.data import SPECS, BatchIterator, canonical_name, load_dataset, synthetic_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import make_optimizer, train_loop

TEST_BATCH_SIZE = 1000
EPOCHS = 100


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
    p.add_argument("--code", type=str, default="sgd", help="codec: sgd | qsgd | terngrad")
    p.add_argument("--quantization-level", type=int, default=4)
    p.add_argument("--bucket-size", type=int, default=512)
    p.add_argument("--qsgd-path", type=str, default="fused", choices=["fused", "pack"],
                   help="fused = one quantize+pack kernel and one decode kernel; "
                        "pack = torch quantizer with the pack/unpack kernels")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--eval-freq", type=int, default=50)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    p.set_defaults(fn=cmd_train)
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
    codec = get_codec(
        args.code, quantization_level=args.quantization_level,
        bucket_size=args.bucket_size,
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


def main(argv: Optional[list[str]] = None, log_fn=print) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "fn", None) is None:
        build_parser().print_help()
        return 2
    args.fn(args, log_fn=log_fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
