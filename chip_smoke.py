#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at full width through the CLI's own entry
point, ``python -m atomo_tpu_torch train --network ResNet18 --dataset Cifar10
--synthetic --batch-size 128 --code qsgd --quantization-level 4`` (and
``--code svd --svd-rank 3``) and ``python -m atomo_tpu_torch lm --layout
dp-sp --ways 1 --attn-impl ulysses-flash --vocab-size 256 --seq-len 1024
--width 256 --depth 4 --num-heads 4 --batch-size 16 --code svd``, and holds
every hand-written kernel against its plain PyTorch version:

1. build: ``nvcc`` compiles ``atomo_tpu_torch/csrc/*.cu`` for sm_90a, one
   process per source, all at once, while ``g++`` builds the checkpoints'
   host codec (``atomo_tpu_torch/native/lossless.cc``; timed as set-up),
   and prints what
   ``ptxas -v`` says of each flash-attention kernel (registers, spills)
   beside its shared memory;
2. check: the flash-attention kernel against its plain version at the LM
   recipe's (B 16, H 4, S 1024, D 64), on the head views the model hands it,
   causal and not (float32 max abs err <= 2e-5), at a ragged S = 1000,
   with bfloat16 inputs (within 2e-2 of the float32 plain value on the same
   inputs), and its gradients (within 5e-5); the QSGD encode as the trainer
   launches it, once over all 62 ResNet-18 leaves, and each of the four QSGD
   kernels against its plain version on the ResNet-18 shape groups' stacks,
   for bits 2/4/8 (qsgd) and 1 (terngrad): words and codes bit
   for bit, scales within rtol 1e-6, decoded values bit for bit; the
   in-kernel Philox generator bit for bit against its twin; the tree decode
   (one launch over the 62 leaves, straight into the port layout, for one
   replica and the mean of four), the tree unpack and the tree pack (one
   launch over the codes of every leaf) against
   their plain versions bit for bit at bits 1-8 and terngrad, and over the
   LM recipe's 28 leaves (embedding tables untransposed) at bits 2/4/8; the
   pack path's encode as one pass over the tree against its 17 per-group
   stacks (scales within 1 ulp, words bit for bit where scales agree); the
   mean decode over 64 seeds within 4 * scale / levels / sqrt(64) of the input
   (unbiasedness); a LeNet train step on the card against the same step on
   the CPU (TF32 off; loss rtol 1e-4, params within 1e-5 plus one
   quantization step times lr); a small LM step (width 128, depth 2) on the
   card against the same step on the CPU, and the SVD codec's decode of a
   recipe leaf on the card against the CPU given the same draws;
3. train: ResNet-18 5 steps with ``qsgd`` (then a validation pass), 2 with
   ``terngrad``, 5 with ``--code qsgd --qsgd-path pack`` and 2 with ``--code
   terngrad --qsgd-path pack`` (torch quantizer, pack/unpack kernels), 3
   with ``sgd`` (no codec, for the step-time baseline), 3 with ``svd`` at
   rank 3 (no kernel: torch linear algebra); the LM 5 steps with ``svd``
   (auto rank 24) and 3 with ``sgd``. Each run sets the launch counts to 0
   before it and reads them after; the losses must be finite and fall over
   the qsgd, qsgd pack and LM svd runs, every kernel of a run's path must
   have launched in it, the QSGD encode and decode exactly once per step
   each (one launch over the tree each way), the pack path's pack and
   unpack once per step each, its Msg(MB) the fused path's, and the flash
   kernel exactly once per layer per step;
4. time: each kernel's launches of one train step (ResNet-18 at bits 4: the
   encode's and the decode's one tree launch (the whole ``decode_tree``
   call), the pack path's one unpack and one pack launch, beside the
   per-shape-group ways they replaced, the pack kernel's bare launch and the
   pack path's whole encode; the LM's four flash launches), by CUDA events
   around the calls, median of 20, and as
   the kernels' own device time under
   ``torch.profiler``, beside the plain version's time, the bound (bytes over
   3.35 TB/s or operations over the peak of the route: 495 TFLOP/s TF32 x 3
   for the float32 flash kernel, 989 TFLOP/s bf16, 67 TFLOP/s float32 FMA,
   the larger of bytes and operations) and, for flash attention,
   ``F.scaled_dot_product_attention`` on the same tensors, for the float32
   and the bfloat16 form;
5. profile: three qsgd ResNet-18 steps (fused, then the pack path), three
   svd rank 3 steps (the canonical recipe's codec) and three svd LM steps,
   float32 and ``--bf16``, under ``torch.profiler``: wall and device-busy
   time per step, the device's idle share, each ``step.*`` phase's time, and the kernels that
   take the most;
6. check: gathered decode: the tree decode and the tree unpack over the
   rows of an (N, bytes) gathered buffer of the ResNet-18 tree at 4 bits,
   N = 2, 4, 8, read in place, against their plain versions on the same
   views and the replica-contiguous launch, bit for bit, each layout's
   device time beside the other's;
7. dist nccl-1: the data-parallel step (``parallel/replicated.py``) at NCCL
   world size 1, ResNet-18 batch 128, 3 steps each of qsgd 4 bits gather,
   svd rank 3 gather and qsgd ring, with the single-device step of the same
   codec timed the same way: the counts set to 0 before each run and read
   after (quantize_pack and unpack_dequantize once a step for qsgd), steps
   2-3 of the qsgd runs under ``set_sync_debug_mode("error")``, Msg(MB) the
   single device's; then three qsgd and three svd gather steps under the
   profiler, as in 5, with ``step.exchange`` and ``step.decode_mean``;
8. dist gloo-2: two processes on the one card over gloo (this script with
   ``--gloo-child``; NCCL refuses two ranks on one device), global batch
   128, qsgd gather and psum and svd gather, 3 steps each: the replicas
   bit-identical after every step, rank 0's decode-mean over its gathered
   buffer equal to the plain twin's, Msg(MB) the single card's (psum: the
   dense bytes); first a probe of gloo's send and receive of a CUDA tensor
   (``--gloo-p2p-probe``), which the ring would need; its outcome is
   printed, and the ring is left out of this phase (and so is an sp axis
   over gloo on the card: its hops are the same send and receive);
9. lm bf16: the LM recipe with ``--bf16`` for 5 steps: the flash kernel's
   bfloat16 form launched 20 times and nothing else, finite losses, a
   float32 state, the first loss within 1e-2 relative of the float32 run's
   (phase 3), the median step beside the float32 one;
10. ckpt: the rest of the ``train`` verb, in a child process (this script
   with ``--ckpt-child``) under ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before its
   first cuBLAS handle: the canonical recipe (``--lr 0.01 --lr-shrinkage 0.95
   --shrinkage-freq 50 --momentum 0 --code svd --svd-rank 3``) for 10 steps
   with ``--eval-freq 5 --save-freq 5``, and cut at 5 and ``--resume``d to
   10 (it must print ``Resumed from ... at step 5`` and end bit for bit
   where the first run ended); ``evaluate`` on the first run's directory
   (its ``Evaluator:`` lines equal the trainer's ``Validation:`` lines);
   ``--code qsgd --compress --keep-ckpts 2 --bf16`` for 6 steps saving every
   2 (``quantize_pack`` and ``unpack_dequantize`` once a step, two files
   left with the compressed magic, the newest loading back bit for bit);
   the save and load times of the recipe's state, raw and compressed, and
   the ops that warned; the LM recipe saved at step 3 (the file loads back
   bit for bit) and resumed to 5, equal bit for bit to the continuation the
   JAX verb runs after a resume (a fresh ``--seed`` stream, step keys folded
   with 4 and 5); ``lm nccl-1``: the LM recipe for 3 steps with an NCCL
   group of world 1 up, so that ``lm`` builds its (dp 1, sp 1) mesh over it
   and gathers the payloads with a real NCCL call, against the same run
   with no group: the states equal bit for bit, the ``LM:`` lines alike but
   for their times, the flash kernel 12 launches in each; then, in this
   process, 5 steps each of svd rank 3
   and qsgd with and without ``--bf16`` for their median step time;
11. zoo: the reference CLI's model zoo at full width. VGG-11 (BatchNorm,
   ``--network VGG11``) at batch 128 through the CLI, 5 steps each of svd
   rank 3, qsgd and sgd (qsgd: one launch a step each way over its 38
   leaves; the others none), then at NCCL world 1 ``--n-devices 1
   --aggregate gather`` svd rank 3 (Msg(MB) the single device's), and the
   single-device and world-1 steps on the same batches, codec draws and
   dropout masks (through their hooks), equal bit for bit after 2 steps;
   DenseNet-BC-190 (k 40, 569 leaves) at batch 128 through ``--n-devices 1
   --grad-accum K`` (K the smallest that fits, 1 on the H100 80GB) with qsgd
   for 3 steps and at K 2 for 2 (3 launches a step each way: the tree
   kernels of rows 1, 2 and 4 take 256 leaves a launch, row 3's persistent
   launch any number) and svd rank 3 for 2 steps, its
   encode's time per step over its 98 shape groups; rows 1-4 on DenseNet's
   real gradient tree and rows 1-2 on AlexNet's 37.7 M-value ``Dense_0``
   leaf against their plain twins (words, codes and decoded values bit for
   bit, scales within 1 ulp), with the launches of each call and the device
   time of rows 1-2 beside their bound; AlexNet at (32, 3, 224, 224)
   through ``make_train_step`` with qsgd for 2 steps; three VGG-11 svd rank
   3 steps under the profiler. Each run prints its median step and its
   peak of ``torch.cuda.max_memory_allocated``.

Prints a ``kernels`` JSON line (row 5 with its ``bf16`` form), the card's
name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero. Without a
CUDA device, or run outside the repository, it exits non-zero and prints no
result. A copy of the results goes to ``output/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM, dense TF32 on the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores
ROOT = Path(__file__).resolve().parent
REPLACES = {
    "quantize_pack": "atomo_tpu/ops/qsgd_kernels.py:215",
    "unpack_dequantize": "atomo_tpu/ops/qsgd_kernels.py:387",
    "pack_bucketed": "atomo_tpu/ops/qsgd_kernels.py:323",
    "unpack_bucketed": "atomo_tpu/ops/qsgd_kernels.py:363",
    "flash_attention": "atomo_tpu/ops/attention_kernels.py:164",
}
SOURCES = {name: "atomo_tpu_torch/csrc/qsgd_kernels.cu" for name in REPLACES}
SOURCES["flash_attention"] = "atomo_tpu_torch/csrc/flash_attention.cu"
TRAIN_ARGS = ["train", "--network", "ResNet18", "--dataset", "Cifar10", "--synthetic",
              "--batch-size", "128", "--quantization-level", "4", "--lr", "0.01",
              "--momentum", "0.9", "--seed", "1", "--log-interval", "1", "--device", "cuda",
              "--train-dir", ""]
# the canonical LM recipe (scripts/run_lm_tpu.sh) on one card
LM_DEPTH = 4
LM_SHAPE = (16, 4, 1024, 64)  # (B, H, S, D) the flash kernel sees
LM_ARGS = ["lm", "--layout", "dp-sp", "--ways", "1", "--attn-impl", "ulysses-flash",
           "--vocab-size", "256", "--seq-len", "1024", "--width", "256", "--depth",
           str(LM_DEPTH), "--num-heads", "4", "--batch-size", "16", "--lr", "0.1",
           "--momentum", "0.9", "--seed", "0", "--log-interval", "1", "--device", "cuda"]


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 10, tries: int = 2) -> float:
    """Milliseconds a call of ``fn()`` keeps the card busy in kernels whose
    name holds ``kernel``, from ``torch.profiler`` over ``reps`` calls. A
    session that records no device activity at all is taken again, once
    (one such session in a run of dozens has been seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
        if us > 0:
            return us / 1e3 / reps
    raise AssertionError(f"the profiler saw no device time of {kernel!r} in {tries} sessions")


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time of the work: bytes over the memory rate or operations
    over ``ops_per_s``, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------- phases


def phase_build():
    from atomo_tpu_torch.ops import _build

    from atomo_tpu_torch.native import lossless

    t0 = time.time()
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    handles = [_build.start_build(n) for n in names]
    lossless.decompress(lossless.compress(b""))  # the host codec's g++ runs beside nvcc
    for h in handles:
        _build.finish_build(h)
    for n in names:
        _build.load(n)
    log(f"build: {names} and the host codec in {time.time() - t0:.1f} s")
    from atomo_tpu_torch.ops import attention_kernels as A

    for line in ptxas_flash(_build.ptxas_report("flash_attention"), A._lib()):
        log(line)


def ptxas_flash(report: str, lib) -> list[str]:
    """One line per flash-attention kernel: what ``ptxas -v`` says of it and
    the dynamic shared memory its launch asks for."""
    import ctypes
    import re

    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\S*flash_forward_kernelI"
                      r"(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            cur = None
        if m:
            dtype = "float32" if m[1] == "f" else "bfloat16"
            smem = lib.flash_attention_smem_bytes(int(m[2]), 0 if m[1] == "f" else 1)
            cur = [f"ptxas flash_forward_kernel {dtype} D {m[2]}, {m[3]} warpgroups, "
                   f"{m[4]}-key tiles, {smem} bytes dynamic shared memory"]
            out.append(cur)
        elif cur is not None and ("spill" in line or "registers" in line):
            cur.append(line.split(":")[-1].strip())
    if not out:
        raise AssertionError("ptxas reported no flash_forward_kernel")
    return [": ".join([c[0], ", ".join(c[1:])]) for c in out]


def resnet_grads(device, seed: int = 0):
    """Gradient-like tensors of ResNet-18's 62 leaves, each leaf at its own
    scale: the port-layout leaves, the flat JAX-layout leaves the encode's
    tree launch takes, and the (L, n) stacks of the shape groups."""
    import torch

    from atomo_tpu_torch.codecs import stack_leaves
    from atomo_tpu_torch.convert import jax_view
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training.trainer import leaf_params

    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    gen = torch.Generator(device=device).manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen, device=device) * (0.01 * (1 + i % 7))
             for i, p in enumerate(leaf_params(model))]
    leaves = [jax_view(g).reshape(-1) for g in grads]
    return grads, leaves, [(idxs, x) for idxs, x in stack_leaves(grads)]


def lm_grads(device, seed: int = 0):
    """Gradient-like tensors of the LM recipe's 28 leaves (port layout) and
    their layouts (embedding tables untransposed)."""
    import torch

    from atomo_tpu_torch.convert import jax_layouts
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.training.trainer import leaf_params

    model = TransformerLM(vocab_size=256, max_len=LM_SHAPE[2], width=256, depth=LM_DEPTH,
                          num_heads=4)
    gen = torch.Generator(device=device).manual_seed(seed)
    return ([torch.randn(p.shape, generator=gen, device=device) * 0.01
             for p in leaf_params(model)], jax_layouts(model))


def same_bits(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def phase_check(leaves, stacks, errs):
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, terngrad
    from atomo_tpu_torch.ops import qsgd_kernels as K

    dev = stacks[0][1].device
    gen = torch.Generator(device=dev).manual_seed(7)
    for codec in (QsgdCodec(bits=2), QsgdCodec(bits=4), QsgdCodec(bits=8), terngrad()):
        bits, scheme = codec.bits, codec.scheme
        tree = [codec._clip_leaf(x) for x in leaves]
        u = [torch.rand((K.geometry(x.numel(), bits).n_buckets, 512), generator=gen, device=dev)
             for x in tree]
        for kw in (dict(u=u), dict(seeds=[1000003 * (i + 1) + bits for i in range(len(tree))])):
            got = K.quantize_pack_tree(tree, bits=bits, scheme=scheme, **kw)
            want = K.quantize_pack_tree_plain(tree, bits=bits, scheme=scheme, **kw)
            for (wk, sk), (wp, sp) in zip(got, want):
                if not same_bits(wk, wp):
                    raise AssertionError(f"quantize_pack_tree words differ: bits {bits} "
                                         f"{scheme} {list(kw)}")
                torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
                errs["quantize_pack"] = max(errs["quantize_pack"], float((sk - sp).abs().max()))
        for idxs, x in stacks:
            x = codec._clip(x)
            L, n = x.shape
            g = K.geometry(n, bits, codec.bucket_size)
            u = torch.rand((L, g.n_buckets, g.bucket_size), generator=gen, device=dev)
            seeds = [1000003 * (i + 1) + bits for i in idxs]
            for kw in (dict(u=u), dict(seeds=seeds)):
                wk, sk = K.quantize_pack(x, bits=bits, scheme=scheme, **kw)
                wp, sp = K.quantize_pack_plain(x, bits=bits, scheme=scheme, **kw)
                if not same_bits(wk, wp):
                    raise AssertionError(f"quantize_pack words differ: bits {bits} "
                                         f"{scheme} shape {tuple(x.shape)} {list(kw)}")
                torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
                errs["quantize_pack"] = max(errs["quantize_pack"],
                                            float((sk - sp).abs().max()))
                dk = K.unpack_dequantize(wk, sk, bits=bits, n=n)
                dp = K.unpack_dequantize_plain(wk, sk, bits=bits, n=n)
                errs["unpack_dequantize"] = max(errs["unpack_dequantize"],
                                                float((dk - dp).abs().max()))
                if not torch.equal(dk, dp):
                    raise AssertionError(f"unpack_dequantize differs: bits {bits}")
                rows = wk.reshape(-1, g.n_words)
                ck = K.unpack_bucketed(rows, bits)
                cp = K.unpack_bucketed_plain(rows, bits)
                errs["unpack_bucketed"] = max(errs["unpack_bucketed"],
                                              float((ck - cp).abs().max()))
                if not torch.equal(ck, cp):
                    raise AssertionError(f"unpack_bucketed differs: bits {bits}")
                pk = K.pack_bucketed(ck, bits)
                pp = K.pack_bucketed_plain(ck, bits)
                diff = (pk.view(torch.int32).long() - pp.view(torch.int32).long()).abs()
                errs["pack_bucketed"] = max(errs["pack_bucketed"], float(diff.max()))
                if not (same_bits(pk, pp) and same_bits(pk, rows)):
                    raise AssertionError(f"pack_bucketed differs: bits {bits}")
        torch.cuda.synchronize()
        log(f"check: bits {bits} {scheme}: the encode's tree launch over {len(leaves)} "
            f"leaves and the kernels on {len(stacks)} shape groups equal their plain versions")


def replica_payloads(codec, grads, n_replicas: int, layouts=None):
    """Per leaf, the (words, scales) of ``n_replicas`` encodes of ``grads``
    (keys 100, 101, ...), on a leading replica axis above one replica."""
    import torch

    from atomo_tpu_torch.codecs import encode_tree

    reps = [encode_tree(codec, 100 + r, grads, layouts=layouts)[0] for r in range(n_replicas)]
    if n_replicas == 1:
        return [(p.words, p.scales) for p in reps[0]]
    return [(torch.stack([p.words.view(torch.int32) for p in ps]).view(torch.uint32),
             torch.stack([p.scales for p in ps])) for ps in zip(*reps)]


def check_tree_pack(codes, words, bits, errs, label):
    """The tree pack (one launch over the codes of every leaf) against its
    plain twin and the words the codes came from, bit for bit."""
    import torch

    from atomo_tpu_torch.ops import qsgd_kernels as K

    rows = [w.numel() // w.shape[-1] for w in words]
    got = K.pack_bucketed_tree(codes, rows, bits=bits)
    want = K.pack_bucketed_tree_plain(codes, rows, bits=bits)
    flat = torch.cat([w.reshape(-1, w.shape[-1]).view(torch.int32) for w in want])
    errs["pack_bucketed"] = max(errs["pack_bucketed"], float(
        (torch.cat([w.view(torch.int32) for w in got]).long() - flat.long()).abs().max()))
    if not all(same_bits(a, b) and same_bits(b, w.reshape(b.shape))
               for a, b, w in zip(got, want, words)):
        raise AssertionError(f"pack_bucketed_tree differs: {label}")


def phase_check_decode(grads, errs):
    """The tree decode (one launch, straight into the port layout), the
    tree unpack (one launch) and the tree pack (one launch) against their
    plain twins, bit for bit: over ResNet-18's 62
    leaves at bits 1-8 and terngrad, for one replica and the mean of four,
    and over the LM recipe's 28 leaves."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, terngrad
    from atomo_tpu_torch.ops import qsgd_kernels as K

    lm, lm_layouts = lm_grads(grads[0].device, seed=11)
    cases = [(QsgdCodec(bits=b), grads, None, f"ResNet-18 bits {b}") for b in range(1, 9)]
    cases += [(terngrad(), grads, None, "ResNet-18 terngrad")]
    cases += [(QsgdCodec(bits=b), lm, lm_layouts, f"LM bits {b}") for b in (2, 4, 8)]
    for codec, tree, layouts, label in cases:
        bits = codec.bits
        for n_rep in (1, 4):
            payloads = replica_payloads(codec, tree, n_rep, layouts)
            got = K.unpack_dequantize_tree(payloads, tree, layouts, bits=bits, n_replicas=n_rep)
            want = K.unpack_dequantize_tree_plain(payloads, tree, layouts, bits=bits,
                                                  n_replicas=n_rep)
            words = [w for w, _ in payloads]
            codes = K.unpack_bucketed_tree(words, bits=bits)
            codes_plain = K.unpack_bucketed_tree_plain(words, bits=bits)
            check_tree_pack(codes, words, bits, errs, f"{label}, {n_rep} replicas")
            errs["unpack_dequantize"] = max([errs["unpack_dequantize"]] + [
                float((a - b).abs().max()) for a, b in zip(got, want) if a.numel()])
            errs["unpack_bucketed"] = max(errs["unpack_bucketed"],
                                          float((codes - codes_plain).abs().max()))
            for i, (a, b, g) in enumerate(zip(got, want, tree)):
                if not (a.shape == g.shape and a.is_contiguous() and torch.equal(a, b)):
                    raise AssertionError(f"unpack_dequantize_tree differs: {label}, "
                                         f"{n_rep} replicas, leaf {i} {tuple(g.shape)}")
            if not torch.equal(codes, codes_plain):
                raise AssertionError(f"unpack_bucketed_tree differs: {label}, {n_rep} replicas")
        torch.cuda.synchronize()
        log(f"check: {label}: the tree decode over {len(tree)} leaves (1 and 4 replicas), "
            f"the tree unpack and the tree pack equal their plain versions")


def gathered_payloads(codec, grads, n_replicas: int):
    """``n_replicas`` encodes of ``grads`` (keys 100, 101, ...) packed rank
    by rank and stacked as ``all_gather_into_tensor`` leaves them: per leaf
    (words, scales) views of the (N, bytes) buffer, and the same payloads
    laid out replica after replica."""
    import torch

    from atomo_tpu_torch.codecs import encode_tree
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets

    reps = [encode_tree(codec, 100 + r, grads)[0] for r in range(n_replicas)]
    packed = [pack_tree_buckets(p) for p in reps]
    views = unpack_tree_buckets(torch.stack([b for b, _ in packed]), packed[0][1])
    return [(v.words, v.scales) for v in views], replica_payloads(codec, grads, n_replicas)


def phase_check_gathered(grads, errs):
    """Rows 2 and 4 over the rows of an (N, bytes) gathered buffer of the
    ResNet-18 tree at 4 bits, N = 2, 4, 8, read in place: the tree decode
    and the tree unpack each equal their plain twins on the same views and
    the replica-contiguous launch, bit for bit; each layout's device time."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec
    from atomo_tpu_torch.ops import qsgd_kernels as K

    bits, out = 4, {}
    for n in (2, 4, 8):
        views, contiguous = gathered_payloads(QsgdCodec(bits=bits), grads, n)
        got = K.unpack_dequantize_tree(views, grads, bits=bits, n_replicas=n)
        twin = K.unpack_dequantize_tree_plain(views, grads, bits=bits, n_replicas=n)
        cont = K.unpack_dequantize_tree(contiguous, grads, bits=bits, n_replicas=n)
        errs["unpack_dequantize"] = max([errs["unpack_dequantize"]] + [
            float((a - b).abs().max()) for a, b in zip(got, twin) if a.numel()])
        if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, twin, cont)):
            raise AssertionError(f"gathered decode differs at N = {n}")
        vw, cw = [w for w, _ in views], [w for w, _ in contiguous]
        codes = K.unpack_bucketed_tree(vw, bits=bits)
        codes_twin = K.unpack_bucketed_tree_plain(vw, bits=bits)
        errs["unpack_bucketed"] = max(errs["unpack_bucketed"],
                                      float((codes - codes_twin).abs().max()))
        if not (torch.equal(codes, codes_twin)
                and torch.equal(codes, K.unpack_bucketed_tree(cw, bits=bits))):
            raise AssertionError(f"gathered unpack differs at N = {n}")
        t = {
            "decode_gathered_ms": device_ms(lambda: K.unpack_dequantize_tree(
                views, grads, bits=bits, n_replicas=n), "unpack_dequantize_tree_kernel"),
            "decode_contiguous_ms": device_ms(lambda: K.unpack_dequantize_tree(
                contiguous, grads, bits=bits, n_replicas=n), "unpack_dequantize_tree_kernel"),
            "unpack_gathered_ms": device_ms(lambda: K.unpack_bucketed_tree(vw, bits=bits),
                                            "unpack_codes_tree_kernel"),
            "unpack_contiguous_ms": device_ms(lambda: K.unpack_bucketed_tree(cw, bits=bits),
                                              "unpack_codes_tree_kernel"),
        }
        out[n] = t
        log(f"check: gathered decode N = {n}: the tree decode and the tree unpack over the "
            f"(N, bytes) buffer's rows equal their plain versions and the replica-contiguous "
            f"launch bit for bit; device ms: decode {t['decode_gathered_ms']:.4f} gathered, "
            f"{t['decode_contiguous_ms']:.4f} contiguous; unpack {t['unpack_gathered_ms']:.4f} "
            f"gathered, {t['unpack_contiguous_ms']:.4f} contiguous")
    torch.cuda.synchronize()
    return out


def phase_check_pack_encode(grads):
    """The pack path's encode as one pass over the tree against the
    per-shape-group stacks it replaced, on the card (same seeds): the
    quantizer's reductions may round a bucket's scale differently over
    21,847 rows than over a group's, so scales must agree within 1 ulp and
    words bit for bit wherever the scales are equal; the rows and fields
    that differ are counted."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, encode_tree, terngrad
    from atomo_tpu_torch.codecs.base import _views, encode_groups
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.utils.rng import fold_in

    for codec in (QsgdCodec(bits=4, use_kernel=False), terngrad(use_kernel=False)):
        tree, _ = encode_tree(codec, 3, grads)
        groups = encode_groups(codec, _views(grads, None),
                               [fold_in(3, i) for i in range(len(grads))])
        rows = diff_rows = diff_fields = 0
        worst = 0.0
        for a, b in zip(tree, groups):
            big = torch.maximum(a.scales.abs(), b.scales.abs())
            ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
            worst = max(worst, float(((a.scales - b.scales).abs() / ulp).max()))
            same = a.scales == b.scales
            wa, wb = a.words.view(torch.int32), b.words.view(torch.int32)
            if not torch.equal(wa[same], wb[same]):
                raise AssertionError(f"{codec.name} pack encode: words differ at equal scales")
            g = K.geometry(0, codec.bits)._replace(n_words=wa.shape[1])
            diff_fields += int((K._split_fields(wa, g) != K._split_fields(wb, g)).sum())
            rows += same.numel()
            diff_rows += int((~same).sum())
        if not worst <= 1.0:
            raise AssertionError(f"{codec.name} pack encode: scales {worst} ulp apart")
        log(f"check: {codec.name} {codec.bits} bits pack path, one pass over the tree vs 17 "
            f"per-group stacks: scales differ in {diff_rows} of {rows} rows (at most "
            f"{worst:.0f} ulp), {diff_fields} fields differ, words equal where scales are")


def phase_unbiased(stacks, trials: int = 64):
    import torch

    from atomo_tpu_torch.ops import qsgd_kernels as K

    for bits in (2, 4, 8):
        worst = 0.0
        levels = (1 << bits) - 1
        for idxs, x in stacks:
            L, n = x.shape
            acc = torch.zeros((L, n), dtype=torch.float64, device=x.device)
            for t in range(trials):
                w, s = K.quantize_pack(x, bits=bits, seeds=[t * 7919 + i for i in idxs])
                acc += K.unpack_dequantize(w, s, bits=bits, n=n).double()
            per = s.double().repeat_interleave(512, dim=1)[:, :n]
            lim = 4 * per / levels / math.sqrt(trials)
            ratio = float(((acc / trials - x.double()).abs() / lim.clamp_min(1e-30)).max())
            worst = max(worst, ratio)
        if not worst <= 1.0:
            raise AssertionError(f"bits {bits}: mean decode off by {worst:.3f} of the bound")
        log(f"unbiased: bits {bits}: worst |mean decode - x| = {worst:.3f} of "
            f"4*scale/levels/sqrt({trials})")


def phase_reference():
    """A LeNet qsgd step on the card against the same step on the CPU."""
    import copy

    import torch

    from atomo_tpu_torch.codecs import QsgdCodec
    from atomo_tpu_torch.convert import jax_view
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step
    from atomo_tpu_torch.training.trainer import leaf_params

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        spec = SPECS["mnist"]
        images, labels = next(BatchIterator(synthetic_dataset(spec, True, size=64), 16).epoch())
        lr = 0.05
        opt = make_optimizer("sgd", lr=lr, momentum=0.9)
        codec = QsgdCodec(bits=4)
        base = get_model("lenet", 10, image_shape=spec.image_shape)
        cpu = create_state(base, opt, 3, "cpu")
        gpu = create_state(copy.deepcopy(base).cpu(), opt, 3, "cuda")
        gen = torch.Generator().manual_seed(5)
        uniforms = [torch.rand((K.geometry(p.numel(), 4).n_buckets, 512), generator=gen)
                    for p in leaf_params(base)]
        res = {}
        for name, state in (("cpu", cpu), ("cuda", gpu)):
            step = make_train_step(state.model, opt, codec=codec)
            u = [t.to(name) for t in uniforms]
            _, m = step(state, 4, *to_device(images, labels, name), uniforms=u)
            res[name] = (float(m["loss"]), [jax_view(p).detach().cpu() for p in
                                            leaf_params(state.model)])
        max_scale = max(float(codec.encode(0, p.grad).scales.max())
                        for p in leaf_params(cpu.model))
        if not math.isclose(res["cpu"][0], res["cuda"][0], rel_tol=1e-4):
            raise AssertionError(f"loss cpu {res['cpu'][0]} vs cuda {res['cuda'][0]}")
        worst = max(float((a - b).abs().max()) for a, b in zip(res["cpu"][1], res["cuda"][1]))
        # one quantization step of the largest bucket scale, times lr
        limit = 1e-5 + lr * max_scale / 15
        if not worst <= limit:
            raise AssertionError(f"params cpu vs cuda {worst} > {limit}")
        log(f"reference: LeNet qsgd step, cuda vs cpu: loss {res['cuda'][0]:.6f} vs "
            f"{res['cpu'][0]:.6f}, max |param diff| {worst:.3e}")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def lm_heads(shape=LM_SHAPE, dtype=None, seed: int = 0):
    """q, k, v as the LM hands them to the kernel: (B, H, S, D) views of one
    (B, S, 3*H*D) projection, strided, not copied."""
    import torch

    b, h, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
    if dtype is not None:
        qkv = qkv.to(dtype)
    return [t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]


def phase_flash_check(errs):
    """The flash kernel against its plain version, at the LM recipe's shape
    and the blocks the path gives it (512)."""
    import torch

    from atomo_tpu_torch.ops import attention_kernels as A

    blk = dict(block_q=512, block_k=512)
    cases = [("recipe", LM_SHAPE, True), ("recipe", LM_SHAPE, False),
             ("ragged", (4, 4, 1000, 64), True), ("ragged", (4, 4, 1000, 64), False)]
    for label, shape, causal in cases:
        q, k, v = lm_heads(shape, seed=1)
        err = float((A.flash_attention_forward(q, k, v, causal=causal, **blk)
                     - A.flash_attention_plain(q, k, v, causal=causal, **blk)).abs().max())
        errs["flash_attention"] = max(errs["flash_attention"], err)
        if not err <= 2e-5:
            raise AssertionError(f"flash {label} {shape} causal={causal}: max abs err {err}")
        log(f"check: flash {label} {shape} causal={causal}: max abs err {err:.3e} (<= 2e-5)")
    q, k, v = lm_heads(dtype=torch.bfloat16, seed=2)
    got = A.flash_attention_forward(q, k, v, causal=True, **blk)
    want = A.flash_attention_plain(q.float(), k.float(), v.float(), causal=True, **blk)
    err = float((got.float() - want).abs().max())
    if got.dtype != torch.bfloat16 or not err <= 2e-2:
        raise AssertionError(f"flash bf16: {got.dtype}, max abs err {err}")
    errs["flash_attention_bf16"] = err
    log(f"check: flash bf16 inputs: max abs err {err:.3e} against float32 (<= 2e-2)")
    for causal in (True, False):
        grads = []
        for fn in (A.flash_attention, A.flash_attention_plain):
            q, k, v = (t.detach().requires_grad_() for t in lm_heads(seed=3))
            w = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(4),
                            device="cuda")
            (fn(q, k, v, causal=causal, **blk) * w).sum().backward()
            grads.append([q.grad, k.grad, v.grad])
        err = max(float((a - b).abs().max()) for a, b in zip(*grads))
        if not err <= 5e-5:
            raise AssertionError(f"flash gradients causal={causal}: max abs err {err}")
        log(f"check: flash gradients causal={causal}: max abs err {err:.3e} (<= 5e-5)")


def phase_reference_lm():
    """A small LM step (sgd) on the card against the same step on the CPU,
    and one recipe leaf's SVD encode/decode on the card against the CPU
    given the same draws. TF32 off; loss rtol 1e-4, params atol 1e-5, the
    decoded leaf within 1e-4 of its Frobenius norm: the Gram eigh squares
    the spectrum, so atoms from the sketch's noise floor, which the sampler
    does draw, carry the two solvers' float32 differences: an entrywise rtol
    1e-4 plus 1e-5 of the leaf's largest entry did not hold on the card."""
    import copy

    import torch

    from atomo_tpu_torch.codecs import SvdCodec
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.parallel.lm import make_lm_train_step
    from atomo_tpu_torch.training import create_state, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dict(vocab_size=256, max_len=256, width=128, depth=2, num_heads=2)
        opt = make_optimizer("sgd", lr=0.1, momentum=0.9)
        base = TransformerLM(**cfg)
        tokens = torch.randint(0, 256, (4, 256), generator=torch.Generator().manual_seed(6))
        res = {}
        for dev in ("cpu", "cuda"):
            state = create_state(copy.deepcopy(base), opt, 5, dev)
            step = make_lm_train_step(state.model, opt, None, attn_impl="ulysses-flash")
            _, m = step(state, 1, tokens.to(dev))
            res[dev] = (float(m["loss"]), [p.detach().cpu() for p in leaf_params(state.model)])
        worst = max(float((a - b).abs().max()) for a, b in zip(res["cpu"][1], res["cuda"][1]))
        if not (math.isclose(res["cpu"][0], res["cuda"][0], rel_tol=1e-4) and worst <= 1e-5):
            raise AssertionError(f"LM step cpu vs cuda: loss {res['cpu'][0]} vs "
                                 f"{res['cuda'][0]}, params {worst}")
        log(f"reference: LM step (width 128, depth 2), cuda vs cpu: loss {res['cuda'][0]:.6f} "
            f"vs {res['cpu'][0]:.6f}, max |param diff| {worst:.3e}")

        codec, shape = SvdCodec(rank=24), (256, 768)  # an LM qkv leaf, randomized
        _, n = codec._dims(shape)
        gen = torch.Generator().manual_seed(8)
        # a gradient-like leaf: a geometric spectrum (0.7^i) over a 1e-3 noise floor
        u, _ = torch.linalg.qr(torch.randn((shape[0], 256), generator=gen, dtype=torch.float64))
        v, _ = torch.linalg.qr(torch.randn((shape[1], 256), generator=gen, dtype=torch.float64))
        x = ((u * 0.7 ** torch.arange(256)) @ v.T).float()
        x += 1e-3 * torch.randn(shape, generator=gen)
        sk = codec.rank + codec.oversample
        draws = {"sketch": torch.randn((n, sk), generator=gen),
                 "gumbel": -torch.log(-torch.log(torch.rand((codec.rank, sk), generator=gen))),
                 "probes": (torch.randint(0, 2, (n, codec.residual_probes), generator=gen)
                            * 2 - 1).float()}
        dec = {dev: codec.decode(codec.encode(0, x.to(dev), draws=draws), shape).cpu()
               for dev in ("cpu", "cuda")}
        err = float((dec["cuda"] - dec["cpu"]).abs().max())
        rel = float(torch.linalg.norm(dec["cuda"] - dec["cpu"]) / torch.linalg.norm(dec["cpu"]))
        if not rel <= 1e-4:
            raise AssertionError(f"svd decode cpu vs cuda: relative Frobenius diff {rel}")
        log(f"reference: svd rank 24 decode of a {shape} leaf, cuda vs cpu: relative "
            f"Frobenius diff {rel:.3e} (<= 1e-4), max abs diff {err:.3e}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def run_cli(argv, expect, prefix="Worker: "):
    """One CLI run with every launch count set to 0 before and read after;
    ``prefix`` marks the per-step log lines."""
    import torch

    from atomo_tpu_torch import cli, ops

    lines: list[str] = []
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rc = cli.main(argv, log_fn=lambda ln: (lines.append(ln), log("  " + ln)))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    worker = [ln for ln in lines if ln.startswith(prefix)]
    losses = [float(ln.split("Loss: ")[1].split(",")[0]) for ln in worker]
    step_s = [float(ln.split("Time Cost: ")[1].split(",")[0]) for ln in worker]
    msg_mb = sorted({float(ln.split("Msg(MB): ")[1].split(",")[0]) for ln in worker})
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite or missing losses {losses}")
    for name in expect:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched in {argv}: {counts}")
    for ln in lines:
        if ln.startswith(("Validation: ", "LM Validation: ")):
            if not all(math.isfinite(float(v.split(",")[0])) for v in ln.split(": ")[2:]):
                raise AssertionError(f"bad validation line {ln}")
    return {"losses": losses, "step_ms": [1e3 * s for s in step_s], "launches": counts,
            "msg_mb": msg_mb, "wall_s": wall, "lines": len(lines),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_train():
    qsgd = ["quantize_pack", "unpack_dequantize"]
    runs = {
        "qsgd": run_cli(TRAIN_ARGS + ["--code", "qsgd", "--max-steps", "5", "--eval-freq", "5"],
                        qsgd),
        "terngrad": run_cli(TRAIN_ARGS + ["--code", "terngrad", "--max-steps", "2",
                                          "--eval-freq", "0"], qsgd),
        "qsgd_pack": run_cli(TRAIN_ARGS + ["--code", "qsgd", "--qsgd-path", "pack",
                                           "--max-steps", "5", "--eval-freq", "0"],
                             ["pack_bucketed", "unpack_bucketed"]),
        "terngrad_pack": run_cli(TRAIN_ARGS + ["--code", "terngrad", "--qsgd-path", "pack",
                                               "--max-steps", "2", "--eval-freq", "0"],
                                 ["pack_bucketed", "unpack_bucketed"]),
        "sgd": run_cli(TRAIN_ARGS + ["--code", "sgd", "--max-steps", "3", "--eval-freq", "0"],
                       []),
        "svd3": run_cli(TRAIN_ARGS + ["--code", "svd", "--svd-rank", "3", "--max-steps", "3",
                                      "--eval-freq", "0"], []),
        "lm_svd": run_cli(LM_ARGS + ["--code", "svd", "--max-steps", "5"], ["flash_attention"],
                          prefix="LM: "),
        "lm_sgd": run_cli(LM_ARGS + ["--code", "sgd", "--max-steps", "3"], ["flash_attention"],
                          prefix="LM: "),
    }
    for name in ("qsgd", "qsgd_pack", "lm_svd"):
        q = runs[name]["losses"]
        if not q[-1] < q[0]:
            raise AssertionError(f"{name} loss did not fall: {q}")
    for name, steps in (("qsgd", 5), ("terngrad", 2)):  # one launch a step each way
        counts = runs[name]["launches"]
        if counts["quantize_pack"] != steps or counts["unpack_dequantize"] != steps:
            raise AssertionError(f"{name}: launches {counts}, want quantize_pack and "
                                 f"unpack_dequantize {steps} (one over the tree a step)")
    for name, steps in (("qsgd_pack", 5), ("terngrad_pack", 2)):  # one launch a step each way
        counts = runs[name]["launches"]
        if counts["unpack_bucketed"] != steps or counts["pack_bucketed"] != steps:
            raise AssertionError(f"{name}: launches {counts}, want unpack_bucketed and "
                                 f"pack_bucketed {steps} (one over the tree a step)")
    for fused, pack in (("qsgd", "qsgd_pack"), ("terngrad", "terngrad_pack")):
        if runs[fused]["msg_mb"] != runs[pack]["msg_mb"] or len(runs[pack]["msg_mb"]) != 1:
            raise AssertionError(f"Msg(MB) {fused} {runs[fused]['msg_mb']} vs {pack} "
                                 f"{runs[pack]['msg_mb']}")
    for name in ("sgd", "svd3"):  # no kernel on these paths
        if any(runs[name]["launches"].values()):
            raise AssertionError(f"{name} run launched kernels: {runs[name]['launches']}")
    for name, steps in (("lm_svd", 5), ("lm_sgd", 3)):
        counts = runs[name]["launches"]
        if counts["flash_attention"] != LM_DEPTH * steps or sum(counts.values()) != \
                counts["flash_attention"]:
            raise AssertionError(f"{name}: launches {counts}, want flash_attention "
                                 f"{LM_DEPTH} x {steps} and nothing else")
    for name, r in runs.items():
        steady = r["step_ms"][1:] or r["step_ms"]
        r["median_step_ms_after_first"] = statistics.median(steady)
        log(f"train {name}: losses {r['losses']} launches {r['launches']} "
            f"median step ms (after the first) {r['median_step_ms_after_first']:.3f}")
    return runs


def phase_time(grads, leaves, stacks):
    """Each QSGD kernel's launches of one ResNet-18 train step at bits 4: the
    encode's one launch over the 62 leaves (the seeds computed once, as
    ``encode_tree`` hands them over), the decode's one launch (the whole
    ``decode_tree`` call, straight into the port layout), the pack path's one
    unpack launch and one pack launch over the tree. Two times per kernel:
    the CUDA-event wall around the calls (host work and launches included)
    and the kernels' own device time from ``torch.profiler``. Beside the
    decode and the unpack, the per-shape-group way they replaced, in the
    same call: per shape group a stack of the payloads, a launch and
    (decode) each leaf's copy into the port layout. Beside the pack, the
    per-group way it replaced (17 launches, one per shape group's stack),
    the kernel's bare launch (no checks, no views), and the pack path's
    whole encode as one pass over the tree and as 17 per-group stacks."""
    import dataclasses

    from atomo_tpu_torch.codecs import QsgdCodec, decode_tree, encode_tree
    from atomo_tpu_torch.codecs.base import _decode_groups, _views, encode_groups
    from atomo_tpu_torch.ops import qsgd_kernels as K

    bits = 4
    seeds = [17 + i for i in range(len(leaves))]
    tree = K.quantize_pack_tree(leaves, bits=bits, seeds=seeds)
    enc = []
    for idxs, x in stacks:
        L, n = x.shape
        g = K.geometry(n, bits)
        w, s = K.quantize_pack(x, bits=bits, seeds=[17 + i for i in idxs])
        codes = K.unpack_bucketed(w.reshape(-1, g.n_words), bits)
        enc.append((x, g, w, s, codes))
    fused = QsgdCodec(bits=bits)
    pack = dataclasses.replace(fused, use_kernel=False)
    payloads, _ = encode_tree(fused, 17, grads)
    pack_payloads, _ = encode_tree(pack, 17, grads)
    pairs = [(p.words, p.scales) for p in payloads]
    words = [p.words for p in payloads]
    codes = K.unpack_bucketed_tree(words, bits=bits)  # the tree's codes, as the pack path has them
    rows = [w.shape[0] for w in words]
    views = _views(grads, None)

    def each(fn):
        return lambda: [fn(*e) for e in enc]

    def per_group(codec, ps):
        return lambda: _decode_groups(codec, ps, grads, None,
                                      lambda p, n, shape: codec.decode_stack(p, n, shape=shape))

    n_words = sum(w.numel() for w in words)
    n_scales = sum(p.scales.numel() for p in payloads)
    n_values = sum(g.numel() for g in grads)
    n_codes = n_words * K.geometry(0, bits).vpw
    work = {
        "quantize_pack": (
            lambda: K.quantize_pack_tree(leaves, bits=bits, seeds=seeds),
            lambda: K.quantize_pack_tree_plain(leaves, bits=bits, seeds=seeds),
            "quantize_pack_kernel",
            # read x and the seeds, write words and scales
            sum(x.numel() * 4 + 8 + w.numel() * 4 + s.numel() * 4
                for x, (w, s) in zip(leaves, tree)),
            # per padded position: 2 for the scale, 7 for the rounding
            # (abs, div, mul, floor, sub, compare, add), 2 to code; Philox
            # 10 rounds of ~8 integer operations per 4 positions
            sum(w.numel() * K.geometry(x.numel(), bits).vpw * (11 + 20)
                for x, (w, s) in zip(leaves, tree)),
            1, {},
        ),
        "unpack_dequantize": (
            lambda: decode_tree(fused, payloads, grads),
            lambda: K.unpack_dequantize_tree_plain(pairs, grads, bits=bits),
            "unpack_dequantize_tree_kernel",
            # read words and scales, write the values
            4 * (n_words + n_scales + n_values),
            # per value: shift, mask, two conversions, the sign, two products
            n_values * 6,
            1,
            {"wrapper": lambda: K.unpack_dequantize_tree(pairs, grads, bits=bits),
             "pr3_path": per_group(fused, payloads)},
        ),
        "pack_bucketed": (
            lambda: K.pack_bucketed_tree(codes, rows, bits=bits),
            lambda: K.pack_bucketed_tree_plain(codes, rows, bits=bits),
            "pack_codes_tree_kernel",
            # read the codes, write the words
            4 * (codes.numel() + n_words),
            # per code: a shift and an or
            codes.numel() * 2,
            1,
            {"pr4_path": each(lambda x, g, w, s, c: K.pack_bucketed(c, bits)),
             "bare_launch": lambda: K.pack_words(codes, bits),
             "pack_encode": lambda: encode_tree(pack, 17, grads),
             "pack_encode_pr4_path": lambda: encode_groups(pack, views, seeds)},
        ),
        "unpack_bucketed": (
            lambda: K.unpack_bucketed_tree(words, bits=bits),
            lambda: K.unpack_bucketed_tree_plain(words, bits=bits),
            "unpack_codes_tree_kernel",
            4 * (n_words + n_codes),
            n_codes * 2,
            1,
            {"pr3_path": each(lambda x, g, w, s, c: K.unpack_bucketed(
                w.reshape(-1, g.n_words), bits)),
             "pack_decode": lambda: decode_tree(pack, pack_payloads, grads),
             "pack_decode_pr3_path": per_group(pack, pack_payloads)},
        ),
    }
    out = {}
    for name, (kern, plain, kname, nbytes, ops, launches, beside) in work.items():
        ms = cuda_ms(kern)
        dev_ms = device_ms(kern, kname)
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        b_ms, b_by = bound(nbytes, ops)
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "ops": ops,
                     "launches_per_step": launches}
        log(f"time {name}: {ms:.4f} ms per step by events around the calls, "
            f"{dev_ms:.4f} ms of device time ({launches} launches), plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by} ({nbytes} bytes, {ops} ops), "
            f"{100 * b_ms / dev_ms:.1f} % of it by device time, {100 * b_ms / ms:.1f} % by events")
        for label, fn in beside.items():
            t = {"ms": cuda_ms(fn), "device_all_ms": device_ms(fn, "")}
            out[name][label] = t
            log(f"time {name} {label}: {t['ms']:.4f} ms by events, {t['device_all_ms']:.4f} ms "
                f"of device time in all its kernels and copies")
        if beside:
            out[name]["device_all_ms"] = device_ms(kern, "")
    return out


def phase_time_flash():
    """The flash kernel's launches of one LM train step (one per layer) on
    the recipe's head views, against its plain version and the one PyTorch
    call that computes the same function. The bound of the float32 kernel is
    that of its route, three TF32 products per product at 495 TFLOP/s; the
    bf16 one's one product at 989 TFLOP/s; 67 TFLOP/s of float32 FMA was the
    yardstick of the earlier design."""
    import torch
    import torch.nn.functional as F

    from atomo_tpu_torch.ops import attention_kernels as A

    q, k, v = lm_heads(seed=5)
    blk = dict(block_q=512, block_k=512)

    def per_step(fn):
        return lambda: [fn() for _ in range(LM_DEPTH)]

    b, h, s, d = LM_SHAPE
    nbytes = LM_DEPTH * 4 * b * h * s * d * 4  # read q, k, v, write o, float32
    ops = LM_DEPTH * 4 * b * h * d * s * (s + 1) // 2  # q.k and p.v over the causal pairs
    kern = per_step(lambda: A.flash_attention_forward(q, k, v, causal=True, **blk))
    ms = cuda_ms(kern)
    dev_ms = device_ms(kern, "flash_forward_kernel")
    plain_ms = cuda_ms(per_step(lambda: A.flash_attention_plain(q, k, v, causal=True, **blk)),
                       reps=5, warmup=1)
    with torch.no_grad():
        library_ms = cuda_ms(per_step(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)))
    qb, kb, vb = lm_heads(dtype=torch.bfloat16, seed=5)
    kern_bf16 = per_step(lambda: A.flash_attention_forward(qb, kb, vb, causal=True, **blk))
    bf16_ms = cuda_ms(kern_bf16)
    bf16_dev_ms = device_ms(kern_bf16, "flash_forward_kernel")
    bf16_plain_ms = cuda_ms(per_step(lambda: A.flash_attention_plain(qb, kb, vb, causal=True,
                                                                     **blk)), reps=5, warmup=1)
    with torch.no_grad():
        bf16_library_ms = cuda_ms(per_step(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True)))
    b_ms, b_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
    # bf16 in and out: half the bytes; one bf16 product per product
    bf16_bound, bf16_by = bound(nbytes // 2, ops, BF16_OPS_PER_S)
    fma_bound, _ = bound(nbytes, ops, F32_OPS_PER_S)
    log(f"time flash_attention: {ms:.4f} ms per step ({LM_DEPTH} launches), {dev_ms:.4f} ms "
        f"of device time, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{library_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} (3 x {ops} TF32 ops at 495 "
        f"TFLOP/s; {nbytes} bytes at 3.35 TB/s: {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), "
        f"{100 * b_ms / ms:.1f} % of it; float32 FMA bound {fma_bound:.4f} ms (67 TFLOP/s)")
    log(f"time flash_attention bf16 inputs: {bf16_ms:.4f} ms per step, {bf16_dev_ms:.4f} ms "
        f"of device time, plain {bf16_plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{bf16_library_ms:.4f} ms on the same bf16 tensors; bound {bf16_bound:.4f} ms by "
        f"{bf16_by} ({ops} bf16 ops at 989 TFLOP/s; {nbytes // 2} bytes at 3.35 TB/s: "
        f"{nbytes / 2 / HBM_BYTES_PER_S * 1e3:.4f} ms), {100 * bf16_bound / bf16_dev_ms:.1f} % "
        f"of it by device time")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_peak": "3 x TF32 at 495 TFLOP/s",
            "fma_bound_ms": fma_bound, "bytes": nbytes, "ops": ops,
            "launches_per_step": LM_DEPTH,
            "bf16": {"ms": bf16_ms, "device_ms": bf16_dev_ms, "plain_ms": bf16_plain_ms,
                     "library_ms": bf16_library_ms, "bound_ms": bf16_bound, "bound_by": bf16_by,
                     "bytes": nbytes // 2, "ops": ops}}


def profile_steps(label: str, step_once, steps: int = 3):
    """Where a step's time goes: ``torch.profiler`` over ``steps`` calls of
    ``step_once()`` (after two warm-up calls), the device's busy time (sum of
    kernel times) against the host's wall time, each ``step.*`` phase's host
    time and its span on the device's timeline, and the kernels that take
    the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step_once()
    torch.cuda.synchronize()

    def dev_us(e):
        return e.self_device_time_total

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # the step.* ranges appear twice: as host ranges, and as annotations on
    # the device's timeline spanning their kernels (not kernels themselves)
    kernels = [e for e in events if e.device_type == cuda and not e.key.startswith("step.")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    phases: dict = {}
    for e in events:
        if e.key.startswith("step."):
            ph = phases.setdefault(e.key, {"host_ms": 0.0, "device_span_ms": 0.0})
            if e.device_type == cuda:
                ph["device_span_ms"] += dev_us(e) / 1e3 / steps
            else:
                ph["host_ms"] += e.cpu_time_total / 1e3 / steps
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    out = {"steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
           "phases": phases,
           "top_kernels": [{"name": e.key[:90], "ms_per_step": dev_us(e) / 1e3 / steps,
                            "count_per_step": e.count / steps} for e in top]}
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    log(f"profile {label}: wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step, "
        f"idle share {out['device_idle_share']:.3f}")
    for k, v in sorted(phases.items()):
        log(f"profile {label} phase {k}: host {v['host_ms']:.3f} ms, device span "
            f"{v['device_span_ms']:.3f} ms")
    for t in out["top_kernels"]:
        log(f"profile {label} kernel {t['ms_per_step']:.3f} ms x{t['count_per_step']:.0f} "
            f"{t['name']}")
    return out


def phase_profile():
    """Three qsgd ResNet-18 steps (batch 128) on the fused path, three on
    the pack path and three svd rank 3 steps (the canonical recipe's codec),
    and three svd LM steps at the recipe, each under the profiler."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, SvdCodec
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel.lm import create_lm_state, make_lm_train_step
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step

    spec = SPECS["cifar10"]
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    it = BatchIterator(synthetic_dataset(spec, True), 128, seed=1).epoch()
    batches = [to_device(*next(it), "cuda") for _ in range(5)]

    def resnet(label, codec):
        box = {"state": create_state(get_model("resnet18", 10, image_shape=spec.image_shape),
                                     opt, 1, "cuda"), "i": 0}
        step = make_train_step(box["state"].model, opt, codec=codec, augment=True)

        def resnet_step():
            x, y = batches[box["i"] % len(batches)]
            box["i"] += 1
            box["state"], m = step(box["state"], 2, x, y)
            float(m["loss"])

        return profile_steps(label, resnet_step)

    out = {"resnet18_qsgd4": resnet("resnet18 qsgd", QsgdCodec(bits=4)),
           "resnet18_qsgd4_pack": resnet("resnet18 qsgd-pack",
                                         QsgdCodec(bits=4, use_kernel=False)),
           "resnet18_svd3": resnet("resnet18 svd3", SvdCodec(rank=3))}
    del batches

    lm_opt = make_optimizer("sgd", lr=0.1, momentum=0.9)
    cfg = dict(vocab_size=256, max_len=LM_SHAPE[2], width=256, depth=LM_DEPTH, num_heads=4)
    lm = {"state": create_lm_state(cfg, lm_opt, 0, "cuda"), "i": 0}
    lm_step = make_lm_train_step(lm["state"].model, lm_opt, SvdCodec(rank=24),
                                 attn_impl="ulysses-flash")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = [torch.randint(0, 256, (LM_SHAPE[0], LM_SHAPE[2]), generator=gen, device="cuda")
              for _ in range(5)]

    def lm_step_once():
        lm["i"] += 1
        lm["state"], m = lm_step(lm["state"], lm["i"], tokens[lm["i"] % len(tokens)])
        float(m["loss"])

    out["lm_svd24"] = profile_steps("lm svd", lm_step_once)
    lm["state"] = create_lm_state(cfg, lm_opt, 0, "cuda")
    lm_step = make_lm_train_step(lm["state"].model, lm_opt, SvdCodec(rank=24),
                                 attn_impl="ulysses-flash", compute_dtype=torch.bfloat16)
    out["lm_svd24_bf16"] = profile_steps("lm svd bf16", lm_step_once)
    return out


DIST_STEPS = 3


def resnet_batches(device, n: int, rank: int = 0, world: int = 1):
    """``n`` global ResNet-18 batches (CIFAR-10 shapes, 128) of the seeded
    synthetic set, this rank's rows of each, on ``device``."""
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
    from atomo_tpu_torch.parallel.replicated import shard_batch

    it = BatchIterator(synthetic_dataset(SPECS["cifar10"], True), 128, seed=1).epoch()
    return [to_device(*shard_batch(*next(it), rank, world), device) for _ in range(n)]


def state_hash(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_steps(step, state, batches, sync_check: bool):
    """The steps over ``batches`` with every launch count set to 0 before
    and read after: losses, host ms per step (the step and the read of its
    loss), Msg bytes; from the second step on, with ``sync_check``, each
    step runs under ``set_sync_debug_mode("error")``."""
    import torch

    from atomo_tpu_torch import ops

    ops.reset_launch_counts()
    losses, ms, hashes = [], [], []
    m = None
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        if sync_check and i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = step(state, 2, x, y)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        hashes.append(state_hash(state.model))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return state, {"losses": losses, "step_ms": ms, "median_step_ms": statistics.median(ms[1:]),
                   "msg_bytes": int(m["msg_bytes"]), "launches": ops.launch_counts(),
                   "hashes": hashes}


DIST_RUNS = [("qsgd_gather", "qsgd", "gather"), ("svd3_gather", "svd3", "gather"),
             ("qsgd_ring", "qsgd", "ring")]


def make_codec(name):
    from atomo_tpu_torch.codecs import QsgdCodec, SvdCodec

    return QsgdCodec(bits=4) if name == "qsgd" else SvdCodec(rank=3)


def phase_dist_nccl1(work: Path):
    """The data-parallel step at NCCL world size 1 (its collectives real
    NCCL calls of one rank), ResNet-18 at batch 128, 3 steps each: qsgd 4
    bits gather, svd rank 3 gather (the canonical recipe), qsgd ring; the
    single-device step of the same codecs timed the same way beside them;
    then each under the profiler with its phases."""
    import torch

    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.replicated import (
        make_distributed_train_step,
        replicate_state,
    )
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/nccl1", world_size=1,
                      rank=0)
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    batches = resnet_batches(dev, DIST_STEPS)
    out, prof = {}, {}
    try:
        def fresh(dist_step, codec, aggregate=None):
            model = get_model("resnet18", 10, image_shape=(32, 32, 3))
            state = create_state(model, opt, 1, dev)
            if not dist_step:
                return state, make_train_step(model, opt, codec=codec, augment=True)
            return replicate_state(state), make_distributed_train_step(
                model, opt, codec, aggregate=aggregate, augment=True)

        for label, code, aggregate in DIST_RUNS:
            state, step = fresh(True, make_codec(code), aggregate)
            state, out[label] = run_steps(step, state, batches, sync_check=code == "qsgd")
            if label != "qsgd_ring":
                single, sstep = fresh(False, make_codec(code))
                _, out[f"single_{code}"] = run_steps(sstep, single, batches, False)
        for label, code, aggregate in DIST_RUNS:
            r = out[label]
            single = out[f"single_{code}"]
            if code == "qsgd" and (r["launches"]["quantize_pack"] != DIST_STEPS
                                   or r["launches"]["unpack_dequantize"] != DIST_STEPS):
                raise AssertionError(f"dist nccl-1 {label}: launches {r['launches']}, want "
                                     f"quantize_pack and unpack_dequantize {DIST_STEPS}")
            if code == "svd3" and any(r["launches"].values()):
                raise AssertionError(f"dist nccl-1 {label} launched kernels: {r['launches']}")
            if r["msg_bytes"] != single["msg_bytes"]:
                raise AssertionError(f"dist nccl-1 {label}: Msg {r['msg_bytes']} bytes, the "
                                     f"single-device step's {single['msg_bytes']}")
            log(f"dist nccl-1 {label}: losses {r['losses']} launches {r['launches']} "
                f"Msg(MB) {r['msg_bytes'] / 2 ** 20:.4f} median step ms (steps 2-3) "
                f"{r['median_step_ms']:.3f}, single-device step {single['median_step_ms']:.3f}"
                + (", steps 2-3 under set_sync_debug_mode('error')" if code == "qsgd" else ""))
        for label, code, aggregate in DIST_RUNS[:2]:
            box = dict(zip(("state", "step"), fresh(True, make_codec(code), aggregate)), i=0)

            def once():
                x, y = batches[box["i"] % len(batches)]
                box["i"] += 1
                box["state"], m = box["step"](box["state"], 2, x, y)
                float(m["loss"])

            prof[label] = profile_steps(f"dist nccl-1 {code}", once)
    finally:
        launch.shutdown()
    return out, prof


def gloo_child(rank: int, world: int, store: str, out_path: str) -> int:
    """One rank of ``phase_dist_gloo2`` (this script run with
    ``--gloo-child``): ResNet-18 at global batch 128, qsgd 4 bits gather
    and psum and svd rank 3 gather, 3 steps each, over gloo on cuda:0.
    Writes each run's losses, state hashes, Msg bytes and launches, and on
    rank 0 the check of the last qsgd gather's decode-mean against the
    plain twin on the same gathered buffer, to ``out_path`` (JSON)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch.codecs import decode_mean_tree
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.common import unpack_tree_buckets
    from atomo_tpu_torch.training import create_state, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="gloo", init_method=f"file://{store}", world_size=world,
                      rank=rank)
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    batches = resnet_batches(dev, DIST_STEPS, rank, world)
    gathered = []
    gather = R.gather_payloads

    def recording_gather(*args, **kw):  # the last gathered buffer, for the check
        gathered[:] = [gather(*args, **kw)]
        return gathered[0]

    R.gather_payloads = recording_gather
    out = {}
    try:
        for label, code, aggregate in [("qsgd_gather", "qsgd", "gather"),
                                       ("qsgd_psum", "qsgd", "psum"),
                                       ("svd3_gather", "svd3", "gather")]:
            model = get_model("resnet18", 10, image_shape=(32, 32, 3))
            state = R.replicate_state(create_state(model, opt, 1, dev))
            step = R.make_distributed_train_step(model, opt, make_codec(code),
                                                 aggregate=aggregate, augment=True)
            state, out[label] = run_steps(step, state, batches, sync_check=False)
            out[label]["dense_bytes"] = sum(p.numel() * 4 for p in leaf_params(model))
            if label == "qsgd_gather" and rank == 0:
                buf, spec = gathered[0]
                like = [p.detach() for p in leaf_params(model)]
                got = decode_mean_tree(make_codec(code), unpack_tree_buckets(buf, spec), like,
                                       world)
                cpu_views = unpack_tree_buckets(buf.cpu(), spec)
                want = K.unpack_dequantize_tree_plain(
                    [(v.words, v.scales) for v in cpu_views], [t.cpu() for t in like], bits=4,
                    n_replicas=world)
                out["decode_check"] = {
                    "equal": all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                    "max_abs_err": max(float((a.cpu() - b).abs().max()) for a, b in
                                       zip(got, want))}
    finally:
        R.gather_payloads = gather
        launch.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def gloo_p2p_probe(rank: int, store: str) -> int:
    """One rank of the probe ``phase_dist_gloo2`` makes first (this script
    with ``--gloo-p2p-probe``): one ``batch_isend_irecv`` of a CUDA tensor
    between two gloo ranks on cuda:0, which the ring would need."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
    try:
        x = torch.full((1024,), float(rank), device="cuda")
        y = torch.empty_like(x)
        for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                         dist.P2POp(dist.irecv, y, 1 - rank)]):
            r.wait()
        return 0 if float(y[0]) == float(1 - rank) else 1
    finally:
        dist.destroy_process_group()


def spawn_ranks(args_of, work: Path, name: str, timeout: float):
    """Start two copies of this script with ``args_of(rank)``; wait for
    both (killing them at ``timeout``); returns (exit codes, logs)."""
    procs = []
    for r in range(2):
        with open(work / f"{name}{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), *args_of(r)],
                stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    return ([p.returncode for p in procs],
            [(work / f"{name}{r}.log").read_text(errors="replace") for r in range(2)])


def phase_dist_gloo2(work: Path, single_msg: dict):
    """Two processes on the one card over gloo (NCCL refuses two ranks on
    one device): every step leaves the replicas bit-identical, the decode-
    mean equals the plain twin's on rank 0's gathered buffer, and Msg(MB)
    equals the single card's (gather) or the dense bytes (psum). First a
    probe of gloo's send and receive of a CUDA tensor, which the ring needs;
    where it fails the ring is left out, as it is in this phase."""
    rcs, logs = spawn_ranks(lambda r: ["--gloo-p2p-probe", str(r), str(work / "p2p_store")],
                            work, "p2p", timeout=60)
    p2p = {"exit_codes": rcs, "log_tail": logs[0][-400:]}
    log(f"dist gloo-2 probe: gloo send/recv of a CUDA tensor between two ranks on one card: "
        f"exit codes {rcs}" + ("" if rcs == [0, 0] else
                               f" (it fails: {logs[0].strip().splitlines()[-1:]})"))
    paths = [work / f"gloo{r}.json" for r in range(2)]
    rcs, logs = spawn_ranks(lambda r: ["--gloo-child", str(r), "2", str(work / "gloo_store"),
                                       str(paths[r])], work, "gloo", timeout=600)
    if any(rcs):
        raise AssertionError("dist gloo-2: a rank failed:\n" + "\n".join(
            t[-3000:] for t in logs))
    ranks = [json.loads(path.read_text()) for path in paths]
    for label in ("qsgd_gather", "qsgd_psum", "svd3_gather"):
        r0, r1 = ranks[0][label], ranks[1][label]
        if r0["hashes"] != r1["hashes"]:
            raise AssertionError(f"dist gloo-2 {label}: the replicas differ")
        want = r0["dense_bytes"] if label.endswith("psum") else single_msg[label.split("_")[0]]
        if r0["msg_bytes"] != want or r1["msg_bytes"] != want:
            raise AssertionError(f"dist gloo-2 {label}: Msg {r0['msg_bytes']} bytes, want {want}")
        log(f"dist gloo-2 {label}: losses {r0['losses']} replicas bit-identical after each of "
            f"{len(r0['hashes'])} steps, Msg(MB) {r0['msg_bytes'] / 2 ** 20:.4f}, launches "
            f"rank 0 {r0['launches']}, median step ms (steps 2-3) {r0['median_step_ms']:.3f}")
    check = ranks[0]["decode_check"]
    if not check["equal"]:
        raise AssertionError(f"dist gloo-2: the decode-mean differs from its plain twin {check}")
    log("dist gloo-2: the tree decode's mean over rank 0's gathered buffer equals its plain "
        "twin bit for bit; the ring left out (it needs gloo's send and receive of CUDA "
        "tensors, probed above)")
    return {"ranks": ranks, "p2p_probe": p2p}


# the LM recipe through the CLI: svd at the auto rank 24
LM_SVD = LM_ARGS + ["--code", "svd", "--train-dir", ""]
LM_NCCL_STEPS, LM_BF16_STEPS = 3, 5


def flash_launches_only(counts: dict, want: int, label: str) -> None:
    if counts["flash_attention"] != want or sum(counts.values()) != want:
        raise AssertionError(f"{label}: launches {counts}, want flash_attention {want} "
                             "and nothing else")


def lm_nccl1(work: str):
    """The LM recipe (ulysses-flash, svd rank 24) through the process-group
    path at NCCL world 1, 3 steps, in :func:`ckpt_child`'s deterministic
    process: ``lm`` run with a group up builds the (1, 1) mesh over it,
    replicates the state, and gathers the payloads over the dp group with a
    real NCCL call. Its state must equal the single-device run's (no group)
    bit for bit, its ``LM:`` lines the same but for their times, the flash
    kernel launched once per layer per step in each."""
    import torch

    from atomo_tpu_torch.parallel import launch

    argv = LM_SVD + ["--max-steps", str(LM_NCCL_STEPS)]
    single_lines: list[str] = []
    single, single_counts = train_state(argv, single_lines)
    launch.initialize(torch.device("cuda", 0), backend="nccl",
                      init_method=f"file://{work}/lm_nccl1", world_size=1, rank=0)
    try:
        lines: list[str] = []
        grouped, counts = train_state(argv, lines)
    finally:
        launch.shutdown()
    for label, c in (("single", single_counts), ("nccl-1", counts)):
        flash_launches_only(c, LM_DEPTH * LM_NCCL_STEPS, f"lm nccl-1 {label}")
    if not same_state(single, grouped):
        worst = max(float((a - b).abs().max()) for a, b in
                    zip(single.model.state_dict().values(), grouped.model.state_dict().values()))
        raise AssertionError("lm nccl-1: the process-group run differs from the single-device "
                             f"run: max |param diff| {worst:.3e}")

    def cols(ls):  # the LM: lines but for their times
        return [re.sub(r"Time Cost: [0-9.]+, ", "", ln) for ln in ls if ln.startswith("LM: ")]

    if cols(single_lines) != cols(lines):
        raise AssertionError(f"lm nccl-1: LM lines differ {single_lines} {lines}")
    steps = {k: statistics.median([1e3 * float(ln.split("Time Cost: ")[1].split(",")[0])
                                   for ln in ls if ln.startswith("LM: ")][1:])
             for k, ls in (("single", single_lines), ("nccl1", lines))}
    log(f"lm nccl-1: the recipe (ulysses-flash, svd rank 24) through the process-group path "
        f"at NCCL world 1 equals the single-device run bit for bit after {LM_NCCL_STEPS} "
        f"steps (parameters, momentum); losses and Msg(MB) alike; launches {counts} in each; "
        f"median step ms (steps 2-3) {steps['nccl1']:.3f}, single-device {steps['single']:.3f}")
    return {"launches": counts["flash_attention"] + single_counts["flash_attention"],
            "median_step_ms": steps}


def phase_lm_bf16(runs: dict):
    """``lm --bf16`` at the recipe, 5 steps: the bf16 form of the flash
    kernel launched once per layer per step and nothing else, the losses
    finite, parameters and optimizer state float32, and the first step's
    loss (the same init and batch as the float32 run of ``phase_train``)
    within 1e-2 relative of the float32 one: bfloat16's 8-bit mantissa,
    rounded at each op of the forward, over a loss near ln 256."""
    import torch

    from atomo_tpu_torch.ops import attention_kernels as A

    lines: list[str] = []
    state, counts = train_state(LM_SVD + ["--max-steps", str(LM_BF16_STEPS), "--bf16"], lines)
    bf16 = A.bf16_launch_count()
    want = LM_DEPTH * LM_BF16_STEPS
    flash_launches_only(counts, want, "lm bf16")
    if bf16 != want:
        raise AssertionError(f"lm bf16: {bf16} of the {want} flash launches took bfloat16")
    lm = [ln for ln in lines if ln.startswith("LM: ")]
    losses = [float(ln.split("Loss: ")[1].split(",")[0]) for ln in lm]
    if len(losses) != LM_BF16_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"lm bf16: losses {losses}")
    dtypes = {t.dtype for t in state.model.state_dict().values()}
    dtypes |= {t.dtype for t in state.opt_state.trace or []}
    if dtypes != {torch.float32}:
        raise AssertionError(f"lm bf16: state dtypes {dtypes}")
    f32 = runs["lm_svd"]["losses"][0]
    if not math.isclose(losses[0], f32, rel_tol=1e-2):
        raise AssertionError(f"lm bf16: first loss {losses[0]} vs float32 {f32}")
    ms = statistics.median([1e3 * float(ln.split("Time Cost: ")[1].split(",")[0])
                            for ln in lm][1:])
    log(f"lm bf16: launches {counts}, all {bf16} on bfloat16 inputs; losses {losses}; state "
        f"float32; first loss {losses[0]:.4f} vs float32 {f32:.4f} (rel 1e-2); median step ms "
        f"(steps 2-5) {ms:.3f}, float32 {runs['lm_svd']['median_step_ms_after_first']:.3f}")
    return {"launches": counts["flash_attention"], "bf16_launches": bf16, "losses": losses,
            "median_step_ms": ms,
            "median_step_ms_float32": runs["lm_svd"]["median_step_ms_after_first"]}


def lm_ckpt(work: str) -> dict:
    """The LM part of :func:`ckpt_child`: the recipe saved at step 3, the
    file loaded into a fresh state (equal to the saved one bit for bit),
    and ``--resume`` to 5, equal bit for bit to the continuation that the
    JAX verb runs after a resume: steps 4 and 5 from the loaded state, on
    the first two batches of a fresh ``--seed`` stream, keys folded with 4
    and 5. Returns the CLI runs' flash launches."""
    import torch

    from atomo_tpu_torch import cli
    from atomo_tpu_torch.parallel.lm import create_lm_state, make_lm_train_step
    from atomo_tpu_torch.training import checkpoint as ck
    from atomo_tpu_torch.utils.rng import fold_in

    d = str(Path(work) / "lm")
    argv = LM_ARGS + ["--code", "svd", "--train-dir", d, "--save-freq", "3"]
    saved, c1 = train_state(argv + ["--max-steps", "3"], [])
    args = cli.build_parser().parse_args(argv + ["--max-steps", "5"])
    opt = cli.lm_optimizer(args)
    loaded = ck.load_checkpoint(d, create_lm_state(cli.lm_config(args), opt, 1, "cuda"))
    if not same_state(saved, loaded):
        raise AssertionError("lm ckpt: the loaded state differs from the saved one")
    lines: list[str] = []
    resumed, c2 = train_state(argv + ["--max-steps", "5", "--resume"], lines)
    if f"Resumed from {d} at step 3" not in lines:
        raise AssertionError(f"lm ckpt: the resumed run began {lines[:3]}")
    step = make_lm_train_step(loaded.model, opt, cli.lm_codec(args, lambda _: None),
                              attn_impl="ulysses-flash")
    next_batch, _ = cli.lm_data(args)
    state = loaded
    for i in (4, 5):
        state, _ = step(state, fold_in(args.seed, i),
                        torch.from_numpy(next_batch()).to("cuda", torch.int64))
    if not same_state(resumed, state):
        raise AssertionError("lm ckpt: the resumed run differs from the continuation on a "
                             "fresh stream")
    log("lm ckpt: the recipe saved at step 3 loads back bit for bit; resumed to 5 it equals "
        "the JAX verb's continuation (a fresh --seed stream, keys folded with 4 and 5) bit "
        f"for bit; launches {c1} then {c2}")
    return {"launches": c1["flash_attention"] + c2["flash_attention"]}


# the canonical recipe (src/run_pytorch.sh): ResNet-18 on CIFAR-10 shapes,
# batch 128, lr 0.01 shrunk by 0.95 every 50 steps, momentum 0, svd rank 3
RECIPE_ARGS = ["train", "--network", "ResNet18", "--dataset", "Cifar10", "--synthetic",
               "--batch-size", "128", "--lr", "0.01", "--lr-shrinkage", "0.95",
               "--shrinkage-freq", "50", "--momentum", "0", "--seed", "1",
               "--log-interval", "1", "--device", "cuda"]
SVD3 = ["--code", "svd", "--svd-rank", "3"]
QSGD4 = ["--code", "qsgd", "--quantization-level", "4"]


def train_state(argv, lines):
    """One ``train`` run through the CLI's parser and verb, returning the
    final train state (``cli.main`` returns only an exit code); the launch
    counts are set to 0 before it."""
    from atomo_tpu_torch import cli, ops

    args = cli.build_parser().parse_args(argv)
    ops.reset_launch_counts()
    state = args.fn(args, log_fn=lambda ln: (lines.append(ln), log("  " + ln)))
    return state, ops.launch_counts()


def same_state(a, b) -> bool:
    """Parameters, buffers and optimizer tensors equal bit for bit."""
    import torch

    sa, sb = a.model.state_dict(), b.model.state_dict()
    if a.step != b.step or a.opt_state.count != b.opt_state.count or list(sa) != list(sb):
        return False
    pairs = list(zip(sa.values(), sb.values()))
    for f in ("trace", "mu", "nu", "nu_max"):
        x, y = getattr(a.opt_state, f, None), getattr(b.opt_state, f, None)
        if (x is None) != (y is None):
            return False
        pairs += list(zip(x or [], y or []))
    return all(torch.equal(u.reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8))
               for u, v in pairs)


def ckpt_child(work: str, out_path: str) -> int:
    """The checkpoint phase's deterministic runs (this script with
    ``--ckpt-child``, a process of its own so that cuBLAS's workspace
    setting precedes its first handle): the canonical recipe straight for 10
    steps, and cut at 5 and resumed to 10, equal bit for bit; ``evaluate``
    on the first run's directory against its ``Validation:`` lines; qsgd
    with ``--compress --keep-ckpts 2 --bf16``; the save and load times.
    Writes its findings to ``out_path`` (JSON)."""
    import os
    import warnings

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import cli
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import checkpoint as ck
    from atomo_tpu_torch.training import create_state, make_optimizer

    # warn_only: an op without a deterministic algorithm warns (and is named
    # in the result) instead of raising; the bit-for-bit check still holds
    torch.use_deterministic_algorithms(True, warn_only=True)
    a, b, c = (str(Path(work) / d) for d in ("a", "b", "c"))
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lines_a: list[str] = []
        state_a, _ = train_state(RECIPE_ARGS + SVD3 + ["--max-steps", "10", "--eval-freq", "5",
                                                      "--save-freq", "5", "--train-dir", a],
                                 lines_a)
        train_state(RECIPE_ARGS + SVD3 + ["--max-steps", "5", "--eval-freq", "5",
                                          "--save-freq", "5", "--train-dir", b], [])
        lines_b: list[str] = []
        state_b, _ = train_state(RECIPE_ARGS + SVD3 + ["--max-steps", "10", "--eval-freq", "5",
                                                      "--save-freq", "5", "--train-dir", b,
                                                      "--resume"], lines_b)
        if lines_b[0] != f"Resumed from {b} at step 5":
            raise AssertionError(f"ckpt: the resumed run began {lines_b[:1]}")
        if not same_state(state_a, state_b):
            raise AssertionError("ckpt: the resumed recipe run differs from the straight one")
        log("ckpt: svd rank 3 recipe cut at step 5 and resumed equals the straight 10 steps "
            "bit for bit (parameters, BatchNorm statistics, optimizer state)")

        evals: list[str] = []
        cli.main(["evaluate", "--network", "ResNet18", "--dataset", "Cifar10", "--synthetic",
                  "--model-dir", a, "--max-polls", "1", "--stop-when-idle", "--device", "cuda"],
                 log_fn=lambda ln: (evals.append(ln), log("  " + ln)))
        want = [ln.replace("Validation: ", "Evaluator: ") for ln in lines_a
                if ln.startswith("Validation: ")]
        if evals != want or not any(ln.startswith("Evaluator: Step: 10,") for ln in evals):
            raise AssertionError(f"ckpt: evaluator lines {evals}, the trainer's {want}")
        log("ckpt: the Evaluator: lines at steps 5 and 10 equal the trainer's Validation: "
            "lines field for field")

        lines_c: list[str] = []
        state_c, counts = train_state(
            RECIPE_ARGS + QSGD4 + ["--momentum", "0.9", "--compress", "--keep-ckpts", "2",
                                   "--bf16", "--max-steps", "6", "--save-freq", "2",
                                   "--eval-freq", "0", "--train-dir", c], lines_c)
        losses = [float(ln.split("Loss: ")[1].split(",")[0]) for ln in lines_c
                  if ln.startswith("Worker: ")]
        magics = {s: open(ck.checkpoint_path(c, s), "rb").read(4) for s in ck.list_steps(c)}
        if counts["quantize_pack"] != 6 or counts["unpack_dequantize"] != 6:
            raise AssertionError(f"ckpt qsgd bf16: launches {counts}, want 6 and 6")
        if sorted(magics) != [4, 6] or set(magics.values()) != {ck.MAGIC_LZ}:
            raise AssertionError(f"ckpt qsgd bf16: files {magics}, want steps 4 and 6 "
                                 f"compressed")
        if len(losses) != 6 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"ckpt qsgd bf16: losses {losses}")

        def fresh(momentum):
            model = get_model("resnet18", 10, image_shape=(32, 32, 3))
            return create_state(model, make_optimizer("sgd", momentum=momentum), 2, "cuda")

        if not same_state(ck.load_checkpoint(c, fresh(0.9)), state_c):
            raise AssertionError("ckpt qsgd bf16: the newest file does not give back the state")
        log(f"ckpt qsgd --compress --keep-ckpts 2 --bf16: launches {counts}, files "
            f"{sorted(magics)} with magic {ck.MAGIC_LZ!r}, losses {losses}; loading the "
            "newest gives back the state bit for bit")

        times = {}
        for compress in (False, True):
            d = str(Path(work) / f"t{int(compress)}")
            save, load = [], []
            for i in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = ck.save_checkpoint(d, state_a, 10 + i, compress=compress)
                save.append((time.perf_counter() - t0) * 1e3)
                target = fresh(0.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ck.load_checkpoint(d, target, 10 + i)
                torch.cuda.synchronize()
                load.append((time.perf_counter() - t0) * 1e3)
            times["compressed" if compress else "raw"] = {
                "save_ms": statistics.median(save), "load_ms": statistics.median(load),
                "bytes": Path(path).stat().st_size}
        lm = lm_ckpt(work)
        lm["nccl1"] = lm_nccl1(work)
        nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                         for w in caught if "deterministic" in str(w.message)})
    out = {"times": times, "nondeterministic_ops": nondet, "launches": counts, "lm": lm,
           "qsgd_losses": losses, "recipe_step_ms": [
               1e3 * float(ln.split("Time Cost: ")[1].split(",")[0]) for ln in lines_a
               if ln.startswith("Worker: ")]}
    Path(out_path).write_text(json.dumps(out))
    return 0


def phase_ckpt(work: Path, card: str):
    """The rest of the ``train`` verb on the card: the deterministic runs of
    :func:`ckpt_child` in a process of its own, then the median step of svd
    rank 3 and qsgd with and without ``--bf16`` (5 steps each, in this
    process, as the other phases run: not in deterministic mode)."""
    out_path = work / "ckpt.json"
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--ckpt-child",
                           str(work), str(out_path)], capture_output=True, text=True,
                          timeout=600, cwd=str(ROOT))
    for ln in proc.stdout.splitlines():
        log(ln)
    if proc.returncode != 0:
        raise AssertionError(f"ckpt: the deterministic runs failed (exit {proc.returncode}):\n"
                             + proc.stderr[-4000:])
    res = json.loads(out_path.read_text())
    log(f"ckpt: ops without a deterministic algorithm on the path (they warned): "
        f"{res['nondeterministic_ops'] or 'none'}")
    steps = {}
    for label, codec, expect in (("svd3", SVD3, []),
                                 ("qsgd", QSGD4, ["quantize_pack", "unpack_dequantize"])):
        for bf16 in (False, True):
            r = run_cli(RECIPE_ARGS + codec + ["--max-steps", "5", "--eval-freq", "0",
                                               "--train-dir", ""]
                        + (["--bf16"] if bf16 else []), expect)
            key = f"{label}{'_bf16' if bf16 else ''}"
            r["median_step_ms_after_first"] = statistics.median(r["step_ms"][1:])
            steps[key] = r
    res["steps"] = steps
    t = res["times"]
    log(f"ckpt times ({card}): ResNet-18 state save raw {t['raw']['save_ms']:.3f} ms, load raw "
        f"{t['raw']['load_ms']:.3f} ms, save compressed {t['compressed']['save_ms']:.3f} ms, "
        f"load compressed {t['compressed']['load_ms']:.3f} ms, compressed "
        f"{t['compressed']['bytes']} / raw {t['raw']['bytes']} bytes = "
        f"{t['compressed']['bytes'] / t['raw']['bytes']:.4f}; median step ms after the first "
        + ", ".join(f"{k} {v['median_step_ms_after_first']:.3f}" for k, v in steps.items()))
    return res


# ------------------------------------------------------------- the zoo phase

# the smallest --grad-accum at which DenseNet-BC-190 trains at batch 128 on an
# H100 80GB: this phase's runs peak at 62.8 GiB with K 1 and 31.7 with K 2
ZOO_DENSENET_GRAD_ACCUM = 1
ZOO_ALEXNET_BATCH = (32, 3, 224, 224)  # NCHW
DENSENET_LEAVES = 569


def zoo_args(network: str, *extra) -> list[str]:
    """The full-width train flags (``TRAIN_ARGS``) for a zoo network."""
    args = list(TRAIN_ARGS)
    args[args.index("ResNet18")] = network
    return args + list(extra)


def svd_leaf_draws(codec, key: int, grads) -> list[dict]:
    """Per leaf, the draws ``codec`` (SVD) makes encoding it under
    ``fold_in(key, i)``, recorded from one encode of each leaf: the argument
    of the steps' draws hook."""
    import torch

    from atomo_tpu_torch.codecs import svd as S
    from atomo_tpu_torch.convert import jax_view
    from atomo_tpu_torch.utils.rng import fold_in

    seen: dict = {}
    call = S._Draws.__call__

    def record(self, name, keys, make):
        t = call(self, name, keys, make)
        seen[name] = t[0]
        return t

    S._Draws.__call__ = record
    out = []
    try:
        for i, g in enumerate(grads):
            seen = {}
            v = jax_view(torch.randn_like(g))
            codec.encode_stack(v.reshape(1, -1), [fold_in(key, i)], shape=tuple(v.shape))
            out.append(dict(seen))
    finally:
        S._Draws.__call__ = call
    return out


def zoo_vgg11_nccl1_same_draws(dev, steps: int = 2) -> dict:
    """VGG-11 at batch 128, svd rank 3 gather: the single-device step and the
    data-parallel step at NCCL world 1, from the same init, on the same
    batches (augmentation off), each step handed the same codec draws and
    dropout keep-masks through their hooks, end equal bit for bit. (Left to
    their own draws they differ by design: the data-parallel step folds the
    replica index into its step key, as the JAX package's does.)"""
    import torch

    from atomo_tpu_torch.codecs import SvdCodec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel.replicated import (
        make_distributed_train_step,
        replicate_state,
    )
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step
    from atomo_tpu_torch.training.trainer import leaf_params

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    a = create_state(get_model("vgg11", 10, image_shape=(32, 32, 3)), opt, 1, dev)
    b = replicate_state(create_state(get_model("vgg11", 10, image_shape=(32, 32, 3)), opt, 1,
                                     dev))
    step_a = make_train_step(a.model, opt, codec=SvdCodec(rank=3))
    step_b = make_distributed_train_step(b.model, opt, SvdCodec(rank=3), aggregate="gather")
    gen = torch.Generator(device=dev).manual_seed(5)
    for s, (x, y) in enumerate(resnet_batches(dev, steps)):
        masks = [torch.rand((x.shape[0], 512), generator=gen, device=dev) < 0.5
                 for _ in range(2)]
        draws = svd_leaf_draws(SvdCodec(rank=3), 100 + s, leaf_params(a.model))
        a, ma = step_a(a, 2, x, y, uniforms=draws, dropout_masks=masks)
        b, mb = step_b(b, 2, x, y, draws=draws, dropout_masks=masks)
        if int(ma["msg_bytes"]) != int(mb["msg_bytes"]):
            raise AssertionError(f"zoo vgg11 nccl-1: Msg {ma['msg_bytes']} vs {mb['msg_bytes']}")
    if not same_state(a, b):
        raise AssertionError("zoo vgg11: the NCCL world-1 step differs from the single-device "
                             "step on the same batches, draws and dropout masks")
    return {"steps": steps, "loss": float(ma["loss"]), "equal": True}


def zoo_tree_check(grads, label: str, errs: dict, *, replicas=(1, 2)) -> dict:
    """Rows 1-4 on a model's real gradient tree at 4 bits against their plain
    twins: the encode's tree launch (Philox seeds and given uniforms: words
    bit for bit, scales within 1 ulp), the tree decode (1 and 2 replicas),
    the tree unpack and the tree pack, bit for bit; the launches each call
    made (rows 1, 2 and 4: 256 leaves a launch; row 3: one); the device
    time of rows 1 and 2 beside their bound."""
    import torch

    from atomo_tpu_torch import ops
    from atomo_tpu_torch.codecs import QsgdCodec
    from atomo_tpu_torch.convert import jax_view
    from atomo_tpu_torch.ops import qsgd_kernels as K

    codec, bits = QsgdCodec(bits=4), 4
    dev = grads[0].device
    tree = [codec._clip_leaf(jax_view(g).reshape(-1).contiguous()) for g in grads]
    seeds = [1000003 * (i + 1) for i in range(len(tree))]
    gen = torch.Generator(device=dev).manual_seed(11)
    launches = {}
    for kw in (dict(seeds=seeds), dict(u=[torch.rand((K.geometry(x.numel(), bits).n_buckets,
                                                         512), generator=gen, device=dev)
                                          for x in tree])):
        ops.reset_launch_counts()
        got = K.quantize_pack_tree(tree, bits=bits, **kw)
        launches["quantize_pack"] = ops.launch_counts()["quantize_pack"]
        want = K.quantize_pack_tree_plain(tree, bits=bits, **kw)
        for i, ((wk, sk), (wp, sp)) in enumerate(zip(got, want)):
            big = torch.maximum(sk.abs(), sp.abs())
            ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
            if not (same_bits(wk, wp) and bool(((sk - sp).abs() <= ulp).all())):
                raise AssertionError(f"{label}: quantize_pack_tree differs from its plain twin "
                                     f"at leaf {i} ({list(kw)})")
            errs["quantize_pack"] = max(errs["quantize_pack"], float((sk - sp).abs().max()))
        del want
    payloads = got
    for n_rep in replicas:
        pay = payloads if n_rep == 1 else [
            (torch.stack([w.view(torch.int32)] * n_rep).view(torch.uint32),
             torch.stack([s * (1 + r) for r in range(n_rep)])) for w, s in payloads]
        ops.reset_launch_counts()
        dk = K.unpack_dequantize_tree(pay, grads, bits=bits, n_replicas=n_rep)
        launches["unpack_dequantize"] = ops.launch_counts()["unpack_dequantize"]
        dp = K.unpack_dequantize_tree_plain(pay, grads, bits=bits, n_replicas=n_rep)
        errs["unpack_dequantize"] = max([errs["unpack_dequantize"]] + [
            float((a - b).abs().max()) for a, b in zip(dk, dp) if a.numel()])
        if not all(torch.equal(a, b) for a, b in zip(dk, dp)):
            raise AssertionError(f"{label}: unpack_dequantize_tree differs, {n_rep} replicas")
        del dk, dp
    words = [w for w, _ in payloads]
    ops.reset_launch_counts()
    codes = K.unpack_bucketed_tree(words, bits=bits)
    launches["unpack_bucketed"] = ops.launch_counts()["unpack_bucketed"]
    if not torch.equal(codes, K.unpack_bucketed_tree_plain(words, bits=bits)):
        raise AssertionError(f"{label}: unpack_bucketed_tree differs")
    ops.reset_launch_counts()
    check_tree_pack(codes, words, bits, errs, label)
    launches["pack_bucketed"] = ops.launch_counts()["pack_bucketed"]
    del codes
    torch.cuda.synchronize()
    n_values = sum(x.numel() for x in tree)
    n_words = sum(w.numel() for w in words)
    n_scales = sum(s.numel() for _, s in payloads)
    n_pos = n_words * K.geometry(0, bits).vpw
    work = {
        "quantize_pack": (lambda: K.quantize_pack_tree(tree, bits=bits, seeds=seeds),
                          "quantize_pack_kernel",
                          4 * (n_values + n_words + n_scales) + 8 * len(tree), n_pos * 31),
        "unpack_dequantize": (lambda: K.unpack_dequantize_tree(payloads, grads, bits=bits),
                              "unpack_dequantize_tree_kernel",
                              4 * (n_words + n_scales + n_values), n_values * 6),
    }
    out = {"leaves": len(tree), "values": n_values, "launches": launches}
    for name, (fn, kname, nbytes, n_ops) in work.items():
        b_ms, b_by = bound(nbytes, n_ops)
        # a read below the bound is a profiler session that missed
        # kernels (it has happened): taken again, twice at most
        reads = [device_ms(fn, kname, reps=5)]
        while reads[-1] < b_ms and len(reads) < 3:
            reads.append(device_ms(fn, kname, reps=5))
        out[name] = {"device_ms": reads[-1], "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nbytes, "ops": n_ops, "reads": reads}
    log(f"zoo check {label}: {len(tree)} leaves, {n_values} values: the encode's tree launch "
        f"(Philox and given uniforms), the tree decode ({' and '.join(map(str, replicas))} "
        f"replicas), the tree unpack and pack equal their plain twins; launches per call "
        f"{launches}; device "
        f"ms quantize_pack {out['quantize_pack']['device_ms']:.4f} (bound "
        f"{out['quantize_pack']['bound_ms']:.4f} by {out['quantize_pack']['bound_by']}), "
        f"unpack_dequantize {out['unpack_dequantize']['device_ms']:.4f} (bound "
        f"{out['unpack_dequantize']['bound_ms']:.4f} by {out['unpack_dequantize']['bound_by']})")
    return out


def zoo_encode_timer():
    """A wrapper of the data-parallel step's ``encode_tree`` that records the
    wall milliseconds of each call between two device synchronizations, and
    the function that removes it: the encode phase's time."""
    import torch

    import atomo_tpu_torch.parallel.replicated as R

    encode, ms = R.encode_tree, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(*args, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    R.encode_tree = timed

    def restore():
        R.encode_tree = encode

    return ms, restore


def zoo_run(argv, expect, steps: int, per_step: dict) -> dict:
    """One zoo CLI run (:func:`run_cli`) with the launches of ``per_step``
    (kernel: launches a step) required exactly and every other kernel none."""
    r = run_cli(argv, expect)
    for name, n in r["launches"].items():
        want = per_step.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"zoo {' '.join(argv)}: {name} launched {n} times, want {want}")
    r["median_step_ms_after_first"] = statistics.median(r["step_ms"][1:] or r["step_ms"])
    return r


def phase_zoo(work: Path, errs: dict) -> dict:
    """The reference CLI's model zoo at full width on the card: VGG-11 (BN)
    trained through the CLI at batch 128 with svd rank 3, qsgd and sgd (5
    steps each) and, at NCCL world 1, ``--n-devices 1 --aggregate gather``
    svd rank 3, with the single-device and the world-1 steps held bit for
    bit on the same draws; a VGG-11 svd rank 3 step profile; DenseNet-BC-190
    (k 40) at batch 128 through ``--n-devices 1 --grad-accum K`` with qsgd
    (3 steps: 3 launches a step each way over its 569 leaves; and 2 steps at
    K 2) and svd rank 3 (2 steps: its encode's time over 98 shape groups),
    and rows 1-4 on its real gradient tree against the plain twins; AlexNet at 224x224 through
    ``make_train_step`` with qsgd (2 steps) and rows 1-2 on its 37.7 M-value
    leaf."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step
    from atomo_tpu_torch.training.trainer import leaf_params

    out: dict = {"runs": {}, "checks": {}}
    runs = out["runs"]
    qsgd_once = {"quantize_pack": 1, "unpack_dequantize": 1}
    qsgd = ["quantize_pack", "unpack_dequantize"]
    for code, extra, expect, per in (("svd3", ["--code", "svd", "--svd-rank", "3"], [], {}),
                                     ("qsgd", ["--code", "qsgd"], qsgd, qsgd_once),
                                     ("sgd", ["--code", "sgd"], [], {})):
        runs[f"vgg11_{code}"] = zoo_run(zoo_args("VGG11", *extra, "--max-steps", "5",
                                                 "--eval-freq", "0"), expect, 5, per)
    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/zoo_nccl1", world_size=1,
                      rank=0)
    try:
        runs["vgg11_svd3_nccl1"] = zoo_run(zoo_args(
            "VGG11", "--code", "svd", "--svd-rank", "3", "--n-devices", "1", "--aggregate",
            "gather", "--max-steps", "5", "--eval-freq", "0"), [], 5, {})
        if runs["vgg11_svd3_nccl1"]["msg_mb"] != runs["vgg11_svd3"]["msg_mb"]:
            raise AssertionError(f"zoo vgg11 nccl-1 Msg(MB) {runs['vgg11_svd3_nccl1']['msg_mb']} "
                                 f"vs single-device {runs['vgg11_svd3']['msg_mb']}")
        same = out["checks"]["vgg11_nccl1_same_draws"] = zoo_vgg11_nccl1_same_draws(dev)
        log(f"zoo vgg11 nccl-1: the single-device and the NCCL world-1 steps (svd rank 3 "
            f"gather, batch 128) on the same batches, draws and dropout masks equal bit for "
            f"bit after {same['steps']} steps")
        k = str(ZOO_DENSENET_GRAD_ACCUM)
        chunks = -(-DENSENET_LEAVES // 256)  # the tree kernels' leaf table holds 256
        runs["densenet_qsgd"] = zoo_run(zoo_args(
            "DenseNet", "--code", "qsgd", "--n-devices", "1", "--grad-accum", k,
            "--max-steps", "3", "--eval-freq", "0"), qsgd, 3,
            {"quantize_pack": chunks, "unpack_dequantize": chunks})
        # the accumulation on the card at full size: two microbatches of 64
        runs["densenet_qsgd_accum2"] = zoo_run(zoo_args(
            "DenseNet", "--code", "qsgd", "--n-devices", "1", "--grad-accum", "2",
            "--max-steps", "2", "--eval-freq", "0"), qsgd, 2,
            {"quantize_pack": chunks, "unpack_dequantize": chunks})
        enc_ms, restore = zoo_encode_timer()
        try:
            runs["densenet_svd3"] = zoo_run(zoo_args(
                "DenseNet", "--code", "svd", "--svd-rank", "3", "--n-devices", "1",
                "--grad-accum", k, "--max-steps", "2", "--eval-freq", "0"), [], 2, {})
        finally:
            restore()
        runs["densenet_svd3"]["encode_ms"] = enc_ms
    finally:
        launch.shutdown()
    out["densenet_grad_accum"] = ZOO_DENSENET_GRAD_ACCUM
    # DenseNet's real gradient tree (batch 16: the values, not the batch, matter)
    torch.cuda.empty_cache()
    model = get_model("densenet", 10, image_shape=(32, 32, 3))
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    create_state(model, opt, 1, dev)
    x, y = resnet_batches(dev, 1)[0]
    model.train()
    torch.nn.functional.cross_entropy(model(x[:16]), y[:16]).backward()
    grads = [p.grad for p in leaf_params(model)]
    tree = out["checks"]["densenet_tree"] = zoo_tree_check(grads, "densenet", errs)
    # rows 1, 2 and 4 in chunks of 256 leaves; row 3 in one persistent launch
    want = {"quantize_pack": chunks, "unpack_dequantize": chunks, "unpack_bucketed": chunks,
            "pack_bucketed": 1}
    if tree["launches"] != want:
        raise AssertionError(f"zoo densenet tree launches {tree['launches']}, want {want}")
    del model, grads
    torch.cuda.empty_cache()
    # AlexNet at 224x224 through make_train_step
    n, c, h, w = ZOO_ALEXNET_BATCH
    model = get_model("alexnet", 10, image_shape=(h, w, c))
    state = create_state(model, opt, 1, dev)
    step = make_train_step(model, opt, codec=QsgdCodec(bits=4))
    gen = torch.Generator(device=dev).manual_seed(3)
    xs = torch.randn(ZOO_ALEXNET_BATCH, generator=gen, device=dev)
    ys = torch.randint(0, 10, (ZOO_ALEXNET_BATCH[0],), generator=gen, device=dev)
    from atomo_tpu_torch import ops

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, m = step(state, 2, xs, ys)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    if launches != {**{n: 0 for n in launches}, "quantize_pack": 2, "unpack_dequantize": 2}:
        raise AssertionError(f"zoo alexnet: launches {launches}, want one each way a step")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"zoo alexnet: losses {losses}")
    runs["alexnet_qsgd"] = {"losses": losses, "step_ms": ms, "launches": launches,
                            "msg_mb": [int(m["msg_bytes"]) / 2 ** 20],
                            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                            "median_step_ms_after_first": ms[-1]}
    big = max(leaf_params(model), key=lambda p: p.numel())
    out["checks"]["alexnet_leaf"] = zoo_tree_check([big.grad], "alexnet_dense0", errs,
                                                   replicas=(1,))
    del model, state, step, xs
    torch.cuda.empty_cache()
    runs["vgg11_svd3_profile"] = profile_vgg11_svd3(dev)
    for name, r in runs.items():
        if "losses" in r:
            log(f"zoo {name}: losses {r['losses']} launches {r['launches']} Msg(MB) "
                f"{r['msg_mb']} median step ms (after the first) "
                f"{r['median_step_ms_after_first']:.3f} peak GiB {r.get('peak_gib', 0):.2f}")
    log(f"zoo densenet: --grad-accum {ZOO_DENSENET_GRAD_ACCUM}, qsgd launches "
        f"{runs['densenet_qsgd']['launches']} ({chunks} a step each way over 569 leaves), "
        f"svd3 encode ms per step {runs['densenet_svd3']['encode_ms']}")
    return out


def profile_vgg11_svd3(dev) -> dict:
    """Three VGG-11 svd rank 3 steps (batch 128) under the profiler."""
    from atomo_tpu_torch.codecs import SvdCodec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    batches = resnet_batches(dev, 3)
    box = {"state": create_state(get_model("vgg11", 10, image_shape=(32, 32, 3)), opt, 1, dev),
           "i": 0}
    step = make_train_step(box["state"].model, opt, codec=SvdCodec(rank=3), augment=True)

    def once():
        x, y = batches[box["i"] % len(batches)]
        box["i"] += 1
        box["state"], m = step(box["state"], 2, x, y)
        float(m["loss"])

    return profile_steps("zoo vgg11 svd3", once)


def main() -> int:
    if sys.argv[1:2] == ["--gloo-child"]:
        return gloo_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--gloo-p2p-probe"]:
        return gloo_p2p_probe(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--ckpt-child"]:
        return ckpt_child(sys.argv[2], sys.argv[3])
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import atomo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the atomo_tpu_torch package is missing beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t_start = time.time()
    seconds: dict[str, float] = {}

    def lap(name):  # wall seconds of each group of phases, for the time budget
        seconds[name] = time.time() - t_start - sum(seconds.values())

    phase_build()
    lap("build")
    grads, leaves, stacks = resnet_grads(torch.device("cuda"))
    log(f"ResNet-18 leaves: {len(leaves)} in {len(stacks)} shape groups, "
        f"{sum(x.numel() for x in leaves)} values")
    errs = {name: 0.0 for name in REPLACES}  # and flash_attention_bf16, its bf16 form
    phase_flash_check(errs)
    phase_check(leaves, stacks, errs)
    phase_check_decode(grads, errs)
    phase_check_pack_encode(grads)
    phase_unbiased(stacks)
    phase_reference()
    phase_reference_lm()
    lap("check")
    runs = phase_train()
    lap("train")
    times = phase_time(grads, leaves, stacks)
    times["flash_attention"] = phase_time_flash()
    lap("time")
    prof = phase_profile()
    lap("profile")
    gathered = phase_check_gathered(grads, errs)
    lap("gathered")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        dist_runs, dist_prof = phase_dist_nccl1(Path(work))
        lap("dist nccl-1")
        single_msg = {"qsgd": dist_runs["single_qsgd"]["msg_bytes"],
                      "svd3": dist_runs["single_svd3"]["msg_bytes"]}
        gloo = phase_dist_gloo2(Path(work), single_msg)
        lap("dist gloo-2")
        lm_bf16 = phase_lm_bf16(runs)
        lap("lm bf16")
        ckpt = phase_ckpt(Path(work), card)
        lap("ckpt")
        zoo = phase_zoo(Path(work), errs)
        lap("zoo")
    lm_runs = {"nccl1": ckpt["lm"].pop("nccl1"), "bf16": lm_bf16}
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    prof.update({f"dist_nccl1_{k}": v for k, v in dist_prof.items()})

    launches = {name: sum(r["launches"][name] for r in runs.values())
                + sum(dist_runs[label]["launches"][name] for label, _, _ in DIST_RUNS)
                + ckpt["launches"][name]
                + sum(r["launches"][name] for r in ckpt["steps"].values())
                + sum(r["launches"][name] for r in zoo["runs"].values() if "launches" in r)
                for name in REPLACES}
    launches["flash_attention"] += (lm_runs["nccl1"]["launches"] + lm_runs["bf16"]["launches"]
                                    + ckpt["lm"]["launches"])
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": errs[name],
        "ms": times[name]["ms"], "device_ms": times[name]["device_ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": times[name].get("library_ms"),
    } for name in REPLACES]
    # row 5's bfloat16 form, launched by lm --bf16 on the main path
    fb = times["flash_attention"]["bf16"]
    kernels[-1]["bf16"] = {
        "launches": lm_runs["bf16"]["bf16_launches"], "max_abs_err": errs["flash_attention_bf16"],
        "ms": fb["ms"], "device_ms": fb["device_ms"], "plain_ms": fb["plain_ms"],
        "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"], "library_ms": fb["library_ms"]}
    result = {"card": card, "runs": runs, "times": times, "profile": prof, "kernels": kernels,
              "gathered": gathered, "dist_nccl1": dist_runs, "dist_gloo2": gloo, "lm": lm_runs,
              "ckpt": ckpt, "zoo": zoo, "phase_seconds": seconds,
              "seconds": time.time() - t_start}
    out_dir = ROOT / "output"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
