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
12. sparse: the embedding tower over zipf row ids with the sparse-row
   hybrid exchange. (a) The README recipe (``--dataset zipf --network
   embedding --code qsgd``, 4096 x 16, batch 128, lr 0.1, momentum 0.9)
   through the CLI for 30 steps: the mean loss of the last 5 below that of
   the first 5, one encode and one decode launch a step. (b) At NCCL world
   1 on the CLI's largest table (2^24 x 16, 268,435,456 values; batch 128,
   slots 8): the plan from the first batch's gradient on the card; the row
   encode of that gradient equal to the CPU's, the decode lossless, both
   timed; rows 1-4 on the table leaf against their twins
   (:func:`zoo_tree_check`); then ``make_distributed_train_step
   (hybrid=plan)`` with qsgd against the all-dense qsgd step (the table
   through rows 1-2) and the hybrid on the ``--qsgd-path pack`` path (rows
   3-4), 3 steps each (step ms, Msg(MB), peak GiB; the hybrids'
   ``msg_bytes`` the plan's, ``row_overflow`` 0, one encode and one decode
   launch a step each; the qsgd hybrid and all-dense steps profiled as in
   5), and the ``DenseCodec`` hybrid against
   ``hybrid=None``, equal bit for bit. (c) ``train --n-devices 2 --aggregate
   gather --sparse-rows on`` over two gloo ranks on the card (this script
   with ``--sparse-gloo-child``), 3 steps: the plan printed, the replicas
   bit-identical, one launch a step each way on each rank. The ring stays
   on the CPU (gloo aborts on a CUDA tensor's send and receive).
13. budget: per-layer allocation and error feedback. (a) The CLI's
   ``--budget-alloc variance`` allocations for ResNet-18 at batch 128 (svd
   rank 3 under ``fixed_k``, qsgd 4 bits; ``--budget-bytes 0``), then rows
   1-4 on ResNet-18's real gradient at the qsgd allocation's widths and at
   a forced allocation of every width 1-16 (62 leaves, widths 1 + i % 16),
   as the main path runs them, against their plain versions (bit for bit;
   scales within 1 ulp, the pack path's torch quantizer within rtol 1e-6),
   with the launches of each call (one per distinct width) and each row's
   device time over the tree beside its bound by bytes. (b) At NCCL world
   1, ``make_distributed_train_step`` 30 steps each of uniform and variance
   for svd3 and qsgd4 from one start on the same batches: Msg bytes (the
   variance total at or under the uniform one, equal to
   ``allocation_payload_bytes``), the median step, the mean loss of steps
   26-30, the SVD groups or QSGD launches a step; DenseNet-BC-190's SVD
   groups uniform and variance. (c) ``--error-feedback`` with svd3
   ``--sample topk`` and qsgd4 at NCCL world 1 in a deterministic child
   (this script with ``--budget-child``): ``ef_res_norm`` for steps 1-10,
   step 1 equal to the plain step and a run cut after step 5 and resumed
   equal to the straight run, bit for bit. (d) ``train --code qsgd
   --budget-alloc variance --error-feedback`` through ``torchrun
   --nproc-per-node 1`` without ``--n-devices`` (this script with
   ``--budget-cli-child``): its ``Budget:`` and ``Worker:`` lines and
   launches (one encode and two decode launches per width a step).
14. superstep: ``--superstep K``, the sync-free step replayed as a CUDA
   graph. (a) In a deterministic child (this script with
   ``--superstep-child``): ResNet-18 batch 128 qsgd 4 bits, fused, 16 steps
   with augmentation and an LR change at step 8, as single eager steps, as
   graph blocks of 8 and of 3 (a tail block of 1): per-step losses,
   parameters, buffers and momentum equal bit for bit, rows 1-2 launched
   once a step each way, the replays counted. (b) In this process: the same
   step at K = 1 and K = 8 (graph) timed without the profiler (median step
   ms; K = 8 a block's wall over 8) and under it (wall, device busy, idle
   share); rows 1-2 as one replayed graph each (the tree encode in its
   device-key form, the tree decode) by CUDA events beside their eager
   event wall and device time; svd rank 3 in the eager block against K = 1;
   the data-parallel step at NCCL world 1, qsgd gather, as a graph at K = 8
   against K = 1; ``train --superstep 8`` through the CLI on one device and
   under ``torchrun --nproc-per-node 1`` (this script with
   ``--superstep-cli-child``): the mode line ``Superstep: K=8, graph`` and
   ``Worker:`` lines at steps 8 and 16.
15. overlap: ``--stream-encode`` and ``--overlap delayed`` on ResNet-18
   batch 128, qsgd 4 bits gather, 4 MiB layer buckets. In a deterministic
   child at NCCL world 1 (this script with ``--overlap-child``): (a) 3
   streamed steps equal 3 plain ones bit for bit, with the same Msg(MB) and
   one row-1 launch a bucket (10 a step); (b) delayed: step 0 leaves
   parameters, momentum and BatchNorm statistics bit-identical, and 4 steps
   equal the two-call oracle (``make_delayed_oracle_steps``) and delayed
   with stream-encode bit for bit; (c) 16 delayed steps as blocks of 8 (a
   CUDA graph by ``graph_rule``) equal the single steps. At once, two gloo
   ranks on the card (this script with ``--overlap-gloo-child``): (d)
   ``train --n-devices 2 --aggregate gather --code qsgd --overlap delayed
   --stream-encode on``, 6 steps straight and cut at 3 and resumed: the
   replicas and the two runs bit-identical step by step; (e) ``lm --layout
   dp-sp --ways 1 --attn-impl ulysses-flash --n-devices 2 --overlap delayed
   --stream-encode`` at the LM recipe's width (svd): replicas equal, step 0
   skipped, the flash kernel once a layer a step. Then in this process: the
   bucket encodes and the carry's decode against their plain twins, each
   run's median step ms in turns (off, stream, delayed, both), and a
   ``torch.profiler`` trace of the streamed steps (row 1's launches that
   start before backward's last main-stream kernel, their device time
   under it, their stream) and of the delayed steps (row 2's likewise).
16. resilience: ``--grad-guard`` on ResNet-18 batch 128, qsgd 4 bits. In a
   deterministic child (this script with ``--resilience-child``), ``--chaos
   nan@3`` skips step 3 (its state equals step 2's bit for bit, every later
   loss finite) one step at a time and as the K = 8 CUDA graph, which
   equals the eager steps bit for bit; then, through the CLI in that
   process, the straight ResNet-18 run and the LeNet ``spike@7:3
   --on-diverge skip`` drill (a rollback, exit 0). At once, the drills that
   end processes, as processes of their own (deterministic through a
   sitecustomize on their path): ``kill@5 --max-restarts 1``, held to the
   straight run (the final checkpoints byte for byte), and ``slow@3:60
   --health-timeout 5`` (exit 13).
   Then row 2 with per-replica flags over a 4-replica gathered buffer whose
   replica 2 came from a NaN gradient: equal to its plain twin bit for bit,
   within 2 ulp of the three survivors' decode rescaled, its device ms
   beside the unflagged launch's; and the step ms with the guard and
   without it, eager and as the graph, in turns.
17. obs: the flight recorder and the quality probes. ``train --obs-record
   --obs-quality`` on ResNet-18 batch 128 with qsgd 4 bits and svd rank 3,
   6 steps each into a scratch train dir: one ``step`` record a step with
   62 finite per-layer errors, ``report --strict`` over the dir exits 0 and
   reads consistent, rows 1-2 once a step each (one device: the probe reads
   the step's own decode). The data-parallel step at NCCL world 1 with the
   probe: row 2 twice a step (the gather's decode and the probe's decode of
   the rank's own payload). Row 2's probe decode (one replica) of the
   ResNet-18 tree at 4 bits: its ``q_err2`` against the one through row 2's
   plain twin (rtol 1e-6; the decodes bit for bit), and its device ms
   beside its bound. In the superstep phase's deterministic child: the
   probe armed, 16 eager steps and 2 graph blocks of 8 give the same
   ``q_err2`` series step for step, and both end in the state of the
   unarmed eager run, bit for bit. Then the median step ms armed and off,
   eager and at K = 8 (qsgd a graph, svd rank 3 the eager block), in two
   turns.
18. timeline: the trace-based phase timeline, ``--phase-metrics``,
   ``--fabric measured`` and the online budget re-allocation. In a
   deterministic child at NCCL world 1 (this script with
   ``--timeline-child``): ``distributed_train_loop`` with ``profile_dir``
   and the flight recorder on ResNet-18 batch 128, qsgd 4 bits eager (steps
   2-4 traced) and as the K 8 graph (the second block traced, its capture
   profiled into the phase map), svd rank 3 eager; ``report timeline
   --strict`` reads each consistent; each dispatch's encode (decode) busy
   holds row 1's (row 2's) kernels, which the timeline puts there, and the
   window's encode (decode) busy is at least 0.9 x row 1's (row 2's) device
   ms timed alone in the `time` phase; eagerly the events the timeline gives
   each phase fill its ``step.*`` range's device spans (Kineto's own
   ``gpu_user_annotation``, which ``profile_steps`` reads, in the same
   trace) edge to edge within 2 us, none of them outside; as the graph each
   phase's busy ms a step is within 25 % of the eager run's; then 4 phased
   steps (``phase_metrics``) equal the fused gather loop's parameters bit
   for bit, with non-zero Comp/Encode/Comm seconds. At once, two gloo ranks
   on the card (this script with ``--timeline-gloo-child``, deterministic
   through a sitecustomize): ``train --fabric measured`` (ResNet-18 qsgd, 2
   steps) writes a complete ``fabric_probe.json`` (host buffers, the gloo
   backend named), prices and trains as ``--fabric <its GB/s>`` (the same
   ``--aggregate auto`` line, ``model_step_2`` byte for byte) and is
   reused on ``--resume``; ``--budget-alloc variance --obs-record
   --obs-quality --save-freq 8`` (16 steps) re-allocates at step 8 (the
   recorded series with the largest sub-16-bit leaf's error times 1e4:
   ``tl_doctor_series``), and the same run killed at step 12 and resumed
   writes the straight run's ``model_step_16`` byte for byte. Rows 1-2 at
   the re-allocated widths equal their plain twins (``mixed_tree_check``).
   ``profile_steps`` (the ``profile ...`` lines) reads its trace through
   the timeline module too.
19. partition: the sharded weight update (``mesh/update.py``). In a
   deterministic child at NCCL world 1 (this script with
   ``--partition-child``): ResNet-18 batch 128, qsgd 4 bits and svd rank 3,
   the replicated and the sharded-update step 6 steps each from one init,
   the sharded step's parameters and momentum equal to the replicated
   step's bit for bit, and the qsgd sharded step as the K 8 graph (one
   warm-up, 5 replays) equal to its eager steps. At once, two gloo ranks on
   the card (``--partition-gloo-child``): ResNet-18 qsgd 3 steps and AlexNet
   at 224 (1000 classes, 61 M parameters) 1 step under the replicated,
   ZeRO-1 and sharded-update steps, each rank's bytes between steps
   (``memory_allocated``, gradients dropped, after one warm-up step) and its
   peak, the states equal across the three; and the supervised drill
   (``--partition-drill-child`` under ``run_supervised``):
   ``distributed_train_loop`` with the sharded update and ``--overlap
   delayed`` at NCCL world 1, killed before step 5 and restarted once,
   writes the straight run's ``model_step_6`` byte for byte (the CLI
   refuses ``--overlap delayed`` on one device, as the JAX verb does, so
   the drill drives the loop). Then, in this process, the replicated and
   the sharded eager steps timed in turns at NCCL world 1 (qsgd, svd3) and
   the materialize alone.
20. quorum: bounded-staleness quorum aggregation (``quorum/``, the
   ``quorum=`` step). In this process row 2's survivor mode (the kernel
   divides by max(kept, 1), the count read from the flags on the card)
   over a 4-replica gathered buffer of the ResNet-18 tree with 0, 1, 2 and
   4 replicas flagged out, each against its plain twin bit for bit, all up
   against the unflagged mean, a flagged-out replica's NaN bytes never
   read; its device ms beside the flagged form's and its bound. At once,
   two gloo ranks on the card (``--quorum-gloo-child``, deterministic, one
   pair of processes for every run): ResNet-18 qsgd 4 bits gather 6 steps
   ``train --quorum 1 --staleness 1 --quorum-period-ms 100`` under
   ``slow@3:1:0.25``, its ``--replay-arrivals`` (the same final checkpoint
   byte for byte), blocking under the same chaos (the median step ms of
   steps 4-6 beside the quorum run's), and svd rank 3 3 steps: the replicas
   bit-identical after every step, the recorded ``quorum_kept`` and
   ``stale_dropped`` columns equal to the schedule, the schedule equal to
   the one the chaos table gives. The ring stays out (gloo's send and
   receive of CUDA tensors, probed by ``dist gloo-2``).

21. topology: two-tier hierarchical aggregation (``topology/``, the
   ``aggregate='hierarchical'`` step). Four gloo ranks on the card
   (``--topology-gloo-child``, deterministic, one process a rank for every
   run) over the ``(dp=2, ici=2)`` mesh, ResNet-18 through ``train``: (1)
   qsgd 4 bits 3 steps, ``--aggregate auto --dcn-ways 2 --plan psum+gather
   --fabric measured`` (the two-tier probe writes both tiers, the advisory
   prices the pinned plan from them, the planner's own pick on that fabric
   is logged); (2) the same under ``--grad-guard --chaos nan@2`` (group 0
   masked at step 2, kept 1 of 2); (3) svd rank 3, the legacy plan, 2
   steps. The replicas bit-identical after every step, Msg(MB) one payload
   on the slow tier, one row-1 and one row-2 launch a step, and each of
   rank 0's outer decodes (over the K = 2 gathered rows; flagged under the
   guard) equal to its plain twin bit for bit. In this process row 2's
   flagged form over two outer rows of the ResNet-18 tree, group 0 out,
   against its plain twin and timed beside its bound. The plans with a ring
   stay out (gloo's send and receive of CUDA tensors).

Prints a ``kernels`` JSON line (row 5 with its ``bf16`` form, row 2's
survivor mode as an entry of its own), the card's name and power limit,
and last
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
T_START = time.time()  # this process's start, for the children's set-up seconds
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
           "--momentum", "0.9", "--seed", "0", "--log-interval", "1", "--device", "cuda",
           "--aggregate", "gather"]


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


def device_ms(fn, kernel: str, reps: int = 10, tries: int = 4) -> float:
    """Milliseconds a call of ``fn()`` keeps the card busy in kernels whose
    name holds ``kernel``, from ``torch.profiler`` over ``reps`` calls. A
    session that records no device activity at all is taken again, up to
    ``tries`` sessions in all (one such session in a run of dozens has been
    seen, and two in a row once)."""
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
    """Where a step's time goes: a ``--profile-dir`` trace
    (:func:`atomo_tpu_torch.utils.tracing.profile`) over ``steps`` calls of
    ``step_once()`` (after two warm-up calls), read by the timeline module
    (:mod:`atomo_tpu_torch.obs.timeline`): the device's busy time (every
    attributed kernel, copy and set) against the host's wall time, each
    ``step.*`` phase's host time and its span on the device's timeline
    (Kineto's ``gpu_user_annotation``), the timeline's busy / exposed /
    hidden split by phase, and the kernels that take the most."""
    import tempfile

    import torch

    from atomo_tpu_torch.obs.timeline import (
        PHASES,
        build_timeline,
        latest_trace,
        parse_trace,
        phase_totals,
    )
    from atomo_tpu_torch.utils.tracing import profile

    for _ in range(2):
        step_once()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with profile(tmp, device="cuda"):
            t0 = time.perf_counter()
            for _ in range(steps):
                step_once()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        trace = parse_trace(latest_trace(tmp))
        doc = build_timeline(tmp, trace=trace)
    totals = phase_totals(doc)
    busy_ms = (totals["compute_ms"] + sum(totals[p]["busy_ms"] for p in PHASES)) / steps
    phases: dict = {}
    kernels: dict = {}
    for e in trace["events"]:
        cat, name, ms = e.get("cat"), str(e["name"]), float(e.get("dur", 0.0)) / 1e3 / steps
        if name.startswith("step.") and cat in ("user_annotation", "gpu_user_annotation"):
            ph = phases.setdefault(name, {"host_ms": 0.0, "device_span_ms": 0.0})
            ph["host_ms" if cat == "user_annotation" else "device_span_ms"] += ms
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += ms
            k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    out = {"steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
           "phases": phases,
           "timeline": {p: {k: v / steps for k, v in totals[p].items()} for p in PHASES},
           "top_kernels": [{"name": n[:90], "ms_per_step": ms, "count_per_step": c / steps}
                           for n, (ms, c) in top]}
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    log(f"profile {label}: wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step, "
        f"idle share {out['device_idle_share']:.3f}")
    for k, v in sorted(phases.items()):
        log(f"profile {label} phase {k}: host {v['host_ms']:.3f} ms, device span "
            f"{v['device_span_ms']:.3f} ms")
    log(f"profile {label} timeline ms/step: " + ", ".join(
        f"{p} busy {t['busy_ms']:.3f} exposed {t['exposed_ms']:.3f} hidden {t['hidden_ms']:.3f}"
        for p, t in out["timeline"].items()))
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


def zoo_tree_check(grads, label: str, errs: dict, *, replicas=(1, 2), layouts=None) -> dict:
    """Rows 1-4 on a model's real gradient tree at 4 bits against their plain
    twins: the encode's tree launch (Philox seeds and given uniforms: words
    bit for bit, scales within 1 ulp), the tree decode (1 and 2 replicas),
    the tree unpack and the tree pack, bit for bit; the launches each call
    made (rows 1, 2 and 4: 256 leaves a launch; row 3: one); the device
    time of rows 1 and 2 beside their bound. ``layouts`` (per leaf, as the
    model's ``convert.jax_layouts``; by default every leaf transposed) says
    which leaves the JAX view transposes: the encode reads and the decode
    writes each leaf as the main path does."""
    import torch

    from atomo_tpu_torch import ops
    from atomo_tpu_torch.codecs import QsgdCodec
    from atomo_tpu_torch.convert import jax_view
    from atomo_tpu_torch.ops import qsgd_kernels as K

    codec, bits = QsgdCodec(bits=4), 4
    dev = grads[0].device
    layouts = [True] * len(grads) if layouts is None else list(layouts)
    tree = [codec._clip_leaf(jax_view(g, tr).reshape(-1).contiguous())
            for g, tr in zip(grads, layouts)]
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
        dk = K.unpack_dequantize_tree(pay, grads, layouts, bits=bits, n_replicas=n_rep)
        launches["unpack_dequantize"] = ops.launch_counts()["unpack_dequantize"]
        dp = K.unpack_dequantize_tree_plain(pay, grads, layouts, bits=bits, n_replicas=n_rep)
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
        "unpack_dequantize": (lambda: K.unpack_dequantize_tree(payloads, grads, layouts,
                                                               bits=bits),
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


# ----------------------------------------------------------- the sparse phase

SPARSE_ROWS = 1 << 24  # the CLI's largest table (--emb-rows): 268,435,456 values at dim 16
SPARSE_DIM, SPARSE_SLOTS, SPARSE_BATCH, SPARSE_STEPS = 16, 8, 128, 3
# the README recipe (--dataset zipf --network embedding, 4096 x 16) through the CLI
SPARSE_ARGS = ["train", "--dataset", "zipf", "--network", "embedding", "--code", "qsgd",
               "--batch-size", "128", "--lr", "0.1", "--momentum", "0.9", "--seed", "1",
               "--log-interval", "1", "--eval-freq", "0", "--train-dir", "", "--device", "cuda"]
SPARSE_GLOO_ARGS = SPARSE_ARGS + ["--n-devices", "2", "--aggregate", "gather", "--sparse-rows",
                                  "on", "--max-steps", str(SPARSE_STEPS)]


def sparse_recipe() -> dict:
    """(a) The README recipe on one card through the CLI, 30 steps: the mean
    loss of the last 5 below that of the first 5, one encode and one decode
    launch a step."""
    steps = 30
    r = run_cli(SPARSE_ARGS + ["--max-steps", str(steps)],
                ["quantize_pack", "unpack_dequantize"])
    q = r["losses"]
    if not statistics.mean(q[-5:]) < statistics.mean(q[:5]):
        raise AssertionError(f"sparse recipe: the loss did not fall: {q}")
    if r["launches"]["quantize_pack"] != steps or r["launches"]["unpack_dequantize"] != steps:
        raise AssertionError(f"sparse recipe: launches {r['launches']}, want {steps} each way")
    r["median_step_ms_after_first"] = statistics.median(r["step_ms"][1:])
    log(f"sparse recipe (4096 x 16, batch 128, 30 steps): first 5 mean loss "
        f"{statistics.mean(q[:5]):.4f}, last 5 {statistics.mean(q[-5:]):.4f}, launches "
        f"{r['launches']}, Msg(MB) {r['msg_mb']}, median step ms "
        f"{r['median_step_ms_after_first']:.3f}")
    return r


def sparse_table_checks(rc, g, errs) -> dict:
    """The row codec on the big table's real gradient: the card's encode
    equal to the plain encode of the same gradient on the CPU, the decode
    lossless, their times beside the bound (the gradient read once and the
    payload written once; the decode: the payload read, the table written);
    then rows 1-2 (and 3-4) on the 268 M-value leaf against their twins
    (:func:`zoo_tree_check`)."""
    import torch

    p = rc.encode(0, g)
    want = rc.encode(0, g.cpu())
    if not all(torch.equal(a.cpu(), b) for a, b in zip(p, want)):
        raise AssertionError("sparse: the row encode on the card differs from the CPU's")
    if not torch.equal(rc.decode(p, g.shape), g):
        raise AssertionError("sparse: the row decode on the card is not lossless")
    payload = sum(t.numel() * t.element_size() for t in p)
    table = g.numel() * 4
    out = {"touched_rows": int((g != 0).any(dim=1).sum()), "budget": rc.max_rows,
           "payload_bytes": payload}
    for name, fn, nbytes in (("encode", lambda: rc.encode(0, g), table + payload),
                             ("decode", lambda: rc.decode(p, g.shape), table + payload)):
        b_ms, b_by = bound(nbytes, 0)
        out[name] = {"ms": cuda_ms(fn, reps=10, warmup=2), "bound_ms": b_ms, "bound_by": b_by}
    del want
    # the table lies alike in both packages: no transposed view
    out["tree"] = zoo_tree_check([g], "sparse table", errs, replicas=(1,), layouts=[False])
    if out["tree"]["launches"] != {k: 1 for k in out["tree"]["launches"]}:
        raise AssertionError(f"sparse table: tree launches {out['tree']['launches']}")
    log(f"sparse table: {g.shape[0]} x {g.shape[1]} gradient, {out['touched_rows']} rows "
        f"touched of a budget of {rc.max_rows}: the row encode on the card equals the CPU's, "
        f"the decode is lossless; row encode {out['encode']['ms']:.4f} ms, decode "
        f"{out['decode']['ms']:.4f} ms by events (bound {out['encode']['bound_ms']:.4f} ms by "
        f"bytes each)")
    return out


def sparse_big_table(work: Path, errs: dict) -> dict:
    """(b) ``make_distributed_train_step(hybrid=plan)`` at NCCL world 1 on
    the CLI's largest table (2^24 x 16), batch 128, slots 8, fused and on
    the pack path, against the all-dense qsgd step (the table through rows
    1-2), 3 steps each; then the
    lossless ``DenseCodec`` hybrid against ``hybrid=None``, equal bit for
    bit. The plan comes from the first batch's gradient on the card."""
    import torch

    from atomo_tpu_torch import ops
    from atomo_tpu_torch.codecs import DenseCodec, QsgdCodec
    from atomo_tpu_torch.convert import jax_layouts
    from atomo_tpu_torch.data import to_device, zipf_dataset
    from atomo_tpu_torch.models import EmbeddingTower
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.replicated import make_distributed_train_step
    from atomo_tpu_torch.sparse import infer_row_bounds, leaf_specs, measured_densities, plan_hybrid
    from atomo_tpu_torch.training import TrainState, make_optimizer
    from atomo_tpu_torch.training.trainer import init_params, leaf_params

    dev = torch.device("cuda", 0)
    t0 = time.time()
    ds = zipf_dataset(True, rows=SPARSE_ROWS, slots=SPARSE_SLOTS,
                      size=SPARSE_BATCH * SPARSE_STEPS, seed=1)
    b = SPARSE_BATCH
    batches = [to_device(ds.images[i * b:(i + 1) * b], ds.labels[i * b:(i + 1) * b], dev)
               for i in range(SPARSE_STEPS)]
    model = EmbeddingTower(rows=SPARSE_ROWS, dim=SPARSE_DIM, slots=SPARSE_SLOTS)
    init_params(model, 1)
    init_sd = {k: v.to(dev) for k, v in model.state_dict().items()}
    del model
    setup_s = time.time() - t0
    opt = make_optimizer("sgd", lr=0.1, momentum=0.9)

    def fresh():
        with torch.device(dev):
            m = EmbeddingTower(rows=SPARSE_ROWS, dim=SPARSE_DIM, slots=SPARSE_SLOTS)
        m.load_state_dict(init_sd)
        return m, TrainState(0, m, opt.init(leaf_params(m)))

    model, _ = fresh()
    x, y = batches[0]
    loss = torch.nn.functional.cross_entropy(model(x), y)
    grads = [g.detach() for g in torch.autograd.grad(loss, leaf_params(model))]
    specs = leaf_specs(model)
    dens = measured_densities(grads, jax_layouts(model))
    bounds = infer_row_bounds(specs, SPARSE_BATCH, SPARSE_SLOTS)
    plans = {"qsgd": plan_hybrid(QsgdCodec(bits=4), specs, dens, bounds),
             "dense": plan_hybrid(DenseCodec(), specs, dens, bounds)}
    plan = plans["qsgd"]
    log(plan.describe())
    for a in plan.assignments:
        log(f"  [{a.index}] {a.name}: {a.reason}")
    if plan.sparse_idxs != (4,) or plans["dense"].sparse_idxs != (4,):
        raise AssertionError(f"sparse: the table is not sparse-assigned: {plan.describe()}")
    out = {"plan": plan.describe(), "setup_s": setup_s,
           "checks": sparse_table_checks(plan.row_codec(4), grads[4], errs)}
    del model, loss, grads
    torch.cuda.empty_cache()
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/sparse_nccl1",
                      world_size=1, rank=0)
    runs, final = {}, {}
    try:
        for label, codec, hybrid in (("qsgd_hybrid", QsgdCodec(bits=4), plans["qsgd"]),
                                     ("qsgd_pack_hybrid", QsgdCodec(bits=4, use_kernel=False),
                                      plans["qsgd"]),
                                     ("qsgd_dense", QsgdCodec(bits=4), None),
                                     ("dense_hybrid", DenseCodec(), plans["dense"]),
                                     ("dense_off", DenseCodec(), None)):
            model, state = fresh()
            step = make_distributed_train_step(model, opt, codec, aggregate="gather",
                                               hybrid=hybrid)
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            losses, ms, m = [], [], None
            for xb, yb in batches:
                t1 = time.perf_counter()
                state, m = step(state, 2, xb, yb)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t1) * 1e3)
            r = runs[label] = {
                "losses": losses, "step_ms": ms, "median_step_ms": statistics.median(ms[1:]),
                "msg_bytes": int(m["msg_bytes"]), "launches": ops.launch_counts(),
                "row_overflow": float(m["row_overflow"]) if "row_overflow" in m else None,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"sparse {label}: losses {losses}")
            if label in ("qsgd_hybrid", "qsgd_dense"):  # where the step's time goes
                box = {"state": state, "i": 0}

                def once():
                    xb, yb = batches[box["i"] % len(batches)]
                    box["i"] += 1
                    box["state"], mb = step(box["state"], 2, xb, yb)
                    float(mb["loss"])

                r["profile"] = profile_steps(f"sparse nccl-1 {label}", once)
                state = box["state"]
                del box, once  # the next run's peak memory must not hold this state
            if label.startswith("dense"):
                final[label] = [p.detach().clone() for p in leaf_params(model)]
            del model, state, step
            torch.cuda.empty_cache()
            log(f"sparse nccl-1 {label}: losses {losses} launches {r['launches']} Msg(MB) "
                f"{r['msg_bytes'] / 2 ** 20:.4f} row_overflow {r['row_overflow']} median step "
                f"ms (steps 2-3) {r['median_step_ms']:.3f} peak GiB {r['peak_gib']:.2f}")
    finally:
        launch.shutdown()
    for label, hybrid in (("qsgd_hybrid", plans["qsgd"]), ("qsgd_pack_hybrid", plans["qsgd"]),
                          ("dense_hybrid", plans["dense"])):
        r = runs[label]
        if r["msg_bytes"] != hybrid.payload_bytes() or r["row_overflow"] != 0.0:
            raise AssertionError(f"sparse {label}: Msg {r['msg_bytes']} bytes (plan "
                                 f"{hybrid.payload_bytes()}), row_overflow {r['row_overflow']}")
    fused = {"quantize_pack": SPARSE_STEPS, "unpack_dequantize": SPARSE_STEPS}
    pack = {"pack_bucketed": SPARSE_STEPS, "unpack_bucketed": SPARSE_STEPS}
    for label, once in (("qsgd_hybrid", fused), ("qsgd_pack_hybrid", pack),
                        ("qsgd_dense", fused)):
        if runs[label]["launches"] != {**{k: 0 for k in runs[label]["launches"]}, **once}:
            raise AssertionError(f"sparse {label}: launches {runs[label]['launches']}, want "
                                 f"one encode and one decode a step")
    if not all(torch.equal(a, b) for a, b in zip(final["dense_hybrid"], final["dense_off"])):
        raise AssertionError("sparse: the DenseCodec hybrid's parameters differ from "
                             "hybrid=None's")
    log("sparse nccl-1: the DenseCodec hybrid and hybrid=None end equal bit for bit after "
        f"{SPARSE_STEPS} steps; the qsgd hybrid's wire {plans['qsgd'].payload_bytes()} bytes, "
        f"the all-dense qsgd step's {runs['qsgd_dense']['msg_bytes']}")
    out["runs"] = runs
    return out


def sparse_gloo_child(rank: int, store: str, out_path: str) -> int:
    """One rank of the sparse phase's (c) (this script with
    ``--sparse-gloo-child``): the README recipe through ``train --n-devices 2
    --aggregate gather --sparse-rows on`` over gloo on cuda:0; writes its
    log lines, launches and a hash of its final state (JSON)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import cli, ops
    from atomo_tpu_torch.parallel import launch

    launch.initialize(torch.device("cuda", 0), backend="gloo", init_method=f"file://{store}",
                      world_size=2, rank=rank)
    lines: list[str] = []
    try:
        ops.reset_launch_counts()
        state = cli.cmd_train(cli.build_parser().parse_args(SPARSE_GLOO_ARGS),
                              log_fn=lines.append)
        out = {"lines": lines, "launches": ops.launch_counts(), "hash": state_hash(state.model)}
    finally:
        launch.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def sparse_gloo2(work: Path) -> dict:
    """(c) Two ranks over gloo on the one card through the CLI: the plan
    printed, one encode and one decode launch a step on each rank, the
    replicas bit-identical at the end, Msg(MB) the plan's."""
    paths = [work / f"sparse_gloo{r}.json" for r in range(2)]
    rcs, logs = spawn_ranks(lambda r: ["--sparse-gloo-child", str(r),
                                       str(work / "sparse_gloo_store"), str(paths[r])],
                            work, "sparse_gloo", timeout=300)
    if any(rcs):
        raise AssertionError("sparse gloo-2: a rank failed:\n" + "\n".join(
            t[-3000:] for t in logs))
    ranks = [json.loads(p.read_text()) for p in paths]
    lines = ranks[0]["lines"]
    plan = [ln for ln in lines if ln.startswith(("hybrid plan:", "  ["))]
    worker = [ln for ln in lines if ln.startswith("Worker: ")]
    msg = sorted({float(ln.split("Msg(MB): ")[1].split(",")[0]) for ln in worker})
    once = {"quantize_pack": SPARSE_STEPS, "unpack_dequantize": SPARSE_STEPS}
    if not plan or not plan[0].startswith("hybrid plan: 1/5 leaves sparse-row"):
        raise AssertionError(f"sparse gloo-2: no plan printed: {lines[:8]}")
    if ranks[0]["hash"] != ranks[1]["hash"]:
        raise AssertionError("sparse gloo-2: the replicas differ")
    for r in ranks:
        if r["launches"] != {**{k: 0 for k in r["launches"]}, **once}:
            raise AssertionError(f"sparse gloo-2: launches {r['launches']}")
    if len(worker) != SPARSE_STEPS or len(msg) != 1 or ranks[1]["lines"]:
        raise AssertionError(f"sparse gloo-2: Worker lines {worker}")
    for ln in plan + worker:
        log("  " + ln)
    log(f"sparse gloo-2: train --n-devices 2 --aggregate gather --sparse-rows on, "
        f"{SPARSE_STEPS} steps: replicas bit-identical, launches per rank {ranks[0]['launches']},"
        f" Msg(MB) {msg[0]}")
    return {"plan": plan, "worker": worker, "launches": ranks[0]["launches"], "msg_mb": msg}


def phase_sparse(work: Path, errs: dict) -> dict:
    """The embedding tower over zipf data with the sparse-row hybrid
    exchange: (a) the README recipe on one card, (b) the hybrid step at NCCL
    world 1 on the 2^24 x 16 table against the all-dense step, (c) the CLI
    over two gloo ranks on the card."""
    out = {"recipe": sparse_recipe()}
    out["big_table"] = sparse_big_table(work, errs)
    out["gloo2"] = sparse_gloo2(work)
    return out


# ----------------------------------------------------------- the budget phase

BUDGET_STEPS = 30
EF_STEPS, EF_CUT = 10, 5
BUDGET_CLI_STEPS = 5
# (label, CLI codec flags): the allocations of the JAX package's bench config
# 16 comparison, svd rank 3 under --sample fixed_k and qsgd at 4 bits
BUDGET_CODES = [("svd3", ["--code", "svd", "--svd-rank", "3"]),
                ("qsgd4", ["--code", "qsgd", "--quantization-level", "4"])]
ROW_KERNELS = {"quantize_pack": "quantize_pack_kernel",
               "unpack_dequantize": "unpack_dequantize_tree_kernel",
               "pack_bucketed": "pack_codes_tree_kernel",
               "unpack_bucketed": "unpack_codes_tree_kernel"}


def budget_allocation(flags, budget_bytes: float = 0.0):
    """The CLI's ``--budget-alloc variance`` allocation for ResNet-18 at
    batch 128 (its probe gradient over the first 128 training images, its
    printed block): (plain codec, wrapped codec, spectra, allocation)."""
    from atomo_tpu_torch import cli
    from atomo_tpu_torch.budget import budgeted_codec
    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
    from atomo_tpu_torch.models import get_model

    args = cli.build_parser().parse_args(TRAIN_ARGS + flags + [
        "--budget-alloc", "variance", "--budget-bytes", str(budget_bytes)])
    it = BatchIterator(synthetic_dataset(SPECS["cifar10"], True), 128, seed=1)
    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    codec = get_codec(args.code, svd_rank=args.svd_rank or 3,
                      quantization_level=args.quantization_level, sample=args.sample)
    spectra, alloc, _ = cli.budget_allocation(args, model, codec, it,
                                              lambda ln: log("  " + ln))
    return codec, budgeted_codec(codec, alloc.ks), spectra, alloc


def real_resnet_grads(dev):
    """ResNet-18's gradient on the card from one backward pass over the first
    training batch (the model at seed 1)."""
    import torch.nn.functional as F

    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import create_state, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    create_state(model, make_optimizer("sgd"), 1, dev)
    x, y = resnet_batches(dev, 1)[0]
    model.train()
    F.cross_entropy(model(x), y).backward()
    return [p.grad.detach().clone() for p in leaf_params(model)]


def mixed_tree_check(grads, ks, label: str, errs: dict) -> dict:
    """Rows 1-4 on the ResNet-18 gradient tree at per-leaf widths ``ks``,
    against their plain versions on the CPU, each run as the main path runs
    it: the fused path's encode (row 1) and the pack path's (row 3) with
    given uniforms (scales within 1 ulp, the pack path's torch quantizer
    within rtol 1e-6; words bit for bit where the scales are the same
    float), then the gathered decode of 2 replicas read in place (row 2's
    values, row 4's codes, and row 3 packing those codes again), bit for bit
    against the plain versions on the card's payloads. Returns the launches
    each call made (one per distinct width) and the device time of each row
    over the tree, beside its bound by bytes."""
    import torch

    from atomo_tpu_torch import ops
    from atomo_tpu_torch.budget import budgeted_codec
    from atomo_tpu_torch.codecs import QsgdCodec, QsgdPayload, decode_mean_tree, encode_tree
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets

    dev = grads[0].device
    cpu = [g.cpu() for g in grads]
    gen = torch.Generator(device=dev).manual_seed(13)
    u = [[torch.rand((K.geometry(g.numel(), 1).n_buckets, 512), generator=gen, device=dev)
          for g in grads] for _ in range(2)]
    out = {"widths": sorted(set(ks)), "launches": {}, "time": {}}
    for path, enc_row, dec_row in (("fused", "quantize_pack", "unpack_dequantize"),
                                   ("pack", "pack_bucketed", "unpack_bucketed")):
        codec = budgeted_codec(QsgdCodec(bits=4, use_kernel=path == "fused"), ks)
        reps = []
        for r in range(2):
            ops.reset_launch_counts()
            got = encode_tree(codec, 7 + r, grads, draws=u[r])[0]
            out["launches"][f"{path}_encode"] = ops.launch_counts()
            want = encode_tree(codec, 7 + r, cpu, draws=[t.cpu() for t in u[r]])[0]
            for i, (a, b) in enumerate(zip(got, want)):
                sa = a.scales.cpu()
                big = torch.maximum(sa.abs(), b.scales.abs())
                # the fused kernel's scale within 1 ulp of its twin's; the
                # pack path's is torch's vector_norm, whose sum runs in
                # other orders on the card and on the CPU: rtol 1e-6
                tol = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big
                       if path == "fused" else 1e-6 * big)
                same = sa == b.scales
                if not (bool(((sa - b.scales).abs() <= tol).all()) and same_bits(
                        a.words.cpu().view(torch.int32)[same], b.words.view(torch.int32)[same])):
                    raise AssertionError(f"budget check {label} {path}: leaf {i} at "
                                         f"{ks[i]} bits differs from the plain encode")
                if path == "fused":  # the pack path's scales are torch's, not row 3's
                    errs[enc_row] = max(errs[enc_row], float((sa - b.scales).abs().max()))
            reps.append(got)
        packed = [pack_tree_buckets(p) for p in reps]
        views = unpack_tree_buckets(torch.stack([b for b, _ in packed]), packed[0][1])
        ops.reset_launch_counts()
        mean = decode_mean_tree(codec, views, grads, 2)
        torch.cuda.synchronize()
        out["launches"][f"{path}_decode"] = ops.launch_counts()
        if path == "fused":  # row 2's values
            plain = decode_mean_tree(codec, [QsgdPayload(v.words.cpu(), v.scales.cpu())
                                             for v in views], cpu, 2)
            pairs = [(a.cpu(), b) for a, b in zip(mean, plain)]
        else:  # row 4's codes, one launch per width as the pack path's decode makes
            pairs = []  # them, and row 3 packing them again
            for k in sorted(set(ks)):
                group = [v.words for v, w in zip(views, ks) if w == k]
                codes = K.unpack_bucketed_tree(group, bits=k)
                pairs.append((codes.cpu(),
                              K.unpack_bucketed_tree_plain([w.cpu() for w in group], bits=k)))
                check_tree_pack(codes, group, k, errs, f"budget check {label} at {k} bits")
        for i, (a, b) in enumerate(pairs):
            if not torch.equal(a, b):
                raise AssertionError(f"budget check {label} {path}: the gathered decode "
                                     f"differs from the plain one (item {i})")
            errs[dec_row] = max(errs[dec_row], float((a.double() - b.double()).abs().max()))
        n_values = sum(g.numel() for g in grads)
        n_words = sum(p.words.numel() for p in reps[0])
        n_scales = sum(p.scales.numel() for p in reps[0])
        n_pos = sum(p.words.numel() * K.geometry(0, k).vpw for p, k in zip(reps[0], ks))
        one = unpack_tree_buckets(packed[0][0], packed[0][1])
        if path == "fused":
            work = {
                enc_row: (lambda: encode_tree(codec, 7, grads),
                          4 * (n_values + n_words + n_scales)),
                dec_row: (lambda: decode_mean_tree(codec, one, grads, 1),
                          4 * (n_words + n_scales + n_values)),
            }
        else:
            codes = [K.unpack_bucketed(p.words.reshape(-1, p.words.shape[-1]), k)
                     for p, k in zip(reps[0], ks)]
            work = {
                enc_row: (lambda: [K.pack_bucketed(c, k) for c, k in zip(codes, ks)],
                          4 * (n_pos + n_words)),
                dec_row: (lambda: [K.unpack_bucketed(p.words.reshape(-1, p.words.shape[-1]), k)
                                   for p, k in zip(reps[0], ks)], 4 * (n_words + n_pos)),
            }
        for row, (fn, nbytes) in work.items():
            b_ms, b_by = bound(nbytes, 0)
            out["time"][row] = {"device_ms": device_ms(fn, ROW_KERNELS[row], reps=5),
                                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    log(f"budget check {label}: widths {out['widths']} over {len(grads)} leaves: rows 1-4 "
        "equal their plain versions (the encodes with given uniforms, the gathered decode of "
        "2 replicas read in place); launches per call " + ", ".join(
            f"{k} {({n: v for n, v in c.items() if v})}" for k, c in out["launches"].items())
        + "; device ms over the tree " + ", ".join(
            f"{row} {t['device_ms']:.4f} (bound {t['bound_ms']:.4f} by {t['bound_by']})"
            for row, t in out["time"].items()))
    return out


def budget_groups(codec, grads) -> int:
    """Codec calls a tree encode makes: QSGD one per distinct width, SVD one
    per (JAX-layout shape, rank) group."""
    from atomo_tpu_torch.codecs import leaf_codec
    from atomo_tpu_torch.convert import jax_view

    if hasattr(leaf_codec(codec, 0), "bits"):
        return len({leaf_codec(codec, i) for i in range(len(grads))})
    return len({(tuple(jax_view(g).shape), leaf_codec(codec, i)) for i, g in enumerate(grads)})


def budget_densenet_groups() -> dict:
    """DenseNet-BC-190's SVD groups under the svd rank 3 variance allocation
    (probe: the first 8 training images, on the CPU): the encode's shape
    groups, and its SVD groups (one ``eigh`` host sync each) uniform and
    variance."""
    from atomo_tpu_torch.budget import budgeted_codec, measure_spectra, solve_allocation
    from atomo_tpu_torch.codecs import SvdCodec, leaf_codec
    from atomo_tpu_torch.convert import jax_layouts, jax_leaf_paths, jax_view
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.sparse import probe_gradient

    model = get_model("densenet", 10, image_shape=(32, 32, 3))
    it = BatchIterator(synthetic_dataset(SPECS["cifar10"], True), 128, seed=1)
    grads = probe_gradient(model, it.images[:8], it.labels[:8])
    codec = SvdCodec(rank=3)
    alloc = solve_allocation(codec, measure_spectra(codec, grads, jax_leaf_paths(model),
                                                    jax_layouts(model)))
    wrapped = budgeted_codec(codec, alloc.ks)
    shapes = [tuple(jax_view(g).shape) for g in grads]

    def svd_groups(c):
        return len({(s, leaf_codec(c, i)) for i, s in enumerate(shapes)
                    if not leaf_codec(c, i)._dense_fallback(s)})

    out = {"leaves": len(grads), "shape_groups": len(set(shapes)),
           "svd_groups_uniform": svd_groups(codec), "svd_groups_variance": svd_groups(wrapped)}
    log(f"budget densenet svd3: {out['leaves']} leaves in {out['shape_groups']} shape groups; "
        f"SVD groups (an eigh host sync each) uniform {out['svd_groups_uniform']}, variance "
        f"{out['svd_groups_variance']}")
    return out


def budget_pairs(work: Path, allocs: dict) -> dict:
    """(b) ResNet-18 at batch 128 through ``make_distributed_train_step`` at
    NCCL world 1, ``variance`` against ``uniform`` at equal wire bytes
    (``--budget-bytes 0``), svd rank 3 and qsgd 4 bits, 30 steps each from
    one start on the same batches: Msg bytes (the variance total at or under
    the uniform one and equal to ``allocation_payload_bytes``), the median
    step (steps 2 on), the mean loss of the last 5, the SVD groups or QSGD
    launches a step."""
    import torch

    from atomo_tpu_torch.budget import allocation_payload_bytes
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.replicated import make_distributed_train_step, replicate_state
    from atomo_tpu_torch.training import create_state, make_optimizer

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/budget_nccl1",
                      world_size=1, rank=0)
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    batches = resnet_batches(dev, BUDGET_STEPS)
    grads = real_resnet_grads(dev)
    out = {}
    try:
        for label, _ in BUDGET_CODES:
            codec, wrapped, spectra, alloc = allocs[label]
            pair = {}
            for mode, c in (("uniform", codec), ("variance", wrapped)):
                model = get_model("resnet18", 10, image_shape=(32, 32, 3))
                state = replicate_state(create_state(model, opt, 1, dev))
                step = make_distributed_train_step(model, opt, c, aggregate="gather",
                                                   augment=True)
                _, r = run_steps(step, state, batches, sync_check=False)
                r["per_step_launches"] = {k: v / BUDGET_STEPS for k, v in r["launches"].items()}
                r["codec_calls_per_encode"] = budget_groups(c, grads)
                r["last5_mean_loss"] = statistics.fmean(r["losses"][-5:])
                del r["hashes"]
                pair[mode] = r
            want = allocation_payload_bytes(codec, spectra, alloc.ks)
            uni, var = pair["uniform"], pair["variance"]
            if var["msg_bytes"] != want or var["msg_bytes"] > uni["msg_bytes"]:
                raise AssertionError(f"budget {label}: variance Msg {var['msg_bytes']} bytes, "
                                     f"predicted {want}, uniform {uni['msg_bytes']}")
            if label == "qsgd4" and (var["launches"]["quantize_pack"]
                                     != BUDGET_STEPS * var["codec_calls_per_encode"]):
                raise AssertionError(f"budget {label}: launches {var['launches']}")
            for mode in ("uniform", "variance"):
                r = pair[mode]
                log(f"budget nccl-1 {label} {mode}: Msg(MB) {r['msg_bytes'] / 2 ** 20:.4f} "
                    f"({r['msg_bytes']} bytes), median step ms (steps 2-{BUDGET_STEPS}) "
                    f"{r['median_step_ms']:.3f}, mean loss of steps {BUDGET_STEPS - 4}-"
                    f"{BUDGET_STEPS} {r['last5_mean_loss']:.4f}, "
                    + (f"SVD groups {r['codec_calls_per_encode']}" if label == "svd3" else
                       f"QSGD launches per step {r['per_step_launches']}"))
            pair["predicted_bytes"] = want
            out[label] = pair
    finally:
        launch.shutdown()
    return out


def budget_child(work: str, out_path: str) -> int:
    """(c) ``--error-feedback`` at NCCL world 1 in a deterministic process
    (this script with ``--budget-child``; cuBLAS's workspace set before its
    first handle): svd rank 3 ``--sample topk`` and qsgd 4 bits, ResNet-18 at
    batch 128. The first EF step equals the plain step bit for bit (the
    residual starts at zero); ``ef_res_norm`` for steps 1-10; a run cut after
    step 5 (every rank's residual gathered into the checkpoint) and resumed
    equals the straight run bit for bit, residual included."""
    import dataclasses
    import os

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import ops
    from atomo_tpu_torch.codecs import QsgdCodec, SvdCodec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.replicated import make_distributed_train_step, replicate_state
    from atomo_tpu_torch.training import checkpoint as ck
    from atomo_tpu_torch.training import create_state, make_optimizer
    from atomo_tpu_torch.training import trainer as T

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/ef_nccl1", world_size=1,
                      rank=0)
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    batches = resnet_batches(dev, EF_STEPS)
    codecs = {"svd3_topk": SvdCodec(rank=3, sample="topk"), "qsgd4": QsgdCodec(bits=4)}
    out = {}
    try:
        for label in codecs:
            def fresh(ef: bool):
                model = get_model("resnet18", 10, image_shape=(32, 32, 3))
                state = replicate_state(create_state(model, opt, 1, dev))
                return model, state, make_distributed_train_step(
                    model, opt, codecs[label], aggregate="gather", augment=True,
                    error_feedback=ef)

            def run(model, state, step, idx):
                norms, hashes = [], []
                for i in idx:
                    state, m = step(state, 2, *batches[i])
                    norms.append(float(m.get("ef_res_norm", float("nan"))))
                    hashes.append(state_hash(model))
                return state, norms, hashes

            model, state, step = fresh(False)
            _, _, plain = run(model, state, step, [0])
            ops.reset_launch_counts()
            model, state, step = fresh(True)
            state_s, norms, hashes = run(model, state, step, range(EF_STEPS))
            counts = ops.launch_counts()
            model_c, state_c, step_c = fresh(True)
            state_c, _, cut = run(model_c, state_c, step_c, range(EF_CUT))
            d = str(Path(work) / f"ef_{label}")
            ck.save_checkpoint(d, dataclasses.replace(
                state_c, residual=T.gather_residual(state_c, 1)), compress=False)
            model_r, state_r, step_r = fresh(True)
            state_r = T.own_residual(ck.load_checkpoint(d, state_r), model_r, 0, 1, dev)
            state_r, _, resumed = run(model_r, state_r, step_r, range(EF_CUT, EF_STEPS))
            if hashes[0] != plain[0]:
                raise AssertionError(f"ef {label}: step 1 differs from the plain step")
            if cut + resumed != hashes:
                raise AssertionError(f"ef {label}: the resumed run differs from the straight")
            if not all(torch.equal(a, b) for a, b in zip(state_s.residual, state_r.residual)):
                raise AssertionError(f"ef {label}: the resumed residual differs")
            if not all(math.isfinite(v) and v > 0 for v in norms):
                raise AssertionError(f"ef {label}: ef_res_norm {norms}")
            out[label] = {"ef_res_norm": norms, "launches": counts}
    finally:
        launch.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def budget_cli_child(out_path: str) -> int:
    """(d) ``train --code qsgd --budget-alloc variance --error-feedback``
    through the CLI in a ``torchrun --nproc-per-node 1`` process (this
    script with ``--budget-cli-child``), without ``--n-devices``: the whole
    process group, one NCCL rank. Writes its lines and launch counts."""
    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import cli, ops

    lines: list[str] = []
    ops.reset_launch_counts()
    rc = cli.main(TRAIN_ARGS + ["--code", "qsgd", "--quantization-level", "4",
                                "--budget-alloc", "variance", "--error-feedback",
                                "--max-steps", str(BUDGET_CLI_STEPS), "--eval-freq", "0"],
                  log_fn=lines.append)
    Path(out_path).write_text(json.dumps({"rc": rc, "lines": lines,
                                          "launches": ops.launch_counts()}))
    return rc


def phase_budget(work: Path, errs: dict, card: str) -> dict:
    """The per-layer budget allocation and error feedback: (a) rows 1-4 on
    ResNet-18's real gradient at the qsgd variance allocation's widths and at
    a forced allocation of every width 1-16; (b) variance against uniform at
    equal wire bytes; (c) error feedback in a deterministic child; (d) the
    CLI end to end under torchrun. The two children start first and run
    beside (a) and DenseNet's groups; (b), which is timed, runs once they
    are done."""
    import os
    import socket

    import torch

    ef_path = work / "ef.json"
    ef_proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--budget-child",
                                str(work), str(ef_path)], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cli_path = work / "budget_cli.json"
    env = dict(os.environ, OMP_NUM_THREADS=str(os.cpu_count() or 1))  # the CPU probe's threads
    cli_proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                                 "--nproc-per-node", "1", "--master-addr", "127.0.0.1",
                                 "--master-port", str(port), str(Path(__file__).resolve()),
                                 "--budget-cli-child", str(cli_path)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=str(ROOT), env=env)
    allocs = {label: budget_allocation(flags) for label, flags in BUDGET_CODES}
    grads = real_resnet_grads(torch.device("cuda"))
    out = {"check": {
        "allocated": mixed_tree_check(grads, list(allocs["qsgd4"][3].ks), "allocated", errs),
        "every_width": mixed_tree_check(grads, [1 + i % 16 for i in range(len(grads))],
                                        "every width", errs)}}
    del grads
    out["densenet"] = budget_densenet_groups()
    out["ks"] = {label: list(a[3].ks) for label, a in allocs.items()}
    ef_out, ef_err = ef_proc.communicate(timeout=600)
    if ef_proc.returncode != 0:
        raise AssertionError(f"ef: the deterministic runs failed (exit {ef_proc.returncode}):\n"
                             + ef_out[-2000:] + ef_err[-4000:])
    cli_out, cli_err = cli_proc.communicate(timeout=600)
    if cli_proc.returncode != 0 or not cli_path.exists():
        raise AssertionError(f"budget cli: torchrun failed (exit {cli_proc.returncode}):\n"
                             + cli_out[-2000:] + cli_err[-4000:])
    out["pairs"] = budget_pairs(work, allocs)
    out["ef"] = json.loads(ef_path.read_text())
    for label, r in out["ef"].items():
        log(f"ef nccl-1 {label}: ef_res_norm steps 1-{EF_STEPS} "
            + " ".join(f"{v:.6g}" for v in r["ef_res_norm"])
            + f"; step 1 equals the plain step bit for bit; cut after step {EF_CUT} and resumed"
            f" equals the straight run bit for bit (residual included); launches {r['launches']}")
    res = json.loads(cli_path.read_text())
    lines = res["lines"]
    block = [ln for ln in lines if ln.startswith(("budget allocation", "  [", "Budget:"))]
    worker = [ln for ln in lines if ln.startswith("Worker: ")]
    widths = len(set(allocs["qsgd4"][3].ks))
    want = {"quantize_pack": widths * BUDGET_CLI_STEPS,
            "unpack_dequantize": 2 * widths * BUDGET_CLI_STEPS}
    if (len(worker) != BUDGET_CLI_STEPS or not block
            or any(res["launches"][k] != v for k, v in want.items())):
        raise AssertionError(f"budget cli: lines {lines[:12]}, launches {res['launches']}")
    for ln in block + worker:
        log("  " + ln)
    log(f"budget cli (torchrun --nproc-per-node 1, no --n-devices): --code qsgd --budget-alloc "
        f"variance --error-feedback, {BUDGET_CLI_STEPS} steps, launches {res['launches']} "
        f"({widths} widths: one encode launch per width a step, two decode launches per "
        "width a step: the error feedback's own decode and the gathered mean)")
    out["cli"] = {"lines": block + worker, "launches": res["launches"]}
    out["card"] = card
    return out

# ----------------------------------------------------------- the superstep phase

SS_STEPS = 16  # two blocks of 8; six blocks of 3 with a tail of 1
SS_SHRINK = 8  # the LR schedule's change falls at step 8
SS_ARGS = TRAIN_ARGS + ["--code", "qsgd", "--max-steps", str(SS_STEPS), "--eval-freq", "0",
                        "--superstep", "8"]


def ss_resnet(dev, code: str, k: int, optimizer=None, dist_step: bool = False,
              quality: bool = False):
    """ResNet-18 (batch 128, augmentation on) and its step or block step,
    with the quality probes armed where ``quality`` is set."""
    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel.replicated import make_distributed_train_step, replicate_state
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step

    opt = optimizer or make_optimizer("sgd", lr=0.01, momentum=0.9, shrinkage_freq=SS_SHRINK)
    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    state = create_state(model, opt, 1, dev)
    codec = get_codec(code, quantization_level=4, svd_rank=3)
    if dist_step:
        return replicate_state(state), make_distributed_train_step(
            model, opt, codec, aggregate="gather", augment=True, superstep=k,
            track_quality=quality)
    return state, make_train_step(model, opt, codec, augment=True, superstep=k,
                                  track_quality=quality)


def ss_stream():
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset

    return BatchIterator(synthetic_dataset(SPECS["cifar10"], True, size=4096), 128,
                         seed=1).forever()


def ss_run(state, step, k: int, steps: int, stream, timed: bool = False):
    """``steps`` steps of ``step`` (K = 1) or of the block step in blocks of
    ``k`` (the last shrunk): per-step losses (one fetch a block), the state,
    and with ``timed`` each block's wall ms over its steps, block and fetch
    included."""
    import torch

    from atomo_tpu_torch.data import to_device
    from atomo_tpu_torch.data.pipeline import BlockStream, block_to_device

    blocks = BlockStream(stream)
    losses, ms, s = [], [], 0
    while s < steps:
        kb = min(k, steps - s)
        t0 = time.perf_counter()
        if k == 1:
            state, m = step(state, 2, *to_device(*next(stream), "cuda"))
            losses.append(float(m["loss"]))
        else:
            staged = block_to_device(*blocks.take(kb), "cuda")
            torch.cuda.current_stream().wait_event(staged.ready)
            state, m = step(state, 2, staged.images, staged.labels)
            losses += m["loss"].tolist()
        if timed:
            ms.append((time.perf_counter() - t0) * 1e3 / kb)
        s += kb
    return state, losses, ms


def ss_carried(state):
    o = state.opt_state
    return list(state.model.state_dict().values()) + (o.trace or [])


def superstep_child(out_path: str) -> int:
    """The superstep phase's deterministic runs (this script with
    ``--superstep-child``; cuBLAS's workspace setting precedes its first
    handle): 16 ResNet-18 qsgd steps eagerly one by one, then as graph
    blocks of 8 and of 3; then the obs phase's armed runs
    (:func:`obs_deterministic`); writes what it found to ``out_path``."""
    import os

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import ops
    from atomo_tpu_torch.training.graph import mode_line

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    runs = {}
    ref = None
    for k in (1, 8, 3):
        state, step = ss_resnet(dev, "qsgd", k)
        ops.reset_launch_counts()
        state, losses, _ = ss_run(state, step, k, SS_STEPS, ss_stream())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        carried = [t.detach().clone() for t in ss_carried(state)]
        run = {"losses": losses, "launches": counts,
               "mode": mode_line(step) if k > 1 else "per-step",
               "replays": getattr(step, "replays", 0)}
        if ref is None:
            ref = (losses, carried)
        else:
            run["losses_equal"] = losses == ref[0]
            run["state_equal"] = all(
                torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                for a, b in zip(ref[1], carried))
        runs[f"K{k}"] = run
    runs["obs"] = obs_deterministic(dev, ref[1])
    Path(out_path).write_text(json.dumps(runs))
    return 0


def superstep_cli_child(out_path: str) -> int:
    """``train --superstep 8`` through the CLI in a ``torchrun
    --nproc-per-node 1`` process (this script with ``--superstep-cli-child``):
    the data-parallel step over one NCCL rank. Writes its lines and launch
    counts."""
    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import cli, ops

    lines: list[str] = []
    ops.reset_launch_counts()
    rc = cli.main(SS_ARGS, log_fn=lines.append)
    Path(out_path).write_text(json.dumps({"rc": rc, "lines": lines,
                                          "launches": ops.launch_counts()}))
    return rc


def ss_profile(label: str, state, step, k: int, stream, steps: int = SS_STEPS) -> dict:
    """Wall and device-busy ms per step under ``torch.profiler`` over
    ``steps`` steps (blocks of ``k``), after a warm-up block, and the idle
    share. A replayed graph's kernels are traced as kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, _, _ = ss_run(state, step, k, k, stream)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _, _ = ss_run(state, step, k, steps, stream)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda and not e.key.startswith("step.")) / 1e3 / steps
    if busy <= 0:
        raise AssertionError(f"superstep profile {label}: the profiler recorded no device time")
    out = {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / wall}
    log(f"superstep profile {label}: wall {wall:.3f} ms/step, device busy {busy:.3f} ms/step, "
        f"idle share {out['device_idle_share']:.3f}")
    return out


def ss_rows_graph(dev) -> dict:
    """Rows 1-2 on ResNet-18's gradient tree at 4 bits, each as a captured
    graph of its one tree call (the encode in its device-key form) replayed
    20 times, by CUDA events, beside the eager call's event wall (the seeds
    by value, as :func:`phase_time` times it) and the device time of the
    kernel in the replay."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, decode_tree, encode_tree
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.utils.rng import FoldedSeeds

    grads, leaves, _ = resnet_grads(dev)
    codec = QsgdCodec(bits=4)
    key = torch.tensor(17, dtype=torch.int64, device=dev)
    seeds = FoldedSeeds(key, range(len(leaves)))
    by_value = list(seeds)
    payloads, _ = encode_tree(codec, 17, grads)
    out = {}
    # as phase_time times them: the encode's tree call, the whole decode_tree
    for name, kernel, eager_fn, fn in (
            ("quantize_pack", "quantize_pack_kernel",
             lambda: K.quantize_pack_tree(leaves, bits=4, seeds=by_value),
             lambda: K.quantize_pack_tree(leaves, bits=4, seeds=seeds)),
            ("unpack_dequantize", "unpack_dequantize_tree_kernel",
             lambda: decode_tree(codec, payloads, grads),
             lambda: decode_tree(codec, payloads, grads))):
        eager = cuda_ms(eager_fn)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        replay = cuda_ms(g.replay)
        dev_ms = device_ms(g.replay, kernel)
        out[name] = {"graph_ms": replay, "eager_ms": eager, "device_ms": dev_ms}
        log(f"superstep rows {name}: {replay:.4f} ms per call by events as a replayed graph, "
            f"{eager:.4f} ms as the eager call, {dev_ms:.4f} ms of device time")
    return out


def ss_children(work: Path):
    """The phase's two child processes, run at once (they check; they time
    nothing): the deterministic runs (``--superstep-child``) and the CLI
    under ``torchrun --nproc-per-node 1`` (``--superstep-cli-child``)."""
    import os
    import socket

    det_path, cli_path = work / "superstep.json", work / "superstep_cli.json"
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    me = str(Path(__file__).resolve())
    procs = {
        "deterministic": subprocess.Popen(
            [sys.executable, me, "--superstep-child", str(det_path)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=str(ROOT)),
        "torchrun": subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
             "--master-addr", "127.0.0.1", "--master-port", str(port), me,
             "--superstep-cli-child", str(cli_path)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=str(ROOT), env=dict(os.environ))}
    for label, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"superstep {label} child failed (exit {proc.returncode}):\n"
                                 + out[-2000:] + err[-4000:])
    return json.loads(det_path.read_text()), json.loads(cli_path.read_text())


def ss_turns(dev, code: str, turns=(1, 8, 8, 1), steps: int = 8) -> dict:
    """Median ms a step of ``code`` at K = 1 and K = 8, measured in turns
    (K 1, K 8, K 8, K 1: ``steps`` steps a turn, one model each, a warm-up
    block first), so that drift in the host's speed falls on both."""
    runs = {}
    for k in sorted(set(turns)):
        state, step = ss_resnet(dev, code, k)
        stream = ss_stream()
        state, _, _ = ss_run(state, step, k, k, stream)
        runs[k] = [state, step, stream, []]
    for k in turns:
        state, step, stream, ms = runs[k]
        runs[k][0], _, got = ss_run(state, step, k, steps, stream, timed=True)
        ms.append(statistics.median(got))
    from atomo_tpu_torch.training.graph import mode_line

    return {f"K{k}": {"median_step_ms_by_turn": r[3], "median_step_ms": statistics.median(r[3]),
                      "mode": mode_line(r[1]) if k > 1 else "per-step"}
            for k, r in runs.items()}


def phase_superstep(work: Path, card: str) -> dict:
    """``--superstep``: the deterministic child's bit-for-bit check and the
    torchrun CLI (both at once), then in this process the K = 1 / K = 8 step
    times and idle shares, rows 1-2 as replayed graphs, svd3's eager block,
    the NCCL world-1 graph and the CLI on one device (see the module
    docstring, phase 14)."""
    import torch

    from atomo_tpu_torch import ops
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.training.graph import mode_line

    t0 = time.time()
    det, tr = ss_children(work)
    obs_det = det.pop("obs")  # the obs phase's runs, checked there
    seconds = {"children": time.time() - t0}
    for label, r in det.items():
        c = r["launches"]
        if c["quantize_pack"] != SS_STEPS or c["unpack_dequantize"] != SS_STEPS:
            raise AssertionError(f"superstep {label}: launches {c}, want {SS_STEPS} each way")
        if label != "K1" and not (r["losses_equal"] and r["state_equal"] and r["replays"] > 0
                                  and r["mode"].endswith(", graph")):
            raise AssertionError(f"superstep {label}: {r}")
    log(f"superstep deterministic: ResNet-18 qsgd 4 bits, batch 128, {SS_STEPS} steps, "
        f"augmentation on, LR change at step {SS_SHRINK}: K8 ({det['K8']['mode']}, "
        f"{det['K8']['replays']} replays) and K3 ({det['K3']['replays']} replays, tail block "
        f"of 1) equal the eager steps bit for bit (losses, parameters, buffers, momentum); "
        f"rows 1-2 {SS_STEPS} launches each way in each run; losses "
        + " ".join(f"{v:.4f}" for v in det["K1"]["losses"]))
    for ln in tr["lines"]:
        log("  " + ln)
    dev = torch.device("cuda", 0)
    res = {"deterministic": det, "card": card, "obs_deterministic": obs_det}
    t0 = time.time()
    times = {}
    for k in (1, 8):
        state, step = ss_resnet(dev, "qsgd", k)
        stream = ss_stream()
        state, _, ms = ss_run(state, step, k, SS_STEPS + k, stream, timed=True)
        prof = ss_profile(f"qsgd K={k}", state, step, k, stream)
        times[f"qsgd_K{k}"] = {"median_step_ms": statistics.median(ms[1:]), **prof,
                               "mode": mode_line(step) if k > 1 else "per-step"}
    for k, t in ss_turns(dev, "svd").items():
        times[f"svd3_{k}"] = t
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/ss_nccl1", world_size=1,
                      rank=0)
    try:
        for k in (1, 8):
            state, step = ss_resnet(dev, "qsgd", k, dist_step=True)
            ops.reset_launch_counts()
            state, losses, ms = ss_run(state, step, k, SS_STEPS, ss_stream(), timed=True)
            times[f"nccl1_qsgd_K{k}"] = {
                "median_step_ms": statistics.median(ms[1:]), "launches": ops.launch_counts(),
                "mode": mode_line(step) if k > 1 else "per-step",
                "replays": getattr(step, "replays", 0), "losses": losses}
    finally:
        launch.shutdown()
    first = [times[f"nccl1_qsgd_K{k}"]["losses"][0] for k in (1, 8)]
    if not math.isclose(*first, rel_tol=1e-5):  # outside deterministic mode
        raise AssertionError(f"superstep nccl-1: first losses {first} at K 1 and 8")
    for label, t in times.items():
        log(f"superstep {label} ({card}): median step {t['median_step_ms']:.3f} ms, {t['mode']}"
            + (f", idle share {t['device_idle_share']:.3f}" if "device_idle_share" in t else "")
            + (" (turns " + ", ".join(f"{v:.3f}" for v in t["median_step_ms_by_turn"]) + ")"
               if "median_step_ms_by_turn" in t else "")
            + (f", launches {t['launches']}, replays {t['replays']}" if "launches" in t else ""))
    res["times"] = times
    res["rows"] = ss_rows_graph(dev)
    seconds["timing"] = time.time() - t0
    t0 = time.time()
    expect = ["quantize_pack", "unpack_dequantize"]
    single = run_cli(SS_ARGS, expect)
    seconds["cli"] = time.time() - t0
    res["cli"] = {"single": single, "torchrun": tr}
    worker = [int(ln.split("Step: ")[1].split(",")[0]) for ln in tr["lines"]
              if ln.startswith("Worker: ")]
    if "Superstep: K=8, graph" not in tr["lines"] or worker != [8, 16]:
        raise AssertionError(f"superstep cli torchrun: lines {tr['lines'][:6]}")
    if len(single["losses"]) != 2:
        raise AssertionError(f"superstep cli single-device: Worker: lines {single['losses']}")
    for label, counts in (("single-device", single["launches"]), ("torchrun", tr["launches"])):
        if any(counts[n] != SS_STEPS for n in expect):
            raise AssertionError(f"superstep cli {label}: launches {counts}")
    log(f"superstep cli: train --superstep 8, {SS_STEPS} steps, single-device and torchrun "
        f"--nproc-per-node 1: 'Superstep: K=8, graph', Worker: lines at steps 8 and 16, "
        f"launches {single['launches']} / {tr['launches']}")
    log("superstep seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    res["seconds"] = seconds
    res["launches"] = {name: det["K1"]["launches"][name] + det["K8"]["launches"][name]
                       + det["K3"]["launches"][name] + single["launches"][name]
                       + tr["launches"][name]
                       + times["nccl1_qsgd_K1"]["launches"][name]
                       + times["nccl1_qsgd_K8"]["launches"][name] for name in REPLACES
                       if name != "flash_attention"}
    res["launches"]["flash_attention"] = 0
    return res

OV_BUCKET = 4 << 20  # --stream-bucket-mb 4, the default
OV_STEPS = 4  # delayed: the skipped step 0 and three that apply
OV_K = 8
OV_TIMED = 8  # steps a turn
OV_RUNS = {"off": {}, "stream": {"stream_encode": True}, "delayed": {"overlap": "delayed"},
           "both": {"overlap": "delayed", "stream_encode": True}}
OV_GLOO_STEPS = 6
OV_TRAIN = TRAIN_ARGS + ["--code", "qsgd", "--n-devices", "2", "--aggregate", "gather",
                         "--overlap", "delayed", "--stream-encode", "on", "--eval-freq", "0"]
OV_LM_STEPS = 3
OV_LM = LM_ARGS + ["--n-devices", "2", "--overlap", "delayed", "--stream-encode", "--code",
                   "svd", "--max-steps", str(OV_LM_STEPS), "--train-dir", ""]


def ov_resnet(dev, superstep: int = 1, **modes):
    """ResNet-18 (batch 128, augmentation on) with qsgd 4 bits and its
    data-parallel step, gather, in ``modes`` (``stream_encode``,
    ``overlap``; 4 MiB layer buckets); a delayed state carries its fresh
    carry."""
    from atomo_tpu_torch.codecs import QsgdCodec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel.replicated import (
        init_delayed_state,
        make_distributed_train_step,
        replicate_state,
    )
    from atomo_tpu_torch.training import create_state, make_optimizer

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9, shrinkage_freq=SS_SHRINK)
    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    state = replicate_state(create_state(model, opt, 1, dev))
    codec = QsgdCodec(bits=4)
    step = make_distributed_train_step(model, opt, codec, aggregate="gather", augment=True,
                                       stream_bucket_bytes=OV_BUCKET, superstep=superstep,
                                       **modes)
    if modes.get("overlap") == "delayed":
        state = init_delayed_state(state, codec)
    return opt, codec, state, step


def ov_same(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(
        torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


def ov_steps(state, step, batches):
    """The steps over ``batches``, launch counts set to 0 before and read
    after: (state, losses, skipped, msg bytes, launches, stream log)."""
    import torch

    from atomo_tpu_torch import ops

    ops.reset_launch_counts()
    losses, skipped, m = [], [], None
    for x, y in batches:
        state, m = step(state, 2, x, y)
        losses.append(float(m["loss"]))
        skipped.append(float(m["skipped"]) if "skipped" in m else None)
    torch.cuda.synchronize()
    return state, losses, skipped, int(m["msg_bytes"]), ops.launch_counts(), step.stream_log


def overlap_child(work: str, out_path: str) -> int:
    """The overlap phase's deterministic checks (this script with
    ``--overlap-child``; cuBLAS's workspace set before its first handle), at
    NCCL world 1 on ResNet-18 batch 128, qsgd 4 bits gather: (a) 3 streamed
    steps against 3 plain ones; (b) 4 delayed steps against the initial
    state (step 0), the two-call oracle and delayed with stream-encode;
    (c) 16 delayed steps as graph blocks of 8 against single steps."""
    import os

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.overlap import issued_under_backward
    from atomo_tpu_torch.parallel.replicated import make_delayed_oracle_steps
    from atomo_tpu_torch.training.graph import mode_line

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/ov_child", world_size=1,
                      rank=0)
    out: dict = {}
    try:
        batches = resnet_batches(dev, OV_STEPS)
        runs = {}
        for label in ("off", "stream", "delayed", "both"):
            _, _, state, step = ov_resnet(dev, **OV_RUNS[label])
            init = [t.detach().clone() for t in ss_carried(state)]
            n = 3 if label in ("off", "stream") else OV_STEPS
            state, losses, skipped, msg, counts, log_ = ov_steps(state, step, batches[:1])
            first = [t.detach().clone() for t in ss_carried(state)]
            state, more, skip2, msg, counts2, _ = ov_steps(state, step, batches[1:n])
            runs[label] = {"losses": losses + more, "skipped": skipped + skip2, "msg_bytes": msg,
                           "launches": {k: counts[k] + counts2[k] for k in counts},
                           "step0_held": ov_same(init, first),
                           "carried": [t.detach().clone() for t in ss_carried(state)],
                           "n_buckets": step.plan.n_buckets if step.plan else None,
                           "issued_under_backward": (issued_under_backward(log_)
                                                     if log_ else None)}
        # (b)'s oracle: produce step t, then apply step t - 1's carry
        opt, codec, st, _ = ov_resnet(dev)
        oracle = make_delayed_oracle_steps(st.model, opt, codec, aggregate="gather",
                                           augment=True)
        from atomo_tpu_torch.parallel.replicated import init_delayed_state

        carry = init_delayed_state(st, codec).carry
        for x, y in batches:
            new, stats_x, _ = oracle["produce"](st, 2, x, y)
            st, _ = oracle["apply"](st, carry, stats_x)
            carry = new
        torch.cuda.synchronize()
        oracle_equal = ov_same(ss_carried(st), runs["delayed"]["carried"])
        # (c): 16 delayed steps, single and as blocks of 8 (graph by the rule)
        blocks = {}
        for k in (1, OV_K):
            _, _, state, step = ov_resnet(dev, superstep=k, overlap="delayed")
            from atomo_tpu_torch import ops

            ops.reset_launch_counts()
            state, losses, _ = ss_run(state, step, k, SS_STEPS, ss_stream())
            torch.cuda.synchronize()
            blocks[k] = {"losses": losses, "launches": ops.launch_counts(),
                         "carried": [t.detach().clone() for t in ss_carried(state)],
                         "mode": mode_line(step) if k > 1 else "per-step",
                         "replays": getattr(step, "replays", 0)}
        out = {
            "a": {"equal": ov_same(runs["off"]["carried"], runs["stream"]["carried"])
                  and runs["off"]["losses"] == runs["stream"]["losses"],
                  **{f"{k}_{f}": runs[k][f] for k in ("off", "stream")
                     for f in ("losses", "msg_bytes", "launches", "n_buckets",
                               "issued_under_backward")}},
            "b": {"step0_held": runs["delayed"]["step0_held"] and runs["both"]["step0_held"],
                  "skipped": runs["delayed"]["skipped"], "oracle_equal": oracle_equal,
                  "stream_equal": ov_same(runs["delayed"]["carried"], runs["both"]["carried"])
                  and runs["delayed"]["losses"] == runs["both"]["losses"],
                  **{f"{k}_{f}": runs[k][f] for k in ("delayed", "both")
                     for f in ("losses", "msg_bytes", "launches")}},
            "c": {"equal": ov_same(blocks[1]["carried"], blocks[OV_K]["carried"])
                  and blocks[1]["losses"] == blocks[OV_K]["losses"],
                  "mode": blocks[OV_K]["mode"], "replays": blocks[OV_K]["replays"],
                  "losses": blocks[1]["losses"],
                  "launches": {k: blocks[1]["launches"][k] + blocks[OV_K]["launches"][k]
                               for k in blocks[1]["launches"]}},
        }
    finally:
        launch.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def overlap_gloo_child(rank: int, work: str, out_path: str) -> int:
    """One rank of the overlap phase's (d) and (e) (this script with
    ``--overlap-gloo-child``; deterministic, cuBLAS's workspace set first):
    over gloo on cuda:0, ``train`` with ``--overlap delayed --stream-encode
    on`` straight for 6 steps and cut at 3 and resumed, each step's state
    hashed; then ``lm`` with ``--overlap delayed --stream-encode`` for 3
    steps, each step's hash and ``skipped``."""
    import os

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    sys.path.insert(0, str(ROOT))
    import atomo_tpu_torch.parallel.lm as LM
    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch import cli, ops
    from atomo_tpu_torch.parallel import launch

    torch.use_deterministic_algorithms(True, warn_only=True)
    launch.initialize(torch.device("cuda", 0), backend="gloo",
                      init_method=f"file://{work}/ov_gloo_store", world_size=2, rank=rank)
    trace: list = []

    def traced(factory):
        def make(*args, **kw):
            step = factory(*args, **kw)

            def run(state, *a, **k):
                state, m = step(state, *a, **k)
                trace.append((state_hash(state.model), float(m.get("skipped", -1))))
                return state, m

            return run

        return make

    make_step, make_lm = R.make_distributed_train_step, LM.make_lm_train_step
    R.make_distributed_train_step = traced(make_step)
    LM.make_lm_train_step = traced(make_lm)
    out: dict = {}
    try:
        for label, argv in (
                ("straight", OV_TRAIN + ["--max-steps", str(OV_GLOO_STEPS), "--train-dir",
                                         f"{work}/ov_straight", "--save-freq", "3"]),
                ("cut", OV_TRAIN + ["--max-steps", "3", "--train-dir", f"{work}/ov_cut",
                                    "--save-freq", "3"]),
                ("resumed", OV_TRAIN + ["--max-steps", str(OV_GLOO_STEPS), "--train-dir",
                                        f"{work}/ov_cut", "--save-freq", "3", "--resume"]),
                ("lm", OV_LM)):
            lines: list[str] = []
            trace.clear()
            ops.reset_launch_counts()
            args = cli.build_parser().parse_args(argv)
            args.fn(args, log_fn=lines.append)
            torch.cuda.synchronize()
            out[label] = {"lines": lines, "trace": list(trace), "launches": ops.launch_counts()}
    finally:
        R.make_distributed_train_step, LM.make_lm_train_step = make_step, make_lm
        launch.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def ov_children(work: Path):
    """The phase's deterministic children, run at once (they check; they
    time nothing): the NCCL world-1 child and the two gloo ranks."""
    me = str(Path(__file__).resolve())
    det_path = work / "overlap.json"
    gloo_paths = [work / f"overlap_gloo{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, me, "--overlap-child", str(work), str(det_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=str(ROOT))]
    procs += [subprocess.Popen([sys.executable, me, "--overlap-gloo-child", str(r), str(work),
                                str(gloo_paths[r])], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True, cwd=str(ROOT))
              for r in range(2)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=300)[0])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    for label, proc, text in zip(("deterministic", "gloo rank 0", "gloo rank 1"), procs, outs):
        if proc.returncode != 0:
            raise AssertionError(f"overlap {label} child failed (exit {proc.returncode}):\n"
                                 + text[-4000:])
    return (json.loads(det_path.read_text()),
            [json.loads(p.read_text()) for p in gloo_paths])


def ov_check_kernels(grads, errs: dict) -> dict:
    """Rows 1-2 at the shapes the overlap path gives them: each 4 MiB layer
    bucket's tree encode (one launch a bucket, the leaves' global seeds)
    and the consume's tree decode of the carried buffer, against their
    plain twins on the same card tensors."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, decode_mean_tree, encode_leaf_subset
    from atomo_tpu_torch.convert import jax_layouts, jax_view
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel.common import (
        pack_tree_buckets,
        plan_layer_buckets,
        unpack_tree_buckets,
    )
    from atomo_tpu_torch.utils.rng import fold_in

    codec = QsgdCodec(bits=4)
    layouts = jax_layouts(get_model("resnet18", 10, image_shape=(32, 32, 3)))
    plan = plan_layer_buckets(grads, OV_BUCKET)
    payloads = [None] * len(grads)
    for idxs in plan.buckets:
        got = encode_leaf_subset(codec, 12345, grads, idxs, None, layouts)
        tree = [codec._clip_leaf(jax_view(grads[i], layouts[i]).reshape(-1)) for i in idxs]
        want = K.quantize_pack_tree_plain(tree, bits=4, scheme=codec.scheme,
                                          seeds=[fold_in(12345, i) for i in idxs])
        for i, g, (ww, ws) in zip(idxs, got, want):
            if not same_bits(g.words, ww):
                raise AssertionError(f"overlap check: bucket leaf {i}'s words differ")
            torch.testing.assert_close(g.scales, ws, rtol=1e-6, atol=0.0)
            errs["quantize_pack"] = max(errs["quantize_pack"], float((g.scales - ws).abs().max()))
            payloads[i] = g
    buf, spec = pack_tree_buckets(payloads)
    rows = buf.view(1, spec.nbytes)
    got = decode_mean_tree(codec, unpack_tree_buckets(rows, spec), grads, 1, layouts)
    views = unpack_tree_buckets(rows, spec)
    want = K.unpack_dequantize_tree_plain([(v.words, v.scales) for v in views], grads,
                                          layouts, bits=4, n_replicas=1)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    errs["unpack_dequantize"] = max(errs["unpack_dequantize"], err)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("overlap check: the carry's tree decode differs from its plain twin")
    log(f"overlap check: the {plan.n_buckets} bucket encodes of the 4 MiB plan (one row-1 "
        f"launch a bucket) and the carry's tree decode (one row-2 launch) equal their plain "
        f"twins on the card: words and decoded values bit for bit, decode max abs err {err}")
    return {"n_buckets": plan.n_buckets, "decode_max_abs_err": err}


def ov_trace(prof, kernel: str) -> dict:
    """From a profile of delayed or streamed steps: per step, the device
    window of ``step.forward_backward`` up to its last main-stream kernel
    (backward's end), the ``kernel`` launches (row 1 or 2) that start inside
    it or before it (after the previous step's window), the share of their
    device time that lies inside it, and whether they ran on a stream other
    than the main one."""
    import collections

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda]
    kernels = [e for e in evs if not e.name.startswith("step.")]
    if not kernels:
        raise AssertionError("overlap trace: the profiler recorded no device kernels")
    main = collections.Counter(e.device_resource_id for e in kernels).most_common(1)[0][0]
    rows = [e for e in kernels if kernel in e.name]
    windows = sorted((e.time_range.start, e.time_range.end) for e in evs
                     if e.name == "step.forward_backward")
    started, before, inside = 0, 0, 0.0
    total = sum(e.time_range.elapsed_us() for e in rows)
    prev_end = float("-inf")
    for s0, s1 in windows:
        main_in = [e.time_range.end for e in kernels if e.device_resource_id == main
                   and kernel not in e.name and s0 <= e.time_range.start < s1]
        if not main_in:
            continue
        end = max(main_in)
        for e in rows:
            a, b = e.time_range.start, e.time_range.end
            started += s0 <= a < end
            before += prev_end <= a < s0  # done before the step's forward began
            inside += max(0.0, min(b, end) - max(a, s0))
        prev_end = end
    return {"launches": len(rows), "steps": len(windows),
            "started_under_backward": started, "started_before_forward": before,
            "device_us": total, "device_us_under_backward": inside,
            "share_under_backward": inside / total if total else None,
            "on_side_stream": sum(e.device_resource_id != main for e in rows)}


def ov_timing(dev) -> dict:
    """NCCL world 1, in this process: each run's median ms a step, in turns
    (off, stream, delayed, both, both, delayed, stream, off: ``OV_TIMED``
    steps a turn after a warm-up), then 3 profiled steps of stream and of
    delayed with their row-1 and row-2 trace figures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atomo_tpu_torch.data import to_device

    runs = {}
    for label, modes in OV_RUNS.items():
        _, _, state, step = ov_resnet(dev, **modes)
        stream = ss_stream()
        for _ in range(2):
            state, m = step(state, 2, *to_device(*next(stream), "cuda"))
        float(m["loss"])
        runs[label] = [state, step, stream, []]
    for label in ("off", "stream", "delayed", "both", "both", "delayed", "stream", "off"):
        state, step, stream, ms = runs[label]
        got = []
        for _ in range(OV_TIMED):
            t0 = time.perf_counter()
            state, m = step(state, 2, *to_device(*next(stream), "cuda"))
            float(m["loss"])
            got.append((time.perf_counter() - t0) * 1e3)
        runs[label][0] = state
        ms.append(statistics.median(got))
    out = {label: {"median_step_ms_by_turn": r[3], "median_step_ms": statistics.median(r[3])}
           for label, r in runs.items()}
    for label, kernel in (("stream", "quantize_pack"), ("delayed", "unpack_dequantize")):
        state, step, stream, _ = runs[label]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                state, m = step(state, 2, *to_device(*next(stream), "cuda"))
            torch.cuda.synchronize()
        out[label]["trace"] = ov_trace(prof, kernel)
    return out


def phase_overlap(work: Path, card: str, grads, errs: dict) -> dict:
    """``--stream-encode`` and ``--overlap delayed`` (see the module
    docstring, phase 15)."""
    import torch

    from atomo_tpu_torch.parallel import launch

    t0 = time.time()
    det, gloo = ov_children(work)
    seconds = {"children": time.time() - t0}
    a, b, c = det["a"], det["b"], det["c"]
    nb = a["stream_n_buckets"]
    if not a["equal"] or a["off_msg_bytes"] != a["stream_msg_bytes"]:
        raise AssertionError(f"overlap (a): streamed steps differ from the plain ones: {a}")
    if (a["stream_launches"]["quantize_pack"] != 3 * nb
            or a["stream_launches"]["unpack_dequantize"] != 3):
        raise AssertionError(f"overlap (a): launches {a['stream_launches']}, want "
                             f"{3 * nb} row-1 and 3 row-2")
    log(f"overlap (a) stream-encode nccl-1: ResNet-18 qsgd 4 bits gather, 4 MiB buckets: "
        f"{nb} buckets, 3 steps equal the plain steps bit for bit (parameters, buffers, "
        f"momentum; losses {a['off_losses']}), Msg(MB) {a['stream_msg_bytes'] / 2 ** 20:.4f}, "
        f"launches {a['stream_launches']} ({nb} row-1 launches a step), "
        f"{a['stream_issued_under_backward']} buckets issued before backward's last hook")
    if not (b["step0_held"] and b["oracle_equal"] and b["stream_equal"]
            and b["skipped"] == [1.0] + [0.0] * (OV_STEPS - 1)):
        raise AssertionError(f"overlap (b): {b}")
    if (b["delayed_launches"]["quantize_pack"] != OV_STEPS
            or b["delayed_launches"]["unpack_dequantize"] != OV_STEPS - 1
            or b["both_launches"]["quantize_pack"] != OV_STEPS * nb):
        raise AssertionError(f"overlap (b): launches {b['delayed_launches']} / "
                             f"{b['both_launches']}")
    log(f"overlap (b) delayed nccl-1: step 0 skipped with parameters, momentum and BatchNorm "
        f"statistics bit-identical to their initial values; steps 1-{OV_STEPS - 1} equal the "
        f"two-call oracle and delayed with stream-encode bit for bit; skipped {b['skipped']}, "
        f"losses {b['delayed_losses']}, launches {b['delayed_launches']} (delayed) "
        f"{b['both_launches']} (with stream-encode)")
    if not (c["equal"] and c["mode"].startswith(f"Superstep: K={OV_K}")):
        raise AssertionError(f"overlap (c): {c}")
    if c["mode"].endswith("graph") and c["replays"] <= 0:
        raise AssertionError(f"overlap (c): a graph block that never replayed: {c}")
    log(f"overlap (c) delayed K={OV_K} nccl-1: '{c['mode']}', {c['replays']} replays; "
        f"{SS_STEPS} steps equal the single steps bit for bit")
    r0, r1 = gloo
    for label in ("straight", "cut", "resumed", "lm"):
        h0 = [h for h, _ in r0[label]["trace"]]
        if h0 != [h for h, _ in r1[label]["trace"]]:
            raise AssertionError(f"overlap gloo-2 {label}: the replicas differ")
    straight, resumed = r0["straight"]["trace"], r0["resumed"]["trace"]
    if [h for h, _ in straight[3:]] != [h for h, _ in resumed] or len(resumed) != 3:
        raise AssertionError("overlap (d): the resumed run differs from the straight run")
    if [s for _, s in straight] != [1.0] + [0.0] * (OV_GLOO_STEPS - 1):
        raise AssertionError(f"overlap (d): skipped {[s for _, s in straight]}")
    worker = [ln for ln in r0["straight"]["lines"] if ln.startswith("Worker: ")]
    log(f"overlap (d) gloo-2 train --n-devices 2 --overlap delayed --stream-encode on: "
        f"replicas bit-identical after each of {OV_GLOO_STEPS} steps, step 0 skipped, the run "
        f"cut at step 3 and resumed equals the straight run bit for bit; launches rank 0 "
        f"{r0['straight']['launches']}; the gloo exchange is host-staged, so no time is read")
    for ln in worker:
        log("  " + ln)
    lm = r0["lm"]
    if [s for _, s in lm["trace"]] != [1.0] + [0.0] * (OV_LM_STEPS - 1):
        raise AssertionError(f"overlap (e): skipped {[s for _, s in lm['trace']]}")
    if lm["launches"]["flash_attention"] != OV_LM_STEPS * LM_DEPTH:
        raise AssertionError(f"overlap (e): launches {lm['launches']}")
    log(f"overlap (e) gloo-2 lm --layout dp-sp --ways 1 --n-devices 2 --overlap delayed "
        f"--stream-encode (svd, the recipe's width): replicas bit-identical after each of "
        f"{OV_LM_STEPS} steps, step 0 skipped, launches rank 0 {lm['launches']}")
    for ln in lm["lines"]:
        if ln.startswith("LM: "):
            log("  " + ln)
    t0 = time.time()
    dev = torch.device("cuda", 0)
    checks = ov_check_kernels(grads, errs)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/ov_nccl1", world_size=1,
                      rank=0)
    try:
        times = ov_timing(dev)
    finally:
        launch.shutdown()
    seconds["timing"] = time.time() - t0
    for label, t in times.items():
        log(f"overlap time {label} ({card}): median step {t['median_step_ms']:.3f} ms (turns "
            + ", ".join(f"{v:.3f}" for v in t["median_step_ms_by_turn"]) + ")")
    for label, t in times.items():
        if "trace" in t:
            tr = t["trace"]
            log(f"overlap trace {label}: {tr['launches']} launches of "
                f"{'row 1' if label == 'stream' else 'row 2'} over {tr['steps']} steps, "
                f"{tr['started_under_backward']} started between forward's first and "
                f"backward's last main-stream kernel, {tr['started_before_forward']} before "
                f"forward's first, {tr['device_us_under_backward']:.1f} of "
                f"{tr['device_us']:.1f} us of their device time under forward and backward "
                f"(share {tr['share_under_backward']}), {tr['on_side_stream']} on a side "
                "stream")
    log("overlap seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    launches = {name: sum(det[p][f"{k}_launches"][name] for p, k in
                          (("a", "off"), ("a", "stream"), ("b", "delayed"), ("b", "both")))
                + det["c"]["launches"][name]
                + sum(r0[label]["launches"][name] for label in ("straight", "cut", "resumed",
                                                                "lm"))
                for name in REPLACES}
    return {"deterministic": det, "gloo": gloo, "times": times, "checks": checks,
            "seconds": seconds, "card": card, "launches": launches}


# ------------------------------------------------------------ the layouts phase

LAYOUTS = ("dp-tp", "dp-ep", "dp-pp", "dp-tp-sp")
LAYOUT_STEPS = 5  # step ms: the median of steps 2-5
LAYOUT_CFG = dict(vocab_size=256, max_len=1024, width=256, depth=LM_DEPTH, num_heads=4)
LAYOUT_EXTRA = {"dp-tp": [], "dp-ep": ["--num-experts", "8"], "dp-pp": ["--microbatches", "2"],
                "dp-tp-sp": ["--sp-ways", "1", "--attn-impl", "ulysses-flash"]}


def layout_argv(layout: str, code: str, *extra) -> list[str]:
    """``lm --layout <layout> --ways 1`` at the LM recipe (scripts/run_lm_tpu.sh:
    vocab 256, seq 1024, width 256, depth 4, 4 heads, batch 16), the dp
    exchange gather (so Msg(MB) is the codec's payload)."""
    return ["lm", "--layout", layout, "--ways", "1", "--vocab-size", "256", "--seq-len",
            "1024", "--width", "256", "--depth", str(LM_DEPTH), "--num-heads", "4",
            "--batch-size", "16", "--lr", "0.1", "--momentum", "0.9", "--seed", "0",
            "--log-interval", "1", "--device", "cuda", "--train-dir", "", "--aggregate",
            "gather", "--max-steps", str(LAYOUT_STEPS), "--code", code,
            *LAYOUT_EXTRA[layout], *extra]


def layout_program(layout: str, code: str, dev):
    """The program ``lm`` builds for ``layout_argv(layout, code)``, with the
    verb's own config, optimizer, codec and first batch."""
    from atomo_tpu_torch import cli
    from atomo_tpu_torch.mesh.spec import MeshSpec
    from atomo_tpu_torch.parallel import model_axes as MA

    args = cli.build_parser().parse_args(layout_argv(layout, code))
    cfg = cli.lm_config(args)
    if layout == "dp-ep":
        cfg["num_experts"] = args.num_experts
    spec = MeshSpec.from_layout(layout, 1, (1, 1) if layout == "dp-tp-sp" else 1)
    prog = MA.build_model_axis_program(
        spec, cfg, cli.lm_optimizer(args), args.seed, cli.lm_codec(args, lambda _: None),
        layout=layout, attn_impl=args.attn_impl, num_microbatches=args.microbatches,
        aggregate="gather", device=dev)
    return prog, cfg, cli.lm_data(args)[0]()


def stock_lm_logits(tree: dict, tokens, cfg: dict):
    """dp-tp's and dp-tp-sp's oracle: the stock ``TransformerLM`` (its plain
    attention, nothing of the tp forward) loaded with ``tp_params_to_lm`` of
    the family tree."""
    from atomo_tpu_torch.convert import state_dict_from_jax
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.parallel import tp
    from atomo_tpu_torch.parallel.common import map_tree

    lm = TransformerLM(**cfg)
    flat = map_tree(lambda t: t.detach().cpu().numpy(),
                    tp.tp_params_to_lm(tree, cfg["num_heads"]))
    lm.load_state_dict(state_dict_from_jax(lm, flat, {}))
    return lm.to(tokens.device)(tokens)


def moe_lm_by_expert(tree: dict, tokens, cfg: dict, capacity: int):
    """dp-ep's oracle, written apart from ``moe.moe_mlp``: each layer routes
    every token to its top-1 expert, then runs one expert at a time on the
    first ``capacity`` tokens routed to it (in token order) with plain
    matmuls, scaled by the gate; a dropped token's MLP output is zero. No
    slot buffer, no all-to-all, no batched matmul. -> (logits, mean aux)."""
    import torch
    import torch.nn.functional as F

    from atomo_tpu_torch.parallel.common import attention_sublayer, layernorm

    b, s = tokens.shape
    e = cfg["num_experts"]
    pos = torch.arange(s, device=tokens.device)
    x = tree["tok_emb"]["embedding"][tokens] + tree["pos_emb"]["embedding"][pos][None]
    aux = 0.0
    for i in range(cfg["depth"]):
        p = tree[f"block{i}"]
        x = attention_sublayer(p, x, cfg["num_heads"])
        y = layernorm(x, p["ln2"]["scale"]).reshape(b * s, -1)
        probs = torch.softmax((y @ p["router"]["kernel"]).float(), dim=-1)
        expert = torch.argmax(probs, dim=-1)
        mlp = torch.zeros_like(y)
        counts = []
        for j in range(e):
            mine = (expert == j).nonzero()[:, 0]
            counts.append(mine.numel())
            kept = mine[:capacity]
            h = F.gelu(y[kept] @ p["up"]["kernel"][j], approximate="tanh")
            mlp[kept] = (h @ p["down"]["kernel"][j]) * probs[kept, j][:, None]
        share = torch.tensor(counts, dtype=torch.float32, device=y.device) / (b * s)
        aux = aux + e * (share * probs.mean(dim=0)).sum()
        x = x + mlp.reshape(b, s, -1)
    x = layernorm(x, tree["ln_f"]["scale"])
    return x @ tree["head"]["kernel"], aux / cfg["depth"]


def layout_step0(dev) -> dict:
    """Each family's first-step loss against an oracle that shares no code
    with its step's forward, on the same parameters and tokens, float32,
    within 1e-5 relative: dp-tp and dp-tp-sp against the stock LM
    (:func:`stock_lm_logits`; dp-tp-sp's step runs the flash kernel, the
    stock LM the plain attention), dp-ep against :func:`moe_lm_by_expert`
    at the capacity of the whole batch (ep 1: the training capacity) plus
    0.01 times its aux loss, dp-pp against the layer-by-layer reference
    (``pp_lm_forward_reference``) of its GPipe step."""
    import torch
    import torch.nn.functional as F

    from atomo_tpu_torch.convert import jax_leaf_order
    from atomo_tpu_torch.parallel import model_axes as MA
    from atomo_tpu_torch.parallel import moe, pp
    from atomo_tpu_torch.training.trainer import leaf_params

    out = {}
    for layout in LAYOUTS:
        prog, cfg, batch = layout_program(layout, "svd", dev)
        toks = torch.from_numpy(batch).to(dev, torch.int64)
        aux = 0.0
        with torch.no_grad():
            tree = MA.tree_of(jax_leaf_order(prog.state.model),
                              [p.detach().clone() for p in leaf_params(prog.state.model)])
            if layout == "dp-ep":
                cap = moe.expert_capacity(toks.numel(), cfg["num_experts"])
                logits, aux = moe_lm_by_expert(tree, toks, cfg, cap)
            elif layout == "dp-pp":
                logits = pp.pp_lm_forward_reference(tree, toks, cfg)
            else:
                logits = stock_lm_logits(tree, toks, cfg)
            want = F.cross_entropy(logits[:, :-1].reshape(-1, 256), toks[:, 1:].reshape(-1))
            want = want + 0.01 * aux
        _, m = prog.step(prog.state, 1, toks)
        got, want = float(m["loss"]), float(want)
        if not math.isclose(got, want, rel_tol=1e-5):
            raise AssertionError(f"layouts {layout}: step-0 loss {got} vs oracle {want}")
        out[layout] = {"loss": got, "oracle": want}
        log(f"layouts {layout}: step-0 loss {got:.6f} = oracle forward {want:.6f} (rel 1e-5)")
        del prog
    return out


def layout_tp_vs_dp(dev, steps: int = 3) -> dict:
    """dp-tp at tp 1 against dp, ``--code sgd``: the same initialisation
    re-laid, 3 steps on the same batches, losses within 1e-4 relative."""
    import torch

    from atomo_tpu_torch import cli
    from atomo_tpu_torch.mesh.spec import MeshSpec
    from atomo_tpu_torch.parallel import model_axes as MA

    losses = {}
    for layout in ("dp", "dp-tp"):
        argv = layout_argv("dp-tp", "sgd")
        argv[2] = layout
        args = cli.build_parser().parse_args(argv)
        prog = MA.build_model_axis_program(
            MeshSpec.from_layout(layout, 1, 1), cli.lm_config(args), cli.lm_optimizer(args),
            args.seed, None, layout=layout, aggregate="psum", device=dev)
        nxt = cli.lm_data(args)[0]
        state, ls = prog.state, []
        for i in range(1, steps + 1):
            state, m = prog.step(state, i, torch.from_numpy(nxt()).to(dev, torch.int64))
            ls.append(float(m["loss"]))
        losses[layout] = ls
        del prog, state
    for a, b in zip(losses["dp"], losses["dp-tp"]):
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"layouts dp-tp at tp 1 vs dp: losses {losses}")
    log(f"layouts dp-tp (tp 1) vs dp, sgd: losses {losses['dp-tp']} vs {losses['dp']} "
        "(rel 1e-4)")
    return losses


def layout_kernel_checks(dev, errs: dict) -> dict:
    """Rows 1, 2 and 5 at this phase's shapes against their plain versions:
    the fused QSGD encode (one tree launch) and the tree decode over the
    MoE LM's leaves (8 experts stacked, the JAX layout), 4 bits, words bit
    for bit, scales rtol 1e-6, decoded values bit for bit; the flash kernel
    on the head views the tp forward hands it (``einsum('bsw,wthd->tbhsd')``
    of the recipe's activations), float32 within 2e-5 and bfloat16 within
    2e-2 of the float32 plain value."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec
    from atomo_tpu_torch.ops import attention_kernels as A
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel import moe
    from atomo_tpu_torch.convert import tree_leaves

    full = moe.init_moe_lm_params(3, dict(LAYOUT_CFG, num_experts=8))
    leaves = [t.to(dev) * 0.01 for t in tree_leaves(full)]
    layouts = [False] * len(leaves)
    codec = QsgdCodec(bits=4)
    tree = [codec._clip_leaf(x.reshape(-1)) for x in leaves]
    seeds = [1000003 * (i + 1) for i in range(len(tree))]
    got = K.quantize_pack_tree(tree, bits=4, scheme=codec.scheme, seeds=seeds)
    want = K.quantize_pack_tree_plain(tree, bits=4, scheme=codec.scheme, seeds=seeds)
    for (wk, sk), (wp, sp) in zip(got, want):
        if not same_bits(wk, wp):
            raise AssertionError("layouts: quantize_pack_tree words differ on the MoE tree")
        torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
        errs["quantize_pack"] = max(errs["quantize_pack"], float((sk - sp).abs().max()))
    payloads = replica_payloads(codec, leaves, 1, layouts)
    dk = K.unpack_dequantize_tree(payloads, leaves, layouts, bits=4, n_replicas=1)
    dp = K.unpack_dequantize_tree_plain(payloads, leaves, layouts, bits=4, n_replicas=1)
    for a, b in zip(dk, dp):
        if not torch.equal(a, b):
            raise AssertionError("layouts: unpack_dequantize_tree differs on the MoE tree")
    errs["unpack_dequantize"] = max([errs["unpack_dequantize"]]
                                    + [float((a - b).abs().max()) for a, b in zip(dk, dp)])
    gen = torch.Generator(device=dev).manual_seed(9)
    y = torch.randn((16, 1024, 256), generator=gen, device=dev)
    kern = torch.randn((256, 3, 4, 64), generator=gen, device=dev) / 16
    blk = dict(block_q=512, block_k=512)
    out = {"moe_leaves": len(leaves)}
    for dtype, tol, key in ((torch.float32, 2e-5, "flash_attention"),
                            (torch.bfloat16, 2e-2, "flash_attention_bf16")):
        qkv = torch.einsum("bsw,wthd->tbhsd", y.to(dtype), kern.to(dtype))
        q, k, v = qkv[0], qkv[1], qkv[2]
        a = A.flash_attention_forward(q, k, v, causal=True, **blk)
        b = A.flash_attention_plain(q.float(), k.float(), v.float(), causal=True, **blk)
        err = float((a.float() - b).abs().max())
        if not err <= tol:
            raise AssertionError(f"layouts: flash on the tp head views {dtype}: err {err}")
        errs[key] = max(errs[key], err)
        out[key] = err
    torch.cuda.synchronize()
    log(f"layouts check: rows 1-2 over the MoE tree's {len(leaves)} leaves (4 bits) equal their "
        f"plain versions; the flash kernel on the tp head views (16, 4, 1024, 64): max abs err "
        f"{out['flash_attention']:.3e} float32 (<= 2e-5), {out['flash_attention_bf16']:.3e} "
        "bfloat16 (<= 2e-2)")
    return out


def layout_comm(runs: dict, card: str) -> dict:
    """The ``comm`` lines: the codec tax anchor measured in this call
    (ResNet-18 svd3's median step minus sgd's, from ``phase_train``) beside
    the constant ``utils/comm_model.py`` carries, and the ``--aggregate
    auto`` line each verb prints: ``lm`` at the recipe over dp 1 (this
    card) and 8, ``train`` (ResNet-18 svd3) priced for 8 ranks on one
    host."""
    from atomo_tpu_torch import cli
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.tuning.probe import byte_budget
    from atomo_tpu_torch.utils import comm_model

    svd = runs["svd3"]["median_step_ms_after_first"]
    sgd = runs["sgd"]["median_step_ms_after_first"]
    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    dense = byte_budget(None, model)[0]
    log(f"comm codec tax anchor ({card}): ResNet-18 svd rank 3 median step {svd:.3f} ms - sgd "
        f"{sgd:.3f} ms = {svd - sgd:.3f} ms on a {dense}-byte dense gradient; "
        f"utils/comm_model._TAX_ANCHOR_S = {comm_model._TAX_ANCHOR_S * 1e3:.3f} ms")
    lines = {}
    lm_args = cli.build_parser().parse_args(layout_argv("dp-tp", "svd"))
    lm_codec = cli.lm_codec(lm_args, lambda _: None)
    for ways in (1, 8):
        cli.resolve_auto_aggregate(lm_args, lm_codec, TransformerLM(**LAYOUT_CFG), ways,
                                   allow_hierarchical=False,
                                   log=lambda ln, w=ways: lines.setdefault(f"lm_dp{w}", ln))
    tr_args = cli.build_parser().parse_args(TRAIN_ARGS + ["--code", "svd", "--svd-rank", "3"])
    tr_codec = cli.get_codec("svd", svd_rank=3)
    cli.resolve_auto_aggregate(tr_args, tr_codec, model, 8,
                               log=lambda ln: lines.setdefault("train_n8", ln))
    for k, ln in lines.items():
        log(f"comm {k}: {ln}")
    return {"svd3_ms": svd, "sgd_ms": sgd, "tax_ms": svd - sgd, "dense_bytes": dense,
            "constant_ms": comm_model._TAX_ANCHOR_S * 1e3, "auto_lines": lines}


def phase_layouts(work: Path, card: str, runs: dict, errs: dict) -> dict:
    """Phase 16: dp-tp, dp-ep, dp-pp and dp-tp-sp through the ``lm`` verb at
    NCCL world 1 with the model axis at 1, at the LM recipe (8 experts, 2
    microbatches): ``--code svd`` (auto rank 24) on each, ``--code qsgd``
    on dp-ep (rows 1-2 once a step each), dp-tp-sp with ``ulysses-flash``
    (row 5 once a layer a step) in float32 and ``--bf16``. Each run: its
    median step ms (steps 2-5), Msg(MB), peak GiB and launches. Then the
    step-0 oracle checks, dp-tp at tp 1 against dp, rows 1, 2 and 5 against
    their plain versions at these shapes, and the ``comm`` lines."""
    import torch

    from atomo_tpu_torch.parallel import launch

    t0 = time.time()
    dev = torch.device("cuda", 0)
    res: dict = {"runs": {}}
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/layouts_nccl1",
                      world_size=1, rank=0)
    try:
        plan = [(f"{lay}_svd", layout_argv(lay, "svd"),
                 ["flash_attention"] if lay == "dp-tp-sp" else []) for lay in LAYOUTS]
        plan += [("dp-ep_qsgd", layout_argv("dp-ep", "qsgd", "--quantization-level", "4"),
                  ["quantize_pack", "unpack_dequantize"]),
                 ("dp-tp-sp_svd_bf16", layout_argv("dp-tp-sp", "svd", "--bf16"),
                  ["flash_attention"])]
        for label, argv, expect in plan:
            r = run_cli(argv, expect, prefix="LM: ")
            r["median_step_ms"] = statistics.median(r["step_ms"][1:LAYOUT_STEPS])
            c = r["launches"]
            want = {"flash_attention": LM_DEPTH * LAYOUT_STEPS if "dp-tp-sp" in label else 0,
                    "quantize_pack": LAYOUT_STEPS if "qsgd" in label else 0,
                    "unpack_dequantize": LAYOUT_STEPS if "qsgd" in label else 0,
                    "pack_bucketed": 0, "unpack_bucketed": 0}
            if c != want:
                raise AssertionError(f"layouts {label}: launches {c}, want {want}")
            res["runs"][label] = r
            log(f"layouts {label} ({card}): median step {r['median_step_ms']:.3f} ms (steps "
                f"2-{LAYOUT_STEPS}), Msg(MB) {r['msg_mb']}, peak {r['peak_gib']:.3f} GiB, "
                f"launches a step {({k: v / LAYOUT_STEPS for k, v in c.items() if v})}, "
                f"losses {r['losses']}")
    finally:
        launch.shutdown()
    res["seconds_runs"] = time.time() - t0
    res["step0"] = layout_step0(dev)
    res["tp_vs_dp"] = layout_tp_vs_dp(dev)
    res["checks"] = layout_kernel_checks(dev, errs)
    res["comm"] = layout_comm(runs, card)
    res["launches"] = {name: sum(r["launches"][name] for r in res["runs"].values())
                       for name in REPLACES}
    res["seconds"] = time.time() - t0
    log(f"layouts launches on the main path: row 1 {res['launches']['quantize_pack']}, row 2 "
        f"{res['launches']['unpack_dequantize']}, row 5 {res['launches']['flash_attention']}; "
        f"phase seconds {res['seconds']:.1f}")
    return res


# ---------------------------------------------------------------- resilience

RS_STEPS = 10
RS_SPEC = "nan@3"
RS_TRAIN = ["train", "--network", "ResNet18", "--dataset", "Cifar10", "--synthetic",
            "--batch-size", "128", "--code", "qsgd", "--quantization-level", "4",
            "--eval-freq", "0", "--log-interval", "1", "--save-freq", "2", "--max-steps", "8",
            "--seed", "1", "--device", "cuda"]
RS_LENET = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
            "--batch-size", "16", "--eval-freq", "0", "--log-interval", "1", "--code", "sgd",
            "--device", "cuda"]
RS_DOCTOR = ["--max-steps", "14", "--save-freq", "2", "--grad-guard", "--on-diverge", "skip",
             "--diverge-window", "4", "--diverge-zmax", "4", "--diverge-patience", "2",
             "--diverge-min-history", "4", "--chaos", "spike@7:3"]


def rs_resnet(dev, k: int, guard: bool, spec: str = RS_SPEC):
    """ResNet-18 (batch 128, augmentation on, qsgd 4 bits) and its step, or
    its block step of ``k``, guarded (with ``spec``'s faults, when given) or
    not."""
    from atomo_tpu_torch.training.resilience import GuardConfig
    from atomo_tpu_torch.utils.chaos import ChaosConfig, ChaosInjector
    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    state = create_state(model, opt, 1, dev)
    kw = {}
    if guard:
        kw = dict(guard=GuardConfig())
    if guard and spec:
        kw["chaos"] = ChaosInjector(ChaosConfig.from_spec(spec, environ={}), membership_epoch=0)
    return state, make_train_step(model, opt, get_codec("qsgd", quantization_level=4),
                                  augment=True, superstep=k, **kw)


def rs_steps(state, step, k: int, steps: int, stream, on_step=None, timed: bool = False):
    """``steps`` steps in blocks of ``k`` (1: one by one): per-step losses,
    skipped flags and (``timed``) wall ms a step; ``on_step(s, state)``
    after each block's last step."""
    import torch

    from atomo_tpu_torch.data import to_device
    from atomo_tpu_torch.data.pipeline import BlockStream, block_to_device

    blocks = BlockStream(stream)
    losses, skipped, ms, s = [], [], [], 0
    while s < steps:
        kb = min(k, steps - s)
        t0 = time.perf_counter()
        if k == 1:
            state, m = step(state, 2, *to_device(*next(stream), "cuda"))
        else:
            staged = block_to_device(*blocks.take(kb), "cuda")
            torch.cuda.current_stream().wait_event(staged.ready)
            state, m = step(state, 2, staged.images, staged.labels)
        loss = m["loss"].reshape(-1).tolist()
        losses += loss
        skipped += m["skipped"].reshape(-1).tolist() if "skipped" in m else [0.0] * kb
        if timed:
            ms.append((time.perf_counter() - t0) * 1e3 / kb)
        s += kb
        if on_step is not None:
            on_step(s, state)
    return state, losses, skipped, ms


def resilience_child(work: str, out_path: str) -> int:
    """The guard's deterministic runs (this script with
    ``--resilience-child``; cuBLAS's workspace set before its first
    handle): ResNet-18 qsgd 4 bits with ``--grad-guard --chaos nan@3``, 10
    steps one by one (the state after step 3 against the state after step
    2) and as graph blocks of 8 (the rule still qualifies the guarded
    step); then, through the CLI in this process, the straight ResNet-18 run
    the kill drill is held to and the LeNet spike drill. Writes what it
    found to ``out_path``."""
    import os

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import ops
    from atomo_tpu_torch.training.graph import mode_line

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    runs = {}
    for k in (1, 8):
        state, step = rs_resnet(dev, k, guard=True)
        seen = {}

        def on_step(s, st):
            if s in (2, 3):
                seen[s] = [t.detach().clone() for t in ss_carried(st)]

        ops.reset_launch_counts()
        state, losses, skipped, _ = rs_steps(state, step, k, RS_STEPS, ss_stream(),
                                             on_step=on_step if k == 1 else None)
        torch.cuda.synchronize()
        run = {"losses": losses, "skipped": skipped, "launches": ops.launch_counts(),
               "mode": mode_line(step) if k > 1 else "per-step",
               "replays": getattr(step, "replays", 0), "held": int(state.held),
               "count": state.opt_state.count,
               "carried": [t.detach().clone() for t in ss_carried(state)]}
        if k == 1:
            run["step3_equals_step2"] = all(torch.equal(
                a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                for a, b in zip(seen[2], seen[3]))
        runs[f"K{k}"] = run
    a, b = runs["K1"].pop("carried"), runs["K8"].pop("carried")
    runs["graph_equals_eager"] = runs["K1"]["losses"] == runs["K8"]["losses"] and all(
        torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))
    from atomo_tpu_torch import cli

    runs["straight_rc"] = cli.main(RS_TRAIN + ["--train-dir", str(Path(work) / "rs_a")],
                                   log_fn=lambda _: None)
    os.environ["ATOMO_CHAOS_SPIKE_SCALE"] = "100"
    lines: list = []
    runs["spike_rc"] = cli.main(RS_LENET + RS_DOCTOR + ["--train-dir", str(Path(work) / "rs_c")],
                                log_fn=lines.append)
    runs["spike_doctor"] = [ln for ln in lines if ln.startswith("Doctor:")]
    Path(out_path).write_text(json.dumps(runs))
    return 0


def rs_row2(grads, errs: dict) -> dict:
    """Row 2 with per-replica flags over a 4-replica gathered buffer of the
    ResNet-18 tree (4 bits) built on the card, replica 2 encoded from a NaN
    gradient (row 1 on non-finite input) and flagged 0: against its plain
    twin (bit for bit), against the decode of the three survivors rescaled
    by 4/3 (in ulp). Returns the result and a timing function (device ms
    with the flags and without them)."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, encode_tree
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets
    from atomo_tpu_torch.training.resilience import rescale_by_survivors

    codec = QsgdCodec(bits=4)
    bufs = []
    for r in range(4):
        g = grads if r != 2 else [x * float("nan") for x in grads]
        payloads, _ = encode_tree(codec, r + 1, g)
        buf, spec = pack_tree_buckets(payloads)
        bufs.append(buf)
    torch.cuda.synchronize()  # row 1 took the NaN gradient without a fault
    rows = torch.stack(bufs)
    pays = [tuple(p) for p in unpack_tree_buckets(rows, spec)]
    flags = torch.tensor([1.0, 1.0, 0.0, 1.0], device=rows.device)
    got = K.unpack_dequantize_tree(pays, grads, bits=4, n_replicas=4, replica_ok=flags)
    plain = K.unpack_dequantize_tree_plain(pays, grads, bits=4, n_replicas=4, replica_ok=flags)
    twin = all(same_bits(a, b) for a, b in zip(got, plain))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    keep = rows[[0, 1, 3]]
    surv = K.unpack_dequantize_tree([tuple(p) for p in unpack_tree_buckets(keep, spec)], grads,
                                    bits=4, n_replicas=3)
    scaled = rescale_by_survivors(got, 4, torch.tensor(3.0, device=rows.device))
    ulps = max(float(((a.double() - b.double()).abs()
                      / torch.finfo(torch.float32).eps
                      / b.double().abs().clamp_min(torch.finfo(torch.float32).tiny)).max())
               for a, b in zip(scaled, surv))
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    errs["unpack_dequantize"] = max(errs["unpack_dequantize"], err)
    if not (twin and finite and ulps <= 2.0):
        raise AssertionError(f"row 2 with flags: twin {twin}, finite {finite}, "
                             f"survivor ulps {ulps}")
    res = {"twin_bit_equal": twin, "finite": finite, "survivor_max_ulp": ulps,
           "bytes_a_replica": int(rows.shape[1])}

    def timing():
        res["device_ms_flags"] = device_ms(lambda: K.unpack_dequantize_tree(
            pays, grads, bits=4, n_replicas=4, replica_ok=flags), "unpack_dequantize")
        res["device_ms_unflagged"] = device_ms(lambda: K.unpack_dequantize_tree(
            pays, grads, bits=4, n_replicas=4), "unpack_dequantize")
        log(f"resilience row 2 flags: 4-replica gathered ResNet-18 buffer "
            f"({res['bytes_a_replica']} bytes a replica), replica 2 from a NaN gradient "
            f"flagged 0: equals its plain twin bit for bit, finite, within {ulps:.3f} ulp of "
            f"the three survivors' decode rescaled by 4/3; device ms "
            f"{res['device_ms_flags']:.4f} with flags, {res['device_ms_unflagged']:.4f} "
            f"without")
        return res

    return res, timing


def rs_timing(dev, card: str) -> dict:
    """Median step ms of ResNet-18 qsgd 4 bits with ``--grad-guard`` (no
    chaos) and without it, eager and as the K = 8 graph, in turns within
    this call."""
    import torch

    out = {}
    for turn in range(2):
        for k in (1, 8):
            for guard in (False, True):
                state, step = rs_resnet(dev, k, guard, spec=None)
                steps = 24 if k == 8 else 12
                _, _, _, ms = rs_steps(state, step, k, steps, ss_stream(), timed=True)
                torch.cuda.synchronize()
                key = f"{'graph' if k > 1 else 'eager'}_{'guard' if guard else 'off'}"
                out.setdefault(key, []).append(statistics.median(ms[1:]))
    res = {k: statistics.median(v) for k, v in out.items()}
    log(f"resilience time ({card}): median step ms eager {res['eager_off']:.3f} off, "
        f"{res['eager_guard']:.3f} guarded; graph K=8 {res['graph_off']:.3f} off, "
        f"{res['graph_guard']:.3f} guarded")
    return res


def rs_drills_start(work: Path) -> dict:
    """The CLI drills that end processes, started at once as processes of
    their own (a sitecustomize on their path sets the deterministic
    algorithms before anything runs): ResNet-18 qsgd for 8 steps with
    ``kill@5`` under ``--max-restarts 1``, and the LeNet ``slow@3:60`` drill
    under ``--health-timeout 5``."""
    import os

    det = work / "rs_det"
    det.mkdir(exist_ok=True)
    (det / "sitecustomize.py").write_text(
        "import torch\ntorch.use_deterministic_algorithms(True, warn_only=True)\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join([str(det), str(ROOT)]))
    for k in ("ATOMO_CHAOS", "ATOMO_SUPERVISED", "ATOMO_RUN_ATTEMPT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "atomo_tpu_torch"]
    plans = {
        "kill": (RS_TRAIN + ["--train-dir", str(work / "rs_b"), "--chaos", "kill@5",
                             "--max-restarts", "1", "--restart-backoff", "0.1"], {}),
        "slow": (RS_LENET + ["--max-steps", "6", "--train-dir", "", "--chaos", "slow@3:60",
                             "--health-timeout", "5"], {}),
    }
    t0 = time.time()
    return {name: (subprocess.Popen(cmd + argv, env={**env, **extra}, cwd=str(ROOT),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True), t0)
            for name, (argv, extra) in plans.items()}


def rs_drills_finish(work: Path, procs: dict, det: dict) -> dict:
    """Wait for the drills and hold each to its outcome (the straight run
    and the spike drill from the deterministic child's ``det``)."""
    res = {}
    for name, (p, t0) in procs.items():
        out, err = p.communicate(timeout=300)
        res[name] = {"rc": p.returncode, "stdout": out, "stderr": err}
    a, b = work / "rs_a" / "model_step_8", work / "rs_b" / "model_step_8"
    kill = res["kill"]
    inc = work / "rs_b" / "incidents.jsonl"
    drills = {
        "kill_equal": a.exists() and b.exists() and a.read_bytes() == b.read_bytes(),
        "kill_rc": kill["rc"],
        "kill_died": "CHAOS: killing process before step 5" in kill["stderr"],
        "kill_resumed": "at step 4" in kill["stdout"],
        "kill_incidents": [json.loads(ln).get("cause") for ln in inc.read_text().splitlines()]
        if inc.exists() else [],
        "spike_rc": det["spike_rc"], "spike_doctor": det["spike_doctor"],
        "slow_rc": res["slow"]["rc"],
        "seconds": time.time() - min(t0 for _, t0 in procs.values()),
    }
    ok = (drills["kill_equal"] and drills["kill_rc"] == 0 and drills["kill_died"]
          and drills["kill_resumed"] and drills["kill_incidents"] == ["crash", "clean_exit"]
          and drills["spike_rc"] == 0 and drills["spike_doctor"] and drills["slow_rc"] == 13
          and det["straight_rc"] == 0)
    if not ok:
        tails = {k: (v["rc"], v["stdout"][-1500:], v["stderr"][-1500:]) for k, v in res.items()}
        raise AssertionError(f"resilience drills failed: {drills}; {tails}")
    log(f"resilience drill kill@5 --max-restarts 1 (deterministic): rc 0, attempt 0 died before "
        f"step 5 (exit 43), attempt 1 resumed at step 4; model_step_8 equals the straight "
        f"run's byte for byte; incidents {drills['kill_incidents']}")
    log(f"resilience drill spike@7:3 --on-diverge skip: rc 0, {drills['spike_doctor'][0]}")
    log(f"resilience drill slow@3:60 --health-timeout 5: rc {drills['slow_rc']}; the drills "
        f"and the deterministic child together took {drills['seconds']:.1f} s")
    return drills


def phase_resilience(work: Path, card: str, grads, errs: dict) -> dict:
    """The guard, its kernel form and the drills (the module docstring's
    item 16): the drills and the deterministic child start at once, row 2's
    check runs beside them, and the timings run once they are done."""
    import torch

    t0 = time.time()
    out_path = work / "resilience_child.json"
    me = str(Path(__file__).resolve())
    child = subprocess.Popen([sys.executable, me, "--resilience-child", str(work),
                              str(out_path)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = rs_drills_start(work)
    row2, row2_timing = rs_row2(grads, errs)
    log_child, _ = child.communicate(timeout=300)
    if child.returncode != 0:
        raise AssertionError(f"resilience child failed:\n{log_child[-3000:]}")
    det = json.loads(out_path.read_text())
    drills = rs_drills_finish(work, procs, det)
    k1, k8 = det["K1"], det["K8"]
    want_skip = [1.0 if s == 3 else 0.0 for s in range(1, RS_STEPS + 1)]
    finite = all(math.isfinite(v) for v in k1["losses"][3:])
    ok = (k1["step3_equals_step2"] and det["graph_equals_eager"] and finite
          and k1["skipped"] == want_skip == k8["skipped"] and k8["mode"].endswith("graph")
          and k1["held"] == k8["held"] == 1
          and k1["launches"]["quantize_pack"] == k1["launches"]["unpack_dequantize"] == RS_STEPS)
    if not ok:
        raise AssertionError(f"resilience guard runs: {det}")
    log(f"resilience guard nan@3 (deterministic): step 3 skipped, its state equals step 2's bit "
        f"for bit, losses after it finite; '{k8['mode']}' ({k8['replays']} replays) equals the "
        f"eager steps bit for bit; optimizer count {k1['count']} with {k1['held']} held; "
        f"launches eager {k1['launches']}, graph {k8['launches']}")
    t_checks = time.time() - t0
    row2 = row2_timing()
    timing = rs_timing(torch.device("cuda"), card)
    launches = {k: k1["launches"][k] + k8["launches"][k] for k in REPLACES}
    res = {"guard": det, "row2": row2, "timing": timing, "drills": drills,
           "launches": launches, "seconds_checks": t_checks, "seconds": time.time() - t0}
    log(f"resilience phase seconds {res['seconds']:.1f} (checks and drills "
        f"{t_checks:.1f})")
    return res


# ------------------------------------------------------------------- the obs phase

OBS_STEPS = 6
OBS_CODES = (("qsgd", ["--code", "qsgd"], ["quantize_pack", "unpack_dequantize"]),
             ("svd3", ["--code", "svd", "--svd-rank", "3"], []))
OBS_NCCL_STEPS = 3
OBS_RTOL = 1e-6  # row 2's probe decode against its plain twin


def obs_run(state, step, k: int, steps: int, stream):
    """``steps`` steps of a step armed with the quality probes, one by one
    (``k`` 1) or in blocks of ``k``: the state and each step's ``q_err2``
    row (one fetch a step, or a block)."""
    import torch

    from atomo_tpu_torch.data import to_device
    from atomo_tpu_torch.data.pipeline import BlockStream, block_to_device

    blocks = BlockStream(stream)
    rows, s = [], 0
    while s < steps:
        kb = min(k, steps - s)
        if k == 1:
            state, m = step(state, 2, *to_device(*next(stream), "cuda"))
            rows.append(m["q_err2"].tolist())
        else:
            staged = block_to_device(*blocks.take(kb), "cuda")
            torch.cuda.current_stream().wait_event(staged.ready)
            state, m = step(state, 2, staged.images, staged.labels)
            rows += m["q_err2"].tolist()
        s += kb
    return state, rows


def obs_deterministic(dev, off_state) -> dict:
    """The probe's deterministic runs, in the superstep child: ResNet-18
    qsgd 4 bits with ``track_quality``, ``SS_STEPS`` eager steps and graph
    blocks of 8: their ``q_err2`` series, launches and mode, and whether
    each final state equals ``off_state`` (the unarmed eager run's) bit for
    bit."""
    import torch

    from atomo_tpu_torch import ops
    from atomo_tpu_torch.training.graph import mode_line

    out = {}
    for k in (1, 8):
        state, step = ss_resnet(dev, "qsgd", k, quality=True)
        ops.reset_launch_counts()
        state, rows = obs_run(state, step, k, SS_STEPS, ss_stream())
        torch.cuda.synchronize()
        out[f"K{k}"] = {
            "q_err2": rows, "launches": ops.launch_counts(),
            "mode": mode_line(step) if k > 1 else "per-step",
            "replays": getattr(step, "replays", 0),
            "state_equals_off": all(
                torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                for a, b in zip(off_state, ss_carried(state)))}
    out["graph_equals_eager"] = out["K1"]["q_err2"] == out["K8"]["q_err2"]
    return out


def obs_cli(work: Path) -> dict:
    """``train --obs-record --obs-quality`` for qsgd 4 bits and svd rank 3
    into a scratch train dir each, then ``report --strict`` over it."""
    from atomo_tpu_torch import cli
    from atomo_tpu_torch.obs.recorder import FlightRecorder, metrics_path

    out = {}
    for label, flags, expect in OBS_CODES:
        d = work / f"obs_{label}"
        argv = (TRAIN_ARGS[:-1] + [str(d)] + flags
                + ["--max-steps", str(OBS_STEPS), "--eval-freq", "0", "--save-freq", "3",
                   "--obs-record", "--obs-quality"])
        r = run_cli(argv, expect)
        steps = FlightRecorder.read_steps(metrics_path(str(d)))
        lines: list[str] = []
        rc = cli.main(["report", "--train-dir", str(d), "--strict"], log_fn=lines.append)
        doc = json.loads((d / "run_report.json").read_text())
        series_ok = [s["step"] for s in steps] == list(range(1, OBS_STEPS + 1)) and all(
            len(s["q_err2"]) == len(s["q_rel"]) == 62
            and all(v is not None and math.isfinite(v) for v in s["q_err2"] + s["q_rel"])
            for s in steps)
        want = {n: OBS_STEPS if n in expect else 0 for n in REPLACES}
        if not (series_ok and rc == 0 and doc["consistent"] and r["launches"] == want):
            raise AssertionError(f"obs cli {label}: {len(steps)} step records, report rc {rc}, "
                                 f"consistent {doc['consistent']}, launches {r['launches']}; "
                                 + "\n".join(lines))
        ran = sum(not c["skipped"] for c in doc["checks"])
        r["report"] = {"rc": rc, "consistent": doc["consistent"], "checks_ran": ran,
                       "steps_recorded": len(steps)}
        r["q_err2_first"] = sum(steps[0]["q_err2"])
        log(f"obs cli {label}: train --obs-record --obs-quality, {len(steps)} step records of "
            f"62 finite q_err2/q_rel each (sum of q_err2 at step 1 {r['q_err2_first']:.6g}); "
            f"report --strict rc {rc}, consistent ({ran} check ran); launches {r['launches']}")
        out[label] = r
    return out


def obs_nccl1(work: Path) -> dict:
    """The data-parallel step at NCCL world 1 with the probe armed (qsgd 4
    bits, gather): row 2 twice a step, the gather's decode and the probe's
    decode of the rank's own payload."""
    import torch

    from atomo_tpu_torch import ops
    from atomo_tpu_torch.parallel import launch

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work.resolve()}/obs_nccl1",
                      world_size=1, rank=0)
    try:
        state, step = ss_resnet(dev, "qsgd", 1, dist_step=True, quality=True)
        ops.reset_launch_counts()
        state, rows = obs_run(state, step, 1, OBS_NCCL_STEPS, ss_stream())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        launch.shutdown()
    finite = all(math.isfinite(v) for row in rows for v in row)
    if not (finite and len(rows) == OBS_NCCL_STEPS and counts["quantize_pack"] == OBS_NCCL_STEPS
            and counts["unpack_dequantize"] == 2 * OBS_NCCL_STEPS):
        raise AssertionError(f"obs nccl-1: launches {counts}, finite {finite}")
    log(f"obs nccl-1 qsgd gather with the probe: {OBS_NCCL_STEPS} steps, launches {counts} "
        f"(row 2 twice a step: the gather's decode and the probe's own decode), q_err2 finite")
    return {"launches": counts, "q_err2": rows}


def obs_row2(grads, errs: dict) -> dict:
    """Row 2's probe decode of one replica's payload (the ResNet-18 tree at
    4 bits, encoded on the card) against its plain twin: the decodes bit for
    bit, ``q_err2`` within ``OBS_RTOL``; then its device ms beside its
    bound (one replica's words and scales read, the float32 tree written)."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, decode_tree, encode_tree, payload_nbytes
    from atomo_tpu_torch.obs.quality import quality_from_decoded, quality_probe
    from atomo_tpu_torch.ops import qsgd_kernels as K

    codec = QsgdCodec(bits=4)
    payloads, _ = encode_tree(codec, 3, grads)
    got = quality_probe(codec, payloads, grads)
    plain_dec = K.unpack_dequantize_tree_plain(payloads, grads, bits=4)
    want = quality_from_decoded(plain_dec, grads)
    dec = decode_tree(codec, payloads, grads)
    err = max(float((a - b).abs().max()) for a, b in zip(dec, plain_dec))
    errs["unpack_dequantize"] = max(errs["unpack_dequantize"], err)
    rel = float(((got["q_err2"] - want["q_err2"]).abs()
                 / want["q_err2"].abs().clamp_min(1e-30)).max())
    same = all(same_bits(a, b) for a, b in zip(dec, plain_dec))
    if not (same and rel <= OBS_RTOL and torch.isfinite(got["q_err2"]).all()):
        raise AssertionError(f"obs row 2 probe decode: decodes bit for bit {same}, q_err2 "
                             f"max rel {rel}")
    nbytes = sum(payload_nbytes(p) for p in payloads) + sum(g.numel() * 4 for g in grads)
    bound_ms, by = bound(nbytes, sum(g.numel() for g in grads))
    dms = device_ms(lambda: K.unpack_dequantize_tree(payloads, grads, bits=4),
                    "unpack_dequantize")
    log(f"obs row 2 probe decode (one replica, 62 leaves, 4 bits): decodes equal the plain "
        f"twin's bit for bit, q_err2 max rel diff {rel:.3e} (limit {OBS_RTOL}); device ms "
        f"{dms:.4f} against a bound of {bound_ms:.4f} by {by} ({nbytes / 1e6:.1f} MB)")
    return {"max_abs_err": err, "q_err2_max_rel": rel, "device_ms": dms, "bound_ms": bound_ms,
            "bound_by": by, "bytes": nbytes}


def obs_timing(dev, card: str) -> dict:
    """Median step ms armed and off, eager (K 1) and at K = 8 (qsgd: the
    graph; svd rank 3: the eager block), each config a model of its own
    after a warm-up block, in two turns (off first, then armed first)."""
    import torch

    from atomo_tpu_torch.training.graph import mode_line

    out, modes = {}, {}
    for turn in range(2):
        for code in ("qsgd", "svd"):
            for k in (1, 8):
                for armed in ((False, True) if turn == 0 else (True, False)):
                    state, step = ss_resnet(dev, code, k, quality=armed)
                    stream = ss_stream()
                    state, _, _ = ss_run(state, step, k, k, stream)
                    _, _, ms = ss_run(state, step, k, 16 if k == 8 else 8, stream, timed=True)
                    torch.cuda.synchronize()
                    key = f"{'svd3' if code == 'svd' else code}_K{k}_{'armed' if armed else 'off'}"
                    out.setdefault(key, []).append(statistics.median(ms))
                    modes[key] = mode_line(step) if k > 1 else "per-step"
    res = {k: {"median_step_ms": statistics.median(v), "by_turn": v, "mode": modes[k]}
           for k, v in out.items()}
    for code in ("qsgd", "svd3"):
        log(f"obs time {code} ({card}): median step ms eager "
            f"{res[f'{code}_K1_off']['median_step_ms']:.3f} off, "
            f"{res[f'{code}_K1_armed']['median_step_ms']:.3f} armed; K=8 "
            f"{res[f'{code}_K8_off']['median_step_ms']:.3f} off, "
            f"{res[f'{code}_K8_armed']['median_step_ms']:.3f} armed "
            f"('{res[f'{code}_K8_armed']['mode']}')")
    return res


def phase_obs(work: Path, card: str, grads, errs: dict, det: dict) -> dict:
    """The flight recorder and the quality probes (the module docstring's
    item 17); ``det`` is the superstep child's armed runs."""
    import torch

    t0 = time.time()
    k1, k8 = det["K1"], det["K8"]
    if not (det["graph_equals_eager"] and k1["state_equals_off"] and k8["state_equals_off"]
            and k8["mode"].startswith("Superstep: K=8, graph (quality probes armed")
            and k8["replays"] > 0 and len(k1["q_err2"]) == SS_STEPS
            and all(math.isfinite(v) for row in k1["q_err2"] for v in row)):
        raise AssertionError(f"obs deterministic: {det}")
    log(f"obs deterministic: ResNet-18 qsgd 4 bits with the probe, {SS_STEPS} steps: "
        f"'{k8['mode']}' ({k8['replays']} replays) gives the eager steps' q_err2 series step "
        f"for step ({SS_STEPS} x 62 values), and both end in the unarmed eager run's state bit "
        f"for bit; launches eager {k1['launches']}, graph {k8['launches']}")
    cli_runs = obs_cli(work)
    nccl1 = obs_nccl1(work)
    row2 = obs_row2(grads, errs)
    t_checks = time.time() - t0
    timing = obs_timing(torch.device("cuda", 0), card)
    launches = {n: sum(r["launches"][n] for r in cli_runs.values()) + nccl1["launches"][n]
                + k1["launches"][n] + k8["launches"][n] for n in REPLACES}
    res = {"deterministic": det, "cli": cli_runs, "nccl1": nccl1, "row2": row2,
           "timing": timing, "launches": launches, "seconds_checks": t_checks,
           "seconds": time.time() - t0}
    log(f"obs phase seconds {res['seconds']:.1f} (checks {t_checks:.1f})")
    return res


# ------------------------------------------------------------- the timeline phase

TL_STEPS = 6  # eager: the profiled window is steps 2-4
TL_K8_STEPS = 24  # K 8: the second block, steps 9-16, is traced
TL_RUNS = (("qsgd_eager", "qsgd", 1, TL_STEPS), ("qsgd_k8", "qsgd", 8, TL_K8_STEPS),
           ("svd3_eager", "svd", 1, TL_STEPS))
TL_PHASED_STEPS = 4
# the timeline child's marker: its traced runs are done
TL_TRACED_DONE = "tl_traced_done"
# eagerly, the events the timeline gives a phase against Kineto's own span
# of the range (its ``gpu_user_annotation``: the first to the last kernel the
# range launched): each span's edges within 2 us of the extent of that
# phase's events inside it, and no event of the phase outside every span
TL_EDGE_US = 2.0
# the K 8 graph's busy ms a step of each phase against the eager run's
TL_GRAPH_REL = 0.25
# a span's encode (decode) busy against row 1's (row 2's) device ms timed
# alone in this call's `time` phase: the clocks move a few percent
TL_ROW_REL = 0.9
TL_REALLOC = ["--code", "qsgd", "--quantization-level", "4", "--budget-alloc", "variance",
              "--obs-record", "--obs-quality", "--save-freq", "8", "--max-steps", "16",
              "--n-devices", "2", "--aggregate", "gather", "--eval-freq", "0"]
TL_FABRIC = ["--code", "qsgd", "--quantization-level", "4", "--n-devices", "2",
             "--eval-freq", "0", "--save-freq", "2"]


def span_agreement(trace: dict) -> dict:
    """For each phase of the eager step: Kineto's spans of the range that
    carries it (``gpu_user_annotation``, one a range instance on the stream
    its kernels ran on) against the kernels the timeline attributes to the
    phase on that stream: the largest distance of a span's edge from the
    extent of the phase's events inside it (µs), the phase's events on that
    stream outside every span, and the phase's events on streams with no
    span of the range (NCCL's own stream: Kineto's span of a range covers
    one stream), with both totals in ms."""
    from atomo_tpu_torch.obs import timeline as TL

    events, _ = TL.attributed_events(trace, None)
    out = {}
    for phase, rng in (("encode", "step.encode"), ("exchange", "step.exchange"),
                       ("decode", "step.decode_mean")):
        wins: dict = {}
        for e in trace["events"]:
            if e.get("cat") == "gpu_user_annotation" and e["name"] == rng:
                wins.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
        # Kineto spans a range from its kernels: its copies and sets aside
        mine = [e for e in events if e["phase"] == phase and e["cat"] == "kernel"]
        edge, outside = 0.0, 0
        for line, ws in wins.items():
            on = [e for e in mine if e["line"] == line]
            seen = set()
            for s, t in ws:
                inside = [i for i, e in enumerate(on) if s - TL_EDGE_US <= e["start_us"] <= t]
                seen.update(inside)
                edge = max(edge, abs(min(on[i]["start_us"] for i in inside) - s),
                           abs(max(on[i]["end_us"] for i in inside) - t)) if inside else \
                    max(edge, t - s)
            outside += len(on) - len(seen)
        other = [e for e in mine if e["line"] not in wins]
        out[phase] = {"spans": sum(len(w) for w in wins.values()), "max_edge_us": edge,
                      "outside": outside, "other_streams": len(other),
                      "other_names": sorted({e["name"][:60] for e in other}),
                      "span_ms": sum(t - s for ws in wins.values() for s, t in ws) / 1e3,
                      "busy_ms": sum(e["end_us"] - e["start_us"] for e in mine) / 1e3}
    return out


def row_kernels_by_span(trace: dict) -> list:
    """For each dispatch of the timeline's segmentation: the device ms of row
    1's and row 2's kernels in it and the phases they were given."""
    from atomo_tpu_torch.obs import timeline as TL

    events, _ = TL.attributed_events(trace, TL.read_graph_map(str(Path(trace["path"]).parent)))
    events.sort(key=lambda e: e["start_us"])
    out = []
    for ex in TL._segment_executions(events):
        row = {}
        for name, kernel in (("quantize_pack", "quantize_pack_kernel"),
                             ("unpack_dequantize", "unpack_dequantize_tree_kernel")):
            hits = [e for e in ex if kernel in e["name"]]
            row[name] = {"ms": sum(e["end_us"] - e["start_us"] for e in hits) / 1e3,
                         "phases": sorted({e["phase"] for e in hits})}
        out.append(row)
    return out


def timeline_child(work: str, out_path: str) -> int:
    """The timeline phase's deterministic runs at NCCL world 1 (this script
    with ``--timeline-child``): ``distributed_train_loop`` with
    ``profile_dir`` and the flight recorder on ResNet-18 batch 128, qsgd 4
    bits eager and as the K 8 graph and svd rank 3 eager, each read back by
    ``report timeline --strict``; then ``--phase-metrics`` against the fused
    gather loop, 4 steps each from one start."""
    import os

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import cli, ops
    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.obs.recorder import FlightRecorder
    from atomo_tpu_torch.obs.timeline import latest_trace, parse_trace
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.training import distributed_train_loop, make_optimizer

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/tl_nccl1", world_size=1,
                      rank=0)
    out = {}

    def loop(code, k, steps, d, **kw):
        model = get_model("resnet18", 10, image_shape=(32, 32, 3))
        it = BatchIterator(synthetic_dataset(SPECS["cifar10"], True, size=4096), 128, seed=1)
        lines: list[str] = []
        ops.reset_launch_counts()
        state = distributed_train_loop(
            model, make_optimizer("sgd", lr=0.01, momentum=0.9), it, None,
            codec=get_codec(code, quantization_level=4, svd_rank=3), aggregate="gather",
            augment=True, max_steps=steps, seed=1, train_dir=str(d), save_freq=0,
            log_fn=lines.append, log_every=1, device=dev, superstep=k, **kw)
        torch.cuda.synchronize()
        return state, lines, ops.launch_counts()

    try:
        for label, code, k, steps in TL_RUNS:
            d = Path(work) / f"tl_{label}"
            t0 = time.perf_counter()
            _, lines, counts = loop(code, k, steps, d, recorder=FlightRecorder.for_train_dir(
                str(d)), profile_dir=str(d / "prof"))
            run_s = time.perf_counter() - t0
            report: list[str] = []
            rc = cli.main(["report", "timeline", "--profile-dir", str(d / "prof"), "--train-dir",
                           str(d), "--strict"], log_fn=report.append)
            trace = latest_trace(str(d / "prof"))
            parsed = parse_trace(trace)
            out[label] = {"rc": rc, "report": report, "launches": counts, "run_s": run_s,
                          "lines": [ln for ln in lines if not ln.startswith("Worker:")],
                          "doc": json.loads((d / "timeline_report.json").read_text()),
                          "trace": trace, "trace_mb": os.path.getsize(trace) / 1e6,
                          "rows": row_kernels_by_span(parsed),
                          "spans": span_agreement(parsed) if k == 1 else None}
        (Path(work) / TL_TRACED_DONE).write_text("")  # the card is free for the gloo ranks
        fused, f_lines, f_counts = loop("qsgd", 1, TL_PHASED_STEPS, Path(work) / "tl_fused")
        phased, p_lines, p_counts = loop("qsgd", 1, TL_PHASED_STEPS, Path(work) / "tl_phased",
                                         phase_metrics=True,
                                         lr_fn=lambda s: 0.01 * 0.95 ** (s // 50))
        out["phased"] = {
            "equal": state_hash(fused.model) == state_hash(phased.model),
            "fused_lines": f_lines, "lines": p_lines, "launches": p_counts,
            "fused_launches": f_counts}
    finally:
        launch.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def tl_doctor_series() -> None:
    """The re-allocation drill's hook (both ranks, every run alike): the
    recorded ``q_err2`` series as the retuner reads it, with the error of
    the largest adaptive leaf below 16 bits in epoch 0 multiplied by 1e4,
    so the boundary re-solve moves bits to it (``tests/test_budget.py``'s
    doctored series, applied to the run's own recorded rows)."""
    from atomo_tpu_torch.budget import read_alloc
    from atomo_tpu_torch.obs.recorder import FlightRecorder

    read = FlightRecorder.read_steps

    def doctored(path):
        recs = read(path)
        doc = read_alloc(str(Path(path).parent))
        if not doc:
            return recs
        layers = doc["epochs"][0]["layers"]
        target = max((lay["dense_bytes"], i) for i, lay in enumerate(layers)
                     if lay["adaptive"] and lay["k"] < 16)[1]
        for r in recs:
            if isinstance(r.get("q_err2"), list):
                r["q_err2"] = [v * 1e4 if i == target and v is not None else v
                               for i, v in enumerate(r["q_err2"])]
        return recs

    FlightRecorder.read_steps = staticmethod(doctored)


def timeline_gloo_child(rank: int, work: str, role: str, out_path: str) -> int:
    """One rank of the timeline phase's gloo groups of two on cuda:0 (this
    script with ``--timeline-gloo-child``), deterministic through the
    sitecustomize on its path. ``role`` ``main``: the straight
    re-allocation run (16 steps), ``train --fabric measured`` (ResNet-18
    qsgd 4 bits, 2 steps), the same run with ``--fabric`` pinned to the
    measured GB/s, the measured run resumed to step 3, then, once the
    killed run's ranks are gone, that run resumed; ``kill``: the
    re-allocation run with ``--chaos kill@12``."""
    sys.path.insert(0, str(ROOT))
    import torch

    from atomo_tpu_torch import cli, ops
    from atomo_tpu_torch.parallel import launch

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="gloo", init_method=f"file://{work}/tl_gloo_{role}",
                      world_size=2, rank=rank)
    tl_doctor_series()
    w = Path(work)
    out = {}

    def run(name, argv):
        lines: list[str] = []
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(TRAIN_ARGS[:-1] + argv, log_fn=lines.append)
        out[name] = {"rc": rc, "lines": lines, "launches": ops.launch_counts(),
                     "seconds": time.perf_counter() - t0}
        Path(out_path).write_text(json.dumps(out))

    try:
        if role == "kill":
            run("killed", [str(w / "tl_realloc_killed")] + TL_REALLOC + ["--chaos", "kill@12"])
            return 1  # the kill ends the process before this
        run("straight", [str(w / "tl_realloc")] + TL_REALLOC)
        run("measured", [str(w / "tl_fabric")] + TL_FABRIC + ["--max-steps", "2", "--fabric",
                                                               "measured"])
        doc = json.loads((w / "tl_fabric" / "fabric_probe.json").read_text())
        run("pinned", [str(w / "tl_pinned")] + TL_FABRIC + [
            "--max-steps", "2", "--fabric", repr(doc["tiers"][0]["bandwidth_gbps"])])
        run("fabric_resumed", [str(w / "tl_fabric")] + TL_FABRIC + [
            "--max-steps", "3", "--fabric", "measured", "--resume"])
        marker = w / "tl_killed_done"  # the parent writes it when the kill ranks end
        deadline = time.time() + 300
        while not marker.exists():
            if time.time() > deadline:
                raise TimeoutError("the killed run's ranks never ended")
            time.sleep(0.1)
        run("resumed", [str(w / "tl_realloc_killed")] + TL_REALLOC + ["--resume"])
    finally:
        launch.shutdown()
    return 0


def tl_gloo_spawn(work: Path, role: str, env: dict) -> list:
    paths = [work / f"tl_gloo_{role}{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--timeline-gloo-child", str(r),
         str(work), role, str(paths[r])], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    return [procs, paths]


def tl_check_run(label: str, r: dict, eager: dict, times: dict, card: str) -> dict:
    """Hold one traced run to the phase's checks (module docstring's
    item 18) and print its lines."""
    from atomo_tpu_torch.obs.timeline import PHASES, phase_totals

    doc = r["doc"]
    k8 = label == "qsgd_k8"
    n_steps = 8 if k8 else 3
    totals = phase_totals(doc)
    per_step = {p: totals[p]["busy_ms"] / n_steps for p in PHASES}
    names = [c["name"] for c in doc["checks"]]
    ok = r["rc"] == 0 and doc["consistent"] and per_step["encode"] > 0 and \
        per_step["decode"] > 0 and (not k8 or "timeline_graph_map" in names)
    if not ok:
        raise AssertionError(f"timeline {label}: rc {r['rc']}, checks {doc['checks']}, "
                             f"busy {per_step}\n" + "\n".join(r["report"]))
    res = {"per_step_busy_ms": per_step, "totals": totals, "n_dispatches": doc["n_dispatches"],
           "checks": names, "trace_mb": r["trace_mb"]}
    if label.startswith("qsgd"):
        for row, ph in (("quantize_pack", "encode"), ("unpack_dequantize", "decode")):
            busy = [s["phases"][ph]["busy_ms"] for s in doc["spans"]]
            per_row = [x[row] for x in r["rows"]]
            alone = times[row]["device_ms"] * n_steps  # the window's launches, timed alone
            if (any(x["phases"] not in ([ph], []) for x in per_row)
                    or any(b < x["ms"] for b, x in zip(busy, per_row))
                    or sum(busy) < TL_ROW_REL * alone):
                raise AssertionError(f"timeline {label}: {ph} busy {busy} against row "
                                     f"{row} {per_row} and {alone} ms timed alone")
            res[f"{row}_in_{ph}"] = {"busy": busy, "row_ms": [x["ms"] for x in per_row],
                                     "alone_ms": alone}
    if k8:
        for p in ("encode", "decode"):
            a, b = per_step[p], eager["per_step_busy_ms"][p]
            if abs(a - b) > TL_GRAPH_REL * b:
                raise AssertionError(f"timeline {label}: {p} busy {a} ms a step against the eager "
                                     f"{b}")
    else:
        for p, a in r["spans"].items():
            if a["max_edge_us"] > TL_EDGE_US or a["outside"]:
                raise AssertionError(f"timeline {label}: {p} against its range's spans: {a}")
            res[f"{p}_spans"] = a
    log(f"timeline {label} ({card}): report timeline --strict rc 0, consistent, checks {names}; "
        f"{doc['n_dispatches']} dispatch(es) over {n_steps} steps; busy ms a step "
        + ", ".join(f"{p} {per_step[p]:.4f} (exposed {totals[p]['exposed_ms'] / n_steps:.4f}, "
                    f"hidden {totals[p]['hidden_ms'] / n_steps:.4f})" for p in PHASES)
        + f", compute {totals['compute_ms'] / n_steps:.4f}, device wall "
        f"{totals['wall_ms'] / n_steps:.4f}"
        + (f"; each phase's events fill its range's device spans edge to edge (within "
           f"{TL_EDGE_US} us; span ms a step " + ", ".join(
               f"{p} {res[p + '_spans']['span_ms'] / n_steps:.4f}"
               for p in ("encode", "exchange", "decode")) + ")"
           + "; on other streams " + ", ".join(
               f"{p} {res[p + '_spans']['other_streams']} {res[p + '_spans']['other_names']}"
               for p in ("encode", "exchange", "decode"))
           if not k8 else "; the capture map attributed every replayed event")
        + (f"; row 1 in encode {res['quantize_pack_in_encode']['row_ms'][0]:.4f} ms, row 2 in "
           f"decode {res['unpack_dequantize_in_decode']['row_ms'][0]:.4f} ms"
           if label.startswith("qsgd") else "") + f"; trace {r['trace_mb']:.1f} MB")
    return res


def phase_timeline(work: Path, card: str, times: dict, errs: dict) -> dict:
    """The trace-based timeline, the phased step, the measured fabric and the
    online budget re-allocation on the card (the module docstring's item
    18): the deterministic NCCL child's traced runs alone on the card (the
    kernels of another process time-slice with theirs and stretch their
    traced durations), then the gloo ranks beside its phased runs."""
    import os

    import torch

    t0 = time.time()
    det = work / "tl_det"
    det.mkdir(exist_ok=True)
    (det / "sitecustomize.py").write_text(
        "import torch\ntorch.use_deterministic_algorithms(True, warn_only=True)\n")
    # four gloo ranks at once, each with a CPU probe gradient: two threads a
    # rank share the host's cores instead of oversubscribing them
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(det), str(ROOT)]))
    for k in ("ATOMO_CHAOS", "ATOMO_SUPERVISED", "ATOMO_RUN_ATTEMPT", "WORLD_SIZE"):
        env.pop(k, None)
    out_path = work / "timeline_child.json"
    ends = {}
    # the child writes to a file: nobody reads a pipe while its traces run
    child_log = work / "timeline_child.log"
    with open(child_log, "w") as f:
        child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                  "--timeline-child", str(work), str(out_path)], stdout=f,
                                 stderr=subprocess.STDOUT, text=True, cwd=str(ROOT))
    while not (work / TL_TRACED_DONE).exists() and child.poll() is None:
        if time.time() - t0 > 300:
            child.kill()
            raise AssertionError("timeline child: its traced runs took over 300 s")
        time.sleep(0.2)
    ends["traced"] = time.time() - t0
    kill_procs, _ = tl_gloo_spawn(work, "kill", env)
    main_procs, main_paths = tl_gloo_spawn(work, "main", env)
    kill_logs = [p.communicate(timeout=300)[0] for p in kill_procs]
    ends["kill"] = time.time() - t0
    (work / "tl_killed_done").write_text("")
    main_logs = [p.communicate(timeout=300)[0] for p in main_procs]
    ends["main"] = time.time() - t0
    child.wait(timeout=300)
    log_child = child_log.read_text()
    ends["nccl child"] = time.time() - t0
    if child.returncode != 0:
        raise AssertionError(f"timeline child failed:\n{log_child[-4000:]}")
    if [p.returncode for p in main_procs] != [0, 0]:
        raise AssertionError("timeline gloo ranks failed:\n" + "\n".join(
            t[-3000:] for t in main_logs))
    t_children = time.time() - t0
    runs_s = {k: round(v["seconds"], 1) for k, v in json.loads(main_paths[0].read_text()).items()}
    log("timeline children end (s from the phase's start): " + ", ".join(
        f"{k} {v:.1f}" for k, v in ends.items()) + f"; gloo runs (rank 0, s) {runs_s}")
    res = json.loads(out_path.read_text())
    checks = {"qsgd_eager": tl_check_run("qsgd_eager", res["qsgd_eager"], {}, times, card)}
    checks["qsgd_k8"] = tl_check_run("qsgd_k8", res["qsgd_k8"], checks["qsgd_eager"], times, card)
    checks["svd3_eager"] = tl_check_run("svd3_eager", res["svd3_eager"], {}, times, card)
    mode = [ln for ln in res["qsgd_k8"]["lines"] if ln.startswith("Superstep:")]
    if mode != ["Superstep: K=8, graph"]:
        raise AssertionError(f"timeline qsgd_k8: {mode}")
    ph = res["phased"]
    workers = [ln for ln in ph["lines"] if ln.startswith("Worker:")]
    masters = [ln for ln in ph["lines"] if ln.startswith("Master:")]
    figs = [tuple(float(x) for x in re.search(
        r"Comp: ([\d.]+), Encode: +([\d.]+), Comm: +([\d.]+)", ln).groups()) for ln in workers]
    n = TL_PHASED_STEPS
    if not (ph["equal"] and len(workers) == len(masters) == n
            and all(min(f) > 0 for f in figs)
            and ph["launches"]["quantize_pack"] == ph["launches"]["unpack_dequantize"] == n):
        raise AssertionError(f"timeline phased: {ph}")
    log(f"phase-metrics nccl-1 qsgd ({card}): {n} phased steps equal the fused gather loop's "
        f"parameters bit for bit; launches {ph['launches']}; Comp/Encode/Comm s by step "
        + "; ".join(f"{c:.4f}/{e:.4f}/{m:.4f}" for c, e, m in figs) + f"; last: {masters[-1]}")
    # the gloo ranks: the measured fabric and the re-allocation
    ranks = [json.loads(p.read_text()) for p in main_paths]
    r0 = ranks[0]
    for name, r in r0.items():
        if r["rc"] != 0 or ranks[1][name]["rc"] != 0:
            raise AssertionError(f"timeline gloo {name}: {r}")
    fab = json.loads((work / "tl_fabric" / "fabric_probe.json").read_text())
    tier = fab["tiers"][0]
    auto = {k: [ln for ln in r0[k]["lines"] if ln.startswith("--aggregate auto ->")]
            for k in ("measured", "pinned")}
    same_state = all((work / "tl_fabric" / f"model_step_{s}").read_bytes()
                     == (work / "tl_pinned" / f"model_step_{s}").read_bytes() for s in (2,))
    reused = any(ln.startswith("Fabric probe: reusing") for ln in r0["fabric_resumed"]["lines"])
    if not (fab["complete"] and auto["measured"] == auto["pinned"] and auto["measured"]
            and same_state and reused and fab["meta"]["group_backend"] == "gloo"):
        raise AssertionError(f"timeline fabric: {fab['meta']}, {auto}, state {same_state}, "
                             f"reused {reused}")
    log(f"fabric measured gloo-2 on the card ({card}): {fab['meta']['group_backend']} group, "
        f"{fab['meta']['buffers']} buffers (gloo sends host buffers): {tier['bandwidth_gbps']} "
        f"GB/s/chip, {tier['latency_us']} us/hop (all_gather {tier['allgather_gbps']} GB/s), "
        f"probe {fab['meta']['probe_wall_s']} s; complete; the run priced and trained as "
        f"--fabric {tier['bandwidth_gbps']} (the same auto line, model_step_2 byte for byte); "
        f"--resume reused the probe; {auto['measured'][0]}")
    for ln in r0["measured"]["lines"][:2]:
        log("  " + ln)
    incidents = [json.loads(ln) for ln in (work / "tl_realloc" / "incidents.jsonl")
                 .read_text().splitlines()]
    re_doc = json.loads((work / "tl_realloc" / "budget_alloc.json").read_text())
    killed_rcs = [p.returncode for p in kill_procs]
    a = (work / "tl_realloc" / "model_step_16").read_bytes()
    b_path = work / "tl_realloc_killed" / "model_step_16"
    equal = b_path.exists() and a == b_path.read_bytes()
    resumed = r0["resumed"]["lines"]
    moved = [r for r in incidents if r["cause"] == "budget_realloc"
             and r["action"].startswith("realloc->")]
    if not (moved and killed_rcs == [43, 43] and equal and len(re_doc["epochs"]) >= 2
            and any(ln.startswith("Resumed from") and ln.endswith("at step 8") for ln in resumed)
            and "Budget: online re-allocation armed (q_err2-fed re-solve at checkpoint "
                "boundaries; decisions land in incidents.jsonl as budget_realloc)"
            in r0["straight"]["lines"]):
        raise AssertionError(f"timeline realloc: incidents {incidents}, killed {killed_rcs}, "
                             f"equal {equal}, resumed {resumed[:6]}\n" + kill_logs[0][-2000:])
    new_ks = moved[0]["ks_new"]
    log(f"realloc gloo-2 qsgd 4 bits ({card}): {len(incidents)} budget_realloc decisions "
        f"{[(r['step'], r['action']) for r in incidents]}; epoch 1 moved "
        f"{len(moved[0]['moved'])} leaves, predicted variance {moved[0]['predicted_variance_old']}"
        f" -> {moved[0]['predicted_variance_new']} (the recorded q_err2 series with the "
        "largest sub-16-bit leaf's error times 1e4, tl_doctor_series); killed at step 12 "
        f"(exit codes {killed_rcs}) and resumed from step 8 under epoch 1: model_step_16 "
        "equals the straight run's byte for byte")
    t_checks = time.time() - t0
    grads = real_resnet_grads(torch.device("cuda"))
    rows = mixed_tree_check(grads, new_ks, "realloc epoch 1", errs)
    del grads
    launches = {k: res["qsgd_eager"]["launches"][k] + res["qsgd_k8"]["launches"][k]
                + res["svd3_eager"]["launches"][k] + ph["launches"][k]
                + ph["fused_launches"][k] + sum(r["launches"][k] for r in r0.values())
                for k in REPLACES}
    out = {"child": {k: {kk: vv for kk, vv in v.items() if kk not in ("doc",)}
                     for k, v in res.items()},
           "checks": checks, "fabric": fab, "realloc": {"incidents": incidents,
                                                        "epochs": re_doc["epochs"],
                                                        "rows": rows},
           "launches": launches, "seconds_children": t_children, "seconds_checks": t_checks,
           "seconds": time.time() - t0}
    log(f"timeline phase seconds {out['seconds']:.1f} (children {t_children:.1f}, checks "
        f"{t_checks:.1f})")
    return out


# ------------------------------------------------------------- partition

PT_STEPS = 6
PT_GLOO_STEPS = 3
PT_DRILL_STEPS = 6
PT_DATA = 1024  # the phase's synthetic CIFAR-10 images


def pt_batches(device, n: int, rank: int = 0, world: int = 1):
    """``n`` global ResNet-18 batches (CIFAR-10 shapes, 128) of a small
    seeded synthetic set (1024 images: a process makes it in a fraction of
    a second), this rank's rows of each, on ``device``."""
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
    from atomo_tpu_torch.parallel.replicated import shard_batch

    it = BatchIterator(synthetic_dataset(SPECS["cifar10"], True, size=PT_DATA), 128,
                       seed=1).epoch()
    return [to_device(*shard_batch(*next(it), rank, world), device) for _ in range(n)]


def pt_state(dev, partition: str, code: str, network: str = "resnet18", image_shape=(32, 32, 3),
             num_classes: int = 10, superstep: int = 1):
    """(state, step, specs) of one partition in the group that is up:
    momentum SGD, ``code``'s codec, the gather exchange."""
    from atomo_tpu_torch.mesh import update as U
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel.replicated import make_distributed_train_step, replicate_state
    from atomo_tpu_torch.training import create_state, make_optimizer

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    model = get_model(network, num_classes, image_shape=image_shape)
    state = replicate_state(create_state(model, opt, 1, dev))
    spec, kw = None, {}
    if partition == "zero1":
        state, spec = U.zero1_state(state, opt)
        kw["zero1"] = spec
    elif partition == "sharded-update":
        state, spec = U.sharded_update_state(state, opt)
        kw["sharded_update"] = spec
    step = make_distributed_train_step(model, opt, make_codec(code), aggregate="gather",
                                       superstep=superstep, **kw)
    return state, step, spec


def pt_digest(state, spec) -> str:
    """A hash of the trained parameters (materialized from the masters under
    the sharded update) and of the momentum, flat in canonical order."""
    import hashlib

    import torch

    from atomo_tpu_torch.training.trainer import leaf_params

    if spec is not None and spec.partition == "sharded-update":
        spec.materialize(state.master)
    h = hashlib.sha256()
    params = leaf_params(state.model)
    trace = state.opt_state.trace
    flat = (torch.cat([t.reshape(-1) for t in trace]) if spec is None
            else spec.gather(trace[0])[:spec.d_flat])
    for t in params + [flat]:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def pt_run(state, step, spec, batches) -> tuple:
    """The eager steps with the launch counts set to 0 before and read after:
    (state, losses, host ms a step, launches, digest)."""
    import torch

    from atomo_tpu_torch import ops

    ops.reset_launch_counts()
    losses, ms = [], []
    for x, y in batches:
        t0 = time.perf_counter()
        state, m = step(state, 2, x, y)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    return state, {"losses": losses, "step_ms": ms, "launches": launches,
                   "digest": pt_digest(state, spec)}


def partition_child(work: str, out_path: str) -> int:
    """The deterministic NCCL-world-1 runs of the ``partition`` phase (this
    script with ``--partition-child``; cuBLAS's workspace set before its
    first handle): ResNet-18 batch 128, qsgd 4 bits and svd rank 3, the
    replicated and the sharded-update step 6 steps each from one init, and
    the qsgd sharded step as the K 8 graph over the same 6 batches."""
    import os

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import ops
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.training.trainer import leaf_params

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{work}/pt_nccl1", world_size=1,
                      rank=0)
    t0 = float(os.environ["PT_T0"])  # the phase's start: seconds below count from it
    out = {"started": {"launches": {}, "seconds": T_START - t0},
           "group up": {"launches": {}, "seconds": time.time() - t0}}
    try:
        batches = pt_batches(dev, PT_STEPS)
        for code in ("qsgd", "svd3"):
            for part in ("replicated", "sharded-update"):
                state, step, spec = pt_state(dev, part, code)
                _, out[f"{code}_{part}"] = pt_run(state, step, spec, batches)
                out[f"{code}_{part}"]["seconds"] = time.time() - t0
        state, block, spec = pt_state(dev, "sharded-update", "qsgd", superstep=8)
        xs = torch.stack([x for x, _ in batches])
        ys = torch.stack([y for _, y in batches])
        ops.reset_launch_counts()
        state, m = block(state, 2, xs, ys)
        torch.cuda.synchronize()
        out["qsgd_sharded_k8"] = {"losses": m["loss"].tolist(), "mode": block.mode,
                                  "why": block.why, "replays": block.replays,
                                  "launches": ops.launch_counts(),
                                  "digest": pt_digest(state, spec),
                                  "d_flat": spec.d_flat, "chunk": spec.chunk,
                                  "n_params": sum(p.numel() for p in leaf_params(state.model)),
                                  "seconds": time.time() - t0}
        del state, block, spec
        # the drill's straight run, in this group
        ops.reset_launch_counts()
        pt_drill_loop(dev, str(Path(work) / "pt_straight"), None, resume=False)
        out["drill_straight"] = {"launches": ops.launch_counts(), "seconds": time.time() - t0}
    finally:
        launch.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def pt_memory(dev, partition: str, code: str, batches, network="resnet18",
              image_shape=(32, 32, 3), num_classes=10) -> dict:
    """One partition's steps on this rank: the bytes the rank holds between
    steps (``memory_allocated`` above the batches, the gradients dropped: the
    next step's start drops them, and the sharded step drops its own) and its
    peak, the digest, the losses and the launches."""
    import gc

    import torch

    from atomo_tpu_torch.training.trainer import leaf_params

    gc.collect()  # the previous run's step closures hold its state in cycles
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, step, spec = pt_state(dev, partition, code, network, image_shape, num_classes)
    state, r = pt_run(state, step, spec, batches)
    for p in leaf_params(state.model):
        p.grad = None
    if spec is not None and spec.partition == "sharded-update":
        spec.release(leaf_params(state.model))  # pt_run's digest materialized it
    gc.collect()
    torch.cuda.synchronize()
    r["persistent_bytes"] = torch.cuda.memory_allocated() - base
    r["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    r["n_params"] = sum(p.numel() for p in leaf_params(state.model))
    del state, step, spec
    return r


def partition_gloo_child(rank: int, store: str, out_path: str) -> int:
    """One of two gloo ranks on the card (this script with
    ``--partition-gloo-child``; deterministic through a sitecustomize):
    ResNet-18 qsgd 4 bits gather at global batch 128, 3 steps of each
    partition from one init, then AlexNet at 224 (1000 classes, 61 M
    parameters, global batch 8) one step of each: per partition the bytes
    between steps, the peak, the digest, the launches."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.replicated import shard_batch

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="gloo", init_method=f"file://{store}", world_size=2,
                      rank=rank)
    t0 = float(os.environ["PT_T0"])  # the phase's start: seconds below count from it
    out = {"seconds": {"started": T_START - t0, "group up": time.time() - t0}}
    try:
        batches = pt_batches(dev, PT_GLOO_STEPS, rank, 2)
        # one step first: cuBLAS's and cuDNN's workspaces are not a partition's
        pt_memory(dev, "replicated", "qsgd", batches[:1])
        out["seconds"]["warm-up"] = time.time() - t0
        for part in ("replicated", "zero1", "sharded-update"):
            out[f"resnet18_{part}"] = pt_memory(dev, part, "qsgd", batches)
            out["seconds"][f"resnet18_{part}"] = time.time() - t0
        del batches
        gen = torch.Generator().manual_seed(5)
        x = torch.randn((8, 3, 224, 224), generator=gen).numpy()
        y = torch.randint(0, 1000, (8,), generator=gen).numpy()
        xs, ys = shard_batch(x, y, rank, 2)
        big = [(torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev))]
        for part in ("replicated", "zero1", "sharded-update"):
            out[f"alexnet_{part}"] = pt_memory(dev, part, "qsgd", big, "alexnet",
                                               (224, 224, 3), 1000)
            out["seconds"][f"alexnet_{part}"] = time.time() - t0
    finally:
        launch.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def pt_drill_loop(dev, train_dir: str, chaos, resume: bool, log_fn=print) -> None:
    """The drill's run: ``distributed_train_loop`` in the group that is up,
    the sharded update with ``overlap='delayed'``, ResNet-18 qsgd 4 bits
    gather batch 128, 6 steps, a checkpoint every 2; ``chaos`` a fault spec
    or None."""
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import distributed_train_loop, make_optimizer
    from atomo_tpu_torch.utils.chaos import ChaosConfig, ChaosInjector

    it = BatchIterator(synthetic_dataset(SPECS["cifar10"], True, size=PT_DATA), 128, seed=1)
    distributed_train_loop(
        get_model("resnet18", 10, image_shape=(32, 32, 3)),
        make_optimizer("sgd", lr=0.01, momentum=0.9), it, None, codec=make_codec("qsgd"),
        aggregate="gather", overlap="delayed", partition="sharded-update",
        max_steps=PT_DRILL_STEPS, save_freq=2, seed=1, train_dir=train_dir, resume=resume,
        log_every=1, log_fn=log_fn, device=dev, compress_ckpt=False,
        chaos=None if chaos is None else ChaosInjector(ChaosConfig.from_spec(chaos,
                                                                             environ={})))


def partition_drill_child(train_dir: str, chaos: str, *extra: str) -> int:
    """One attempt of the supervised drill (this script with
    ``--partition-drill-child``; deterministic through a sitecustomize):
    :func:`pt_drill_loop` at NCCL world 1 with ``chaos``, quiet; ``--resume``
    (a supervisor's restart) continues from the newest checkpoint. Writes
    ``<train_dir>.attempt-<n>.json`` when its group is up and again at its
    end: seconds into the phase (``PT_T0``) and the launch counts."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    from atomo_tpu_torch import ops
    from atomo_tpu_torch.parallel import launch

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="nccl", init_method=f"file://{train_dir}.store{os.getpid()}",
                      world_size=1, rank=0)
    t0 = float(os.environ["PT_T0"])
    rec = {"started": T_START - t0, "group_up": time.time() - t0}
    out = Path(f"{train_dir}.attempt-{os.environ.get('ATOMO_RUN_ATTEMPT', '0')}.json")
    out.write_text(json.dumps(rec))
    try:
        ops.reset_launch_counts()
        pt_drill_loop(dev, train_dir, chaos, "--resume" in extra, log_fn=lambda line: None)
        out.write_text(json.dumps({**rec, "done": time.time() - t0,
                                   "launches": ops.launch_counts()}))
    finally:
        launch.shutdown()
    return 0


def pt_children(work: Path) -> dict:
    """Start the phase's children at once: the supervised drill (its
    supervisor a thread of this process, its attempts children), the
    deterministic NCCL child and the two gloo ranks; returns the processes,
    the drill's thread and box, and their paths."""
    import os
    import threading

    from atomo_tpu_torch.training.resilience import run_supervised

    det = work / "pt_det"
    det.mkdir(exist_ok=True)
    (det / "sitecustomize.py").write_text(
        "import torch\ntorch.use_deterministic_algorithms(True, warn_only=True)\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(det), str(ROOT)]))
    for k in ("ATOMO_CHAOS", "ATOMO_SUPERVISED", "ATOMO_RUN_ATTEMPT", "WORLD_SIZE"):
        env.pop(k, None)
    env["PT_T0"] = repr(time.time())
    me = str(Path(__file__).resolve())
    paths = {"det": work / "pt_det.json", "gloo": [work / f"pt_gloo{r}.json" for r in range(2)],
             "straight": work / "pt_straight", "drill": work / "pt_drill"}
    # the drill first (its chain is the longest): kill@5 ends attempt 0
    # (exit 43), attempt 1 resumes
    box = {"lines": []}

    def drill():
        box["rc"] = run_supervised(
            [sys.executable, me, "--partition-drill-child", str(paths["drill"]), "kill@5"],
            max_restarts=1, backoff_base=0.05, backoff_max=0.1, train_dir=str(paths["drill"]),
            env=env, log_fn=box["lines"].append)

    thread = threading.Thread(target=drill, daemon=True)
    thread.start()
    # the others start once attempt 0 is up: processes that import torch and
    # make their CUDA contexts at once slow each other several-fold
    first = Path(f"{paths['drill']}.attempt-0.json")
    deadline = time.time() + 60
    while not first.exists() and thread.is_alive() and time.time() < deadline:
        time.sleep(0.2)
    procs = {"det": subprocess.Popen([sys.executable, me, "--partition-child", str(work),
                                      str(paths["det"])], env=env, cwd=str(ROOT),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)}
    procs["gloo"] = [subprocess.Popen(
        [sys.executable, me, "--partition-gloo-child", str(r), str(work / "pt_gloo_store"),
         str(paths["gloo"][r])], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    return {"procs": procs, "paths": paths, "drill": (thread, box)}


def pt_timing(dev, work: Path) -> dict:
    """Median host ms a step (steps 2-6) of the replicated and the sharded
    eager step at NCCL world 1, qsgd and svd3, in turns replicated,
    sharded, sharded, replicated; and the materialize alone."""
    import torch

    from atomo_tpu_torch.parallel import launch

    up = torch.distributed.is_initialized()
    if not up:
        launch.initialize(dev, backend="nccl", init_method=f"file://{work}/pt_time",
                          world_size=1, rank=0)
    res = {"launches": {name: 0 for name in REPLACES}}
    try:
        batches = pt_batches(dev, PT_STEPS)
        for code in ("qsgd", "svd3"):
            meds = {"replicated": [], "sharded-update": []}
            runs = {part: pt_state(dev, part, code) for part in meds}
            for part in ("replicated", "sharded-update", "sharded-update", "replicated"):
                state, step, spec = runs[part]
                state, r = pt_run(state, step, spec, batches)
                runs[part] = (state, step, spec)
                meds[part].append(statistics.median(r["step_ms"][1:]))
                for k, v in r["launches"].items():
                    res["launches"][k] = res["launches"].get(k, 0) + v
                if part == "sharded-update" and "materialize_ms" not in res:
                    res["materialize_ms"] = cuda_ms(lambda: spec.materialize(state.master))
                    res["materialize_bytes"] = spec.flat.numel() * 4
            del runs, state, step, spec
            res[code] = {k: statistics.median(v) for k, v in meds.items()}
    finally:
        if not up:
            launch.shutdown()
    return res


def phase_partition(work: Path, card: str) -> dict:
    """The partitioned update on the card (the module docstring's item 19)."""
    import torch

    t0 = time.time()
    kids = pt_children(work)
    procs, paths = kids["procs"], kids["paths"]
    logs, ends = {}, {}
    logs["det"] = procs["det"].communicate(timeout=300)[0]
    ends["det"] = time.time() - t0
    logs["gloo"] = [p.communicate(timeout=300)[0] for p in procs["gloo"]]
    ends["gloo"] = time.time() - t0
    thread, box = kids["drill"]
    thread.join(timeout=300)
    ends["drill"] = time.time() - t0
    t_children = time.time() - t0
    log("partition children end (s from the phase's start): " + ", ".join(
        f"{k} {v:.1f}" for k, v in ends.items()))
    if procs["det"].returncode != 0:
        raise AssertionError(f"partition child failed:\n{logs['det'][-4000:]}")
    if [p.returncode for p in procs["gloo"]] != [0, 0]:
        raise AssertionError("partition gloo ranks failed:\n" + "\n".join(
            t[-3000:] for t in logs["gloo"]))
    attempts = {p.name: json.loads(p.read_text())
                for p in sorted(work.glob("pt_drill.attempt-*.json"))}
    if thread.is_alive() or box.get("rc") != 0:
        raise AssertionError(f"partition drill failed: rc {box.get('rc')}, {box['lines']}, "
                             f"attempts {attempts}")
    det = json.loads(paths["det"].read_text())
    out = {"det": det}
    for code in ("qsgd", "svd3"):
        rep, su = det[f"{code}_replicated"], det[f"{code}_sharded-update"]
        if rep["digest"] != su["digest"] or rep["losses"] != su["losses"]:
            raise AssertionError(f"partition nccl-1 {code}: sharded {su} vs replicated {rep}")
        log(f"partition nccl-1 {code} (deterministic): sharded-update's parameters and momentum "
            f"equal the replicated step's bit for bit after {PT_STEPS} steps; losses "
            f"{[round(v, 4) for v in su['losses']]}; launches a run {su['launches']}")
    k8, su = det["qsgd_sharded_k8"], det["qsgd_sharded-update"]
    if not (k8["mode"] == "graph" and k8["digest"] == su["digest"]
            and k8["losses"] == su["losses"] and k8["replays"] == PT_STEPS - 1
            and k8["launches"] == su["launches"]):
        raise AssertionError(f"partition K=8 graph: {k8} vs eager {su}")
    log(f"partition nccl-1 qsgd sharded-update as the K 8 graph: 1 warm-up, {k8['replays']} "
        f"replays, equal to its eager steps bit for bit (master, momentum, losses, launches "
        f"{k8['launches']}); flat {k8['d_flat']} values, chunk {k8['chunk']}")
    ranks = [json.loads(p.read_text()) for p in paths["gloo"]]
    for net in ("resnet18", "alexnet"):
        digests = {ranks[r][f"{net}_{p}"]["digest"] for r in range(2)
                   for p in ("replicated", "zero1", "sharded-update")}
        if len(digests) != 1:
            raise AssertionError(f"partition gloo-2 {net}: {len(digests)} distinct states")
        rows = []
        for p in ("replicated", "zero1", "sharded-update"):
            a = [ranks[r][f"{net}_{p}"] for r in range(2)]
            rows.append(f"{p} persistent {a[0]['persistent_bytes'] / 1e6:.1f}/"
                        f"{a[1]['persistent_bytes'] / 1e6:.1f} MB, peak "
                        f"{a[0]['peak_bytes'] / 1e6:.1f}/{a[1]['peak_bytes'] / 1e6:.1f} MB, step ms "
                        f"{statistics.median(a[0]['step_ms'][1:] or a[0]['step_ms']):.1f}")
        per = {p: [ranks[r][f"{net}_{p}"]["persistent_bytes"] for r in range(2)]
               for p in ("replicated", "zero1", "sharded-update")}
        if not all(per["sharded-update"][r] < per["zero1"][r] < per["replicated"][r]
                   for r in range(2)):
            raise AssertionError(f"partition gloo-2 {net}: persistent bytes {per}")
        n = ranks[0][f"{net}_replicated"]["n_params"]
        log(f"partition gloo-2 {net} ({n} params, rank 0/rank 1) ({card}): " + "; ".join(rows)
            + "; parameters and momentum equal across the three")
    out["gloo"] = ranks
    log("partition children's stages (s into the phase): nccl " + ", ".join(
        f"{k} {v['seconds']:.1f}" for k, v in det.items()) + "; gloo rank 0 " + ", ".join(
        f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items()))
    runs = [r[k] for r in ranks for k in r if k != "seconds"]
    a = (paths["straight"] / f"model_step_{PT_DRILL_STEPS}").read_bytes()
    b_path = paths["drill"] / f"model_step_{PT_DRILL_STEPS}"
    incidents = [json.loads(ln) for ln in (paths["drill"] / "incidents.jsonl").read_text()
                 .splitlines()]
    acts = [(r["cause"], r["action"]) for r in incidents]
    if not (b_path.exists() and b_path.read_bytes() == a
            and acts[:1] == [("crash", "restart")] and acts[-1] == ("clean_exit", "done")):
        raise AssertionError(f"partition drill: incidents {acts}, equal "
                             f"{b_path.exists() and b_path.read_bytes() == a}; "
                             f"supervisor {box['lines']}, attempts {attempts}")
    for ln in box["lines"]:
        log("  " + ln)
    log("  drill attempts (s into the phase): " + "; ".join(
        f"{k.split('.')[1]} started {v['started']:.1f}, group up {v['group_up']:.1f}"
        + (f", done {v['done']:.1f}" if "done" in v else ", killed") for k, v in attempts.items()))
    log(f"partition drill nccl-1 (sharded-update, --overlap delayed, kill@5, one restart): "
        f"incidents {acts}; model_step_{PT_DRILL_STEPS} equals the straight run's byte for "
        "byte (the checkpoint carries the in-flight payload)")
    t_checks = time.time() - t0
    dev = torch.device("cuda", 0)
    timing = pt_timing(dev, work)
    out["timing"] = timing
    for code in ("qsgd", "svd3"):
        t = timing[code]
        log(f"partition time nccl-1 {code} ({card}): median step ms replicated "
            f"{t['replicated']:.3f}, sharded-update {t['sharded-update']:.3f} "
            f"({t['sharded-update'] / t['replicated'] - 1:+.1%})")
    log(f"partition materialize nccl-1 ({card}): {timing['materialize_bytes'] / 1e6:.1f} MB "
        f"device copy {timing['materialize_ms']:.4f} ms "
        f"(bound {timing['materialize_bytes'] * 2 / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    drill_launches = [v["launches"] for v in attempts.values() if "launches" in v]
    launches = {name: timing["launches"].get(name, 0)
                + sum(det[k]["launches"].get(name, 0) for k in det)
                + sum(r["launches"].get(name, 0) for r in runs)
                + sum(d.get(name, 0) for d in drill_launches)
                for name in REPLACES}
    out.update({"launches": launches, "seconds_children": t_children,
                "seconds_checks": t_checks, "seconds": time.time() - t0})
    log(f"partition phase seconds {out['seconds']:.1f} (children {t_children:.1f}, timing "
        f"{out['seconds'] - t_checks:.1f}); rows 1-2 launches {launches['quantize_pack']}, "
        f"{launches['unpack_dequantize']}")
    return out


# ------------------------------------------------------------------ quorum

QM_STEPS, QM_SVD_STEPS = 6, 3
QM_COMMON = ["--n-devices", "2", "--aggregate", "gather", "--eval-freq", "0", "--obs-record"]
QM_QUORUM = ["--quorum", "1", "--staleness", "1", "--quorum-period-ms", "100"]
QM_SLOW = ["--chaos", "slow@3:1:0.25"]


def quorum_gloo_child(rank: int, work: str, out_path: str) -> int:
    """One of two gloo ranks on the card (this script with
    ``--quorum-gloo-child``; deterministic through a sitecustomize), every
    run through ``train`` in this one process: ResNet-18 qsgd 4 bits gather
    6 steps, (a) ``--quorum 1 --staleness 1 --quorum-period-ms 100`` under
    ``slow@3:1:0.25``, (b) ``--replay-arrivals`` of (a)'s schedule, (c)
    blocking under the same chaos, and svd rank 3 live 3 steps. Per run the
    state hash after every step (the step wrapped to take it), the lines,
    the launches (row 2's survivor-mode launches beside them) and the
    seconds."""
    sys.path.insert(0, str(ROOT))
    import torch

    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch import cli, ops
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel import launch

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="gloo", init_method=f"file://{work}/qm_gloo_store",
                      world_size=2, rank=rank)
    w = Path(work)
    out = {}
    hashes: list = []
    make = R.make_distributed_train_step

    def hashing(model, *args, **kw):
        """The loop's step, with this rank's state hash taken after each call."""
        step = make(model, *args, **kw)

        def wrapped(*a, **k):
            result = step(*a, **k)
            hashes.append(state_hash(model))
            return result

        wrapped.__dict__.update(step.__dict__)
        return wrapped

    def run(name, argv):
        lines: list[str] = []
        hashes.clear()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(TRAIN_ARGS[:-1] + [str(w / name)] + QM_COMMON + argv,
                      log_fn=lines.append)
        out[name] = {"rc": rc, "lines": lines, "launches": ops.launch_counts(),
                     "survivor_launches": K.unpack_dequantize.survivor_launches,
                     "hashes": list(hashes), "seconds": time.perf_counter() - t0}
        Path(out_path).write_text(json.dumps(out))

    R.make_distributed_train_step = hashing
    try:
        steps = ["--max-steps", str(QM_STEPS), "--save-freq", str(QM_STEPS)]
        run("qm_live", ["--code", "qsgd"] + steps + QM_QUORUM + QM_SLOW)
        run("qm_replay", ["--code", "qsgd"] + steps + QM_QUORUM + [
            "--replay-arrivals", str(w / "qm_live" / "arrival_schedule.jsonl")])
        run("qm_block", ["--code", "qsgd"] + steps + QM_SLOW)
        run("qm_svd3", ["--code", "svd", "--svd-rank", "3", "--max-steps", str(QM_SVD_STEPS)]
            + QM_QUORUM + QM_SLOW)
    finally:
        R.make_distributed_train_step = make
        launch.shutdown()
    return 0


def qm_spawn(work: Path) -> list:
    """The two gloo ranks of the quorum phase, deterministic (a
    sitecustomize on their path); returns (processes, result paths)."""
    import os

    det = work / "qm_det"
    det.mkdir(exist_ok=True)
    (det / "sitecustomize.py").write_text(
        "import torch\ntorch.use_deterministic_algorithms(True, warn_only=True)\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(det), str(ROOT)]))
    for k in ("ATOMO_CHAOS", "ATOMO_SUPERVISED", "ATOMO_RUN_ATTEMPT", "WORLD_SIZE"):
        env.pop(k, None)
    paths = [work / f"qm_gloo{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--quorum-gloo-child", str(r),
         str(work), str(paths[r])], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    return [procs, paths]


def qm_row2(grads, errs: dict, card: str) -> tuple:
    """Row 2's survivor mode over a 4-replica gathered buffer of the
    ResNet-18 tree (4 bits, encoded on the card) with 0, 1, 2 and 4
    replicas flagged out: each against its plain twin bit for bit; all up
    against today's unflagged mean bit for bit; replica 3's bytes overwritten
    with NaN scales and all-ones words, flagged out, give the bits of its
    clean bytes flagged out (they are never read). Returns the result and a
    timing function (device ms of the survivor and the flagged form, one of
    4 flagged out, and the survivor form's bytes bound)."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, encode_tree
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets

    codec = QsgdCodec(bits=4)
    bufs = []
    for r in range(4):
        payloads, _ = encode_tree(codec, 200 + r, grads)
        buf, spec = pack_tree_buckets(payloads)
        bufs.append(buf)
    rows = torch.stack(bufs)
    bad = rows.clone()
    bad_views = unpack_tree_buckets(bad, spec)
    for v in bad_views:  # replica 3's fields: NaN scales, all-ones words
        v.scales[3].fill_(float("nan"))
        v.words[3].view(torch.int32).fill_(-1)
    pays = [tuple(p) for p in unpack_tree_buckets(rows, spec)]
    bad_pays = [tuple(p) for p in bad_views]
    kw = dict(bits=4, n_replicas=4)
    flagsets = {"0 out": [1.0, 1.0, 1.0, 1.0], "1 out": [1.0, 1.0, 1.0, 0.0],
                "2 out": [1.0, 0.0, 1.0, 0.0], "4 out": [0.0, 0.0, 0.0, 0.0]}
    res = {"bytes_a_replica": int(rows.shape[1]), "cases": {}}
    err = 0.0
    for label, f in flagsets.items():
        flags = torch.tensor(f, device=rows.device)
        K.reset_launch_counts()
        got = K.unpack_dequantize_tree(pays, grads, replica_ok=flags, survivor=True, **kw)
        launches = K.unpack_dequantize.survivor_launches
        plain = K.unpack_dequantize_tree_plain(pays, grads, replica_ok=flags, survivor=True,
                                               **kw)
        case = {"twin_bit_equal": all(same_bits(a, b) for a, b in zip(got, plain)),
                "launches": launches}
        err = max(err, max(float((a - b).abs().max()) for a, b in zip(got, plain)))
        if f[3] == 0.0:
            poisoned = K.unpack_dequantize_tree(bad_pays, grads, replica_ok=flags, survivor=True,
                                                **kw)
            case["nan_bytes_unread"] = all(same_bits(a, b) for a, b in zip(poisoned, got))
            case["finite"] = all(bool(torch.isfinite(a).all()) for a in poisoned)
        if label == "0 out":
            today = K.unpack_dequantize_tree(pays, grads, **kw)
            case["equals_unflagged_mean"] = all(same_bits(a, b) for a, b in zip(got, today))
        if label == "4 out":
            case["zeros"] = all(not bool(a.any()) for a in got)
        res["cases"][label] = case
        if not all(v for k, v in case.items() if k != "launches") or launches != 1:
            raise AssertionError(f"quorum row 2 survivor mode {label}: {case}")
    errs["unpack_dequantize_survivor"] = err
    n_values = sum(g.numel() for g in grads)
    # one of four flagged out: three replicas' payloads read, the flags, the
    # float32 mean written
    res["bound_ms"], res["bound_by"] = bound(3 * res["bytes_a_replica"] + 16 + 4 * n_values,
                                             3 * 3 * n_values)
    flags = torch.tensor(flagsets["1 out"], device=rows.device)
    cpu_pays = [tuple(t.cpu() for t in p) for p in pays]
    cpu_like = [g.cpu() for g in grads]

    def timing():
        res["device_ms"] = device_ms(lambda: K.unpack_dequantize_tree(
            pays, grads, replica_ok=flags, survivor=True, **kw), "unpack_dequantize")
        res["device_ms_flagged"] = device_ms(lambda: K.unpack_dequantize_tree(
            pays, grads, replica_ok=flags, **kw), "unpack_dequantize")
        res["ms"] = cuda_ms(lambda: K.unpack_dequantize_tree(pays, grads, replica_ok=flags,
                                                             survivor=True, **kw))
        res["plain_ms"] = cuda_ms(lambda: K.unpack_dequantize_tree_plain(
            pays, grads, replica_ok=flags, survivor=True, **kw), reps=5)
        res["plain_cpu_check"] = all(same_bits(a.cpu(), b) for a, b in zip(
            K.unpack_dequantize_tree(pays, grads, replica_ok=flags, survivor=True, **kw),
            K.unpack_dequantize_tree_plain(cpu_pays, cpu_like, replica_ok=flags.cpu(),
                                           survivor=True, **kw)))
        if not res["plain_cpu_check"]:
            raise AssertionError("quorum row 2 survivor mode: the card's mean differs from "
                                 "the plain twin's on the CPU")
        log(f"quorum row 2 survivor mode ({card}): 4-replica gathered ResNet-18 buffer "
            f"({res['bytes_a_replica']} bytes a replica), 0/1/2/4 flagged out: each equals "
            f"its plain twin bit for bit (on the card, and on the CPU for 1 out), one launch "
            f"each; all up equals today's unflagged mean bit for bit; replica 3's NaN bytes "
            f"flagged out never read (finite, the clean bytes' bits); 4 out all zeros; "
            f"1 out: device ms {res['device_ms']:.4f} survivor, {res['device_ms_flagged']:.4f} "
            f"flagged, bound {res['bound_ms']:.4f} ({res['bound_by']}), events "
            f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms")
        return res

    return res, timing


def qm_records(train_dir: Path) -> list:
    from atomo_tpu_torch.obs.recorder import FlightRecorder, metrics_path

    return FlightRecorder.read_steps(metrics_path(str(train_dir)))


def phase_quorum(work: Path, card: str, grads, errs: dict, p2p: dict) -> dict:
    """Bounded-staleness quorum on the card (the module docstring's item
    20): row 2's survivor mode in this process while the two gloo ranks run
    ``train --quorum``; their checks; then row 2's timing."""
    from atomo_tpu_torch.quorum.artifact import read_schedule, schedule_path
    from atomo_tpu_torch.quorum.schedule import staleness_vector

    t0 = time.time()
    procs, paths = qm_spawn(work)
    row2, row2_timing = qm_row2(grads, errs, card)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    t_children = time.time() - t0
    if [p.returncode for p in procs] != [0, 0]:
        raise AssertionError("quorum gloo ranks failed:\n" + "\n".join(
            t[-3000:] for t in logs))
    ranks = [json.loads(p.read_text()) for p in paths]
    out = {"row2": row2, "runs": {}}
    for name in ("qm_live", "qm_replay", "qm_block", "qm_svd3"):
        r0, r1 = ranks[0][name], ranks[1][name]
        want = QM_SVD_STEPS if name == "qm_svd3" else QM_STEPS
        if r0["rc"] != 0 or r1["rc"] != 0 or len(r0["hashes"]) != want:
            raise AssertionError(f"quorum {name}: {r0['rc']}, {r1['rc']}, "
                                 f"{len(r0['hashes'])} steps; {r0['lines'][-3:]}")
        if r0["hashes"] != r1["hashes"]:
            raise AssertionError(f"quorum {name}: the replicas differ after a step")
        recs = qm_records(work / name)
        out["runs"][name] = {"launches": r0["launches"],
                             "survivor_launches": r0["survivor_launches"],
                             "step_ms": [r.get("step_ms") for r in recs],
                             "losses": [round(r["loss"], 4) for r in recs],
                             "seconds": r0["seconds"]}
        if name == "qm_block":
            continue
        meta, sched = read_schedule(schedule_path(str(work / name)))
        for rec in recs:
            s = rec["step"]
            sigma, exposed, _ = staleness_vector(
                s, n_dev=2, quorum=1, staleness=1, faults=((3, 1, 0.25),), period_s=0.1)
            a = sched[s]
            if (a["staleness"] != sigma or a["exposed_wait_ms"] != round(exposed * 1e3, 3)
                    or rec["quorum_kept"] != a["kept"] or rec["stale_dropped"] != a["dropped"]):
                raise AssertionError(f"quorum {name} step {s}: recorded {rec}, schedule {a}, "
                                     f"derived {sigma} {exposed}")
        if name != "qm_svd3":
            # one row-1 launch a step and one at the start, where the ring's
            # layout is read off one encode of the parameters
            if (r0["survivor_launches"] != QM_STEPS
                    or r0["launches"]["quantize_pack"] != QM_STEPS + 1):
                raise AssertionError(f"quorum {name}: launches {r0['launches']}, survivor "
                                     f"{r0['survivor_launches']}")
    live, rep = work / "qm_live", work / "qm_replay"
    same = ((live / f"model_step_{QM_STEPS}").read_bytes()
            == (rep / f"model_step_{QM_STEPS}").read_bytes())
    if not same or ranks[0]["qm_live"]["hashes"] != ranks[0]["qm_replay"]["hashes"]:
        raise AssertionError("quorum: the replay does not end in the live run's state")
    if read_schedule(schedule_path(str(rep)))[1] != read_schedule(schedule_path(str(live)))[1]:
        raise AssertionError("quorum: the replay did not re-record the live schedule")
    runs = out["runs"]
    q_ms = statistics.median(runs["qm_live"]["step_ms"][3:6])
    b_ms = statistics.median(runs["qm_block"]["step_ms"][3:6])
    out.update(median_step_ms_live=q_ms, median_step_ms_blocking=b_ms,
               children_seconds=t_children)
    sched = read_schedule(schedule_path(str(live)))[1]
    log(f"quorum gloo-2 resnet18 qsgd gather (deterministic): live --quorum 1 --staleness 1 "
        f"--quorum-period-ms 100 under slow@3:1:0.25, schedule "
        f"{[sched[s]['staleness'] for s in sorted(sched)]} (kept "
        f"{[sched[s]['kept'] for s in sorted(sched)]}, exposed wait ms "
        f"{[sched[s]['exposed_wait_ms'] for s in sorted(sched)]}), the recorded quorum_kept "
        f"and stale_dropped columns equal it; replicas bit-identical after each of {QM_STEPS} "
        f"steps; --replay-arrivals ends in the live run's model_step_{QM_STEPS} byte for "
        f"byte; row 2 in its survivor mode {runs['qm_live']['survivor_launches']} launches "
        f"in {QM_STEPS} steps, launches {runs['qm_live']['launches']}")
    log(f"quorum svd3 gloo-2 live: {QM_SVD_STEPS} steps, replicas bit-identical, losses "
        f"{runs['qm_svd3']['losses']}, launches {runs['qm_svd3']['launches']}")
    log(f"quorum time ({card}): median step ms steps 4-6: live quorum {q_ms:.3f}, blocking "
        f"{b_ms:.3f} (blocking sleeps 250 ms a step from step 3 on, the quorum step waits 0); "
        f"losses live {runs['qm_live']['losses']}, blocking {runs['qm_block']['losses']}")
    log(f"quorum ring: left out on the card (it needs gloo's send and receive of CUDA "
        f"tensors between two ranks, which the dist gloo-2 probe saw exit {p2p['exit_codes']})")
    out["row2"] = row2_timing()
    log(f"quorum phase seconds: children {t_children:.1f}, all {time.time() - t0:.1f}")
    return out

TP_STEPS, TP_SVD_STEPS = 3, 2
TP_COMMON = ["--n-devices", "4", "--dcn-ways", "2", "--eval-freq", "0"]
TP_RUN1 = ["--aggregate", "auto", "--plan", "psum+gather", "--fabric", "measured", "--code",
           "qsgd", "--max-steps", str(TP_STEPS)]


def topology_gloo_child(rank: int, work: str, out_path: str) -> int:
    """One of four gloo ranks on cuda:0 (this script with
    ``--topology-gloo-child``; deterministic through a sitecustomize): the
    two-tier ``(dp=2, ici=2)`` mesh, every run through ``train`` in this one
    process. (1) ResNet-18 qsgd 4 bits 3 steps, ``--aggregate auto
    --dcn-ways 2 --plan psum+gather --fabric measured``; (2) the same with
    ``--grad-guard --chaos nan@2``; (3) svd rank 3, ``--aggregate
    hierarchical`` (the legacy plan), 2 steps. Per run the state hash after
    every step, the lines, the launches and the seconds; on rank 0 every
    row-2 launch's output held against its plain twin on the same inputs
    (the outer decode over the K = 2 gathered rows, flagged under the
    guard)."""
    sys.path.insert(0, str(ROOT))
    import torch

    import atomo_tpu_torch.parallel.replicated as R
    from atomo_tpu_torch import cli, ops
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel import launch

    dev = torch.device("cuda", 0)
    launch.initialize(dev, backend="gloo", init_method=f"file://{work}/tp_gloo_store",
                      world_size=4, rank=rank)
    w = Path(work)
    out = {}
    hashes: list = []
    twins: list = []
    make = R.make_distributed_train_step
    decode = K.unpack_dequantize_tree

    def hashing(model, *args, **kw):
        """The loop's step, with this rank's state hash taken after each call."""
        step = make(model, *args, **kw)

        def wrapped(*a, **k):
            result = step(*a, **k)
            hashes.append(state_hash(model))
            return result

        wrapped.__dict__.update(step.__dict__)
        return wrapped

    def checked(payloads, outs_like, layouts=None, **kw):
        """Row 2 as the codec calls it, then its plain twin on the same
        inputs (no launch), bit for bit."""
        got = decode(payloads, outs_like, layouts, **kw)
        if rank == 0:
            plain = K.unpack_dequantize_tree_plain(payloads, outs_like, layouts, **kw)
            twins.append({"bit_equal": all(same_bits(a, b) for a, b in zip(got, plain)),
                          "max_abs_err": max(float((a - b).abs().max())
                                             for a, b in zip(got, plain)),
                          "n_replicas": kw.get("n_replicas"),
                          "flags": (None if kw.get("replica_ok") is None
                                    else [float(f) for f in kw["replica_ok"]])})
        return got

    def run(name, argv):
        lines: list[str] = []
        hashes.clear()
        twins.clear()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(TRAIN_ARGS[:-1] + [str(w / name)] + TP_COMMON + argv,
                      log_fn=lines.append)
        out[name] = {"rc": rc, "lines": lines, "launches": ops.launch_counts(),
                     "hashes": list(hashes), "twins": list(twins),
                     "seconds": time.perf_counter() - t0}
        Path(out_path).write_text(json.dumps(out))

    R.make_distributed_train_step = hashing
    K.unpack_dequantize_tree = checked
    try:
        run("tp_qsgd", TP_RUN1)
        run("tp_guard", TP_RUN1 + ["--grad-guard", "--chaos", "nan@2"])
        run("tp_svd3", ["--aggregate", "hierarchical", "--code", "svd", "--svd-rank", "3",
                        "--max-steps", str(TP_SVD_STEPS)])
    finally:
        R.make_distributed_train_step = make
        K.unpack_dequantize_tree = decode
        launch.shutdown()
    return 0


def tp_spawn(work: Path) -> list:
    """The four gloo ranks of the topology phase, deterministic (a
    sitecustomize on their path); returns (processes, result paths)."""
    import os

    det = work / "tp_det"
    det.mkdir(exist_ok=True)
    (det / "sitecustomize.py").write_text(
        "import torch\ntorch.use_deterministic_algorithms(True, warn_only=True)\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(det), str(ROOT)]))
    for k in ("ATOMO_CHAOS", "ATOMO_SUPERVISED", "ATOMO_RUN_ATTEMPT", "WORLD_SIZE",
              "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    paths = [work / f"tp_gloo{r}.json" for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--topology-gloo-child", str(r),
         str(work), str(paths[r])], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    return [procs, paths]


def tp_row2(grads, errs: dict, card: str) -> tuple:
    """Row 2's flagged form over two outer rows of the ResNet-18 tree (4
    bits, encoded on the card), group 0 flagged out: against its plain twin
    bit for bit, one launch. Returns the result and a timing function (the
    device ms beside the bound: one row read, the float32 mean written)."""
    import torch

    from atomo_tpu_torch.codecs import QsgdCodec, encode_tree
    from atomo_tpu_torch.ops import qsgd_kernels as K
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets

    codec = QsgdCodec(bits=4)
    bufs = []
    for o in range(2):
        payloads, _ = encode_tree(codec, 300 + o, grads)
        buf, spec = pack_tree_buckets(payloads)
        bufs.append(buf)
    rows = torch.stack(bufs)
    pays = [tuple(p) for p in unpack_tree_buckets(rows, spec)]
    flags = torch.tensor([0.0, 1.0], device=rows.device)
    kw = dict(bits=4, n_replicas=2, replica_ok=flags)
    K.reset_launch_counts()
    got = K.unpack_dequantize_tree(pays, grads, **kw)
    launches = K.launch_counts()["unpack_dequantize"]
    plain = K.unpack_dequantize_tree_plain(pays, grads, **kw)
    twin = all(same_bits(a, b) for a, b in zip(got, plain))
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    errs["unpack_dequantize"] = max(errs["unpack_dequantize"], err)
    if not twin or launches != 1:
        raise AssertionError(f"topology row 2 flagged over 2 outer rows: twin {twin}, "
                             f"launches {launches}")
    n_values = sum(g.numel() for g in grads)
    res = {"twin_bit_equal": twin, "launches": launches,
           "bytes_a_replica": int(rows.shape[1])}
    # group 0 flagged out: one row's payload read, the flags, the mean written
    res["bound_ms"], res["bound_by"] = bound(res["bytes_a_replica"] + 8 + 4 * n_values,
                                             3 * n_values)

    def timing():
        res["device_ms"] = device_ms(lambda: K.unpack_dequantize_tree(pays, grads, **kw),
                                     "unpack_dequantize")
        res["ms"] = cuda_ms(lambda: K.unpack_dequantize_tree(pays, grads, **kw))
        res["plain_ms"] = cuda_ms(lambda: K.unpack_dequantize_tree_plain(pays, grads, **kw),
                                  reps=5)
        log(f"topology row 2 flagged outer decode ({card}): 2 outer rows of the ResNet-18 "
            f"tree ({res['bytes_a_replica']} bytes a row), group 0 flagged out: equals its "
            f"plain twin bit for bit, one launch; device ms {res['device_ms']:.4f}, bound "
            f"{res['bound_ms']:.4f} ({res['bound_by']}: one row read, "
            f"{4 * n_values / 1e6:.1f} MB written), events {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms")
        return res

    return res, timing


def tp_planner_pick(doc: dict) -> str:
    """The planner's own pick on the measured two-tier fabric of the run's
    probe, for ResNet-18 qsgd 4 bits (the pinned run's byte budget)."""
    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.obs.fabric import measured_two_tier
    from atomo_tpu_torch.topology.schedule import choose_plan
    from atomo_tpu_torch.tuning.probe import byte_budget

    fabric2 = measured_two_tier(doc, dcn_ways=2, n_dev=4)
    dense_b, payload_b = byte_budget(get_codec("qsgd", quantization_level=4),
                                     get_model("resnet18", 10, image_shape=(32, 32, 3)))
    plan, reason = choose_plan(dense_bytes=dense_b, payload_bytes=payload_b, fabric=fabric2)
    return f"{fabric2.describe()}; {reason}"


def phase_topology(work: Path, card: str, grads, errs: dict, p2p: dict) -> dict:
    """Two-tier hierarchical aggregation on the card (the module docstring's
    item 21): four gloo ranks run ``train`` over the ``(dp=2, ici=2)`` mesh
    while this process checks row 2's flagged form over two outer rows;
    the ranks' checks; then row 2's timing."""
    t0 = time.time()
    procs, paths = tp_spawn(work)
    row2, row2_timing = tp_row2(grads, errs, card)
    logs = [p.communicate(timeout=400)[0] for p in procs]
    t_children = time.time() - t0
    if [p.returncode for p in procs] != [0, 0, 0, 0]:
        raise AssertionError("topology gloo ranks failed:\n" + "\n".join(
            t[-3000:] for t in logs))
    ranks = [json.loads(p.read_text()) for p in paths]
    out = {"row2": row2, "runs": {}, "launches": {name: 0 for name in REPLACES}}
    msg = "7.2506"  # ResNet-18 qsgd 4 bits: one payload on the slow tier (MiB)
    for name, want in (("tp_qsgd", TP_STEPS), ("tp_guard", TP_STEPS),
                       ("tp_svd3", TP_SVD_STEPS)):
        r0 = ranks[0][name]
        if any(r[name]["rc"] != 0 for r in ranks) or len(r0["hashes"]) != want:
            raise AssertionError(f"topology {name}: {[r[name]['rc'] for r in ranks]}, "
                                 f"{len(r0['hashes'])} steps; {r0['lines'][-3:]}")
        if any(r[name]["hashes"] != r0["hashes"] for r in ranks):
            raise AssertionError(f"topology {name}: the replicas differ after a step")
        workers = [ln for ln in r0["lines"] if ln.startswith("Worker:")]
        losses = [float(re.search(r"Loss: ([0-9.naninf]+)", ln).group(1)) for ln in workers]
        step_ms = [1e3 * float(re.search(r"Time Cost: ([0-9.]+)", ln).group(1))
                   for ln in workers]
        out["runs"][name] = {"launches": r0["launches"], "seconds": r0["seconds"],
                             "losses": losses, "twins": r0["twins"], "step_ms": step_ms,
                             "msg_mb": [re.search(r"Msg\(MB\): +([0-9.]+)", ln).group(1)
                                        for ln in workers]}
        for k in REPLACES:
            out["launches"][k] += r0["launches"].get(k, 0)
        if name == "tp_svd3":
            continue
        run = out["runs"][name]
        if run["msg_mb"] != [msg] * want:
            raise AssertionError(f"topology {name}: Msg(MB) {run['msg_mb']}, want {msg}")
        la = r0["launches"]
        if la["quantize_pack"] != want or la["unpack_dequantize"] != want:
            raise AssertionError(f"topology {name}: launches {la}, want one row-1 and one "
                                 f"row-2 launch a step")
        tw = r0["twins"]
        if len(tw) != want or not all(t["bit_equal"] and t["n_replicas"] == 2 for t in tw):
            raise AssertionError(f"topology {name}: rank 0's outer decodes against the plain "
                                 f"twin: {tw}")
        errs["unpack_dequantize"] = max(errs["unpack_dequantize"],
                                        max(t["max_abs_err"] for t in tw))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"topology {name}: losses {losses}")
    lines = ranks[0]["tp_qsgd"]["lines"]
    probes = [ln for ln in lines if ln.startswith("Fabric probe: ")]
    auto = [ln for ln in lines if ln.startswith("--aggregate auto -> ")]
    doc = json.loads((work / "tp_qsgd" / "fabric_probe.json").read_text())
    tiers = [(t["label"], t["ways"]) for t in doc["tiers"]]
    if (tiers != [("ici", 2), ("dcn", 2)] or doc["meta"]["dcn_ways"] != 2
            or len(auto) != 1 or "hierarchical (inner 2x measured_ici" not in auto[0]
            or "plan psum+gather predicted" not in auto[0]
            or "Topology plan: psum+gather" not in lines):
        raise AssertionError(f"topology probe and advisory: {tiers}, {probes}, {auto}")
    guard = ranks[0]["tp_guard"]
    glines = [ln for ln in guard["lines"] if ln.startswith("Guard:")]
    flags = [t["flags"] for t in guard["twins"]]
    if glines != ["Guard: Step: 2, Dropped: 1, Action: rescale (anomalous contribution "
                  "masked from the aggregate)"] or flags != [[1.0, 1.0], [0.0, 1.0],
                                                             [1.0, 1.0]]:
        raise AssertionError(f"topology guard: {glines}, flags {flags}")
    pick = tp_planner_pick(doc)
    out.update(children_seconds=t_children, probe=doc, advisory=auto[0], planner_pick=pick)
    runs = out["runs"]
    log(f"topology gloo-4 probe: " + "; ".join(probes))
    log(f"topology gloo-4 advisory: {auto[0]}")
    log(f"topology planner's own pick on the measured fabric: {pick}")
    log(f"topology gloo-4 resnet18 qsgd psum+gather (deterministic, (dp=2, ici=2) on one "
        f"card): replicas bit-identical after each of {TP_STEPS} steps, Msg(MB) "
        f"{runs['tp_qsgd']['msg_mb']} (one payload on the slow tier), launches "
        f"{runs['tp_qsgd']['launches']}, rank 0's outer decode over 2 rows equal to its "
        f"plain twin bit for bit each step, losses {runs['tp_qsgd']['losses']}, "
        f"step ms {[round(v, 3) for v in runs['tp_qsgd']['step_ms']]} ({card}), "
        f"{runs['tp_qsgd']['seconds']:.1f} s")
    log(f"topology gloo-4 guard nan@2: {glines[0]}; row 2's flags a step {flags} (group 0 "
        f"masked at step 2, kept 1 of 2), flagged decode equal to its plain twin, launches "
        f"{runs['tp_guard']['launches']}, losses {runs['tp_guard']['losses']}, step ms "
        f"{[round(v, 3) for v in runs['tp_guard']['step_ms']]}")
    log(f"topology gloo-4 svd3 legacy plan: {TP_SVD_STEPS} steps, replicas bit-identical, "
        f"Msg(MB) {runs['tp_svd3']['msg_mb']}, losses {runs['tp_svd3']['losses']}, step ms "
        f"{[round(v, 3) for v in runs['tp_svd3']['step_ms']]}")
    log(f"topology ring plans (a cring inner or a ring outer): left out on the card; they "
        f"need gloo's send and receive of CUDA tensors between ranks, which the dist gloo-2 "
        f"probe saw exit {p2p['exit_codes']}, so they wait for two or more cards, like the "
        f"flat ring (psum+gather, the legacy plan, is the plan of all_reduce and all_gather "
        f"alone)")
    out["row2"] = row2_timing()
    log(f"topology phase seconds: children {t_children:.1f}, all {time.time() - t0:.1f}")
    return out


def main() -> int:
    if sys.argv[1:2] == ["--gloo-child"]:
        return gloo_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--gloo-p2p-probe"]:
        return gloo_p2p_probe(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--ckpt-child"]:
        return ckpt_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--sparse-gloo-child"]:
        return sparse_gloo_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--budget-child"]:
        return budget_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--budget-cli-child"]:
        return budget_cli_child(sys.argv[2])
    if sys.argv[1:2] == ["--superstep-child"]:
        return superstep_child(sys.argv[2])
    if sys.argv[1:2] == ["--superstep-cli-child"]:
        return superstep_cli_child(sys.argv[2])
    if sys.argv[1:2] == ["--overlap-child"]:
        return overlap_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--overlap-gloo-child"]:
        return overlap_gloo_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--resilience-child"]:
        return resilience_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--timeline-child"]:
        return timeline_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--partition-child"]:
        return partition_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--partition-gloo-child"]:
        return partition_gloo_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--partition-drill-child"]:
        return partition_drill_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--timeline-gloo-child"]:
        return timeline_gloo_child(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--quorum-gloo-child"]:
        return quorum_gloo_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--topology-gloo-child"]:
        return topology_gloo_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
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
        log(f"phase {name}: {seconds[name]:.1f} s")

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
        sparse = phase_sparse(Path(work), errs)
        lap("sparse")
        budget = phase_budget(Path(work), errs, card)
        lap("budget")
        superstep = phase_superstep(Path(work), card)
        lap("superstep")
        overlap = phase_overlap(Path(work), card, grads, errs)
        lap("overlap")
        layouts = phase_layouts(Path(work), card, runs, errs)
        lap("layouts")
        resilience = phase_resilience(Path(work), card, grads, errs)
        lap("resilience")
        obs = phase_obs(Path(work), card, grads, errs, superstep["obs_deterministic"])
        lap("obs")
        timeline = phase_timeline(Path(work), card, times, errs)
        lap("timeline")
        partition = phase_partition(Path(work), card)
        lap("partition")
        quorum = phase_quorum(Path(work), card, grads, errs, gloo["p2p_probe"])
        lap("quorum")
        topology = phase_topology(Path(work), card, grads, errs, gloo["p2p_probe"])
        lap("topology")
    lm_runs = {"nccl1": ckpt["lm"].pop("nccl1"), "bf16": lm_bf16}
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    prof.update({f"dist_nccl1_{k}": v for k, v in dist_prof.items()})

    launches = {name: sum(r["launches"][name] for r in runs.values())
                + sum(dist_runs[label]["launches"][name] for label, _, _ in DIST_RUNS)
                + ckpt["launches"][name]
                + sum(r["launches"][name] for r in ckpt["steps"].values())
                + sum(r["launches"][name] for r in zoo["runs"].values() if "launches" in r)
                + sparse["recipe"]["launches"][name]
                + sum(r["launches"][name] for r in sparse["big_table"]["runs"].values())
                + sum(r["launches"][name] for pair in budget["pairs"].values()
                      for r in pair.values() if isinstance(r, dict))
                + sum(r["launches"][name] for r in budget["ef"].values())
                + budget["cli"]["launches"][name]
                + superstep["launches"][name]
                + overlap["launches"][name]
                + layouts["launches"][name]
                + resilience["launches"][name]
                + obs["launches"][name]
                + timeline["launches"][name]
                + partition["launches"][name]
                + sum(r["launches"][name] for r in quorum["runs"].values())
                + topology["launches"][name]
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
    # row 2's survivor mode (the quorum step's survivor-exact mean), its own entry
    q2 = quorum["row2"]
    kernels.insert(2, {
        "name": "unpack_dequantize_survivor", "route": "cuda",
        "source": SOURCES["unpack_dequantize"], "replaces": REPLACES["unpack_dequantize"],
        "launches": sum(r["survivor_launches"] for r in quorum["runs"].values()),
        "max_abs_err": errs["unpack_dequantize_survivor"], "ms": q2["ms"],
        "device_ms": q2["device_ms"], "plain_ms": q2["plain_ms"], "bound_ms": q2["bound_ms"],
        "bound_by": q2["bound_by"], "library_ms": None})
    result = {"card": card, "runs": runs, "times": times, "profile": prof, "kernels": kernels,
              "gathered": gathered, "dist_nccl1": dist_runs, "dist_gloo2": gloo, "lm": lm_runs,
              "ckpt": ckpt, "zoo": zoo, "sparse": sparse, "budget": budget,
              "superstep": superstep, "overlap": overlap, "layouts": layouts,
              "resilience": resilience, "obs": obs, "timeline": timeline,
              "partition": partition, "quorum": quorum, "topology": topology,
              "phase_seconds": seconds,
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
