"""Command line of the port: ``python -m atomo_tpu_torch train|evaluate|lm|report ...``.

Counterpart of the ``train``, ``evaluate``, ``lm`` and ``report`` verbs of
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
each new file; it takes every flag of ``train``, as the JAX verb does.
``lm`` runs the six layouts of the JAX verb on one device or
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
gather or ring by wire bytes otherwise, and on ``train`` over a two-tier
mesh (``--dcn-ways K`` above 1, or a group that spans hosts) the
hierarchical schedule with the topology planner's plan. ``train
--aggregate hierarchical --dcn-ways K --plan P`` runs the two-tier
exchange over the ``(dp=K, ici=N/K)`` mesh's process groups
(:mod:`atomo_tpu_torch.topology`). ``train`` takes the JAX verb's resilience flags: ``--grad-guard``
and ``--max-grad-norm`` (skip, or mask and rescale, an anomalous gradient),
``--chaos`` (or ATOMO_CHAOS; the fleet kinds refused), ``--health-timeout``
(the heartbeat watchdog, exit 13), ``--on-diverge`` with ``--diverge-*``
and ``--max-rollbacks`` (the divergence doctor, exit 23 once its budget is
spent) and ``--max-restarts`` with ``--restart-backoff`` (the supervisor,
one process), their argv refusals checked before the supervisor re-executes
the command. ``--obs-record`` writes the flight recorder
(``train_dir/metrics.jsonl``, :mod:`atomo_tpu_torch.obs.recorder`), which
``lm`` writes whenever it has a ``--train-dir``; ``--obs-quality`` adds the
per-layer estimator-quality probes (:mod:`atomo_tpu_torch.obs.quality`), and
with ``--budget-alloc variance`` and a save cadence over several devices the
two arm the online re-allocation at checkpoint boundaries
(:mod:`atomo_tpu_torch.budget.retune`). ``--profile-dir`` traces three
steady-state steps of the data-parallel loop; ``--phase-metrics``
(deprecated, as in the JAX verb) times the gather step's four phases on the
host; ``--fabric measured`` probes the run's process group at startup and
prices ``--aggregate auto`` from it (:mod:`atomo_tpu_torch.obs.fabric`).
``report`` joins a run's artifacts into ``run_report.json`` with the JAX
verb's consistency checks, and ``report timeline`` turns a ``--profile-dir``
trace into per-step phase spans (:mod:`atomo_tpu_torch.obs.timeline`);
``--strict`` exits 3 on a failed check; ``--fleet`` is not ported yet. From
the process entry a refusal exits 2.
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
from atomo_tpu_torch.utils.tracing import PHASE_METRICS_HINT

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


def _resilience_flags(p: argparse.ArgumentParser) -> None:
    """``train``'s resilience flags, with the JAX verb's defaults
    (``atomo_tpu/cli.py:333-500``)."""
    p.add_argument("--health-timeout", type=float, default=0.0,
                   help="arm the step-heartbeat watchdog: interrupt the job "
                        "if no step completes within this many seconds "
                        "(0 = off); recovery = restart from last checkpoint")
    p.add_argument("--grad-guard", action="store_true", default=False,
                   help="anomaly-guarded stepping: screen each replica's "
                        "raw gradient for non-finite values, drop anomalous "
                        "contributions and re-scale the surviving average "
                        "by n/kept (valid because the codecs are unbiased); "
                        "a step with no survivors is skipped")
    p.add_argument("--max-grad-norm", type=float, default=0.0, metavar="L2",
                   help="with the guard: also drop contributions whose "
                        "global L2 norm exceeds this (0 = finiteness only). "
                        "A screen, not clipping — implies --grad-guard")
    p.add_argument("--chaos", type=str, default="", metavar="SPEC",
                   help="fault-injection spec for drills, e.g. "
                        "'nan@3,kill@6,truncate@4,spike@5:3,crashloop@2' "
                        "(see atomo_tpu_torch/utils/chaos.py); defaults "
                        "to the ATOMO_CHAOS env var")
    p.add_argument("--quorum", type=str, default="off", metavar="Q",
                   help="bounded-staleness quorum aggregation: each step "
                        "consumes whatever payloads have ARRIVED (a "
                        "straggler's payload rides a staleness ring, "
                        "bounded at --staleness steps stale, then dropped "
                        "+ counted) and waits only until Q of the N "
                        "replicas are present — the surviving mean is "
                        "the survivor-exact mean (one division by the "
                        "kept count). The per-step arrival schedule is "
                        "recorded to train-dir/arrival_schedule.jsonl "
                        "so --replay-arrivals replays the trajectory "
                        "bit-exact. Needs a compressing --code, "
                        "--aggregate gather|ring and a multi-device "
                        "group; conflicts with --overlap delayed, "
                        "--sparse-rows, --stream-encode, "
                        "--error-feedback, --zero1/--partition "
                        "sharded-update, --num-aggregate, --superstep > "
                        "1, --obs-quality. off (default) = blocking "
                        "aggregation")
    p.add_argument("--staleness", type=int, default=1, metavar="K",
                   help="with --quorum: the staleness bound — a payload "
                        "may be consumed at most K steps late; one that "
                        "would exceed K is DROPPED (one "
                        "staleness_exceeded incident each, never a "
                        "silent stale apply)")
    p.add_argument("--quorum-period-ms", type=float, default=100.0, metavar="MS",
                   help="with --quorum: the modelled step period used to "
                        "convert a chaos slow@S:R:SEC straggler's lag "
                        "into whole steps (lag = ceil(SEC/period))")
    p.add_argument("--replay-arrivals", type=str, default="", metavar="PATH",
                   help="with --quorum: replay a recorded "
                        "arrival_schedule.jsonl instead of deriving (and "
                        "waiting out) a live schedule — the trajectory "
                        "is bit-identical to the recorded run's; refuses "
                        "a schedule recorded under different "
                        "Q/K/N/period knobs")
    p.add_argument("--on-diverge", type=str, default="off",
                   choices=["off", "skip", "rewarm", "densify"],
                   help="arm the divergence doctor: a windowed robust "
                        "z-score over the per-step loss series (plus guard "
                        "skip-rate and grad-norm trend counters) detects "
                        "divergence the per-step screen cannot see; on "
                        "alarm the run rolls back to the newest HEALTHY "
                        "checkpoint, replays the data stream, and applies "
                        "this remedy: skip = replay unchanged (transient-"
                        "fault model), rewarm = LR re-warmup ramp over the "
                        "detector window, densify = temporary dense "
                        "(uncompressed) aggregation for the window — valid "
                        "because every codec is an unbiased estimator of "
                        "the same mean. off (default) = detector disarmed")
    p.add_argument("--diverge-window", type=int, default=16, metavar="W",
                   help="divergence-detector window: EMA span, healthy-"
                        "tag clearance, and remedy duration (steps)")
    p.add_argument("--diverge-zmax", type=float, default=6.0, metavar="Z",
                   help="robust z-score threshold for the loss series")
    p.add_argument("--diverge-patience", type=int, default=3, metavar="N",
                   help="consecutive above-threshold steps before the "
                        "alarm fires (one bad batch is noise; a sustained "
                        "excursion is divergence)")
    p.add_argument("--diverge-min-history", type=int, default=8, metavar="N",
                   help="warmup steps before z/skip/trend alarms arm")
    p.add_argument("--max-rollbacks", type=int, default=2, metavar="N",
                   help="in-process rollback budget; exhaustion exits with "
                        "the rollback-requested code (23) so a supervisor "
                        "can prune to the last healthy checkpoint and "
                        "restart")
    p.add_argument("--max-restarts", type=int, default=0, metavar="N",
                   help="supervise this run: re-exec the same command "
                        "under a crash-loop budget of N restarts with "
                        "jittered exponential backoff, resuming from the "
                        "last checkpoint; decisions land in "
                        "train_dir/incidents.jsonl (0 = unsupervised; one "
                        "process only)")
    p.add_argument("--restart-backoff", type=float, default=1.0, metavar="SEC",
                   help="supervisor backoff base seconds (decorrelated "
                        "jitter, capped at 30x)")


def _chaos_preflight(args: argparse.Namespace) -> None:
    """The chaos half of the JAX verb's argv preflight
    (``atomo_tpu/cli.py:1483-1560``): a bad spec, in the flag or in
    ATOMO_CHAOS, fails here with its reason, as do die@ and slow@ faults
    the run could not honour; the fleet lease faults are refused (the
    fleet layer is not ported)."""
    from atomo_tpu_torch.utils.chaos import ChaosConfig
    from atomo_tpu_torch.utils.tracing import MEMBERSHIP_EPOCH_ENV

    specs = [args.chaos] if args.chaos else []
    if not args.chaos and os.environ.get("ATOMO_CHAOS"):
        specs.append(os.environ["ATOMO_CHAOS"])
    for spec in specs:
        try:
            cfg = ChaosConfig.from_spec(spec)
        except ValueError as exc:
            raise SystemExit(str(exc))
        fleet = cfg.fleet_kinds()
        if fleet:
            raise SystemExit(
                f"chaos {'/'.join(fleet)}@ faults drill the fleet control plane, "
                "which is not ported (ROADMAP queue 1 item 11); train takes the "
                "step, host and checkpoint faults")
        epoch0 = int(os.environ.get(MEMBERSHIP_EPOCH_ENV, "0") or 0) == 0
        if cfg.die_faults and epoch0:
            if not (args.grad_guard or args.max_grad_norm > 0):
                raise SystemExit(
                    "chaos die@S:R models a replica that stops "
                    "contributing and is carried by the guard's "
                    "skip-and-rescale; arm --grad-guard (or "
                    "--max-grad-norm)")
            if args.n_devices == 1:
                raise SystemExit(
                    "chaos die@S:R targets one replica of a multi-device "
                    "mesh; single-device training has no surviving "
                    "replicas to continue on")
            bad = [r for _, r in cfg.die_faults if r >= args.n_devices >= 2]
            if bad:
                raise SystemExit(
                    f"chaos die@S:R targets replica(s) {sorted(bad)} "
                    f"outside the {args.n_devices}-device mesh "
                    "(replicas are 0-based); the fault would never "
                    "fire and the drill would prove nothing")
        if cfg.slow_replica_faults and epoch0:
            if args.n_devices == 1:
                raise SystemExit(
                    "chaos slow@S:R:SEC delays one replica of a "
                    "multi-device mesh; single-device training has no "
                    "exchange for a straggler to hold up")
            bad = [r for _, r, _ in cfg.slow_replica_faults if r >= args.n_devices >= 2]
            if bad:
                raise SystemExit(
                    f"chaos slow@S:R:SEC targets replica(s) "
                    f"{sorted(bad)} outside the "
                    f"{args.n_devices}-device mesh (replicas are "
                    "0-based); the fault would never fire and the "
                    "drill would prove nothing")


def _quorum_q(args: argparse.Namespace) -> Optional[int]:
    """``--quorum``: None for 'off', else the validated Q floor
    (``atomo_tpu/cli.py:867-890``)."""
    q = args.quorum
    if q in ("off", ""):
        return None
    try:
        v = int(q)
    except (TypeError, ValueError):
        raise SystemExit(
            f"--quorum {q!r}: expected 'off' or a positive integer "
            "(the number of replicas a step waits for)")
    if v < 1:
        raise SystemExit(
            f"--quorum {v}: must be >= 1 (a step has to consume at "
            "least one arrival)")
    return v


def _quorum_preflight(args: argparse.Namespace) -> None:
    """The quorum half of the JAX verb's argv preflight
    (``atomo_tpu/cli.py:1356-1482``) for the flags the port has."""
    if _quorum_q(args) is None:
        if args.replay_arrivals:
            raise SystemExit(
                "--replay-arrivals replays a recorded quorum arrival "
                "schedule and needs --quorum")
        return
    if args.staleness < 1:
        raise SystemExit(
            f"--staleness {args.staleness}: must be >= 1 (0 would "
            "mean blocking aggregation — drop --quorum instead)")
    if args.quorum_period_ms <= 0:
        raise SystemExit(
            f"--quorum-period-ms {args.quorum_period_ms}: must be "
            "> 0 (it converts a straggler's seconds of lag into "
            "whole steps)")
    if args.code.lower() in DENSE_CODES:
        raise SystemExit(
            "--quorum rides the encoded payload exchange (the "
            "staleness ring carries payloads, not dense gradients); "
            "pick a compressing --code")
    if args.n_devices == 1:
        raise SystemExit(
            "--quorum needs a multi-device mesh: a single device "
            "has no stragglers to absorb")
    if args.aggregate in ("psum", "hierarchical"):
        raise SystemExit(
            f"--quorum does not compose with --aggregate "
            f"{args.aggregate}: only the flat payload gather/ring "
            "exchanges carry the staleness ring; psum ships dense "
            "gradients and the hierarchical boundary re-encode is "
            "not arrival-aware")
    if args.plan != "auto":
        raise SystemExit(
            "--quorum does not compose with --plan: the two-level "
            "topology schedules are not arrival-aware; drop one")
    if args.overlap == "delayed":
        raise SystemExit(
            "--quorum does not compose with --overlap delayed: "
            "both modes carry cross-step payload state, and "
            "composing the delayed carry with the staleness ring "
            "would double-count a step of lag — the quorum carry "
            "IS the bounded generalization of the delayed one")
    if args.stream_encode == "on":
        raise SystemExit(
            "--quorum does not compose with --stream-encode: the "
            "bucket-streamed encode is not staleness-ring-aware yet")
    if args.sparse_rows != "off":
        raise SystemExit(
            "--quorum does not compose with --sparse-rows: the "
            "row payloads' shapes are assignment-specific and the "
            "staleness ring is not row-aware yet")
    if args.error_feedback:
        raise SystemExit(
            "--quorum does not compose with --error-feedback: a "
            "dropped stale payload's residual would be "
            "mis-attributed — rejected honestly")
    if _partition(args) != "replicated":
        raise SystemExit(
            "--quorum does not compose with --zero1 / --partition "
            "sharded-update yet: the staleness-ring carry is "
            "untested against the sharded state templates")
    if args.num_aggregate is not None:
        raise SystemExit(
            "--quorum does not compose with --num-aggregate: the "
            "arrival schedule already decides which replicas "
            "contribute each step")
    if args.superstep > 1:
        raise SystemExit(
            f"--superstep {args.superstep} does not compose with "
            "--quorum: the host feeds a fresh arrival vector every "
            "step, which a fused K-step scan cannot consume")
    if args.phase_metrics:
        raise SystemExit(
            "--quorum needs the fused step (the staleness ring "
            "rides its carry); --phase-metrics has no fused step"
            + PHASE_METRICS_HINT)
    if args.obs_quality:
        raise SystemExit(
            "--quorum does not compose with --obs-quality: a stale "
            "payload's per-layer error column would describe an "
            "earlier step's gradient — rejected honestly rather "
            "than silently mis-attributed")
    if args.on_diverge != "off":
        raise SystemExit(
            "--quorum does not compose with --on-diverge: the "
            "rollback reload does not rebuild the staleness-ring "
            "template yet")
    if args.replay_arrivals and not os.path.exists(args.replay_arrivals):
        raise SystemExit(f"--replay-arrivals {args.replay_arrivals!r}: no such file")


def _quorum_config(args: argparse.Namespace, n_dev: int):
    """The resolved-world half of the quorum checks (``:2446-2458``), then
    the :class:`~atomo_tpu_torch.quorum.QuorumConfig` the loop takes
    (``:2776-2786``), or None without ``--quorum``."""
    q = _quorum_q(args)
    if q is None:
        return None
    if n_dev <= 1:
        raise SystemExit(
            "--quorum waits for Q of N replica payloads: this run "
            "resolved to 1 device, so there is no exchange to quorum on")
    if q > n_dev:
        raise SystemExit(
            f"--quorum {q} exceeds the resolved "
            f"{n_dev}-replica mesh: a quorum larger than the world "
            "can never be met")
    from atomo_tpu_torch.quorum import QuorumConfig

    return QuorumConfig(q, staleness=args.staleness, period_s=args.quorum_period_ms / 1e3)


def _diverge_preflight(args: argparse.Namespace) -> None:
    """The doctor's half of the argv preflight (``:1620-1665``): the
    detector's knobs and the conflict matrix, as far as argv knows."""
    if args.on_diverge == "off":
        return
    from atomo_tpu_torch.training.resilience import DetectorConfig, diverge_conflict

    try:
        DetectorConfig(window=args.diverge_window, zmax=args.diverge_zmax,
                       patience=args.diverge_patience, min_history=args.diverge_min_history)
    except ValueError as exc:
        raise SystemExit(str(exc))
    multi = args.n_devices >= 2
    reason = diverge_conflict(
        args.on_diverge, train_dir=args.train_dir,
        codec=None if args.code.lower() in DENSE_CODES else args.code,
        aggregate=args.aggregate if multi else None, overlap=args.overlap,
        zero1=_partition(args) == "zero1" and multi, phase_metrics=args.phase_metrics,
        num_aggregate=args.num_aggregate if multi else None, keep_ckpts=args.keep_ckpts,
        save_freq=args.save_freq or args.eval_freq, window=args.diverge_window)
    if reason:
        raise SystemExit(reason)
    if args.error_feedback:
        raise SystemExit(
            "--error-feedback does not compose with --on-diverge: "
            "the rollback reload does not rebuild the residual "
            "template yet — drop one")


def _resolved_chaos(chaos, n_dev: int) -> None:
    """The resolved-world half of the die@ and slow@ range checks
    (``:2395-2445``): --n-devices 0 needs the group's size."""
    if chaos is None or chaos.membership_epoch:
        return
    cfg = chaos.config
    if cfg.die_faults:
        bad = [r for _, r in cfg.die_faults if r >= n_dev]
        if bad or n_dev <= 1:
            raise SystemExit(
                f"chaos die@S:R targets replica(s) "
                f"{sorted(r for _, r in cfg.die_faults)} but this "
                f"run resolved to a {n_dev}-device mesh (replicas are "
                "0-based); the fault would never fire")
    if cfg.slow_replica_faults:
        bad = [r for _, r, _ in cfg.slow_replica_faults if r >= n_dev]
        if bad or n_dev <= 1:
            raise SystemExit(
                f"chaos slow@S:R:SEC targets replica(s) "
                f"{sorted(r for _, r, _ in cfg.slow_replica_faults)} "
                f"but this run resolved to a {n_dev}-device mesh (replicas "
                "are 0-based); the fault would never fire")


def _diverge_config(args: argparse.Namespace, codec, n_dev: int, aggregate):
    """``--on-diverge``'s :class:`DivergeConfig` after the conflict check
    with the resolved world (``:2697-2730``), or None."""
    if args.on_diverge == "off":
        return None
    from atomo_tpu_torch.training.resilience import (
        DetectorConfig,
        DivergeConfig,
        diverge_conflict,
    )

    reason = diverge_conflict(
        args.on_diverge, train_dir=args.train_dir, codec=codec,
        aggregate=aggregate if n_dev > 1 else None, overlap=args.overlap,
        zero1=_partition(args) == "zero1" and n_dev > 1, phase_metrics=args.phase_metrics,
        num_aggregate=args.num_aggregate if n_dev > 1 else None, keep_ckpts=args.keep_ckpts,
        save_freq=args.save_freq or args.eval_freq, window=args.diverge_window)
    if reason:
        raise SystemExit(reason)
    return DivergeConfig(
        remedy=args.on_diverge,
        detector=DetectorConfig(window=args.diverge_window, zmax=args.diverge_zmax,
                                patience=args.diverge_patience,
                                min_history=args.diverge_min_history),
        max_rollbacks=args.max_rollbacks)


def _supervise(args: argparse.Namespace, log_fn) -> Optional[int]:
    """``--max-restarts``: re-exec this command as a supervised child
    (``atomo_tpu/cli.py:2307-2340``) and return its triaged exit code, or
    None when this process is the child (or unsupervised)."""
    from atomo_tpu_torch.training.resilience import SUPERVISED_ENV, run_supervised

    if args.max_restarts <= 0 or os.environ.get(SUPERVISED_ENV) == "1":
        return None
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise SystemExit(
            "--max-restarts supervises one process: a restarted rank would re-join "
            "a process group whose store already holds its keys, so the port "
            "refuses it above one rank (restart the whole torchrun job instead)")
    argv = getattr(args, "_argv", None)
    if argv is None:
        warnings.warn(
            "--max-restarts needs the CLI entrypoint's argv to re-exec "
            "itself; running unsupervised (call atomo_tpu_torch.cli.main)")
        return None
    if not args.train_dir:
        warnings.warn(
            "--max-restarts with --train-dir '': checkpointing is "
            "off, so every restart retrains from step 0 and no "
            "incidents.jsonl is written")
    return run_supervised(
        [sys.executable, "-m", "atomo_tpu_torch"] + list(argv),
        max_restarts=args.max_restarts, backoff_base=args.restart_backoff,
        backoff_max=args.restart_backoff * 30, train_dir=args.train_dir,
        resume_flag="--resume" if args.train_dir else None, log_fn=log_fn)


def _diverged_exit(exc: Exception) -> int:
    """A spent rollback budget as the rollback-requested exit code."""
    from atomo_tpu_torch.training.resilience import ROLLBACK_EXIT_CODE

    print(
        f"Divergence doctor gave up: {exc}; diverged checkpoint tail "
        f"pruned to the last healthy step, exiting rc={ROLLBACK_EXIT_CODE} "
        "(rollback-requested — a supervisor restarts from there, and an "
        "unsupervised --resume lands there too)",
        flush=True,
    )
    return ROLLBACK_EXIT_CODE


def _fabric_flags(p: argparse.ArgumentParser) -> None:
    """``--fabric`` and ``--codec-tax-ms``, what ``--aggregate auto``
    prices from."""
    p.add_argument("--fabric", type=str, default="auto", metavar="F",
                   help="the fabric --aggregate auto prices the wire on: auto "
                        "(nvlink on one host, dcn across hosts) | nvlink | ici (the JAX "
                        "package's name, = nvlink) | dcn | eth10g | a per-device GB/s "
                        "number | measured (train: a startup probe times fenced ring-hop "
                        "and all_gather ladders on the run's own process group, records "
                        "train_dir/fabric_probe.json, and --aggregate auto prices from it; "
                        "PRICING ONLY: measured trains bit-identical to the same run under "
                        "its measured GB/s pinned)")
    p.add_argument("--codec-tax-ms", type=float, default=None, metavar="MS",
                   help="measured single-device codec tax for --aggregate auto's "
                        "advisory; default scales the ResNet-18 anchor measured on the "
                        "H100 (utils/comm_model.py) by gradient size")


def _fit_flags(p: argparse.ArgumentParser) -> None:
    """The flags of ``train``, which ``evaluate`` takes too (the JAX verbs'
    ``_add_fit_args``): a flag line shared by both verbs parses on both, and
    ``evaluate`` reads what it needs and ignores the rest."""
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
    p.add_argument("--zero1", action="store_true", default=False,
                   help="ZeRO-1 optimizer-state sharding: each rank holds 1/n of the "
                        "flat momentum/Adam buffers, updates its slice, and one "
                        "all_gather reassembles the replicated params (multi-device "
                        "only). Alias for --partition zero1")
    p.add_argument("--partition", type=str, default="replicated",
                   choices=["replicated", "zero1", "sharded-update"],
                   help="weight-update partitioning: 'replicated' keeps params+optimizer "
                        "state on every rank; 'zero1' shards the optimizer state only; "
                        "'sharded-update' (Xu et al. 2004.13336) shards master weights AND "
                        "optimizer state AND the update over the ranks — per-rank "
                        "persistent state drops to 1/n, the dense model exists only "
                        "transiently inside the step, trajectories stay bit-identical to "
                        "replicated per codec, and — unlike zero1 — checkpoints carry the "
                        "--overlap delayed in-flight payload, so supervised restarts "
                        "resume bit-exact")
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
                   choices=["auto", "gather", "ring", "psum", "hierarchical"],
                   help="gradient exchange: gather = payload all_gather (compressed "
                        "wire), ring = its streamed form (payloads rotate, each hop's "
                        "decode overlaps the next transfer), psum = dense all-reduce, "
                        "hierarchical = the two-tier schedule: a dense mean over the "
                        "fast fabric (NVLink inside a host) then the payload all_gather "
                        "over the slow one (the NICs between hosts), see --dcn-ways and "
                        "--plan; auto = the comm-cost model's pick for this byte budget, "
                        "device count and --fabric, printed with its reason (psum for "
                        "a dense code; hierarchical, with the planner's plan, on a "
                        "--dcn-ways mesh or a group that spans hosts)")
    _fabric_flags(p)
    p.add_argument("--dcn-ways", type=int, default=0, metavar="K",
                   help="hierarchical aggregation: number of SLOW-fabric (outer) groups; "
                        "the n-devices group becomes the mesh (dp=K) x (ici=n/K), rank r "
                        "in outer group r // (n/K). 0 = one group per host (WORLD_SIZE "
                        "over LOCAL_WORLD_SIZE), 2 on one host. With --dcn-ways > 1, "
                        "--aggregate auto plans over the two-tier fabric")
    p.add_argument("--plan", type=str, default="auto",
                   help="two-level schedule for hierarchical aggregation "
                        "(topology.schedule): auto = the cost-driven planner when "
                        "--aggregate auto resolved hierarchical, the legacy plan when "
                        "you pinned --aggregate hierarchical yourself; legacy = dense "
                        "mean over the fast tier + one payload gather over the slow "
                        "one; or an explicit inner+outer pair from {psum,cring}+{gather,"
                        "ring,psum}, e.g. cring+ring: inner dense mean or compressed "
                        "ring, the boundary re-encode, outer re-encoded gather/ring or "
                        "the SparCML dense fallback")
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
    p.add_argument("--obs-record", action="store_true", default=False,
                   help="arm the flight recorder: one JSON line per "
                        "training step appended to train-dir/"
                        "metrics.jsonl (loss, step wall ms, guard "
                        "verdicts, wire bytes, the aggregate mode in "
                        "effect, membership epoch, chaos generation, "
                        "drift state, rolling predicted-vs-measured "
                        "calibration), pruned in lockstep with the "
                        "checkpoint timeline on rollback/resume. Off "
                        "(default): zero new device ops, byte-identical "
                        "programs and stdout. Read it back with the "
                        "`report` verb")
    p.add_argument("--obs-quality", action="store_true", default=False,
                   help="in-graph estimator-quality probes: per-layer "
                        "||decode(encode(g))-g||^2 and relative variance "
                        "proxy inside the fused step (the ATOMO "
                        "estimator's variance, observable at last — the "
                        "feed for adaptive variance budgets). Needs a "
                        "compressing --code with flat gather/ring/psum "
                        "aggregation; off = byte-identical programs, on "
                        "= bit-identical trajectories (the probe only "
                        "adds metric outputs). Costs one extra decode + "
                        "one f32 reduction per layer per step")
    p.add_argument("--phase-metrics", action="store_true", default=False,
                   help="split the step into separately-jitted phases and "
                        "log real Comp/Encode/Comm (+ master Gather/Decode) "
                        "seconds — the reference's per-phase observability; "
                        "costs fusion, so default off")
    p.add_argument("--profile-dir", type=str, default="",
                   help="capture a torch.profiler device trace of a few "
                        "steady-state steps into this dir (Chrome-trace / "
                        "TensorBoard loadable) — phase cost inside the fused "
                        "step; read it with `report timeline`")
    p.add_argument("--comm-type", type=str, default="Bcast", metavar="N",
                   help="accepted for parity with the reference and ignored")
    p.add_argument("--enable-gpu", action="store_true", default=False,
                   help="accepted for parity with the reference and ignored")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="accepted for parity with the reference and ignored (--device "
                        "picks the device)")
    _svd_flags(p, "0 = rank 3 for the fixed-budget samplers (the reference's "
                  "rank-0 mode only with --sample bernoulli)")
    _resilience_flags(p)
    p.add_argument("--svd-mode", type=str, default="auto",
                   choices=["auto", "exact", "randomized"],
                   help="alias over --svd-algo (the two must agree when both are "
                        "pinned): randomized = the Halko sketch at every size, exact = "
                        "the exact SVD, auto = --svd-algo's choice")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="atomo_tpu_torch",
        description="PyTorch/CUDA port of atomo_tpu (compressed data-parallel SGD)",
    )
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("train", help="train a model on one device or data-parallel")
    _fit_flags(p)
    p.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate", help="poll a checkpoint directory and evaluate")
    _fit_flags(e)
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

    r = sub.add_parser(
        "report",
        help="join metrics.jsonl + incidents.jsonl + membership.json + "
             "tune_decision.json + fabric_probe.json into run_report.json "
             "and print the post-mortem timeline (cross-artifact "
             "consistency checks); `report timeline` parses a "
             "--profile-dir trace into per-step phase spans instead",
    )
    r.add_argument("what", nargs="?", default="run", choices=["run", "timeline"],
                   help="run (default): the cross-artifact run "
                        "report; timeline: per-step encode/exchange/"
                        "decode/compute spans from a --profile-dir "
                        "trace, joined against metrics.jsonl — the "
                        "replacement for the deprecated "
                        "--phase-metrics mode")
    r.add_argument("--train-dir", type=str, default="output/models/", metavar="N",
                   help="the run's artifact directory")
    r.add_argument("--profile-dir", type=str, default="", metavar="DIR",
                   help="for `report timeline`: the torch.profiler "
                        "trace directory a training run captured "
                        "with --profile-dir (default: "
                        "train-dir/trace)")
    r.add_argument("--fleet", action="store_true", default=False,
                   help="the fleet report over train-dir/hosts/ (refused: not ported yet)")
    r.add_argument("--strict", action="store_true", default=False,
                   help="exit rc=3 when a consistency check fails "
                        "(default: report and exit 0 — the report "
                        "itself is the product)")
    r.set_defaults(fn=cmd_report)
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


def _partition(args: argparse.Namespace) -> str:
    """The weight-update partition, one of replicated | zero1 |
    sharded_update (``atomo_tpu/cli.py:849-864``): ``--zero1`` is the alias
    of ``--partition zero1`` and conflicts with the sharded update."""
    p = getattr(args, "partition", "replicated").replace("-", "_")
    if getattr(args, "zero1", False):
        if p == "sharded_update":
            raise SystemExit(
                "--zero1 conflicts with --partition sharded-update: "
                "ZeRO-1 is the sharded update's shard-state-only "
                "degenerate point — pass one of the two")
        p = "zero1"
    return p


def _partition_preflight(args: argparse.Namespace) -> None:
    """The sharded update's argv refusals (``atomo_tpu/cli.py:898-930``)
    for the flags the port has (``--elastic`` is not ported)."""
    if _partition(args) != "sharded_update":  # raises on the --zero1 conflict
        return
    if args.phase_metrics:
        raise SystemExit(
            "--partition sharded-update is not supported with "
            "--phase-metrics (the phased update program assumes a "
            "replicated optimizer state)")
    if args.on_diverge != "off":
        raise SystemExit(
            "--on-diverge rollback rebuilds replicated templates "
            "and cannot re-thread the sharded master layout yet; "
            "drop --partition sharded-update or --on-diverge")
    if args.sparse_rows != "off":
        raise SystemExit(
            "--partition sharded-update does not compose with "
            "--sparse-rows yet (the row exchange is untested "
            "against the flat master layout)")


def _plan_preflight(args: argparse.Namespace) -> None:
    """The JAX verb's argv checks of ``--plan`` (``atomo_tpu/cli.py:
    993-1013``): the plan-name grammar, and a plan pinned beside a flat
    ``--aggregate``."""
    if args.plan not in ("auto", "legacy"):
        from atomo_tpu_torch.topology.schedule import plan_from_name

        try:
            plan_from_name(args.plan)
        except ValueError as exc:
            raise SystemExit(str(exc))
    if args.plan != "auto" and args.aggregate not in ("auto", "hierarchical"):
        raise SystemExit(
            f"--plan {args.plan} selects a two-level hierarchical "
            f"schedule and cannot compose with --aggregate "
            f"{args.aggregate}; use --aggregate hierarchical (or auto on "
            "a --dcn-ways mesh)")


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
        if args.aggregate in ("psum", "hierarchical"):
            raise SystemExit(
                f"--overlap delayed does not compose with --aggregate "
                f"{args.aggregate} (only the compressed flat gather/ring "
                "exchanges have a delayed form; no two-level topology "
                "plan — legacy or re-encoded — does)")
        if args.plan != "auto":
            raise SystemExit(
                f"--overlap delayed does not compose with --plan "
                f"{args.plan}: no two-level topology plan — legacy or "
                "re-encoded — has a delayed form; drop one")
        if args.phase_metrics:
            raise SystemExit(
                "--phase-metrics times blocking phase programs and cannot "
                "describe the overlapped step; drop one of the flags"
                + PHASE_METRICS_HINT)
        if _partition(args) == "zero1" and args.max_restarts > 0 and args.train_dir:
            raise SystemExit(
                "--max-restarts with --zero1 --overlap delayed cannot work: "
                "supervised restarts resume from checkpoints, and a "
                "--zero1 run cannot resume the delayed in-flight payload "
                "(the legacy sharded optimizer template cannot carry it) "
                "— every restart would fail instantly and burn the "
                "budget; drop one of the three, or switch to --partition "
                "sharded-update, whose checkpoints hold the payload as a "
                "sharded carry leaf and resume bit-exact")
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
        if args.aggregate in ("psum", "hierarchical"):
            raise SystemExit(
                f"--stream-encode does not compose with --aggregate "
                f"{args.aggregate}: psum ships dense gradients (no encode "
                "to stream), and the hierarchical boundary re-encode is "
                "not bucket-aware yet — the honest reject until it is; "
                "use --aggregate gather or ring")
        if args.plan != "auto":
            raise SystemExit(
                f"--stream-encode does not compose with --plan "
                f"{args.plan}: the two-level topology schedules re-encode "
                "at the fabric boundary, which is not bucket-aware yet; "
                "drop one")
        if args.phase_metrics:
            raise SystemExit(
                "--phase-metrics times a monolithic encode phase program "
                "and cannot describe the bucket-streamed schedule; drop "
                "one of the flags"
                + PHASE_METRICS_HINT)


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
    if args.aggregate == "hierarchical" or args.plan != "auto":
        raise SystemExit(
            "--sparse-rows does not compose with hierarchical "
            "aggregation (--aggregate hierarchical / --plan): the "
            "boundary re-encode composes a second estimator per "
            "layer and is not row-aware yet — rejected honestly")
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
    if args.phase_metrics:
        raise SystemExit(
            "--sparse-rows is not supported with --phase-metrics "
            "(the phased programs assume one whole-tree codec "
            "exchange; there is no row-aware phase split)"
            + PHASE_METRICS_HINT)


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
        if args.aggregate == "hierarchical" or args.plan != "auto":
            raise SystemExit(
                "--budget-alloc variance needs flat gather/ring/psum "
                "aggregation: the hierarchical boundary re-encode is not "
                "allocation-aware yet")
        if args.sparse_rows != "off":
            raise SystemExit(
                "--budget-alloc variance with --sparse-rows is a JOINT "
                "decision: the hybrid planner must re-price its dense "
                "sub-list under the allocated per-leaf codec, and the "
                "two single deciders each assume the other's knob is at "
                "its default. --auto controller prices and probes "
                "exactly that cross term (the +sp+ab candidates) — use "
                "it; the static pairing stays rejected")
        if args.phase_metrics:
            raise SystemExit(
                "--budget-alloc variance shapes the fused step's per-leaf "
                "payloads; --phase-metrics has no fused step"
                + PHASE_METRICS_HINT)
        if args.on_diverge != "off" and args.obs_quality and args.obs_record:
            raise SystemExit(
                "--budget-alloc variance with --obs-quality --obs-record "
                "arms online re-allocation at checkpoint boundaries, "
                "which cannot compose with --on-diverge: a rollback "
                "would replay pre-reallocation steps under the "
                "post-reallocation program — drop --on-diverge, or "
                "freeze the allocation by dropping --obs-record or "
                "--obs-quality")
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
    if args.aggregate == "hierarchical" or args.plan != "auto":
        raise SystemExit(
            "--error-feedback needs flat gather/ring/psum "
            "aggregation: the hierarchical boundary re-encode's "
            "unbiased-by-composition argument does not survive the "
            "EF bias")
    if args.sparse_rows != "off":
        raise SystemExit(
            "--error-feedback does not compose with --sparse-rows "
            "(the mixed per-leaf residual carry is untested)")
    if args.num_aggregate is not None:
        raise SystemExit(
            "--error-feedback does not compose with --num-aggregate: "
            "an unconsumed encode's residual would be mis-attributed")
    if _partition(args) != "replicated":
        raise SystemExit(
            "--error-feedback does not compose with --zero1 / "
            "--partition sharded-update yet: the residual carry is "
            "untested against the sharded state templates")
    if args.phase_metrics:
        raise SystemExit(
            "--error-feedback needs the fused step (the residual "
            "rides its carry); --phase-metrics has no fused step"
            + PHASE_METRICS_HINT)
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
    """``--budget-alloc variance``: (spectra, allocation, artifact document)
    as the JAX verb makes and prints them (``:2565-2645``). The probe
    gradient is taken over a direct slice of the training arrays, so the
    batch stream does not advance; ``--resume`` reuses the last epoch of a
    recorded ``budget_alloc.json`` that fits, else solves again. ``write``
    (rank 0) writes the artifact."""
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
    alloc = doc = None
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
            doc = prior
            log_fn(f"Budget: {why} (budget_alloc.json)")
        elif prior is not None:
            log_fn(f"Budget: NOT reusing budget_alloc.json: {why}")
    if alloc is None:
        alloc = solve_allocation(codec, spectra, budget_bytes=budget_b, mode="variance")
        doc = new_alloc_doc(codec, spectra, alloc)
        if args.train_dir:
            if write:
                write_alloc(args.train_dir, doc)
            log_fn(f"Budget: allocation artifact -> {alloc_path(args.train_dir)}")
    log_fn(alloc.describe())
    for l in spectra:
        log_fn(f"  [{l.index}] {l.name}: k={alloc.ks[l.index]}"
               + ("" if l.adaptive else " (dense at any rank — fixed)"))
    return spectra, alloc, doc


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
    (<reason>)``. On a two-tier mesh (``--dcn-ways`` above 1, or a group
    that spans hosts) with a codec it is ``hierarchical``: the advisory
    quotes each tier (:class:`~atomo_tpu_torch.topology.fabric.
    TwoTierFabric`) and runs the topology planner, whose plan rides on
    ``args._auto_plan``; a plan pinned by ``--plan`` is priced instead, and
    no plan is stashed."""
    from atomo_tpu_torch.tuning.probe import byte_budget
    from atomo_tpu_torch.utils.comm_model import choose_aggregate, resolve_fabric

    n_hosts = hosts_in_group()
    dcn_ways = getattr(args, "dcn_ways", 0)
    cross_host = (n_hosts > 1 or dcn_ways > 1) and allow_hierarchical
    dense_b, payload_b = byte_budget(codec, model) if codec is not None else (0, 0)
    if cross_host and codec is not None:
        from atomo_tpu_torch.topology.fabric import resolve_two_tier
        from atomo_tpu_torch.topology.schedule import choose_plan, plan_from_name

        k = _outer_ways(args, n_hosts)
        try:
            fabric2 = resolve_two_tier(args.fabric, dcn_ways=k, n_dev=n_dev, n_proc=n_hosts,
                                       measured=getattr(args, "_fabric_probe", None))
        except ValueError as exc:
            raise SystemExit(str(exc)) from None
        # a pinned --plan wins the precedence chain, so the advisory prices
        # THAT plan (the plan space narrowed to it) and selects nothing
        pinned = getattr(args, "plan", "auto")
        pinned_names = None
        suffix = ""
        if pinned != "auto":
            pinned_names = (plan_from_name(pinned).name,)
            suffix = " — pinned by --plan, planner selection skipped"
        plan, plan_reason = choose_plan(
            dense_bytes=dense_b, payload_bytes=payload_b, fabric=fabric2,
            tax_s=None if args.codec_tax_ms is None else args.codec_tax_ms / 1e3,
            plan_names=pinned_names)
        if pinned == "auto":
            args._auto_plan = plan.name
        log(f"--aggregate auto -> hierarchical ({fabric2.describe()}; {plan_reason}{suffix})")
        return "hierarchical"
    try:
        bw = resolve_fabric(args.fabric, n_proc=n_hosts,
                            measured=getattr(args, "_fabric_probe", None))
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
        bw = resolve_fabric(args.fabric, n_proc=hosts_in_group(),
                            measured=getattr(args, "_fabric_probe", None))
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
    if n_dev <= 1:
        if args.plan != "auto":
            warnings.warn(PLAN_ONE_DEVICE)
        return "gather" if args.aggregate in ("auto", "hierarchical") else args.aggregate
    if args.aggregate != "auto":
        return args.aggregate
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
    if args.obs_quality and aggregate == "hierarchical":
        raise SystemExit(
            "--obs-quality: --aggregate auto resolved to "
            "hierarchical for this deployment (the boundary "
            "re-encode is not probe-aware); pass --aggregate "
            "gather or ring explicitly to keep the quality "
            "probes, or drop --obs-quality")
    if args.plan != "auto" and aggregate != "hierarchical":
        # a pinned plan is never dropped in silence: auto goes hierarchical
        # only on a two-tier deployment with a codec
        raise SystemExit(
            f"--plan {args.plan}: --aggregate auto resolved to "
            f"{aggregate!r} for this deployment (a planned "
            "two-level schedule needs a compressing --code and a "
            "--dcn-ways/multi-host mesh); pass --aggregate "
            "hierarchical explicitly to force it, or drop --plan")
    return aggregate


PLAN_ONE_DEVICE = (
    "--plan selects a two-level schedule over a multi-device "
    "mesh; single-device training has no tiers to schedule — "
    "ignoring it")


def _outer_ways(args: argparse.Namespace, n_hosts: int) -> int:
    """K, the outer (slow-fabric) group count of a two-tier run: ``--dcn-ways``,
    else one group a host, at least 2 (``atomo_tpu/cli.py:3004``)."""
    return args.dcn_ways or max(n_hosts, 2)


def _two_tier_spec(n_dev: int, k: int):
    """``MeshSpec.from_world``'s ``(dp=K, ici=N/K)`` split of ``n_dev``
    devices, or None where K is not one (K does not divide N, or K <= 1,
    which it takes as flat)."""
    from atomo_tpu_torch.mesh.spec import MeshSpec

    try:
        spec = MeshSpec.from_world(n_dev, k)
    except ValueError:
        return None
    return spec if spec.is_two_tier else None


def _two_tier_mesh(args: argparse.Namespace, n_dev: int, k: int):
    """The ``(dp=K, ici=N/K)`` mesh over the group, built once a run and kept
    on ``args`` for the fabric probe and the step alike (making its groups
    is collective: every rank builds every line, in ``MeshSpec.build``'s
    order). A K that does not divide N exits with the JAX verb's text."""
    mesh = getattr(args, "_two_tier_mesh", None)
    if mesh is None or mesh.size("dp") != k:
        spec = _two_tier_spec(n_dev, k)
        if spec is None:
            raise SystemExit(
                f"--dcn-ways {k} must divide --n-devices {n_dev} "
                "(outer slow-fabric groups x inner fast-fabric chips)")
        mesh = args._two_tier_mesh = spec.build()
    return mesh


def _two_tier(args: argparse.Namespace, codec, n_dev: int, log):
    """The train verb's hierarchical block (``atomo_tpu/cli.py:3000-3031``):
    the two-tier mesh over the group (:func:`_two_tier_mesh`) and the plan
    in effect: an explicit ``--plan``, then the auto-resolution's planner
    pick, then the legacy plan (None); a non-legacy plan is announced as
    ``Topology plan: <name>``."""
    from atomo_tpu_torch.topology.schedule import plan_from_name

    k = _outer_ways(args, hosts_in_group())
    if codec is None:
        raise SystemExit(
            "--aggregate hierarchical needs a compressing --code "
            "(the point is factors on the slow fabric; use "
            "--aggregate psum for dense)")
    mesh = _two_tier_mesh(args, n_dev, k)
    pname = (args.plan if args.plan != "auto" else None) or getattr(args, "_auto_plan", None)
    plan = None
    if pname and pname != "legacy":
        plan = plan_from_name(pname)
        log(f"Topology plan: {plan.name}")
    return mesh, plan


def _superstep(args: argparse.Namespace) -> int:
    """``--superstep`` as the JAX verb takes it (``atomo_tpu/cli.py:930-934``,
    ``:2401-2407``): a negative K refused, 0 resolved to 1 (the JAX verb's
    off-TPU default)."""
    if args.superstep < 0:
        raise SystemExit(
            f"--superstep {args.superstep}: must be >= 1 (or 0 for the "
            "per-backend auto default)")
    return args.superstep or 1


def _codec(args: argparse.Namespace):
    """The codec of the fit flags, as the JAX verbs' ``_build_common`` makes
    it (its warning for ``--svd-rank 0``, its refusal of a disagreeing
    ``--svd-mode``), or None for a dense code."""
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
    # dense: no encode/decode in the step, as the JAX trainer
    return None if codec.name == "sgd" else codec


def _fabric_preflight(args: argparse.Namespace) -> None:
    """The argv half of the measured-fabric contract
    (``atomo_tpu/cli.py:981-995``); the resolved device count is checked
    again in the run."""
    if args.fabric == "measured":
        if not args.train_dir:
            raise SystemExit(
                "--fabric measured records the startup probe in "
                "train_dir/fabric_probe.json and needs a --train-dir")
        if args.n_devices == 1:
            raise SystemExit(
                "--fabric measured needs a multi-device mesh: a single "
                "device has no inter-chip fabric to measure")


FABRIC_ONE_DEVICE = (
    "--fabric measured needs a multi-device mesh: this host "
    "resolved to 1 device, so there is no inter-chip fabric "
    "to measure")


def _fabric_probe(args: argparse.Namespace, n_dev: int, ctx, log_fn) -> None:
    """``--fabric measured``'s startup probe (``atomo_tpu/cli.py:
    2459-2485``), before anything prices from the fabric: every rank takes
    part, rank 0 writes ``fabric_probe.json`` (or a ``--resume`` reuses
    it), and the document rides on ``args._fabric_probe`` to the pricing
    (``utils.comm_model.resolve_fabric(measured=)``)."""
    if args.fabric != "measured":
        return
    from atomo_tpu_torch.obs.fabric import ensure_fabric_probe

    if n_dev <= 1:
        raise SystemExit(FABRIC_ONE_DEVICE)
    k = getattr(args, "dcn_ways", 0)
    # a two-tier probe runs over the step's own groups (a K that is not a
    # two-tier split probes flat, as the JAX probe does)
    mesh = _two_tier_mesh(args, n_dev, k) if _two_tier_spec(n_dev, k) else None
    try:
        args._fabric_probe = ensure_fabric_probe(
            args.train_dir, n_dev=n_dev, dcn_ways=k, reuse=args.resume, log_fn=log_fn,
            write=ctx.rank == 0, device=ctx.device, mesh=mesh)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None


def _obs_preflight(args: argparse.Namespace) -> None:
    """The JAX verb's argv refusals of ``--obs-record`` and ``--obs-quality``
    (``atomo_tpu/cli.py:1167-1196``) for the flags the port has."""
    if args.obs_record and not args.train_dir:
        raise SystemExit(
            "--obs-record appends per-step telemetry to "
            "train-dir/metrics.jsonl and needs a --train-dir")
    if args.obs_quality:
        if args.code.lower() in DENSE_CODES:
            raise SystemExit(
                "--obs-quality probes the codec's estimator error; dense "
                "training (--code sgd) has no estimator to probe")
        if args.phase_metrics:
            raise SystemExit(
                "--obs-quality probes the fused step's encode in-graph; "
                "--phase-metrics has no fused step — drop one"
                + PHASE_METRICS_HINT)
        if args.overlap == "delayed":
            raise SystemExit(
                "--obs-quality does not compose with --overlap delayed: "
                "the carried payload describes the PREVIOUS step, so a "
                "per-step per-layer error column would be off by one — "
                "rejected honestly rather than silently mis-attributed")
        if args.aggregate == "hierarchical" or args.plan != "auto":
            raise SystemExit(
                "--obs-quality needs flat gather/ring/psum aggregation: "
                "the hierarchical boundary re-encode composes two "
                "estimators per layer and is not probe-aware yet")


def _recorder(args: argparse.Namespace, n_dev: int, log_fn, write: bool = True, budget=None):
    """(flight recorder, budget retuner) as the JAX verb builds them
    (``atomo_tpu/cli.py:2787-2880``), after the allocation: the recorder of
    ``--obs-record`` (None without it; no prediction to calibrate against,
    the port has no ``--auto``), and under ``--budget-alloc variance`` the
    allocation's meta line (from ``budget_alloc.json``) and the
    ``budget_epoch`` column. ``budget`` is ``(base codec, spectra,
    allocation, artifact document)``: over several devices with both obs
    flags, a train dir, a save cadence and no doctor the online
    re-allocation is armed (a :class:`~atomo_tpu_torch.budget.
    BudgetRetuner`), else the allocation is frozen, each with the JAX
    verb's line. Every rank calls it and gets the retuner (each re-solves
    alike); ``write`` (rank 0, which wrote the allocation) alone gets a
    recorder and writes."""
    recorder = None
    if args.obs_record and write:
        from atomo_tpu_torch.obs.recorder import FlightRecorder

        recorder = FlightRecorder.for_train_dir(args.train_dir)
    if args.budget_alloc != "variance":
        return recorder, None
    if recorder is not None:
        from atomo_tpu_torch.budget import allocation_meta, latest_epoch, read_alloc

        ep = latest_epoch(read_alloc(args.train_dir))
        recorder.write_meta(allocation_meta(ep))
        recorder.set_context(budget_epoch=int(ep["epoch"]))
    if (n_dev > 1 and args.obs_quality and args.obs_record and args.train_dir
            and (args.save_freq or args.eval_freq) and args.on_diverge == "off"):
        # online re-allocation: armed only when its signal (the recorded
        # q_err2 series) actually lands on disk
        from atomo_tpu_torch.budget import BudgetRetuner

        base, spectra, alloc, doc = budget
        tuner = BudgetRetuner(train_dir=args.train_dir, base_codec=base, spectra=spectra,
                              alloc=alloc, doc=doc, owner=write)
        log_fn("Budget: online re-allocation armed (q_err2-fed re-solve "
               "at checkpoint boundaries; decisions land in "
               "incidents.jsonl as budget_realloc)")
        return recorder, tuner
    log_fn("Budget: allocation frozen for this run"
           + ("" if args.obs_quality and args.obs_record
              else " (arm --obs-quality --obs-record with a "
                   "checkpoint cadence to re-solve at boundaries)"))
    return recorder, None


def cmd_train(args: argparse.Namespace, log_fn=print):
    from atomo_tpu_torch.training.resilience import DivergenceError, GuardConfig
    from atomo_tpu_torch.utils.chaos import ChaosConfig, ChaosInjector

    _partition_preflight(args)
    superstep = _superstep(args)
    _fabric_preflight(args)
    _plan_preflight(args)
    _overlap_preflight(args)
    _sparse_preflight(args)
    _obs_preflight(args)
    _budget_preflight(args)
    _quorum_preflight(args)
    _chaos_preflight(args)
    _diverge_preflight(args)
    rc = _supervise(args, log_fn)
    if rc is not None:
        return rc
    _warn_dead_flags(args)
    if args.phase_metrics:
        warnings.warn(
            "--phase-metrics is DEPRECATED: it times the four phases as "
            "separate blocking programs, so it cannot observe any fused "
            "program we ship (superstep, stream-encode, sparse-rows, "
            "tune, delayed, elastic, hierarchical are all rejected). "
            "The replacement is trace-based: run with --profile-dir and "
            "use `report timeline` to get per-step "
            "encode/exchange/decode/compute spans of the REAL fused step")
        if superstep > 1:
            warnings.warn(
                "--phase-metrics times individual phase programs and cannot "
                "run under a fused superstep scan; forcing --superstep 1"
                + PHASE_METRICS_HINT)
            superstep = 1
    guard = (GuardConfig(max_grad_norm=args.max_grad_norm)
             if args.grad_guard or args.max_grad_norm > 0 else None)
    # no --chaos: the loops read ATOMO_CHAOS from the env
    chaos = ChaosInjector(ChaosConfig.from_spec(args.chaos)) if args.chaos else None
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
    codec = _codec(args)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    common = dict(augment=name.startswith("cifar") and not args.no_augment,
                  max_steps=min(args.max_steps, args.epochs * steps_per_epoch),
                  eval_freq=args.eval_freq, seed=args.seed, log_fn=log_fn,
                  log_every=args.log_interval, device=args.device,
                  train_dir=args.train_dir, save_freq=args.save_freq or args.eval_freq,
                  resume=args.resume, keep_ckpts=args.keep_ckpts, compress_ckpt=args.compress,
                  compute_dtype=torch.bfloat16 if args.bf16 else None, superstep=superstep,
                  guard=guard, chaos=chaos, health_timeout=args.health_timeout)
    # one process runs the single-device loop unless a process group is up
    # or torchrun started it (one device over NCCL: a torchrun of one process)
    if args.n_devices <= 1 and not (dist.is_initialized() or "WORLD_SIZE" in os.environ):
        if args.fabric == "measured":
            raise SystemExit(FABRIC_ONE_DEVICE)
        _resolved_single(args)
        if args.sparse_rows != "off":
            log_fn("--sparse-rows auto: single device, no exchange — running dense")
        if args.num_aggregate is not None:
            warnings.warn("--num-aggregate needs a multi-device mesh; single-device "
                          "training has no replicas to subset — ignoring it")
        if args.plan != "auto":
            warnings.warn(PLAN_ONE_DEVICE)
        if args.grad_accum > 1:
            warnings.warn("--grad-accum is only wired into the multi-device step; "
                          "single-device training ignores it")
        if args.error_feedback:
            warnings.warn("--error-feedback needs a multi-device mesh; single-device "
                          "training has no exchanged estimator to compensate — "
                          "ignoring it")
        _single_partition_warnings(args)
        if args.budget_alloc == "variance":
            codec = budgeted_codec(codec, budget_allocation(
                args, model, codec, train_iter, log_fn)[1].ks)
        recorder, _ = _recorder(args, 1, log_fn)
        _resolved_chaos(chaos, 1)
        _quorum_config(args, 1)
        diverge = _diverge_config(args, codec, 1, None)
        try:
            return train_loop(model, optimizer, train_iter, test_iter, codec=codec,
                              diverge=diverge, track_quality=args.obs_quality,
                              recorder=recorder, **common)
        except DivergenceError as exc:
            return _diverged_exit(exc)
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
        _fabric_probe(args, n_dev, ctx, rank_log)
        plan = None
        if args.sparse_rows != "off" and n_dev <= 1:
            rank_log("--sparse-rows auto: single device, no exchange — running dense")
        elif args.sparse_rows != "off":
            plan = sparse_plan(args, model, codec, train_iter, n_dev, rank_log)
            if plan is not None and codec is None:
                # --code sgd: the dense-assigned leaves ride the payload
                # exchange as uncompressed DenseCodec payloads
                codec = DenseCodec()
        budget = None
        if args.budget_alloc == "variance":
            spectra, alloc, doc = budget_allocation(args, model, codec, train_iter, rank_log,
                                                    write=ctx.rank == 0)
            budget = (codec, spectra, alloc, doc)
            codec = budgeted_codec(codec, alloc.ks)
        # every rank runs the probes and the reduce; rank 0 alone writes
        recorder, budget_tuner = _recorder(args, n_dev, rank_log, write=ctx.rank == 0,
                                           budget=budget)
        aggregate = _train_aggregate(args, codec, model, plan, n_dev, rank_log)
        mesh = topo_plan = None
        if aggregate == "hierarchical":
            mesh, topo_plan = _two_tier(args, codec, n_dev, rank_log)
        partition = _partition(args).replace("_", "-")
        if partition == "zero1" and n_dev <= 1:
            # zero1 = partition == "zero1" and n_dev > 1 (atomo_tpu/cli.py:1750);
            # the sharded update at one rank is its degenerate case and runs
            warnings.warn(ZERO1_ONE_DEVICE)
            partition = "replicated"
        _resolved_chaos(chaos, n_dev)
        # (the JAX verb forces --superstep 1 here where its backend's auto
        # default is 8; the port's auto is 1, and an argv K above 1 is refused)
        quorum = _quorum_config(args, n_dev)
        diverge = _diverge_config(args, codec, n_dev, aggregate)
        try:
            return distributed_train_loop(
                model, optimizer, train_iter, test_iter, codec=codec, aggregate=aggregate,
                num_aggregate=_num_aggregate(args, aggregate, codec, n_dev),
                ring_bucket_size=args.ring_bucket_size, grad_accum=args.grad_accum,
                hybrid=plan, error_feedback=args.error_feedback, overlap=args.overlap,
                stream_encode=args.stream_encode == "on",
                stream_bucket_bytes=_stream_bucket_bytes(args), diverge=diverge,
                track_quality=args.obs_quality, recorder=recorder,
                phase_metrics=args.phase_metrics, lr_fn=_reference_lr(args),
                profile_dir=args.profile_dir or None, budget_tuner=budget_tuner,
                partition=partition, quorum=quorum,
                quorum_replay=args.replay_arrivals or None, mesh=mesh, plan=topo_plan,
                **{**common, "device": ctx.device})
        except DivergenceError as exc:
            return _diverged_exit(exc)
    finally:
        if not was_up:
            launch.shutdown()


ZERO1_ONE_DEVICE = (
    "--zero1 needs a multi-device mesh; single-device training "
    "has no dp axis to shard the optimizer state over — "
    "ignoring it")


def _single_partition_warnings(args: argparse.Namespace) -> None:
    """The JAX verb's warnings for a partition on the single-device path
    (``atomo_tpu/cli.py:3095-3119``), which trains the replicated update."""
    if args.zero1:
        warnings.warn(ZERO1_ONE_DEVICE)
    if _partition(args) != "replicated":
        warnings.warn(
            f"--partition {_partition(args)} is wired into the "
            "distributed loop; the single-device path trains the "
            "replicated update (the --zero1 precedent — there is "
            "nothing to shard a 1-chip update over)")


def _reference_lr(args: argparse.Namespace):
    """The master line's ``Cur lr``: the JAX verb's stepwise schedule in
    Python floats (its ``stepwise_shrink``), so the line reads as its."""
    return lambda step: args.lr * args.lr_shrinkage ** (step // args.shrinkage_freq)


def cmd_evaluate(args: argparse.Namespace, log_fn=print) -> int:
    """Evaluate each new checkpoint of ``--model-dir`` (``--train-dir``) with
    the reference's ``Evaluator:`` line, every ``--poll-interval`` seconds.
    The verb takes every flag of ``train``, as the JAX verb takes them: the
    model and data flags shape the run, the codec flags are checked as
    ``train`` checks them (with its warnings), and the rest are ignored."""
    _codec(args)
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
    recorder = None
    if args.train_dir and rank == 0:
        # the run recorded, as the JAX verb records it, so that `report` can
        # check the recorded axis layout against what ran (rank 0 writes,
        # as it does the checkpoints)
        from atomo_tpu_torch.obs.recorder import FlightRecorder
        from atomo_tpu_torch.training.trainer import fetch_metrics

        recorder = FlightRecorder.for_train_dir(args.train_dir)
        if start:
            recorder.prune_past(start)
        recorder.set_context(aggregate=aggregate)
        recorder.write_meta({
            "what": "model_axes",
            "layout": layout,
            "mesh_axes": spec.shape_dict(),
            "exchange": None if exchange is None else {
                "aggregate": exchange.aggregate,
                "stream_encode": exchange.stream_encode,
                "overlap": exchange.overlap,
            },
        })
    for i in range(start + 1, args.max_steps + 1):
        t0 = time.time()
        # every rank draws the global batch alike and takes its block
        tokens = np.ascontiguousarray(prog.shard_tokens(next_batch()))
        state, metrics = prog.step(state, fold_in(args.seed, i),
                                   torch.from_numpy(tokens).to(dev, torch.int64))
        if recorder is not None:  # one host copy of the step's metrics
            host = fetch_metrics(metrics)
            loss = host["loss"]
            recorder.record_block(i, host, wall_s=time.time() - t0)
        else:
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


def cmd_report(args: argparse.Namespace, log_fn=print) -> int:
    """``report`` (``atomo_tpu/cli.py:3651-3740``): in ``run`` mode the
    run's artifacts joined into ``train_dir/run_report.json`` (written
    atomically) with the cross-artifact consistency checks, and the
    post-mortem printed; ``report timeline`` parses the newest
    ``--profile-dir`` trace (default ``train-dir/trace``) into per-step
    encode/exchange/decode/compute spans joined against ``metrics.jsonl``
    (:mod:`atomo_tpu_torch.obs.timeline`), printed and, with a train dir,
    written to ``timeline_report.json``. ``--strict`` exits 3 when a check
    fails. Pure host-side reads: no device, no card. ``--fleet`` is refused
    by name (ROADMAP queue 1 item 11)."""
    from atomo_tpu_torch.obs.report import build_report, report_path, summarize_report
    from atomo_tpu_torch.utils.tracing import write_json_atomic

    if args.what == "timeline":
        from atomo_tpu_torch.obs.timeline import (
            TIMELINE_REPORT_NAME,
            build_timeline,
            summarize_timeline,
        )

        prof = args.profile_dir
        if not prof and args.train_dir:
            # convention fallback: a trace captured into the train dir
            prof = os.path.join(args.train_dir, "trace")
        if not prof or not os.path.isdir(prof):
            raise SystemExit(
                f"report timeline: profile dir {prof!r} does not exist — "
                "run training with --profile-dir DIR to capture a trace, "
                "then report timeline --profile-dir DIR")
        train_dir = args.train_dir if args.train_dir and os.path.isdir(args.train_dir) else None
        doc = build_timeline(prof, train_dir)
        log_fn(summarize_timeline(doc))
        if train_dir:
            out = os.path.join(train_dir, TIMELINE_REPORT_NAME)
            write_json_atomic(out, doc)
            log_fn(f"timeline report -> {out}")
        if args.strict and not doc["consistent"]:
            return 3
        return 0
    if not args.train_dir or not os.path.isdir(args.train_dir):
        raise SystemExit(f"report: train dir {args.train_dir!r} does not exist")
    if args.fleet:
        raise SystemExit(
            "report --fleet: the fleet report over train-dir/hosts/ is not "
            "ported yet (ROADMAP queue 1 item 11, with elastic and fleet); run "
            "`report` without --fleet for the run report")
    doc = build_report(args.train_dir)
    write_json_atomic(report_path(args.train_dir), doc)
    log_fn(summarize_report(doc))
    log_fn(f"run report -> {report_path(args.train_dir)}")
    if args.strict and not doc["consistent"]:
        return 3
    return 0


def main(argv: Optional[list[str]] = None, log_fn=print) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if getattr(args, "fn", None) is None:
        build_parser().print_help()
        return 2
    args._argv = argv  # the supervisor re-executes this exact command
    rc = args.fn(args, log_fn=log_fn)
    return rc if isinstance(rc, int) else 0


def cli_entry() -> int:
    """The process entry (``python -m atomo_tpu_torch``): a SystemExit that
    carries a message is a deterministic config refusal, so it exits with
    ``CONFIG_EXIT_CODE`` (2) and a supervisor gives up at once; a
    KeyboardInterrupt sent by the heartbeat watchdog exits with its code
    (13). In-process callers of :func:`main` keep the raising behaviour."""
    from atomo_tpu_torch.parallel.launch import WATCHDOG_EXIT_CODE, WATCHDOG_FIRED
    from atomo_tpu_torch.training.resilience import CONFIG_EXIT_CODE

    try:
        return main()
    except SystemExit as exc:
        if isinstance(exc.code, str):
            print(exc.code, file=sys.stderr, flush=True)
            return CONFIG_EXIT_CODE
        raise
    except KeyboardInterrupt:
        if WATCHDOG_FIRED.is_set():
            print(f"HealthWatchdog: exiting with {WATCHDOG_EXIT_CODE}", file=sys.stderr,
                  flush=True)
            return WATCHDOG_EXIT_CODE
        raise


if __name__ == "__main__":
    sys.exit(main())
