"""Anomaly-guarded stepping, the divergence doctor, bounded retries and the
run supervisor.

Counterpart of ``atomo_tpu/training/resilience.py`` (all but the step-time
drift detector, which waits for the autopilot). The escalation ladder is the
JAX package's:

1. **The guard** (:func:`grad_ok`): finiteness and an optional global-L2
   ceiling of each replica's raw gradient, before the codec. One device: a
   step that fails is skipped (parameters, optimizer state and BatchNorm
   statistics held, :func:`hold_`). Data-parallel: the failing replica's
   payload is masked out of the exchange and the survivors' mean rescaled
   by n/kept (:func:`rescale_by_survivors`, :func:`masked_mean`), valid
   because every codec is an unbiased estimator; a step with no survivor
   is skipped. ``ok`` is a 0-d device bool: it never reaches the host
   inside a step, so a guarded step stays sync-free and may run as a
   replayed CUDA graph.
2. **The detector** (:func:`detector_update`): a robust z-score of the loss
   against its EMA, a skip-rate EMA and a gradient-norm trend, a pure
   sequential fold, so its alarms are the same for any block partition.
3. **Rollback** (:class:`DivergenceDoctor`, :class:`RecoveryRig`):
   checkpoints earn a ``.healthy`` tag once the detector window clears past
   them; an alarm reloads the newest healthy one, replays the data stream,
   bumps the chaos generation and applies the remedy (``skip``, ``rewarm``:
   a ramp of the update from ``rewarm_floor`` back to 1, ``densify``: dense
   aggregation for a window).
4. **The supervisor** (:func:`run_supervised`): restarts a crashing run
   under a budget with decorrelated backoff, prunes to the newest healthy
   step on :data:`ROLLBACK_EXIT_CODE`, gives up at once on
   :data:`CONFIG_EXIT_CODE`; each decision is an incident.
5. **Retries** (:func:`with_retries`) around fallible host work (saves).

PyTorch idiom: the port's optimizers update parameters and buffers in place,
so the skip keeps a copy of the pre-step values (taken into fixed buffers
before forward: a graph reads the same addresses every replay) and writes
``where(ok, new, old)`` back in place, the JAX package's ``select_state``
bit for bit. The optimizer's step count is held as the JAX package holds
optax's: a guarded state counts its skipped steps on the device
(``TrainState.held``) and the update reads its learning rate (and Adam's
bias corrections) from a device table at ``count - held``
(:class:`OptScalarTable`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import random
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from atomo_tpu_torch.utils.tracing import ATTEMPT_ENV, PHASE_METRICS_HINT  # noqa: F401

SUPERVISED_ENV = "ATOMO_SUPERVISED"  # set by run_supervised on its children
# the trainer's "roll me back from a clean checkpoint" exit, distinct from
# crashes (1), the watchdog's 13 and chaos's 43
ROLLBACK_EXIT_CODE = 23
# a deterministic config error (argparse's own usage code): the supervisor
# gives up at once instead of re-running the same reject
CONFIG_EXIT_CODE = 2
# the elastic membership boundary of the JAX package (its elastic layer is
# not ported: the port's supervisor triages this code as a crash)
MEMBERSHIP_EXIT_CODE = 29


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """max_grad_norm: drop a contribution whose global L2 norm exceeds this
    (0 = finiteness only). A screen, not clipping."""

    max_grad_norm: float = 0.0


# ---------------------------------------------------------------------------
# The screen and the skip (in the step, on the device)
# ---------------------------------------------------------------------------


def global_sq_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d float32 sum of squares over every leaf, leaf by leaf in order:
    the detector's raw grad-norm signal (pre-screen, pre-codec)."""
    sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        lf = g.float()
        sq = sq + torch.sum(lf * lf)
    return sq


def grad_ok(grads: Sequence[torch.Tensor], max_grad_norm: float = 0.0) -> torch.Tensor:
    """0-d bool on the gradients' device: every leaf finite, and (when
    ``max_grad_norm`` > 0) the global L2 norm within it. An overflowing sum
    of squares is itself non-finite, so the norm screen also catches an
    explosion whose square overflows. The finiteness test is two
    multi-tensor passes, not two launches a leaf: every value times 0 (NaN
    for NaN and Inf, zero otherwise), then each leaf's 1-norm of those,
    finite exactly when the leaf is."""
    zeros = torch._foreach_mul(list(grads), 0.0)
    finite = torch.isfinite(torch.stack(torch._foreach_norm(zeros, 1))).all()
    if max_grad_norm and max_grad_norm > 0:
        bound = float(np.float32(max_grad_norm) ** 2)
        finite = finite & (global_sq_norm(grads) <= bound)
    return finite


def select_state(ok: torch.Tensor, new_tree: Sequence[torch.Tensor],
                 old_tree: Sequence[torch.Tensor]) -> list:
    """Per leaf ``where(ok, new, old)``: the skip."""
    return [torch.where(ok, n, o) for n, o in zip(new_tree, old_tree)]


@torch.no_grad()
def hold_(ok: torch.Tensor, live: Sequence[torch.Tensor],
          before: Sequence[torch.Tensor]) -> None:
    """:func:`select_state` written back into ``live`` in place (the port's
    parameters, optimizer buffers and statistics are updated in place):
    each tensor keeps its new value where ``ok``, else ``before``'s."""
    for t, b in zip(live, before):
        torch.where(ok, t, b, out=t)


def zero_if(bad: torch.Tensor, tree: Sequence[torch.Tensor]) -> list:
    """Every leaf zeroed when ``bad``: keeps non-finite values out of the
    codec and the optimizer arithmetic."""
    return [torch.where(bad, torch.zeros((), dtype=g.dtype, device=g.device), g)
            for g in tree]


def survivors_scale(n_contrib: int, kept: torch.Tensor) -> torch.Tensor:
    """``n / max(kept, 1)`` in float32, as a division (0-d, on kept's device)."""
    return torch.full_like(kept, float(n_contrib)) / torch.clamp(kept, min=1.0)


def rescale_by_survivors(tree: Sequence[torch.Tensor], n_contrib: int,
                         kept: torch.Tensor) -> list:
    """Skip-and-rescale, gather form: a mean over all ``n_contrib`` slots
    (the masked ones zero) times n/kept is the mean over the survivors."""
    scale = survivors_scale(n_contrib, kept)
    return [g * scale.to(g.dtype) for g in tree]


def masked_mean(tree: Sequence[torch.Tensor], ok: torch.Tensor, world: int, group=None):
    """Skip-and-rescale, psum form: this replica's contribution zeroed when
    not ``ok``, summed over the ranks with the survivors' count in the same
    ``all_reduce``, divided by max(kept, 1). Returns (mean, kept)."""
    import torch.distributed as dist

    flat = torch.cat([g.reshape(-1) for g in zero_if(~ok, tree)]
                     + [ok.to(torch.float32).reshape(1)])
    if world > 1:
        dist.all_reduce(flat, group=group)
    kept = flat[-1]
    mean = flat[:-1] / torch.clamp(kept, min=1.0)
    parts = mean.split([g.numel() for g in tree])
    return [p.view(g.shape) for p, g in zip(parts, tree)], kept


class OptScalarTable:
    """The optimizer's per-step values (``step_scalars``: -lr, and Adam's
    bias corrections) for every count below ``cap``, in device memory: a
    guarded step reads the row of its held count (``count - held``) with
    no host sync. The rows are the host's float32 values, so the update is
    the unguarded one's bit for bit while nothing was skipped."""

    def __init__(self, optimizer, device):
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.table: Optional[torch.Tensor] = None

    def reserve(self, n: int) -> bool:
        """Rows for counts 0..n-1; True when the table was reallocated (a
        captured graph reads the old one and must be captured again)."""
        have = 0 if self.table is None else self.table.shape[0]
        if n <= have:
            return False
        cap = max(1024, 1 << (int(n) - 1).bit_length())
        rows = np.array([self.optimizer.step_scalars(c) for c in range(cap)],
                        dtype=np.float32)
        self.table = torch.from_numpy(rows).to(self.device)
        return have > 0

    def row(self, count: torch.Tensor) -> torch.Tensor:
        """The (width,) float32 row of a 0-d int64 device count."""
        return self.table.index_select(0, count.reshape(1))[0]


# ---------------------------------------------------------------------------
# The divergence detector (host, once a step or a block)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """window: EMA span, healthy-tag clearance and remedy span; zmax: the
    loss z-score threshold; patience: consecutive hot steps before the
    alarm; min_history: warm-up steps; skip_max: the skip-rate alarm;
    grad_ratio: the gradient-norm trend alarm."""

    window: int = 16
    zmax: float = 6.0
    patience: int = 3
    min_history: int = 8
    skip_max: float = 0.5
    grad_ratio: float = 10.0

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(
                f"detector window must be >= 2, got {self.window} (a "
                "1-step window has zero variance — the z-score alarm "
                "could never fire)"
            )
        if self.patience < 1:
            raise ValueError(f"detector patience must be >= 1, got {self.patience}")
        if self.min_history < 0:
            raise ValueError(f"detector min_history must be >= 0, got {self.min_history}")
        if self.zmax <= 0:
            raise ValueError(f"detector zmax must be > 0, got {self.zmax}")


@dataclasses.dataclass(frozen=True)
class DetectorState:
    n: int = 0
    mean: float = 0.0  # loss EMA baseline (frozen while hot)
    var: float = 0.0
    hot: int = 0  # consecutive steps with z > zmax
    skip_ema: float = 0.0
    gn_ref: float = 0.0  # gradient-norm EMA baseline
    gn_hot: int = 0


def detector_update(cfg: DetectorConfig, st: DetectorState, loss: float,
                    skipped: float = 0.0, grad_norm: Optional[float] = None):
    """Fold one step's ``(loss, skipped[, grad_norm])`` into the carry;
    returns ``(state, alarm reason or None)``. The loss baseline is frozen
    while the z-score is hot; a skipped step updates the skip rate only; a
    non-finite loss on an unskipped step alarms at once."""
    loss = float(loss)
    alpha = 2.0 / (cfg.window + 1.0)
    armed = st.n >= cfg.min_history
    skip = 1.0 if skipped and float(skipped) > 0 else 0.0
    skip_ema = st.skip_ema + alpha * (skip - st.skip_ema)
    mean, var, hot = st.mean, st.var, st.hot
    gn_ref, gn_hot = st.gn_ref, st.gn_hot
    alarm = None

    if not math.isfinite(loss):
        if skip < 0.5:
            alarm = "nonfinite_loss"
    elif skip < 0.5:
        if st.n == 0 or (mean == 0.0 and var == 0.0 and st.hot == 0):
            mean, var, hot = loss, 0.0, 0
        else:
            diff = loss - mean
            sd = math.sqrt(var) if var > 0 else 0.0
            z = diff / sd if sd > 0 else 0.0
            if armed and sd > 0 and z > cfg.zmax:
                hot += 1
            else:
                hot = 0
                mean += alpha * diff
                var = (1.0 - alpha) * (var + alpha * diff * diff)

    if alarm is None and hot >= cfg.patience:
        alarm = "loss_zscore"
    if alarm is None and armed and skip_ema > cfg.skip_max:
        alarm = "skip_rate"

    if grad_norm is not None:
        g = float(grad_norm)
        if math.isfinite(g) and g > 0 and skip < 0.5:
            if armed and gn_ref > 0 and g > cfg.grad_ratio * gn_ref:
                gn_hot += 1
            else:
                gn_hot = 0
                gn_ref = g if gn_ref <= 0 else gn_ref + alpha * (g - gn_ref)
    if alarm is None and gn_hot >= cfg.patience:
        alarm = "grad_norm_trend"

    return DetectorState(n=st.n + 1, mean=mean, var=var, hot=hot, skip_ema=skip_ema,
                         gn_ref=gn_ref, gn_hot=gn_hot), alarm


def _as_seq(x):
    return np.asarray(x).reshape(-1)


def detector_scan(cfg: DetectorConfig, st: DetectorState, losses, skipped=None,
                  grad_norms=None, first_step: int = 1):
    """Fold a per-step series (a block's, or one step's) through the
    detector, stopping at the first alarm: ``(state, alarm step or None,
    reason or None)``."""
    losses = [float(x) for x in _as_seq(losses)]
    skips = [0.0] * len(losses) if skipped is None else [float(x) for x in _as_seq(skipped)]
    gns = ([None] * len(losses) if grad_norms is None
           else [float(x) for x in _as_seq(grad_norms)])
    for i, (loss, sk, gn) in enumerate(zip(losses, skips, gns)):
        st, alarm = detector_update(cfg, st, loss, sk, gn)
        if alarm is not None:
            return st, first_step + i, alarm
    return st, None, None


class DivergenceError(RuntimeError):
    """The in-process rollback budget is spent (the CLI exits with
    :data:`ROLLBACK_EXIT_CODE`)."""

    def __init__(self, step: int, reason: str, rollbacks: int):
        super().__init__(
            f"divergence at step {step} ({reason}) after {rollbacks} "
            "rollback(s); in-process budget exhausted"
        )
        self.step = step
        self.reason = reason
        self.rollbacks = rollbacks


@dataclasses.dataclass(frozen=True)
class RemedyConfig:
    """The ``rewarm`` remedy: the update scaled by a ramp from ``floor``
    back to 1 over ``window`` steps after ``start_step``."""

    start_step: int
    window: int
    floor: float = 0.1


def remedy_scale(remedy: RemedyConfig, step) -> torch.Tensor:
    """The ramp factor in [floor, 1] at ``step`` (an int, or a 0-d device
    tensor: a graph's step counter), a 0-d float32 tensor computed in the
    JAX package's float32 arithmetic."""
    step = torch.as_tensor(step).to(torch.float32)
    t = torch.clamp((step - float(np.float32(remedy.start_step)))
                    / float(np.float32(max(remedy.window, 1))), 0.0, 1.0)
    floor = float(np.float32(remedy.floor))
    return floor + (1.0 - floor) * t


def apply_remedy(remedy: RemedyConfig, step, grads: Sequence[torch.Tensor]) -> list:
    """The aggregated gradient times the rewarm ramp at ``step``."""
    scale = remedy_scale(remedy, step)
    return [g * scale.to(g.dtype) for g in grads]


@dataclasses.dataclass(frozen=True)
class DivergeConfig:
    """``--on-diverge``: the remedy, the detector and the in-process
    rollback budget."""

    remedy: str = "skip"  # skip | rewarm | densify
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    max_rollbacks: int = 2
    rewarm_floor: float = 0.1

    def __post_init__(self):
        if self.remedy not in ("skip", "rewarm", "densify"):
            raise ValueError(
                f"unknown --on-diverge remedy {self.remedy!r}; expected "
                "skip | rewarm | densify"
            )


def diverge_conflict(remedy, *, train_dir, codec=None, aggregate=None, overlap=None,
                     zero1=False, phase_metrics=False, num_aggregate=None, keep_ckpts=None,
                     save_freq=None, window=None):
    """The ``--on-diverge`` compatibility matrix (the JAX package's, text
    for text): the reason a combination cannot work, or None."""
    if not train_dir:
        return (
            "diverge (--on-diverge) needs a train_dir: rollback "
            "restores from checkpoints"
        )
    if save_freq is not None and not save_freq:
        return (
            "--on-diverge needs a checkpoint cadence (--save-freq or "
            "--eval-freq > 0): with saves disabled no checkpoint can earn "
            "a healthy tag and every rollback would restart from scratch"
        )
    if keep_ckpts and save_freq and window and keep_ckpts * save_freq < window:
        return (
            f"--on-diverge with --keep-ckpts {keep_ckpts} and --save-freq "
            f"{save_freq} retains checkpoints for only "
            f"{keep_ckpts * save_freq} steps — shorter than the "
            f"--diverge-window of {window}, so none would live long enough "
            "to earn the healthy tag a rollback needs; raise --keep-ckpts "
            "(or drop it to keep all checkpoints)"
        )
    if zero1:
        return (
            "--on-diverge is not supported with --zero1 (the sharded "
            "optimizer template cannot be rebuilt mid-run); drop one"
        )
    if phase_metrics:
        return (
            "--on-diverge needs the fused step's metric series; "
            "--phase-metrics has no doctor wiring — drop one"
            + PHASE_METRICS_HINT
        )
    if remedy == "densify":
        if codec is None:
            return (
                "--on-diverge densify needs a compressing --code — "
                "dense training has nothing denser to de-escalate to"
            )
        if overlap == "delayed":
            return (
                "--on-diverge densify cannot compose with --overlap "
                "delayed (the dense fallback has no delayed form); "
                "use skip or rewarm"
            )
        if aggregate == "hierarchical":
            return (
                "--on-diverge densify cannot compose with --aggregate "
                "hierarchical (the dense fallback aggregates with a flat "
                "psum; every two-level topology plan — the legacy "
                "psum+gather schedule and the re-encoded plans alike — "
                "needs a codec to compress at least one tier); use skip "
                "or rewarm"
            )
        if num_aggregate:
            return (
                "--on-diverge densify cannot compose with "
                "--num-aggregate (a dense psum cannot subset "
                "replicas); use skip or rewarm"
            )
    return None


@dataclasses.dataclass(frozen=True)
class RollbackPlan:
    target: int
    remedy: str
    window: int
    generation: int
    reason: str
    alarm_step: int


class DivergenceDoctor:
    """Folds the per-step series through the detector, grants healthy tags
    to checkpoints the window has cleared, and turns alarms into
    :class:`RollbackPlan` against the in-process budget. ``owner`` False
    (a data-parallel rank other than 0: every rank folds the same series)
    reads the directory for its rollback targets but writes nothing to it."""

    def __init__(self, cfg: DivergeConfig, train_dir: Optional[str], incidents=None,
                 log_fn=print, owner: bool = True):
        self.cfg = cfg
        self.owner = owner
        self.train_dir = train_dir
        self.incidents = incidents
        self.log_fn = log_fn
        self.state = DetectorState()
        self.pending: list[int] = []  # saved steps awaiting the healthy tag
        self.rollbacks = 0
        self.generation = 0

    def note_save(self, step: int) -> None:
        if step not in self.pending:
            self.pending.append(step)

    def observe_block(self, first_step: int, losses, skipped=None, grad_norms=None):
        """Fold steps ``first_step..`` into the detector and confirm the
        pending tags the window has cleared; ``(alarm step, reason)`` or
        ``(None, None)``."""
        losses = _as_seq(losses)
        self._confirm_through(first_step - 1)
        self.state, alarm_step, reason = detector_scan(
            self.cfg.detector, self.state, losses, skipped, grad_norms,
            first_step=first_step)
        if reason is None:
            self._confirm_through(first_step + len(losses) - 1)
        else:
            # the steps before the alarm were observed alarm-free: the same
            # confirmations as the per-step loop, for any block partition
            self._confirm_through(alarm_step - 1)
        return alarm_step, reason

    def _confirm_through(self, step: int) -> None:
        if not self.pending:
            return
        from atomo_tpu_torch.training.checkpoint import checkpoint_path, mark_healthy

        w = self.cfg.detector.window
        still = []
        for s in sorted(self.pending):
            if s + w <= step:
                # a save that retention already pruned is dropped untagged
                if (self.owner and self.train_dir
                        and os.path.exists(checkpoint_path(self.train_dir, s))):
                    mark_healthy(self.train_dir, s)
            else:
                still.append(s)
        self.pending = still

    def plan_rollback(self, alarm_step: int, reason: str) -> RollbackPlan:
        """The plan for an alarm (or :class:`DivergenceError` once the
        budget is spent): prunes the diverged timeline above the target,
        resets the detector, bumps the chaos generation."""
        from atomo_tpu_torch.training.checkpoint import latest_healthy_step, prune_after

        if self.rollbacks >= self.cfg.max_rollbacks:
            pruned: list[int] = []
            if self.train_dir and self.owner:
                pruned = prune_after(self.train_dir,
                                     latest_healthy_step(self.train_dir) or 0)
            if self.incidents is not None:
                self.incidents.append("divergence", action="give_up", step=alarm_step,
                                      reason=reason, rollbacks=self.rollbacks, pruned=pruned)
            raise DivergenceError(alarm_step, reason, self.rollbacks)
        self.rollbacks += 1
        target = None
        removed: list[int] = []
        if self.train_dir:
            target = latest_healthy_step(self.train_dir)
            if self.owner:
                removed = prune_after(self.train_dir, target or 0)
        target = int(target) if target is not None else 0
        self.generation += 1
        self.state = DetectorState()
        self.pending = [s for s in self.pending if s <= target]
        plan = RollbackPlan(target=target, remedy=self.cfg.remedy,
                            window=self.cfg.detector.window, generation=self.generation,
                            reason=reason, alarm_step=alarm_step)
        self.log_fn(
            f"Doctor: divergence at step {alarm_step} ({reason}); rolling "
            f"back to step {target} with remedy {plan.remedy!r} "
            f"(rollback {self.rollbacks}/{self.cfg.max_rollbacks}"
            + (f", pruned steps {removed}" if removed else "")
            + ")"
        )
        if self.incidents is not None:
            self.incidents.append("divergence", action=f"rollback+{plan.remedy}",
                                  step=alarm_step, target=target, reason=reason,
                                  pruned=removed, rollbacks=self.rollbacks)
        return plan


class RecoveryRig:
    """Binds a :class:`DivergenceDoctor` to one loop's ``reload_state(target)``
    (the state of the step-``target`` checkpoint; 0 = fresh init),
    ``restream(target)`` (the data stream replayed past ``target`` batches)
    and ``build_step(generation, remedy_cfg, densify)``."""

    def __init__(self, doctor, diverge, reload_state, restream, build_step):
        self.doctor = doctor
        self.diverge = diverge
        self._reload = reload_state
        self._restream = restream
        self._build = build_step
        self.densify_until: Optional[int] = None
        self.remedy_until: Optional[int] = None

    def observe(self, first_step, metrics):
        """Feed fetched metrics (per-step scalars or (K,) series) to the
        detector; ``sample_skipped`` (delayed) wins over ``skipped``."""
        return self.doctor.observe_block(
            first_step, metrics["loss"],
            metrics.get("sample_skipped", metrics.get("skipped")), metrics.get("grad_norm"))

    def note_save(self, step):
        self.doctor.note_save(step)

    def rollback(self, alarm_step, reason):
        plan = self.doctor.plan_rollback(alarm_step, reason)
        remedy_cfg = (RemedyConfig(start_step=plan.target, window=plan.window,
                                   floor=self.diverge.rewarm_floor)
                      if plan.remedy == "rewarm" else None)
        densify = plan.remedy == "densify"
        self.densify_until = plan.target + plan.window if densify else None
        self.remedy_until = plan.target + plan.window if plan.remedy == "rewarm" else None
        state = self._reload(plan.target)
        stream = self._restream(plan.target)
        step_fn = self._build(plan.generation, remedy_cfg, densify)
        return plan, state, stream, step_fn

    def recover(self, alarm_step, reason, chaos):
        """The rollback, the loop's own chaos injector moved to the plan's
        generation (its host faults disarm with the step's), and the
        restored step: ``(state, stream, step_fn, chaos, step)``."""
        plan, state, stream, step_fn = self.rollback(alarm_step, reason)
        if chaos is not None:
            chaos = chaos.with_generation(plan.generation)
        return state, stream, step_fn, chaos, int(state.step)

    def maybe_end_densify(self, step):
        if self.densify_until is not None and step >= self.densify_until:
            self.densify_until = None
            return self._build(self.doctor.generation, None, False)
        return None

    def remedy_active(self, step) -> bool:
        if self.densify_until is not None and step < self.densify_until:
            return True
        return self.remedy_until is not None and step < self.remedy_until


# ---------------------------------------------------------------------------
# Loop helpers
# ---------------------------------------------------------------------------


def resolve_chaos(chaos):
    """The caller's injector, or the ATOMO_CHAOS env's when it passed none."""
    from atomo_tpu_torch.utils.chaos import ChaosInjector

    return ChaosInjector.from_env() if chaos is None else chaos


@contextlib.contextmanager
def heartbeat_watchdog(health_timeout: float, on_failure=None):
    """Arm the step-heartbeat watchdog around a loop body (a no-op at 0):
    yields the monitor to ``beat()`` (or None) and stops the thread on the
    way out."""
    from atomo_tpu_torch.parallel.launch import HealthMonitor, HealthWatchdog

    monitor = watchdog = None
    if health_timeout > 0:
        monitor = HealthMonitor(timeout=health_timeout)
        watchdog = HealthWatchdog(monitor, interval=min(health_timeout / 4, 10.0),
                                  on_failure=on_failure).start()
    try:
        yield monitor
    finally:
        if watchdog is not None:
            watchdog.stop()


def retrying_saver(log_fn=print, incidents=None):
    """``save_checkpoint`` under the standard bounded backoff, each retry
    an incident when ``incidents`` is given."""
    from atomo_tpu_torch.training.checkpoint import save_checkpoint

    return with_retries(
        save_checkpoint,
        on_retry=lambda i, exc: log_fn(f"Checkpoint save failed (attempt {i}): {exc}; retrying"),
        incidents=incidents, incident_cause="checkpoint_save")


def decorrelated_delay(prev: float, base: float, cap: float,
                       rng: random.Random) -> tuple[float, float]:
    """One decorrelated-jitter backoff step: ``min(cap, uniform(base,
    3 * prev))``; returns ``(delay, next prev)``."""
    delay = min(cap, rng.uniform(base, prev * 3))
    return delay, max(delay, base)


def with_retries(fn: Callable, *, attempts: int = 3, base_delay: float = 0.1,
                 max_delay: float = 5.0, exceptions: Sequence[type] = (OSError,),
                 on_retry: Optional[Callable[[int, BaseException], None]] = None,
                 sleep: Callable[[float], None] = time.sleep, jitter: bool = True,
                 rng: Optional[random.Random] = None, incidents=None,
                 incident_cause: str = "retry") -> Callable:
    """``fn`` retried on the listed exceptions with decorrelated-jitter
    backoff (``jitter=False``: base * 2**i), the last failure re-raised
    after ``attempts``; anything else propagates at once."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    exc_types = tuple(exceptions)
    rng = rng if rng is not None else random.Random()

    def wrapped(*args, **kwargs):
        prev = base_delay
        for i in range(attempts):
            try:
                return fn(*args, **kwargs)
            except exc_types as exc:
                if i + 1 >= attempts:
                    raise
                if on_retry is not None:
                    on_retry(i + 1, exc)
                if incidents is not None:
                    incidents.append(incident_cause, action="retry", attempt=i + 1,
                                     op=getattr(fn, "__name__", str(fn)),
                                     error=f"{type(exc).__name__}: {exc}")
                if jitter:
                    delay, prev = decorrelated_delay(prev, base_delay, max_delay, rng)
                else:
                    delay = min(base_delay * (2 ** i), max_delay)
                sleep(delay)

    return wrapped


def run_supervised(cmd: Sequence[str], *, max_restarts: int = 2, backoff_base: float = 1.0,
                   backoff_max: float = 30.0, train_dir: Optional[str] = None,
                   resume_flag: Optional[str] = "--resume", log_fn=print,
                   rng: Optional[random.Random] = None,
                   sleep: Callable[[float], None] = time.sleep,
                   env: Optional[dict] = None) -> int:
    """Run ``cmd`` as a child under a crash-loop budget. The child sees
    :data:`SUPERVISED_ENV` (it never supervises itself) and
    :data:`ATTEMPT_ENV` (its 0-based attempt). Exit codes: 0 done;
    :data:`CONFIG_EXIT_CODE` give up at once (every restart would fail
    alike); :data:`ROLLBACK_EXIT_CODE` prune the checkpoints to the newest
    healthy step, then restart; anything else (the JAX package's membership
    exit 29 included: the elastic layer is not ported) a crash, restarted.
    A restart appends ``resume_flag`` once, waits a decorrelated backoff
    and burns one unit of ``max_restarts``; once spent, the child's code is
    returned. Every decision is one record in ``train_dir/incidents.jsonl``."""
    import subprocess

    from atomo_tpu_torch.utils.tracing import IncidentLog

    incidents = IncidentLog.for_train_dir(train_dir) if train_dir else None
    rng = rng if rng is not None else random.Random()
    base_env = dict(os.environ if env is None else env)
    cmd = list(cmd)
    attempt = 0
    budget_used = 0
    prev = max(backoff_base, 1e-3)
    while True:
        run_cmd = list(cmd)
        if attempt > 0 and resume_flag and resume_flag not in run_cmd:
            run_cmd.append(resume_flag)
        child_env = {**base_env, SUPERVISED_ENV: "1", ATTEMPT_ENV: str(attempt)}
        t0 = time.time()
        rc = subprocess.call(run_cmd, env=child_env)
        wall = round(time.time() - t0, 3)
        if rc == 0:
            if incidents is not None:
                incidents.append("clean_exit", action="done", attempt=attempt, run_s=wall)
            log_fn(f"Supervisor: clean exit (attempt {attempt})")
            return 0
        if rc == MEMBERSHIP_EXIT_CODE:
            log_fn(
                f"Supervisor: attempt {attempt} exited rc={rc} "
                "(membership-change) but the elastic membership layer is not "
                "ported (ROADMAP queue 1 item 11); triaging as a crash"
            )
        if rc == CONFIG_EXIT_CODE:
            if incidents is not None:
                incidents.append("config_error", action="give_up", attempt=attempt, rc=rc,
                                 run_s=wall)
            log_fn(
                f"Supervisor: attempt {attempt} exited rc={rc} (config "
                "error — deterministic); not restarting"
            )
            return rc
        cause = "rollback_requested" if rc == ROLLBACK_EXIT_CODE else "crash"
        target = None
        if rc == ROLLBACK_EXIT_CODE and train_dir:
            from atomo_tpu_torch.training.checkpoint import latest_healthy_step, prune_after

            target = latest_healthy_step(train_dir) or 0
            prune_after(train_dir, target)
        if budget_used >= max_restarts:
            if incidents is not None:
                incidents.append("budget_exhausted", action="give_up", attempt=attempt,
                                 rc=rc, run_s=wall, max_restarts=max_restarts)
            log_fn(
                f"Supervisor: budget exhausted after attempt {attempt} "
                f"(rc={rc}, {cause}); giving up"
            )
            return rc
        delay, prev = decorrelated_delay(prev, backoff_base, backoff_max, rng)
        delay = round(delay, 3)
        if incidents is not None:
            incidents.append(cause, action="restart", attempt=attempt, rc=rc, target=target,
                             backoff_s=delay, run_s=wall)
        log_fn(
            f"Supervisor: attempt {attempt} exited rc={rc} ({cause}); "
            f"restarting in {delay:.2f}s "
            f"({max_restarts - budget_used} restart(s) left)"
        )
        sleep(delay)
        attempt += 1
        budget_used += 1
