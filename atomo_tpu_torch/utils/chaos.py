"""Chaos harness: deterministic fault injection for the resilience stack.

Counterpart of ``atomo_tpu/utils/chaos.py``: the same fault grammar, the same
parsed fields and the same error texts, so one spec drills both packages.

Fault kinds (S a 1-based trainer step)::

  nan@S inf@S       the gradient becomes NaN / Inf at step S    (in the step)
  explode@S         the gradient is scaled by 1e12 at step S    (in the step)
  spike@S:W         the gradient is scaled by ``spike_scale`` (finite) for W
                    steps from S, on every replica              (in the step)
  die@S:R           replica R's gradient is NaN from step S on, at
                    membership epoch 0 only                     (in the step)
  slow@S:SEC        the host sleeps SEC seconds before step S
  slow@S:R:SEC      replica R lags SEC seconds on every step from S on
  kill@S            the process dies before step S (run attempt 0 only)
  crashloop@M       the process dies at loop start on the first M attempts
  truncate@S bitflip@S badmagic@S
                    the checkpoint written at step S is damaged after the save
  hostdie@S:H slowlink@S:H:SEC partition@S:H1-H2:SEC
                    the fleet's lease faults; parsed here, refused by
                    ``train`` (the fleet layer is not ported)

``@S*`` makes that one gradient fault hit every replica; otherwise a gradient
fault hits ``target_replica`` (0) only. Step-targeted faults fire at doctor
generation 0 only (a rollback replays the faulted range clean); ``die`` and
``slow@S:R:SEC`` follow the membership epoch instead, ``crashloop`` the run
attempt.

The gradient faults in the step. The JAX package bakes a constant
(step, code) table into the compiled step and indexes it with the traced
step counter. The port does the same on the card: :meth:`ChaosInjector.
prepare` puts the table in device memory once, and :meth:`inject_grads`
selects the fault there by the step counter, a 0-d tensor (the step a CUDA
graph reads from its static buffers, :mod:`atomo_tpu_torch.training.graph`;
an eager step's is a CPU scalar), with no host sync, so a replayed graph
sees each step's own fault. The gradient goes through the JAX package's
arithmetic, ``g * mul + add`` (mul 1e12 for explode, add NaN or Inf for nan
and inf, 1 and 0 otherwise), ``g + add`` for die and ``g * mul`` for spike.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import sys
import time
from typing import Optional

from atomo_tpu_torch.utils.tracing import ATTEMPT_ENV, MEMBERSHIP_EPOCH_ENV

GRAD_FAULTS = {"nan": 1, "inf": 2, "explode": 3}
CKPT_FAULTS = ("truncate", "bitflip", "badmagic")
CHAOS_EXIT_CODE = 43  # distinct from crashes (1) and the watchdog's 13

_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<step>\d+)(?P<all>\*)?"
    r"(?::(?P<arg>[0-9.e+-]+))?(?::(?P<arg2>[0-9.e+-]+))?$"
)


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """A parsed fault plan (the JAX package's fields). ``grad_faults`` holds
    (step, kind, all_replicas) entries."""

    grad_faults: tuple[tuple[int, str, bool], ...] = ()
    slow_steps: tuple[tuple[int, float], ...] = ()
    kill_steps: tuple[int, ...] = ()
    ckpt_faults: tuple[tuple[int, str], ...] = ()
    spike_faults: tuple[tuple[int, int], ...] = ()  # (start_step, window)
    die_faults: tuple[tuple[int, int], ...] = ()  # (start_step, replica)
    slow_replica_faults: tuple[tuple[int, int, float], ...] = ()  # (start, replica, sec)
    host_die_faults: tuple[tuple[int, int], ...] = ()  # (round, host)
    slowlink_faults: tuple[tuple[int, int, float], ...] = ()  # (round, host, sec)
    partition_faults: tuple[tuple[int, int, int, float], ...] = ()  # (round, h1, h2, sec)
    spike_scale: float = 8.0  # finite: passes grad_ok's finiteness screen
    crashloop: int = 0  # the first M runs die at loop start
    explode_scale: float = 1e12
    target_replica: int = 0
    exit_code: int = CHAOS_EXIT_CODE
    seed: int = 0

    def __post_init__(self):
        # one gradient fault a step: the selector sums the matching codes,
        # so two faults on one step would combine into another kind
        steps = [f[0] for f in self.grad_faults]
        if len(steps) != len(set(steps)):
            raise ValueError(
                "multiple gradient faults configured for the same step "
                f"({sorted(steps)}); pick one fault kind per step"
            )

    @classmethod
    def from_spec(cls, spec: str, *, seed: Optional[int] = None,
                  spike_scale: Optional[float] = None, environ=None) -> "ChaosConfig":
        """Parse a fault spec. ``seed`` and ``spike_scale`` default to the
        ATOMO_CHAOS_SEED / ATOMO_CHAOS_SPIKE_SCALE env knobs."""
        env = os.environ if environ is None else environ
        if seed is None:
            seed = int(env.get("ATOMO_CHAOS_SEED", "0"))
        if spike_scale is None:
            spike_scale = float(env.get("ATOMO_CHAOS_SPIKE_SCALE", "8.0"))
        grad, slow, kill, ckpt, spike, die = [], [], [], [], [], []
        slow_rep = []
        host_die, slowlink, partition = [], [], []
        crashloop = 0
        for raw in spec.split(","):
            tok = raw.strip().lower()
            if not tok:
                continue
            m = _SPEC_RE.match(tok)
            if m is None:
                raise ValueError(
                    f"bad chaos token {tok!r}; expected kind@step[*][:arg] "
                    f"with kind in "
                    f"{sorted(GRAD_FAULTS) + ['spike', 'die', 'slow', 'kill', 'crashloop'] + list(CKPT_FAULTS) + ['hostdie', 'slowlink', 'partition']}"
                )
            kind, step = m.group("kind"), int(m.group("step"))
            arg, arg2 = m.group("arg"), m.group("arg2")
            if arg2 is not None and kind not in ("slow", "slowlink", "partition"):
                raise ValueError(
                    f"chaos token {tok!r}: only slow@S:R:SEC, "
                    "slowlink@S:H:SEC and partition@S:H1-H2:SEC take two "
                    "colon args"
                )
            if kind in GRAD_FAULTS:
                grad.append((step, kind, bool(m.group("all"))))
            elif kind == "spike":
                window = int(float(arg)) if arg else 3
                if window < 1:
                    raise ValueError(f"spike window must be >= 1, got {window}")
                spike.append((step, window))
            elif kind == "die":
                rep = int(float(arg)) if arg else 0
                if rep < 0:
                    raise ValueError(f"die replica must be >= 0, got {rep}")
                die.append((step, rep))
            elif kind == "slow":
                if arg2 is not None:
                    rep, sec = int(float(arg)), float(arg2)
                    if rep < 0:
                        raise ValueError(f"slow replica must be >= 0, got {rep}")
                    if sec <= 0:
                        raise ValueError(f"slow replica delay must be > 0 s, got {sec}")
                    slow_rep.append((step, rep, sec))
                else:
                    slow.append((step, float(arg) if arg else 0.25))
            elif kind == "hostdie":
                host = int(float(arg)) if arg else 0
                if host < 0:
                    raise ValueError(f"hostdie host must be >= 0, got {host}")
                host_die.append((step, host))
            elif kind == "slowlink":
                if arg is None or arg2 is None:
                    raise ValueError(
                        f"chaos token {tok!r}: slowlink needs both args "
                        "(slowlink@ROUND:HOST:SEC)"
                    )
                host, sec = int(float(arg)), float(arg2)
                if host < 0:
                    raise ValueError(f"slowlink host must be >= 0, got {host}")
                if sec <= 0:
                    raise ValueError(f"slowlink delay must be > 0 s, got {sec}")
                slowlink.append((step, host, sec))
            elif kind == "partition":
                if arg is None or arg2 is None or "-" not in arg:
                    raise ValueError(
                        f"chaos token {tok!r}: partition needs a host "
                        "pair and a duration (partition@ROUND:H1-H2:SEC)"
                    )
                a, _, b = arg.partition("-")
                h1, h2 = int(float(a)), int(float(b))
                sec = float(arg2)
                if h1 < 0 or h2 < 0 or h1 == h2:
                    raise ValueError(
                        f"partition hosts must be distinct and >= 0, got {h1}-{h2}")
                if sec <= 0:
                    raise ValueError(f"partition duration must be > 0 s, got {sec}")
                partition.append((step, h1, h2, sec))
            elif kind == "kill":
                kill.append(step)
            elif kind == "crashloop":
                crashloop = max(crashloop, step)  # the @N slot counts doomed runs
            elif kind in CKPT_FAULTS:
                ckpt.append((step, kind))
            else:
                raise ValueError(f"unknown chaos fault kind {kind!r}")
        return cls(grad_faults=tuple(grad), slow_steps=tuple(slow), kill_steps=tuple(kill),
                   ckpt_faults=tuple(ckpt), spike_faults=tuple(spike), die_faults=tuple(die),
                   slow_replica_faults=tuple(slow_rep), host_die_faults=tuple(host_die),
                   slowlink_faults=tuple(slowlink), partition_faults=tuple(partition),
                   spike_scale=spike_scale, crashloop=crashloop, seed=seed)

    @classmethod
    def from_env(cls, environ=None) -> Optional["ChaosConfig"]:
        """The ATOMO_CHAOS spec, or None when it is unset or blank."""
        env = os.environ if environ is None else environ
        spec = env.get("ATOMO_CHAOS", "")
        if not spec.strip():
            return None
        return cls.from_spec(spec, environ=env)

    def enabled(self) -> bool:
        return bool(
            self.grad_faults or self.slow_steps or self.kill_steps
            or self.ckpt_faults or self.spike_faults or self.die_faults
            or self.slow_replica_faults or self.host_die_faults
            or self.slowlink_faults or self.partition_faults
            or self.crashloop
        )

    def fleet_kinds(self) -> list[str]:
        """The fleet lease faults this plan holds (``train`` refuses them)."""
        return [k for k, v in (("hostdie", self.host_die_faults),
                               ("slowlink", self.slowlink_faults),
                               ("partition", self.partition_faults)) if v]


class ChaosInjector:
    """Applies a :class:`ChaosConfig`. ``generation`` (the doctor's
    rollback counter) disarms every step-targeted fault above 0;
    ``membership_epoch`` (default: the ATOMO_MEMBERSHIP_EPOCH env) disarms
    ``die`` and ``slow@S:R:SEC`` above 0."""

    def __init__(self, config: ChaosConfig, generation: int = 0,
                 membership_epoch: Optional[int] = None):
        self.config = config
        self.generation = generation
        if membership_epoch is None:
            membership_epoch = int(os.environ.get(MEMBERSHIP_EPOCH_ENV, "0") or "0")
        self.membership_epoch = membership_epoch
        self._partition_t0: dict[int, float] = {}
        self._tables: dict = {}

    def with_generation(self, generation: int) -> "ChaosInjector":
        """The same plan at ``generation`` (the doctor's rebuilt steps)."""
        return ChaosInjector(self.config, generation=generation,
                             membership_epoch=self.membership_epoch)

    @classmethod
    def from_env(cls, environ=None) -> Optional["ChaosInjector"]:
        cfg = ChaosConfig.from_env(environ)
        return cls(cfg) if cfg is not None and cfg.enabled() else None

    # ---- gradient faults ----------------------------------------------

    def grad_fault_code(self, step: int) -> int:
        """The fault code of 1-based ``step`` (0 none, 1 nan, 2 inf, 3
        explode), ignoring replica targeting."""
        if self.generation:
            return 0
        return sum(GRAD_FAULTS[k] for s, k, _ in self.config.grad_faults if s == step)

    def prepare(self, device) -> None:
        """Put the gradient-fault table in ``device`` memory (once per
        device): the form a step given a device step counter reads."""
        import torch

        device = torch.device(device)
        if device in self._tables or not self.config.grad_faults:
            return
        faults = self.config.grad_faults
        self._tables[device] = (
            torch.tensor([f[0] for f in faults], dtype=torch.int64, device=device),
            torch.tensor([GRAD_FAULTS[f[1]] for f in faults], dtype=torch.int64,
                         device=device),
            torch.tensor([bool(f[2]) for f in faults], dtype=torch.bool, device=device),
        )

    def _on_target(self, replica) -> bool:
        tr = self.config.target_replica
        return tr < 0 or int(replica) == tr

    def inject_grads(self, grads, step, replica: Optional[int] = None) -> list:
        """``grads`` (a list of tensors) with the faults of 1-based ``step``
        applied. ``step`` is a 0-d integer tensor (a graph's device step
        counter, selected on the device from the table :meth:`prepare` put
        there, no host sync) or an int. With ``replica`` (this process's
        replica index) a gradient fault hits ``target_replica`` only, unless
        it was starred; ``spike`` hits every replica."""
        import torch

        if not torch.is_tensor(step):
            step = torch.tensor(int(step))  # a CPU scalar: no copy to the card
        grads = self._inject_die(list(grads), step, replica)
        if self.generation:
            return grads
        grads = self._inject_spike(grads, step)
        if not self.config.grad_faults:
            return grads
        device = grads[0].device
        self.prepare(device)
        steps, codes, alls = self._tables[device]
        match = steps == step
        code = torch.where(match, codes, torch.zeros_like(codes)).sum()
        if replica is not None and not self._on_target(replica):
            code = torch.where((match & alls).any(), code, torch.zeros_like(code))
        one = torch.ones((), dtype=torch.float32, device=device)
        # none: g * 1 + 0; explode: g * scale + 0; nan/inf: g * 1 + (nan | inf)
        mul = torch.where(code == 3, one * self.config.explode_scale, one)
        add = torch.where(code == 1, one * math.nan,
                          torch.where(code == 2, one * math.inf, one * 0.0))
        return [g * mul.to(g.dtype) + add.to(g.dtype) for g in grads]

    def _inject_die(self, grads, step, replica):
        """die@S:R: replica R's gradient + NaN from step S on (epoch 0 only;
        no replica, the single-device step, disarms it)."""
        if not self.config.die_faults or self.membership_epoch or replica is None:
            return grads
        import torch

        active = torch.zeros((), dtype=torch.bool, device=step.device)
        for start, target in self.config.die_faults:
            if target == int(replica):
                active = active | (step >= start)
        add = torch.where(active, torch.full((), math.nan, device=step.device),
                          torch.zeros((), device=step.device))
        return [g + add.to(g.dtype) for g in grads]

    def _inject_spike(self, grads, step):
        """spike@S:W: every replica's gradient times ``spike_scale`` for the
        steps in [S, S + W)."""
        if not self.config.spike_faults:
            return grads
        import torch

        active = torch.zeros((), dtype=torch.bool, device=step.device)
        for start, window in self.config.spike_faults:
            active = active | ((step >= start) & (step < start + window))
        mul = torch.where(active, torch.full((), self.config.spike_scale, device=step.device),
                          torch.ones((), device=step.device))
        return [g * mul.to(g.dtype) for g in grads]

    # ---- host faults --------------------------------------------------

    def maybe_die_crashloop(self, attempt: Optional[int] = None) -> None:
        """crashloop@M: exit at loop start while the run attempt is below M."""
        m = self.config.crashloop
        if not m:
            return
        if attempt is None:
            attempt = int(os.environ.get(ATTEMPT_ENV, "0"))
        if attempt < m:
            print(f"CHAOS: crashloop killing run attempt {attempt} "
                  f"(dies until attempt {m}; exit {self.config.exit_code})",
                  file=sys.stderr, flush=True)
            os._exit(self.config.exit_code)

    def maybe_sleep(self, step: int) -> float:
        """Sleep when a slow@S:SEC fault targets ``step``; the seconds slept."""
        if self.generation:
            return 0.0
        total = 0.0
        for s, sec in self.config.slow_steps:
            if s == step:
                time.sleep(sec)
                total += sec
        return total

    def replica_delays(self, step: int, n_dev: int) -> list[float]:
        """Each replica's straggler lag at ``step`` from the slow@S:R:SEC
        faults (epoch 0 only, generations ignored)."""
        delays = [0.0] * n_dev
        if self.membership_epoch:
            return delays
        for start, rep, sec in self.config.slow_replica_faults:
            if step >= start and rep < n_dev:
                delays[rep] = max(delays[rep], sec)
        return delays

    def maybe_sleep_replica(self, step: int, n_dev: int) -> float:
        """The blocking exchange waits for its slowest replica: sleep the
        largest active lag before ``step``; the seconds slept."""
        lag = max(self.replica_delays(step, n_dev), default=0.0)
        if lag > 0:
            time.sleep(lag)
        return lag

    def maybe_hostdie(self, round_no: int, host_id: int) -> None:
        if self.membership_epoch:
            return
        for s, h in self.config.host_die_faults:
            if round_no >= s and h == host_id:
                print(f"CHAOS: host {host_id} dying at fleet round {round_no} "
                      f"(exit {self.config.exit_code})", file=sys.stderr, flush=True)
                os._exit(self.config.exit_code)

    def slowlink_delay(self, round_no: int, host_id: int) -> float:
        if self.membership_epoch:
            return 0.0
        lag = 0.0
        for s, h, sec in self.config.slowlink_faults:
            if round_no >= s and h == host_id:
                lag = max(lag, sec)
        return lag

    def store_partitioned(self, round_no: int, host_id: int, *, now=None) -> bool:
        if self.membership_epoch:
            return False
        clock = now if now is not None else time.monotonic
        for i, (s, h1, h2, sec) in enumerate(self.config.partition_faults):
            if host_id != max(h1, h2) or round_no < s:
                continue
            t0 = self._partition_t0.setdefault(i, clock())
            if clock() - t0 < sec:
                return True
        return False

    def should_die(self, step: int) -> bool:
        """kill@S, on run attempt 0 only: a restarted attempt gets past S."""
        if self.generation or step not in self.config.kill_steps:
            return False
        return int(os.environ.get(ATTEMPT_ENV, "0") or "0") == 0

    def maybe_die(self, step: int) -> None:
        """Hard-exit before ``step`` runs (no finally blocks, no atexit)."""
        if self.should_die(step):
            print(f"CHAOS: killing process before step {step} "
                  f"(exit {self.config.exit_code})", file=sys.stderr, flush=True)
            os._exit(self.config.exit_code)

    def ckpt_fault_for(self, step: int) -> Optional[str]:
        if self.generation:
            return None
        for s, kind in self.config.ckpt_faults:
            if s == step:
                return kind
        return None

    def maybe_corrupt_checkpoint(self, path: str, step: int) -> Optional[str]:
        """Damage a just-written checkpoint as the plan says."""
        kind = self.ckpt_fault_for(step)
        if kind is None:
            return None
        corrupt_file(path, kind, seed=self.config.seed ^ step)
        print(f"CHAOS: corrupted checkpoint {path} ({kind})", file=sys.stderr, flush=True)
        return kind


def corrupt_file(path: str, kind: str, seed: int = 0) -> None:
    """Damage a file in place, deterministically: ``truncate`` keeps the
    first 40 %, ``bitflip`` flips one seeded bit past the 8-byte header (the
    CRC must catch it), ``badmagic`` overwrites the first 4 bytes."""
    import numpy as np

    with open(path, "rb") as f:
        blob = bytearray(f.read())
    if kind == "truncate":
        blob = blob[:max(9, int(len(blob) * 0.4))]
    elif kind == "bitflip":
        if len(blob) <= 8:
            raise ValueError(f"{path!r} too small to bitflip past its header")
        rng = np.random.default_rng(seed)
        pos = 8 + int(rng.integers(0, len(blob) - 8))
        blob[pos] ^= 1 << int(rng.integers(0, 8))
    elif kind == "badmagic":
        blob[:4] = b"XXXX"
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    tmp = path + ".chaos"
    with open(tmp, "wb") as f:
        f.write(bytes(blob))
    os.replace(tmp, path)
