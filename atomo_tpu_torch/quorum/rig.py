"""The host side of quorum: schedule, wait, record, replay.

Counterpart of ``atomo_tpu/quorum/rig.py``. The quorum step takes each
step's (N,) staleness vector as an input; :class:`QuorumRig` is its one
producer:

* live: the vector from the chaos ``slow@S:R:SEC`` table
  (:func:`~atomo_tpu_torch.quorum.schedule.staleness_vector`), the exposed
  wait slept here (the rig owns the straggler wait: the chaos blocking
  sleep stands down while a rig is armed), the record appended to
  ``arrival_schedule.jsonl``;
* replay (``--replay-arrivals``): the vectors read back from a recorded
  schedule, with no wait (the trajectory depends on the vectors alone), and
  re-recorded into this run's own file.

Every DROPPED entry lands one ``staleness_exceeded`` incident (action
``drop``, the replica as target), which ``report``'s
``quorum_schedule_consistent`` check reconciles with the schedule.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from atomo_tpu_torch.quorum.artifact import (
    append_record,
    prune_schedule_after,
    read_schedule,
    schedule_path,
)
from atomo_tpu_torch.quorum.schedule import DROPPED, staleness_vector


class QuorumRig:
    def __init__(
        self,
        config,
        *,
        n_dev: int,
        train_dir: Optional[str] = None,
        chaos=None,
        incidents=None,
        replay_path: Optional[str] = None,
        log_fn=print,
        write: bool = True,
    ):
        """``write`` False derives the same vectors (and sleeps the same
        waits) without touching the file or the incidents: every rank of a
        group runs a rig, and rank 0 alone writes."""
        if config.quorum > n_dev:
            raise ValueError(
                f"--quorum {config.quorum} exceeds the {n_dev}-replica "
                "mesh: a step can never collect more arrivals than there "
                "are replicas"
            )
        self.config = config
        self.n_dev = n_dev
        self.train_dir = train_dir
        self.incidents = incidents if write else None
        self.log_fn = log_fn
        self.faults = ()
        if chaos is not None and not chaos.membership_epoch:
            # die@'s epoch keying: a reshaped world starts clean
            self.faults = chaos.config.slow_replica_faults
        self._replay: Optional[dict] = None
        if replay_path:
            meta, arrivals = read_schedule(replay_path)
            if not arrivals:
                raise ValueError(
                    f"--replay-arrivals {replay_path!r}: no arrival "
                    "records found (not a recorded quorum schedule?)"
                )
            self._check_meta(meta, replay_path)
            self._replay = arrivals
        self._own_path = None
        if train_dir:
            own = schedule_path(train_dir)
            rp = os.path.abspath(replay_path) if replay_path else None
            if rp != os.path.abspath(own):
                # (replaying a directory's own schedule in place would
                # duplicate every line it reads)
                meta, _ = read_schedule(own)
                self._check_meta(meta, own)
                if write:
                    self._own_path = own
                    if meta is None:
                        append_record(own, self._meta_record())

    def _meta_record(self) -> dict:
        return {
            "kind": "meta",
            "what": "quorum_config",
            "quorum": self.config.quorum,
            "staleness": self.config.staleness,
            "n_replicas": self.n_dev,
            "period_s": self.config.period_s,
        }

    def _check_meta(self, meta: Optional[dict], path: str) -> None:
        """Refuse knobs that disagree with a recorded schedule: vectors
        derived under one (Q, K, N, period) mean something else under
        another."""
        if meta is None:
            return
        want = self._meta_record()
        for k in ("quorum", "staleness", "n_replicas", "period_s"):
            if meta.get(k) != want[k]:
                raise ValueError(
                    f"quorum schedule {path!r} was recorded with "
                    f"{k}={meta.get(k)!r} but this run sets {want[k]!r}; "
                    "match the recorded knobs or remove the artifact — "
                    "refusing to mix schedules"
                )

    def prune_past(self, step: int) -> None:
        """The resume's cut: the killed attempt's records past the restart
        checkpoint go, so the replayed steps re-record their lines."""
        if self.train_dir and self._own_path is not None:
            prune_schedule_after(self.train_dir, step)

    def begin_step(self, step: int) -> np.ndarray:
        """Step ``step``'s staleness vector ((N,) int32): in live mode the
        exposed wait slept, the record appended, an incident a drop."""
        if self._replay is not None:
            rec = self._replay.get(step)
            if rec is None:
                raise ValueError(
                    f"--replay-arrivals: recorded schedule has no step "
                    f"{step} — the replay ran past (or resumed before) "
                    "the recorded run's range"
                )
            sigma = [int(x) for x in rec["staleness"]]
            if len(sigma) != self.n_dev:
                raise ValueError(
                    f"--replay-arrivals: step {step} records "
                    f"{len(sigma)} replicas, this run has {self.n_dev}"
                )
            drops = [(r, None) for r, s in enumerate(sigma) if s == DROPPED]
        else:
            sigma, exposed, drops = staleness_vector(
                step,
                n_dev=self.n_dev,
                quorum=self.config.quorum,
                staleness=self.config.staleness,
                faults=self.faults,
                period_s=self.config.period_s,
            )
            if exposed > 0:
                # the Q-th arrival's exposure, not the blocking maximum
                time.sleep(exposed)
            rec = {
                "kind": "arrival",
                "step": step,
                "staleness": list(sigma),
                "kept": sum(1 for s in sigma if s >= 0),
                "dropped": sum(1 for s in sigma if s == DROPPED),
                "exposed_wait_ms": round(exposed * 1e3, 3),
            }
        if self._own_path is not None:
            append_record(self._own_path, rec)
        if self.incidents is not None:
            for rep, avail in drops:
                detail = {"bound": self.config.staleness}
                if avail is not None:
                    detail["available_staleness"] = avail
                self.incidents.append(
                    "staleness_exceeded",
                    action="drop",
                    step=step,
                    target=rep,
                    **detail,
                )
        return np.asarray(sigma, np.int32)
