"""The flight recorder: one JSON line a training step (``metrics.jsonl``).

Counterpart of ``atomo_tpu/obs/recorder.py``. The records are the JAX
package's key for key (README "Observability"), so each package reads the
other's file. A run appends to ``train_dir/metrics.jsonl`` with the incident
log's discipline (append-only, one ``write()`` per append, torn trailing
lines skipped on read), and the file is cut in lockstep with the checkpoint
timeline on rollback (:func:`atomo_tpu_torch.training.checkpoint.prune_after`
calls :func:`prune_metrics_after`) and on resume (:meth:`FlightRecorder.
prune_past`).

Record kinds (every record carries ``kind``):

``step``
    one training step: ``step``, ``loss``, ``step_ms`` (the host wall's
    per-step share: a superstep block's wall divided into K equal shares),
    the guard's ``skipped`` / ``dropped``, ``msg_bytes`` / ``dense_bytes``,
    ``grad_norm`` (when the doctor tracks it), the per-layer estimator
    quality columns ``q_err2`` / ``q_rel`` (``--obs-quality``), the
    ``aggregate`` mode in effect, ``epoch`` (membership) and ``generation``
    (chaos / rollback), and, given a prediction, the rolling
    predicted-vs-measured calibration column (``predicted_ms`` / ``calib``,
    :func:`~atomo_tpu_torch.utils.comm_model.rolling_calibration`). The JAX
    package's drift (``drift_ms`` / ``drift_hot``) and per-tier
    (``calib_tiers``) columns come from its online tuner, which the port
    does not have yet (ROADMAP queue 1 item 12).
``log``
    the reference worker line, structured: the same ``StepMetrics`` record
    the stdout line is formatted from (:func:`emit_worker_line`, one sink).
``meta``
    one-off run context (the per-layer byte split of ``--obs-quality``,
    :func:`atomo_tpu_torch.obs.quality.quality_meta`; each allocation epoch
    of ``--budget-alloc variance``; the ``profile_window`` of
    ``--profile-dir``, the steps its trace covers).

Cost: disarmed (no recorder) the loops add no device work and print what
they printed before; armed, the block loops ride the one metric fetch a
block they already make, and the per-step loops make one fetch a step.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Any, Optional

import numpy as np

from atomo_tpu_torch.utils.comm_model import rolling_calibration
from atomo_tpu_torch.utils.tracing import MEMBERSHIP_EPOCH_ENV, read_jsonl

METRICS_FILE_NAME = "metrics.jsonl"

# metric keys copied (per-step scalar) into each ``step`` record when the
# fetched metrics carry them; absent keys stay absent
_SCALAR_KEYS = (
    "loss",
    "prec1",
    "prec5",
    "msg_bytes",
    "dense_bytes",
    "skipped",
    "dropped",
    "grad_norm",
    "ok_bits",
    "ef_res_norm",
    "quorum_kept",
    "stale_dropped",
)
# per-layer vector columns (the --obs-quality probes): recorded as lists
_VECTOR_KEYS = ("q_err2", "q_rel")


def metrics_path(train_dir: str) -> str:
    return os.path.join(train_dir, METRICS_FILE_NAME)


def resolve_predicted_ms(train_dir: Optional[str]) -> Optional[float]:
    """The calibration column's reference: the decision winner's predicted
    ms a step, from ``train_dir/controller_decision.json`` when present,
    else ``tune_decision.json``, else None (no prediction, no column)."""
    if not train_dir:
        return None
    from atomo_tpu_torch.controller.artifact import controller_path
    from atomo_tpu_torch.tuning.autopilot import decision_path

    doc = None
    for path in (controller_path(train_dir), decision_path(train_dir)):
        try:
            with open(path) as f:
                doc = json.load(f)
            break
        except (OSError, ValueError):
            continue
    win = (doc or {}).get("winner") or {}
    pred = win.get("predicted_ms_per_step")
    return float(pred) if isinstance(pred, (int, float)) and pred > 0 else None


def _env_membership_epoch() -> int:
    try:
        return int(os.environ.get(MEMBERSHIP_EPOCH_ENV, "0") or 0)
    except ValueError:
        return 0


def _sanitize(obj):
    """Non-finite floats -> None, recursively: a diverged step must not make
    the file unparseable to strict JSON readers."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


class FlightRecorder:
    """Append-only per-step telemetry (see the module docstring). One
    recorder a run process; the context fields (``aggregate``, the
    membership ``epoch``, extras) set by :meth:`set_context` are stamped on
    every later record. ``predicted_ms`` (a decision's predicted ms a step)
    arms the calibration column."""

    def __init__(self, path: str, predicted_ms: Optional[float] = None):
        self.path = path
        self.predicted_ms = (float(predicted_ms)
                             if predicted_ms is not None and predicted_ms > 0 else None)
        self._calib: Optional[float] = None
        self.context: dict = {"epoch": _env_membership_epoch()}
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    @classmethod
    def for_train_dir(cls, train_dir: str,
                      predicted_ms: Optional[float] = None) -> "FlightRecorder":
        return cls(metrics_path(train_dir), predicted_ms=predicted_ms)

    def set_context(self, **kw) -> "FlightRecorder":
        """Merge context fields stamped on every later record (None deletes
        the field)."""
        for k, v in kw.items():
            if v is None:
                self.context.pop(k, None)
            else:
                self.context[k] = v
        return self

    # -- writes ---------------------------------------------------------

    def _append_lines(self, records: list) -> None:
        if not records:
            return
        payload = "".join(json.dumps(_sanitize(r), allow_nan=False) + "\n" for r in records)
        try:
            with open(self.path, "a") as f:
                f.write(payload)
        except OSError as exc:
            # telemetry is written when the filesystem may misbehave: it
            # must never crash the run it documents
            warnings.warn(f"flight recorder append failed: {exc}")

    def write_meta(self, meta: dict) -> None:
        """One ``meta`` record, idempotent per ``what``: a resumed or
        restarted attempt re-arms against the same file (``prune_past``
        keeps meta lines), and must not append a duplicate."""
        what = meta.get("what")
        if what is not None and any(r.get("kind") == "meta" and r.get("what") == what
                                    for r in read_jsonl(self.path)):
            return
        self._append_lines([{"kind": "meta", "ts": round(time.time(), 3), **meta}])

    def record_block(self, first_step: int, metrics: Any, *, wall_s: Optional[float] = None,
                     generation: Optional[int] = None) -> list:
        """Append one ``step`` record per step of a fetched metrics dict:
        per-step scalars (the per-step loops), or ``(K,)`` series and
        ``(K, L)`` per-layer series (the block loops). ``wall_s``, the host
        wall spanning the block, is recorded as K equal shares
        (``step_ms``), so any block partition of a run writes the same
        records with the same total wall. ``generation`` is the doctor's
        chaos / rollback generation. Returns the records written."""
        losses = np.asarray(metrics["loss"]).reshape(-1)
        k = int(losses.size)
        if k == 0:
            return []
        share_ms = (float(wall_s) / k * 1e3) if wall_s is not None else None

        def col(name, i):
            v = metrics.get(name)
            if v is None:
                return None
            a = np.asarray(v)
            if a.ndim == 0:
                return a.item()
            if k == 1:  # a per-step fetch: the whole value belongs to this step
                return a.item() if a.size == 1 else a
            return a[i]

        now = round(time.time(), 3)
        records = []
        for i in range(k):
            rec = {"kind": "step", "ts": now, "step": int(first_step) + i}
            for name in _SCALAR_KEYS:
                v = col(name, i)
                if v is not None:
                    rec[name] = float(v)
            for name in _VECTOR_KEYS:
                v = col(name, i)
                if v is not None:
                    rec[name] = [float(x) for x in np.asarray(v).reshape(-1)]
            if share_ms is not None:
                rec["step_ms"] = round(share_ms, 4)
                if self.predicted_ms is not None:
                    self._calib = rolling_calibration(self._calib, share_ms / 1e3,
                                                      self.predicted_ms / 1e3)
                    rec["predicted_ms"] = self.predicted_ms
                    if self._calib is not None:
                        rec["calib"] = round(self._calib, 4)
            if generation is not None:
                rec["generation"] = int(generation)
            rec.update(self.context)
            records.append(rec)
        self._append_lines(records)
        return records

    def record_log(self, step_metrics) -> dict:
        """Append the worker-line record (``kind="log"``); called only by
        :func:`emit_worker_line`."""
        rec = {"kind": "log", "ts": round(time.time(), 3), **dataclasses.asdict(step_metrics)}
        # StepMetrics has its own ``epoch`` (the dataset's): the membership
        # epoch of the context must not overwrite it
        rec.update({k: v for k, v in self.context.items() if k != "epoch"})
        self._append_lines([rec])
        return rec

    # -- reads ----------------------------------------------------------

    @staticmethod
    def read(path: str) -> list:
        """Every record of a metrics.jsonl (a missing file is empty, torn
        lines are skipped)."""
        return read_jsonl(path)

    @staticmethod
    def read_steps(path: str) -> list:
        """The ``step`` records only, in file order."""
        return [r for r in read_jsonl(path) if r.get("kind") == "step"]

    def prune_past(self, step: int) -> int:
        """Drop the records past ``step`` from this recorder's file: the
        resume hook (a restarted attempt replays the steps above its
        checkpoint, so the killed attempt's tail goes first)."""
        return _prune_file_after(self.path, step)


def emit_worker_line(recorder: Optional[FlightRecorder], rec, log_fn=print) -> None:
    """The one worker-line sink: stdout and metrics.jsonl are fed from the
    same ``StepMetrics`` record. With ``recorder`` None this is exactly
    ``log_fn(rec.worker_line())``."""
    log_fn(rec.worker_line())
    if recorder is not None:
        recorder.record_log(rec)


def prune_metrics_after(train_dir: Optional[str], step: int) -> int:
    """Cut the metrics timeline in lockstep with the checkpoints: drop every
    record whose ``step`` exceeds ``step`` (meta lines, which have none, are
    kept), by an atomic rewrite. Returns the records removed (0 without a
    file)."""
    if not train_dir:
        return 0
    return _prune_file_after(metrics_path(train_dir), step)


def _prune_file_after(path: str, step: int) -> int:
    if not os.path.exists(path):
        return 0
    recs = read_jsonl(path)
    keep = [r for r in recs if "step" not in r or int(r["step"]) <= int(step)]
    removed = len(recs) - len(keep)
    if removed == 0:
        return 0
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in keep))
        os.replace(tmp, path)
    except OSError as exc:
        warnings.warn(f"flight recorder prune failed: {exc}")
        return 0
    return removed
