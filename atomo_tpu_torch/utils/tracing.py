"""The incident log, the run-protocol names of the resilience stack, and the
profiler window.

Counterpart of ``atomo_tpu/utils/tracing.py``: the environment names the
supervisor hands its children (:data:`ATTEMPT_ENV`,
:data:`MEMBERSHIP_EPOCH_ENV`), the atomic JSON writer, the tolerant JSONL
reader, :class:`IncidentLog`, the machine-readable post-mortem of a run
(``train_dir/incidents.jsonl``: every divergence alarm, rollback, retried
save, supervised restart and give-up is one JSON line there, the JAX
package's schema key for key, so each package reads the other's file), and
:func:`profile` (``:134-143``), the trace window of ``--profile-dir`` that
``report timeline`` (:mod:`atomo_tpu_torch.obs.timeline`) reads.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Iterator, Optional

TRACE_SUFFIX = ".pt.trace.json"

# the supervisor's 0-based run attempt on each child (run_supervised sets
# it, utils.chaos keys crashloop@M and kill@S on it)
ATTEMPT_ENV = "ATOMO_RUN_ATTEMPT"
# the membership epoch of a child re-executed across a reshape; chaos keys
# die@S:R and slow@S:R:SEC on it (they fire at epoch 0 only)
MEMBERSHIP_EPOCH_ENV = "ATOMO_MEMBERSHIP_EPOCH"

# the pointer every --phase-metrics conflict carries in the JAX package;
# the doctor's conflict matrix quotes it, so the text stays the same here
PHASE_METRICS_HINT = (
    " (deprecated mode — the trace-based replacement observes fused "
    "programs: run with --profile-dir and use `report timeline`)"
)

INCIDENT_LOG_NAME = "incidents.jsonl"


def write_json_atomic(path: str, obj) -> None:
    """Write ``obj`` as JSON through a temporary file and ``os.replace``:
    a reader never sees a torn file, even after a kill mid-write."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


@contextlib.contextmanager
def profile(log_dir: str, device=None) -> Iterator:
    """Capture a ``torch.profiler`` trace around a block: the CPU activity
    (the host's operator events and the ``step.*`` ranges), plus the CUDA
    activity when ``device`` is a card (kernels, copies and sets, each
    linked to the runtime call that launched it by its ``correlation`` id).
    On exit (the device synchronized first) it writes one Chrome trace,
    ``<host>_<pid>.<unix ns>.pt.trace.json``, under ``log_dir``; the
    trace's ``baseTimeNanoseconds`` plus an event's ``ts`` (microseconds) is
    the event's unix time. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = device is not None and torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = torch_profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.__exit__(None, None, None)
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}{TRACE_SUFFIX}"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def read_jsonl(path: str) -> list[dict]:
    """Every JSON object line of ``path``: a missing file is an empty
    history, and torn lines (a write cut by a kill) are skipped."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def format_incident(r: dict) -> str:
    """One incident record as one human line."""
    bits = [f"+{r.get('uptime_s', 0.0):.1f}s", r.get("cause", "?")]
    for key in ("step", "target", "attempt", "epoch", "world", "rc"):
        if key in r:
            bits.append(f"{key}={r[key]}")
    if r.get("action"):
        bits.append(f"-> {r['action']}")
    return " ".join(bits)


class IncidentLog:
    """Append-only JSONL incident stream. Every record carries ``ts`` (unix
    seconds), ``uptime_s`` (seconds since this writer opened the log),
    ``cause`` and ``action``, and optionally ``step``, ``target``,
    ``attempt`` and any keyword detail. A record is one ``write()`` of one
    line in append mode, so the trainer and its supervisor interleave at
    line granularity and the file always parses."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.time()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    @classmethod
    def for_train_dir(cls, train_dir: str) -> "IncidentLog":
        return cls(os.path.join(train_dir, INCIDENT_LOG_NAME))

    def append(self, cause: str, *, action: str = "", step: Optional[int] = None,
               target: Optional[int] = None, attempt: Optional[int] = None,
               **detail) -> dict:
        now = time.time()
        rec = {"ts": round(now, 3), "uptime_s": round(now - self._t0, 3), "cause": cause,
               "action": action}
        if step is not None:
            rec["step"] = int(step)
        if target is not None:
            rec["target"] = int(target)
        if attempt is not None:
            rec["attempt"] = int(attempt)
        rec.update(detail)
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as exc:
            # incidents are often recorded while the filesystem misbehaves:
            # the post-mortem must never crash the run it documents
            import warnings

            warnings.warn(f"incident log append failed: {exc}")
        return rec

    @staticmethod
    def read(path: str) -> list[dict]:
        return read_jsonl(path)

    @staticmethod
    def summarize(path: str) -> str:
        """One line per incident, oldest first."""
        recs = IncidentLog.read(path)
        if not recs:
            return f"no incidents recorded in {path!r}"
        lines = [f"incident log {path} ({len(recs)} records):"]
        lines.extend("  " + format_incident(r) for r in recs)
        return "\n".join(lines)
