"""``train_dir/arrival_schedule.jsonl``: the quorum run's replay anchor.

Counterpart of ``atomo_tpu/quorum/artifact.py``: the file's name and path,
its append-only writer, its reader and the resume's cut. The schema is the
JAX package's, one JSON object a line, so each package reads the other's
file::

    {"kind": "meta", "what": "quorum_config", "quorum": Q, "staleness": K,
     "n_replicas": N, "period_s": P}
    {"kind": "arrival", "step": s, "staleness": [...], "kept": k,
     "dropped": d, "exposed_wait_ms": w}

A staleness entry is >= 0 (present at that staleness), -1 (dropped: the
bound exceeded) or -2 (absent: warm-up). The meta header pins the knobs the
vectors were derived under; the rig refuses to adopt a file recorded under
other ones.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

ARRIVAL_SCHEDULE_NAME = "arrival_schedule.jsonl"


def schedule_path(train_dir: str) -> str:
    return os.path.join(train_dir, ARRIVAL_SCHEDULE_NAME)


def append_record(path: str, rec: dict) -> None:
    """One newline-terminated line a record, one ``write()`` a line (the
    append-only artifact discipline). An unwritable file warns: it costs
    the run its replay anchor, never its training."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError as exc:
        print(f"WARNING: could not append to {path}: {exc}", file=sys.stderr)


def read_schedule(path: str):
    """``(meta or None, {step: arrival record})`` of an arrival schedule; a
    missing file is empty and a torn line (a writer killed mid-append) is
    skipped."""
    meta: Optional[dict] = None
    arrivals: dict = {}
    if not os.path.exists(path):
        return meta, arrivals
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("kind") == "meta":
                meta = rec
            elif rec.get("kind") == "arrival" and "step" in rec:
                arrivals[int(rec["step"])] = rec
    return meta, arrivals


def prune_schedule_after(train_dir: str, step: int) -> None:
    """Cut every arrival record past ``step`` by an atomic rewrite (the meta
    header, which has no step, stays): a resumed run re-records the steps
    above its checkpoint instead of duplicating the killed attempt's."""
    from atomo_tpu_torch.obs.recorder import _prune_file_after

    _prune_file_after(schedule_path(train_dir), step)
