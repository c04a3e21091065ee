"""``train_dir/arrival_schedule.jsonl``: the quorum run's replay anchor, read.

Counterpart of ``atomo_tpu/quorum/artifact.py:31-81`` (the file's name, its
path and its reader), which :mod:`atomo_tpu_torch.obs.report` opens. The
schema is the JAX package's, one JSON object a line::

    {"kind": "meta", "what": "quorum_config", "quorum": Q, "staleness": K,
     "n_replicas": N, "period_s": P}
    {"kind": "arrival", "step": s, "staleness": [...], "kept": k,
     "dropped": d, "exposed_wait_ms": w}

The quorum mode that writes it is not ported yet (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import json
import os
from typing import Optional

ARRIVAL_SCHEDULE_NAME = "arrival_schedule.jsonl"


def schedule_path(train_dir: str) -> str:
    return os.path.join(train_dir, ARRIVAL_SCHEDULE_NAME)


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
