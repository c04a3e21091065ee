"""``train_dir/fabric_probe.json``: the measured fabric's artifact, read.

Counterpart of ``atomo_tpu/obs/fabric.py:58,74-85``: the artifact's name,
its path and its tolerant reader, which :mod:`atomo_tpu_torch.obs.report`
opens. The probe that writes it (``--fabric measured``) is not ported yet
(ROADMAP queue 1 item 7e), so a port run has no such file and the report's
fabric check reports skipped.
"""

from __future__ import annotations

import json
import os
from typing import Optional

FABRIC_PROBE_NAME = "fabric_probe.json"


def probe_path(train_dir: str) -> str:
    return os.path.join(train_dir, FABRIC_PROBE_NAME)


def read_fabric_probe(train_dir: str) -> Optional[dict]:
    """The recorded probe document, or None when it is absent or does not
    parse (a torn artifact is no measurement, never a crash)."""
    try:
        with open(probe_path(train_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None
