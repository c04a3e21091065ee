"""``train_dir/controller_decision.json``: the controller's decision, read.

Counterpart of ``atomo_tpu/controller/artifact.py:39-55`` (the file's name,
its path and its reader), which :mod:`atomo_tpu_torch.obs.report` and
:func:`atomo_tpu_torch.obs.recorder.resolve_predicted_ms` open. The
controller that writes it (``--auto controller``) is not ported yet (ROADMAP
queue 1 item 12).
"""

from __future__ import annotations

import json
import os
from typing import Optional

CONTROLLER_DECISION_NAME = "controller_decision.json"


def controller_path(train_dir: str) -> str:
    return os.path.join(train_dir, CONTROLLER_DECISION_NAME)


def read_controller(train_dir: Optional[str]) -> Optional[dict]:
    """The decision document, or None when it is absent or does not parse."""
    if not train_dir:
        return None
    try:
        with open(controller_path(train_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
