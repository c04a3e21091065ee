"""``train_dir/tune_decision.json``: the autopilot decision's name and path.

Counterpart of ``atomo_tpu/tuning/autopilot.py:51,634-635``, which
:func:`atomo_tpu_torch.obs.recorder.resolve_predicted_ms` and the run report
read. The autopilot itself (``--auto tune``) is not ported yet (ROADMAP
queue 1 item 12).
"""

from __future__ import annotations

import os

TUNE_DECISION_NAME = "tune_decision.json"


def decision_path(train_dir: str) -> str:
    return os.path.join(train_dir, TUNE_DECISION_NAME)
