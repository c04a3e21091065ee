"""Observability of the port: the flight recorder, the estimator-quality
probes and the run report.

Counterpart of ``atomo_tpu/obs/`` (ROADMAP queue 1 items 7a-7f, the fleet
report aside):

* :mod:`~atomo_tpu_torch.obs.recorder`: ``FlightRecorder``, one JSON line a
  training step into ``train_dir/metrics.jsonl`` (``train --obs-record``;
  ``lm`` whenever it has a ``--train-dir``);
* :mod:`~atomo_tpu_torch.obs.quality`: the per-layer estimator error of
  the codec inside the step (``train --obs-quality``);
* :mod:`~atomo_tpu_torch.obs.report`: the ``report`` verb's run mode, every
  artifact of a run joined into ``run_report.json`` with consistency checks;
* :mod:`~atomo_tpu_torch.obs.fabric`: the measured fabric
  (``train --fabric measured``): the startup probe of the run's process
  group and its ``fabric_probe.json``;
* :mod:`~atomo_tpu_torch.obs.timeline`: the trace-based phase timeline
  (``train --profile-dir``, ``report timeline``).
"""

from atomo_tpu_torch.obs.fabric import (  # noqa: F401
    FABRIC_PROBE_NAME,
    probe_path,
    read_fabric_probe,
)
from atomo_tpu_torch.obs.recorder import (  # noqa: F401
    METRICS_FILE_NAME,
    FlightRecorder,
    emit_worker_line,
    metrics_path,
    prune_metrics_after,
)
