"""Bounded-staleness quorum aggregation (``--quorum Q --staleness K``).

Counterpart of ``atomo_tpu/quorum/__init__.py``. Each step consumes, per
replica, the freshest payload that has arrived: an on-time replica
contributes this step's encode, a straggler's payload rides a per-rank ring
of K + 1 encoded payloads, at most K steps stale. A payload older than K is
dropped and counted (one ``staleness_exceeded`` incident a drop; the bound
also holds inside the step, where a staleness outside [0, K] selects
nothing). The surviving mean is the survivor-exact operator
(:func:`atomo_tpu_torch.elastic.shrink.survivor_decode_mean`: a masked
decode, a fold in roster order, one division by the kept count), and a
step keeps at least Q arrivals: when drops or warm-up leave fewer, the rig
waits for the nearest stragglers' fresh payloads.

Arrival is modelled, not raced: the host decides each step's per-replica
staleness vector as a pure function of the chaos ``slow@S:R:SEC`` table and
the step (:mod:`.schedule`), sleeps the exposed wait it implies, records it
to ``train_dir/arrival_schedule.jsonl`` (:mod:`.artifact`) and hands it to
the step (:mod:`.rig`). The same schedule in gives the same trajectory out
(``--replay-arrivals`` feeds a recorded one back in), and the wire equals
blocking's: one payload a rank moves each step, whatever its staleness.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuorumConfig:
    """The quorum family's knobs, validated once: ``quorum`` (Q) the fewest
    payloads a step consumes, ``staleness`` (K) the hard bound on a
    payload's age in steps, ``period_s`` the modelled seconds a step that
    turn a straggler's lag into a staleness (recorded in the schedule's
    header)."""

    quorum: int
    staleness: int = 1
    period_s: float = 0.1

    def __post_init__(self):
        if self.quorum < 1:
            raise ValueError(
                f"--quorum must be >= 1 (got {self.quorum}); a step that "
                "waits for zero arrivals has nothing to average"
            )
        if self.staleness < 0:
            raise ValueError(
                f"--staleness must be >= 0, got {self.staleness}"
            )
        if self.period_s <= 0:
            raise ValueError(
                f"quorum period must be > 0 s, got {self.period_s}"
            )


from atomo_tpu_torch.quorum.artifact import (  # noqa: E402
    ARRIVAL_SCHEDULE_NAME,
    prune_schedule_after,
    read_schedule,
    schedule_path,
)
from atomo_tpu_torch.quorum.rig import QuorumRig  # noqa: E402
from atomo_tpu_torch.quorum.schedule import (  # noqa: E402
    ABSENT,
    DROPPED,
    staleness_vector,
)

__all__ = [
    "ABSENT",
    "ARRIVAL_SCHEDULE_NAME",
    "DROPPED",
    "QuorumConfig",
    "QuorumRig",
    "prune_schedule_after",
    "read_schedule",
    "schedule_path",
    "staleness_vector",
]
