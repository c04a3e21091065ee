"""The arrival schedule: a pure function of (fault table, step).

Counterpart of ``atomo_tpu/quorum/schedule.py``, the same arithmetic line
for line. A replica slowed by SEC seconds from step S on has a lag of ``L =
ceil(SEC / period_s)`` steps (at least 1); at consuming step s its freshest
arrived payload is this step's while s < S, then ``min(s - S + 1, L)``
steps stale. Above the bound K the payload is DROPPED (-1, counted); a
staleness reaching before the run's first step is ABSENT (-2, warm-up, not
a drop). While fewer than Q payloads are present the quorum floor waits
for the replicas of smallest lag instead (staleness 0), and the step's
exposed wait is the largest lag waited on: the Q-th order statistic of the
lags, what ``utils.comm_model.quorum_exposed_wait_s`` prices.
"""

from __future__ import annotations

import math

DROPPED = -1  # staleness bound exceeded: dropped and counted
ABSENT = -2  # warm-up: no payload exists yet (not a drop)


def lateness_steps(sec: float, period_s: float) -> int:
    """A straggler's lag in whole steps: ceil(SEC / period), at least 1."""
    return max(1, int(math.ceil(sec / period_s)))


def staleness_vector(
    step: int,
    *,
    n_dev: int,
    quorum: int,
    staleness: int,
    faults,
    period_s: float,
):
    """The arrival schedule of 1-based ``step``: ``(sigma, exposed_wait_s,
    drops)``. ``faults`` is the chaos ``slow_replica_faults`` table of
    (start_step, replica, seconds); ``sigma`` one entry a replica (>= 0
    present at that staleness, :data:`DROPPED` or :data:`ABSENT`);
    ``exposed_wait_s`` the seconds the host waits to honour the quorum
    floor; ``drops`` the [(replica, available staleness)] behind each
    DROPPED entry."""
    sigma = [0] * n_dev
    wait = [0.0] * n_dev
    avail = [0] * n_dev
    for r in range(n_dev):
        active = [
            (sec, start)
            for start, rep, sec in faults
            if rep == r and step >= start
        ]
        if not active:
            continue
        # the dominant fault: the largest lag, the earliest start on ties
        sec, start = max(active, key=lambda a: (a[0], -a[1]))
        lag = lateness_steps(sec, period_s)
        sig = min(step - start + 1, lag)
        if sig > step - 1:
            # the producing step does not exist yet: warm-up absence
            sigma[r] = ABSENT
            wait[r] = sec
        elif sig <= staleness:
            sigma[r] = sig  # present, stale: it rides the ring
        else:
            sigma[r] = DROPPED
            wait[r] = sec
            avail[r] = sig
    present = sum(1 for s in sigma if s >= 0)
    exposed = 0.0
    if present < quorum:
        # the quorum floor: wait for the nearest fresh payloads, in
        # ascending lag, so the exposed wait is the Q-th order statistic
        waiting = sorted(
            (r for r in range(n_dev) if sigma[r] < 0),
            key=lambda r: (wait[r], r),
        )
        for r in waiting:
            sigma[r] = 0
            exposed = max(exposed, wait[r])
            present += 1
            if present >= quorum:
                break
    drops = [(r, avail[r]) for r in range(n_dev) if sigma[r] == DROPPED]
    return sigma, exposed, drops
