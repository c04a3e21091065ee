"""The run report: every artifact of a run joined into one story.

Counterpart of ``atomo_tpu/obs/report.py:1-1011`` (the run mode; the fleet
report, ``:1014-1328``, waits for ROADMAP queue 1 item 11). :func:`build_report`
joins ``metrics.jsonl`` (the flight recorder), ``incidents.jsonl``,
``membership.json``, ``tune_decision.json``, ``fabric_probe.json``,
``budget_alloc.json``, ``arrival_schedule.jsonl`` and
``controller_decision.json`` into one time-ordered document
(``train_dir/run_report.json``): the step records compressed into contiguous
segments (split where the step sequence, the aggregate mode, the membership
epoch or the chaos generation changes), incidents and membership epochs
placed at their steps. Then the artifacts audit each other, by the JAX
package's checks, word for word:

* ``membership_incidents_agree``: each membership epoch has its incident;
* ``metrics_monotone``: the recorded steps strictly increase (every
  rollback and resume prune cut its tail);
* ``retunes_visible``: the aggregate column follows each retune incident;
* ``membership_column_agrees``: each step's epoch is the one whose span
  covers it;
* ``quality_density_valid``: the hybrid plan's density columns lie in
  [0, 1] and a sparse-assigned layer is sparse;
* ``fabric_probe_consistent``: a measured-fabric decision agrees with the
  probe artifact;
* ``drift_blame_present``: each retune incident quotes its blame;
* ``budget_alloc_consistent``: the budget meta lines and ``budget_epoch``
  column match ``budget_alloc.json``;
* ``quorum_schedule_consistent``: the arrival schedule matches the
  ``quorum_kept`` column and the staleness incidents;
* ``controller_decision_consistent``: the controller's decision is closed
  over its meta sections and not contradicted by what it supersedes;
* ``model_axes_layout_consistent``: the decision's layout is the one the
  ``lm`` run recorded.

A check whose artifact is absent reports skipped, not failed. The document is
the JAX package's key for key, so ``build_report`` of either package over
one directory gives the same document. :func:`summarize_report` renders the
human post-mortem. Everything here is a host-side file read.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from atomo_tpu_torch.obs.recorder import FlightRecorder, metrics_path
from atomo_tpu_torch.utils.tracing import (
    INCIDENT_LOG_NAME,
    IncidentLog,
    format_incident,
)

REPORT_FILE_NAME = "run_report.json"

_EPOCH_REASON_ACTION = {"init": "begin", "shrink": "shrink", "grow": "grow"}


def report_path(train_dir: str) -> str:
    return os.path.join(train_dir, REPORT_FILE_NAME)


def _segments(steps: list[dict]) -> list[dict]:
    """Compress the per-step records into contiguous segments: a new
    segment starts on a step regression/gap or when a context column
    (aggregate / membership epoch / generation) changes — exactly the
    boundaries a reader of the timeline cares about."""
    segs: list[dict] = []
    cur: Optional[dict] = None

    def ctx(r):
        return (r.get("aggregate"), r.get("epoch"), r.get("generation"))

    for r in steps:
        s = int(r.get("step", 0))
        fresh = (
            cur is None
            or s != cur["last_step"] + 1
            or ctx(r) != cur["_ctx"]
        )
        if fresh:
            if cur is not None:
                segs.append(cur)
            cur = {
                "kind": "metrics",
                "first_step": s,
                "last_step": s,
                "n": 0,
                "loss_first": r.get("loss"),
                "loss_last": r.get("loss"),
                "_ctx": ctx(r),
                "_ms_sum": 0.0,
                "_ms_n": 0,
                "skips": 0.0,
                "drops": 0.0,
            }
            for k in ("aggregate", "epoch", "generation"):
                if r.get(k) is not None:
                    cur[k] = r[k]
        cur["last_step"] = s
        cur["n"] += 1
        cur["loss_last"] = r.get("loss", cur["loss_last"])
        if r.get("step_ms") is not None:
            cur["_ms_sum"] += float(r["step_ms"])
            cur["_ms_n"] += 1
        cur["skips"] += float(r.get("skipped", 0.0) or 0.0)
        cur["drops"] += float(r.get("dropped", 0.0) or 0.0)
        if r.get("calib") is not None:
            cur["calib_last"] = r["calib"]
    if cur is not None:
        segs.append(cur)
    for seg in segs:
        if seg["_ms_n"]:
            seg["mean_step_ms"] = round(seg["_ms_sum"] / seg["_ms_n"], 3)
        del seg["_ctx"], seg["_ms_sum"], seg["_ms_n"]
    return segs


def _check(name: str, ok: bool, detail: str, skipped: bool = False) -> dict:
    return {"name": name, "ok": bool(ok), "skipped": skipped,
            "detail": detail}


def _check_membership_incidents(epochs: list[dict], incidents) -> dict:
    name = "membership_incidents_agree"
    if not epochs:
        return _check(name, True, "no membership history", skipped=True)
    mem = [r for r in incidents if r.get("cause") == "membership"]
    if not incidents:
        return _check(name, True, "incidents.jsonl absent", skipped=True)
    missing = []
    for e in epochs:
        want = _EPOCH_REASON_ACTION.get(str(e.get("reason")))
        if want is None:
            continue  # operator_resize etc.: no incident contract
        hit = any(
            r.get("epoch") == e.get("epoch")
            and r.get("action") == want
            and r.get("world") == e.get("world_size")
            for r in mem
        )
        if not hit:
            missing.append(
                f"epoch {e.get('epoch')} ({e.get('reason')}, world "
                f"{e.get('world_size')}) has no matching incident"
            )
    return _check(
        name,
        not missing,
        "; ".join(missing)
        or f"{len(epochs)} epoch(s) all matched by membership incidents",
    )


def _check_metrics_monotone(steps: list[dict], incidents) -> dict:
    name = "metrics_monotone"
    if not steps:
        return _check(name, True, "no step records", skipped=True)
    viol = [
        (int(a["step"]), int(b["step"]))
        for a, b in zip(steps, steps[1:])
        if int(b["step"]) <= int(a["step"])
    ]
    n_roll = sum(
        1
        for r in incidents
        if r.get("cause") == "divergence"
        and str(r.get("action", "")).startswith("rollback")
    )
    if viol:
        return _check(
            name,
            False,
            f"step regressions in file order at {viol[:5]} — a pruned "
            "tail survived",
        )
    return _check(
        name,
        True,
        f"{len(steps)} step records strictly increasing"
        + (f" across {n_roll} rollback prune(s)" if n_roll else ""),
    )


def _check_retunes(steps: list[dict], incidents) -> dict:
    name = "retunes_visible"
    switches = [
        (int(r.get("step", 0)), str(r["action"]).split("->", 1)[1])
        for r in incidents
        if r.get("cause") == "perf_drift"
        and str(r.get("action", "")).startswith("retune->")
    ]
    if not switches:
        return _check(name, True, "no retune switches", skipped=True)
    if not any(r.get("aggregate") for r in steps):
        return _check(
            name, True, "metrics carry no aggregate column", skipped=True
        )
    bad = []
    switches.sort()
    for i, (s, mode) in enumerate(switches):
        until = switches[i + 1][0] if i + 1 < len(switches) else None
        span = [
            r for r in steps
            if int(r["step"]) > s and (until is None or int(r["step"]) <= until)
        ]
        wrong = [r for r in span if r.get("aggregate") not in (None, mode)]
        if wrong:
            bad.append(
                f"retune->{mode} at step {s} but step "
                f"{wrong[0]['step']} records aggregate="
                f"{wrong[0].get('aggregate')!r}"
            )
    return _check(
        name,
        not bad,
        "; ".join(bad)
        or f"{len(switches)} retune switch(es) reflected in the "
        "aggregate column",
    )


def _check_membership_column(steps: list[dict], epochs: list[dict]) -> dict:
    name = "membership_column_agrees"
    if not epochs:
        return _check(name, True, "no membership history", skipped=True)
    recs = [r for r in steps if r.get("epoch") is not None]
    if not recs:
        return _check(
            name, True, "metrics carry no membership column", skipped=True
        )
    starts = sorted(
        (int(e["start_step"]), int(e["epoch"])) for e in epochs
    )

    def active(step: int) -> int:
        cur = starts[0][1]
        for s0, ep in starts:
            if s0 < step:
                cur = ep
            else:
                break
        return cur

    bad = [
        (int(r["step"]), int(r["epoch"]), active(int(r["step"])))
        for r in recs
        if int(r["epoch"]) != active(int(r["step"]))
    ]
    return _check(
        name,
        not bad,
        (
            f"step {bad[0][0]} records epoch {bad[0][1]} but membership "
            f"history says {bad[0][2]} (+{len(bad) - 1} more)"
            if bad
            else f"{len(recs)} records agree with the epoch spans"
        ),
    )


def _check_quality_density(metas: list[dict]) -> dict:
    """``quality_density_valid`` — audit the hybrid plan's per-layer
    columns in the obs_quality meta record: every
    recorded density lies in [0, 1], and a sparse-ASSIGNED layer is
    actually sparse — its row-budgeted payload strictly below its dense
    bytes (otherwise the plan's own crossover rule was violated) with a
    row budget inside the table. Skipped when no meta carries density
    columns (non-hybrid runs)."""
    name = "quality_density_valid"
    layers = [
        l
        for m in metas
        if m.get("what") == "obs_quality"
        for l in (m.get("layers") or [])
        if "density" in l
    ]
    if not layers:
        return _check(
            name, True, "no per-layer density columns recorded",
            skipped=True,
        )
    bad = []
    for l in layers:
        d = l.get("density")
        if not isinstance(d, (int, float)) or not 0.0 <= float(d) <= 1.0:
            bad.append(f"{l.get('name')}: density {d!r} outside [0, 1]")
            continue
        if l.get("assignment") == "sparse":
            if not l.get("payload_bytes", 0) < l.get("dense_bytes", 0):
                bad.append(
                    f"{l.get('name')}: sparse-assigned but payload "
                    f"{l.get('payload_bytes')} B >= dense "
                    f"{l.get('dense_bytes')} B — not actually sparse"
                )
            rows = (l.get("shape") or [0])[0]
            if not 0 < l.get("row_budget", 0) <= rows:
                bad.append(
                    f"{l.get('name')}: sparse-assigned with row budget "
                    f"{l.get('row_budget')!r} outside (0, {rows}]"
                )
    return _check(
        name,
        not bad,
        "; ".join(bad[:5])
        or f"{len(layers)} per-layer density column(s) all valid",
    )


def _check_fabric_probe(tune, fabric_probe, incidents=()) -> dict:
    """``fabric_probe_consistent`` — a tune decision priced from
    ``--fabric measured`` must agree with the probe artifact it claims
    to have read: the artifact exists and is complete, and the
    decision's recorded per-tier GB/s (``meta.fabric_tiers``) match the
    artifact's tier labels and numbers. Two artifacts describing one
    measurement must tell one story; skipped when no decision was
    measured-priced. ONE legitimate divergence exists: the drift-blame
    flow re-writes the artifact when the fabric MOVED mid-run — but
    that rewrite is itself on the record (a ``perf_drift`` incident
    whose blame verdict is ``fabric``), so a number mismatch is only a
    violation when no such incident explains it."""
    name = "fabric_probe_consistent"
    meta = (tune or {}).get("meta") or {}
    if meta.get("fabric") != "measured":
        return _check(
            name, True,
            "no measured-fabric tune decision to cross-check",
            skipped=True,
        )
    if not fabric_probe:
        return _check(
            name, False,
            "tune_decision.json was priced from --fabric measured but "
            "fabric_probe.json is missing or unparseable — the pricing "
            "source is gone",
        )
    if not fabric_probe.get("complete"):
        return _check(
            name, False,
            "fabric_probe.json is incomplete (no usable tier fit) but "
            "the tune decision claims measured pricing",
        )
    probe_tiers = {
        str(t.get("label")): t.get("bandwidth_gbps")
        for t in fabric_probe.get("tiers", [])
        if t.get("bandwidth_gbps")
    }
    meta_tiers = meta.get("fabric_tiers") or {}
    fabric_moved = any(
        r.get("cause") == "perf_drift"
        and (r.get("blame") or {}).get("verdict") == "fabric"
        for r in incidents
    )
    bad = []
    repriced = 0
    if not meta_tiers:
        bad.append(
            "decision meta carries no fabric_tiers (pre-probe artifact?)"
        )
    for lbl, gbps in meta_tiers.items():
        if lbl not in probe_tiers:
            bad.append(
                f"decision priced tier {lbl!r} ({gbps} GB/s) but the "
                f"probe artifact measured {sorted(probe_tiers) or 'none'}"
            )
        elif round(float(gbps), 4) != round(float(probe_tiers[lbl]), 4):
            if fabric_moved:
                # the recorded drift-blame re-price: the retuner rewrote
                # the artifact because the fabric MOVED, and said so in
                # incidents.jsonl — a divergence that explains itself
                repriced += 1
            else:
                bad.append(
                    f"tier {lbl!r}: decision says {gbps} GB/s, probe "
                    f"artifact says {probe_tiers[lbl]} GB/s — one of "
                    "them was rewritten with no fabric-moved incident "
                    "to explain it"
                )
    return _check(
        name,
        not bad,
        "; ".join(bad)
        or (
            f"decision tiers {sorted(meta_tiers)} match the probe "
            "artifact"
            + (
                f" up to {repriced} recorded drift-blame re-price(s)"
                if repriced else ""
            )
        ),
    )


def _check_budget_alloc(steps: list[dict], metas: list[dict],
                        budget_doc) -> dict:
    """``budget_alloc_consistent`` — the per-layer budget columns in
    metrics.jsonl must match the recorded allocation artifact: every
    ``budget_alloc_epochN`` meta line's epoch exists in
    budget_alloc.json with the SAME per-layer payload sum, and every
    step record's ``budget_epoch`` column matches the epoch whose span
    covers that step (re-allocations snap to checkpoint boundaries, so
    the column must switch exactly at each recorded ``start_step`` —
    the retunes_visible discipline applied to the budget dial). Skipped
    when no allocation was recorded (non-adaptive runs)."""
    name = "budget_alloc_consistent"
    b_metas = [
        m for m in metas
        if str(m.get("what", "")).startswith("budget_alloc_epoch")
    ]
    if not budget_doc and not b_metas:
        return _check(
            name, True, "no budget allocation recorded", skipped=True
        )
    if not budget_doc:
        return _check(
            name, False,
            "metrics.jsonl carries budget_alloc meta lines but "
            "budget_alloc.json is missing or unparseable — the "
            "allocation source is gone",
        )
    epochs = {
        int(e.get("epoch", -1)): e for e in budget_doc.get("epochs", [])
    }
    bad = []
    if not epochs:
        bad.append("budget_alloc.json records no allocation epochs")
    for m in b_metas:
        ep = m.get("budget_epoch")
        if ep not in epochs:
            bad.append(
                f"meta line records allocation epoch {ep!r} but the "
                f"artifact holds {sorted(epochs) or 'none'}"
            )
            continue
        meta_sum = sum(
            int(l.get("payload_bytes", 0))
            for l in (m.get("layers") or [])
        )
        art = int(epochs[ep].get("payload_bytes", -1))
        if meta_sum != art:
            bad.append(
                f"epoch {ep}: meta per-layer payload sum {meta_sum} B "
                f"!= artifact's {art} B — the recorded columns and the "
                "allocation disagree about a byte"
            )
    recs = [r for r in steps if r.get("budget_epoch") is not None]
    if epochs and recs:
        starts = sorted(
            (int(e.get("start_step", 0)), ep)
            for ep, e in epochs.items()
        )

        def active(step: int) -> int:
            cur = starts[0][1]
            for s0, ep in starts:
                if s0 < step:
                    cur = ep
                else:
                    break
            return cur

        wrong = [
            (int(r["step"]), int(r["budget_epoch"]),
             active(int(r["step"])))
            for r in recs
            if int(r["budget_epoch"]) != active(int(r["step"]))
        ]
        if wrong:
            bad.append(
                f"step {wrong[0][0]} records budget_epoch "
                f"{wrong[0][1]} but the artifact's spans say "
                f"{wrong[0][2]} (+{len(wrong) - 1} more)"
            )
    return _check(
        name,
        not bad,
        "; ".join(bad[:5])
        or (
            f"{len(b_metas)} allocation epoch meta(s) and "
            f"{len(recs)} step record(s) agree with budget_alloc.json"
        ),
    )


def _check_quorum_schedule(steps: list[dict], incidents,
                           sched_meta, sched_arrivals) -> dict:
    """``quorum_schedule_consistent`` — arrival_schedule.jsonl must agree
    with the run it anchors: per-step ``quorum_kept`` columns match the
    schedule's kept counts, no recorded staleness exceeds the meta
    header's K bound, and the schedule's total drop count equals the
    number of ``staleness_exceeded`` incidents (every drop announced,
    never a silent stale apply). Skipped when no schedule was recorded
    (non-quorum runs)."""
    name = "quorum_schedule_consistent"
    if sched_meta is None and not sched_arrivals:
        return _check(
            name, True, "no arrival schedule recorded", skipped=True
        )
    bad = []
    if sched_meta is None:
        bad.append(
            "arrival_schedule.jsonl has arrival records but no "
            "quorum_config meta header — the knobs the vectors were "
            "derived under are gone"
        )
    k_bound = int(sched_meta.get("staleness", 0)) if sched_meta else None
    recs = [r for r in steps if r.get("quorum_kept") is not None]
    for r in recs:
        s = int(r["step"])
        sched = sched_arrivals.get(s)
        if sched is None:
            bad.append(
                f"step {s} records quorum_kept="
                f"{int(r['quorum_kept'])} but the schedule has no "
                "arrival record for it"
            )
            continue
        if int(r["quorum_kept"]) != int(sched.get("kept", -1)):
            bad.append(
                f"step {s}: metrics say {int(r['quorum_kept'])} kept, "
                f"schedule says {sched.get('kept')} — the recorded "
                "trajectory and its replay anchor disagree"
            )
    if k_bound is not None:
        over = [
            (s, max(int(x) for x in rec.get("staleness", [0])))
            for s, rec in sorted(sched_arrivals.items())
            if any(int(x) > k_bound for x in rec.get("staleness", []))
        ]
        if over:
            bad.append(
                f"step {over[0][0]} records staleness {over[0][1]} past "
                f"the K={k_bound} bound (+{len(over) - 1} more) — a "
                "stale payload survived where it should have dropped"
            )
    total_drops = sum(
        int(rec.get("dropped", 0)) for rec in sched_arrivals.values()
    )
    n_incidents = sum(
        1 for r in incidents if r.get("cause") == "staleness_exceeded"
    )
    if total_drops != n_incidents:
        bad.append(
            f"schedule records {total_drops} drop(s) but incidents.jsonl "
            f"holds {n_incidents} staleness_exceeded incident(s) — "
            "every drop must be announced exactly once"
        )
    return _check(
        name,
        not bad,
        "; ".join(bad[:5])
        or (
            f"{len(sched_arrivals)} arrival record(s), {len(recs)} "
            f"quorum step record(s) and {n_incidents} drop incident(s) "
            "agree"
        ),
    )


def _check_drift_blame(incidents) -> dict:
    """``drift_blame_present`` — every ``perf_drift`` RETUNE incident
    (action ``retune->X`` / ``retune_keep``) must carry the blame record
    with both quoted numbers: the step-ms pair always, and per-tier
    GB/s whenever the verdict is ``fabric`` (an unquantified blame is an
    opinion, not evidence). Skipped when no retune incidents exist."""
    name = "drift_blame_present"
    retunes = [
        r for r in incidents
        if r.get("cause") == "perf_drift"
        and str(r.get("action", "")).startswith("retune")
    ]
    if not retunes:
        return _check(
            name, True, "no perf_drift retune incidents", skipped=True
        )
    bad = []
    for r in retunes:
        blame = r.get("blame")
        where = f"step {r.get('step')} ({r.get('action')})"
        if not isinstance(blame, dict) or blame.get("verdict") not in (
            "fabric", "program",
        ):
            bad.append(f"{where}: no blame verdict recorded")
            continue
        sm = blame.get("step_ms") or {}
        if not isinstance(sm.get("baseline"), (int, float)):
            bad.append(f"{where}: blame quotes no baseline step ms")
        if blame["verdict"] == "fabric":
            tiers = blame.get("fabric") or {}
            if not any(
                isinstance(t, dict)
                and isinstance(t.get("measured_gbps"), (int, float))
                and isinstance(t.get("baseline_gbps"), (int, float))
                for t in tiers.values()
            ):
                bad.append(
                    f"{where}: fabric verdict without per-tier "
                    "baseline/measured GB/s"
                )
    return _check(
        name,
        not bad,
        "; ".join(bad[:5])
        or f"{len(retunes)} retune incident(s) all carry quantified blame",
    )


def _check_controller_decision(ctl, tune, budget_doc, incidents) -> dict:
    """``controller_decision_consistent`` — the controller's ONE
    artifact must not be contradicted by the artifacts it supersedes or
    by its own audit stream (``--report --strict`` exits 3 on a
    contradicted knob vector, like every other check):

      * closure: a winner knob vector pinning ``budget_alloc=variance``
        / ``sparse_rows=on`` must carry the ``meta.allocation`` /
        ``meta.hybrid`` section that knob resolves against on resume;
      * supersession: a coexisting legacy ``tune_decision.json`` (or
        ``budget_alloc.json`` epoch 0) that disagrees with the
        controller's winner on a shared knob axis means two artifacts
        claim to be the source of truth — exactly what the controller
        exists to prevent;
      * the re-solve audit: ``controller_redecide`` incidents chain —
        each one's ``knobs_old`` is the previous one's ``knobs_new``,
        and the first chains off the recorded winner.

    Skipped when the run has no controller decision."""
    name = "controller_decision_consistent"
    if not ctl:
        return _check(
            name, True, "no controller decision recorded", skipped=True
        )
    bad = []
    if not ctl.get("complete"):
        bad.append("controller_decision.json is incomplete (solve died "
                   "mid-ladder)")
    knobs = ((ctl.get("winner") or {}).get("knobs")) or {}
    meta = ctl.get("meta") or {}
    if not knobs:
        bad.append("controller decision records no winner knob vector")
    if knobs.get("budget_alloc") == "variance" and not (
        (meta.get("allocation") or {}).get("ks")
    ):
        bad.append(
            "winner pins budget_alloc=variance but the artifact carries "
            "no meta.allocation.ks"
        )
    if knobs.get("sparse_rows") == "on" and not (
        (meta.get("hybrid") or {}).get("assignments")
    ):
        bad.append(
            "winner pins sparse_rows=on but the artifact carries no "
            "meta.hybrid assignment"
        )
    if tune is not None:
        legacy = ((tune.get("winner") or {}).get("knobs")) or {}
        for k in sorted(set(knobs) & set(legacy)):
            if knobs[k] != legacy[k]:
                bad.append(
                    f"superseded tune_decision.json contradicts the "
                    f"controller on {k!r}: {legacy[k]!r} vs {knobs[k]!r} "
                    "— two artifacts claim the knob vector"
                )
    if budget_doc and (meta.get("allocation") or {}).get("ks"):
        ep0 = next(
            (e for e in budget_doc.get("epochs", [])
             if int(e.get("epoch", -1)) == int(
                 meta["allocation"].get("epoch", 0))),
            None,
        )
        if ep0 is not None:
            art_ks = [int(k) for k in ep0.get("ks") or []]
            ctl_ks = [int(k) for k in meta["allocation"]["ks"]]
            if art_ks and art_ks != ctl_ks:
                bad.append(
                    "legacy budget_alloc.json epoch "
                    f"{meta['allocation'].get('epoch', 0)} records ks="
                    f"{art_ks} but the controller decision says {ctl_ks}"
                )
    redecides = [
        r for r in incidents if r.get("cause") == "controller_redecide"
    ]
    prev = {k: v for k, v in knobs.items()}
    for r in redecides:
        old = r.get("knobs_old") or {}
        new = r.get("knobs_new") or {}
        where = f"controller_redecide at step {r.get('step')}"
        if not old or not new:
            bad.append(f"{where} quotes no old/new knob vector")
            continue
        mismatched = {
            k for k in set(prev) & set(old) if prev[k] != old[k]
        }
        if mismatched:
            bad.append(
                f"{where}: knobs_old disagrees with the preceding "
                f"decision on {sorted(mismatched)} — the audit chain "
                "is broken"
            )
        prev = new
    return _check(
        name,
        not bad,
        "; ".join(bad[:5])
        or (
            "one decision artifact, knob vector closed over its meta "
            f"sections, {len(redecides)} re-decision(s) chained"
        ),
    )


def _check_model_axes_layout(ctl, metas) -> dict:
    """``model_axes_layout_consistent`` — the RECORDED axis layout must
    be one story across artifacts: the controller decision's
    ``meta.controller.layout``/``mesh_axes`` (what the knobs were solved
    FOR) against the run's own ``metrics.jsonl`` ``model_axes`` meta
    record (what the lm loop actually executed). A contradiction means
    the decision was resumed onto a reshaped mesh — a different program
    family wearing the old knob vector (``--strict`` exits 3, like every
    consistency check). Skipped when either side is unrecorded."""
    name = "model_axes_layout_consistent"
    run_meta = next(
        (m for m in metas if m.get("what") == "model_axes"), None
    )
    ctl_meta = ((ctl or {}).get("meta") or {})
    ctl_controller = ctl_meta.get("controller") or {}
    ctl_layout = ctl_controller.get("layout")
    if run_meta is None or ctl_layout is None:
        return _check(
            name,
            True,
            "layout recorded on one side at most (no cross-check "
            "possible)",
            skipped=True,
        )
    bad = []
    run_layout = run_meta.get("layout")
    if run_layout != ctl_layout:
        bad.append(
            f"controller decision was solved for layout {ctl_layout!r} "
            f"but metrics.jsonl records the run executing {run_layout!r}"
        )
    ctl_axes = ctl_meta.get("mesh_axes")
    run_axes = run_meta.get("mesh_axes")
    if (
        isinstance(ctl_axes, dict)
        and isinstance(run_axes, dict)
        and dict(ctl_axes) != dict(run_axes)
    ):
        bad.append(
            f"controller decision mesh {dict(ctl_axes)} contradicts the "
            f"executed mesh {dict(run_axes)}"
        )
    # overlap is a program-family knob like the layout itself: a decision
    # priced for the delayed (stale-by-one) schedule wearing a blocking
    # run's metrics — or vice versa — is the same contradiction
    knobs = (((ctl or {}).get("winner") or {}).get("knobs")) or {}
    ctl_overlap = knobs.get("overlap")
    run_exchange = run_meta.get("exchange")
    if ctl_overlap is not None and isinstance(run_exchange, dict):
        run_overlap = run_exchange.get("overlap", "off")
        if run_overlap != ctl_overlap:
            bad.append(
                f"controller decision priced overlap={ctl_overlap!r} but "
                f"metrics.jsonl records the run executing "
                f"overlap={run_overlap!r}"
            )
    return _check(
        name,
        not bad,
        "; ".join(bad)
        or f"decision and run agree on layout {ctl_layout!r}",
    )


def build_report(train_dir: str) -> dict:
    """Join the run's artifacts into the report document (see module
    docstring). Pure read — writing run_report.json is the caller's move
    (the CLI ``report`` verb uses write_json_atomic)."""
    all_recs = FlightRecorder.read(metrics_path(train_dir))
    steps = [r for r in all_recs if r.get("kind") == "step"]
    metas = [r for r in all_recs if r.get("kind") == "meta"]
    incidents = IncidentLog.read(os.path.join(train_dir, INCIDENT_LOG_NAME))
    epochs: list[dict] = []
    mpath = os.path.join(train_dir, "membership.json")
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                epochs = list(json.load(f).get("epochs", []))
        except (OSError, ValueError):
            epochs = []
    tune = None
    tpath = os.path.join(train_dir, "tune_decision.json")
    if os.path.exists(tpath):
        try:
            with open(tpath) as f:
                tune = json.load(f)
        except (OSError, ValueError):
            tune = None
    from atomo_tpu_torch.obs.fabric import read_fabric_probe

    fabric_probe = read_fabric_probe(train_dir)
    from atomo_tpu_torch.budget.artifact import read_alloc

    budget_doc = read_alloc(train_dir)
    from atomo_tpu_torch.quorum.artifact import read_schedule, schedule_path

    sched_meta, sched_arrivals = read_schedule(schedule_path(train_dir))
    from atomo_tpu_torch.controller.artifact import read_controller

    ctl = read_controller(train_dir)

    events: list[dict] = []
    events.extend(_segments(steps))
    for r in incidents:
        events.append(
            {
                "kind": "incident",
                "step": r.get("step"),
                "ts": r.get("ts"),
                "line": format_incident(r),
                "record": r,
            }
        )
    for e in epochs:
        events.append(
            {
                "kind": "membership",
                "step": e.get("start_step"),
                "epoch": e.get("epoch"),
                "world_size": e.get("world_size"),
                "reason": e.get("reason"),
                "dead": e.get("dead", []),
            }
        )
    if tune is not None:
        win = (tune.get("winner") or {})
        events.append(
            {
                "kind": "tune_decision",
                "step": 0,
                "winner": win.get("name"),
                "predicted_ms_per_step": win.get("predicted_ms_per_step"),
                "measured_ms_per_step": win.get("measured_ms_per_step"),
                "why": tune.get("why"),
            }
        )

    def sort_key(ev):
        step = ev.get("step") if ev.get("kind") != "metrics" else ev.get(
            "first_step"
        )
        # step-keyed events order by step; step-less ones (supervisor
        # records, retries) follow in ts order — chronologically they
        # bracket the run, and ts alone cannot be merged against steps
        if step is None:
            return (1, 0, float(ev.get("ts") or 0.0))
        return (0, int(step), float(ev.get("ts") or 0.0))

    events.sort(key=sort_key)

    checks = [
        _check_membership_incidents(epochs, incidents),
        _check_metrics_monotone(steps, incidents),
        _check_retunes(steps, incidents),
        _check_membership_column(steps, epochs),
        _check_quality_density(metas),
        _check_fabric_probe(tune, fabric_probe, incidents),
        _check_drift_blame(incidents),
        _check_budget_alloc(steps, metas, budget_doc),
        _check_quorum_schedule(steps, incidents, sched_meta,
                               sched_arrivals),
        _check_controller_decision(ctl, tune, budget_doc, incidents),
        _check_model_axes_layout(ctl, metas),
    ]
    consistent = all(c["ok"] for c in checks)
    summary = {
        "steps_recorded": len(steps),
        "first_step": int(steps[0]["step"]) if steps else None,
        "last_step": int(steps[-1]["step"]) if steps else None,
        "final_loss": steps[-1].get("loss") if steps else None,
        "incidents": len(incidents),
        "membership_epochs": len(epochs),
        "tuned": tune is not None,
        "quality_armed": any("q_rel" in r for r in steps) or bool(metas),
    }
    return {
        "kind": "run_report",
        "train_dir": os.path.abspath(train_dir),
        "sources": {
            "metrics_jsonl": len(all_recs),
            "incidents_jsonl": len(incidents),
            "membership_json": len(epochs),
            "tune_decision_json": tune is not None,
            "fabric_probe_json": fabric_probe is not None,
            "budget_alloc_json": budget_doc is not None,
            "arrival_schedule_jsonl": len(sched_arrivals),
            "controller_decision_json": ctl is not None,
        },
        "summary": summary,
        "timeline": events,
        "checks": checks,
        "consistent": consistent,
    }


def summarize_report(doc: dict) -> str:
    """The human post-mortem: one line per timeline event."""
    s = doc.get("summary", {})
    lines = [
        f"run report: {doc.get('train_dir')}",
        "  steps {}..{} ({} recorded), {} incident(s), {} membership "
        "epoch(s){}{}".format(
            s.get("first_step"),
            s.get("last_step"),
            s.get("steps_recorded"),
            s.get("incidents"),
            s.get("membership_epochs"),
            ", autopilot-tuned" if s.get("tuned") else "",
            ", quality probes armed" if s.get("quality_armed") else "",
        ),
    ]
    for ev in doc.get("timeline", []):
        kind = ev.get("kind")
        if kind == "metrics":
            ctx = ", ".join(
                f"{k}={ev[k]}"
                for k in ("aggregate", "epoch", "generation")
                if ev.get(k) is not None
            )
            ms = (
                f", {ev['mean_step_ms']} ms/step"
                if ev.get("mean_step_ms") is not None
                else ""
            )
            extra = ""
            if ev.get("skips"):
                extra += f", {int(ev['skips'])} skipped"
            if ev.get("drops"):
                extra += f", {int(ev['drops'])} dropped contribs"
            if ev.get("calib_last") is not None:
                extra += f", calib {ev['calib_last']}x"
            lines.append(
                f"  [steps {ev['first_step']}..{ev['last_step']}] "
                f"{ev['n']} step(s), loss "
                f"{_fmt(ev.get('loss_first'))} -> "
                f"{_fmt(ev.get('loss_last'))}{ms}"
                + (f" ({ctx})" if ctx else "")
                + extra
            )
        elif kind == "incident":
            at = f"[step {ev['step']}] " if ev.get("step") is not None else ""
            lines.append(f"  {at}incident: {ev['line']}")
        elif kind == "membership":
            lines.append(
                f"  [step {ev.get('step')}] membership epoch "
                f"{ev.get('epoch')}: world {ev.get('world_size')} "
                f"({ev.get('reason')}"
                + (f", dead={ev.get('dead')}" if ev.get("dead") else "")
                + ")"
            )
        elif kind == "tune_decision":
            lines.append(
                f"  [step 0] autopilot: {ev.get('winner')} "
                f"(predicted {ev.get('predicted_ms_per_step')} / measured "
                f"{ev.get('measured_ms_per_step')} ms/step)"
            )
    bad = [c["name"] for c in doc.get("checks", []) if not c["ok"]]
    ran = [c for c in doc.get("checks", []) if not c.get("skipped")]
    if doc.get("consistent"):
        lines.append(
            f"  consistency: OK ({len(ran)} check(s) ran, "
            f"{len(doc.get('checks', [])) - len(ran)} skipped)"
        )
    else:
        lines.append(f"  consistency: FAILED ({', '.join(bad)})")
        for c in doc.get("checks", []):
            if not c["ok"]:
                lines.append(f"    {c['name']}: {c['detail']}")
    return "\n".join(lines)


def _fmt(x) -> str:
    return f"{x:.4f}" if isinstance(x, (int, float)) else str(x)
