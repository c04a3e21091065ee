"""Trace-based phase timeline — ``report timeline``.

Counterpart of ``atomo_tpu/obs/timeline.py``. The JAX module parses an
XSpace protobuf and maps each HLO op to its ``named_phase`` scope; the port
reads its own Chrome trace (``*.pt.trace.json``, written by
:func:`atomo_tpu_torch.utils.tracing.profile` under ``train --profile-dir``)
and turns it into the same per-step phase timeline:

  1. PARSE: :func:`parse_trace` loads the trace's complete events: the
     ``step.*`` ranges (``record_function``, on the host thread that opened
     them), the host's operator events, the CUDA runtime and driver calls,
     and the device's kernels, copies and sets, each carrying the
     ``correlation`` id of the call that launched it.
  2. MAP: a range's phase is :func:`phase_of` its name with the ``step.``
     prefix stripped (``PHASE_OF_SCOPE``, the JAX package's table). The
     ranges that only the port opens get the phase the JAX step gives the
     same work (``PORT_PHASE_OF_RANGE``): the psum path's local decode
     (``step.decode``), the error-feedback decode and the quality probe run
     outside every ``named_phase`` scope in the JAX step, so they are
     compute; the layer-bucket encodes sit inside its ``encode`` scope; the
     delayed ring consume is the ring's exchange with its decode overlapped,
     as ``ring_exchange_decode`` is. (The JAX table has no entry for its own
     ``delayed_ring_exchange_decode`` scope, so the JAX timeline counts that
     work as compute; the port names it exchange.)
  3. ATTRIBUTE: each device event goes to the innermost ``step.*`` range
     that encloses the host call that launched it: linked to the call by its
     correlation id, and to the range by time on the call's own host
     thread. Backward runs on autograd's device thread, where no ``step.*``
     range is open, so its kernels are compute, never the range the main
     thread is in at the time; the bucket encodes open ``step.encode_bucket``
     on that thread and are encode. A replayed CUDA graph is one
     ``cudaGraphLaunch`` whose kernels have no range around them: the
     capture-order phase list that :class:`~atomo_tpu_torch.training.graph.
     GraphBlock` records beside the trace (``graph_phase_map.json``, from a
     profiled capture; Kineto tags a replayed kernel with no graph node id,
     so the map is keyed on the place in the replay) gives each replayed
     event, sorted by start, the phase of its place. A replay that runs
     another number of events than were captured fails the
     ``timeline_graph_map`` check and is attributed nothing but compute: no
     guesswork. On the CPU there are no device events: there the attributed
     events are the outermost operator events of each host thread, each
     thread its own line (as the JAX CPU trace's host ops are).
     Events are segmented into dispatches by :func:`_segment_executions`
     (the JAX function: the anchor is the minimum-occurrence event on the
     busiest line, on the card the busiest CUDA stream), and per dispatch
     and phase the timeline reports ``busy`` (summed event time),
     ``exposed`` (the phase's interval union minus its intersection with
     the compute union) and ``hidden`` (that intersection).
  4. JOIN: with a ``train_dir`` the spans are joined against
     ``metrics.jsonl`` through the ``profile_window`` meta record the loop
     writes when the trace starts, and the largest dispatch must fit inside
     the window's recorded host wall (1.5x band): a stream that describes
     another run fails the check.

The check names are the JAX module's, and so are their texts, with the
trace kind (``*.pt.trace.json``) where the JAX text says ``*.xplane.pb``;
``timeline_graph_map`` is the port's own. A trace is an observation
artifact: this module reads files and touches no device.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Optional

from atomo_tpu_torch.utils.tracing import TRACE_SUFFIX

TIMELINE_REPORT_NAME = "timeline_report.json"
GRAPH_PHASE_MAP_NAME = "graph_phase_map.json"

# scope token -> reported phase. ring_exchange_decode is exchange-with-
# decode-overlapped by construction (module docstring); the delayed_*
# scopes are the same phases consumed one step late.
PHASE_OF_SCOPE = {
    "encode": "encode",
    "exchange": "exchange",
    "hybrid_exchange": "exchange",
    "delayed_exchange": "exchange",
    "ring_exchange_decode": "exchange",
    "decode_mean": "decode",
    "delayed_decode_mean": "decode",
}
PHASES = ("encode", "exchange", "decode")

RANGE_PREFIX = "step."
# the port's own step.* ranges: the phase the JAX step gives the same work
PORT_PHASE_OF_RANGE = {
    "encode_bucket": "encode",
    "delayed_ring_exchange_decode": "exchange",
    # the quorum step's (the JAX table leaves its scopes out too)
    "quorum_exchange": "exchange",
    "quorum_decode_mean": "decode",
    "quorum_ring_exchange_decode": "exchange",
    "decode": "compute",
    "ef_decode": "compute",
    "quality": "compute",
}

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def phase_of(op_name: Optional[str]) -> str:
    """Classify a scope path (``/``-separated, the JAX form) or a port range
    name into encode/exchange/decode/compute: the first component the tables
    know decides. ``step.`` names are looked up with the prefix stripped,
    in the JAX table first and then in ``PORT_PHASE_OF_RANGE``."""
    if op_name:
        for part in op_name.split("/"):
            ported = part.startswith(RANGE_PREFIX)
            token = part[len(RANGE_PREFIX):] if ported else part
            ph = PHASE_OF_SCOPE.get(token) or (PORT_PHASE_OF_RANGE.get(token) if ported
                                               else None)
            if ph:
                return ph
    return "compute"


def latest_trace(profile_dir: str) -> Optional[str]:
    """Newest ``*.pt.trace.json`` under ``profile_dir``."""
    newest, newest_m = None, -1.0
    for base, _dirs, files in os.walk(profile_dir):
        for f in files:
            if f.endswith(TRACE_SUFFIX):
                p = os.path.join(base, f)
                m = os.path.getmtime(p)
                if m > newest_m:
                    newest, newest_m = p, m
    return newest


def parse_trace(path: str) -> dict:
    """The Chrome trace's complete (``ph`` X) events and its base unix time
    (``baseTimeNanoseconds``: an event's unix time is base + ``ts`` µs)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError("no traceEvents list")
    base = doc.get("baseTimeNanoseconds") if isinstance(doc, dict) else None
    return {"path": path, "base_ns": int(base) if isinstance(base, (int, float)) else None,
            "events": [e for e in events if isinstance(e, dict) and e.get("ph") == "X"
                       and "ts" in e]}


# ---------------------------------------------------------- attribution


def _union_len_us(intervals: list[tuple[float, float]]) -> float:
    if not intervals:
        return 0.0
    ivs = sorted(intervals)
    total = 0.0
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _intersect_len_us(a: list, b: list) -> float:
    """Length of the intersection of two interval UNIONS (both merged
    first so overlapping ops are not double counted)."""
    def merged(ivs):
        out = []
        for s, e in sorted(ivs):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    ma, mb = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(ma) and j < len(mb):
        s = max(ma[i][0], mb[j][0])
        e = min(ma[i][1], mb[j][1])
        if e > s:
            total += e - s
        if ma[i][1] < mb[j][1]:
            i += 1
        else:
            j += 1
    return total


def _segment_executions(events: list[dict]) -> list[list[dict]]:
    """Split one module's op events (time-sorted) into dispatches.

    A trace of a multi-device program carries every instruction once per
    DEVICE LINE per dispatch, and the devices run concurrently — pooling
    all lines and counting occurrences would over-split each dispatch
    into per-device fragments. So: segment on ONE reference line (the
    line with the most recorded busy time — a full participant of every
    dispatch), where an instruction OUTSIDE any scan loop executes
    exactly once per dispatch while scan-body ops (a superstep program's
    step body) run K times — the MINIMUM per-instruction occurrence
    count on that line is the dispatch count, and the earliest-starting
    minimum-count instruction is the boundary anchor. Every line's
    events are then assigned to dispatches by TIME against the anchor
    windows (a concurrent device may start an op fractionally before the
    reference anchor and land one dispatch early — tolerable noise for
    wall and busy sums, stated here rather than hidden)."""
    if not events:
        return []
    busy_by_line: dict = {}
    for ev in events:
        busy_by_line[ev.get("line")] = busy_by_line.get(
            ev.get("line"), 0.0
        ) + (ev["end_us"] - ev["start_us"])
    ref = max(busy_by_line, key=lambda ln: busy_by_line[ln])
    ref_events = [ev for ev in events if ev.get("line") == ref]
    counts: dict = {}
    for ev in ref_events:
        counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    n_min = min(counts.values())
    boundary = next(
        ev["name"] for ev in ref_events if counts[ev["name"]] == n_min
    )
    anchors = [
        ev["start_us"] for ev in ref_events if ev["name"] == boundary
    ]
    import bisect

    execs: list[list[dict]] = [[] for _ in anchors]
    for ev in events:
        # window i covers [anchors[i], anchors[i+1]); pre-anchor events
        # (another device's head start) join the first window
        i = max(bisect.bisect_right(anchors, ev["start_us"]) - 1, 0)
        execs[i].append(ev)
    return [ex for ex in execs if ex]


class _Ranges:
    """The ``step.*`` ranges of one trace, per host line (pid, tid), for
    innermost-enclosing lookups by time."""

    def __init__(self, events: list[dict]):
        self.by_line: dict = {}
        for e in events:
            if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(
                    RANGE_PREFIX):
                s = float(e["ts"])
                self.by_line.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (s, s + float(e.get("dur", 0.0)), e["name"]))
        self.starts = {}
        for line, rs in self.by_line.items():
            rs.sort(key=lambda r: (r[0], -r[1]))
            self.starts[line] = [r[0] for r in rs]

    def innermost(self, line, ts: float) -> Optional[str]:
        """The name of the latest-starting range of ``line`` that contains
        ``ts`` (ranges of one thread nest), or None."""
        rs = self.by_line.get(line)
        if not rs:
            return None
        i = bisect.bisect_right(self.starts[line], ts)
        while i > 0:
            i -= 1
            s, e, name = rs[i]
            if s <= ts <= e:
                return name
        return None

    def names(self) -> set:
        return {r[2] for rs in self.by_line.values() for r in rs}


def _is_launch(name: str) -> bool:
    """A runtime or driver call that puts work on a stream (in a capture: a
    node of the graph)."""
    if name.startswith(("cudaLaunch", "cuLaunch")):
        return True
    return name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")) and \
        "Async" in name


def capture_phase_map(trace_path: str) -> list[dict]:
    """The phase of each node a profiled CUDA-graph capture recorded, in
    capture order: every launch call (kernel, async copy, async set) made
    between ``cudaStreamBeginCapture`` and ``cudaStreamEndCapture`` on any
    thread of the process, each with the innermost ``step.*`` range of its
    own thread."""
    evs = parse_trace(trace_path)["events"]
    host = [e for e in evs if e.get("cat") in LAUNCH_CATS]
    begins = [float(e["ts"]) for e in host if str(e["name"]).startswith("cudaStreamBeginCapture")]
    ends = [float(e["ts"]) for e in host if str(e["name"]).startswith("cudaStreamEndCapture")]
    if len(begins) != 1 or len(ends) != 1:
        raise ValueError(f"{trace_path}: expected one capture, found {len(begins)} begins and "
                         f"{len(ends)} ends")
    lo, hi = begins[0], ends[0]
    ranges = _Ranges(evs)
    out = []
    for e in sorted(host, key=lambda e: float(e["ts"])):
        if lo <= float(e["ts"]) <= hi and _is_launch(str(e["name"])):
            rng = ranges.innermost((e.get("pid"), e.get("tid")), float(e["ts"]))
            out.append({"launch": e["name"], "range": rng, "phase": phase_of(rng)})
    return out


def read_graph_map(profile_dir: str) -> Optional[list]:
    try:
        with open(os.path.join(profile_dir, GRAPH_PHASE_MAP_NAME)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    entries = doc.get("entries") if isinstance(doc, dict) else None
    return entries if isinstance(entries, list) else None


def _outermost(ops: list[dict]) -> list[dict]:
    """The operator events of one thread that no other operator event of
    the thread encloses (nested operators would double-count busy time)."""
    out = []
    end = float("-inf")
    for e in sorted(ops, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0)))):
        s = float(e["ts"])
        if s >= end:
            out.append(e)
            end = s + float(e.get("dur", 0.0))
    return out


def attributed_events(trace: dict, graph_map: Optional[list] = None):
    """(events, notes): every attributed event of the trace as the
    segmentation takes it (``name``, ``line``, ``start_us``, ``end_us``,
    ``phase``, times in µs of the trace), and what the graph replays showed
    (``graph_replays``, ``graph_events``, ``graph_mismatch``: the replays
    whose event count differs from the map)."""
    evs = trace["events"]
    ranges = _Ranges(evs)
    notes = {"graph_replays": 0, "graph_events": 0, "graph_mismatch": []}
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    out = []
    if dev:
        calls = {}
        for e in evs:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    calls[corr] = e
        replays: dict = {}
        for e in dev:
            corr = (e.get("args") or {}).get("correlation")
            call = calls.get(corr)
            ev = {"name": e["name"], "line": (e.get("pid"), e.get("tid")),
                  "start_us": float(e["ts"]), "end_us": float(e["ts"]) + float(e.get("dur", 0.0)),
                  "phase": "compute", "cat": e["cat"]}
            if call is not None and call.get("name") in GRAPH_LAUNCHES:
                replays.setdefault(corr, []).append(ev)
            elif call is not None:
                ev["phase"] = phase_of(ranges.innermost((call.get("pid"), call.get("tid")),
                                                        float(call["ts"])))
            out.append(ev)
        for corr, group in replays.items():
            group.sort(key=lambda ev: ev["start_us"])
            notes["graph_replays"] += 1
            notes["graph_events"] += len(group)
            if graph_map is None or len(group) != len(graph_map):
                notes["graph_mismatch"].append(len(group))
                continue
            for ev, entry in zip(group, graph_map):
                ev["phase"] = entry.get("phase", "compute")
    else:
        ops: dict = {}
        for e in evs:
            if e.get("cat") == "cpu_op":
                ops.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        for line, line_ops in ops.items():
            for e in _outermost(line_ops):
                s = float(e["ts"])
                out.append({"name": e["name"], "line": line, "start_us": s,
                            "end_us": s + float(e.get("dur", 0.0)),
                            "phase": phase_of(ranges.innermost(line, s))})
    return out, notes


def build_timeline(
    profile_dir: str, train_dir: Optional[str] = None, trace: Optional[dict] = None
) -> dict:
    """The timeline document (module docstring): per-dispatch phase
    spans from the newest trace under ``profile_dir``, joined against
    ``train_dir/metrics.jsonl`` when given. Pure host-side file reads;
    ``trace`` is that newest trace already parsed (:func:`parse_trace`),
    for a caller that reads it too."""
    checks = []

    def check(name, ok, detail, skipped=False):
        checks.append({"name": name, "ok": bool(ok), "skipped": skipped,
                       "detail": detail})

    doc = {
        "kind": "timeline_report",
        "profile_dir": os.path.abspath(profile_dir),
        "trace": None,
        "module": None,
        "spans": [],
        "checks": checks,
        "consistent": True,
    }
    trace_path = latest_trace(profile_dir) if os.path.isdir(profile_dir) else None
    if trace_path is None:
        check("timeline_trace_found", False,
              f"no *{TRACE_SUFFIX} under {profile_dir!r} — run with "
              "--profile-dir to capture one")
        doc["consistent"] = False
        return doc
    doc["trace"] = trace_path
    try:
        trace = parse_trace(trace_path) if trace is None else trace
    except (ValueError, IndexError, OSError) as exc:
        check("timeline_trace_found", False,
              f"unparseable trace {trace_path!r}: {exc}")
        doc["consistent"] = False
        return doc
    graph_map = read_graph_map(os.path.dirname(trace_path)) or read_graph_map(profile_dir)
    ranges = _Ranges(trace["events"])
    phased = any(phase_of(n) != "compute" for n in ranges.names()) or any(
        e.get("phase") != "compute" for e in graph_map or [])
    if not phased:
        check(
            "timeline_phases_present", False,
            "no named_phase scopes (encode/exchange/decode) in any traced "
            "program — the trace predates the fused step, or the "
            "anchors were dropped (tests/test_fabric_obs.py guards them)",
        )
        doc["consistent"] = False
        return doc
    events, notes = attributed_events(trace, graph_map)
    if not events:
        check(
            "timeline_phases_present", False,
            "named_phase scopes exist in the HLO metadata but no device "
            "op events were recorded for those programs — the profiled "
            "window may not have executed the fused step",
        )
        doc["consistent"] = False
        return doc
    events.sort(key=lambda e: e["start_us"])
    t0 = events[0]["start_us"]
    for ev in events:
        ev["start_us"] -= t0
        ev["end_us"] -= t0
    pids = sorted({str(e.get("pid")) for e in trace["events"] if e.get("cat") in
                   ("user_annotation", "cpu_op")})
    doc["module"] = f"step.* ranges of pid {', '.join(pids)}"
    doc["profile_start_unix_s"] = (
        (trace["base_ns"] / 1e9 + t0 / 1e6) if trace["base_ns"] is not None else None
    )
    check(
        "timeline_phases_present", True,
        f"module {doc['module']} carries "
        f"{sum(1 for e in events if e['phase'] != 'compute')} phase-scoped "
        f"op executions across {len(events)} events",
    )
    if notes["graph_replays"]:
        doc["graph_replays"] = notes["graph_replays"]
        bad = notes["graph_mismatch"]
        n_map = None if graph_map is None else len(graph_map)
        check(
            "timeline_graph_map", not bad,
            (f"{notes['graph_replays']} CUDA-graph replay(s), {notes['graph_events']} "
             f"device events, each replay attributed by the {n_map}-entry capture map"
             if not bad else
             (f"no {GRAPH_PHASE_MAP_NAME} beside the trace for its "
              f"{notes['graph_replays']} CUDA-graph replay(s)" if graph_map is None else
              f"{len(bad)} replay(s) ran {sorted(set(bad))} device events where the capture "
              f"recorded {n_map}") + " — their events stay unattributed (compute)"),
        )

    spans = []
    for i, ex in enumerate(_segment_executions(events)):
        ivs: dict = {p: [] for p in PHASES}
        ivs["compute"] = []
        busy: dict = {p: 0.0 for p in PHASES}
        busy["compute"] = 0.0
        for ev in ex:
            ivs[ev["phase"]].append((ev["start_us"], ev["end_us"]))
            busy[ev["phase"]] += ev["end_us"] - ev["start_us"]
        t_start = min(e["start_us"] for e in ex)
        t_end = max(e["end_us"] for e in ex)
        span = {
            "dispatch": i,
            "t_start_us": round(t_start, 3),
            "wall_ms": round((t_end - t_start) / 1e3, 4),
            "compute_ms": round(busy["compute"] / 1e3, 4),
            "phases": {},
        }
        if doc["profile_start_unix_s"] is not None:
            span["t_start_unix_s"] = round(
                doc["profile_start_unix_s"] + t_start / 1e6, 3
            )
        for p in PHASES:
            union = _union_len_us(ivs[p])
            hidden = _intersect_len_us(ivs[p], ivs["compute"])
            busy_ms, hidden_ms = round(busy[p] / 1e3, 4), round(hidden / 1e3, 4)
            # busy >= union = exposed + hidden; rounded apart, the two parts
            # could pass the rounded busy by 1e-4, so exposed takes the rest
            span["phases"][p] = {
                "busy_ms": busy_ms,
                "exposed_ms": min(round((union - hidden) / 1e3, 4),
                                  round(busy_ms - hidden_ms, 4)),
                "hidden_ms": hidden_ms,
            }
        spans.append(span)
    doc["spans"] = spans
    doc["n_dispatches"] = len(spans)

    # ---- join against metrics.jsonl ---------------------------------
    if train_dir:
        from atomo_tpu_torch.obs.recorder import FlightRecorder, metrics_path

        recs = FlightRecorder.read(metrics_path(train_dir))
        steps = [r for r in recs if r.get("kind") == "step"]
        window = next(
            (r for r in recs
             if r.get("kind") == "meta"
             and r.get("what") == "profile_window"),
            None,
        )
        if not steps:
            check(
                "timeline_joins_metrics", True,
                "no metrics.jsonl step records to join against "
                "(run with --obs-record to arm the recorder)",
                skipped=True,
            )
        else:
            if window is not None:
                # the exact artifact-side key the loops record when the
                # trace starts: which steps the profiled window covers
                lo = int(window["first_step"])
                hi = int(window["last_step"])
                joined = [
                    r for r in steps if lo <= int(r["step"]) <= hi
                ]
                basis = f"recorded profile_window steps {lo}..{hi}"
            else:
                # fallback for pre-meta artifacts: wall-clock overlap
                # (trace times are unix-anchored via baseTimeNanoseconds)
                t_lo = min(
                    (s.get("t_start_unix_s") for s in spans
                     if s.get("t_start_unix_s") is not None),
                    default=None,
                )
                t_hi = max(
                    (s.get("t_start_unix_s", 0) + s["wall_ms"] / 1e3
                     for s in spans if s.get("t_start_unix_s") is not None),
                    default=None,
                )
                joined = [
                    r for r in steps
                    if t_lo is not None and t_hi is not None
                    and t_lo - 2.0 <= float(r.get("ts", 0)) <= t_hi + 30.0
                ]
                basis = "wall-clock overlap (no profile_window meta)"
            doc["joined_steps"] = [int(r["step"]) for r in joined]
            if joined and spans and len(joined) % len(spans) == 0:
                # informational only (a trailing async dispatch can leak
                # into the trace, so a non-dividing count is not an
                # error — the wall check below is the contract)
                doc["steps_per_dispatch"] = len(joined) // len(spans)
            if not joined:
                check(
                    "timeline_joins_metrics", False,
                    f"no metrics.jsonl step records join the trace "
                    f"({basis}) — the trace and the metrics stream "
                    "describe different runs",
                )
            else:
                missing = []
                if window is not None:
                    have = {int(r["step"]) for r in joined}
                    missing = [
                        s for s in range(lo, hi + 1) if s not in have
                    ]
                window_ms = sum(
                    float(r["step_ms"]) for r in joined
                    if r.get("step_ms")
                )
                max_wall = max(s["wall_ms"] for s in spans)
                # the quantitative cross-check: the LARGEST device
                # dispatch must fit inside the profiled window's
                # recorded host wall (device work cannot outlast the
                # host wall that dispatched and fetched it; 1.5x guard
                # band for fetch jitter). A metrics stream describing a
                # different — or doctored — run fails here (tested on a
                # violated fixture).
                ok_wall = (
                    window_ms <= 0
                    or max_wall <= window_ms * 1.5 + 1.0
                )
                ok = not missing and ok_wall
                check(
                    "timeline_joins_metrics", ok,
                    f"{len(joined)} recorded step(s) joined ({basis}); "
                    f"largest dispatch {max_wall:.3f} ms vs window host "
                    f"wall {window_ms:.3f} ms"
                    + (
                        f"; steps {missing} missing from metrics.jsonl "
                        "(pruned or never recorded)" if missing else ""
                    )
                    + (
                        "" if ok_wall else
                        " — the device span EXCEEDS the host wall that "
                        "dispatched it; the metrics stream does not "
                        "describe this trace"
                    ),
                )
    else:
        check("timeline_joins_metrics", True,
              "no --train-dir given; trace-only timeline", skipped=True)

    doc["consistent"] = all(c["ok"] for c in checks)
    return doc


def phase_totals(doc: dict) -> dict:
    """``{phase: {busy_ms, exposed_ms, hidden_ms}}`` summed over the
    document's spans, and ``compute_ms`` and ``wall_ms`` beside them."""
    out = {p: {"busy_ms": 0.0, "exposed_ms": 0.0, "hidden_ms": 0.0} for p in PHASES}
    out["compute_ms"] = out["wall_ms"] = 0.0
    for s in doc.get("spans", []):
        out["compute_ms"] += s["compute_ms"]
        out["wall_ms"] += s["wall_ms"]
        for p in PHASES:
            for k in ("busy_ms", "exposed_ms", "hidden_ms"):
                out[p][k] += s["phases"][p][k]
    return out


def summarize_timeline(doc: dict) -> str:
    """The human rendering: one line per dispatch with the phase
    exposed/hidden split, then the check verdicts."""
    lines = [
        f"phase timeline: {doc.get('trace') or doc.get('profile_dir')}",
    ]
    if doc.get("module"):
        lines.append(
            f"  module {doc['module']}: {doc.get('n_dispatches')} "
            "dispatch(es)"
            + (
                f", {doc['steps_per_dispatch']} step(s)/dispatch"
                if doc.get("steps_per_dispatch") else ""
            )
        )
    for s in doc.get("spans", []):
        ph = s["phases"]
        bits = [
            f"{p} {ph[p]['busy_ms']}ms"
            f" (exposed {ph[p]['exposed_ms']}, hidden {ph[p]['hidden_ms']})"
            for p in PHASES
            if ph[p]["busy_ms"] > 0
        ]
        lines.append(
            f"  [dispatch {s['dispatch']}] wall {s['wall_ms']} ms, "
            f"compute {s['compute_ms']} ms"
            + (": " + "; ".join(bits) if bits else " (no phase ops)")
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
