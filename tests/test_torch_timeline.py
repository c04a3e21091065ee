"""The trace-based phase timeline (``obs/timeline.py``, ``--profile-dir``,
``report timeline``) and the phased step (``--phase-metrics``), against the
JAX package on the CPU.

* The JAX module's pure functions, kept verbatim, on random inputs
  (hypothesis): ``_union_len_us``, ``_intersect_len_us`` and
  ``_segment_executions`` over random interval lists and event tables, and
  the one-line anchor case of ``tests/test_fabric_obs.py:609-632``;
  ``phase_of`` over every ``named_phase`` scope of the JAX package (the
  same phase, but for ``delayed_ring_exchange_decode``, which the JAX table
  leaves out and the port names exchange).
* Every ``step.*`` range the port opens has a phase: the port's sources
  are walked for ``record_function("step.``, the counterpart of the JAX
  scope-presence test.
* Attribution on a synthetic card trace: a kernel launched from autograd's
  thread is compute whatever range the main thread is in; a kernel
  launched inside ``step.encode`` is encode; a replayed graph's events take
  the capture map's phases by place, and a replay of another length fails
  ``timeline_graph_map``; ``capture_phase_map`` reads a profiled capture.
* Real traces: a two-rank gloo LeNet qsgd run with ``--profile-dir
  --obs-record`` and one under ``--phase-metrics``; ``report timeline
  --strict`` reads both consistent with encode, exchange and decode spans;
  the join passes on the true ``metrics.jsonl`` and fails on doctored ones
  (a missing step, a host wall too short); a missing trace and a scopeless
  trace give the JAX messages.
* ``--phase-metrics``: every conflict text equals the JAX verb's, the
  deprecation warning and the superstep warning are the JAX verb's, the
  worker line carries non-zero Comp/Encode/Comm seconds with the master
  line beside it, and the phased run's checkpoints equal the fused gather
  run's bit for bit.
"""

import json
import re
import shutil
import warnings
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_dist import ROOT, Group

from atomo_tpu import cli as jax_cli
from atomo_tpu.obs import timeline as J
from atomo_tpu_torch import cli
from atomo_tpu_torch.obs import timeline as P
from atomo_tpu_torch.obs.recorder import metrics_path
from atomo_tpu_torch.utils.tracing import profile, read_jsonl

torch.set_num_threads(1)

IV = st.tuples(st.floats(0, 1e4, allow_nan=False), st.floats(0, 1e3, allow_nan=False)).map(
    lambda t: (t[0], t[0] + t[1]))


@settings(max_examples=80, deadline=None)
@given(ivs=st.lists(IV, max_size=12))
def test_union_len_equals_jax(ivs):
    assert P._union_len_us(ivs) == J._union_len_us(ivs)


@settings(max_examples=80, deadline=None)
@given(a=st.lists(IV, max_size=10), b=st.lists(IV, max_size=10))
def test_intersect_len_equals_jax(a, b):
    assert P._intersect_len_us(a, b) == J._intersect_len_us(a, b)


EVENT = st.fixed_dictionaries({
    "name": st.sampled_from(["a", "b", "c", "d"]),
    "line": st.sampled_from([("p", "dev0"), ("p", "dev1"), ("h", 7)]),
    "start_us": st.floats(0, 1e3, allow_nan=False),
    "dur": st.floats(0, 50, allow_nan=False),
})


@settings(max_examples=80, deadline=None)
@given(rows=st.lists(EVENT, max_size=30))
def test_segment_executions_equals_jax(rows):
    events = sorted(({"name": r["name"], "line": r["line"], "start_us": r["start_us"],
                      "end_us": r["start_us"] + r["dur"]} for r in rows),
                    key=lambda e: e["start_us"])
    assert P._segment_executions(events) == J._segment_executions(events)


def test_segmentation_anchors_on_one_device_line():
    events = []
    for d in range(2):  # two dispatches
        base = d * 100.0
        for line in ("dev0", "dev1"):
            off = 0.1 if line == "dev1" else 0.0
            for i, op in enumerate(("a", "b", "c")):
                t = base + i * 1.0 + off
                events.append({"name": op, "line": ("p", line), "start_us": t,
                               "end_us": t + 0.5})
    events.sort(key=lambda e: e["start_us"])
    got = P._segment_executions(events)
    assert [len(ex) for ex in got] == [6, 6] and got == J._segment_executions(events)


def _sources(root: Path, pattern: str) -> list:
    rx = re.compile(pattern)
    out = set()
    for path in sorted(root.rglob("*.py")):
        out.update(rx.findall(path.read_text()))
    return sorted(out)


JAX_SCOPES = _sources(ROOT / "atomo_tpu", r'named_phase\("([a-z_]+)"\)')
PORT_RANGES = _sources(ROOT / "atomo_tpu_torch", r'record_function\("step\.([a-z_]+)"') + \
    _sources(ROOT, r'record_function\("step\.([a-z_]+)"')


# JAX scopes whose work the JAX table leaves unscoped (compute) and the
# port's ranges attribute to the phase the work is (PORT_PHASE_OF_RANGE)
PORT_ATTRIBUTED = {"delayed_ring_exchange_decode": "exchange", "quorum_exchange": "exchange",
                   "quorum_decode_mean": "decode", "quorum_ring_exchange_decode": "exchange"}


@pytest.mark.parametrize("scope", JAX_SCOPES)
def test_phase_of_every_jax_scope(scope):
    path = f"jit(step)/jit(main)/{scope}/dot_general"
    assert P.phase_of(path) == J.phase_of(path)
    want = PORT_ATTRIBUTED.get(scope, J.phase_of(path))
    assert P.phase_of(f"step.{scope}") == want


def test_phase_of_names_and_the_table():
    assert P.PHASE_OF_SCOPE == J.PHASE_OF_SCOPE and P.PHASES == J.PHASES
    assert P.TIMELINE_REPORT_NAME == J.TIMELINE_REPORT_NAME
    for name in (None, "", "jit(f)/dense/add", "step.forward_backward", "step.update"):
        assert P.phase_of(name) == "compute"
    assert P.phase_of("jit(f)/encode_bucket/x") == J.phase_of("jit(f)/encode_bucket/x")


# the ranges the JAX step leaves unscoped, and the sharded update's two,
# whose JAX scopes its table leaves out: compute, on purpose
COMPUTE_RANGES = {"forward_backward", "update", "sp_reduce", "decode", "ef_decode", "quality",
                  "materialize_params", "sharded_update"}


@pytest.mark.parametrize("name", sorted(set(PORT_RANGES)))
def test_every_port_range_has_a_phase(name):
    """A range the tables do not know would silently read as compute."""
    known = name in P.PHASE_OF_SCOPE or name in P.PORT_PHASE_OF_RANGE
    assert known or name in COMPUTE_RANGES, name
    assert (P.phase_of(f"step.{name}") == "compute") == (name in COMPUTE_RANGES)


def test_the_ranges_the_main_path_opens_are_found():
    assert {"forward_backward", "encode", "exchange", "decode_mean", "update",
            "encode_bucket", "ring_exchange_decode", "delayed_ring_exchange_decode"} <= \
        set(PORT_RANGES)


# ------------------------------------------------------ synthetic card traces


def _x(name, cat, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _card_trace(d: Path, graph_events: int = 3, graph_map: bool = True) -> Path:
    """Main thread 1 opens forward_backward then encode; autograd's thread 2
    launches a kernel while forward_backward is open; thread 1 launches one
    inside encode and one graph replay whose events run on stream 7."""
    ev = [
        _x("step.forward_backward", "user_annotation", 0, 100),
        _x("step.encode", "user_annotation", 100, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 50, 2, tid=2, correlation=7),
        _x("cudaLaunchKernel", "cuda_runtime", 120, 2, correlation=8),
        _x("cudaGraphLaunch", "cuda_runtime", 200, 5, correlation=9),
        _x("bwd_kernel", "kernel", 60, 10, pid=0, tid=7, correlation=7),
        _x("enc_kernel", "kernel", 125, 5, pid=0, tid=7, correlation=8),
    ]
    for i in range(graph_events):
        ev.append(_x(f"g{i}", "kernel" if i else "gpu_memcpy", 210 + 10 * i, 5, pid=0, tid=7,
                     correlation=9))
    d.mkdir(parents=True, exist_ok=True)
    path = d / "host_1.1.pt.trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": 10 ** 18, "traceEvents": ev}))
    if graph_map:
        (d / P.GRAPH_PHASE_MAP_NAME).write_text(json.dumps({
            "kind": "graph_phase_map", "n": 3,
            "entries": [{"phase": p} for p in ("compute", "encode", "decode")]}))
    return path


def test_attribution_follows_the_launching_thread(tmp_path):
    path = _card_trace(tmp_path)
    events, notes = P.attributed_events(P.parse_trace(str(path)),
                                        P.read_graph_map(str(tmp_path)))
    phases = {e["name"]: e["phase"] for e in events}
    # backward's kernel: launched on autograd's thread, no range there
    assert phases["bwd_kernel"] == "compute"
    assert phases["enc_kernel"] == "encode"
    assert [phases[f"g{i}"] for i in range(3)] == ["compute", "encode", "decode"]
    assert notes == {"graph_replays": 1, "graph_events": 3, "graph_mismatch": []}
    doc = P.build_timeline(str(tmp_path))
    assert doc["consistent"] and doc["graph_replays"] == 1
    assert [c["name"] for c in doc["checks"]] == ["timeline_phases_present",
                                                  "timeline_graph_map", "timeline_joins_metrics"]


@pytest.mark.parametrize("n,graph_map", [(2, True), (4, True), (3, False)],
                         ids=["short", "long", "no-map"])
def test_a_replay_that_differs_from_its_capture_fails_the_check(tmp_path, n, graph_map):
    _card_trace(tmp_path, graph_events=n, graph_map=graph_map)
    doc = P.build_timeline(str(tmp_path))
    check = {c["name"]: c for c in doc["checks"]}["timeline_graph_map"]
    assert not check["ok"] and not doc["consistent"]
    assert "unattributed" in check["detail"]
    events, _ = P.attributed_events(P.parse_trace(P.latest_trace(str(tmp_path))),
                                    P.read_graph_map(str(tmp_path)))
    assert all(e["phase"] == "compute" for e in events if e["name"].startswith("g"))


def test_capture_phase_map_reads_a_profiled_capture(tmp_path):
    ev = [
        _x("cudaStreamBeginCapture", "cuda_runtime", 10, 1),
        _x("step.encode", "user_annotation", 20, 30),
        _x("step.exchange", "user_annotation", 60, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 5, 1),  # before the capture: not a node
        _x("cudaLaunchKernel", "cuda_runtime", 25, 1),
        _x("cudaLaunchKernelExC", "cuda_runtime", 30, 1),
        _x("cuLaunchKernel", "cuda_driver", 40, 1, tid=2),  # autograd's thread: compute
        _x("cudaMemcpyAsync", "cuda_runtime", 70, 1),
        _x("cudaStreamGetCaptureInfo_v2", "cuda_runtime", 75, 1),
        _x("cudaMemsetAsync", "cuda_runtime", 95, 1),
        _x("cudaStreamEndCapture", "cuda_runtime", 100, 1),
    ]
    path = tmp_path / "cap.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    got = P.capture_phase_map(str(path))
    assert [(e["launch"], e["phase"]) for e in got] == [
        ("cudaLaunchKernel", "encode"), ("cudaLaunchKernelExC", "encode"),
        ("cuLaunchKernel", "compute"), ("cudaMemcpyAsync", "exchange"),
        ("cudaMemsetAsync", "compute")]


# ------------------------------------------------------------- real traces

LENET = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic", "--batch-size",
         "16", "--log-interval", "2", "--eval-freq", "0", "--device", "cpu", "--n-devices",
         "2", "--code", "qsgd", "--aggregate", "gather", "--max-steps", "6", "--save-freq",
         "3", "--obs-record"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's answers and the train dirs of the fused and the phased run,
    each traced, over one gloo group of two ranks."""
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    out = {}
    try:
        for name, extra in (("fused", []), ("phased", ["--phase-metrics"])):
            d = tmp_path_factory.mktemp(name)
            r = g.run("cli", argv=LENET + extra + ["--train-dir", str(d), "--profile-dir",
                                                   str(d / "prof")])[0]
            assert r["rc"] == 0 and r["exit"] is None, r
            out[name] = (d, r)
    finally:
        g.close()
    return out


@pytest.mark.parametrize("name", ["fused", "phased"])
def test_report_timeline_reads_the_port_trace(runs, name):
    d, r = runs[name]
    assert "Profiling steps 2..4 -> " + str(d / "prof") in r["lines"]
    lines = []
    rc = cli.main(["report", "timeline", "--profile-dir", str(d / "prof"), "--train-dir",
                   str(d), "--strict"], log_fn=lines.append)
    assert rc == 0, "\n".join(lines)
    doc = json.loads((d / P.TIMELINE_REPORT_NAME).read_text())
    assert doc["consistent"] and doc["joined_steps"] == [2, 3, 4]
    assert doc["n_dispatches"] >= 1 and doc["trace"].endswith(".pt.trace.json")
    totals = P.phase_totals(doc)
    assert all(totals[p]["busy_ms"] > 0 for p in P.PHASES), totals
    for s in doc["spans"]:
        for p in P.PHASES:
            ph = s["phases"][p]
            assert ph["busy_ms"] >= ph["exposed_ms"] + ph["hidden_ms"] - 1e-6
    text = "\n".join(lines)
    assert "consistency: OK (2 check(s) ran, 0 skipped)" in text
    assert all(f"{p} " in text for p in P.PHASES)
    window = [m for m in read_jsonl(metrics_path(str(d))) if m.get("what") == "profile_window"]
    assert window == [{**window[0], "first_step": 2, "last_step": 4,
                       "profile_dir": str(d / "prof")}]


def _doctored(src: Path, dst: Path, *, drop=None, step_ms=None) -> Path:
    shutil.copytree(src, dst)
    recs = read_jsonl(metrics_path(str(dst)))
    keep = []
    for r in recs:
        if r.get("kind") == "step" and r.get("step") == drop:
            continue
        if r.get("kind") == "step" and step_ms is not None:
            r = dict(r, step_ms=step_ms)
        keep.append(r)
    Path(metrics_path(str(dst))).write_text("".join(json.dumps(r) + "\n" for r in keep))
    return dst


def test_the_join_fails_on_doctored_metrics(runs, tmp_path):
    d, _ = runs["fused"]
    prof = str(d / "prof")
    honest = P.build_timeline(prof, str(d))
    assert {c["name"]: c for c in honest["checks"]}["timeline_joins_metrics"]["ok"]
    holey = P.build_timeline(prof, str(_doctored(d, tmp_path / "holey", drop=3)))
    c = {x["name"]: x for x in holey["checks"]}["timeline_joins_metrics"]
    assert not c["ok"] and "steps [3] missing" in c["detail"] and not holey["consistent"]
    fast = P.build_timeline(prof, str(_doctored(d, tmp_path / "fast", step_ms=1e-4)))
    c = {x["name"]: x for x in fast["checks"]}["timeline_joins_metrics"]
    assert max(s["wall_ms"] for s in fast["spans"]) > 1.5 * 3e-4 + 1.0
    assert not c["ok"] and "EXCEEDS" in c["detail"]
    rc = cli.main(["report", "timeline", "--profile-dir", prof, "--train-dir",
                   str(tmp_path / "fast"), "--strict"], log_fn=lambda _: None)
    assert rc == 3


def test_missing_and_scopeless_traces_give_the_jax_messages(tmp_path):
    doc = P.build_timeline(str(tmp_path / "nothing"))
    want = J.build_timeline(str(tmp_path / "nothing"))
    assert doc["consistent"] is False and doc["checks"] == [
        dict(want["checks"][0], detail=want["checks"][0]["detail"].replace(
            "*.xplane.pb", "*.pt.trace.json"))]
    prof = tmp_path / "plain"
    with profile(str(prof)):
        torch.ones(64) @ torch.ones(64)
    doc2 = P.build_timeline(str(prof))
    (bad,) = [c for c in doc2["checks"] if not c["ok"]]
    assert bad["name"] == "timeline_phases_present" and "no named_phase scopes" in bad["detail"]
    with pytest.raises(SystemExit) as got:
        cli.main(["report", "timeline", "--train-dir", str(tmp_path)])
    with pytest.raises(SystemExit) as want_exit:
        jax_cli.main(["report", "timeline", "--train-dir", str(tmp_path)])
    assert str(got.value.code) == str(want_exit.value.code)


# ------------------------------------------------------------ --phase-metrics


@pytest.mark.parametrize("extra", [
    ["--overlap", "delayed", "--code", "qsgd", "--n-devices", "4"],
    ["--stream-encode", "on", "--code", "qsgd", "--n-devices", "4"],
    ["--sparse-rows", "on", "--n-devices", "4"],
    ["--obs-quality", "--code", "qsgd"],
    ["--budget-alloc", "variance", "--code", "qsgd"],
    ["--error-feedback", "--code", "qsgd", "--n-devices", "4"],
    ["--on-diverge", "skip", "--train-dir", "x", "--save-freq", "2"],
], ids=["delayed", "stream", "sparse", "quality", "budget", "ef", "diverge"])
def test_phase_metrics_conflicts_carry_the_jax_texts(extra):
    argv = ["train", "--synthetic", "--phase-metrics"] + extra
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"], log_fn=lambda _: None)
    assert str(got.value.code) == str(want.value.code)
    assert "report timeline" in str(got.value.code)


def test_phase_metrics_warnings_are_the_jax_verbs(tmp_path):
    """The deprecation warning, and the superstep one (forced to 1): a
    one-device run warns and trains (the single-device loop takes neither
    flag, as in the JAX verb)."""
    argv = ["train", "--network", "LeNet", "--synthetic", "--batch-size", "8", "--max-steps",
            "1", "--log-interval", "1", "--eval-freq", "0", "--train-dir", "",
            "--phase-metrics", "--superstep", "2", "--profile-dir", str(tmp_path / "p")]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert cli.main(argv + ["--device", "cpu"], log_fn=lambda _: None) == 0
    msgs = [str(w.message) for w in caught]
    assert any(m.startswith("--phase-metrics is DEPRECATED: it times the four phases")
               for m in msgs)
    assert any(m.startswith("--phase-metrics times individual phase programs and cannot run "
                            "under a fused superstep scan; forcing --superstep 1") for m in msgs)
    assert not (tmp_path / "p").exists()


def test_phased_worker_and_master_lines(runs):
    _, r = runs["phased"]
    workers = [ln for ln in r["lines"] if ln.startswith("Worker:")]
    masters = [ln for ln in r["lines"] if ln.startswith("Master:")]
    assert len(workers) == len(masters) == 3
    for ln in workers:
        comp, enc, comm = (float(x) for x in re.search(
            r"Comp: ([\d.]+), Encode: +([\d.]+), Comm: +([\d.]+)", ln).groups())
        assert comp > 0 and enc > 0 and comm > 0
    assert re.fullmatch(r"Master: Step: 6, Decode Cost: [\d.e-]+, Cur lr 0\.01, Gather: "
                        r"[\d.e-]+", masters[-1])


def test_phased_run_equals_the_fused_run(runs):
    (fd, fr), (pd, pr) = runs["fused"], runs["phased"]

    def losses(lines):
        return [re.search(r"Loss: ([\d.]+)", ln).group(1) for ln in lines
                if ln.startswith("Worker:")]

    assert losses(fr["lines"]) == losses(pr["lines"])
    for s in (3, 6):
        assert (fd / f"model_step_{s}").read_bytes() == (pd / f"model_step_{s}").read_bytes()
