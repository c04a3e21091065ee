"""The flight recorder, its readers and the run report of the port, as units.

Mirrors the JAX package's recorder tests (``tests/test_obs.py:89-315``) on
the port's :mod:`atomo_tpu_torch.obs.recorder`: the step schema and the
calibration column, ``(K,)`` and ``(K, L)`` series, shares that do not
change with the block partition, a torn line, NaN written as null,
``write_meta`` idempotent, the calibration column gated on a prediction,
pruning that keeps meta lines, ``checkpoint.prune_after`` in lockstep,
``prune_past``, and the worker-line sink (byte-identical disarmed). Then
the two packages against each other on the same inputs: each reads the
other's ``metrics.jsonl`` and writes the same records, ``rolling_calibration``
(hypothesis), ``resolve_predicted_ms`` and the artifact readers agree, and
``build_report`` / ``summarize_report`` give the same document and text
over directories made to pass and to fail every run-mode check.
"""

import json
import math
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import atomo_tpu.controller.artifact as jctl
import atomo_tpu.obs.fabric as jfab
import atomo_tpu.obs.recorder as jrec
import atomo_tpu.obs.report as jrep
import atomo_tpu.quorum.artifact as jq
import atomo_tpu.utils.comm_model as jcm
import atomo_tpu_torch.controller.artifact as pctl
import atomo_tpu_torch.obs.fabric as pfab
import atomo_tpu_torch.obs.recorder as prec
import atomo_tpu_torch.obs.report as prep
import atomo_tpu_torch.quorum.artifact as pq
import atomo_tpu_torch.utils.comm_model as pcm
from atomo_tpu.utils.metrics import StepMetrics as JaxStepMetrics
from atomo_tpu_torch.obs.recorder import (
    FlightRecorder,
    emit_worker_line,
    metrics_path,
    prune_metrics_after,
)
from atomo_tpu_torch.utils.metrics import StepMetrics
from atomo_tpu_torch.utils.tracing import IncidentLog

# ---------------------------------------------------------------- recorder


def test_step_schema_and_calibration(tmp_path):
    rec = FlightRecorder.for_train_dir(str(tmp_path), predicted_ms=2.0)
    rec.set_context(aggregate="gather")
    rec.record_block(1, {"loss": 2.5, "msg_bytes": 1024, "skipped": 0.0, "dropped": 0.0},
                     wall_s=0.004, generation=0)
    (r,) = FlightRecorder.read(metrics_path(str(tmp_path)))
    assert r["kind"] == "step" and r["step"] == 1
    assert r["loss"] == 2.5 and r["msg_bytes"] == 1024.0
    assert r["step_ms"] == pytest.approx(4.0)
    assert r["aggregate"] == "gather" and r["epoch"] == 0 and r["generation"] == 0
    assert r["predicted_ms"] == 2.0 and r["calib"] == pytest.approx(2.0)


def test_block_series_and_quality_columns(tmp_path):
    rec = FlightRecorder.for_train_dir(str(tmp_path))
    out = rec.record_block(5, {"loss": np.array([1.0, 2.0, 3.0]),
                               "skipped": np.array([0.0, 1.0, 0.0]),
                               "q_rel": np.arange(6.0).reshape(3, 2)}, wall_s=0.03)
    assert [r["step"] for r in out] == [5, 6, 7]
    assert [r["loss"] for r in out] == [1.0, 2.0, 3.0] and out[1]["skipped"] == 1.0
    assert out[2]["q_rel"] == [4.0, 5.0]
    assert all(r["step_ms"] == pytest.approx(10.0) for r in out)


def test_shares_do_not_change_with_the_block_partition(tmp_path):
    losses, qs = [1.0, 2.0, 3.0, 4.0], np.arange(8.0).reshape(4, 2)
    a = FlightRecorder.for_train_dir(str(tmp_path / "block"))
    a.record_block(1, {"loss": np.asarray(losses), "q_rel": qs}, wall_s=0.04)
    b = FlightRecorder.for_train_dir(str(tmp_path / "steps"))
    for i, loss in enumerate(losses):
        b.record_block(1 + i, {"loss": loss, "q_rel": qs[i]}, wall_s=0.01)

    def strip(path):
        return [{k: v for k, v in r.items() if k != "ts"}
                for r in FlightRecorder.read_steps(metrics_path(path))]

    assert strip(str(tmp_path / "block")) == strip(str(tmp_path / "steps"))


def test_torn_line_is_skipped_and_the_file_stays_appendable(tmp_path):
    rec = FlightRecorder.for_train_dir(str(tmp_path))
    rec.record_block(1, {"loss": 1.0})
    with open(rec.path, "a") as f:
        f.write('{"kind": "step", "step": 2, "los')  # killed mid-write
    assert [r["step"] for r in FlightRecorder.read_steps(rec.path)] == [1]
    rec.record_block(2, {"loss": 2.0})
    assert all(isinstance(r["step"], int) for r in FlightRecorder.read_steps(rec.path))
    rec.record_block(3, {"loss": 3.0})
    assert FlightRecorder.read_steps(rec.path)[-1]["step"] == 3


def test_nonfinite_values_are_written_as_null(tmp_path):
    rec = FlightRecorder.for_train_dir(str(tmp_path))
    rec.record_block(1, {"loss": float("nan"), "grad_norm": float("inf"),
                         "q_rel": np.array([1.0, float("nan")])})
    raw = open(rec.path).read()
    assert "NaN" not in raw and "Infinity" not in raw
    r = json.loads(raw.strip(), parse_constant=lambda c: pytest.fail(f"non-strict {c}"))
    assert r["loss"] is None and r["grad_norm"] is None and r["q_rel"] == [1.0, None]


def test_write_meta_is_idempotent_per_what(tmp_path):
    FlightRecorder.for_train_dir(str(tmp_path)).write_meta({"what": "obs_quality", "n": 2})
    FlightRecorder.for_train_dir(str(tmp_path)).write_meta({"what": "obs_quality", "n": 2})
    metas = [r for r in FlightRecorder.read(metrics_path(str(tmp_path))) if r["kind"] == "meta"]
    assert len(metas) == 1


def test_calibration_column_is_gated_on_a_prediction(tmp_path):
    """A stale tune_decision.json left in the directory by another run does
    not make a calibration series: the port's train has no --auto, so its
    recorder gets no prediction."""
    from atomo_tpu_torch import cli
    from atomo_tpu_torch.utils.tracing import write_json_atomic

    write_json_atomic(str(tmp_path / "tune_decision.json"),
                      {"complete": True, "winner": {"name": "x", "predicted_ms_per_step": 0.3,
                                                    "knobs": {}}})
    assert prec.resolve_predicted_ms(str(tmp_path)) == 0.3
    rc = cli.main(["train", "--synthetic", "--dataset", "mnist", "--network", "lenet",
                   "--batch-size", "8", "--max-steps", "2", "--eval-freq", "0",
                   "--log-interval", "0", "--code", "qsgd", "--quantization-level", "8",
                   "--train-dir", str(tmp_path), "--obs-record", "--momentum", "0.0",
                   "--device", "cpu"], log_fn=lambda _: None)
    assert rc == 0
    steps = FlightRecorder.read_steps(metrics_path(str(tmp_path)))
    assert len(steps) == 2 and all("predicted_ms" not in r and "calib" not in r for r in steps)


def test_prune_cuts_step_and_log_records_and_keeps_meta(tmp_path):
    rec = FlightRecorder.for_train_dir(str(tmp_path))
    rec.write_meta({"what": "obs_quality", "n_layers": 2})
    for s in range(1, 9):
        rec.record_block(s, {"loss": float(s)})
    emit_worker_line(rec, StepMetrics(step=8), log_fn=lambda _: None)
    assert prune_metrics_after(str(tmp_path), 5) == 4  # steps 6-8 and the log of 8
    recs = FlightRecorder.read(metrics_path(str(tmp_path)))
    assert recs[0]["kind"] == "meta" and max(r["step"] for r in recs if "step" in r) == 5
    assert prune_metrics_after("", 1) == 0 and prune_metrics_after(str(tmp_path / "no"), 1) == 0


def test_checkpoint_prune_after_cuts_metrics_in_lockstep(tmp_path):
    from atomo_tpu_torch.training.checkpoint import prune_after

    rec = FlightRecorder.for_train_dir(str(tmp_path))
    for s in range(1, 7):
        rec.record_block(s, {"loss": float(s)})
    prune_after(str(tmp_path), 3)  # no checkpoints: the metrics are cut all the same
    assert [r["step"] for r in FlightRecorder.read_steps(rec.path)] == [1, 2, 3]


def test_prune_past_is_the_resume_hook(tmp_path):
    rec = FlightRecorder.for_train_dir(str(tmp_path))
    for s in range(1, 6):
        rec.record_block(s, {"loss": float(s)})
    assert rec.prune_past(2) == 3
    rec.record_block(3, {"loss": 3.5})  # the replayed step records again
    assert [r["step"] for r in FlightRecorder.read_steps(rec.path)] == [1, 2, 3]


_GOLDEN = (
    "Worker: 0, Step: 12, Epoch: 1 [384/10000 (4%)], Loss: 2.3456, "
    "Time Cost: 0.1234, Comp: 0.0000, Encode:  0.0000, Comm:  0.0000, "
    "Msg(MB):  0.5547, Prec@1:  12.5000, Prec@5:  50.0000"
)
_GOLDEN_FIELDS = dict(rank=0, step=12, epoch=1, samples_seen=384, dataset_size=10000,
                      loss=2.3456, time_cost=0.1234, comp_dur=0.0, encode_dur=0.0,
                      comm_dur=0.0, msg_bytes=581632, prec1=12.5, prec5=50.0)


@pytest.mark.parametrize("armed", [False, True], ids=["disarmed", "armed"])
def test_worker_line_sink(tmp_path, armed):
    """Disarmed, the sink prints the golden line and nothing else; armed it
    prints the same line and writes a ``log`` record of the same fields,
    the JAX package's record key for key."""
    lines, jlines = [], []
    rec = jr = None
    if armed:
        rec = FlightRecorder.for_train_dir(str(tmp_path / "port")).set_context(aggregate="ring")
        jr = jrec.FlightRecorder.for_train_dir(str(tmp_path / "jax")).set_context(
            aggregate="ring")
    emit_worker_line(rec, StepMetrics(**_GOLDEN_FIELDS), log_fn=lines.append)
    jrec.emit_worker_line(jr, JaxStepMetrics(**_GOLDEN_FIELDS), log_fn=jlines.append)
    assert lines == jlines == [_GOLDEN]
    if not armed:
        assert not (tmp_path / "port").exists()
        return
    got, want = (FlightRecorder.read(r.path) for r in (rec, jr))
    assert len(got) == 1 and got[0]["kind"] == "log" and got[0]["epoch"] == 1
    assert got[0]["aggregate"] == "ring" and got[0]["msg_bytes"] == 581632
    assert [{k: v for k, v in r.items() if k != "ts"} for r in got] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in want]


# ------------------------------------------------ the two packages, one file

_BLOCKS = {
    "scalars": (3, {"loss": 2.0, "prec1": 50.0, "msg_bytes": 100, "dense_bytes": 400,
                    "skipped": 0.0, "grad_norm": 1.5}),
    "series": (1, {"loss": np.array([1.0, 0.5, 0.25]), "dropped": np.array([0.0, 1.0, 0.0]),
                   "q_err2": np.arange(6.0).reshape(3, 2), "q_rel": np.ones((3, 2)),
                   "msg_bytes": 7}),
    "nonfinite": (9, {"loss": float("nan"), "q_err2": np.array([1.0, float("inf")])}),
}


@pytest.mark.parametrize("name", sorted(_BLOCKS))
def test_each_package_reads_the_others_file(tmp_path, name):
    """The same calls write the same records in both packages (``ts``
    aside), and each package's reader reads the other's file."""
    first, metrics = _BLOCKS[name]
    files = {}
    for pkg, mod in (("port", prec), ("jax", jrec)):
        r = mod.FlightRecorder.for_train_dir(str(tmp_path / pkg), predicted_ms=5.0)
        r.set_context(aggregate="gather", budget_epoch=0)
        r.write_meta({"what": "obs_quality", "layers": [{"name": "['a']"}]})
        r.record_block(first, metrics, wall_s=0.012, generation=1)
        files[pkg] = r.path

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "ts"} for r in recs]

    port, jax_ = strip(prec.FlightRecorder.read(files["port"])), \
        strip(jrec.FlightRecorder.read(files["jax"]))
    assert port == jax_ and len(port) > 1
    assert strip(jrec.FlightRecorder.read(files["port"])) == port
    assert strip(prec.FlightRecorder.read(files["jax"])) == jax_
    assert prec.FlightRecorder.read_steps(files["jax"]) == \
        jrec.FlightRecorder.read_steps(files["jax"])


_FLOATS = st.one_of(st.floats(allow_nan=True, allow_infinity=True, width=64),
                    st.floats(min_value=1e-6, max_value=1e3))


@settings(max_examples=200, deadline=None)
@given(prev=st.one_of(st.none(), st.floats(min_value=1e-3, max_value=1e3)),
       measured=_FLOATS, predicted=_FLOATS, window=st.integers(-2, 100))
def test_rolling_calibration_equals_the_jax_function(prev, measured, predicted, window):
    got = pcm.rolling_calibration(prev, measured, predicted, window)
    want = jcm.rolling_calibration(prev, measured, predicted, window)
    assert got == want or (got is not None and want is not None
                           and math.isnan(got) and math.isnan(want))


def _decision(pred):
    return {"complete": True, "winner": {"name": "w", "predicted_ms_per_step": pred,
                                         "knobs": {"aggregate": "gather"}}}


@pytest.mark.parametrize("files", [
    {}, {"tune_decision.json": _decision(12.5)},
    {"controller_decision.json": _decision(3.0), "tune_decision.json": _decision(12.5)},
    {"controller_decision.json": "{torn", "tune_decision.json": _decision(7)},
    {"tune_decision.json": _decision(-1.0)}, {"tune_decision.json": _decision("x")},
], ids=["none", "tune", "controller-first", "torn-controller", "negative", "not-a-number"])
def test_resolve_predicted_ms_and_the_readers_agree(tmp_path, files):
    for name, doc in files.items():
        (tmp_path / name).write_text(doc if isinstance(doc, str) else json.dumps(doc))
    d = str(tmp_path)
    assert prec.resolve_predicted_ms(d) == jrec.resolve_predicted_ms(d)
    assert prec.resolve_predicted_ms("") is jrec.resolve_predicted_ms("") is None
    assert pctl.read_controller(d) == jctl.read_controller(d)
    assert pctl.controller_path(d) == jctl.controller_path(d)
    assert pfab.read_fabric_probe(d) == jfab.read_fabric_probe(d) is None
    assert pfab.probe_path(d) == jfab.probe_path(d)


def test_artifact_readers_agree_on_written_artifacts(tmp_path):
    d = str(tmp_path)
    (tmp_path / "fabric_probe.json").write_text(json.dumps(
        {"complete": True, "tiers": [{"label": "ici", "bandwidth_gbps": 42.0}]}))
    lines = [{"kind": "meta", "what": "quorum_config", "quorum": 1, "staleness": 1},
             {"kind": "arrival", "step": 1, "staleness": [0, 1], "kept": 2, "dropped": 0},
             {"kind": "arrival", "step": 2, "staleness": [0, -1], "kept": 1, "dropped": 1}]
    (tmp_path / "arrival_schedule.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in lines) + '{"kind": "arri')
    assert pfab.read_fabric_probe(d) == jfab.read_fabric_probe(d)
    assert pfab.read_fabric_probe(d)["tiers"][0]["label"] == "ici"
    path = pq.schedule_path(d)
    assert path == jq.schedule_path(d) and pq.read_schedule(path) == jq.read_schedule(path)
    assert sorted(pq.read_schedule(path)[1]) == [1, 2]
    assert pq.read_schedule(str(tmp_path / "none.jsonl")) == (None, {})


# ------------------------------------------------------------- the report


def _steps(d, spans, **cols):
    """Step records over ``spans`` ((first, last) pairs) with per-step
    columns from ``cols`` (callables of the step)."""
    rec = prec.FlightRecorder.for_train_dir(d)
    for a, b in spans:
        for s in range(a, b + 1):
            rec.record_block(s, {"loss": 1.0 / s, **{k: f(s) for k, f in cols.items()}},
                             wall_s=0.01)
    return rec


def _ctx(d, spans, **ctx_at):
    """Step records whose context columns change with the step
    (``ctx_at[name](step)``)."""
    rec = prec.FlightRecorder.for_train_dir(d)
    for a, b in spans:
        for s in range(a, b + 1):
            rec.set_context(**{k: f(s) for k, f in ctx_at.items()})
            rec.record_block(s, {"loss": 1.0 / s}, wall_s=0.02)
    return rec


def _json(d, name, doc):
    with open(os.path.join(d, name), "w") as f:
        f.write(json.dumps(doc))


def _membership(d, ok):
    _json(d, "membership.json", {"epochs": [
        {"epoch": 0, "start_step": 0, "world_size": 2, "reason": "init"},
        {"epoch": 1, "start_step": 3, "world_size": 1, "reason": "shrink", "dead": [1]}]})
    log = IncidentLog.for_train_dir(d)
    log.append("membership", action="begin", step=0, epoch=0, world=2)
    if ok:
        log.append("membership", action="shrink", step=3, epoch=1, world=1)
    _ctx(d, [(1, 6)], epoch=lambda s: 0 if s <= 3 else 1)


def _retune(d, ok):
    IncidentLog.for_train_dir(d).append(
        "perf_drift", action="retune->ring", step=3,
        blame={"verdict": "program", "step_ms": {"baseline": 1.0}})
    _ctx(d, [(1, 6)], aggregate=lambda s: "gather" if s <= 3 or not ok else "ring")


def _rollback(d, ok):
    IncidentLog.for_train_dir(d).append("divergence", action="rollback->2", step=5, target=2)
    _steps(d, [(1, 4), (3, 6)] if not ok else [(1, 6)])


def _density(d, ok):
    rec = _steps(d, [(1, 3)], q_rel=lambda s: np.array([0.1, 0.2]))
    rec.write_meta({"what": "obs_quality", "layers": [
        {"name": "['table']", "shape": [128, 4], "dense_bytes": 2048, "payload_bytes": 500,
         "assignment": "sparse", "density": 0.2 if ok else 1.5, "row_budget": 24},
        {"name": "['Dense_0']['kernel']", "shape": [4, 2], "dense_bytes": 32,
         "payload_bytes": 32, "assignment": "dense", "density": 1.0}]})


def _fabric(d, ok):
    _json(d, "tune_decision.json", {"complete": True, "winner": {
        "name": "w", "predicted_ms_per_step": 4.0, "measured_ms_per_step": 5.0,
        "knobs": {"aggregate": "gather"}}, "why": "test",
        "meta": {"fabric": "measured", "fabric_tiers": {"ici": 40.0 if ok else 41.0}}})
    _json(d, "fabric_probe.json", {"complete": True,
                                   "tiers": [{"label": "ici", "bandwidth_gbps": 40.0}]})
    _steps(d, [(1, 3)])


def _blame(d, ok):
    IncidentLog.for_train_dir(d).append(
        "perf_drift", action="retune_keep", step=2,
        blame={"verdict": "fabric", "step_ms": {"baseline": 2.0},
               "fabric": {"ici": {"measured_gbps": 10.0, "baseline_gbps": 20.0}}}
        if ok else {"verdict": "fabric", "step_ms": {}})
    _steps(d, [(1, 3)])


def _budget(d, ok):
    _json(d, "budget_alloc.json", {"kind": "budget_alloc", "epochs": [
        {"epoch": 0, "start_step": 0, "payload_bytes": 300, "ks": [2, 3]}]})
    rec = _steps(d, [(1, 4)], budget_epoch=lambda s: 0)
    rec.write_meta({"what": "budget_alloc_epoch0", "budget_epoch": 0, "layers": [
        {"payload_bytes": 100}, {"payload_bytes": 200 if ok else 201}]})
    _ctx(d, [(5, 5)], budget_epoch=lambda s: 0 if ok else 1)


def _quorum(d, ok):
    lines = [{"kind": "meta", "what": "quorum_config", "quorum": 1, "staleness": 1}] + [
        {"kind": "arrival", "step": s, "staleness": [0, -1 if s == 2 else 1],
         "kept": 1 if s == 2 else 2, "dropped": 1 if s == 2 else 0} for s in (1, 2, 3)]
    with open(os.path.join(d, "arrival_schedule.jsonl"), "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in lines))
    if ok:
        IncidentLog.for_train_dir(d).append("staleness_exceeded", action="drop", step=2)
    rec = prec.FlightRecorder.for_train_dir(d)
    for s in (1, 2, 3):
        rec.record_block(s, {"loss": 1.0, "quorum_kept": 1.0 if s == 2 else 2.0})


def _controller(d, ok):
    _json(d, "controller_decision.json", {
        "kind": "controller_decision", "complete": True,
        "winner": {"name": "w", "knobs": {"aggregate": "gather", "budget_alloc": "uniform"},
                   "predicted_ms_per_step": 3.0},
        "meta": {"controller": {"layout": "dp-sp"}, "mesh_axes": {"dp": 2, "sp": 1}}})
    _json(d, "tune_decision.json", {"complete": True, "winner": {
        "name": "t", "knobs": {"aggregate": "gather" if ok else "ring"}}})
    IncidentLog.for_train_dir(d).append(
        "controller_redecide", action="apply", step=2,
        knobs_old={"aggregate": "gather"}, knobs_new={"aggregate": "ring"})
    rec = _steps(d, [(1, 3)])
    rec.write_meta({"what": "model_axes", "layout": "dp-sp" if ok else "dp-tp",
                    "mesh_axes": {"dp": 2, "sp": 1},
                    "exchange": {"aggregate": "gather", "stream_encode": False,
                                 "overlap": "off"}})


_SCENARIOS = {"membership": _membership, "retune": _retune, "rollback": _rollback,
              "density": _density, "fabric": _fabric, "blame": _blame, "budget": _budget,
              "quorum": _quorum, "controller": _controller}


@pytest.mark.parametrize("ok", [True, False], ids=["consistent", "contradicted"])
@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_report_equals_the_jax_report(tmp_path, scenario, ok):
    """Each directory exercises one check (two for the controller); the
    port's document and post-mortem text are the JAX package's, and the
    check runs (not skipped) with the verdict the artifacts call for."""
    d = str(tmp_path)
    _SCENARIOS[scenario](d, ok)
    got, want = prep.build_report(d), jrep.build_report(d)
    assert got == want
    assert prep.summarize_report(got) == jrep.summarize_report(want)
    assert got["consistent"] is ok
    ran = [c["name"] for c in got["checks"] if not c["skipped"]]
    assert ran and all(c["ok"] for c in got["checks"]) is ok


def test_report_of_an_empty_directory_skips_every_check(tmp_path):
    got = prep.build_report(str(tmp_path))
    assert got == jrep.build_report(str(tmp_path))
    assert got["consistent"] and all(c["skipped"] for c in got["checks"])
    assert prep.report_path(str(tmp_path)) == jrep.report_path(str(tmp_path))
    assert [prep._fmt(x) for x in (1.23456, None, "a")] == \
        [jrep._fmt(x) for x in (1.23456, None, "a")]
