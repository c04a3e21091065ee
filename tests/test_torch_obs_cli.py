"""``train --obs-record --obs-quality``, ``lm --train-dir``, the ``report``
verb and ``evaluate``'s flags, against the JAX verbs on the CPU.

* The refusals of the obs flags carry the JAX verb's messages; the port
  arms the online budget re-allocation where the JAX verb arms it (several
  devices, both obs flags, a save cadence) with the JAX verb's line, and
  prints the frozen line otherwise; ``report timeline`` without a trace
  exits with the JAX verb's message and ``--fleet`` is refused by name; a
  frozen variance allocation is recorded and passes the JAX report's audit.
* ``report`` over a directory written by the port's ``train`` (LeNet, qsgd,
  both obs flags, 6 steps): one ``step`` record a step, every layer's
  series, the JAX package's ``build_report`` over the same directory equal
  to the port's document but for ``train_dir``, both consistent; the JAX
  package reads the file; ``--strict`` exits 3 on a tail doctored to
  regress, as the JAX verb does; a missing directory exits with its
  message. Armed, the run prints what the disarmed run prints (the worker
  lines' Time Cost aside).
* The supervised ``kill@5`` drill with ``--obs-record``: each step in
  ``metrics.jsonl`` exactly once, the report consistent; the doctor's
  rollback (``spike@7:3 --on-diverge skip``) cuts the metrics with the
  checkpoints.
* ``lm --train-dir`` writes the ``model_axes`` meta line that the JAX
  report's layout check takes against a controller decision.
* ``evaluate`` takes ``train``'s flags (ROADMAP queue 3 fault 1): one flag
  line shared with ``train`` runs on both packages' verbs, with the same
  output and warnings.
"""

import os
import re
import warnings

import pytest
from test_torch_resilience_cli import cli as cli_process

from atomo_tpu import cli as jax_cli
from atomo_tpu.obs.recorder import FlightRecorder as JaxRecorder
from atomo_tpu.obs.report import build_report as jax_build_report
from atomo_tpu_torch import cli
from atomo_tpu_torch.obs.recorder import FlightRecorder, metrics_path
from atomo_tpu_torch.obs.report import build_report
from atomo_tpu_torch.utils.tracing import read_jsonl, write_json_atomic

LENET = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
         "--batch-size", "16", "--log-interval", "1", "--eval-freq", "0"]


def _port(argv):
    lines = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rc = cli.main(argv + (["--device", "cpu"] if argv[0] != "report" else []),
                      log_fn=lines.append)
    return rc, lines, [str(w.message) for w in caught]


def _jax(capsys, argv):
    capsys.readouterr()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rc = jax_cli.main(argv)
    return rc, capsys.readouterr().out.splitlines(), [str(w.message) for w in caught]


@pytest.mark.parametrize("extra", [
    ["--obs-record", "--train-dir", ""],
    ["--obs-quality", "--code", "sgd"],
    ["--obs-quality", "--code", "qsgd", "--overlap", "delayed", "--aggregate", "gather"],
    ["--obs-quality", "--obs-record", "--code", "qsgd", "--budget-alloc", "variance",
     "--on-diverge", "skip", "--train-dir", "x"],
], ids=["record-no-dir", "quality-dense", "quality-delayed", "realloc-diverge"])
def test_refusals_carry_the_jax_messages(extra):
    argv = LENET + ["--max-steps", "2"] + extra
    with pytest.raises(SystemExit) as port:
        cli.main(argv + ["--device", "cpu"], log_fn=lambda _: None)
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    assert str(port.value.code) == str(want.value.code) and len(str(want.value.code)) > 40


def test_online_reallocation_is_refused_by_name(tmp_path):
    """Over several devices with both obs flags and a save cadence the JAX
    verb arms its online re-allocation, and so does the port, with its line
    (a retuner on every rank, the writer's alone owning the artifacts);
    with one flag off, or on one device, it prints the JAX verb's frozen
    line."""
    from atomo_tpu_torch.budget import BudgetRetuner, Allocation

    args = cli.build_parser().parse_args(
        LENET + ["--code", "qsgd", "--budget-alloc", "variance", "--obs-quality",
                 "--obs-record", "--save-freq", "2", "--train-dir", str(tmp_path)])
    alloc = Allocation(mode="variance", ks=(4, 4), payload_bytes=8, budget_bytes=8,
                       predicted_variance=1.0)
    doc = {"epochs": [{"epoch": 0, "start_step": 0}]}
    lines = []
    recorder, tuner = cli._recorder(args, 2, lines.append, write=False,
                                    budget=("codec", [], alloc, doc))
    assert recorder is None and isinstance(tuner, BudgetRetuner) and not tuner.owner
    assert tuner.alloc is alloc and tuner.last_boundary == 0
    assert lines == ["Budget: online re-allocation armed (q_err2-fed re-solve at checkpoint "
                     "boundaries; decisions land in incidents.jsonl as budget_realloc)"]
    lines.clear()
    assert cli._recorder(args, 1, lines.append, write=False) == (None, None)
    assert lines == ["Budget: allocation frozen for this run"]
    args.obs_quality = False
    lines.clear()
    assert cli._recorder(args, 2, lines.append, write=False) == (None, None)
    assert lines == ["Budget: allocation frozen for this run (arm --obs-quality "
                     "--obs-record with a checkpoint cadence to re-solve at boundaries)"]


def test_budget_allocation_is_recorded_and_audited(tmp_path):
    """``--budget-alloc variance --obs-record`` on one device: the
    allocation's meta line and the ``budget_epoch`` column, which the JAX
    report's ``budget_alloc_consistent`` check holds against
    ``budget_alloc.json``; the frozen line of the JAX verb."""
    rc, lines, _ = _port(LENET + ["--max-steps", "3", "--code", "qsgd", "--budget-alloc",
                                  "variance", "--obs-record", "--train-dir", str(tmp_path)])
    assert rc == 0 and "Budget: allocation frozen for this run (arm --obs-quality " \
        "--obs-record with a checkpoint cadence to re-solve at boundaries)" in lines
    recs = read_jsonl(metrics_path(str(tmp_path)))
    assert [r["what"] for r in recs if r["kind"] == "meta"] == ["budget_alloc_epoch0"]
    assert [r["budget_epoch"] for r in recs if r["kind"] == "step"] == [0, 0, 0]
    check = [c for c in jax_build_report(str(tmp_path))["checks"]
             if c["name"] == "budget_alloc_consistent"][0]
    assert check["ok"] and not check["skipped"]


@pytest.mark.parametrize("argv,match", [
    (["report", "timeline"], "report timeline: profile dir .* does not exist — run training "
                             "with --profile-dir DIR to capture a trace"),
    (["report", "--fleet"], "ROADMAP queue 1 item 11"),
], ids=["timeline", "fleet"])
def test_report_modes_not_ported_are_refused(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["--train-dir", str(tmp_path)])


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The port's 6-step LeNet qsgd run with both obs flags, and the same
    run disarmed: (directory, armed lines, disarmed lines)."""
    d = tmp_path_factory.mktemp("armed")
    flags = LENET + ["--max-steps", "6", "--code", "qsgd", "--save-freq", "3"]
    rc, armed, _ = _port(flags + ["--obs-record", "--obs-quality", "--train-dir", str(d)])
    assert rc == 0
    rc, plain, _ = _port(flags + ["--train-dir", str(tmp_path_factory.mktemp("plain"))])
    assert rc == 0
    return d, armed, plain


def test_recorded_run_reads_in_both_packages(recorded):
    d, armed, plain = recorded
    steps = FlightRecorder.read_steps(metrics_path(str(d)))
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5, 6]
    assert all(len(r["q_err2"]) == len(r["q_rel"]) == 8 and r["aggregate"] == "local"
               for r in steps)
    recs = JaxRecorder.read(metrics_path(str(d)))
    assert recs == read_jsonl(metrics_path(str(d)))
    assert [r["what"] for r in recs if r["kind"] == "meta"] == ["obs_quality"]
    assert len([r for r in recs if r["kind"] == "log"]) == 6

    def mask(lines):
        return [re.sub(r"Time Cost: [0-9.]+", "Time Cost: -", ln) for ln in lines]

    assert mask(armed) == mask(plain) and len(plain) == 6


def test_report_equals_the_jax_report_and_strict(recorded, capsys):
    d, _, _ = recorded
    rc, lines, _ = _port(["report", "--train-dir", str(d), "--strict"])
    assert rc == 0 and lines[-1] == f"run report -> {d / 'run_report.json'}"
    assert "  consistency: OK (1 check(s) ran, 10 skipped)" in lines[0].splitlines()
    got = build_report(str(d))
    want = jax_build_report(str(d))
    got.pop("train_dir"), want.pop("train_dir")
    assert got == want and got["consistent"] and got["summary"]["quality_armed"]
    # a tail that survived a prune: the step sequence regresses
    FlightRecorder.for_train_dir(str(d)).record_block(4, {"loss": 1.0})
    rc, lines, _ = _port(["report", "--train-dir", str(d), "--strict"])
    jrc, jlines, _ = _jax(capsys, ["report", "--train-dir", str(d), "--strict"])
    assert rc == jrc == 3
    assert "metrics_monotone" in lines[0] and lines[0].splitlines()[1:] == jlines[1:-1]
    with pytest.raises(SystemExit) as port:
        cli.main(["report", "--train-dir", str(d / "missing")])
    with pytest.raises(SystemExit) as jax_:
        jax_cli.main(["report", "--train-dir", str(d / "missing")])
    assert str(port.value.code) == str(jax_.value.code)


def test_supervised_kill_drill_records_each_step_once(tmp_path):
    p = cli_process("--max-steps", "8", "--save-freq", "2", "--train-dir", str(tmp_path),
                    "--chaos", "kill@5", "--max-restarts", "1", "--restart-backoff", "0.05",
                    "--obs-record")
    assert p.returncode == 0, p.stderr[-2000:]
    steps = FlightRecorder.read_steps(metrics_path(str(tmp_path)))
    assert [r["step"] for r in steps] == list(range(1, 9))
    doc = build_report(str(tmp_path))
    assert doc["consistent"] and doc["summary"]["incidents"] == 2
    assert cli.main(["report", "--train-dir", str(tmp_path), "--strict"],
                    log_fn=lambda _: None) == 0


def test_rollback_cuts_the_metrics_with_the_checkpoints(tmp_path):
    p = cli_process("--max-steps", "14", "--save-freq", "2", "--grad-guard", "--on-diverge",
                    "skip", "--diverge-window", "4", "--diverge-zmax", "4",
                    "--diverge-patience", "2", "--diverge-min-history", "4",
                    "--train-dir", str(tmp_path), "--chaos", "spike@7:3", "--obs-record",
                    env={"ATOMO_CHAOS_SPIKE_SCALE": "100"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert "Doctor: divergence at step 8" in p.stdout
    steps = FlightRecorder.read_steps(metrics_path(str(tmp_path)))
    assert [r["step"] for r in steps] == list(range(1, 15))
    assert {r["generation"] for r in steps if r["step"] > 2} == {1}
    doc = jax_build_report(str(tmp_path))
    assert doc["consistent"] and "across 1 rollback prune(s)" in [
        c["detail"] for c in doc["checks"] if c["name"] == "metrics_monotone"][0]


def test_lm_records_the_layout_the_jax_report_checks(tmp_path):
    rc, lines, _ = _port(["lm", "--layout", "dp-sp", "--ways", "1", "--vocab-size", "16",
                          "--seq-len", "16", "--width", "16", "--depth", "1", "--num-heads",
                          "2", "--batch-size", "2", "--max-steps", "2", "--log-interval",
                          "1", "--code", "svd", "--train-dir", str(tmp_path)])
    assert rc == 0
    recs = read_jsonl(metrics_path(str(tmp_path)))
    meta = [r for r in recs if r["kind"] == "meta"]
    assert [(m["what"], m["layout"], m["mesh_axes"], m["exchange"]) for m in meta] == [
        ("model_axes", "dp-sp", {"dp": 1, "sp": 1}, None)]
    assert [r["step"] for r in recs if r["kind"] == "step"] == [1, 2]
    write_json_atomic(str(tmp_path / "controller_decision.json"), {
        "kind": "controller_decision", "complete": True,
        "winner": {"name": "w", "knobs": {"aggregate": "psum"}},
        "meta": {"controller": {"layout": "dp-sp"}, "mesh_axes": {"dp": 1, "sp": 1}}})
    check = [c for c in jax_build_report(str(tmp_path))["checks"]
             if c["name"] == "model_axes_layout_consistent"][0]
    assert check["ok"] and not check["skipped"]


def test_evaluate_takes_the_train_flags_as_the_jax_verb(tmp_path, capsys):
    """ROADMAP queue 3 fault 1: ``evaluate`` with a flag line shared with
    ``train`` (``--lr 0.01 --code svd``) runs on both verbs, printing and
    warning alike; on the port it then evaluates a port checkpoint."""
    argv = ["evaluate", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
            "--train-dir", str(tmp_path), "--max-polls", "1", "--poll-interval", "0",
            "--lr", "0.01", "--code", "svd"]
    rc, lines, warns = _port(argv)
    jrc, jlines, jwarns = _jax(capsys, argv)
    assert (rc, lines, warns) == (jrc, jlines, jwarns) == (0, [], [
        "--svd-rank 0 maps to the reference's rank-0 mode only with --sample bernoulli; "
        "using rank 3 for the fixed-budget sampler"])
    assert _port(LENET + ["--max-steps", "2", "--save-freq", "2", "--code", "svd",
                          "--train-dir", str(tmp_path)])[0] == 0
    rc, lines, _ = _port(argv)
    assert rc == 0 and len(lines) == 1 and lines[0].startswith("Evaluator: Step: 2, Loss: ")
    assert os.path.exists(tmp_path / "model_step_2")
