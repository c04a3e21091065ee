"""``train --quorum`` on the CLI: the preflight against the JAX verb's, and
two gloo ranks against the JAX verb at ``--n-devices 2``.

* The argv preflight refuses every combination the JAX verb refuses with
  its text (``tests/test_quorum.py::test_cli_preflight_quorum_matrix``, the
  flags the port has), ``--overlap delayed`` among them.
* LeNet, ``--quorum 1 --staleness 1 --chaos slow@3:1:0.25
  --quorum-period-ms 100``, 8 steps over one gloo group of two ranks: the
  ``Worker:`` lines' step, epoch and ``Msg(MB)`` fields (each package
  starts from its own seeded init, so loss and precision differ, as in
  every CLI comparison here), ``arrival_schedule.jsonl`` and the
  ``staleness_exceeded`` incidents equal the JAX verb's, and both wrote
  checkpoints at the same steps; ``--replay-arrivals`` of the
  schedule (no chaos) writes the live run's checkpoints byte for byte; a
  run killed by ``kill@5`` (both ranks exit 43, under torchrun), resumed,
  writes the straight run's last checkpoint and schedule; a blocking
  checkpoint resumed under ``--quorum`` warns with the JAX loop's text and
  warms the ring up from empty; the port's
  ``report`` and the JAX package's pass ``quorum_schedule_consistent`` on
  the port's run directory.
"""

import os
import re
import subprocess
import sys

import pytest
from torch_dist import ROOT, Groups

from atomo_tpu import cli as jax_cli
from atomo_tpu_torch import cli
from atomo_tpu_torch.quorum.artifact import read_schedule, schedule_path

BASE = ["train", "--synthetic", "--train-dir", "/tmp/unused", "--code", "qsgd",
        "--n-devices", "4"]


def _jax_preflight_message(argv):
    args = jax_cli.build_parser().parse_args(argv)
    with pytest.raises(SystemExit) as e:
        jax_cli._argv_preflight(args)
    return str(e.value.code)


@pytest.mark.parametrize("extra", [
    ["--quorum", "three"],
    ["--quorum", "0"],
    ["--quorum", "3", "--staleness", "0"],
    ["--quorum", "3", "--quorum-period-ms", "0"],
    ["--quorum", "3", "--code", "sgd"],
    ["--quorum", "3", "--n-devices", "1"],
    ["--quorum", "3", "--aggregate", "psum"],
    ["--quorum", "3", "--overlap", "delayed"],
    ["--quorum", "3", "--stream-encode", "on"],
    ["--quorum", "3", "--sparse-rows", "on"],
    ["--quorum", "3", "--error-feedback"],
    ["--quorum", "3", "--zero1"],
    ["--quorum", "3", "--partition", "sharded-update"],
    ["--quorum", "3", "--num-aggregate", "2"],
    ["--quorum", "3", "--superstep", "4"],
    ["--quorum", "3", "--phase-metrics"],
    ["--quorum", "3", "--obs-quality", "--obs-record"],
    ["--quorum", "3", "--on-diverge", "skip", "--save-freq", "2"],
    ["--replay-arrivals", "/tmp/whatever.jsonl"],
    ["--quorum", "3", "--replay-arrivals", "/tmp/definitely-not-a-file.jsonl"],
], ids=lambda x: "-".join(a.strip("-") for a in x if a.startswith("--"))[:60])
def test_cli_preflight_quorum_matrix_is_the_jax_verbs(extra):
    want = _jax_preflight_message(BASE + extra)
    with pytest.raises(SystemExit) as e:
        cli.main(BASE + extra + ["--device", "cpu"], log_fn=lambda line: None)
    assert str(e.value.code) == want


def test_cli_clean_quorum_passes_the_preflight():
    argv = BASE + ["--quorum", "3", "--staleness", "2"]
    jax_cli._argv_preflight(jax_cli.build_parser().parse_args(argv))
    cli._quorum_preflight(cli.build_parser().parse_args(argv + ["--device", "cpu"]))


def test_cli_one_device_resolved_is_refused_as_jax(tmp_path):
    """``--n-devices 0`` on one process resolves to one device: the JAX
    verb's resolved-world text."""
    argv = ["train", "--network", "LeNet", "--synthetic", "--max-steps", "1", "--code", "qsgd",
            "--quorum", "1", "--train-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"], log_fn=lambda _: None)
    assert "resolved to 1 device" in str(got.value.code)


# ------------------------------------------------------------- two ranks

COMMON = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic", "--batch-size",
          "16", "--log-interval", "1", "--eval-freq", "0", "--save-freq", "2", "--code",
          "qsgd", "--n-devices", "2", "--aggregate", "gather"]
QUORUM = ["--quorum", "1", "--staleness", "1", "--quorum-period-ms", "100"]
ARGV = COMMON + QUORUM + ["--max-steps", "8"]
SLOW = ["--chaos", "slow@3:1:0.25"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Over one gloo group of two ranks: the live run, its replay, a run
    killed before step 5 and resumed; the JAX verb on the live argv."""
    tmp = tmp_path_factory.mktemp("quorum_cli")
    g = Groups(tmp_path_factory, "gloo_quorum_cli")
    try:
        def run(argv, d):
            out = g[2].run("cli", argv=argv + ["--train-dir", str(tmp / d), "--device", "cpu"])
            assert [a["rc"] for a in out] == [0, 0], out[0]
            return out[0]

        out = {"live": run(ARGV + SLOW + ["--obs-record"], "live")}
        out["replay"] = run(ARGV + ["--replay-arrivals", schedule_path(str(tmp / "live"))],
                            "replay")
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        env.pop("WORLD_SIZE", None)
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "atomo_tpu_torch"] + ARGV
            + ["--train-dir", str(tmp / "killed"), "--chaos", "slow@3:1:0.25,kill@5",
               "--device", "cpu"],
            env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=240)
        assert proc.returncode != 0 and "exitcode  : 43" in proc.stderr, proc.stderr[-3000:]
        out["resumed"] = run(ARGV + SLOW + ["--resume"], "killed")
        # a blocking checkpoint resumed under --quorum: the ring warms up
        # from empty, with the JAX loop's warning
        run(COMMON + ["--max-steps", "2"], "blocking")
        out["ringless"] = run(COMMON + QUORUM + ["--max-steps", "4", "--resume"] + SLOW,
                              "blocking")
    finally:
        g.close()
    return out, tmp


def _workers(lines):
    """The ``Worker:`` lines without their one wall-clock field, Time Cost
    (Comp, Encode and Comm are 0.0000 outside ``--phase-metrics``)."""
    return [re.sub(r"Time Cost: [0-9.]+", "", ln) for ln in lines if ln.startswith("Worker:")]


def _fields(lines):
    """Step, epoch and Msg(MB) of each ``Worker:`` line."""
    return [(ln.split(", Loss:")[0], ln.split("Msg(MB):")[1].split(",")[0].strip())
            for ln in lines if ln.startswith("Worker:")]


def _incidents(d):
    from atomo_tpu_torch.utils.tracing import IncidentLog

    return [(r["cause"], r["action"], r["step"], r["target"], r.get("available_staleness"))
            for r in IncidentLog.read(os.path.join(d, "incidents.jsonl"))
            if r["cause"] == "staleness_exceeded"]


def test_two_ranks_equal_the_jax_verb(runs, tmp_path, capsys):
    out, tmp = runs
    capsys.readouterr()
    assert jax_cli.main(ARGV + SLOW + ["--train-dir", str(tmp_path)]) == 0
    want = _fields(capsys.readouterr().out.splitlines())
    assert _fields(out["live"]["lines"]) == want and len(want) == 8
    live = tmp / "live"
    assert (live / "arrival_schedule.jsonl").read_text().splitlines() == \
        (tmp_path / "arrival_schedule.jsonl").read_text().splitlines()
    assert _incidents(str(live)) == _incidents(str(tmp_path))
    assert [s for _, _, s, *_ in _incidents(str(live))] == [4, 5, 6, 7, 8]
    assert sorted(p.name for p in live.glob("model_step_*")) == \
        sorted(p.name for p in tmp_path.glob("model_step_*")) != []


def test_replay_and_resume_equal_the_live_run(runs):
    out, tmp = runs
    live = tmp / "live"
    for step in (2, 4, 6, 8):
        assert (live / f"model_step_{step}").read_bytes() == \
            (tmp / "replay" / f"model_step_{step}").read_bytes()
    assert _workers(out["replay"]["lines"]) == _workers(out["live"]["lines"])
    assert (tmp / "replay" / "arrival_schedule.jsonl").read_text() == \
        (live / "arrival_schedule.jsonl").read_text()
    assert f"Resumed from {tmp / 'killed'} at step 4" in out["resumed"]["lines"]
    assert not [w for w in out["resumed"]["warnings"] if "resume" in w]
    assert (live / "model_step_8").read_bytes() == (tmp / "killed" / "model_step_8").read_bytes()
    assert (tmp / "killed" / "arrival_schedule.jsonl").read_text() == \
        (live / "arrival_schedule.jsonl").read_text()


def test_ringless_checkpoint_resumes_with_the_jax_warning(runs):
    out, tmp = runs
    assert f"Resumed from {tmp / 'blocking'} at step 2" in out["ringless"]["lines"]
    warned = [w for w in out["ringless"]["warnings"] if "staleness ring" in w]
    assert len(warned) == 1 and warned[0].startswith(
        "--quorum resume: checkpoint has no matching staleness ring (no quorum_carry in the "
        "checkpoint); restoring the train state only — the resumed steps warm the ring up "
        "from empty (recorded K must match to resume the ring)"), warned
    assert sorted(read_schedule(schedule_path(str(tmp / "blocking")))[1]) == [3, 4]


def test_reports_read_the_schedule_consistent(runs, capsys):
    from atomo_tpu.obs.report import build_report as jax_build_report
    from atomo_tpu_torch.obs.report import build_report

    _, tmp = runs
    d = str(tmp / "live")
    for doc in (build_report(d), jax_build_report(d)):
        check = {c["name"]: c for c in doc["checks"]}["quorum_schedule_consistent"]
        assert check["ok"] is True and not check["skipped"], check
    assert cli.main(["report", "--train-dir", d, "--strict"], log_fn=lambda _: None) == 0
