"""The supervisor and the host faults, drilled through the port's CLI on the
CPU (``python -m atomo_tpu_torch train``, LeNet on synthetic MNIST), with the
JAX package's exit codes and incident sequences (``tests/test_fault_tolerance.py``):

* ``kill@5`` under ``--max-restarts 1``: the chaos kill (exit 43), a
  supervised restart with ``--resume`` from step 4, exit 0, and the final
  checkpoint equal to the straight run's byte for byte; incidents crash,
  clean_exit;
* ``crashloop@2`` under ``--max-restarts 2``: exit 0, incidents crash,
  crash, clean_exit at attempts 0, 1, 2 with positive backoffs (the budget
  spent: ``tests/test_torch_resilience_drills.py``);
* a config error: refused before any child at exit 2 with no incident
  (a bad spec), or, found only in the run (a die@ fault beyond the resolved
  world), the child's exit 2 triaged as config_error -> give_up at once;
* ``slow@3:30`` beyond ``--health-timeout 1``: the watchdog's exit 13 in
  seconds, not 30;
* ``--max-restarts`` above one rank is refused, naming why.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

from atomo_tpu_torch.utils.tracing import read_jsonl

ROOT = Path(__file__).resolve().parents[1]
BASE = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic", "--batch-size",
        "16", "--eval-freq", "0", "--log-interval", "1", "--code", "sgd", "--device", "cpu"]


def cli(*args, env=None, timeout=120):
    e = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    for k in ("ATOMO_CHAOS", "ATOMO_RUN_ATTEMPT", "ATOMO_SUPERVISED", "WORLD_SIZE"):
        e.pop(k, None)
    e.update(env or {})
    return subprocess.run([sys.executable, "-m", "atomo_tpu_torch", *BASE, *args], env=e,
                          capture_output=True, text=True, timeout=timeout, cwd=str(ROOT))


def incidents(d):
    return read_jsonl(os.path.join(str(d), "incidents.jsonl"))


def test_kill_restart_resume_equals_the_straight_run(tmp_path):
    straight, killed = tmp_path / "straight", tmp_path / "killed"
    common = ["--max-steps", "8", "--save-freq", "2"]
    p = cli(*common, "--train-dir", str(straight))
    assert p.returncode == 0, p.stderr[-2000:]
    p = cli(*common, "--train-dir", str(killed), "--chaos", "kill@5", "--max-restarts", "1",
            "--restart-backoff", "0.05")
    assert p.returncode == 0, p.stderr[-2000:]
    assert "CHAOS: killing process before step 5 (exit 43)" in p.stderr
    assert f"Resumed from {killed} at step 4" in p.stdout
    assert "Supervisor: clean exit (attempt 1)" in p.stdout
    assert (straight / "model_step_8").read_bytes() == (killed / "model_step_8").read_bytes()
    recs = incidents(killed)
    assert [(r["cause"], r["action"], r.get("rc")) for r in recs] == [
        ("crash", "restart", 43), ("clean_exit", "done", None)]


def test_supervised_crashloop_recovers_within_budget(tmp_path):
    p = cli("--max-steps", "3", "--train-dir", str(tmp_path), "--chaos", "crashloop@2",
            "--max-restarts", "2", "--restart-backoff", "0.05")
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-2000:])
    assert "Supervisor: clean exit (attempt 2)" in p.stdout
    recs = incidents(tmp_path)
    assert [r["cause"] for r in recs] == ["crash", "crash", "clean_exit"]
    assert [r["attempt"] for r in recs] == [0, 1, 2]
    assert recs[-1]["action"] == "done"
    assert all(r["backoff_s"] > 0 for r in recs[:2])


def test_config_errors_exit_2_and_give_up(tmp_path):
    p = cli("--max-steps", "3", "--train-dir", str(tmp_path / "a"), "--chaos", "frob@3",
            "--max-restarts", "2")
    assert p.returncode == 2 and "unknown chaos fault kind 'frob'" in p.stderr
    assert not (tmp_path / "a" / "incidents.jsonl").exists()
    # found only in the run: die@S:5 against the resolved one-device world
    p = cli("--max-steps", "3", "--train-dir", str(tmp_path / "b"), "--chaos", "die@2:5",
            "--grad-guard", "--max-restarts", "2", "--restart-backoff", "0.05")
    assert p.returncode == 2, (p.stdout[-2000:], p.stderr[-2000:])
    assert "resolved to a 1-device mesh" in p.stderr
    assert "config error — deterministic); not restarting" in p.stdout
    assert [(r["cause"], r["action"]) for r in incidents(tmp_path / "b")] == [
        ("config_error", "give_up")]


def test_watchdog_ends_a_stalled_run_with_13(tmp_path):
    t0 = time.monotonic()
    p = cli("--max-steps", "6", "--train-dir", "", "--chaos", "slow@3:30",
            "--health-timeout", "1")
    assert p.returncode == 13, (p.returncode, p.stderr[-2000:])
    assert "HealthWatchdog: no training heartbeat" in p.stderr
    assert time.monotonic() - t0 < 25


def test_multi_rank_supervision_is_refused(tmp_path, monkeypatch):
    from atomo_tpu_torch import cli as port_cli

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("ATOMO_SUPERVISED", raising=False)
    try:
        port_cli.main(BASE + ["--max-steps", "2", "--train-dir", str(tmp_path),
                              "--max-restarts", "1"])
    except SystemExit as exc:
        assert "--max-restarts supervises one process" in str(exc.code)
    else:
        raise AssertionError("--max-restarts over two ranks was not refused")
