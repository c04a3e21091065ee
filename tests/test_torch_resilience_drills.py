"""The self-healing checkpoints and the divergence doctor, drilled through
the port's CLI on the CPU (LeNet on synthetic MNIST, the CLI's defaults):

* ``truncate@6,bitflip@4``: the step-6 and step-4 files are damaged after
  their saves; ``--resume`` warns that it skips each, resumes from step 2,
  and the resumed run's step-8 checkpoint equals the straight run's byte
  for byte;
* ``spike@7:3`` (scale 100, finite: the guard passes it) with
  ``--on-diverge skip``: exactly one ``Doctor:`` line, a rollback to a
  healthy checkpoint before step 7 (one ``rollback+skip`` incident), exit 0,
  and the final checkpoint equal to the clean run's byte for byte (the
  clean run alarms on nothing); with ``--max-rollbacks 0`` the run gives up
  at exit 23 with a ``give_up`` record and the diverged tail pruned;
* the supervisor's budget spent: ``crashloop@5`` under ``--max-restarts 1``
  exits 43 with a final budget_exhausted -> give_up record.
"""

import os

import pytest
from test_torch_resilience_cli import cli, incidents

DOCTOR = ["--max-steps", "14", "--save-freq", "2", "--grad-guard", "--on-diverge", "skip",
          "--diverge-window", "4", "--diverge-zmax", "4", "--diverge-patience", "2",
          "--diverge-min-history", "4"]
SPIKE = {"ATOMO_CHAOS_SPIKE_SCALE": "100"}


@pytest.fixture(scope="module")
def damaged(tmp_path_factory):
    """``truncate@6,bitflip@4`` on a 6-step run (saves at 2, 4, 6), then a
    resume to 8 and the straight 8-step run: (first run, resume, straight
    step-8 file, the damaged run's directory)."""
    d, straight = tmp_path_factory.mktemp("damaged"), tmp_path_factory.mktemp("straight")
    first = cli("--max-steps", "6", "--save-freq", "2", "--train-dir", str(d), "--chaos",
                "truncate@6,bitflip@4")
    assert first.returncode == 0, first.stderr[-2000:]
    resumed = cli("--max-steps", "8", "--save-freq", "2", "--train-dir", str(d), "--resume")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    p = cli("--max-steps", "8", "--save-freq", "2", "--train-dir", str(straight))
    assert p.returncode == 0, p.stderr[-2000:]
    return first, resumed, (straight / "model_step_8").read_bytes(), d


@pytest.mark.parametrize("kind,step", [("truncate", 6), ("bitflip", 4)])
def test_damaged_checkpoint_falls_back_to_the_newest_valid(damaged, kind, step):
    """Each damaged file is reported and skipped; the resume lands on step
    2, the newest valid file, and its step-8 checkpoint equals the straight
    run's byte for byte."""
    first, resumed, straight8, d = damaged
    assert f"CHAOS: corrupted checkpoint {d}/model_step_{step} ({kind})" in first.stderr
    assert f"skipping invalid checkpoint '{d}/model_step_{step}'" in resumed.stderr
    assert f"Resumed from {d} at step 2" in resumed.stdout
    assert (d / "model_step_8").read_bytes() == straight8


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    d = tmp_path_factory.mktemp("clean")
    p = cli(*DOCTOR, "--train-dir", str(d), env=SPIKE)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "Doctor:" not in p.stdout  # no false alarm on a sane run
    return d


def test_spike_rolls_back_and_recovers_the_clean_trajectory(tmp_path, clean):
    p = cli(*DOCTOR, "--train-dir", str(tmp_path), "--chaos", "spike@7:3", env=SPIKE)
    assert p.returncode == 0, p.stderr[-2000:]
    doctor = [ln for ln in p.stdout.splitlines() if ln.startswith("Doctor:")]
    assert len(doctor) == 1 and "rolling back to step" in doctor[0], p.stdout
    div = [r for r in incidents(tmp_path) if r["cause"] == "divergence"]
    assert len(div) == 1 and div[0]["action"] == "rollback+skip" and div[0]["target"] < 7
    assert (tmp_path / "model_step_14").read_bytes() == (clean / "model_step_14").read_bytes()
    assert os.path.exists(tmp_path / "model_step_2.healthy")


def test_rollback_budget_exhaustion_exits_23(tmp_path):
    p = cli(*DOCTOR, "--max-rollbacks", "0", "--train-dir", str(tmp_path), "--chaos",
            "spike@7:3", env=SPIKE)
    assert p.returncode == 23, (p.returncode, p.stderr[-2000:])
    assert "Divergence doctor gave up" in p.stdout
    recs = incidents(tmp_path)
    assert recs[-1]["cause"] == "divergence" and recs[-1]["action"] == "give_up"
    assert all(int(n.split("_")[-1]) < 7 for n in os.listdir(tmp_path)
               if n.startswith("model_step_") and not n.endswith(".healthy"))


def test_supervised_budget_exhaustion_exits_nonzero(tmp_path):
    p = cli("--max-steps", "3", "--train-dir", str(tmp_path), "--chaos", "crashloop@5",
            "--max-restarts", "1", "--restart-backoff", "0.05")
    assert p.returncode == 43, (p.returncode, p.stderr[-2000:])
    last = incidents(tmp_path)[-1]
    assert (last["cause"], last["action"], last["rc"], last["max_restarts"]) == (
        "budget_exhausted", "give_up", 43, 1)
