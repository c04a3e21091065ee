"""The guarded data-parallel step over 2 gloo ranks against the JAX dp-2 step.

LeNet on synthetic MNIST from a Flax init, 5 steps, the chaos plan
``nan@2,explode@3,inf@4*`` aimed at replica 1 with the guard's norm ceiling
at 100: step 2 drops replica 1 (non-finite) and rescales the survivor's
mean, step 3 drops it again (its norm, 1e12 times the gradient's, above the
ceiling), step 4 drops every replica (the starred fault) and holds the
state, step 5 is clean. For ``gather``, ``ring`` and ``psum`` (qsgd 4 bits;
svd rank 3 on gather), each rank fed its replica's JAX draws: every step's
``dropped`` and ``skipped`` equal the JAX step's, and
``torch_dist_jax.assert_parity`` holds (replicas bit for bit after every
step, loss rtol 1e-5 over the healthy replicas, ``msg_bytes`` exact,
parameters atol 1e-5 plus one quantization step times lr a step). Beside
them: the delayed step (the flags travel with the carried payload, the
consuming step drops), the ``--superstep 4`` block (its steps the single
steps bit for bit), the ``Guard:`` lines of the port's CLI over the two
ranks against the JAX verb's at ``--n-devices 2``, and the divergence doctor
over the two ranks (``spike@7:3 --on-diverge skip``: one rollback, the
clean run's final checkpoint byte for byte).
"""

import dataclasses

import pytest
import torch_dist_jax as J
from torch_dist import Group

import atomo_tpu.training.resilience as JR
import atomo_tpu.utils.chaos as JC

SPEC, MAXN, STEPS, BATCH, TARGET = "nan@2,explode@3,inf@4*", 100.0, 5, 16, 1


_CHAOS = []


def jax_modes(**extra):
    """The JAX step's guard and chaos (one injector object, so that the
    reference's run cache serves every case of the same arguments)."""
    if not _CHAOS:
        cfg = dataclasses.replace(JC.ChaosConfig.from_spec(SPEC, environ={}),
                                  target_replica=TARGET)
        _CHAOS.append(JC.ChaosInjector(cfg, membership_epoch=0))
    return dict(guard=JR.GuardConfig(MAXN), chaos=_CHAOS[0], **extra)


def guard_case(group, ref, code, aggregate, n, parts=None, **extra):
    """The port's guarded ranks against the JAX guarded step; returns the
    (dropped, skipped) series of both."""
    out, per_rank = ref.run_ranks(code, aggregate, n, **jax_modes(**extra))
    args = ref.job(code, aggregate, guard=MAXN, chaos=SPEC, target_replica=TARGET, **extra)
    answers = group.run("train", per_rank=per_rank, parts=parts, **args)
    J.assert_parity(ref, out, answers, code)
    got = [(s["dropped"], s["skipped"]) for s in answers[0]["steps"]]
    want = [(o["dropped"], o["skipped"]) for o in out]
    assert got == want, (got, want)
    return got, answers


def expected(n):
    return [(0.0, 0.0), (1.0, 0.0), (1.0, 0.0), (float(n), 1.0), (0.0, 0.0)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def ref():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


@pytest.mark.parametrize("code,aggregate", [("qsgd", "gather"), ("qsgd", "ring"),
                                            ("qsgd", "psum"), ("svd", "gather")])
def test_guarded_exchange_matches_jax(group, ref, code, aggregate):
    got, _ = guard_case(group, ref, code, aggregate, 2)
    assert got == expected(2)


def test_guarded_delayed_step_matches_jax(group, ref):
    """The producing step's flags travel with its payload: the consuming
    step (one later) drops replica 1 and rescales, and skips where every
    payload it consumes was poisoned."""
    got, _ = guard_case(group, ref, "qsgd", "gather", 2, overlap="delayed")
    assert got[0] == (0.0, 1.0)  # nothing in flight yet
    assert got[2] == (1.0, 0.0) and got[4] == (2.0, 1.0)


def test_guarded_superstep_block_equals_the_single_steps(group, ref):
    """A block of 4 (then 1) carries the guard's holds and counts inside
    it: the JAX per-step parity, and every rank's state at the boundaries
    equal to the single steps'."""
    _, single = guard_case(group, ref, "qsgd", "gather", 2)
    got, blocked = guard_case(group, ref, "qsgd", "gather", 2, parts=[4, 1])
    assert got == expected(2)
    for a, b in zip(single, blocked):
        assert [s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"]]
        assert b["steps"][3]["hash"] == a["steps"][3]["hash"]
        assert b["steps"][4]["hash"] == a["steps"][4]["hash"]


def test_cli_guard_lines_match_the_jax_verb(group, capsys):
    """``train --grad-guard --chaos nan@2,inf@3*`` on two ranks prints the
    JAX verb's ``Guard:`` lines (rescale at 2, skip at 3)."""
    from atomo_tpu import cli as jax_cli

    argv = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
            "--batch-size", "16", "--max-steps", "3", "--log-interval", "1",
            "--eval-freq", "0", "--train-dir", "", "--code", "qsgd", "--aggregate", "gather",
            "--n-devices", "2", "--grad-guard", "--chaos", "nan@2,inf@3*"]
    answers = group.run("cli", argv=argv + ["--device", "cpu"])
    assert answers[0]["rc"] == 0, answers[0]
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Guard:")]
    got = [ln for ln in answers[0]["lines"] if ln.startswith("Guard:")]
    assert got == want and len(got) == 2
    assert not [ln for ln in answers[1]["lines"] if ln.startswith("Guard:")]


def test_doctor_over_two_ranks_recovers_the_clean_run(group, tmp_path):
    """``--on-diverge skip`` over the two ranks: every rank folds the same
    dp-mean series, rank 0 alone tags and prunes; ``spike@7:3`` rolls back
    once to a healthy checkpoint before step 7 and the run ends with the
    clean run's step-14 checkpoint byte for byte."""
    argv = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
            "--batch-size", "16", "--max-steps", "14", "--save-freq", "2", "--eval-freq", "0",
            "--log-interval", "1", "--code", "qsgd", "--n-devices", "2", "--aggregate",
            "gather", "--device", "cpu", "--grad-guard", "--on-diverge", "skip",
            "--diverge-window", "4", "--diverge-zmax", "4", "--diverge-patience", "2",
            "--diverge-min-history", "4"]
    env = {"ATOMO_CHAOS_SPIKE_SCALE": "100"}
    clean = group.run("cli", argv=argv + ["--train-dir", str(tmp_path / "clean")], env=env)
    spike = group.run("cli", argv=argv + ["--train-dir", str(tmp_path / "spike"), "--chaos",
                                          "spike@7:3"], env=env)
    assert [a["rc"] for a in clean + spike] == [0, 0, 0, 0], (clean, spike)
    assert not [ln for ln in clean[0]["lines"] if ln.startswith("Doctor:")]
    doctor = [ln for ln in spike[0]["lines"] if ln.startswith("Doctor:")]
    assert len(doctor) == 1 and "rolling back to step" in doctor[0]
    assert not [ln for ln in spike[1]["lines"] if ln.startswith("Doctor:")]
    assert ((tmp_path / "spike" / "model_step_14").read_bytes()
            == (tmp_path / "clean" / "model_step_14").read_bytes())
