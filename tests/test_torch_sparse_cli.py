"""``atomo_tpu_torch train --dataset zipf --network embedding --sparse-rows``.

Under a two-process gloo launch (:mod:`torch_dist`) rank 0 prints the hybrid
plan (``plan.describe()`` and one reason line per leaf) and the ``Worker:``
lines; the plan lines equal the JAX CLI's for the same flags on two of the
conftest's CPU devices letter for letter, and so does ``Msg(MB)``
(tolerance: none). On one device ``auto`` says it runs dense, as the JAX
verb says; the argv refusals carry the JAX verb's messages; ``evaluate``
reads an embedding checkpoint back.
"""

import re

import pytest
from torch_dist import Group

from atomo_tpu import cli as jax_cli
from atomo_tpu_torch import cli

ZIPF = ["train", "--dataset", "zipf", "--network", "embedding", "--code", "qsgd",
        "--batch-size", "32", "--max-steps", "2", "--log-interval", "1", "--eval-freq", "0",
        "--train-dir", ""]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


def _msg_mb(lines):
    return [float(m.group(1)) for m in (re.search(r"Msg\(MB\):\s+([0-9.]+)", ln)
                                         for ln in lines) if m]


def _plan_lines(lines):
    return [ln for ln in lines if ln.startswith(("hybrid plan:", "  ["))]


def _jax_lines(capsys, argv):
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_two_ranks_print_the_jax_plan_and_msg(group, capsys, aggregate):
    flags = ZIPF + ["--n-devices", "2", "--sparse-rows", "on", "--aggregate", aggregate]
    answers = group.run("cli", argv=flags + ["--device", "cpu"])
    assert [a["rc"] for a in answers] == [0, 0], answers
    lines = answers[0]["lines"]
    assert answers[1]["lines"] == []  # only rank 0 logs
    plan = _plan_lines(lines)
    assert plan[0].startswith("hybrid plan: 1/5 leaves sparse-row") and len(plan) == 6
    assert "['table']: sparse: B=128 rows" in plan[-1]
    jax_lines = _jax_lines(capsys, flags)
    assert plan == _plan_lines(jax_lines)
    worker = [ln for ln in lines if ln.startswith("Worker: 0, Step: ")]
    assert _msg_mb(worker) == _msg_mb([ln for ln in jax_lines if ln.startswith("Worker: ")])
    assert _msg_mb(worker) == [0.0149, 0.0149]


def test_auto_on_one_device_runs_dense_as_the_jax_verb(capsys):
    flags = ZIPF + ["--sparse-rows", "auto", "--n-devices", "1"]
    lines = []
    assert cli.main(flags + ["--device", "cpu"], log_fn=lines.append) == 0
    jax_lines = _jax_lines(capsys, flags)
    want = "--sparse-rows auto: single device, no exchange — running dense"
    assert lines[0] == want and want in jax_lines
    assert _msg_mb(lines) == _msg_mb(jax_lines) == [0.0491, 0.0491]


@pytest.mark.parametrize("extra,phrase", [
    (["--n-devices", "1", "--sparse-rows", "on"], "needs a multi-device mesh"),
    (["--n-devices", "2", "--sparse-rows", "on", "--aggregate", "psum"], "degenerates"),
    (["--n-devices", "2", "--sparse-rows", "auto", "--num-aggregate", "1"],
     "does not compose with --num-aggregate"),
])
def test_preflight_refusals_carry_the_jax_messages(extra, phrase):
    with pytest.raises(SystemExit) as port:
        cli.main(ZIPF + extra + ["--device", "cpu"], log_fn=lambda _: None)
    with pytest.raises(SystemExit) as jax:
        jax_cli.main(ZIPF + extra)
    assert phrase in str(port.value.code) and str(port.value.code) == str(jax.value.code)


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_image_batches_are_not_row_id_shaped(group, capsys, mode):
    flags = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
             "--batch-size", "16", "--max-steps", "1", "--log-interval", "1",
             "--eval-freq", "0", "--train-dir", "", "--code", "qsgd", "--n-devices", "2",
             "--aggregate", "gather", "--sparse-rows", mode]
    answers = group.run("cli", argv=flags + ["--device", "cpu"])
    if mode == "on":
        assert [a["rc"] for a in answers] == [1, 1]
        with pytest.raises(SystemExit) as jax:
            jax_cli.main(flags)
        assert answers[0]["exit"] == str(jax.value.code)
        assert "not row-id shaped" in answers[0]["exit"]
    else:
        lines = answers[0]["lines"]
        assert lines[0].endswith("— running all-dense") and "not row-id shaped" in lines[0]
        assert lines[0] in _jax_lines(capsys, flags)
        assert _msg_mb(lines) == [0.2808]  # LeNet's qsgd gather wire


def test_evaluate_reads_an_embedding_checkpoint(tmp_path):
    """``evaluate`` builds the tower from the same flags and prints, for the
    checkpoint at step 2, the trainer's ``Validation:`` numbers."""
    flags = ["--dataset", "zipf", "--network", "embedding", "--emb-rows", "2048",
             "--emb-dim", "8", "--zipf-slots", "4", "--device", "cpu",
             "--train-dir", str(tmp_path)]
    lines = []
    assert cli.main(["train"] + flags + ["--code", "qsgd", "--batch-size", "32",
                                         "--max-steps", "2", "--eval-freq", "2"],
                    log_fn=lines.append) == 0
    val = [ln for ln in lines if ln.startswith("Validation: Step: 2, ")]
    ev = []
    assert cli.main(["evaluate"] + flags + ["--max-polls", "1", "--stop-when-idle",
                                            "--poll-interval", "0"], log_fn=ev.append) == 0
    got = [ln for ln in ev if ln.startswith("Evaluator: Step: 2, ")]
    assert len(val) == len(got) == 1
    assert got[0].split("Step: 2, ")[1] == val[0].split("Step: 2, ")[1]


def test_embedding_wide_msg_matches_jax_cli(capsys):
    flags = ["train", "--dataset", "zipf", "--network", "embedding_wide", "--code", "qsgd",
             "--batch-size", "16", "--max-steps", "1", "--log-interval", "1",
             "--eval-freq", "0", "--train-dir", "", "--n-devices", "1"]
    lines = []
    assert cli.main(flags + ["--device", "cpu"], log_fn=lines.append) == 0
    assert _msg_mb(lines) == _msg_mb(_jax_lines(capsys, flags))
