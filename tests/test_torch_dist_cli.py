"""``atomo_tpu_torch train --n-devices 2`` under a two-process gloo launch.

The port's CLI runs in each rank of a two-process group on the CPU (the
group :mod:`torch_dist` brings up, as ``torchrun`` would); rank 0 prints
the reference's ``Worker:`` and ``Validation:`` lines and the other rank
prints nothing. Its ``Msg(MB)`` equals what the JAX package's own CLI
prints for the same flags on two of the conftest's CPU devices: the
payload bytes for gather and ring, the dense bytes for psum and sgd.
"""

import re

import pytest
from torch_dist import Group

from atomo_tpu import cli as jax_cli

FLAGS = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
         "--batch-size", "16", "--max-steps", "2", "--log-interval", "1",
         "--n-devices", "2"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


def _msg_mb(lines):
    return [float(m.group(1)) for m in (re.search(r"Msg\(MB\):\s+([0-9.]+)", ln)
                                         for ln in lines) if m]


@pytest.mark.parametrize("code,aggregate", [
    ("qsgd", "gather"), ("qsgd", "ring"), ("qsgd", "psum"), ("svd", "gather"),
    ("sgd", "auto")])
def test_cli_two_ranks_msg_matches_jax_cli(group, capsys, tmp_path, code, aggregate):
    flags = FLAGS + ["--code", code, "--aggregate", aggregate] + (
        ["--svd-rank", "3"] if code == "svd" else [])
    answers = group.run("cli", argv=flags + ["--eval-freq", "2", "--device", "cpu",
                                             "--train-dir", str(tmp_path / "port")])
    assert [a["rc"] for a in answers] == [0, 0]
    lines = answers[0]["lines"]
    worker = [ln for ln in lines if ln.startswith("Worker: 0, Step: ")]
    assert [int(ln.split("Step: ")[1].split(",")[0]) for ln in worker] == [1, 2]
    assert any(ln.startswith("Validation: Step: 2, ") for ln in lines)
    assert answers[1]["lines"] == []  # only rank 0 logs

    capsys.readouterr()
    assert jax_cli.main(flags + ["--eval-freq", "0", "--train-dir", str(tmp_path)]) == 0
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("Worker: ")]
    assert _msg_mb(worker) == _msg_mb(jax_lines) and len(_msg_mb(worker)) == 2


def test_cli_refuses_a_group_of_another_size(group):
    answers = group.run("cli", argv=FLAGS[:-1] + ["4", "--code", "qsgd", "--device", "cpu"])
    for a in answers:
        assert a["rc"] == 1 and "--n-devices 4 needs 4 processes" in a["exit"], a
