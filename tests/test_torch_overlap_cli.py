"""``train --overlap --stream-encode --stream-bucket-mb`` against the JAX verb.

The preflight conflict matrix, message for message (``atomo_tpu/cli.py:
1013-1130, 1286-1290``): delayed and stream-encode with a dense code, with
``--n-devices 1`` and with ``--aggregate psum``; each with
``--sparse-rows``; ``--error-feedback`` with delayed. On one process with
no group (one device) both modes are refused with the JAX verb's
resolved-count messages (``:2730-2742``), which the JAX verb prints when its
devices resolve to one. Over two gloo ranks (:mod:`torch_dist`, as
``torchrun --nproc-per-node 2`` starts them): ``--overlap delayed
--stream-encode on`` trains with the JAX verb's ``Worker:`` steps and
Msg(MB), writes checkpoints that carry the in-flight payload, and
``--resume`` continues from them with no warning.
"""

import re

import pytest
from torch_dist import Group

from atomo_tpu import cli as jax_cli
from atomo_tpu_torch import cli

LENET = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
         "--batch-size", "16", "--max-steps", "2", "--log-interval", "1", "--eval-freq", "0"]
TWO = ["--n-devices", "2", "--aggregate", "gather"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


@pytest.mark.parametrize("extra", [
    ["--overlap", "delayed", "--code", "sgd"],
    ["--overlap", "delayed", "--code", "qsgd", "--n-devices", "1"],
    ["--overlap", "delayed", "--code", "qsgd", "--n-devices", "2", "--aggregate", "psum"],
    ["--stream-encode", "on", "--code", "sgd"],
    ["--stream-encode", "on", "--code", "qsgd", "--n-devices", "1"],
    ["--stream-encode", "on", "--code", "svd", "--n-devices", "2", "--aggregate", "psum"],
    ["--overlap", "delayed", "--code", "qsgd", "--sparse-rows", "auto"] + TWO,
    ["--stream-encode", "on", "--code", "qsgd", "--sparse-rows", "on"] + TWO,
    ["--error-feedback", "--code", "svd", "--sample", "topk", "--overlap", "delayed"] + TWO,
], ids=["delayed-dense", "delayed-one-device", "delayed-psum", "stream-dense",
        "stream-one-device", "stream-psum", "sparse-delayed", "sparse-stream", "ef-delayed"])
def test_preflight_refusals_carry_the_jax_messages(extra):
    with pytest.raises(SystemExit) as port:
        cli.main(LENET + extra + ["--device", "cpu"], log_fn=lambda _: None)
    with pytest.raises(SystemExit) as want:
        jax_cli.main(LENET + extra)
    assert str(port.value.code) == str(want.value.code) and len(str(want.value.code)) > 40


@pytest.mark.parametrize("flag,message", [
    (["--overlap", "delayed"], "--overlap delayed needs a multi-device mesh: single-device "
                               "training has no exchange to take off the critical path"),
    (["--stream-encode", "on"], "--stream-encode needs a multi-device mesh: single-device "
                                "training has no exchange whose encode is on the critical "
                                "path"),
], ids=["delayed", "stream"])
def test_one_device_is_refused_with_the_resolved_count_message(flag, message):
    with pytest.raises(SystemExit) as port:
        cli.main(LENET + ["--code", "qsgd", "--device", "cpu"] + flag, log_fn=lambda _: None)
    assert str(port.value.code) == message
    with open(jax_cli.__file__) as f:  # the JAX verb's own words
        src = re.sub(r'"\s+"', "", f.read())
    assert message in src


def _steps(lines):
    return [(int(m.group(1)), float(m.group(2))) for m in (
        re.search(r"^Worker: 0, Step: (\d+),.*Msg\(MB\):\s+([0-9.]+)", ln) for ln in lines) if m]


def test_two_ranks_train_and_resume_through_the_cli(group, capsys, tmp_path):
    argv = LENET[:-2] + ["--max-steps", "4", "--save-freq", "2", "--eval-freq", "2",
                         "--code", "qsgd", "--overlap", "delayed", "--stream-encode", "on",
                         "--stream-bucket-mb", "0.01"] + TWO
    capsys.readouterr()
    assert jax_cli.main(argv + ["--train-dir", str(tmp_path / "jax")]) == 0
    want = _steps(capsys.readouterr().out.splitlines())
    answers = group.run("cli", argv=argv + ["--train-dir", str(tmp_path / "p"),
                                            "--device", "cpu"])
    assert all(a["rc"] == 0 for a in answers)
    assert _steps(answers[0]["lines"]) == want == [(s, 0.2808) for s in (1, 2, 3, 4)]
    assert answers[1]["lines"] == []
    resumed = group.run("cli", argv=[a if a != "4" else "6" for a in argv]
                        + ["--train-dir", str(tmp_path / "p"), "--resume", "--device", "cpu"])
    lines = resumed[0]["lines"]
    assert lines[0] == f"Resumed from {tmp_path / 'p'} at step 4"
    assert [s for s, _ in _steps(lines)] == [5, 6]
    assert not [w for w in resumed[0]["warnings"] if "overlap" in w]
