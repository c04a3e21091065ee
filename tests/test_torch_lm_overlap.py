"""``lm``'s ``--stream-encode`` and ``--overlap delayed`` against the JAX package.

The small transformer of ``torch_dist_lm_jax`` (width 32, 4 heads, 2 blocks,
32 positions) on 2 and 4 gloo ranks (:mod:`torch_dist`), each rank fed its
replica's JAX draws, against the JAX package's dp x sp step built by
``build_model_axis_program`` with the same ``DpExchange`` on the forced CPU
mesh: dp 2 with delayed (gather and ring), with stream-encode (one bucket a
leaf, the hooks on the transformer's parameters), with both, and dp 2 x sp 2
with both (the buckets encoded after the sp reduce). Tolerances are
``torch_dist_lm_jax.assert_parity``'s: ranks bit for bit after each step,
loss within rtol 1e-5, message and dense bytes exact, parameters within
1e-5 plus the quantization allowance; ``skipped`` is the JAX step's (1, then
0) and step 0 leaves every rank's parameters as they were. Within the port
the streamed steps equal the blocking ones bit for bit. The verb's delayed
preflight carries the JAX verb's messages; over two ranks ``lm --overlap
delayed --stream-encode --stream-bucket-bytes`` prints the JAX verb's steps,
layout and wire columns, and its checkpoints carry every rank's in-flight
payload, from which ``--resume`` goes on without a warning.
"""

import re

import pytest
import torch_dist_lm_jax as L
from torch_dist import Group

from atomo_tpu import cli as jax_cli
from atomo_tpu_torch import cli
from atomo_tpu_torch.training.checkpoint import _read

ARGS = ["lm", "--layout", "dp", "--vocab-size", "16", "--seq-len", "32", "--width", "32",
        "--depth", "2", "--num-heads", "4", "--batch-size", "4", "--max-steps", "2",
        "--log-interval", "1"]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {n: Group(n, tmp_path_factory.mktemp(f"gloo{n}")) for n in (2, 4)}
    yield gs
    for g in gs.values():
        g.close()


def _check(out, final, answers, delayed: bool):
    L.assert_parity(out, final, answers, loss_rtol=1e-5,
                    atol=1e-5 + L.quantization_atol(answers, "qsgd", L.STEPS))
    if delayed:
        assert [s["skipped"] for s in out] == [1.0, 0.0, 0.0]
        for a in answers:
            assert [s["skipped"] for s in a["steps"]] == [1.0, 0.0, 0.0]
            assert a["steps"][0]["hash"] == a["hash0"]


@pytest.mark.parametrize("n,ways,aggregate,modes", [
    (2, 1, "gather", dict(overlap="delayed")),
    (2, 1, "ring", dict(overlap="delayed")),
    (2, 1, "gather", dict(stream_encode=True, stream_bucket_bytes=1)),
    (2, 1, "ring", dict(stream_encode=True, stream_bucket_bytes=1, overlap="delayed")),
    (4, 2, "gather", dict(stream_encode=True, stream_bucket_bytes=1, overlap="delayed")),
], ids=["delayed-gather", "delayed-ring", "stream-gather", "both-ring", "both-dp2xsp2"])
def test_lm_modes_equal_the_jax_model_axis_step(groups, n, ways, aggregate, modes):
    out, final, per_rank = L.run(n, ways, "ring", "qsgd", aggregate, **modes)
    answers = groups[n].run("lm", per_rank=[{"draws": d} for d in per_rank],
                            **L.job(ways, "ring", "qsgd", aggregate, **modes))
    _check(out, final, answers, modes.get("overlap") == "delayed")
    if modes.get("stream_encode"):  # the same steps as without the buckets
        plain = dict(modes)
        del plain["stream_encode"], plain["stream_bucket_bytes"]
        same = groups[n].run("lm", per_rank=[{"draws": d} for d in per_rank],
                             **L.job(ways, "ring", "qsgd", aggregate, **plain))
        for a, b in zip(answers, same):
            assert [s["hash"] for s in a["steps"]] == [s["hash"] for s in b["steps"]]


@pytest.mark.parametrize("extra", [
    ["--overlap", "delayed", "--code", "sgd", "--n-devices", "1"],
    ["--overlap", "delayed", "--code", "qsgd", "--n-devices", "1"],
], ids=["dense", "one-replica"])
def test_lm_delayed_preflight_on_one_process(extra):
    with pytest.raises(SystemExit) as port:
        cli.main(ARGS + extra + ["--device", "cpu"], log_fn=lambda _: None)
    with pytest.raises(SystemExit) as want:
        jax_cli.main(ARGS + extra)
    assert str(port.value.code) == str(want.value.code) and len(str(want.value.code)) > 40


def test_lm_delayed_psum_is_refused_over_two_ranks(groups):
    extra = ["--overlap", "delayed", "--code", "qsgd", "--aggregate", "psum",
             "--n-devices", "2"]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(ARGS + extra)
    answers = groups[2].run("cli", argv=ARGS + extra + ["--device", "cpu"])
    assert all(a["rc"] == 1 and a["exit"] == str(want.value.code) for a in answers)


def test_lm_stream_encode_with_psum_warns_and_trains(groups, capsys):
    extra = ["--stream-encode", "--code", "qsgd", "--aggregate", "psum", "--n-devices", "2"]
    answers = groups[2].run("cli", argv=ARGS + extra + ["--device", "cpu"])
    assert all(a["rc"] == 0 for a in answers)
    warned = [w for w in answers[0]["warnings"] if "--stream-encode" in w]
    assert warned == ["--stream-encode interleaves encode with the FACTOR exchange "
                      "(gather/ring); psum moves the dense decoded tree — ignoring it"]
    assert [ln.split(",")[0] for ln in answers[0]["lines"] if ln.startswith("LM:")] == \
        ["LM: Step: 1", "LM: Step: 2"]


def _wire(lines):
    """(step, layout, Msg(MB), Dense(MB)) of each ``LM:`` line."""
    return [tuple(m.groups()) for m in (re.match(
        r"LM: Step: (\d+), Layout: (\S+), .*Msg\(MB\): ([0-9.]+), Dense\(MB\): ([0-9.]+)", ln)
        for ln in lines) if m]


def test_lm_cli_delayed_stream_lines_and_resume(groups, capsys, tmp_path):
    """``lm --n-devices 2 --overlap delayed --stream-encode --stream-bucket-bytes``
    over two ranks prints the JAX verb's steps, layout and wire columns; its
    checkpoint carries every rank's in-flight payload, and ``--resume``
    continues from it with no warning."""
    argv = ARGS + ["--n-devices", "2", "--code", "qsgd", "--overlap", "delayed",
                   "--stream-encode", "--stream-bucket-bytes", "4096", "--save-freq", "2"]
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    want = _wire(capsys.readouterr().out.splitlines())
    d = str(tmp_path / "p")
    answers = groups[2].run("cli", argv=argv + ["--train-dir", d, "--device", "cpu"])
    assert all(a["rc"] == 0 for a in answers) and answers[1]["lines"] == []
    assert _wire(answers[0]["lines"]) == want and [w[0] for w in want] == ["1", "2"]
    carry = _read(d, 2)["overlap_carry"]
    assert tuple(carry["payload"].shape)[0] == 2 and float(carry["valid"]) == 1.0
    resumed = groups[2].run("cli", argv=argv + ["--max-steps", "4", "--train-dir", d,
                                                "--resume", "--device", "cpu"])
    lines = resumed[0]["lines"]
    assert f"Resumed from {d} at step 2" in lines
    assert [w[0] for w in _wire(lines)] == ["3", "4"]
    assert not [w for a in resumed for w in a["warnings"] if "overlap" in w]
