"""``--aggregate auto`` through both verbs, and the layouts' ``LM:`` lines.

The port's CLI (in this process for one device, on 2 or 4 gloo ranks of
:mod:`torch_dist` otherwise) against the JAX package's own CLI on the
conftest's CPU devices, with the same flags:

* the ``--aggregate auto -> <mode> (<reason>)`` line letter for letter for
  a dense code, for one device, for a codec over two ranks (``train`` and
  ``lm``, and ``lm`` over the dp axis of a dp-tp mesh) and in the ring
  regime, with ``--fabric`` a number and ``--codec-tax-ms`` given; without
  them the same mode (the NOTE's numbers are then the card's anchors);
* the refusal of ``--overlap delayed`` when auto resolves to psum, after
  the same line;
* a group whose ``WORLD_SIZE`` exceeds ``LOCAL_WORLD_SIZE`` spans hosts,
  where the JAX verb picks the unported hierarchical mode: refused, naming
  it; the same group on one host resolves as usual;
* ``lm --layout dp-tp|dp-ep|dp-pp|dp-tp-sp`` over 4 ranks prints the JAX
  verb's ``LM:`` lines: the same steps, layout column and ``Msg(MB)`` and
  ``Dense(MB)`` (the losses differ: the inits differ), and the same
  validation line format (dp-ep with its ``Loss@TrainCap`` suffix).

Three cases are marked slow, each with its tier-1 witnesses named beside
it.
"""

import re

import numpy as np
import pytest
from torch_dist import Group

from atomo_tpu import cli as jax_cli
from atomo_tpu_torch import cli

LM = ["lm", "--vocab-size", "16", "--seq-len", "16", "--width", "32", "--depth", "2",
      "--num-heads", "2", "--batch-size", "4", "--max-steps", "1", "--log-interval", "1"]
TRAIN = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
         "--batch-size", "16", "--max-steps", "1", "--log-interval", "1", "--eval-freq", "0"]
PRICED = ["--fabric", "10", "--codec-tax-ms", "1.5"]
LM_LINE = re.compile(
    r"^LM: Step: (\d+), Layout: ([a-z-]+\([a-z0-9]+\)), Loss: (\d+\.\d{4}), "
    r"PPL: \d+\.\d{2}, Time Cost: \d+\.\d{4}, Msg\(MB\): (\d+\.\d{4}), "
    r"Dense\(MB\): (\d+\.\d{4})$")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {n: Group(n, tmp_path_factory.mktemp(f"auto{n}")) for n in (2, 4)}
    yield gs
    for g in gs.values():
        g.close()


def _jax(argv, capsys):
    capsys.readouterr()
    try:
        rc = jax_cli.main(argv)
        exit_msg = None
    except SystemExit as e:
        rc, exit_msg = 1, str(e.code)
    return capsys.readouterr().out.splitlines(), rc, exit_msg


def _auto(lines):
    return [ln for ln in lines if ln.startswith("--aggregate auto -> ")]


def _port_group(group, argv, env=None):
    answers = group.run("cli", argv=argv + ["--device", "cpu", "--train-dir", ""], env=env)
    return answers[0]


SLOW = pytest.mark.slow


@pytest.mark.parametrize("argv,layout", [
    (LM + ["--code", "sgd"], []),
    # slow; tier-1 witness: lm-dp-pp-one-device (a codec on one device)
    pytest.param(LM + ["--code", "svd"], [], marks=SLOW),
    (LM + ["--code", "qsgd"], ["--layout", "dp-pp", "--ways", "1"]),
], ids=["lm-dense", "lm-one-device-svd", "lm-dp-pp-one-device"])
def test_one_process_prints_the_jax_line(capsys, argv, layout):
    """At one device. The JAX verb cannot run a model axis of one (it builds
    the dp program over a mesh without an sp axis and fails), so the port's
    dp-pp at ways 1 is held against the JAX verb's dp: the line prices the
    unsharded LM over the dp axis either way."""
    lines = []
    cli.main(argv + layout + ["--device", "cpu"], log_fn=lines.append)
    want, rc, _ = _jax(argv + ["--n-devices", "1"], capsys)
    assert rc == 0
    assert _auto(lines) == _auto(want) and len(_auto(lines)) == 1


@pytest.mark.parametrize("n,argv", [
    # slow; tier-1 witnesses: train-dense here and test_unpriced_pick_is_the_jax_mode
    pytest.param(2, TRAIN + ["--code", "svd", "--svd-rank", "3"] + PRICED, marks=SLOW),
    (2, TRAIN + ["--code", "sgd"] + PRICED),
    (2, LM + ["--code", "svd"] + PRICED),
    (4, LM + ["--code", "svd", "--layout", "dp-tp", "--ways", "2"] + PRICED),
    (2, LM + ["--code", "qsgd", "--quantization-level", "12"] + PRICED),
    (4, LM + ["--code", "qsgd", "--quantization-level", "8"] + PRICED),
], ids=["train-svd", "train-dense", "lm-svd", "lm-dp-tp-svd", "lm-ring-2", "lm-ring-4"])
def test_ranks_print_the_jax_line(groups, capsys, n, argv):
    got = _port_group(groups[n], argv + ["--n-devices", str(n)])
    assert got["rc"] == 0, got["exit"]
    want, rc, _ = _jax(argv + ["--n-devices", str(n), "--train-dir", ""], capsys)
    assert rc == 0
    assert _auto(got["lines"]) == _auto(want) and len(_auto(want)) == 1
    if "qsgd" in argv:  # the two ring-regime cases
        assert _auto(want)[0].startswith("--aggregate auto -> ring (")


def test_unpriced_pick_is_the_jax_mode(groups, capsys):
    argv = TRAIN + ["--code", "svd", "--svd-rank", "3", "--n-devices", "2"]
    got = _port_group(groups[2], argv)
    want, _, _ = _jax(argv + ["--train-dir", ""], capsys)
    mode = re.compile(r"^--aggregate auto -> (\w+) \(")
    assert mode.match(_auto(got["lines"])[0]).group(1) == mode.match(_auto(want)[0]).group(1)


def test_delayed_refusal_after_a_psum_pick_is_the_jax_refusal(groups, capsys):
    argv = (LM + ["--width", "16", "--code", "svd", "--svd-rank", "16", "--overlap",
                  "delayed", "--n-devices", "2"] + PRICED)
    got = _port_group(groups[2], argv)
    want, rc, exit_msg = _jax(argv, capsys)
    assert rc == got["rc"] == 1
    assert got["exit"] == exit_msg and "resolved to 'psum'" in exit_msg
    assert _auto(got["lines"]) == _auto(want)


def test_hierarchical_is_refused_across_hosts(groups):
    argv = TRAIN + ["--code", "svd", "--svd-rank", "3", "--n-devices", "2"]
    got = _port_group(groups[2], argv, env={"LOCAL_WORLD_SIZE": "1"})
    assert got["rc"] == 1 and "hierarchical" in got["exit"] and "2 hosts" in got["exit"]
    assert not _auto(got["lines"])
    same_host = _port_group(groups[2], argv, env={"LOCAL_WORLD_SIZE": "2"})
    assert same_host["rc"] == 0 and len(_auto(same_host["lines"])) == 1
    # delayed takes hierarchical out of the space, as in the JAX verb
    delayed = _port_group(groups[2], argv + ["--overlap", "delayed"],
                          env={"LOCAL_WORLD_SIZE": "1"})
    assert delayed["rc"] == 0, delayed["exit"]


LAYOUT_CASES = [
    ["--layout", "dp-tp", "--ways", "2", "--code", "svd", "--aggregate", "gather"],
    # slow; tier-1 witnesses: the dp-ep cases of test_torch_lm_dist_layouts.py
    # (steps and Msg bytes against the JAX step) and the dp-ep validation line
    # of test_torch_lm_layouts.py's oracle
    pytest.param(["--layout", "dp-ep", "--ways", "2", "--num-experts", "4", "--code",
                  "qsgd"], marks=SLOW),
    ["--layout", "dp-pp", "--ways", "2", "--microbatches", "2", "--code", "svd",
     "--aggregate", "psum"],
    ["--layout", "dp-tp-sp", "--ways", "2", "--sp-ways", "2", "--attn-impl", "ulysses",
     "--num-heads", "4", "--code", "qsgd", "--aggregate", "ring"],
]


@pytest.mark.parametrize("extra", LAYOUT_CASES, ids=["dp-tp", "dp-ep", "dp-pp", "dp-tp-sp"])
def test_layout_lm_lines_match_jax(groups, capsys, extra):
    """Two steps and a validation at step 2. The JAX verb's validation of
    dp-tp-sp applies the stock LM to the tp-laid tree and fails, so that
    case compares the training lines only (the port evaluates it by
    ``tp_lm_forward``)."""
    evals = "dp-tp-sp" not in extra
    argv = LM + ["--n-devices", "4", "--max-steps", "2"] + extra
    got = _port_group(groups[4], argv + ["--eval-freq", "2"])
    assert got["rc"] == 0, got["exit"]
    want, rc, _ = _jax(argv + (["--eval-freq", "2"] if evals else []), capsys)
    assert rc == 0
    g = [LM_LINE.match(ln).groups() for ln in got["lines"] if ln.startswith("LM: ")]
    w = [LM_LINE.match(ln).groups() for ln in want if ln.startswith("LM: ")]
    assert [x[0] for x in g] == [x[0] for x in w] == ["1", "2"]
    for a, b in zip(g, w):
        assert (a[1], a[3], a[4]) == (b[1], b[3], b[4])
        assert np.isfinite(float(a[2]))
    val = re.compile(r"^LM Validation: Step: 2, Loss: \d+\.\d{4}, PPL: \d+\.\d{2}"
                     r"(, Loss@TrainCap: \d+\.\d{4} \(C=(\d+)\))?$")
    gv = [val.match(ln) for ln in got["lines"] if ln.startswith("LM Validation")]
    assert len(gv) == 1 and gv[0]
    if evals:
        wv = [val.match(ln) for ln in want if ln.startswith("LM Validation")]
        assert len(wv) == 1 and wv[0]
        assert gv[0].group(2) == wv[0].group(2)  # dp-ep's training capacity, else None


def test_layout_cli_checkpoint_resumes_on_every_rank(groups, tmp_path):
    """``lm --layout dp-pp --ways 2`` over 4 ranks writes its checkpoint at
    step 2 (rank 0, the full stacked tree in the JAX layout) and a second
    run with ``--resume`` goes on from it at step 3 on every rank, as the
    JAX verb's lines say (``Resumed from <dir> at step 2``)."""
    d = str(tmp_path / "pp")
    base = LM + ["--layout", "dp-pp", "--ways", "2", "--code", "svd", "--n-devices", "4",
                 "--save-freq", "2", "--device", "cpu", "--train-dir", d]
    first = groups[4].run("cli", argv=base + ["--max-steps", "2"])
    assert all(a["rc"] == 0 for a in first), first[0]["exit"]
    from atomo_tpu_torch.training.checkpoint import _read

    saved = _read(d, None)
    assert saved["step"] == 2 and saved["model"]["blocks.qkv.kernel"].shape == (2, 32, 96)
    second = groups[4].run("cli", argv=base + ["--max-steps", "3", "--resume"])
    assert all(a["rc"] == 0 for a in second), second[0]["exit"]
    lines = second[0]["lines"]
    assert f"Resumed from {d} at step 2" in lines
    assert [LM_LINE.match(ln).group(1) for ln in lines if ln.startswith("LM: ")] == ["3"]
