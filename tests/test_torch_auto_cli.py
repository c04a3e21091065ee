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
  where the JAX verb picks the two-tier hierarchical mode: so does the
  port (one outer group a host, the per-tier advisory), and it trains; the
  same group on one host resolves as usual;

Three cases are marked slow, each with its tier-1 witnesses named beside
it. The layouts' ``LM:`` lines and the layout CLI's resume, on 4 ranks, are
``test_torch_auto_cli_layouts.py`` (a file of its own, so that the two
balance over test workers).
"""

import re

import pytest
from torch_dist import Groups

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
    gs = Groups(tmp_path_factory, "auto")
    yield gs
    gs.close()


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
    """(The name is the one slice that refused this; a group across two
    hosts now resolves to the two-tier schedule, one outer group a host.)"""
    argv = TRAIN + ["--code", "svd", "--svd-rank", "3", "--n-devices", "2"]
    got = _port_group(groups[2], argv, env={"LOCAL_WORLD_SIZE": "1"})
    assert got["rc"] == 0, got["exit"]
    (line,) = _auto(got["lines"])
    assert line.startswith("--aggregate auto -> hierarchical (inner 1x nvlink @ 450.00 "
                           "GB/s/chip, outer 2x dcn @ 50.00 GB/s/chip; plan ")
    assert any(ln.startswith("Worker: 0, Step: 1,") for ln in got["lines"])
    same_host = _port_group(groups[2], argv, env={"LOCAL_WORLD_SIZE": "2"})
    assert same_host["rc"] == 0 and len(_auto(same_host["lines"])) == 1
    # delayed takes hierarchical out of the space, as in the JAX verb
    delayed = _port_group(groups[2], argv + ["--overlap", "delayed"],
                          env={"LOCAL_WORLD_SIZE": "1"})
    assert delayed["rc"] == 0, delayed["exit"]
