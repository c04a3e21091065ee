"""``atomo_tpu_torch train --network <zoo model>`` against the JAX verb.

VGG11 on synthetic CIFAR-10 for two steps prints the JAX verb's ``Worker:``
lines: the same steps, epochs and sample counts and the same ``Msg(MB)``
(the loss and accuracy differ: each package draws its own init).
``--svd-mode`` is an alias over ``--svd-algo`` that refuses a
disagreement with the JAX verb's message, and ``--network AlexNet
--dataset Cifar10`` fails as in the JAX package: 32x32 inputs collapse
AlexNet's features, with the same ``ValueError``.
"""

import re

import pytest

import atomo_tpu_torch.cli as port_cli
from atomo_tpu import cli as jax_cli

BASE = ["train", "--dataset", "Cifar10", "--synthetic", "--batch-size", "8", "--max-steps",
        "2", "--log-interval", "1", "--eval-freq", "0", "--train-dir", ""]


def _fields(lines):
    """Each ``Worker:`` line without its loss, times and accuracies."""
    out = []
    for ln in lines:
        if ln.startswith("Worker: "):
            out.append(re.sub(r"(Loss|Time Cost|Prec@1|Prec@5): +[0-9.]+", r"\1", ln))
    return out


def test_vgg11_worker_lines_match_jax_cli(capsys):
    argv = BASE + ["--network", "VGG11", "--code", "svd", "--svd-rank", "3"]
    lines = []
    assert port_cli.main(argv + ["--device", "cpu"], log_fn=lines.append) == 0
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    got, want = _fields(lines), _fields(jax_lines)
    assert len(got) == 2 and got == want
    assert "Msg(MB):  0.4641" in got[0]


@pytest.mark.parametrize("mode,algo", [("exact", "randomized"), ("randomized", "gram")])
def test_svd_mode_disagreement_refused_as_jax(mode, algo):
    argv = BASE + ["--network", "LeNet", "--dataset", "MNIST", "--code", "svd",
                   "--svd-mode", mode, "--svd-algo", algo]
    with pytest.raises(SystemExit) as port_exit:
        port_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(argv)
    assert str(port_exit.value.code) == str(jax_exit.value.code)
    assert f"--svd-mode {mode} and --svd-algo {algo} disagree" in str(port_exit.value.code)


@pytest.mark.parametrize("mode,algo,want", [
    ("auto", "gram", "gram"), ("randomized", "auto", "randomized"),
    ("exact", "exact", "exact")])
def test_svd_mode_selects_the_algorithm(mode, algo, want, monkeypatch):
    seen = {}
    get_codec = port_cli.get_codec

    def spy(*args, **kw):
        seen["algorithm"] = kw["algorithm"]
        return get_codec(*args, **kw)

    monkeypatch.setattr(port_cli, "get_codec", spy)
    args = port_cli.build_parser().parse_args(
        BASE + ["--network", "LeNet", "--svd-mode", mode, "--svd-algo", algo])
    assert port_cli._svd_algo(args) == want
    lines = []
    assert port_cli.main(["train", "--network", "LeNet", "--synthetic", "--batch-size", "8",
                          "--max-steps", "1", "--code", "svd", "--svd-mode", mode,
                          "--svd-algo", algo, "--device", "cpu", "--train-dir", "",
                          "--eval-freq", "0", "--log-interval", "1"], log_fn=lines.append) == 0
    assert seen["algorithm"] == want and len(lines) == 1


def test_alexnet_on_cifar10_fails_as_jax():
    argv = BASE + ["--network", "AlexNet"]
    with pytest.raises(ValueError) as port_exc:
        port_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as jax_exc:
        jax_cli.main(argv)
    assert str(port_exc.value) == str(jax_exc.value)
    assert "input must be >= 63x63" in str(port_exc.value)
