"""``atomo_tpu_torch train --budget-alloc --budget-bytes --error-feedback``,
and the three repaired faults of the ``train`` verb, against the JAX verb.

In-process runs take one device; two-rank runs go through the gloo group of
:mod:`torch_dist`, as ``torchrun --nproc-per-node 2`` would start them, and
the JAX verb runs on two of the conftest's forced CPU devices. Compared
letter for letter: the refusals' messages, the warnings, the ``Budget:``
block (``Allocation.describe()`` and the per-leaf ``[i] name: k=`` lines,
with the port's probe started from the JAX probe's weights, the parity hook
that the draws are elsewhere), and ``budget_alloc.json``'s keys and values
(its predicted variance within rel 1e-5: the two probes' float32 gradients
sum in other orders). ``Worker:`` lines are compared by step and
``Msg(MB)``: the two packages' inits and draws differ, so their losses do.
"""

import json
import re
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch
from torch_dist import Group

from atomo_tpu import cli as jax_cli
from atomo_tpu.models import get_model as jax_model
from atomo_tpu_torch import cli
from atomo_tpu_torch.convert import state_dict_from_jax
from atomo_tpu_torch.sparse import hybrid

LENET = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
         "--batch-size", "16", "--max-steps", "2", "--log-interval", "1", "--eval-freq", "0"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


def _msg_mb(lines):
    return [(int(m.group(1)), float(m.group(2))) for m in (
        re.search(r"^Worker: 0, Step: (\d+),.*Msg\(MB\):\s+([0-9.]+)", ln) for ln in lines) if m]


def _jax(capsys, argv):
    """The JAX verb's stdout lines and the messages of its warnings."""
    capsys.readouterr()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert jax_cli.main(argv) == 0
    return capsys.readouterr().out.splitlines(), [str(w.message) for w in caught]


def _port(argv):
    lines = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert cli.main(argv + ["--device", "cpu"], log_fn=lines.append) == 0
    return lines, [str(w.message) for w in caught]


@pytest.mark.parametrize("extra", [
    ["--budget-bytes", "1000", "--code", "svd"],
    ["--budget-alloc", "variance", "--code", "sgd"],
    ["--budget-alloc", "variance", "--code", "terngrad"],
    ["--budget-alloc", "variance", "--code", "svd", "--sample", "topk"],
    ["--budget-alloc", "variance", "--code", "qsgd", "--n-devices", "2",
     "--sparse-rows", "auto", "--aggregate", "gather"],
    ["--error-feedback", "--code", "sgd"],
    ["--error-feedback", "--code", "svd", "--n-devices", "1"],
    ["--error-feedback", "--code", "qsgd", "--n-devices", "2", "--sparse-rows", "auto",
     "--aggregate", "gather"],
    ["--error-feedback", "--code", "svd", "--sample", "topk", "--n-devices", "2",
     "--num-aggregate", "1"],
], ids=["bytes-uniform", "alloc-dense", "alloc-terngrad", "alloc-svd-topk", "alloc-sparse",
        "ef-dense", "ef-one-device", "ef-sparse", "ef-num-aggregate"])
def test_preflight_refusals_carry_the_jax_messages(extra):
    with pytest.raises(SystemExit) as port:
        cli.main(LENET + extra + ["--device", "cpu"], log_fn=lambda _: None)
    with pytest.raises(SystemExit) as want:
        jax_cli.main(LENET + extra)
    assert str(port.value.code) == str(want.value.code) and len(str(want.value.code)) > 40


def _jax_probe_weights(monkeypatch):
    """Start the port's probe from the JAX probe's weights (Flax init under
    key 0), so that both verbs measure one gradient."""
    real = hybrid.probe_gradient

    def probe(model, images, labels, state_dict=None):
        params = jax_model("LeNet", 10).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
            jnp.asarray(images), train=False)["params"]
        return real(model, images, labels, state_dict_from_jax(model, jax.device_get(params)))

    monkeypatch.setattr(hybrid, "probe_gradient", probe)


@pytest.mark.parametrize("code", [["--code", "qsgd"], ["--code", "svd", "--svd-rank", "3"],
                                  ["--code", "qsgd", "--budget-bytes", "200000"]],
                         ids=["qsgd", "svd3", "qsgd-bytes"])
def test_budget_block_matches_the_jax_verb(monkeypatch, capsys, tmp_path, code):
    _jax_probe_weights(monkeypatch)
    flags = LENET + code + ["--budget-alloc", "variance", "--n-devices", "1"]
    lines, _ = _port(flags + ["--train-dir", str(tmp_path / "port")])
    want, _ = _jax(capsys, flags + ["--train-dir", str(tmp_path / "jax")])

    def block(ls):
        return [ln for ln in ls if ln.startswith(("budget allocation", "  ["))]

    assert len(block(lines)) == 9 and block(lines) == block(want)
    assert lines[0] == f"Budget: allocation artifact -> {tmp_path / 'port' / 'budget_alloc.json'}"
    assert _msg_mb(lines) == _msg_mb(want) and len(_msg_mb(lines)) == 2
    docs = [json.loads((tmp_path / d / "budget_alloc.json").read_text()) for d in ("port", "jax")]
    for d in docs:
        for ep in d["epochs"]:
            ep["predicted_variance"] = pytest.approx(ep["predicted_variance"], rel=1e-5)
    assert docs[0] == docs[1]


def test_budget_resume_reuses_or_refuses_the_artifact(capsys, tmp_path):
    """A resume reuses the recorded allocation (the JAX verb's line), and a
    document for another codec is refused, the run re-allocating."""
    d = str(tmp_path)
    flags = LENET + ["--code", "qsgd", "--budget-alloc", "variance", "--n-devices", "1",
                     "--train-dir", d, "--save-freq", "2"]
    first, _ = _port(flags)
    again, _ = _port(flags[:flags.index("--max-steps") + 1] + ["4"]
                     + flags[flags.index("--max-steps") + 2:] + ["--resume"])
    doc = json.loads((tmp_path / "budget_alloc.json").read_text())
    want = (f"Budget: reusing recorded allocation epoch 0 "
            f"({doc['epochs'][0]['payload_bytes']} B predicted wire) (budget_alloc.json)")
    assert want in again and f"Resumed from {d} at step 2" in again
    assert [ln for ln in first if ln.startswith("  [")] == \
        [ln for ln in again if ln.startswith("  [")]
    (tmp_path / "svd").mkdir()
    (tmp_path / "svd" / "budget_alloc.json").write_text(json.dumps(doc))
    svd, _ = _port(LENET + ["--code", "svd", "--budget-alloc", "variance", "--n-devices", "1",
                            "--train-dir", str(tmp_path / "svd"), "--resume"])
    assert svd[0] == ("Budget: NOT reusing budget_alloc.json: allocation was recorded for "
                      "codec 'qsgd' but this run compresses with 'svd' — re-allocating")


@pytest.mark.parametrize("extra", [
    ["--code", "sgd", "--num-aggregate", "1"],
    ["--code", "qsgd", "--aggregate", "psum", "--num-aggregate", "1"],
    ["--code", "qsgd", "--aggregate", "gather", "--num-aggregate", "5"],
], ids=["dense", "psum", "outside"])
def test_num_aggregate_resolves_as_the_jax_verb(group, capsys, tmp_path, extra):
    """Fault 1: the flag the step cannot take warns and trains every replica
    (it raised ValueError on every rank)."""
    flags = LENET + ["--n-devices", "2", "--train-dir", ""] + extra
    answers = group.run("cli", argv=flags + ["--device", "cpu"])
    assert [a["rc"] for a in answers] == [0, 0], answers
    want, jw = _jax(capsys, flags)
    expect = [w for w in jw if "--num-aggregate" in w]
    assert expect and [w for w in answers[0]["warnings"] if "--num-aggregate" in w] == expect
    assert _msg_mb(answers[0]["lines"]) == _msg_mb(want) and len(_msg_mb(want)) == 2


def test_n_devices_defaults_to_the_whole_group(group, capsys):
    """Fault 2: without --n-devices two ranks train data-parallel, as the
    JAX verb takes every device (the port used to exit naming torchrun)."""
    assert cli.build_parser().parse_args(["train"]).n_devices == 0
    answers = group.run("cli", argv=LENET + ["--code", "qsgd", "--train-dir", "",
                                             "--device", "cpu"])
    assert [a["rc"] for a in answers] == [0, 0], answers
    want, _ = _jax(capsys, LENET + ["--code", "qsgd", "--n-devices", "2", "--train-dir", ""])
    assert _msg_mb(answers[0]["lines"]) == _msg_mb(want) == [(1, 0.2808), (2, 0.2808)]


def test_parity_flags_are_taken_with_the_jax_warnings(capsys):
    """Fault 3: --comm-type, --enable-gpu and --no-cuda are accepted and
    ignored with the JAX verb's warnings (the parser refused them)."""
    flags = LENET + ["--n-devices", "1", "--train-dir", "", "--comm-type", "Isend",
                     "--enable-gpu", "--no-cuda", "--max-steps", "1"]
    lines, got = _port(flags)
    want, jw = _jax(capsys, flags)
    dead = ("--comm-type", "--enable-gpu")
    assert [w for w in got if w.startswith(dead)] == [w for w in jw if w.startswith(dead)]
    assert len([w for w in got if w.startswith(dead)]) == 2
    assert _msg_mb(lines) == _msg_mb(want)


@pytest.mark.parametrize("code,warns", [(["--code", "qsgd"], True),
                                        (["--code", "svd", "--sample", "topk"], False)],
                         ids=["qsgd", "svd-topk"])
def test_error_feedback_over_two_ranks(group, capsys, code, warns):
    flags = LENET + ["--n-devices", "2", "--train-dir", "", "--error-feedback"] + code
    answers = group.run("cli", argv=flags + ["--device", "cpu"])
    assert [a["rc"] for a in answers] == [0, 0], answers
    want, jw = _jax(capsys, flags)
    ef = [w for w in answers[0]["warnings"] if w.startswith("--error-feedback")]
    assert ef == [w for w in jw if w.startswith("--error-feedback")] and bool(ef) == warns
    assert _msg_mb(answers[0]["lines"]) == _msg_mb(want)


def test_error_feedback_is_dropped_on_one_device():
    lines, got = _port(LENET + ["--code", "svd", "--sample", "topk", "--error-feedback",
                                "--train-dir", ""])
    assert any(w.startswith("--error-feedback needs a multi-device mesh; single-device")
               for w in got)
    assert len(_msg_mb(lines)) == 2


def test_error_feedback_resume_through_the_loop(group, tmp_path):
    """The train loop's checkpoints carry every rank's residual: 2 steps,
    then --resume to 4, equals 4 straight steps bit for bit (parameters,
    momentum and residual); a checkpoint without a residual warns and
    starts from zero."""
    base = LENET + ["--code", "svd", "--sample", "topk", "--error-feedback", "--save-freq",
                    "2", "--device", "cpu", "--seed", "3"]

    def run(d, steps, *extra):
        argv = [a if a != "2" or base[i - 1] != "--max-steps" else str(steps)
                for i, a in enumerate(base)] + ["--train-dir", str(d), *extra]
        answers = group.run("cli", argv=argv)
        assert [a["rc"] for a in answers] == [0, 0], answers
        return answers

    run(tmp_path / "straight", 4)
    run(tmp_path / "cut", 2)
    resumed = run(tmp_path / "cut", 4, "--resume")
    assert any(ln.endswith("at step 2") for ln in resumed[0]["lines"])
    a, b = (_payload(tmp_path / d / "model_step_4") for d in ("straight", "cut"))
    assert a["ef_residual"].shape[0] == 2 and a["ef_residual"].abs().sum() > 0
    for k in ("model", "opt_state"):
        for x, y in zip(_tensors(a[k]), _tensors(b[k])):
            assert torch.equal(x, y)
    assert torch.equal(a["ef_residual"], b["ef_residual"])
    plain = base[:]
    plain.remove("--error-feedback")
    group.run("cli", argv=plain + ["--train-dir", str(tmp_path / "plain")])
    answers = run(tmp_path / "plain", 4, "--resume")
    assert any(w.startswith("--error-feedback resume: checkpoint has no residual carry")
               for w in answers[0]["warnings"])


def _payload(path):
    from atomo_tpu_torch.training.checkpoint import _read_payload

    return _read_payload(str(path))


def _tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []
