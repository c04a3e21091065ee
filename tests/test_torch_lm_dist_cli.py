"""The rest of the port's ``lm`` verb over gloo ranks against the JAX
package's: the CLI's ``LM:`` lines, ``--resume``, ``--bf16`` and
``--optimizer adam`` (CPU).

The CLI runs on 4 workers as ``torchrun --nproc-per-node 4 -m
atomo_tpu_torch lm --n-devices 4 ...`` runs it; the JAX verb runs in the test
process on the forced CPU mesh. The two packages draw their initial weights
differently, so the lines are compared where they do not depend on them:
the format, the ``Layout:`` field and the wire columns, exactly. Parity of
the numbers is held by the ``lm`` job from the same Flax init (as in
``tests/test_torch_lm_dist_steps.py``), with the tolerances stated in each
test.

Resume. The JAX verb resumed at step k draws its next batch from a fresh
``--seed`` stream, the batch of step 1, and folds step i's key with i
(``atomo_tpu/cli.py:3532-3580,3605-3607``); the port does the same. At
``--lr 0`` the parameters stay put, so in both packages the losses of the
resumed steps k+1, k+2 equal those of steps 1, 2, as printed. And from the
same init, the port cut at step 2 (rank 0 saving, every rank loading) and
continued over the fresh stream equals the JAX package's run over the batches
the resumed verb takes, 1, 2, 1, 2.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_dist_lm_jax as L
from torch_dist import Group

from atomo_tpu import cli as jax_cli
from atomo_tpu_torch import cli

LM_LINE = re.compile(
    r"^LM: Step: (\d+), Layout: (dp(?:-sp)?\(dp\dxsp\d\)), Loss: (\d+\.\d{4}), "
    r"PPL: \d+\.\d{2}, Time Cost: \d+\.\d{4}, Msg\(MB\): (\d+\.\d{4}), "
    r"Dense\(MB\): (\d+\.\d{4})$")
BASE = ["lm", "--vocab-size", "16", "--seq-len", "16", "--width", "16", "--depth", "2",
        "--num-heads", "2", "--batch-size", "4", "--log-interval", "1", "--seed", "3"]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {n: Group(n, tmp_path_factory.mktemp(f"cligloo{n}")) for n in (2, 4)}
    yield gs
    for g in gs.values():
        g.close()


def _port(group, argv):
    """Every rank's answer to the CLI with ``argv``; rank 0's log lines."""
    answers = group.run("cli", argv=argv + ["--device", "cpu"])
    for a in answers:
        assert a["rc"] == 0, a["exit"]
    assert not any(ln.startswith("LM") for a in answers[1:] for ln in a["lines"])
    return answers[0]["lines"]


def _jax(argv, capsys):
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _lm(lines):
    return [LM_LINE.match(ln).groups() for ln in lines if ln.startswith("LM: ")]


@pytest.mark.parametrize("extra", [
    ["--layout", "dp-sp", "--ways", "2", "--attn-impl", "ulysses-flash", "--code", "svd",
     "--aggregate", "gather"],
    ["--layout", "dp-sp", "--ways", "4", "--code", "qsgd", "--aggregate", "ring"],
    ["--layout", "dp", "--code", "svd", "--aggregate", "psum"],
], ids=["dp2xsp2-svd-gather", "dp1xsp4-qsgd-ring", "dp4-svd-psum"])
def test_cli_lm_lines_match_jax(groups, capsys, extra):
    argv = BASE + ["--n-devices", "4", "--max-steps", "2"] + extra
    got, want = _lm(_port(groups[4], argv)), _lm(_jax(argv, capsys))
    assert [g[0] for g in got] == [w[0] for w in want] == ["1", "2"]
    for g, w in zip(got, want):
        assert (g[1], g[3], g[4]) == (w[1], w[3], w[4])  # layout and the wire columns
        assert np.isfinite(float(g[2]))


def test_cli_lm_resume_draws_a_fresh_stream_as_jax(groups, capsys, tmp_path):
    argv = BASE + ["--n-devices", "4", "--layout", "dp-sp", "--ways", "2", "--code", "sgd",
                   "--lr", "0", "--save-freq", "2"]
    runs = {}
    for name, run in (("port", lambda a: _port(groups[4], a)),
                      ("jax", lambda a: _jax(a, capsys))):
        d = str(tmp_path / name)
        first = run(argv + ["--train-dir", d, "--max-steps", "2"])
        second = run(argv + ["--train-dir", d, "--max-steps", "4", "--resume"])
        assert f"Resumed from {d} at step 2" in second
        runs[name] = (_lm(first), _lm(second))
        straight = _lm(run(argv + ["--max-steps", "4"]))
        # the fresh stream: steps 3 and 4 take the batches of steps 1 and 2
        assert [g[2] for g in runs[name][1]] == [g[2] for g in runs[name][0]]
        assert straight[2][2] != straight[0][2]
    for (a, b), (c, d) in zip(*runs.values()):
        assert (a[1], a[3], a[4]) == (c[1], c[3], c[4])


def test_lm_resumed_run_matches_jax_continuation(groups, tmp_path):
    """From the same init, at lr 0.1 with svd: the port's run cut at step 2
    and resumed (rank 0 saves a compressed checkpoint, every rank loads
    it) over the batches 1, 2, 1, 2 that the resumed verb draws, against the
    JAX package's run over them; the tolerances of the steps file's svd
    cases (loss rtol 1e-5, parameters atol 1e-4)."""
    params = L.flax_params()
    sd = L.port_state_dict(params)
    toks = L.batches(2) * 2
    out, final, draws = L.run(4, 2, "ring", "svd", "gather", params=params, token_batches=toks)
    answers = groups[4].run("lm", per_rank=[{"draws": d} for d in draws], resume_at=2,
                            train_dir=str(tmp_path / "ck"),
                            **L.job(2, "ring", "svd", "gather", state_dict=sd,
                                    token_batches=toks))
    L.assert_parity(out, final, answers, loss_rtol=1e-5, atol=1e-4)
    assert answers[0]["step"] == 4


def test_lm_adam_matches_jax(groups):
    """``--optimizer adam`` (lr 0.01) on the 2x2 mesh, ulysses, dense
    psum: loss rtol 1e-5, parameters atol 1e-5 after 3 steps (Adam's step
    is lr times a ratio of moments, so float32 differences of the gradient
    move it little where the gradient is not near zero)."""
    params = L.flax_params()
    out, final, _ = L.run(4, 2, "ulysses", "sgd", "psum", params=params, optimizer="adam",
                          lr=0.01)
    answers = groups[4].run("lm", **L.job(2, "ulysses", "sgd", "psum", optimizer="adam",
                                          lr=0.01, state_dict=L.port_state_dict(params)))
    L.assert_parity(out, final, answers, loss_rtol=1e-5, atol=1e-5)


def test_lm_bf16_matches_jax(groups):
    """``--bf16`` (``compute_dtype=jnp.bfloat16`` on the JAX side) for 2
    steps on the 2x2 mesh with ulysses-flash, dense: both packages cast the
    parameters to bfloat16 for forward and backward and keep float32
    masters and logits. bfloat16 keeps 8 bits of mantissa, and the two
    round after different ops, so the loss is held within 1e-3 relative;
    each leaf's update after the 2 steps (the parameters' move) at cosine
    0.999 or more with the JAX package's, and within 1e-3 of it entrywise
    (lr 0.1 times a bfloat16 rounding of gradients of a few 1e-2). The
    port's parameters stay float32."""
    params = L.flax_params()
    out, final, _ = L.run(4, 2, "ulysses-flash", "sgd", "gather", params=params,
                          compute_dtype=jnp.bfloat16, steps=2)
    answers = groups[4].run("lm", **L.job(2, "ulysses-flash", "sgd", "gather", bf16=True,
                                          steps=2, state_dict=L.port_state_dict(params)))
    assert {v.dtype for v in answers[0]["state_dict"].values()} == {np.dtype(np.float32)}
    for s, want in enumerate(out):
        assert len({a["steps"][s]["hash"] for a in answers}) == 1
        np.testing.assert_allclose(answers[0]["steps"][s]["loss"], want["loss"], rtol=1e-3)
    got = jax.tree_util.tree_leaves(L.jax_params(answers[0]["state_dict"]))
    for a, b, p in zip(got, jax.tree_util.tree_leaves(final), jax.tree_util.tree_leaves(params)):
        da, db = (a - p).ravel(), (np.asarray(b) - p).ravel()
        assert float(da @ db / (np.linalg.norm(da) * np.linalg.norm(db))) >= 0.999
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3, rtol=0)


@pytest.mark.parametrize("extra,match", [
    (["--stream-encode", "--overlap", "delayed"], "needs a multi-replica dp axis"),
    (["--overlap", "delayed", "--code", "sgd"], "a dense --code has no payload to carry"),
    (["--aggregate", "ring", "--code", "sgd"], "dense code"),
    (["--layout", "dp-sp", "--ways", "3"], "does not divide 1 devices"),
    (["--n-devices", "2"], "torchrun --nproc-per-node 2"),
], ids=["stream-encode", "overlap", "dense-ring", "ways", "n-devices"])
def test_cli_lm_refuses_on_one_process(extra, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(BASE + ["--max-steps", "1", "--device", "cpu"] + extra,
                 log_fn=lambda line: None)


def test_cli_lm_names_torchrun_for_a_group_of_another_size(groups):
    answers = groups[2].run("cli", argv=BASE + ["--n-devices", "4", "--max-steps", "1",
                                                "--device", "cpu"])
    assert all(a["rc"] == 1 and "torchrun --nproc-per-node 4" in a["exit"] for a in answers)
