"""The layouts' ``LM:`` lines through both verbs over 4 ranks, and the
layout CLI's checkpoint resume (the companion of ``test_torch_auto_cli.py``,
whose helpers and gloo groups it takes; a file of its own, so that the two
balance over test workers).

``lm --layout dp-tp|dp-ep|dp-pp|dp-tp-sp`` over 4 ranks prints the JAX
verb's ``LM:`` lines: the same steps, layout column and ``Msg(MB)`` and
``Dense(MB)`` (the losses differ: the inits differ), and the same
validation line format (dp-ep with its ``Loss@TrainCap`` suffix). One case
is marked slow, with its tier-1 witnesses named beside it.
"""

import re

import numpy as np
import pytest
from test_torch_auto_cli import LM, LM_LINE, SLOW, _jax, _port_group, groups  # noqa: F401


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
