"""The LM's model-axis layouts on gloo ranks against the JAX package's step.

Each case runs the JAX package's layout (``build_model_axis_program`` on
the forced CPU mesh, :func:`torch_dist_lm_jax.run_layout`) and the port's
ranks (:mod:`torch_dist`'s ``layout`` job, a group of 2 or 4 workers) for 3
steps from the JAX package's own init of the family's full tree (its
LayerNorm scales perturbed), on the same token batches, every port rank fed
the draws the JAX codec makes for its slice under its replica's key. The
small LM: vocab 16, 8 positions, width 16, depth 4, 2 heads, 4 experts;
batch 4 (8 for dp-pp, so that both microbatch counts divide every mesh).

Cases: dp-tp 1x2 and 2x2; dp-ep 1x2 and 2x2; dp-pp 1x4 and 2x2 with 2 and 4
microbatches; dp-tp-sp 1x2x2 with ``ring`` and ``ulysses-flash`` (the
flash kernel's plain twin on the CPU); ``svd`` and ``qsgd`` across them;
``--stream-encode`` and ``--overlap delayed`` on dp-tp 2x2; dp-tp 1x2 cut
at step 2 and resumed from its checkpoint.

Three cases are marked slow, each with its tier-1 witnesses named beside
it. Tolerances: the replicas (ranks that hold the same slice) bit for bit
after each step; ``msg_bytes`` and ``dense_bytes`` exactly equal; loss rtol
1e-5; the gathered parameters after 3 steps at lr 0.1 within 1e-4 for
``svd`` (the factorisation's float32 differences, as the dp-sp cases) and
2e-5 for ``qsgd`` plus one quantization step times lr for a level that
moved (``quantization_atol``). The port's tp gradients come from
Megatron's pair where the JAX package divides n_tp-scaled ones, so the two
agree to float32 rounding, inside these tolerances.

This file runs the cases on 2 ranks; ``test_torch_lm_dist_layouts4.py`` runs
those on 4 (a file a group, so that the two balance over test workers).
"""

import pytest
import torch_dist_lm_jax as L
from torch_dist import Groups


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = Groups(tmp_path_factory, "layouts")
    yield gs
    gs.close()


class _Starts(dict):
    """Each family's full tree, made at its first use."""

    def __missing__(self, layout):
        self[layout] = L.family_params(layout)
        return self[layout]


@pytest.fixture(scope="module")
def starts():
    return _Starts()


def _run(groups, starts, layout, n, ways, code, aggregate, *, microbatches=2,
         attn_impl="ring", batch=L.BATCH, **modes):
    params = starts[layout]
    toks = L.layout_batches(batch=batch)
    out, final, draws = L.run_layout(layout, n, ways, code, aggregate, params=params,
                                     microbatches=microbatches, attn_impl=attn_impl,
                                     token_batches=toks, **modes)
    answers = groups[n].run(
        "layout", per_rank=[{"draws": d} for d in draws],
        **L.layout_job(layout, ways, code, aggregate, params=params,
                       microbatches=microbatches, attn_impl=attn_impl, token_batches=toks,
                       **modes))
    return out, final, answers


def _atol(code, answers):
    return {"svd": 1e-4, "qsgd": 2e-5}[code] + L.quantization_atol(answers, code, L.STEPS)


SLOW = pytest.mark.slow
CASES = [  # (layout, n, ways, codec, aggregate, microbatches, attention)
    ("dp-tp", 2, 2, "svd", "gather", 2, "ring"),
    # slow; tier-1 witnesses: dp-tp 2x2 qsgd gather under stream-encode and
    # delayed (test_dp_tp_exchange_modes_match_jax)
    pytest.param("dp-tp", 4, 2, "qsgd", "gather", 2, "ring", marks=SLOW),
    ("dp-ep", 2, 2, "qsgd", "gather", 2, "ring"),
    ("dp-ep", 4, 2, "svd", "ring", 2, "ring"),
    ("dp-pp", 4, 4, "svd", "gather", 4, "ring"),
    ("dp-pp", 4, 2, "qsgd", "psum", 2, "ring"),
    # slow; tier-1 witnesses: dp-pp 1x4 with 4 microbatches, 2x2 with 2
    pytest.param("dp-pp", 4, 2, "svd", "gather", 4, "ring", marks=SLOW),
    ("dp-tp-sp", 4, (2, 2), "svd", "gather", 2, "ring"),
    # slow; tier-1 witnesses: dp-tp-sp 1x2x2 ring here, and ulysses over 1x2x2
    # in test_torch_auto_cli.py::test_layout_lm_lines_match_jax[dp-tp-sp]
    pytest.param("dp-tp-sp", 4, (2, 2), "qsgd", "gather", 2, "ulysses-flash", marks=SLOW),
]


def _id(c):
    c = c.values if hasattr(c, "values") else c
    lay, n, ways, code, agg, m, att = c
    w = ways if isinstance(ways, int) else ways[0] * ways[1]
    shape = f"{n // w}x{'x'.join(map(str, ways)) if not isinstance(ways, int) else ways}"
    return f"{lay}-{shape}-{code}-{agg}" + (f"-m{m}" if lay == "dp-pp" else "") + (
        f"-{att}" if lay == "dp-tp-sp" else "")


def cases(world: int) -> list:
    """The cases on ``world`` ranks, as ``parametrize`` takes them."""
    return [pytest.param(*(c.values if hasattr(c, "values") else c), id=_id(c),
                         marks=getattr(c, "marks", ()))
            for c in CASES if (c.values if hasattr(c, "values") else c)[1] == world]


@pytest.mark.parametrize("layout,n,ways,code,aggregate,microbatches,attn_impl", cases(2))
def test_layout_steps_match_jax(groups, starts, layout, n, ways, code, aggregate,
                                microbatches, attn_impl):
    out, final, answers = _run(groups, starts, layout, n, ways, code, aggregate,
                               microbatches=microbatches, attn_impl=attn_impl,
                               batch=8 if layout == "dp-pp" else L.BATCH)
    L.assert_layout_parity(out, final, answers, loss_rtol=1e-5, atol=_atol(code, answers))
    assert out[0]["msg_bytes"] < out[0]["dense_bytes"] or aggregate == "psum"


def dp_tp_exchange_modes_match_jax(groups, starts, modes):
    """``--stream-encode`` (one bucket a leaf; at tp 2 the buckets are
    encoded one after another after backward: the hooks serve only at
    model ways 1) and ``--overlap delayed`` (step 0 skipped) on dp-tp 2x2
    with qsgd, against the JAX package's ``DpExchange`` step."""
    out, final, answers = _run(groups, starts, "dp-tp", 4, 2, "qsgd", "gather", **modes)
    L.assert_layout_parity(out, final, answers, loss_rtol=1e-5,
                           atol=_atol("qsgd", answers))
    if modes.get("overlap") == "delayed":
        assert [s["skipped"] for s in out] == [1.0, 0.0, 0.0]
        assert [s["skipped"] for s in answers[0]["steps"]] == [1.0, 0.0, 0.0]


def test_dp_tp_resumed_run_equals_the_straight_run(groups, starts, tmp_path):
    """dp-tp 1x2 with svd, cut at step 2 (rank 0 writes the gathered full
    tree and its momentum, every rank slices them back) and resumed, equals
    the straight run bit for bit, and both hold the JAX run's tolerances."""
    params = starts["dp-tp"]
    out, final, draws = L.run_layout("dp-tp", 2, 2, "svd", "gather", params=params)
    job = L.layout_job("dp-tp", 2, "svd", "gather", params=params)
    per_rank = [{"draws": d} for d in draws]
    straight = groups[2].run("layout", per_rank=per_rank, **job)
    resumed = groups[2].run("layout", per_rank=per_rank, resume_at=2,
                            train_dir=str(tmp_path / "ck"), **job)
    for a, b in zip(straight, resumed):
        assert [s["hash"] for s in a["steps"]] == [s["hash"] for s in b["steps"]]
        assert b["step"] == 3
    L.assert_layout_parity(out, final, resumed, loss_rtol=1e-5, atol=1e-4)
