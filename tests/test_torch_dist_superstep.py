"""Superstep blocks of the data-parallel step over 2 gloo ranks, against the
single steps and the JAX package.

LeNet on synthetic MNIST (global batch 16, 6 steps) from the weights of a
Flax init: the port's ranks (:mod:`torch_dist`) run
``make_distributed_train_step(superstep=k)`` over blocks of [3, 3], each
rank on its rows of every step of the block and fed its replica's JAX draws
step by step (on gloo every block is the eager K-step block). Bit for bit
within the port: the per-step losses and every rank's parameters and buffers
at the block boundaries equal those of the single steps, for gather, ring
and psum, svd and dense, with ``num_aggregate``, ``grad_accum``, error
feedback (the residual carried from step to step inside the block) and the
hybrid sparse-row exchange on the embedding tower; a run cut after step 1
(inside a K = 3 block's span) and resumed from its checkpoint in blocks of
3 equals the straight blocks. Against the JAX dp-2 step: the tolerances of
``torch_dist_jax.assert_parity`` (replicas bit for bit at every boundary,
loss rtol 1e-5, ``msg_bytes`` exact, parameters atol 1e-5 plus one
quantization step times lr a step).
"""

import pytest
import torch_dist_jax as J
from test_torch_dist_sparse import SparseRef
from torch_dist import Group

from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu_torch.codecs import QsgdCodec
from atomo_tpu_torch.data import BatchIterator, zipf_dataset

STEPS, BATCH, N = 6, 16, 2
PARTS = [3, 3]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(N, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def ref():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


def _per_rank(draws):
    return [{"draws": d} for d in draws]


def _same(single, blocked, parts=PARTS):
    """Per-step losses (and EF norms, row overflow) equal, and every rank's
    hash at each block boundary equal to its single-step hash."""
    bounds = [sum(parts[:i + 1]) - 1 for i in range(len(parts))]
    for a, b in zip(single, blocked):
        for key in ("loss", "prec1", "ef_res_norm", "row_overflow", "msg_bytes"):
            assert [s[key] for s in a["steps"]] == [s[key] for s in b["steps"]], key
        for s in bounds:
            assert b["steps"][s]["hash"] == a["steps"][s]["hash"], s
        assert all(b["steps"][s]["hash"] is None for s in range(len(b["steps"]))
                   if s not in bounds)


@pytest.mark.parametrize("code,aggregate", [
    ("qsgd", "gather"), ("qsgd", "ring"), ("qsgd", "psum"), ("svd", "gather"), ("sgd", "psum"),
])
def test_blocks_equal_the_single_steps_and_jax(group, ref, code, aggregate):
    out, draws = ref.run(code, aggregate, N)
    args = ref.job(code, aggregate)
    single = group.run("train", per_rank=_per_rank(draws), **args)
    blocked = group.run("train", per_rank=_per_rank(draws), parts=PARTS, **args)
    _same(single, blocked)
    J.assert_parity(ref, out, blocked, code)


@pytest.mark.parametrize("kw", [dict(num_aggregate=1), dict(grad_accum=2)],
                         ids=["num_aggregate", "grad_accum"])
def test_blocks_compose_with_subsets_and_microbatches(group, ref, kw):
    out, per_rank = ref.run_ranks("qsgd", "gather", N, kw.get("num_aggregate", 0),
                                  kw.get("grad_accum", 1))
    args = ref.job("qsgd", "gather", **kw)
    single = group.run("train", per_rank=per_rank, **args)
    blocked = group.run("train", per_rank=per_rank, parts=PARTS, **args)
    _same(single, blocked)
    J.assert_parity(ref, out, blocked, "qsgd")


def test_error_feedback_rides_the_block(group, ref):
    """The residual goes from step to step inside each block: K = 3 equals
    the single steps bit for bit, ``ef_res_norm`` step by step."""
    _, draws = ref.run("qsgd", "gather", N)
    args = dict(ref.job("qsgd", "gather"), error_feedback=True)
    single = group.run("train", per_rank=_per_rank(draws), **args)
    blocked = group.run("train", per_rank=_per_rank(draws), parts=PARTS, **args)
    _same(single, blocked)
    assert all(s["ef_res_norm"] > 0 for s in blocked[0]["steps"])


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "error_feedback"])
def test_resume_inside_a_block_span(group, ref, tmp_path, ef):
    """Cut after step 1 and resumed from the checkpoint (every rank's
    residual gathered into it with EF) in blocks of 3 (steps 2-4, 5-6):
    at step 6 every rank equals the straight [3, 3] blocks bit for bit."""
    _, draws = ref.run("qsgd", "gather", N)
    args = dict(ref.job("qsgd", "gather"), error_feedback=ef)
    straight = group.run("train", per_rank=_per_rank(draws), parts=PARTS, **args)
    cut = group.run("train", per_rank=_per_rank(draws), parts=[1, 3, 2], resume_at=1,
                    train_dir=str(tmp_path), **args)
    for a, b in zip(straight, cut):
        assert a["steps"][-1]["hash"] == b["steps"][-1]["hash"]
        assert [s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"]]


@pytest.fixture(scope="module")
def sparse_ref():
    r = SparseRef()
    it = BatchIterator(zipf_dataset(True, size=BATCH * 4, seed=3), BATCH, seed=3).forever()
    r.batches = [next(it) for _ in range(4)]
    return r


@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_hybrid_rides_the_block(group, sparse_ref, aggregate):
    """The embedding tower's hybrid exchange (the table as rows, the rest
    qsgd) in blocks of [3, 1] equals its single steps bit for bit and the
    JAX dp-2 hybrid step."""
    plan, jplan = sparse_ref.plans(QsgdCodec(bits=J.BITS), JaxQsgd(bits=J.BITS), N)
    assert plan.any_sparse
    out, draws = sparse_ref.run(JaxQsgd(bits=J.BITS), aggregate, N, jplan)
    args = sparse_ref.job(J.CODECS["qsgd"][0], aggregate, plan)
    single = group.run("train", per_rank=_per_rank(draws), **args)
    blocked = group.run("train", per_rank=_per_rank(draws), parts=[3, 1], **args)
    _same(single, blocked, [3, 1])
    J.assert_parity(sparse_ref, out, blocked, "qsgd")
    assert {s["msg_bytes"] for s in blocked[0]["steps"]} == {plan.payload_bytes()}
