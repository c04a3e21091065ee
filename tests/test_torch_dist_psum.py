"""The port's ``psum`` exchange, and the dense all-reduce, over N gloo
ranks against the JAX package.

The harness and tolerances are ``tests/test_torch_dist_gather.py``'s
(``torch_dist_jax.assert_parity``). With a codec each rank decodes its own
payloads and the decoded trees are all-reduced: the wire is the dense
gradient, and ``msg_bytes`` says so, as the reference's. Without one
(``sgd``), gather and ring become the dense all-reduce, as in the
reference.
"""

import pytest
import torch_dist_jax as J
from torch_dist import Group

STEPS, BATCH = 2, 16


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {n: Group(n, tmp_path_factory.mktemp(f"gloo{n}")) for n in (2, 4)}
    yield gs
    for g in gs.values():
        g.close()


@pytest.fixture(scope="module")
def lenet():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


def _run(groups, ref, code, aggregate, n):
    out, draws = ref.run(code, aggregate, n)
    answers = groups[n].run("train", per_rank=[{"draws": d} for d in draws],
                            **ref.job(code, aggregate))
    J.assert_parity(ref, out, answers, code)
    return answers


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("code", ["qsgd", "terngrad", "svd", "sgd"])
def test_psum_steps_match_jax(groups, lenet, code, n):
    answers = _run(groups, lenet, code, "psum", n)
    dense = answers[0]["steps"][0]["dense_bytes"]
    assert all(s["msg_bytes"] == dense for s in answers[0]["steps"])


@pytest.mark.parametrize("aggregate,n", [("gather", 2), ("ring", 4)])
def test_dense_gather_and_ring_are_the_all_reduce(groups, lenet, aggregate, n):
    psum = _run(groups, lenet, "sgd", "psum", n)
    got = _run(groups, lenet, "sgd", aggregate, n)
    assert [s["hash"] for s in got[0]["steps"]] == [s["hash"] for s in psum[0]["steps"]]


def test_num_aggregate_refused_with_psum(groups, lenet):
    with pytest.raises(AssertionError, match="num_aggregate requires a codec"):
        groups[2].run("train", **lenet.job("qsgd", "psum", num_aggregate=1))

