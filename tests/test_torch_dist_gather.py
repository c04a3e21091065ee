"""The port's ``gather`` exchange over N gloo ranks against the JAX package.

N port processes on the CPU (one gloo group for each N, started once for
this file: :mod:`torch_dist`) run ``parallel/replicated.py``'s step from the
weights of a Flax init, on the same global batches, each rank fed its
replica's codec draws from the JAX package's step key; the JAX package runs
its ``make_distributed_train_step`` on a sub-mesh of N of the conftest's
forced CPU devices. After each step every rank's state hashes alike
(replicas bit for bit); after two, rank 0's parameters, loss and
``msg_bytes`` hold the reference's at the tolerances of
``tests/test_torch_trainer.py``'s LeNet cases (``torch_dist_jax.assert_parity``).
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


def _run(groups, ref, code, n, num_aggregate=0):
    out, draws = ref.run(code, "gather", n, num_aggregate)
    answers = groups[n].run("train", per_rank=[{"draws": d} for d in draws],
                            **ref.job(code, "gather", num_aggregate))
    J.assert_parity(ref, out, answers, code)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("code", ["qsgd", "terngrad", "svd"])
def test_gather_steps_match_jax(groups, lenet, code, n):
    _run(groups, lenet, code, n)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("code", ["qsgd", "svd"])
def test_gather_num_aggregate_matches_jax(groups, lenet, code, k):
    """The mean over the rotating subset ``(step + arange(k)) % 4``."""
    _run(groups, lenet, code, 4, num_aggregate=k)


@pytest.mark.slow
def test_resnet18_gather_matches_jax(groups):
    """ResNet-18 (CIFAR-10 shapes, BatchNorm statistics averaged over the
    ranks) at N = 2, qsgd 4 bits, against the JAX step in float64. Tier-1
    witness: ``test_gather_steps_match_jax[qsgd-2]`` (LeNet, the same step
    and exchange, no BatchNorm)."""
    _run(groups, J.Reference("resnet18", "cifar10", BATCH, STEPS, x64=True), "qsgd", 2)
