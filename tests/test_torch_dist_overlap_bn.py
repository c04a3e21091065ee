"""The delayed step's skip of step 0 on a model with BatchNorm, over 2 gloo ranks.

A DenseNet-BC (growth 4, depth 10, BatchNorm after every conv) on synthetic
CIFAR-10 (global batch 4, 3 steps) from the weights of a Flax init, each
rank fed its replica's JAX draws (:mod:`torch_dist`), under
``overlap="delayed"`` against the JAX package's delayed dp-2 step
(``torch_dist_jax.assert_parity``'s tolerances, BatchNorm statistics within
rtol 1e-4). Step 0 applies nothing: every rank's parameters and BatchNorm
statistics hash as they did before it, though its forward moved the
statistics (step 1's hash differs).
"""

import pytest
import torch_dist_jax as J
from torch_dist import Group

STEPS, N = 3, 2


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(N, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


def test_delayed_step0_holds_the_batchnorm_statistics(group):
    dense = J.Reference(("DenseNet", {"growth_rate": 4, "depth": 10}), "cifar10", 4, STEPS)
    out, per_rank = dense.run_ranks("qsgd", "gather", N, overlap="delayed")
    answers = group.run("train", per_rank=per_rank,
                        **dense.job("qsgd", "gather", overlap="delayed"))
    J.assert_parity(dense, out, answers, "qsgd")
    assert [s["skipped"] for s in out] == [1.0, 0.0, 0.0]
    for a in answers:
        assert [s["skipped"] for s in a["steps"]] == [1.0, 0.0, 0.0]
        assert a["steps"][0]["hash"] == a["hash0"]
        # the forward moved the statistics; only the skipped step put them back
        assert a["steps"][1]["hash"] != a["hash0"]
