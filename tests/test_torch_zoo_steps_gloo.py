"""The zoo's reduced VGG and DenseNet-BC on 2 gloo ranks against the JAX
package's dp-2 step (the companion of ``test_torch_zoo_steps.py``, whose
models, references, draws and tolerances it takes: gather, batch 2 a rank,
``torch_dist_jax.assert_parity``; a file of its own, so that the two
balance over test workers), and the reduced VGG's dropout keep-masks drawn
per rank."""

import numpy as np
import pytest
import torch_dist_jax as J
from test_torch_zoo_steps import CODES, NETWORKS, group, refs  # noqa: F401 (fixtures)


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", list(NETWORKS))
def test_gloo2_steps_match_jax(group, refs, name, code):
    ref = refs(name)
    out, per_rank = ref.run_ranks(code, "gather", 2)
    answers = group.run("train", per_rank=per_rank, **ref.job(code, "gather"))
    J.assert_parity(ref, out, answers, code)


def test_dropout_masks_reach_every_rank(refs):
    """The reduced VGG's two dropout layers draw per rank: each rank's
    keep-masks differ (its key is folded with the rank) and have the shape
    of its shard's classifier input."""
    _, per_rank = refs("vgg_small").run_ranks("sgd", "gather", 2)
    m0, m1 = (r["dropout_masks"][0] for r in per_rank)
    assert [m.shape for m in m0] == [(2, 512), (2, 512)]
    assert not np.array_equal(m0[0], m1[0])
