"""The port's ``ring`` exchange over N gloo ranks: against the JAX package's
ring, and against the port's own gather.

Train steps: as ``tests/test_torch_dist_gather.py`` (the same harness and
tolerances, ``torch_dist_jax.assert_parity``), with the port's ring held
against the reference's ring (``aggregate="ring"`` there too), not against
gather: the reference's own ring-vs-gather qsgd identity test is red.

The exchange alone: each rank encodes its own gradients, then gather's
decode-mean over the gathered buffer and the ring's decode-mean over the
rotated payloads must agree bit for bit for QSGD and TernGrad (both sum the
replicas' decodes in replica order, then divide), and for SVD against
gather's unfused decode order (``decode_mean_tree(fused=False)``; the fused
product sums in another order). The ring's message cap
(``ring_bucket_size``) moves the same bytes whatever its value.
"""

import numpy as np
import pytest
import torch_dist_jax as J
from torch_dist import Group

from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training.trainer import leaf_params

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


def _run(groups, ref, code, n, num_aggregate=0, ring_bucket_size=65536):
    out, draws = ref.run(code, "ring", n, num_aggregate)
    answers = groups[n].run("train", per_rank=[{"draws": d} for d in draws],
                            **ref.job(code, "ring", num_aggregate, ring_bucket_size))
    J.assert_parity(ref, out, answers, code)
    return answers


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("code", ["qsgd", "terngrad", "svd"])
def test_ring_steps_match_jax_ring(groups, lenet, code, n):
    _run(groups, lenet, code, n)


@pytest.mark.parametrize("code", ["qsgd", "svd"])
def test_ring_num_aggregate_matches_jax(groups, lenet, code):
    _run(groups, lenet, code, 4, num_aggregate=1)


def _grads(n, seed=0):
    shapes = [tuple(p.shape) for p in leaf_params(get_model("lenet", 10,
                                                            image_shape=(28, 28, 1)))]
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(n)]


AGG_CODECS = {"qsgd": ("qsgd", {"quantization_level": 4}), "terngrad": ("terngrad", {}),
              "svd": ("svd", {"svd_rank": 3})}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("code", ["qsgd", "terngrad", "svd"])
def test_ring_equals_gather_bit_for_bit(groups, code, n):
    answers = groups[n].run("aggregate", per_rank=[{"grads": g} for g in _grads(n)],
                            codec=AGG_CODECS[code], draws=None, fused_gather=code != "svd",
                            ring_bucket_size=65536)
    for a in answers:
        assert a["equal"], code
        for x, y in zip(a["ring"], answers[0]["ring"]):  # every rank holds one mean
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k,step", [(1, 2), (2, 3), (3, 1)])
def test_ring_subset_equals_gather_subset(groups, k, step):
    """num_aggregate's rotating window, where it wraps (k 2 from 3) too."""
    answers = groups[4].run("aggregate", per_rank=[{"grads": g} for g in _grads(4, 1)],
                            codec=AGG_CODECS["qsgd"], draws=None, fused_gather=True,
                            ring_bucket_size=65536, num_aggregate=k, step=step)
    assert all(a["equal"] for a in answers)


@pytest.mark.parametrize("bucket", [0, 1000, 20000])
def test_ring_bucket_size_is_layout_only(groups, lenet, bucket):
    """Any cap on a hop's message gives the default's states bit for bit."""
    ref = _run(groups, lenet, "qsgd", 4)
    got = _run(groups, lenet, "qsgd", 4, ring_bucket_size=bucket)
    assert [s["hash"] for s in got[0]["steps"]] == [s["hash"] for s in ref[0]["steps"]]


@pytest.mark.slow
def test_resnet18_ring_matches_jax(groups):
    """ResNet-18 (CIFAR-10 shapes, BatchNorm statistics averaged over the
    ranks) at N = 2, qsgd 4 bits, the port's ring against the JAX step in
    float64 with gather: the JAX ring does not run under x64 (its
    ``lax.rem`` of the int32 axis index and the int64 loop index refuses,
    ``replicated.py:574``), and in float32 XLA's BatchNorm gradient is what
    the comparison would measure (``tests/test_torch_trainer.py``). The two
    exchanges compute one mean (the reference's ring trajectories track
    gather to ~1e-8). Tier-1 witness: ``test_ring_steps_match_jax_ring[qsgd-2]``
    (LeNet against the JAX ring, no BatchNorm)."""
    ref = J.Reference("resnet18", "cifar10", BATCH, STEPS, x64=True)
    out, draws = ref.run("qsgd", "gather", 2)
    answers = groups[2].run("train", per_rank=[{"draws": d} for d in draws],
                            **ref.job("qsgd", "ring"))
    J.assert_parity(ref, out, answers, "qsgd")
