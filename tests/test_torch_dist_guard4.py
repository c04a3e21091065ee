"""The guarded data-parallel step over 4 gloo ranks against the JAX dp-4
step: ``test_torch_dist_guard.py``'s plan and comparisons (replica 1 dropped
at steps 2 and 3, all four at step 4) for ``gather``, ``ring`` and ``psum``
with qsgd, and ``gather`` with ``num_aggregate`` 2 (the flags take the
payloads' rotating subset: replica 1 is in the subset at steps 2 and 3 only
when the rotation says so)."""

import pytest
import torch_dist_jax as J
from test_torch_dist_guard import BATCH, STEPS, expected, guard_case
from torch_dist import Group


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(4, tmp_path_factory.mktemp("gloo4"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def ref():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


@pytest.mark.parametrize("aggregate", ["gather", "ring", "psum"])
def test_guarded_exchange_matches_jax_at_four(group, ref, aggregate):
    got, _ = guard_case(group, ref, "qsgd", aggregate, 4)
    assert got == expected(4)


def test_guarded_subset_matches_jax(group, ref):
    got, _ = guard_case(group, ref, "qsgd", "gather", 4, num_aggregate=2)
    assert got[3] == (2.0, 1.0)  # every consumed payload poisoned
