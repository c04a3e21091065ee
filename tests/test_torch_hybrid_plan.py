"""The port's hybrid planner (``sparse/hybrid.py``) against the JAX package's.

Both packages plan from the same probe: the port's probe starts from the
JAX package's init (carried across by ``convert``), on the same batch. The
plans must be equal field for field, the ``reason`` and ``describe()``
strings included (tolerance: none), for qsgd, svd rank 3 and dense on
``embedding``, ``embedding_wide`` and LeNet (which has no table: all
dense). The dense path's per-leaf bytes, priced here from each codec's
static geometry, equal the JAX package's ``eval_shape`` of an encode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atomo_tpu.codecs import DenseCodec as JaxDense
from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.codecs import terngrad as jax_terngrad
from atomo_tpu.codecs.svd import SvdCodec as JaxSvd
from atomo_tpu.data import SPECS as JAX_SPECS
from atomo_tpu.data import synthetic_dataset as jax_synthetic
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.sparse import hybrid as jax_hybrid
from atomo_tpu_torch.codecs import DenseCodec, QsgdCodec, SvdCodec, terngrad
from atomo_tpu_torch.convert import jax_layouts, state_dict_from_jax
from atomo_tpu_torch.data import zipf_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.sparse import (
    LeafSpec,
    infer_row_bounds,
    leaf_specs,
    measured_densities,
    plan_for_model,
    plan_hybrid,
    probe_gradient,
    row_payload_bytes,
)

CODECS = {
    "qsgd": (lambda: QsgdCodec(bits=4), lambda: JaxQsgd(bits=4)),
    "svd3": (lambda: SvdCodec(rank=3), lambda: JaxSvd(rank=3)),
    "dense": (DenseCodec, JaxDense),
}
BATCH, N_DEV = 32, 4


def _inputs(network):
    if network == "lenet":
        ds = jax_synthetic(JAX_SPECS["mnist"], True, size=BATCH, seed=0)
        return ds.images, ds.labels, (28, 28, 1), 1
    rows = 65536 if network == "embedding_wide" else 4096
    ds = zipf_dataset(True, rows=rows, size=BATCH, seed=0)
    return ds.images, ds.labels, (8,), 8


def _plans(code, network):
    images, labels, shape, slots = _inputs(network)
    jm = jax_model(network, 10)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"])
    pm = get_model(network, 10, image_shape=shape)
    sd = state_dict_from_jax(pm, params)
    make, jmake = CODECS[code]
    got = plan_for_model(make(), pm, images, labels, BATCH // N_DEV, slots, state_dict=sd)
    want = jax_hybrid.plan_for_model(jmake(), jm, images, labels, BATCH // N_DEV, slots)
    return got, want


@pytest.mark.parametrize("network", ["embedding", "embedding_wide", "lenet"])
@pytest.mark.parametrize("code", sorted(CODECS))
def test_plan_equals_jax_field_for_field(code, network):
    got, want = _plans(code, network)
    assert len(got.assignments) == len(want.assignments)
    for a, b in zip(got.assignments, want.assignments):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.describe() == want.describe()
    assert got.payload_bytes() == want.payload_bytes()
    assert got.leaf_budgets() == want.leaf_budgets()
    assert (got.sparse_idxs, got.dense_idxs) == (want.sparse_idxs, want.dense_idxs)
    if network == "lenet":
        assert not got.any_sparse
    else:
        assert got.sparse_idxs == (4,) and got.row_codec(4).max_rows == BATCH // N_DEV * 8
        assert got.assignments[4].payload_bytes == row_payload_bytes(64, got.assignments[4]
                                                                     .shape[1])


SHAPES = [(64,), (128, 64), (64, 10), (4096, 16), (65536, 32), (3, 3, 16, 32), (7,), (1, 513)]


@pytest.mark.parametrize("name,make,jmake", [
    ("qsgd2", lambda: QsgdCodec(bits=2), lambda: JaxQsgd(bits=2)),
    ("qsgd8b128", lambda: QsgdCodec(bits=8, bucket_size=128),
     lambda: JaxQsgd(bits=8, bucket_size=128)),
    ("terngrad", terngrad, jax_terngrad),
    ("svd3", lambda: SvdCodec(rank=3), lambda: JaxSvd(rank=3)),
    ("svd_budget", lambda: SvdCodec(rank=2, sample="bernoulli_budget"),
     lambda: JaxSvd(rank=2, sample="bernoulli_budget")),
    ("svd_bf16", lambda: SvdCodec(rank=3, wire_dtype="bfloat16"),
     lambda: JaxSvd(rank=3, wire_dtype="bfloat16")),
    ("dense", DenseCodec, JaxDense),
])
def test_leaf_payload_bytes_equal_jax_eval_shape(name, make, jmake):
    codec, jcodec = make(), jmake()
    for shape in SHAPES:
        leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
        assert codec.leaf_payload_bytes(shape) == \
            jax_hybrid._codec_leaf_payload_bytes(jcodec, leaf), (name, shape)


def test_measured_densities_and_bounds_match_jax():
    images, labels, shape, slots = _inputs("embedding")
    jm = jax_model("embedding", 10)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"])
    pm = get_model("embedding", 10, image_shape=shape)
    grads = probe_gradient(pm, images, labels, state_dict_from_jax(pm, params))
    jgrads = jax_hybrid.probe_gradient(jm, images, labels)
    assert measured_densities(grads, jax_layouts(pm)) == jax_hybrid.measured_densities(jgrads)
    specs = leaf_specs(pm)
    for bpc, sl in ((8, 8), (1, 1), (1 << 20, 8)):
        assert infer_row_bounds(specs, bpc, sl) == jax_hybrid.infer_row_bounds(jgrads, bpc, sl)
    assert infer_row_bounds(specs, 1 << 20, 8)[4] == 4096  # clamped to the table rows


def test_name_hints_and_non_2d_leaves():
    specs = [LeafSpec("['emb']['embedding']", (100, 4)), LeafSpec("['Dense_0']['kernel']",
                                                                  (100, 4)),
             LeafSpec("['table']", (100,)), LeafSpec("['my_TABLE']", (50, 2))]
    assert infer_row_bounds(specs, 2, 3) == [6, None, None, 6]
    import torch

    g = [torch.zeros(4, 10), torch.ones(4)]  # port layout: a linear (out, in)
    g[0][:, 2] = 1.0  # JAX view (in, out): row 2 of 10 is nonzero
    assert measured_densities(g) == [pytest.approx(0.1), 1.0]


def test_plan_assigns_dense_when_the_budget_crosses_and_rejects_mismatch():
    spec = [LeafSpec("['table']", (4096, 16))]
    plan = plan_hybrid(DenseCodec(), spec, [0.03], [4096])
    a = plan.assignments[0]
    assert a.kind == "dense" and not plan.any_sparse
    assert a.reason.startswith("dense: B=4096 rows would cost")
    with pytest.raises(ValueError, match="leaf 0 .* is dense-assigned"):
        plan.row_codec(0)
    with pytest.raises(ValueError, match="canonical order"):
        plan_hybrid(DenseCodec(), spec, [1.0, 1.0], [None])
    jplan = jax_hybrid.plan_hybrid(JaxDense(), {"table": np.zeros((4096, 16), np.float32)},
                                   [0.03], [4096])
    assert dataclasses.asdict(jplan.assignments[0]) == dataclasses.asdict(a)
