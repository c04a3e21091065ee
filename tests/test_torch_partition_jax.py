"""ZeRO-1 and the sharded update over N gloo ranks against the JAX package's
step of the same partition on the forced CPU mesh.

The layout: at N 2 and 3 (an odd count pads the flat vector) the port's
flat parameter vector (the sharded update's masters gathered, ZeRO-1's
persistent buffer) is the JAX package's ``sharded_update_state`` master /
raveled ``zero1_state`` params under ``convert.port_flat_from_jax``, bit
for bit, with the same chunk, true size and per-rank optimizer slice.

The steps: LeNet on synthetic MNIST (global batch 12, 3 steps) from a Flax
init, each rank fed its replica's JAX codec draws, the port's partition
against the JAX step built with ``zero1_specs=`` / ``sharded_update=``:
``torch_dist_jax.assert_parity``'s tolerances, those of the replicated
parity tests of the same model (replicas bit for bit, loss rtol 1e-5,
``msg_bytes`` exact, parameters atol 1e-5 plus one quantization step times
lr a step), and the momentum buffer, gathered and trimmed, against the JAX
flat buffer at the same tolerance.
"""

import jax
import numpy as np
import pytest
import torch_dist_jax as J
from torch_dist import Groups

from atomo_tpu.mesh.update import sharded_update_state as jax_sharded_state
from atomo_tpu.parallel import make_mesh
from atomo_tpu.parallel.replicated import zero1_state as jax_zero1_state
from atomo_tpu_torch.convert import flat_opt_from_jax, port_flat_from_jax

BATCH, STEPS = 12, 3


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = Groups(tmp_path_factory, "gloo_part_jax")
    yield g
    g.close()


@pytest.fixture(scope="module")
def ref():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


@pytest.mark.parametrize("partition", ["zero1", "sharded-update"])
@pytest.mark.parametrize("n", [2, 3])
def test_layout_and_convert_map_against_jax(groups, ref, n, partition):
    from jax.flatten_util import ravel_pytree

    answers = groups[n].run("partition_layout", network="lenet", image_shape=ref.image_shape,
                            state_dict=ref.state_dict, partition=partition)
    mesh = make_mesh(n)
    host = jax.device_get(ref.jstate)
    if partition == "zero1":
        jst, _ = jax_zero1_state(mesh, host, ref.jopt)
        flat, _ = ravel_pytree(jax.device_get(jst.params))
        size = flat_opt_from_jax(ref.port_model, jax.device_get(jst.opt_state))["trace"][0].numel()
        chunk, d_flat = size // n, flat.size
        flat = np.pad(np.asarray(flat), (0, size - flat.size))
    else:
        jst, su = jax_sharded_state(mesh, host, ref.jopt)
        flat, chunk, d_flat = np.asarray(jax.device_get(jst.master)), su.chunk, su.d_flat
    want = port_flat_from_jax(ref.port_model, flat).numpy()
    for r, a in enumerate(answers):
        assert (a["n"], a["chunk"], a["d_flat"], a["opt_len"]) == (n, chunk, d_flat, chunk)
        assert np.array_equal(a["flat"], want), r
    assert (chunk * n > d_flat) == (d_flat % n > 0)  # N 3 pads LeNet's 431080 values


@pytest.mark.parametrize("code,aggregate,n,partition", [
    ("qsgd", "gather", 2, "zero1"), ("qsgd", "gather", 2, "sharded-update"),
    ("sgd", "psum", 2, "sharded-update"), ("qsgd", "gather", 3, "sharded-update"),
], ids=["qsgd-gather-2-zero1", "qsgd-gather-2-sharded", "dense-psum-2-sharded",
        "qsgd-gather-3-sharded"])
def test_partition_matches_the_jax_step(groups, ref, code, aggregate, n, partition):
    out, per_rank = ref.run_ranks(code, aggregate, n, partition=partition)
    answers = groups[n].run("train", per_rank=per_rank,
                            **ref.job(code, aggregate, partition=partition))
    J.assert_parity(ref, out, answers, code)
    full = flat_opt_from_jax(ref.port_model, out[-1]["opt_state"])
    d_flat = answers[0]["opt"]["trace"].size
    levels = {"qsgd": (1 << J.BITS) - 1}.get(code)
    max_step = max(a["max_scale"] for a in answers) / levels if levels else 0.0
    np.testing.assert_allclose(answers[0]["opt"]["trace"], full["trace"][0][:d_flat].numpy(),
                               atol=1e-5 + max_step * STEPS)
    assert answers[0]["count"] == full["count"] == STEPS
