"""The port's models and weight conversion against the Flax models.

Weights come from a Flax init (vectors and BatchNorm statistics perturbed
from a numpy seed, so that every converted field matters) and move over with
``atomo_tpu_torch.convert``; inputs are numpy draws. Logits agree within
rtol 1e-4 / atol 1e-5 (float32 convolutions summed in different orders);
the conversion round trip is exact.

ResNet-18 runs at 8x8 and 16x16 inputs, batch 2, in eval mode, and at 16x16
in train mode. At 8x8 its last stage is 1x1, so a train-mode BatchNorm there
normalizes two values per channel, and the one-pass variance that Flax and
the port share (mean(x^2) - mean(x)^2) cancels: the port's own float32
logits then differ from its float64 logits by ~1e-2, so no float32
implementation can meet rtol 1e-4 there. At 16x16 the stage sees 8 values
per channel and float32 is good to ~3e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.models import get_model as jax_model
from atomo_tpu_torch.convert import (
    jax_from_state_dict,
    jax_leaf_order,
    jax_view,
    state_dict_from_jax,
)
from atomo_tpu_torch.models import get_model

TOL = dict(rtol=1e-4, atol=1e-5)
CASES = [("resnet18", (16, 16, 3)), ("lenet", (28, 28, 1)), ("fc", (28, 28, 1))]
EVAL_CASES = [("resnet18", (8, 8, 3))] + CASES


def _flax_weights(name, shape, seed=0):
    model = jax_model(name, 10)
    x = np.random.default_rng(seed).standard_normal((2,) + shape).astype(np.float32)
    variables = model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=False,
    )
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0),
        variables["params"],
    )
    stats = jax.tree_util.tree_map(np.asarray, variables.get("batch_stats", {}))
    stats = {k: _perturb_stats(v, rng) for k, v in stats.items()} if stats else {}
    return model, x, params, stats


def _perturb_stats(tree, rng):
    if "mean" in tree:
        return {
            "mean": (0.1 * rng.standard_normal(tree["mean"].shape)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32),
        }
    return {k: _perturb_stats(v, rng) for k, v in tree.items()}


def _port(name, shape, params, stats):
    model = get_model(name, 10, image_shape=shape)
    model.load_state_dict(state_dict_from_jax(model, params, stats))
    return model


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _variables(params, stats):
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return variables


@pytest.mark.parametrize("name,shape", EVAL_CASES)
def test_eval_logits_match_flax(name, shape):
    """Eval mode: the running statistics normalize."""
    fmodel, x, params, stats = _flax_weights(name, shape)
    model = _port(name, shape, params, stats)
    want = np.asarray(fmodel.apply(_variables(params, stats), jnp.asarray(x), train=False))
    model.eval()
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,shape", CASES)
def test_logits_and_bn_stats_match_flax(name, shape):
    """Train mode: batch statistics, and the running statistics they update
    (Flax's biased batch variance, momentum 0.9)."""
    fmodel, x, params, stats = _flax_weights(name, shape)
    model = _port(name, shape, params, stats)
    want, mutated = fmodel.apply(_variables(params, stats), jnp.asarray(x), train=True,
                                 rngs={"dropout": jax.random.PRNGKey(2)},
                                 mutable=["batch_stats"] if stats else [])
    model.train()
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if stats:
        _, new_stats = jax_from_state_dict(model)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
            new_stats, jax.tree_util.tree_map(np.asarray, dict(mutated["batch_stats"])),
        )


@pytest.mark.parametrize("name,shape", CASES)
def test_convert_round_trip_is_exact(name, shape):
    _, _, params, stats = _flax_weights(name, shape)
    model = _port(name, shape, params, stats)
    p2, s2 = jax_from_state_dict(model)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(p2)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(s2)


@pytest.mark.parametrize("name,shape", CASES)
def test_leaf_order_is_jax_flatten_order(name, shape):
    _, _, params, _ = _flax_weights(name, shape)
    model = get_model(name, 10, image_shape=shape)
    order = jax_leaf_order(model)
    jax_shapes = [tuple(a.shape) for a in jax.tree_util.tree_leaves(params)]
    named = dict(model.named_parameters())
    assert len(order) == len(jax_shapes) == len(named)
    assert [tuple(jax_view(named[n]).shape) for n in order] == jax_shapes


def test_resnet18_leaf_layout():
    """62 leaves: BasicBlock_0..7 (BatchNorm_0..2 then Conv_0..2 inside,
    BN leaves bias before scale), then the stem BatchNorm_0, Conv_0, Dense_0."""
    order = jax_leaf_order(get_model("resnet18", 10, image_shape=(32, 32, 3)))
    assert len(order) == 62
    assert order[:4] == ["BasicBlock_0.BatchNorm_0.bias", "BasicBlock_0.BatchNorm_0.weight",
                         "BasicBlock_0.BatchNorm_1.bias", "BasicBlock_0.BatchNorm_1.weight"]
    assert order[-5:] == ["BatchNorm_0.bias", "BatchNorm_0.weight", "Conv_0.weight",
                          "Dense_0.bias", "Dense_0.weight"]
    n = sum(p.numel() for p in get_model("resnet18", 10, image_shape=(32, 32, 3)).parameters())
    assert n == 11_173_962
