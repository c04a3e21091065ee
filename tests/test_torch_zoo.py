"""The port's model zoo (VGG, DenseNet, AlexNet) against the Flax models.

As ``tests/test_torch_models.py``: weights from a Flax init (vectors and
BatchNorm statistics perturbed from a numpy seed) moved over by
``atomo_tpu_torch.convert``, numpy inputs; logits and BatchNorm statistics
within rtol 1e-4 / atol 1e-5 (float32 convolutions summed in other orders),
the conversion round trip exact. Train mode runs the models' dropout with
the keep-masks Flax draws (captured by ``torch_dist_jax.flax_dropout_masks``
and handed to the port through ``dropout_stream(masks=...)``).

Sizes: the VGGs at 32x32 (their last map is 1x1), small DenseNets (growth
4; depth 10 and 16 with the bottleneck, 10 without) at 16x16, AlexNet at
64x64 (its last map 1x1; at 224x224 it is 6x6, where the NHWC flatten
matters, which ``test_alexnet_flatten_order_at_224`` checks on the
classifier alone). The full-size parameter and leaf counts are the JAX
models' ``jax.eval_shape`` counts, held as numbers: no JAX model runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_jax as J
from test_torch_models import _nchw, _perturb_stats, _variables

from atomo_tpu.models import densenet as jax_densenet
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.models import model_names as jax_model_names
from atomo_tpu_torch.convert import (
    jax_from_state_dict,
    jax_layouts,
    jax_leaf_order,
    jax_view,
    state_dict_from_jax,
)
from atomo_tpu_torch.models import DenseNet, dropout_stream, get_model, model_names
from atomo_tpu_torch.training.trainer import init_params

TOL = dict(rtol=1e-4, atol=1e-5)
# case id: (the JAX model, the port's model for an input shape, (H, W, C))
CASES = {
    "vgg11": (lambda: jax_model("vgg11", 10), lambda s: get_model("vgg11", 10, image_shape=s),
              (32, 32, 3)),
    "vgg11_plain": (lambda: jax_model("vgg11_plain", 10),
                    lambda s: get_model("vgg11_plain", 10, image_shape=s), (32, 32, 3)),
    "vgg13": (lambda: jax_model("vgg13", 10), lambda s: get_model("vgg13", 10, image_shape=s),
              (32, 32, 3)),
    "densenet_bc10": (lambda: jax_densenet.DenseNet(growth_rate=4, depth=10),
                      lambda s: DenseNet(growth_rate=4, depth=10, image_shape=s), (16, 16, 3)),
    "densenet_bc16": (lambda: jax_densenet.DenseNet(growth_rate=4, depth=16),
                      lambda s: DenseNet(growth_rate=4, depth=16, image_shape=s), (16, 16, 3)),
    "densenet_10": (lambda: jax_densenet.DenseNet(growth_rate=4, depth=10, bottleneck=False),
                    lambda s: DenseNet(growth_rate=4, depth=10, bottleneck=False,
                                       image_shape=s), (16, 16, 3)),
    "alexnet": (lambda: jax_model("alexnet", 10), lambda s: get_model("alexnet", 10,
                                                                      image_shape=s),
                (64, 64, 3)),
}
# the JAX models' counts (jax.eval_shape of their init): parameters, leaves
FULL_SIZE = {
    "vgg11": ((32, 32, 3), 9_756_426, 38),
    "vgg16": ((32, 32, 3), 15_253_578, 58),
    "densenet": ((32, 32, 3), 25_624_430, 569),
    "densenet100": ((32, 32, 3), 769_162, 299),
    "alexnet": ((224, 224, 3), 57_044_810, 16),
}


@functools.lru_cache(maxsize=None)
def _weights(case, seed=0):
    """(Flax model, NHWC input, perturbed params, perturbed batch_stats);
    one init per case, shared by its tests (none changes them)."""
    jbuild, _, shape = CASES[case]
    model = jbuild()
    x = np.random.default_rng(seed).standard_normal((2,) + shape).astype(np.float32)
    variables = model.init({"params": jax.random.PRNGKey(seed),
                            "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables.get("batch_stats", {}))
    stats = {k: _perturb_stats(v, rng) for k, v in stats.items()} if stats else {}
    return model, x, params, stats


def _port(case, params, stats):
    _, build, shape = CASES[case]
    model = build(shape)
    model.load_state_dict(state_dict_from_jax(model, params, stats or None))
    return model


@pytest.mark.parametrize("case", list(CASES))
def test_eval_logits_match_flax(case):
    fmodel, x, params, stats = _weights(case)
    model = _port(case, params, stats)
    want = np.asarray(fmodel.apply(_variables(params, stats), jnp.asarray(x), train=False))
    model.eval()
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_train_logits_and_bn_stats_match_flax(case):
    """Train mode: batch statistics, the running statistics they update,
    and dropout with Flax's own keep-masks."""
    fmodel, x, params, stats = _weights(case)
    model = _port(case, params, stats)
    variables = _variables(params, stats)
    key = jax.random.PRNGKey(2)
    masks = J.flax_dropout_masks(fmodel, variables, x, key)
    assert len(masks) == (0 if case.startswith("densenet") else 2)
    want, mutated = fmodel.apply(variables, jnp.asarray(x), train=True,
                                 rngs={"dropout": key},
                                 mutable=["batch_stats"] if stats else [])
    model.train()
    with torch.no_grad(), dropout_stream(masks=[torch.from_numpy(m) for m in masks]) as s:
        got = model(_nchw(x)).numpy()
    assert s.calls == len(masks)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if stats:
        _, new_stats = jax_from_state_dict(model)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
            new_stats, jax.tree_util.tree_map(np.asarray, dict(mutated["batch_stats"])))


@pytest.mark.parametrize("case", list(CASES))
def test_convert_round_trip_is_exact(case):
    _, _, params, stats = _weights(case)
    model = _port(case, params, stats)
    p2, s2 = jax_from_state_dict(model)
    for a_tree, b_tree in ((params, p2), (stats, s2)):
        flat_a, tree_a = jax.tree_util.tree_flatten(a_tree)
        flat_b, tree_b = jax.tree_util.tree_flatten(b_tree)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("case", list(CASES))
def test_leaf_order_is_jax_flatten_order(case):
    """Including DenseNet-BC 16's 15 BatchNorms, whose names sort as
    strings (``BatchNorm_10`` before ``BatchNorm_2``)."""
    _, _, params, _ = _weights(case)
    _, build, shape = CASES[case]
    model = build(shape)
    order = jax_leaf_order(model)
    paths = [".".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    flax_names = {"scale": "weight", "bias": "bias", "kernel": "weight"}
    want = [p.rsplit(".", 1)[0] + "." + flax_names[p.rsplit(".", 1)[1]] for p in paths]
    assert order == want
    named = dict(model.named_parameters())
    assert [tuple(jax_view(named[n]).shape) for n in order] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(params)]
    assert all(jax_layouts(model))


def test_densenet_flat_names_sort_as_strings():
    model = DenseNet(growth_rate=4, depth=16, image_shape=(16, 16, 3))
    order = jax_leaf_order(model)
    bns = [n.split(".")[0] for n in order if n.startswith("BatchNorm_")][::2]
    assert bns[:4] == ["BatchNorm_0", "BatchNorm_1", "BatchNorm_10", "BatchNorm_11"]
    assert len(bns) == 15 and order[-2:] == ["Dense_0.bias", "Dense_0.weight"]


@pytest.mark.parametrize("name", list(FULL_SIZE))
def test_full_size_counts_match_jax(name):
    shape, n_params, n_leaves = FULL_SIZE[name]
    model = get_model(name, 10, image_shape=shape)
    assert sum(p.numel() for p in model.parameters()) == n_params
    assert len(jax_leaf_order(model)) == len(list(model.parameters())) == n_leaves


def test_alexnet_224_leaf_shapes_match_jax_eval_shape():
    jm = jax_model("alexnet", 10)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 224, 224, 3)), train=False))
    model = get_model("alexnet", 10, image_shape=(224, 224, 3))
    named = dict(model.named_parameters())
    assert [tuple(jax_view(named[n]).shape) for n in jax_leaf_order(model)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(shapes["params"])]
    assert max(p.numel() for p in model.parameters()) == 37_748_736


def test_alexnet_flatten_order_at_224():
    """At 224x224 the features are 6x6x256: the port flattens them in the
    Flax (NHWC) order, so the converted ``Dense_0`` gives Flax's product."""
    from atomo_tpu_torch.models.lenet import _flatten_nhwc

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 6, 6, 256)).astype(np.float32)
    kernel = (0.01 * rng.standard_normal((6 * 6 * 256, 8))).astype(np.float32)
    want = feats.reshape(2, -1) @ kernel
    lin = torch.nn.Linear(6 * 6 * 256, 8, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        got = lin(_flatten_nhwc(_nchw(feats))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_registry_is_jax_minus_embedding_family():
    assert model_names() == sorted(set(jax_model_names()) - {"embedding", "embedding_wide"})
    assert type(get_model("VGG11", 10, image_shape=(32, 32, 3))).__name__ == "VGG"
    assert get_model("VGG11", 10, image_shape=(32, 32, 3)).batch_norm
    assert not get_model("vgg11_plain", 10, image_shape=(32, 32, 3)).batch_norm


def test_alexnet_at_32_raises_in_both_packages():
    jm = jax_model("alexnet", 10)
    with pytest.raises(ValueError) as jexc:
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    with pytest.raises(ValueError) as pexc:
        get_model("AlexNet", 10, image_shape=(32, 32, 3))
    assert str(pexc.value) == str(jexc.value)


def test_vgg_conv_init_is_he_fan_out():
    """``variance_scaling(2, fan_out, truncated normal)`` for the convs,
    LeCun fan-in for the Dense layers, as the JAX VGG."""
    model = get_model("vgg11", 10, image_shape=(32, 32, 3))
    init_params(model, 0)
    conv = model.Conv_7.weight  # (512, 512, 3, 3): fan-out 512 * 9
    np.testing.assert_allclose(float(conv.std()), np.sqrt(2.0 / (512 * 9)), rtol=2e-2)
    assert float(conv.abs().max()) <= 2 * np.sqrt(2.0 / (512 * 9)) / 0.8796256 + 1e-7
    dense = model.Dense_1.weight  # (512, 512): fan-in 512
    np.testing.assert_allclose(float(dense.std()), np.sqrt(1.0 / 512), rtol=2e-2)


def test_flax_interceptor_leaves_dropout_unchanged():
    """The mask capture draws as Flax's own Dropout does: the output with
    the interceptor equals the output without it."""
    fmodel, x, params, stats = _weights("vgg11_plain")
    variables = _variables(params, stats)
    key = jax.random.PRNGKey(5)
    plain = np.asarray(fmodel.apply(variables, jnp.asarray(x), train=True,
                                    rngs={"dropout": key}))
    masks, out = J.flax_dropout_masks(fmodel, variables, x, key, return_output=True)
    np.testing.assert_array_equal(np.asarray(out), plain)
    assert [m.shape for m in masks] == [(2, 512), (2, 512)]
