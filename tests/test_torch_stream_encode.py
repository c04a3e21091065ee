"""The layer-bucket plan and the streamed encode against the JAX package.

``plan_layer_buckets`` over the port's leaves (``leaf_params``, the
canonical order) equals the JAX package's over the Flax parameter tree
(shapes from ``jax.eval_shape`` of the init), tuple for tuple, for LeNet,
ResNet-18, VGG-11, a DenseNet-BC (growth 4, depth 10) and the small
transformer, at bucket bytes 0, 1, 64 KiB and 4 MiB; on ResNet-18 at 4 MiB
its first bucket holds ``Dense_0`` with the stem (``Conv_0``,
``BatchNorm_0``), as sorted leaf names put them. ``encode_tree_streamed``
equals ``encode_tree`` bit for bit (every field of every payload) for qsgd,
terngrad, svd and per-leaf budget codecs (QSGD widths, SVD ranks) at bucket
bytes 0, 1 and 64 KiB, and, fed the JAX codec's draws, the JAX package's
``encode_tree_streamed``: QSGD words exactly and scales within rtol 1e-6
(``test_torch_qsgd``'s tolerance), SVD's decoded leaves within
``test_torch_svd``'s (rtol 1e-4, atol 1e-5 of the leaf's largest value). A
plan over another tree raises with the JAX package's words. The step's
readiness hooks, in one process over a gloo group of one: buckets are
issued in the order their last gradients arrive, most of them before
backward's last hook; svd's are only recorded there and encoded after
backward (the rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_jax as J
import torch_dist_lm_jax as LJ
from test_torch_svd import jax_draws

import atomo_tpu.models as jm
from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.codecs import base as jbase
from atomo_tpu.codecs.svd import SvdCodec as JaxSvd
from atomo_tpu.models.transformer import TransformerLM as FlaxLM
from atomo_tpu.parallel.common import plan_layer_buckets as jax_plan
from atomo_tpu_torch import budget as pb
from atomo_tpu_torch.codecs import (
    QsgdCodec,
    SvdCodec,
    decode_tree,
    encode_tree,
    encode_tree_streamed,
    terngrad,
)
from atomo_tpu_torch.convert import (
    jax_layouts,
    jax_leaf_paths,
    jax_view,
    state_dict_from_jax,
)
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.models.transformer import TransformerLM
from atomo_tpu_torch.parallel import launch
from atomo_tpu_torch.parallel.common import plan_layer_buckets
from atomo_tpu_torch.parallel.overlap import issued_under_backward
from atomo_tpu_torch.training import TrainState, make_optimizer
from atomo_tpu_torch.training.trainer import init_params, leaf_params
from torch_dist import build_model

SIZES = [0, 1, 64 << 10, 4 << 20]
DENSE_SMALL = ("DenseNet", {"growth_rate": 4, "depth": 10})


def _networks():
    """name -> (port model, the JAX parameter shapes)."""

    def flax(model, x):
        return jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x,
            train=False))["params"]

    mnist, cifar = jnp.zeros((1, 28, 28, 1)), jnp.zeros((1, 32, 32, 3))
    return {
        "lenet": (lambda: get_model("lenet", 10, (28, 28, 1)),
                  lambda: flax(jm.get_model("lenet", 10), mnist)),
        "resnet18": (lambda: get_model("resnet18", 10, (32, 32, 3)),
                     lambda: flax(jm.get_model("resnet18", 10), cifar)),
        "vgg11": (lambda: get_model("vgg11", 10, (32, 32, 3)),
                  lambda: flax(jm.get_model("vgg11", 10), cifar)),
        "densenet_bc10": (lambda: build_model(DENSE_SMALL, 10, (32, 32, 3)),
                          lambda: flax(jm.DenseNet(num_classes=10, **DENSE_SMALL[1]), cifar)),
        "transformer": (lambda: TransformerLM(**LJ.CFG),
                        lambda: jax.eval_shape(lambda: FlaxLM(**LJ.CFG).init(
                            {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, LJ.CFG["max_len"]), jnp.int32)))["params"]),
    }


NETWORKS = _networks()


@pytest.mark.parametrize("bucket_bytes", SIZES, ids=["one", "leaf", "64KiB", "4MiB"])
@pytest.mark.parametrize("name", list(NETWORKS))
def test_plan_equals_the_jax_plan(name, bucket_bytes):
    port, flax = NETWORKS[name]
    got = plan_layer_buckets(leaf_params(port()), bucket_bytes)
    want = jax_plan(flax(), bucket_bytes)
    assert got.n_leaves == want.n_leaves
    assert got.buckets == want.buckets
    assert sorted(i for b in got.buckets for i in b) == list(range(got.n_leaves))


def test_resnet18_first_bucket_is_the_head_with_the_stem():
    model = get_model("resnet18", 10, (32, 32, 3))
    plan = plan_layer_buckets(leaf_params(model), 4 << 20)
    assert (plan.n_leaves, plan.n_buckets) == (62, 10)
    names = jax_leaf_paths(model)
    first = {names[i].split("'")[1] for i in plan.buckets[0]}
    assert first == {"Dense_0", "Conv_0", "BatchNorm_0"}


def _lenet_grads(seed: int = 0):
    """A LeNet-shaped gradient: the JAX tree and the port's leaves."""
    model = get_model("lenet", 10, (28, 28, 1))
    shapes = NETWORKS["lenet"][1]()
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = state_dict_from_jax(model, tree, {})
    named = dict(model.named_parameters())
    inv = {id(p): n for n, p in named.items()}
    return model, tree, [sd[inv[id(p)]] for p in leaf_params(model)]


def _codecs(n_leaves: int):
    widths = [(3 * i) % 16 + 1 for i in range(n_leaves)]
    ranks = [i % 4 + 1 for i in range(n_leaves)]
    return {
        "qsgd": QsgdCodec(bits=4),
        "terngrad": terngrad(),
        "svd": SvdCodec(rank=3),
        "qsgd_widths": pb.budgeted_codec(QsgdCodec(bits=4), widths),
        "svd_ranks": pb.budgeted_codec(SvdCodec(rank=3), ranks),
    }


@pytest.mark.parametrize("code", ["qsgd", "terngrad", "svd", "qsgd_widths", "svd_ranks"])
def test_streamed_encode_equals_the_monolithic_encode(code):
    model, _, grads = _lenet_grads()
    codec = _codecs(len(grads))[code]
    layouts = jax_layouts(model)
    want, wstats = encode_tree(codec, 17, grads, None, layouts)
    for bucket_bytes in SIZES[:3]:
        plan = plan_layer_buckets(grads, bucket_bytes)
        got, gstats = encode_tree_streamed(codec, 17, grads, plan, None, layouts)
        assert gstats == wstats
        for g, w in zip(got, want):
            assert type(g) is type(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("code", ["qsgd", "svd"])
def test_streamed_encode_equals_the_jax_streamed_encode(code):
    model, tree, grads = _lenet_grads(1)
    key = jax.random.PRNGKey(5)
    leaves = jax.tree_util.tree_leaves(tree)
    if code == "qsgd":
        jcodec, codec = JaxQsgd(bits=4), QsgdCodec(bits=4)
        draws = [torch.from_numpy(d.copy()) for d in J.qsgd_draws(key, tree)]
    else:
        jcodec, codec = JaxSvd(rank=3), SvdCodec(rank=3)
        draws = [{k: torch.from_numpy(np.asarray(v)) for k, v in jax_draws(
            codec, jax.random.fold_in(key, i), leaf.shape).items()}
            for i, leaf in enumerate(leaves)]
    for bucket_bytes in (1, 64 << 10):
        jplan = jax_plan(tree, bucket_bytes)
        jpay, jstats = jbase.encode_tree_streamed(jcodec, key, tree, jplan)
        plan = plan_layer_buckets(grads, bucket_bytes)
        got, stats = encode_tree_streamed(codec, 0, grads, plan, draws, jax_layouts(model))
        assert plan.buckets == jplan.buckets
        assert stats.payload_bytes == jstats.payload_bytes
        if code == "qsgd":
            for g, w in zip(got, jax.tree_util.tree_leaves(
                    jpay, is_leaf=lambda x: hasattr(x, "words"))):
                np.testing.assert_array_equal(g.words.numpy(), np.asarray(w.words))
                np.testing.assert_allclose(g.scales.numpy(), np.asarray(w.scales), rtol=1e-6)
            continue
        back = jax.tree_util.tree_leaves(jbase.decode_tree(jcodec, jpay, tree))
        mine = decode_tree(codec, got, grads, jax_layouts(model))
        assert len(mine) == len(back)
        for got_leaf, want, tr in zip(mine, back, jax_layouts(model)):
            x = np.asarray(want)
            np.testing.assert_allclose(jax_view(got_leaf, tr).numpy().reshape(x.shape), x,
                                       rtol=1e-4, atol=1e-5 * float(np.abs(x).max()))


def test_streamed_encode_refuses_a_plan_of_another_tree():
    _, tree, grads = _lenet_grads()
    plan = plan_layer_buckets(grads[:-1], 0)
    with pytest.raises(ValueError) as port:
        encode_tree_streamed(QsgdCodec(bits=4), 0, grads, plan)
    with pytest.raises(ValueError) as want:
        jbase.encode_tree_streamed(JaxQsgd(bits=4), jax.random.PRNGKey(0), tree,
                                   jax_plan(jax.tree_util.tree_leaves(tree)[:-1], 0))
    assert str(port.value) == str(want.value)


@pytest.fixture(scope="module")
def group_of_one(tmp_path_factory):
    """A gloo group of this process alone, with one intra-op thread for
    the file's CPU steps (the suite's workers share the machine's cores,
    and oversubscribed thread pools thrash)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    launch.initialize("cpu", init_method=f"file://{tmp_path_factory.mktemp('g1')}/store",
                      world_size=1, rank=0)
    try:
        yield
    finally:
        launch.shutdown()
        torch.set_num_threads(threads)


def _one_step(network, image_shape, codec, bucket_bytes):
    import atomo_tpu_torch.parallel.replicated as R

    torch.manual_seed(0)
    model = get_model(network, 10, image_shape)
    init_params(model, 0)
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    state = TrainState(0, model, opt.init(leaf_params(model)))
    step = R.make_distributed_train_step(model, opt, codec, stream_encode=True,
                                         stream_bucket_bytes=bucket_bytes)
    rng = np.random.default_rng(0)
    h, w, c = image_shape
    x = torch.from_numpy(rng.standard_normal((2, c, h, w)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 2))
    step(state, 3, x, y)
    return step


def test_buckets_are_issued_as_their_gradients_arrive(group_of_one):
    step = _one_step("resnet18", (32, 32, 3), QsgdCodec(bits=4), 4 << 20)
    log = step.stream_log
    ready = [b for ev, b in log if ev == "ready"]
    assert sorted(ready) == list(range(step.plan.n_buckets))
    # every bucket is issued at its readiness hook, in that order
    assert [b for ev, b in log if ev == "issue"] == ready
    assert all(log[k + 1] == ("issue", b) for k, (ev, b) in enumerate(log) if ev == "ready")
    # plan bucket 0 (the head with the stem) is complete only when backward
    # ends; the other nine are issued before backward's last hook
    assert ready[-1] == 0
    assert issued_under_backward(log) == step.plan.n_buckets - 1


def test_svd_buckets_are_encoded_after_backward_in_ready_order(group_of_one):
    step = _one_step("lenet", (28, 28, 1), SvdCodec(rank=3), 1)
    log = step.stream_log
    ready = [b for ev, b in log if ev == "ready"]
    assert [ev for ev, _ in log] == ["ready"] * len(ready) + ["issue"] * len(ready)
    assert [b for ev, b in log if ev == "issue"] == ready
    assert issued_under_backward(log) == 0
