"""The port's embedding tower (``models/embedding.py``) against the JAX package.

Weights of a Flax init are carried across by ``atomo_tpu_torch.convert``
(the top-level ``table`` untransposed), the inputs are the same zipf ids.
Tolerances: logits atol 1e-6 and gradients atol 1e-6 (float32 products and
the table's scatter-add, whose duplicate rows XLA and torch sum in other
orders); the single-device steps as ``tests/test_torch_trainer.py`` holds
LeNet (loss rtol 1e-5, ``msg_bytes`` exact, params atol 1e-5 plus one
quantization step times lr a step for qsgd), against the JAX step run in
float64, where the f32 scatter order differs; ``--bf16`` logits within 2e-2.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atomo_tpu_torch.training.trainer as port_trainer
from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.models import EmbeddingTower as JaxTower
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu.training.trainer import cast_compute_inputs, create_state, cross_entropy_loss
from atomo_tpu.training.trainer import make_train_step as jax_train_step
from atomo_tpu_torch.codecs import QsgdCodec
from atomo_tpu_torch.convert import (
    jax_from_state_dict,
    jax_layouts,
    jax_leaf_order,
    jax_leaf_paths,
    jax_view,
    state_dict_from_jax,
)
from atomo_tpu_torch.data import BatchIterator, to_device, zipf_dataset
from atomo_tpu_torch.models import EmbeddingTower, get_model
from atomo_tpu_torch.training import create_state as port_create_state
from atomo_tpu_torch.training import make_optimizer, make_train_step
from atomo_tpu_torch.training.trainer import TrainState, forward, init_params, leaf_params

LR, MOMENTUM, BITS = 0.05, 0.9, 4
NETS = {"embedding": dict(rows=4096, dim=16), "embedding_wide": dict(rows=65536, dim=32)}


@contextlib.contextmanager
def _x64(on):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(on))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _pair(name, ids):
    """(Flax model, its params at PRNGKey(0), the port model on them)."""
    jm = jax_model(name, 10)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    pm = get_model(name, 10, image_shape=(ids.shape[1],))
    pm.load_state_dict(state_dict_from_jax(pm, params))
    return jm, params, pm


def _ids(rows, n=16, seed=1):
    return zipf_dataset(True, rows=rows, size=n, seed=seed)


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_and_gradient_match_jax(name):
    ds = _ids(NETS[name]["rows"])
    jm, params, pm = _pair(name, ds.images)

    def loss_fn(p):
        return cross_entropy_loss(jm.apply({"params": p}, jnp.asarray(ds.images)),
                                  jnp.asarray(ds.labels))

    jlogits = np.asarray(jm.apply({"params": params}, jnp.asarray(ds.images)))
    jgrads = jax.tree_util.tree_leaves(jax.grad(loss_fn)(params))
    x, y = to_device(ds.images, ds.labels, "cpu")
    logits = pm(x)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=1e-6)
    grads = torch.autograd.grad(torch.nn.functional.cross_entropy(logits, y), leaf_params(pm))
    for g, jg, tr in zip(grads, jgrads, jax_layouts(pm)):
        np.testing.assert_allclose(jax_view(g, tr).numpy(), np.asarray(jg), atol=1e-6)
    table = grads[-1]
    touched = np.unique(ds.images.astype(np.int64))
    assert set(np.flatnonzero(table.abs().sum(1).numpy())) <= set(touched)


@pytest.mark.parametrize("name", sorted(NETS))
def test_leaf_order_paths_and_round_trip(name):
    ds = _ids(NETS[name]["rows"], n=4)
    _, params, pm = _pair(name, ds.images)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    assert jax_leaf_paths(pm) == [jax.tree_util.keystr(p) for p, _ in flat]
    assert jax_leaf_order(pm) == ["Dense_0.bias", "Dense_0.weight", "Dense_1.bias",
                                  "Dense_1.weight", "table"]
    assert jax_layouts(pm) == [True, True, True, True, False]  # the table lies alike
    back, stats = jax_from_state_dict(pm)
    assert stats == {}
    for (_, a), b in zip(flat, jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert tuple(pm.table.shape) == (NETS[name]["rows"], NETS[name]["dim"])


def test_rows_above_2_24_raise_with_the_jax_message():
    with pytest.raises(ValueError, match="exceeds 2\\^24: the float32 data pipeline"):
        EmbeddingTower(rows=(1 << 24) + 1)
    with pytest.raises(ValueError, match="exceeds 2\\^24: the float32 data pipeline"):
        JaxTower(rows=(1 << 24) + 1).init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    EmbeddingTower(rows=1 << 24, dim=1)  # the CLI's largest table is accepted


def test_init_params_draws_the_table_from_normal_002():
    """Flax's ``normal(0.02)`` for the table (not ``nn.Embed``'s 1/features
    variance), LeCun-normal kernels and zero biases for the tower."""
    m = EmbeddingTower(rows=8192, dim=16)
    init_params(m, 0)
    table = m.table.detach()
    assert abs(float(table.std()) - 0.02) < 0.0005
    assert abs(float(table.mean())) < 0.001
    assert float(m.Dense_0.bias.detach().abs().max()) == 0.0
    assert abs(float(m.Dense_0.weight.detach().std()) - (1 / 128) ** 0.5) < 0.01


@pytest.mark.parametrize("code", ["sgd", "qsgd"])
def test_single_device_steps_match_jax(code, monkeypatch):
    """Three steps of ``make_train_step`` against the JAX step in float64
    (x64 on for this test), on the same zipf batches; the qsgd codec fed the
    JAX step's uniforms (``split(fold_in(key, step), 3)[2]`` folded with the
    leaf index)."""
    ds = zipf_dataset(True, size=96, seed=2)
    it = BatchIterator(ds, 32, seed=2).forever()
    batches = [next(it) for _ in range(3)]
    jm, params, pm = _pair("embedding", batches[0][0])
    opt = make_optimizer("sgd", lr=LR, momentum=MOMENTUM)
    state = TrainState(step=0, model=pm, opt_state=opt.init(leaf_params(pm)))
    scales = [0.0]  # the largest quantization scale the port's encode took
    encode = port_trainer.encode_tree

    def recording_encode(*args, **kw):
        payloads, stats = encode(*args, **kw)
        scales.extend(float(p.scales.max()) for p in payloads)
        return payloads, stats

    monkeypatch.setattr(port_trainer, "encode_tree", recording_encode)
    pstep = make_train_step(pm, opt, codec=QsgdCodec(bits=BITS) if code == "qsgd" else None)
    key = jax.random.PRNGKey(7)
    with _x64(True):
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jopt = jax_optimizer("sgd", lr=LR, momentum=MOMENTUM)
        jstate = create_state(jm, jopt, jax.random.PRNGKey(0), jnp.asarray(batches[0][0]))
        jstate = jstate.replace(params=f64, opt_state=jopt.init(f64))
        jstep = jax_train_step(jm, jopt, codec=JaxQsgd(bits=BITS) if code == "qsgd" else None)
        for s, (x, y) in enumerate(batches):
            uniforms = None
            if code == "qsgd":
                k_codec = jax.random.split(jax.random.fold_in(key, s), 3)[2]
                uniforms = [torch.from_numpy(np.array(jax.random.uniform(
                    jax.random.fold_in(k_codec, i), (-(-leaf.size // 512), 512))))
                    for i, leaf in enumerate(jax.tree_util.tree_leaves(jstate.params))]
            jstate, jmet = jstep(jstate, key, jnp.asarray(x, jnp.float64), jnp.asarray(y))
            state, pmet = pstep(state, 11, *to_device(x, y, "cpu"), uniforms=uniforms)
            np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=1e-5)
            assert int(pmet["msg_bytes"]) == int(jmet["msg_bytes"])
        jparams = jax.tree_util.tree_leaves(jax.device_get(jstate.params))
    got = jax.tree_util.tree_leaves(jax_from_state_dict(pm)[0])
    atol = 1e-5 + LR * max(scales) / ((1 << BITS) - 1) * len(batches)
    for a, b in zip(got, jparams):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def test_loss_falls_on_zipf():
    """The README recipe at a small size (the JAX package's
    ``test_embedding_model_fits_zipf``): the mean loss of the last 5 of 30
    steps below that of the first 5."""
    ds = zipf_dataset(True, size=1024, seed=0)
    model = get_model("embedding", 10, image_shape=(8,))
    opt = make_optimizer("sgd", lr=0.1, momentum=0.9)
    state = port_create_state(model, opt, 0, "cpu")
    step = make_train_step(model, opt, codec=QsgdCodec(bits=4))
    it = BatchIterator(ds, 32, seed=0).forever()
    losses = []
    for _ in range(30):
        state, m = step(state, 3, *to_device(*next(it), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_bf16_aliases_the_same_ids_in_both_packages():
    """A parity fact: ``--bf16`` casts the float32 ids to bfloat16 in both
    packages (``cast_compute_inputs``; the port's ``forward``), so ids above
    256 alias to their bfloat16 roundings, the same ones in each; an id that
    rounds up to the table's size (4095 -> 4096 here) looks up a row of NaN
    in both (``jnp.take``'s fill mode, which the port's lookup repeats)."""
    ids = np.array([[0, 255, 256, 257, 1000, 1001, 2049, 4000],
                    [1, 2, 3, 4, 5, 6, 7, 4095]], np.float32)
    jm, params, pm = _pair("embedding", ids)
    port_alias = torch.from_numpy(ids).to(torch.bfloat16).to(torch.int64).numpy()
    jax_alias = np.asarray(jnp.asarray(jnp.asarray(ids, jnp.bfloat16), jnp.int32))
    np.testing.assert_array_equal(port_alias, jax_alias)
    assert (port_alias != ids).sum() == 4  # 257, 1001, 2049 and 4095
    assert port_alias[1, 7] == 4096
    x = torch.from_numpy(ids)
    with torch.no_grad():
        a = forward(pm, x, torch.bfloat16)
        b = forward(pm, torch.from_numpy(port_alias.astype(np.float32)), torch.bfloat16)
    np.testing.assert_array_equal(a.numpy(), b.numpy())  # the model looked the aliases up
    assert np.isfinite(a[0].numpy()).all() and np.isnan(a[1].numpy()).all()
    jp, jx = cast_compute_inputs(params, jnp.asarray(ids), jnp.bfloat16)
    want = np.asarray(jm.apply({"params": jp}, jx).astype(jnp.float32))
    assert np.isnan(want[1]).all()
    np.testing.assert_allclose(a.numpy(), want, atol=2e-2)
