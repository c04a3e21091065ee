"""The slice as a whole: train steps of the port against the JAX trainer.

Both start from the same weights (a Flax init carried over by
``atomo_tpu_torch.convert``), take the same batches (the same numpy
``BatchIterator`` shuffle) with augmentation off, and run momentum SGD. With
``qsgd`` the port's codec is fed the uniforms the JAX step draws
(``split(fold_in(key, step), 3)[2]`` folded with the leaf index). Tolerances:

* loss rtol 1e-5 and, with ``sgd``, params atol 1e-5 (float32 convolutions
  summed in other orders);
* ``qsgd``: scales of the first step rtol 1e-5 (plus atol 1e-5 of the
  leaf's largest scale: a small bucket inherits the gradient difference of
  its whole leaf); words identical on >= 99.9 % of fields over the first two
  steps (a field may move one level where a float-level gradient difference
  crosses its uniform); params within one quantization step times lr per
  step taken. Words are not compared from the third step on: it starts from
  states apart by the moved fields of two steps, and ResNet-18 at batch 8
  amplifies those (measured: 2e-6 of the fields moved in step one, 1.4e-5 in
  step two, 1e-2 in step three, with its scales 3e-3 apart);
* ``msg_bytes`` exactly equal.

The port always runs in float32. LeNet is held against the JAX step in
float32. ResNet-18 (32x32 inputs, batch 8) is held against the JAX step run
in float64 (x64 on for that test only): there the JAX package's own float32
gradient is up to 5e-2 (of a leaf's largest entry) from its float64
gradient, since XLA's CPU reductions lose the one-pass BatchNorm variance to
cancellation, while the port's float32 gradient is within 3e-6 of it; a
float32 comparison would measure XLA's rounding, not the port. At 8x8 or
16x16 inputs the last stage's BatchNorm sees so few values per channel that
float32 itself is ill-conditioned (see tests/test_torch_models.py). Under x64
the JAX codec draws float64 uniforms; the port's torch quantizer compares
given uniforms in their own type, so both round alike.

This file runs the ``sgd`` cases; ``test_torch_trainer_qsgd.py`` runs this
test with ``qsgd`` (a file of its own, so that the two balance over test
workers).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atomo_tpu_torch.training.trainer as port_trainer
from atomo_tpu.codecs import QsgdCodec as JaxQsgd, encode_tree as jax_encode_tree
from atomo_tpu.data import SPECS as JAX_SPECS
from atomo_tpu.data import synthetic_dataset as jax_synthetic
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu.training.trainer import create_state, cross_entropy_loss
from atomo_tpu.training.trainer import make_train_step as jax_train_step
from atomo_tpu_torch.codecs import QsgdCodec
from atomo_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import make_optimizer
from atomo_tpu_torch.training.trainer import TrainState, leaf_params

LR, MOMENTUM, SEED, BITS, STEPS, BATCH = 0.001, 0.9, 3, 4, 3, 8
WORD_STEPS = 2  # steps whose words are compared field by field
# (network, dataset, JAX reference in float64)
CASES = [("lenet", "mnist", False), ("resnet18", "cifar10", True)]


@contextlib.contextmanager
def _jax_x64(on):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(on))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, tree)


def _batches(dataset):
    """The same synthetic batches for both packages (numpy, NHWC)."""
    ds = synthetic_dataset(SPECS[dataset], True, size=64, seed=SEED)
    jds = jax_synthetic(JAX_SPECS[dataset], True, size=64, seed=SEED)
    np.testing.assert_array_equal(ds.images, jds.images)  # the same numpy draws
    it = BatchIterator(ds, BATCH, seed=SEED).forever()
    return [next(it) for _ in range(STEPS)]


def _jax_uniforms(key, step, params, bucket):
    """The uniforms the JAX codec draws for each leaf of this step, in the
    type it draws them (float64 under x64)."""
    k_codec = jax.random.split(jax.random.fold_in(key, step), 3)[2]
    out = []
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        nb = -(-leaf.size // bucket)
        u = jax.random.uniform(jax.random.fold_in(k_codec, i), (nb, bucket))
        out.append(torch.from_numpy(np.array(u)))
    return out, k_codec


def _jax_grad_fn(model, has_bn: bool):
    """The JAX gradient of a train-mode step as one jitted function of
    (params, batch_stats, images, labels), compiled once a run (a closure
    over each step's state would be traced and compiled at every step)."""

    def loss_fn(params, batch_stats, images, labels):
        variables = {"params": params}
        if has_bn:
            variables["batch_stats"] = batch_stats
        logits, _ = model.apply(
            variables, images, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"] if has_bn else [],
        )
        return cross_entropy_loss(logits, labels)

    return jax.jit(jax.grad(loss_fn))


def _fields(words):
    return (words[..., None] >> (np.arange(32 // (BITS + 1)) * (BITS + 1))) & 31


_STARTS: dict = {}


def _start(name, dataset, x64):
    """(batches, Flax model, JAX state, the port's state_dict) of a case,
    made once for both codecs (the Flax init of ResNet-18 runs op by op)."""
    if (name, dataset, x64) not in _STARTS:
        batches = _batches(dataset)
        jmodel = jax_model(name, 10)
        jopt = jax_optimizer("sgd", lr=LR, momentum=MOMENTUM)
        # one compiled init: op by op, ResNet-18's Flax init compiles each of
        # its operations; for LeNet and ResNet-18 the compiled init draws the
        # op-by-op parameters bit for bit (a VGG's He-scaled one would not)
        jstate = jax.jit(functools.partial(create_state, jmodel, jopt))(
            jax.random.PRNGKey(0), jnp.asarray(batches[0][0]))
        # the port starts from the float32 init either way
        sd = state_dict_from_jax(get_model(name, 10, image_shape=JAX_SPECS[dataset].image_shape),
                                 jax.device_get(jstate.params),
                                 jax.device_get(jstate.batch_stats))
        _STARTS[name, dataset, x64] = (batches, jmodel, jax.device_get(jstate), sd)
    return _STARTS[name, dataset, x64]


@pytest.mark.parametrize("code", ["sgd"])
@pytest.mark.parametrize("name,dataset,x64", CASES)
def test_train_steps_match_jax(name, dataset, x64, code, monkeypatch):
    image_shape = JAX_SPECS[dataset].image_shape
    with _jax_x64(x64):
        batches, jmodel, jstate, sd = _start(name, dataset, x64)
        jopt = jax_optimizer("sgd", lr=LR, momentum=MOMENTUM)
        jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
        model = get_model(name, 10, image_shape=image_shape)
        model.load_state_dict(sd)
        if x64:
            jstate = _f64(jstate)
        jcodec = JaxQsgd(bits=BITS) if code == "qsgd" else None
        jstep = jax_train_step(jmodel, jopt, codec=jcodec)
        key = jax.random.PRNGKey(SEED + 1)

        opt = make_optimizer("sgd", lr=LR, momentum=MOMENTUM)
        state = TrainState(step=0, model=model, opt_state=opt.init(leaf_params(model)))
        codec = QsgdCodec(bits=BITS) if code == "qsgd" else None
        pstep = port_trainer.make_train_step(model, opt, codec=codec)
        recorded = []
        port_encode = port_trainer.encode_tree

        def recording_encode(*args, **kw):
            payloads, stats = port_encode(*args, **kw)
            recorded.append(payloads)
            return payloads, stats

        monkeypatch.setattr(port_trainer, "encode_tree", recording_encode)

        fields = same = 0
        max_step = 0.0
        jgrad = _jax_grad_fn(jmodel, bool(jax.tree_util.tree_leaves(jstate.batch_stats)))
        # one compiled encode (op by op, each step's leaves compile hundreds
        # of small programs)
        jencode = jax.jit(lambda k, g: jax_encode_tree(jcodec, k, g)[0])
        for s, (x, y) in enumerate(batches):
            uniforms = None
            jx = jnp.asarray(x, jnp.float64 if x64 else jnp.float32)
            if code == "qsgd":
                uniforms, k_codec = _jax_uniforms(key, s, jstate.params, 512)
                jgrads = jgrad(jstate.params, jstate.batch_stats, jx, jnp.asarray(y))
                jpay = jencode(k_codec, jgrads)
                jpay = jax.tree_util.tree_leaves(jpay, is_leaf=lambda p: hasattr(p, "words"))
            jstate, jm = jstep(jstate, key, jx, jnp.asarray(y))
            state, pm = pstep(state, SEED + 1, *to_device(x, y, "cpu"), uniforms=uniforms)
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
            assert int(pm["msg_bytes"]) == int(jm["msg_bytes"])
            if code == "qsgd":
                assert len(recorded[-1]) == len(jpay)
                for pp, jp in zip(recorded[-1], jpay):
                    js = np.asarray(jp.scales)
                    if s == 0:  # later steps start from states apart by the flips
                        np.testing.assert_allclose(pp.scales.numpy(), js, rtol=1e-5,
                                                   atol=1e-5 * float(js.max()))
                    if s < WORD_STEPS:
                        fa, fb = _fields(pp.words.numpy()), _fields(np.asarray(jp.words))
                        fields += fa.size
                        same += int((fa == fb).sum())
                    max_step = max(max_step, float(js.max()) / ((1 << BITS) - 1))
            if s in (0, STEPS - 1):
                jparams = jax.device_get(jstate.params)
                pparams, _ = jax_from_state_dict(model)
                atol = 1e-5 + (LR * max_step * (s + 1) if code == "qsgd" else 0.0)
                jax.tree_util.tree_map(
                    lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=atol),
                    pparams, jparams)
    if code == "qsgd":
        assert same / fields >= 0.999, (same, fields)
