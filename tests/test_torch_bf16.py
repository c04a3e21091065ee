"""Mixed precision (``--bf16``) of the port against the JAX package's.

One train step with ``compute_dtype=torch.bfloat16`` against the JAX step
with ``compute_dtype=jnp.bfloat16``, both on the CPU, from the same Flax
init and the same batch: LeNet (MNIST shapes, batch 16) and ResNet-18
(CIFAR-10 shapes, batch 8). Both cast every floating parameter and the
images to bfloat16 for forward and backward and keep master parameters,
optimizer state, gradients, loss and BatchNorm statistics in float32.

Tolerances. The loss within 1e-2 relative. bfloat16 keeps 8 bits of
mantissa, so the gradient is held against the float64 gradient of the same
step (the port run in float64) as well as against the JAX one: per leaf,
its cosine with the float64 gradient at most 0.05 below the JAX package's
bfloat16 gradient's; and its cosine with the JAX gradient at least 0.99 per
leaf for LeNet. Through ResNet-18's twenty BatchNorm layers bfloat16 itself
drifts: the JAX package's own gradient is at cosine 0.926 from the float64
one on its worst leaf (a BatchNorm scale) and 0.961 over the whole tree, the
port's at 0.912 and 0.953 (XLA may keep elementwise chains in float32 where
the port rounds after each op), and the two at 0.898 on the worst leaf. So
for ResNet-18 the per-leaf bar against the JAX gradient is 0.85 and the
whole tree's 0.93. The BatchNorm running statistics within 1e-2 relative
plus 1e-2 of the leaf's largest entry (2.5 bfloat16 ulps: a running mean
near 0 inherits the rounding of activations at the leaf's scale). The parameters after the step are
apart by lr times the gradients' difference, within 1e-6: the float32
update of float32 masters. The port's tensors that stay float32 are checked
to be float32, and its BatchNorm is held to float32 statistics on a
bfloat16 input where a bfloat16 reduction would cancel (a per-leaf bar on
gradients would not see that on this data).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.data import SPECS as JAX_SPECS
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu.training.trainer import cast_compute_inputs, create_state, cross_entropy_loss
from atomo_tpu.training.trainer import make_train_step as jax_train_step
from atomo_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
from atomo_tpu_torch.models import BatchNorm, get_model
from atomo_tpu_torch.training import make_optimizer
from atomo_tpu_torch.training.trainer import TrainState, leaf_params, make_train_step

LR, MOMENTUM, SEED = 0.01, 0.9, 5


def _jax_grads(jmodel, jstate, x, y):
    """The JAX package's bfloat16 gradient (its loss function's casts)."""
    has_bn = bool(jax.tree_util.tree_leaves(jstate.batch_stats))

    def loss_fn(params):
        p, xi = cast_compute_inputs(params, x, jnp.bfloat16)
        variables = {"params": p}
        if has_bn:
            variables["batch_stats"] = jstate.batch_stats
        logits, _ = jmodel.apply(variables, xi, train=True, mutable=["batch_stats"] if has_bn
                                 else [], rngs={"dropout": jax.random.PRNGKey(0)})
        return cross_entropy_loss(logits.astype(jnp.float32), y)

    return jax.jit(jax.grad(loss_fn))(jstate.params)


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _port_grads_f64(name, image_shape, state_dict, x, y):
    """The float64 gradient of the same step, the port's model in float64."""
    model = get_model(name, 10, image_shape=image_shape)
    model.load_state_dict(state_dict)
    model = model.double().train()
    xi, yi = to_device(x, y, "cpu")
    torch.nn.functional.cross_entropy(model(xi.double()), yi).backward()
    grads, _ = jax_from_state_dict(model, {n: p.grad for n, p in model.named_parameters()}
                                   | dict(model.named_buffers()))
    return grads


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("name,dataset,batch,leaf_cos,tree_cos", [
    ("lenet", "mnist", 16, 0.99, 0.99), ("resnet18", "cifar10", 8, 0.85, 0.93)])
def test_bf16_step_matches_jax(name, dataset, batch, leaf_cos, tree_cos):
    ds = synthetic_dataset(SPECS[dataset], True, size=64, seed=SEED)
    x, y = next(BatchIterator(ds, batch, seed=SEED).forever())
    image_shape = JAX_SPECS[dataset].image_shape
    jmodel = jax_model(name, 10)
    jopt = jax_optimizer("sgd", lr=LR, momentum=MOMENTUM)
    jstate = create_state(jmodel, jopt, jax.random.PRNGKey(0), jnp.asarray(x))
    model = get_model(name, 10, image_shape=image_shape)
    sd = state_dict_from_jax(model, jax.device_get(jstate.params),
                             jax.device_get(jstate.batch_stats))
    model.load_state_dict(sd)
    g64 = _port_grads_f64(name, image_shape, sd, x, y)
    jgrads = jax.device_get(_jax_grads(jmodel, jstate, jnp.asarray(x), jnp.asarray(y)))
    jstep = jax_train_step(jmodel, jopt, compute_dtype=jnp.bfloat16)
    jstate, jm = jstep(jstate, jax.random.PRNGKey(SEED + 1), jnp.asarray(x), jnp.asarray(y))

    opt = make_optimizer("sgd", lr=LR, momentum=MOMENTUM)
    state = TrainState(step=0, model=model, opt_state=opt.init(leaf_params(model)))
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    state, pm = step(state, SEED + 1, *to_device(x, y, "cpu"))

    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-2)
    assert pm["loss"].dtype == torch.float32
    for p in model.parameters():  # master params, their gradients, the optimizer state
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in state.opt_state.trace)
    assert all(b.dtype == torch.float32 for b in model.buffers())  # BatchNorm statistics

    pgrads, _ = jax_from_state_dict(model, {n: p.grad for n, p in model.named_parameters()}
                                    | dict(model.named_buffers()))
    leaves = jax.tree_util.tree_leaves
    for (path, pg), jg, tg in zip(jax.tree_util.tree_leaves_with_path(pgrads), leaves(jgrads),
                                  leaves(g64)):
        where = jax.tree_util.keystr(path)
        assert _cosine(pg, jg) >= leaf_cos, (where, _cosine(pg, jg))
        assert _cosine(pg, tg) >= _cosine(jg, tg) - 0.05, (where, _cosine(pg, tg),
                                                           _cosine(jg, tg))
    assert _cosine(_flat(pgrads), _flat(jgrads)) >= tree_cos

    # the float32 update of the float32 masters: the parameters differ by lr
    # times the gradients' difference, to float32 rounding
    pparams, pstats = jax_from_state_dict(model)
    for pp, jp, pg, jg in zip(jax.tree_util.tree_leaves(pparams),
                              jax.tree_util.tree_leaves(jax.device_get(jstate.params)),
                              jax.tree_util.tree_leaves(pgrads),
                              jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(pp - jp, -LR * (pg - jg), rtol=0, atol=1e-6)
    for ps, js in zip(jax.tree_util.tree_leaves(pstats),
                      jax.tree_util.tree_leaves(jax.device_get(jstate.batch_stats))):
        np.testing.assert_allclose(ps, js, rtol=1e-2, atol=1e-2 * np.abs(js).max())


def test_batchnorm_reduces_in_float32_under_bf16():
    """Channels with a mean far above their spread: a bfloat16 mean(x^2) -
    mean(x)^2 loses the variance to cancellation; the port's statistics are
    those of the float32 copy of the same bfloat16 input."""
    gen = torch.Generator().manual_seed(0)
    x = (100.0 + torch.randn((8, 3, 6, 6), generator=gen)).to(torch.bfloat16)
    bn = BatchNorm(3).train()
    y = bn(x)
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    xf = x.float()
    var = xf.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 + 0.1 * var).numpy(), rtol=1e-4)
    ref = (xf - xf.mean(dim=(0, 2, 3), keepdim=True)) / torch.sqrt(var + 1e-5).view(1, 3, 1, 1)
    np.testing.assert_allclose(y.detach().float().numpy(), ref.numpy(), atol=2e-2)


def test_bf16_gradients_reach_the_codec_in_float32(monkeypatch):
    """The codec encodes float32 gradients under bfloat16 compute, so the
    wire is the float32 run's: the same Msg bytes."""
    import atomo_tpu_torch.training.trainer as port_trainer
    from atomo_tpu_torch.codecs import QsgdCodec

    seen = []
    encode = port_trainer.encode_tree

    def recording(codec, key, grads, *a, **kw):
        seen.extend(g.dtype for g in grads)
        return encode(codec, key, grads, *a, **kw)

    monkeypatch.setattr(port_trainer, "encode_tree", recording)
    ds = synthetic_dataset(SPECS["mnist"], True, size=32, seed=SEED)
    x, y = next(BatchIterator(ds, 16, seed=SEED).forever())
    msg = {}
    for dtype in (None, torch.bfloat16):
        model = get_model("lenet", 10)
        opt = make_optimizer("sgd", lr=LR)
        state = TrainState(0, model, opt.init(leaf_params(model)))
        step = make_train_step(model, opt, codec=QsgdCodec(bits=4), compute_dtype=dtype)
        _, m = step(state, 1, *to_device(x, y, "cpu"))
        msg[dtype] = int(m["msg_bytes"])
    assert len(seen) == 16 and all(d == torch.float32 for d in seen)  # 8 leaves, 2 runs
    assert msg[None] == msg[torch.bfloat16]
