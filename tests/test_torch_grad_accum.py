"""``grad_accum`` of the port's data-parallel step against the JAX package's.

With K microbatches (``atomo_tpu/parallel/replicated.py:1515-1569``) each
rank runs its rows of the global batch as K microbatches in order, carries
the BatchNorm statistics from one to the next, draws microbatch i's dropout
under ``fold_in(k_drop, i)``, sums the gradients from zero and divides by K,
and reports the microbatch means of loss and prec@1/5; one encode and one
exchange follow. The gloo N = 2 step (:mod:`torch_dist`) at K = 2, global
batch 8, against the JAX step at ``grad_accum=2`` on two CPU devices, with
the JAX step's codec draws and dropout keep-masks: LeNet (qsgd), a small
DenseNet-BC with BatchNorm (qsgd) and a reduced VGG with BatchNorm and
dropout (svd), at ``torch_dist_jax.assert_parity``'s tolerances. The rest
runs in a one-rank gloo group in this process: the indivisible batch's
error, the microbatch dropout keys, mixed precision's one cast a step, and
the single-device CLI's warning.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_jax as J
from torch_dist import Group

import atomo_tpu_torch.parallel.replicated as R
from atomo_tpu.parallel import make_distributed_train_step as jax_dist_step
from atomo_tpu.parallel import make_mesh, replicate_state, shard_batch
from atomo_tpu_torch import cli
from atomo_tpu_torch.convert import state_dict_from_jax
from atomo_tpu_torch.data import to_device
from atomo_tpu_torch.models import VGG
from atomo_tpu_torch.parallel import launch
from atomo_tpu_torch.training import make_optimizer
from atomo_tpu_torch.training.trainer import TrainState, leaf_params
from atomo_tpu_torch.utils.rng import fold_in, split3

STEPS, BATCH, K = 2, 8, 2
VGG_SMALL = ("VGG", {"cfg": (8, "M", 16, "M", 32, "M"), "batch_norm": True})
CASES = {
    "lenet-qsgd": ("lenet", "mnist", "qsgd"),
    "densenet_bc10-qsgd": (("DenseNet", {"growth_rate": 4, "depth": 10}), "cifar10", "qsgd"),
    "vgg_small-svd": (VGG_SMALL, "cifar10", "svd"),
}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    launch.initialize("cpu", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        yield
    finally:
        launch.shutdown()


@pytest.mark.parametrize("case", list(CASES))
def test_grad_accum_steps_match_jax(group, case):
    network, dataset, code = CASES[case]
    ref = J.Reference(network, dataset, BATCH, STEPS)
    out, per_rank = ref.run_ranks(code, "gather", 2, grad_accum=K)
    if network == VGG_SMALL:  # two dropout layers a microbatch, K microbatches
        assert len(per_rank[0]["dropout_masks"][0]) == 2 * K
    answers = group.run("train", per_rank=per_rank, **ref.job(code, "gather", grad_accum=K))
    J.assert_parity(ref, out, answers, code)


def _vgg_small():
    model = VGG(VGG_SMALL[1]["cfg"], batch_norm=True, image_shape=(32, 32, 3))
    opt = make_optimizer("sgd", lr=J.LR, momentum=J.MOMENTUM)
    return model, opt, TrainState(0, model, opt.init(leaf_params(model)))


def _batch(n):
    rng = np.random.default_rng(0)
    return to_device(rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
                     rng.integers(0, 10, n), "cpu")


def test_indivisible_batch_raises_as_jax(world1):
    model, opt, state = _vgg_small()
    step = R.make_distributed_train_step(model, opt, None, grad_accum=K)
    with pytest.raises(ValueError, match="per-chip batch 3 not divisible by grad_accum=2"):
        step(state, 0, *_batch(3))
    jstep = jax_dist_step(J.jax_build(VGG_SMALL), J.jax_optimizer("sgd", lr=J.LR),
                          make_mesh(n_devices=1), None, grad_accum=K)
    ref = J.Reference(VGG_SMALL, "cifar10", 4, 1)
    with pytest.raises(ValueError, match="per-chip batch 3 not divisible by grad_accum=2"):
        jstep(replicate_state(make_mesh(n_devices=1), jax.device_get(ref.jstate)), ref.key,
              jnp.zeros((3, 32, 32, 3)), jnp.zeros((3,), jnp.int32))
    with pytest.raises(ValueError, match="grad_accum must be >= 1"):
        R.make_distributed_train_step(model, opt, None, grad_accum=0)


def test_microbatch_dropout_keys_differ(world1, monkeypatch):
    """Microbatch i draws under ``fold_in(k_drop, i)``, where ``k_drop`` is
    the rank's step key's second split; the two microbatches' masks differ."""
    keys, kept = [], []
    stream = R.dropout_stream

    def recording_stream(key=None, masks=None):
        keys.append(key)
        return stream(key, masks)

    monkeypatch.setattr(R, "dropout_stream", recording_stream)
    model, opt, state = _vgg_small()
    hook = model.Dropout_0.register_forward_hook(lambda m, i, o: kept.append(o != 0))
    step = R.make_distributed_train_step(model, opt, None, grad_accum=K)
    step(state, 5, *_batch(4))
    hook.remove()
    k_drop = split3(fold_in(fold_in(5, 0), 0))[1]
    assert keys == [fold_in(k_drop, 0), fold_in(k_drop, 1)]
    assert len(kept) == K and kept[0].shape == (2, 512)
    assert not torch.equal(kept[0], kept[1])


def test_bf16_casts_parameters_once_a_step(world1, monkeypatch):
    """Under mixed precision the K microbatches run on one bfloat16 copy of
    the parameters, and the float32 masters take the mean of their
    gradients; the loss is the JAX ``grad_accum`` step's within 1e-2
    relative (``tests/test_torch_bf16.py``)."""
    ref = J.Reference("lenet", "mnist", 4, 1)
    seen = []
    call = R.functional_call

    def recording_call(module, params, args, kwargs=None):
        seen.append((id(params), {p.dtype for p in params.values()}))
        return call(module, params, args, kwargs)

    monkeypatch.setattr(R, "functional_call", recording_call)
    model = J.build_model("lenet", 10, ref.image_shape)
    model.load_state_dict(state_dict_from_jax(model, jax.device_get(ref.jstate.params)))
    opt = make_optimizer("sgd", lr=J.LR, momentum=J.MOMENTUM)
    state = TrainState(0, model, opt.init(leaf_params(model)))
    step = R.make_distributed_train_step(model, opt, None, grad_accum=K,
                                         compute_dtype=torch.bfloat16)
    x, y = ref.batches[0]
    state, m = step(state, 3, *to_device(x, y, "cpu"))
    assert len(seen) == K and len({s[0] for s in seen}) == 1
    assert seen[0][1] == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    mesh = make_mesh(n_devices=1)
    jstep = jax_dist_step(ref.jmodel, ref.jopt, mesh, None, grad_accum=K,
                          compute_dtype=jnp.bfloat16)
    _, jm = jstep(replicate_state(mesh, jax.device_get(ref.jstate)), ref.key,
                  *shard_batch(mesh, jnp.asarray(x), jnp.asarray(y)))[:2]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-2)


def test_single_device_cli_warns_and_ignores_grad_accum():
    lines = []
    argv = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
            "--batch-size", "8", "--max-steps", "1", "--log-interval", "1", "--eval-freq", "0",
            "--device", "cpu", "--train-dir", "", "--grad-accum", "3"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert cli.main(argv, log_fn=lines.append) == 0
    assert any("--grad-accum is only wired into the multi-device step" in str(w.message)
               for w in caught)
    assert [ln.split(",")[1] for ln in lines if ln.startswith("Worker:")] == [" Step: 1"]
