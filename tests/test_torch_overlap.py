"""``overlap='delayed'`` in one process (a gloo group of one) against its
oracle and the JAX package's refusals.

Bit for bit within the port (LeNet, synthetic batches of 8 drawn with numpy,
SGD with momentum 0.9):

* the fused delayed step equals the two-call oracle
  (``make_delayed_oracle_steps``: produce, then apply on the previous
  carry) over 4 steps, parameters and optimizer state, gather and ring;
* step 0 applies nothing: parameters, momentum and BatchNorm statistics
  (a DenseNet-BC, growth 4, depth 10) hold, the step counter moves and the
  carry turns valid;
* staleness: two delayed steps equal one blocking step on the first batch;
* the K = 3 block (the eager block on the CPU) equals three single steps;
* through ``distributed_train_loop``: a delayed run cut at step 2 and
  resumed equals the straight run; a delayed resume of a blocking
  checkpoint warns in the JAX package's words and skips its first step; a
  blocking resume of a delayed checkpoint restores the train state alone,
  with the JAX package's warning.

The step factory's and the loop's refusals carry the JAX package's
messages, and the graph rule sends stream-encode to the eager block and
lets a delayed QSGD step over NCCL through.
"""

import warnings

import numpy as np
import pytest
import torch

from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.parallel import distributed_train_loop as jax_loop
from atomo_tpu.parallel import make_distributed_train_step as jax_step
from atomo_tpu.parallel import make_mesh
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu_torch.codecs import QsgdCodec
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.parallel import launch
from atomo_tpu_torch.training import TrainState, distributed_train_loop, make_optimizer
from atomo_tpu_torch.training import graph as G
from atomo_tpu_torch.training.trainer import init_params, leaf_params
from torch_dist import build_model

import atomo_tpu_torch.parallel.replicated as R

CODEC = QsgdCodec(bits=4, bucket_size=128)


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


def _batches(n=4, shape=(8, 1, 28, 28)):
    r = np.random.default_rng(0)
    return [(torch.from_numpy(r.standard_normal(shape).astype(np.float32)),
             torch.from_numpy(r.integers(0, 10, shape[0]))) for _ in range(n)]


def _fresh(network="lenet", image_shape=(28, 28, 1)):
    model = (build_model(network, 10, image_shape) if isinstance(network, tuple)
             else get_model(network, 10, image_shape))
    init_params(model, 0)
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    return model, opt, TrainState(0, model, opt.init(leaf_params(model)))


def _tensors(state):
    return ([t.detach().clone() for t in list(state.model.parameters())
             + list(state.model.buffers())] + [t.clone() for t in state.opt_state.trace])


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_delayed_step_equals_the_two_call_oracle(group_of_one, aggregate):
    batches = _batches()
    model, opt, state = _fresh()
    step = R.make_distributed_train_step(model, opt, CODEC, aggregate=aggregate,
                                         overlap="delayed")
    state = R.init_delayed_state(state, CODEC)
    fused = []
    for x, y in batches:
        state, m = step(state, 1, x, y)
        fused.append(float(m["skipped"]))
    want = _tensors(state)

    model, opt, st = _fresh()
    oracle = R.make_delayed_oracle_steps(model, opt, CODEC, aggregate=aggregate)
    carry = R.init_delayed_state(st, CODEC).carry
    skipped = []
    for x, y in batches:
        new_carry, stats_x, _ = oracle["produce"](st, 1, x, y)
        st, am = oracle["apply"](st, carry, stats_x)
        carry = new_carry
        skipped.append(float(am["skipped"]))
    assert _equal(_tensors(st), want)
    assert fused == skipped == [1.0, 0.0, 0.0, 0.0]
    assert st.opt_state.count == state.opt_state.count == 3


def test_step0_holds_parameters_momentum_and_batchnorm(group_of_one):
    model, opt, state = _fresh(("DenseNet", {"growth_rate": 4, "depth": 10}), (32, 32, 3))
    before = _tensors(state)
    step = R.make_distributed_train_step(model, opt, CODEC, overlap="delayed")
    state = R.init_delayed_state(state, CODEC)
    x, y = _batches(1, (4, 3, 32, 32))[0]
    state, m = step(state, 1, x, y)
    assert float(m["skipped"]) == 1.0 and float(m["dropped"]) == 0.0
    assert _equal(_tensors(state), before)
    assert state.step == 1 and state.opt_state.count == 0 and state.carry.valid
    state, m = step(state, 1, x, y)
    assert float(m["skipped"]) == 0.0 and not _equal(_tensors(state), before)


def test_two_delayed_steps_equal_one_blocking_step(group_of_one):
    batches = _batches(2)
    model, opt, state = _fresh()
    step = R.make_distributed_train_step(model, opt, CODEC, overlap="delayed")
    state = R.init_delayed_state(state, CODEC)
    for x, y in batches:
        state, _ = step(state, 1, x, y)
    delayed = [p.detach().clone() for p in leaf_params(model)]
    model, opt, state = _fresh()
    blocking = R.make_distributed_train_step(model, opt, CODEC)
    blocking(state, 1, *batches[0])
    assert _equal([p.detach() for p in leaf_params(model)], delayed)


def test_delayed_block_of_three_equals_three_steps(group_of_one):
    batches = _batches(3)
    model, opt, state = _fresh()
    step = R.make_distributed_train_step(model, opt, CODEC, overlap="delayed")
    state = R.init_delayed_state(state, CODEC)
    losses = []
    for x, y in batches:
        state, m = step(state, 1, x, y)
        losses.append(float(m["loss"]))
    want = _tensors(state)
    model, opt, state = _fresh()
    block = R.make_distributed_train_step(model, opt, CODEC, overlap="delayed", superstep=3)
    assert block.mode == "eager" and "CUDA" in block.why
    state = R.init_delayed_state(state, CODEC)
    state, m = block(state, 1, torch.stack([b[0] for b in batches]),
                     torch.stack([b[1] for b in batches]))
    assert _equal(_tensors(state), want)
    assert m["loss"].tolist() == losses and m["skipped"].tolist() == [1.0, 0.0, 0.0]


# the factory's refusals: (port kwargs, the JAX step's kwargs)
REFUSALS = {
    "unknown-overlap": dict(overlap="bogus"),
    "delayed-psum": dict(overlap="delayed", aggregate="psum"),
    "delayed-dense": dict(overlap="delayed", codec=None),
    "stream-psum": dict(stream_encode=True, aggregate="psum"),
    "stream-dense": dict(stream_encode=True, codec=None),
    "ef-delayed": dict(overlap="delayed", error_feedback=True),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_factory_refusals_carry_the_jax_messages(group_of_one, name):
    kw = dict(REFUSALS[name])
    with_codec = "codec" not in kw
    kw.pop("codec", None)
    model, opt, _ = _fresh()
    with pytest.raises(ValueError) as port:
        R.make_distributed_train_step(model, opt, CODEC if with_codec else None, **kw)
    with pytest.raises(ValueError) as want:
        jax_step(jax_model("lenet", 10), jax_optimizer("sgd"), make_mesh(1),
                 JaxQsgd(bits=4) if with_codec else None, **kw)
    assert str(port.value) == str(want.value)


LOOP_REFUSALS = {
    "unknown-overlap": dict(overlap="bogus"),
    "delayed-dense": dict(overlap="delayed", codec=None),
    "ef-delayed": dict(overlap="delayed", error_feedback=True),
    "stream-psum": dict(stream_encode=True, aggregate="psum"),
}


@pytest.mark.parametrize("name", list(LOOP_REFUSALS))
def test_loop_refusals_carry_the_jax_messages(name):
    kw = dict(LOOP_REFUSALS[name])
    with_codec = "codec" not in kw
    kw.pop("codec", None)
    it = BatchIterator(synthetic_dataset(SPECS["mnist"], True, size=32), 8, seed=0)
    with pytest.raises(ValueError) as port:
        distributed_train_loop(get_model("lenet", 10), make_optimizer("sgd"), it,
                               codec=CODEC if with_codec else None, max_steps=1,
                               device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        jax_loop(jax_model("lenet", 10), jax_optimizer("sgd"), make_mesh(1), it,
                 codec=JaxQsgd(bits=4) if with_codec else None, max_steps=1, **kw)
    assert str(port.value) == str(want.value)


@pytest.mark.parametrize("kw,want", [
    (dict(aggregate="gather"), True),
    (dict(aggregate="gather", stream_encode=True), False),
])
def test_graph_rule_takes_delayed_and_sends_stream_encode_eager(kw, want):
    ok, why = G.graph_rule(device="cuda", codec=CODEC, backend="nccl", world=1, **kw)
    assert ok is want
    assert want or why.startswith("stream-encode")


def _loop(train_dir, steps, **kw):
    it = BatchIterator(synthetic_dataset(SPECS["mnist"], True, size=64), 8, seed=0)
    model = get_model("lenet", 10)
    logs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = distributed_train_loop(
            model, make_optimizer("sgd", lr=0.01, momentum=0.9), it, codec=CODEC,
            aggregate="gather", max_steps=steps, eval_freq=0, seed=0, train_dir=str(train_dir),
            save_freq=2, log_fn=logs.append, device="cpu", **kw)
    return state, logs, [str(w.message) for w in caught if "deprecated" not in str(w.message)]


def test_loop_delayed_resume_equals_the_straight_run(group_of_one, tmp_path):
    straight, _, _ = _loop(tmp_path / "a", 4, overlap="delayed")
    _loop(tmp_path / "b", 2, overlap="delayed")
    resumed, logs, warned = _loop(tmp_path / "b", 4, overlap="delayed", resume=True)
    assert "Resumed from" in logs[0] and logs[0].endswith("at step 2")
    assert not warned
    assert _equal(_tensors(resumed), _tensors(straight))
    assert torch.equal(resumed.carry.payload, straight.carry.payload)


def test_loop_delayed_resume_of_a_blocking_checkpoint_skips_its_first_step(
        group_of_one, tmp_path):
    blocking, _, _ = _loop(tmp_path, 2)
    before = _tensors(blocking)
    resumed, _, warned = _loop(tmp_path, 3, overlap="delayed", resume=True)
    assert warned and warned[0].startswith(
        "--overlap delayed resume: checkpoint has no overlap carry (")
    assert warned[0].endswith("restoring the train state only — the first resumed "
                              "step applies a zero (skipped) update")
    assert resumed.step == 3 and _equal(_tensors(resumed), before)


def test_loop_blocking_resume_of_a_delayed_checkpoint_restores_the_train_state(
        group_of_one, tmp_path):
    delayed, _, _ = _loop(tmp_path, 2, overlap="delayed")
    resumed, logs, warned = _loop(tmp_path, 2, resume=True)
    assert warned and warned[0].startswith("resume: checkpoint was written by --overlap "
                                           "delayed (")
    assert "discarding the in-flight payload" in warned[0]
    assert resumed.step == 2 and resumed.carry is None
    assert _equal(_tensors(resumed), _tensors(delayed))
