"""``--superstep K`` of the port on the CPU, against itself and the JAX package.

On the CPU every block is the eager K-step block (a CUDA graph needs a card:
``tests/test_torch_cuda.py`` holds the replay to the eager steps there). Bit
for bit within the port: K = 1, 2, 3 and the ragged partition [3, 4, 1] of
8 LeNet steps (per-step losses, parameters, momentum) for sgd, qsgd (the
torch quantizer and the fused kernels' plain twins), terngrad, svd
``fixed_k`` and a per-leaf qsgd width allocation; the graph's step body (the
codec key a 0-d tensor folded per leaf, the optimizer's scalars a tensor,
the augmentation and dropout drawn outside it) against the step; a run
resumed at a step that is not a multiple of K against the straight run.
Against the JAX package: its ``BlockStream`` blocks and ``_crossed`` equal
the port's; the port's K-block against ``make_train_step(superstep=K)`` on
the same numpy inputs, the JAX step's uniforms handed over, within the
tolerance of the JAX package's own scan-against-step test
(``tests/test_superstep.py``: rtol 1e-4, atol 1e-6); the loop's ``Worker:``
and ``Validation:`` step numbers and checkpoint steps equal the JAX loop's;
the CLI refuses ``--superstep -1`` with the JAX text and resolves 0 to 1.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu import cli as jax_cli
from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.data import SPECS as JAX_SPECS
from atomo_tpu.data import BatchIterator as JaxBatchIterator
from atomo_tpu.data import synthetic_dataset as jax_synthetic
from atomo_tpu.data.pipeline import BlockStream as JaxBlockStream
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu.training import trainer as jax_trainer
from atomo_tpu_torch import cli
from atomo_tpu_torch.budget import budgeted_codec
from atomo_tpu_torch.codecs import DenseCodec, encode_tree, get_codec
from atomo_tpu_torch.convert import state_dict_from_jax
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
from atomo_tpu_torch.data.pipeline import (
    BlockStream,
    SuperstepFeed,
    augment_apply,
    augment_batch,
    augment_draws,
    block_to_device,
)
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.models.vgg import VGG
from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step, train_loop
from atomo_tpu_torch.training import trainer
from atomo_tpu_torch.training.graph import GraphBlock, graph_rule, mode_line
from atomo_tpu_torch.training.trainer import leaf_params
from atomo_tpu_torch.utils.rng import FoldedSeeds, fold_in, generator

SEED, BATCH, KEY = 3, 8, 11
STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's CPU steps: the suite's workers
    share the machine's cores, and oversubscribed thread pools thrash."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ds(name="mnist", size=64):
    return synthetic_dataset(SPECS[name], True, size=size, seed=SEED)


def _codec(code):
    if code == "sgd":
        return None
    if code == "qsgd_fused":  # the fused kernels' plain twins
        return get_codec("qsgd", quantization_level=4, use_kernel=True)
    if code == "budget":  # widths 2-9 over LeNet's 8 leaves
        return budgeted_codec(get_codec("qsgd"), [2 + i for i in range(8)])
    return get_codec(code, quantization_level=4, svd_rank=3)


def _fresh(code, *, superstep=1, shrinkage_freq=3, optimizer="sgd", augment=False,
           network="lenet", image_shape=(28, 28, 1)):
    model = get_model(network, 10, image_shape=image_shape)
    opt = make_optimizer(optimizer, lr=0.01, momentum=0.9, shrinkage_freq=shrinkage_freq)
    state = create_state(model, opt, 0, "cpu")
    return state, make_train_step(model, opt, _codec(code), augment=augment,
                                  superstep=superstep)


def _carried(state):
    return [t.detach().clone() for t in list(state.model.state_dict().values())
            + (state.opt_state.trace or [])]


@functools.lru_cache(maxsize=None)
def _run(code, parts):
    """The LeNet steps over blocks of ``parts`` (a tuple): per-step losses
    and the carried state, each (code, parts) run once per test process."""
    state, _ = _fresh(code)
    # one model for every block size: the steps over it
    steps = {k: make_train_step(state.model, make_optimizer(
        "sgd", lr=0.01, momentum=0.9, shrinkage_freq=3), _codec(code), superstep=k)
        for k in set(parts)}
    blocks = BlockStream(BatchIterator(_ds(), BATCH, seed=SEED).forever())
    losses = []
    for k in parts:
        staged = block_to_device(*blocks.take(k), "cpu")
        if k == 1:
            state, m = steps[1](state, KEY, staged.images[0], staged.labels[0])
            losses.append(m["loss"].reshape(1))
        else:
            state, m = steps[k](state, KEY, staged.images, staged.labels)
            assert m["loss"].shape == (k,) and isinstance(m["msg_bytes"], int)
            losses.append(m["loss"])
    assert state.step == sum(parts) and state.opt_state.count == sum(parts)
    return torch.cat(losses), _carried(state)


def _bits_equal(a, b):
    return all(torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
               for x, y in zip(a, b))


# ------------------------------------------------------------ the data side


@pytest.mark.parametrize("parts", [[3, 3, 1], [8], [1, 1, 1], [2, 5]])
def test_blocks_equal_the_jax_blocks(parts):
    """The port's and the JAX package's BlockStream over their BatchIterators
    (the same numpy shuffle) stack the same blocks, the tail included; the
    feed stages them on the device as to_device stages each batch."""
    jds = jax_synthetic(JAX_SPECS["mnist"], True, size=64, seed=SEED)
    ours = BlockStream(BatchIterator(_ds(), BATCH, seed=SEED).forever())
    theirs = JaxBlockStream(JaxBatchIterator(jds, BATCH, seed=SEED).forever())
    per_step = BatchIterator(_ds(), BATCH, seed=SEED).forever()
    feed = SuperstepFeed(ours, lambda x, y: block_to_device(x, y, "cpu"))
    for k in parts:
        want = theirs.take(k)
        feed.start(k)
        kb, images, labels = feed.take()
        assert kb == k and images.shape == (k, BATCH, 1, 28, 28)
        for t in range(k):
            x, y = to_device(*next(per_step), "cpu")
            assert torch.equal(images[t], x) and images[t].stride() == x.stride()
            assert torch.equal(labels[t], y)
            np.testing.assert_array_equal(want[0][t].transpose(0, 3, 1, 2), images[t].numpy())
            np.testing.assert_array_equal(want[1][t], labels[t].numpy())


@pytest.mark.parametrize("cadence", [0, 1, 2, 3, 5, 7])
def test_crossed_equals_jax(cadence):
    for lo in range(0, 20):
        for hi in range(lo, lo + 9):
            assert trainer._crossed(cadence, lo, hi) == jax_trainer._crossed(cadence, lo, hi)


def test_augment_split_is_augment_batch():
    x = torch.randn((6, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    off, flip = augment_draws(6, generator(5, "cpu"), "cpu")
    assert torch.equal(augment_apply(x, off, flip), augment_batch(x, generator(5, "cpu")))


# ----------------------------------------------------- partitions, bit for bit


PARTS = {"K2": (2,) * 4, "K3": (3, 3, 2), "ragged": (3, 4, 1)}


@pytest.mark.parametrize("code,parts", [
    (code, parts) for code in ("sgd", "qsgd", "terngrad", "svd", "budget") for parts in PARTS
] + [("qsgd_fused", "ragged")])
def test_partitions_are_bit_identical(code, parts):
    """8 LeNet steps (an LR change at step 3 and 6) in blocks of ``parts``
    equal 8 single steps: per-step losses, parameters, buffers, momentum
    (the fused kernels' plain twins on the ragged partition: their Philox
    draws are the costliest on the CPU)."""
    want_losses, want = _run(code, (1,) * STEPS)
    got_losses, got = _run(code, PARTS[parts])
    assert torch.equal(got_losses, want_losses)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("code", ["sgd", "qsgd", "qsgd_fused", "budget"])
def test_graph_body_equals_the_step(code):
    """The step body a graph captures, run on its device-form inputs (the
    codec key a 0-d int64 tensor folded per leaf, -lr a float32 tensor, the
    augmentation drawn outside it) equals the step on the host's values, on
    LeNet at CIFAR shapes with augmentation on, across an LR change."""
    kw = dict(augment=True, image_shape=(32, 32, 3), shrinkage_freq=2)
    ref, ref_step = _fresh(code, **kw)
    dev_state, dev_step = _fresh(code, **kw)
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9, shrinkage_freq=2)
    stream = BatchIterator(_ds("cifar10"), BATCH, seed=SEED).forever()
    for _ in range(4):
        x, y = to_device(*next(stream), "cpu")
        ref, m_ref = ref_step(ref, KEY, x, y)
        k_aug, k_drop, k_codec = dev_step.keys(KEY, dev_state.step)
        scalars = torch.tensor(opt.step_scalars(dev_state.opt_state.count),
                               dtype=torch.float32)
        dev_state, m_dev = dev_step.core(
            dev_state, x, y, aug=augment_draws(BATCH, generator(k_aug, "cpu"), "cpu"),
            k_drop=k_drop, k_codec=torch.tensor(k_codec), opt_scalars=scalars)
        assert torch.equal(m_ref["loss"], m_dev["loss"])
    assert _bits_equal(_carried(ref), _carried(dev_state))


def test_graph_dropout_draws_replay_the_stream():
    """A GraphBlock draws a step's dropout masks outside the step, from the
    calls the warm-up recorded; with them the step body equals the step on
    its key (a reduced VGG with both Dropout layers)."""
    from atomo_tpu_torch.models.dropout import record_dropout_calls

    def fresh():
        model = VGG([8, "M", 16, "M"], batch_norm=True, image_shape=(32, 32, 3))
        opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
        return create_state(model, opt, 0, "cpu"), make_train_step(model, opt, None)

    ref, ref_step = fresh()
    state, step = fresh()
    x, y = to_device(*next(BatchIterator(_ds("cifar10"), BATCH, seed=SEED).forever()), "cpu")
    _, k_drop, _ = step.keys(KEY, 0)
    with record_dropout_calls() as calls:
        ref_step(ref, KEY, x, y)
    assert [c[0] for c in calls] == [0, 0] and len({c[1] for c in calls}) == 2
    block = GraphBlock(step, 2, optimizer=None, augment=False, device="cpu")
    block.static = block._alloc(x, y, 3)
    block.drop_calls = calls
    block.static.masks = [torch.zeros(s, dtype=torch.bool) for _, s, _ in calls]
    block._draw(0, k_drop)
    ref2, ref2_step = fresh()
    ref2, m_ref = ref2_step(ref2, KEY, x, y)
    state, m = step(state, KEY, x, y, dropout_masks=block.static.masks)
    assert torch.equal(m["loss"], m_ref["loss"])
    assert _bits_equal(_carried(state), _carried(ref2))


@pytest.mark.parametrize("code", ["qsgd", "qsgd_fused", "terngrad", "svd", "dense"])
def test_device_key_encodes_as_the_int_key(code):
    """encode_tree under a 0-d int64 key tensor (FoldedSeeds) equals the
    encode under the int key, every payload field bit for bit."""
    codec = DenseCodec() if code == "dense" else _codec(code)
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn(s, generator=gen) for s in ((6, 1, 5, 5), (6,), (120, 400), (10,))]
    a, _ = encode_tree(codec, 77, grads)
    b, _ = encode_tree(codec, torch.tensor(77), grads)
    for pa, pb in zip(a, b):
        for fa, fb in zip(pa, pb):
            assert torch.equal(fa, fb)
    seeds = FoldedSeeds(torch.tensor(77), [4, 9])
    assert list(seeds) == [fold_in(77, 4), fold_in(77, 9)]
    assert list(seeds.subset([1])) == [fold_in(77, 9)]


def test_sgd_device_scalars_equal_the_host_update():
    """``update(scalars=)`` with step_scalars' values equals the host update
    (momentum SGD across the schedule's change at step 50)."""
    opt = make_optimizer("sgd", lr=0.1, momentum=0.9, weight_decay=1e-4)
    assert opt.step_scalars(49) != opt.step_scalars(50)
    gen = torch.Generator().manual_seed(2)
    p1 = [torch.randn((7, 3), generator=gen)]
    p2 = [p.clone() for p in p1]
    s1, s2 = opt.init(p1), opt.init(p2)
    s1.count = s2.count = 48
    for _ in range(4):
        g = [torch.randn((7, 3), generator=gen)]
        s2 = opt.update(g, s2, p2, scalars=torch.tensor(opt.step_scalars(s2.count)))
        s1 = opt.update(g, s1, p1)
    assert torch.equal(p1[0], p2[0]) and torch.equal(s1.trace[0], s2.trace[0])


# ---------------------------------------------------------------- the rule


RULES = {
    "cpu": (dict(device="cpu", codec=None), False, "not on a CUDA device"),
    "sgd": (dict(device="cuda", codec=None), True, ""),
    "qsgd": (dict(device="cuda", codec=get_codec("qsgd")), True, ""),
    "terngrad": (dict(device="cuda", codec=get_codec("terngrad")), True, ""),
    "budget-qsgd": (dict(device="cuda", codec=budgeted_codec(get_codec("qsgd"), [2, 3])),
                    True, ""),
    "budget-svd": (dict(device="cuda", codec=budgeted_codec(get_codec("svd"), [2, 3])),
                   False, "eigh"),
    "svd": (dict(device="cuda", codec=get_codec("svd")), False, "eigh"),
    "pack": (dict(device="cuda", codec=get_codec("qsgd", use_kernel=False)), False,
             "pack path"),
    "nccl": (dict(device="cuda", codec=get_codec("qsgd"), backend="nccl", world=2), True, ""),
    "gloo": (dict(device="cuda", codec=get_codec("qsgd"), backend="gloo"), False, "gloo"),
    "num-aggregate": (dict(device="cuda", codec=get_codec("qsgd"), backend="nccl", world=4,
                           k_agg=2), False, "num_aggregate"),
    "ring-2": (dict(device="cuda", codec=get_codec("qsgd"), backend="nccl", world=2,
                    aggregate="ring"), False, "ring"),
    "ring-1": (dict(device="cuda", codec=get_codec("qsgd"), backend="nccl", world=1,
                    aggregate="ring"), True, ""),
    "hybrid-dense": (dict(device="cuda", codec=DenseCodec(), backend="nccl", world=2), True,
                     ""),
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_graph_rule(case):
    kw, ok, phrase = RULES[case]
    got, why = graph_rule(**kw)
    assert got == ok and phrase in why


def test_mode_line_names_the_eager_block():
    _, block = _fresh("svd", superstep=4)
    assert block.mode == "eager"
    assert mode_line(block) == "Superstep: K=4, eager block (not on a CUDA device)"
    state, _ = _fresh("sgd")
    with pytest.raises(ValueError, match="superstep must be >= 1"):
        make_train_step(state.model, make_optimizer("sgd"), None, superstep=0)


# ---------------------------------------------------------- against JAX


def _jax_uniforms(key, step, params, bucket=512):
    k_codec = jax.random.split(jax.random.fold_in(key, step), 3)[2]
    return [torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(k_codec, i),
                                                         (-(-leaf.size // bucket), bucket))))
            for i, leaf in enumerate(jax.tree_util.tree_leaves(params))]


@pytest.mark.parametrize("code", ["sgd", "qsgd"])
def test_block_matches_the_jax_superstep(code, monkeypatch):
    """The port's 3-step block against the JAX package's
    ``make_train_step(superstep=3)`` (one ``lax.scan``) from the same Flax
    init on the same numpy block, the JAX step's QSGD uniforms handed to the
    port: per-step losses and the parameters after the block within rtol
    1e-4, atol 1e-6 (float32 sums in other orders). With qsgd a float-level
    gradient difference that crosses a uniform moves a field one level (the
    rule of ``tests/test_torch_trainer.py``): at most 0.1 % of the values
    may then differ by up to one quantization step (the largest scale over
    the levels) times lr per step taken."""
    k = 3
    scales = []
    encode = trainer.encode_tree

    def recording(*args, **kw):
        payloads, stats = encode(*args, **kw)
        scales.extend(float(p.scales.max()) for p in payloads)
        return payloads, stats

    monkeypatch.setattr(trainer, "encode_tree", recording)
    x, y = BlockStream(BatchIterator(_ds(), BATCH, seed=SEED).forever()).take(k)
    jmodel = jax_model("lenet", 10)
    jopt = jax_optimizer("sgd", lr=0.001, momentum=0.9)
    jstate = jax_trainer.create_state(jmodel, jopt, jax.random.PRNGKey(0), jnp.asarray(x[0]))
    params0 = jax.device_get(jstate.params)
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    model.load_state_dict(state_dict_from_jax(model, params0, jax.device_get(
        jstate.batch_stats)))
    key = jax.random.PRNGKey(SEED + 1)
    uniforms = [_jax_uniforms(key, s, params0) for s in range(k)] if code == "qsgd" else None
    jstep = jax_trainer.make_train_step(jmodel, jopt, JaxQsgd(bits=4) if code == "qsgd"
                                        else None, superstep=k)
    jstate, jm = jstep(jstate, key, jnp.asarray(x), jnp.asarray(y))
    opt = make_optimizer("sgd", lr=0.001, momentum=0.9)
    state = trainer.TrainState(0, model, opt.init(leaf_params(model)))
    codec = get_codec("qsgd", quantization_level=4) if code == "qsgd" else None
    block = make_train_step(model, opt, codec, superstep=k)
    staged = block_to_device(x, y, "cpu")
    state, m = block(state, KEY, staged.images, staged.labels, uniforms=uniforms)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-4)
    assert m["msg_bytes"] == int(np.asarray(jm["msg_bytes"])[-1])
    want = state_dict_from_jax(model, jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    step_q = 0.001 * k * max(scales, default=0.0) / 15  # lr * steps * scale / levels
    for name, v in model.state_dict().items():
        got, ref = v.numpy(), want[name].numpy()
        off = ~np.isclose(got, ref, rtol=1e-4, atol=1e-6)
        assert off.mean() <= (1e-3 if code == "qsgd" else 0.0), (name, off.sum())
        np.testing.assert_allclose(got[off], ref[off], rtol=0, atol=step_q)


def _steps(lines, prefix):
    return [int(m.group(1)) for m in (re.match(prefix + r"Step: (\d+),", ln) for ln in lines)
            if m]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_loop_cadence_matches_the_jax_loop(tmp_path, k):
    """Both loops over 7 LeNet steps in blocks of K (log every 2, eval and
    save every 3): the same Worker: and Validation: step numbers, the same
    checkpoint steps (the final autosave included), the port's mode line
    first."""
    jds = jax_synthetic(JAX_SPECS["mnist"], True, size=64, seed=SEED)
    jlines = []
    common = dict(max_steps=7, eval_freq=3, save_freq=3, log_every=2, superstep=k)
    jax_trainer.train_loop(jax_model("lenet", 10), jax_optimizer("sgd", lr=0.01),
                           JaxBatchIterator(jds, BATCH, seed=SEED),
                           JaxBatchIterator(jds, 32, seed=SEED, shuffle=False),
                           train_dir=str(tmp_path / "jax"), log_fn=jlines.append, **common)
    lines = []
    train_loop(get_model("lenet", 10, image_shape=(28, 28, 1)), make_optimizer("sgd", lr=0.01),
               BatchIterator(_ds(), BATCH, seed=SEED),
               BatchIterator(_ds(), 32, seed=SEED, shuffle=False),
               train_dir=str(tmp_path / "port"), log_fn=lines.append, device="cpu", **common)
    assert lines[0] == f"Superstep: K={k}, eager block (not on a CUDA device)"
    for prefix in ("Worker: 0, ", "Validation: "):
        assert _steps(lines, prefix) == _steps(jlines, prefix) != []

    def saved(d):
        return sorted(int(m.group(1)) for m in (
            re.match(r"^model_step_(\d+)$", p.name) for p in Path(d).iterdir()) if m)

    assert saved(tmp_path / "port") == saved(tmp_path / "jax") != []


@pytest.mark.parametrize("first,code", [(3, "sgd"), (3, "qsgd"), (1, "qsgd")],
                         ids=["K3-sgd", "K3-qsgd", "K1-then-K3"])
def test_resume_off_a_block_boundary_is_bit_identical(tmp_path, first, code):
    """A run of 4 steps (blocks 3 and 1 at K 3, saved at 3 and 4) resumed
    to 7 in blocks of 3 from step 4, not a multiple of 3, equals the
    straight 7 steps bit for bit."""
    def run(d, steps, k, resume=False):
        return train_loop(get_model("lenet", 10, image_shape=(28, 28, 1)),
                          make_optimizer("sgd", lr=0.01, momentum=0.9, shrinkage_freq=3),
                          BatchIterator(_ds(), BATCH, seed=SEED), codec=_codec(code),
                          max_steps=steps, train_dir=str(d), save_freq=2, resume=resume,
                          log_fn=lambda _: None, device="cpu", superstep=k)

    straight = run(tmp_path / "a", 7, 3)
    run(tmp_path / "b", 4, first)
    assert sorted(p.name for p in (tmp_path / "b").glob("model_step_*"))[-1] == "model_step_4"
    resumed = run(tmp_path / "b", 7, 3, resume=True)
    assert resumed.step == 7
    assert _bits_equal(_carried(straight), _carried(resumed))


# ----------------------------------------------------------------- the CLI


LENET = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
         "--batch-size", "16", "--max-steps", "5", "--log-interval", "1", "--eval-freq", "0"]


def test_cli_refuses_a_negative_superstep_with_the_jax_text():
    with pytest.raises(SystemExit) as port:
        cli.main(LENET + ["--superstep", "-1", "--device", "cpu"], log_fn=lambda _: None)
    with pytest.raises(SystemExit) as want:
        jax_cli.main(LENET + ["--superstep", "-1"])
    assert str(port.value.code) == str(want.value.code)
    assert "--superstep -1: must be >= 1" in str(port.value.code)


def test_cli_superstep_zero_is_the_per_step_loop():
    lines = {}
    for k in ("0", "1"):
        lines[k] = []
        assert cli.main(LENET + ["--superstep", k, "--device", "cpu", "--train-dir", ""],
                        log_fn=lines[k].append) == 0
    assert _steps(lines["0"], "Worker: 0, ") == [1, 2, 3, 4, 5]
    strip = [re.sub(r"Time Cost: [0-9.]+", "", ln) for ln in lines["0"]]
    assert strip == [re.sub(r"Time Cost: [0-9.]+", "", ln) for ln in lines["1"]]


def test_cli_block_lines_match_the_jax_verb(capsys):
    """``train --superstep 2 --log-interval 1`` over 5 steps: Worker: lines
    at 2, 4 and 5 with the JAX verb's Msg(MB), after the mode line."""
    argv = LENET + ["--superstep", "2", "--code", "qsgd"]
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    jlines = capsys.readouterr().out.splitlines()
    lines = []
    assert cli.main(argv + ["--device", "cpu", "--train-dir", ""], log_fn=lines.append) == 0
    assert "Superstep: K=2, eager block (not on a CUDA device)" in lines

    def msg(ls):
        return [(int(m.group(1)), m.group(2)) for m in (
            re.search(r"^Worker: 0, Step: (\d+),.*Msg\(MB\):\s+([0-9.]+)", ln) for ln in ls)
            if m]

    assert msg(lines) == msg(jlines) and [s for s, _ in msg(lines)] == [2, 4, 5]
