"""The port's CRC checkpoints: the contracts of ``tests/test_checkpoint.py``
that the port keeps, and the port's files against the JAX package's.

Contracts: round trip; compressed and raw both load; an empty directory
raises ``FileNotFoundError``; a truncated file, a bad magic and a flipped
bit fall back to the previous step (an explicit step raises); all files
corrupt raise; keep-last-K, which never prunes the file just written and
never lets a corrupt file take a slot; the compress fallback warns and
writes raw; a JAX-package file is refused by name (and never pruned).

Against the JAX package: its ``train_loop`` and the port's run 6 LeNet
steps from the same Flax init on the same batches, saving every 3 (sgd with
momentum, and adam). The port's ``model_step_3`` and ``model_step_6`` hold
the JAX package's state (params, optimizer state through ``convert``) at
the tolerance and learning rate of ``tests/test_torch_trainer.py``'s LeNet
case: atol 1e-5 at lr 0.001. Adam moves each element by about lr whatever
its gradient, so an element whose gradient is near zero carries the two
packages' float32 gradient difference into a step of lr's size (at lr 0.01,
one element of 400,000 ended 1.008e-5 apart).
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atomo_tpu_torch.training.checkpoint as ck
import atomo_tpu_torch.training.trainer as port_trainer
from atomo_tpu.data import SPECS as JAX_SPECS
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.training import create_state as jax_create_state
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu.training import train_loop as jax_train_loop
from atomo_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from atomo_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from atomo_tpu_torch.convert import jax_from_state_dict, jax_opt_state, state_dict_from_jax
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import make_optimizer, train_loop
from atomo_tpu_torch.training.trainer import create_state

LR = 0.001  # tests/test_torch_trainer.py's


def _state(momentum=0.9, seed=0):
    """A LeNet state on the CPU with a non-zero momentum trace."""
    state = create_state(get_model("lenet", 10), make_optimizer("sgd", lr=0.05,
                                                                momentum=momentum), seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    for t in state.opt_state.trace or []:
        t.copy_(torch.randn(t.shape, generator=gen))
    state.opt_state.count = 7
    return state


def _fresh():
    return create_state(get_model("lenet", 10), make_optimizer("sgd", lr=0.05, momentum=0.9),
                        99, "cpu")


def _assert_same(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    for x, y in zip(a.opt_state.trace, b.opt_state.trace):
        assert torch.equal(x, y)


def _saved(d, steps=(1, 2, 3), compress=False):
    state = _state()
    for s in steps:
        state.step = s
        ck.save_checkpoint(str(d), state, compress=compress)
    return state


def _corrupt(path, how):
    blob = open(path, "rb").read()
    if how == "truncate":
        blob = blob[: len(blob) // 2]
    elif how == "badmagic":
        blob = b"XXXX" + blob[4:]
    elif how == "bitflip":
        i = len(blob) - 1000
        blob = blob[:i] + bytes([blob[i] ^ 0x10]) + blob[i + 1:]
    open(path, "wb").write(blob)


@pytest.mark.parametrize("compress", [False, True])
def test_round_trip(tmp_path, compress):
    state = _state()
    state.step = 7
    path = ck.save_checkpoint(str(tmp_path), state, compress=compress)
    assert path.endswith("model_step_7") and ck.list_steps(str(tmp_path)) == [7]
    with open(path, "rb") as f:
        assert f.read(4) == (ck.MAGIC_LZ if compress else ck.MAGIC_RAW)
    restored = ck.load_checkpoint(str(tmp_path), _fresh(), 7)
    _assert_same(restored, state)
    model = get_model("lenet", 10)
    assert ck.load_params(str(tmp_path), model) == 7
    for (_, a), (_, b) in zip(model.state_dict().items(), state.model.state_dict().items()):
        assert torch.equal(a, b)


def test_empty_train_dir_raises_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(str(tmp_path), _fresh())
    assert ck.latest_step(str(tmp_path)) is None and ck.latest_valid_step(str(tmp_path)) is None


@pytest.mark.parametrize("how", ["truncate", "badmagic", "bitflip"])
@pytest.mark.parametrize("compress", [False, True])
def test_corrupt_newest_falls_back_and_explicit_step_raises(tmp_path, how, compress):
    state = _saved(tmp_path, compress=compress)
    assert ck.verify_checkpoint(str(tmp_path), 3)
    _corrupt(ck.checkpoint_path(str(tmp_path), 3), how)
    assert not ck.verify_checkpoint(str(tmp_path), 3)
    assert ck.latest_step(str(tmp_path)) == 3 and ck.latest_valid_step(str(tmp_path)) == 2
    with pytest.warns(UserWarning, match="skipping invalid checkpoint"):
        restored = ck.load_checkpoint(str(tmp_path), _fresh())
    state.step = 2
    _assert_same(restored, state)
    with pytest.raises(ck.CorruptCheckpointError):
        ck.load_checkpoint(str(tmp_path), _fresh(), step=3)


def test_crc_catches_a_single_bit_flip(tmp_path):
    """One flipped payload bit with the magic intact fails the CRC."""
    _saved(tmp_path, steps=(1,))
    path = ck.checkpoint_path(str(tmp_path), 1)
    blob = open(path, "rb").read()
    flipped = blob[:-1] + bytes([blob[-1] ^ 1])
    assert flipped[:4] == ck.MAGIC_RAW
    open(path, "wb").write(flipped)
    with pytest.raises(ck.CorruptCheckpointError, match="CRC mismatch"):
        ck.load_checkpoint(str(tmp_path), _fresh(), step=1)


def test_all_checkpoints_corrupt_raises_filenotfound(tmp_path):
    _saved(tmp_path, steps=(1, 2))
    for s in (1, 2):
        _corrupt(ck.checkpoint_path(str(tmp_path), s), "truncate")
    with pytest.warns(UserWarning):
        with pytest.raises(FileNotFoundError, match="no VALID"):
            ck.load_checkpoint(str(tmp_path), _fresh())


def test_keep_last_k_retention(tmp_path):
    state = _state()
    for s in range(1, 6):
        ck.save_checkpoint(str(tmp_path), state, s, compress=False, keep=2)
    assert ck.list_steps(str(tmp_path)) == [4, 5]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_retention_never_prunes_the_just_written_step(tmp_path):
    """A timeline resumed below a stale corrupt file: keep=1 keeps the new
    file, not the higher-numbered corpse."""
    state = _state()
    for s in (3, 6):
        ck.save_checkpoint(str(tmp_path), state, s, compress=False)
    _corrupt(ck.checkpoint_path(str(tmp_path), 6), "truncate")
    ck.save_checkpoint(str(tmp_path), state, 4, compress=False, keep=1)
    assert ck.list_steps(str(tmp_path)) == [4]


def test_retention_does_not_count_corrupt_files(tmp_path):
    state = _state()
    for s in (3, 6):
        ck.save_checkpoint(str(tmp_path), state, s, compress=False)
    _corrupt(ck.checkpoint_path(str(tmp_path), 6), "bitflip")
    ck.save_checkpoint(str(tmp_path), state, 4, compress=False, keep=2)
    assert ck.list_steps(str(tmp_path)) == [3, 4]


def test_compress_fallback_warns_and_writes_raw(tmp_path, monkeypatch):
    from atomo_tpu_torch.native import lossless

    def boom(*a, **k):
        raise RuntimeError("g++ failed for lossless.cc")

    monkeypatch.setattr(lossless, "compress", boom)
    monkeypatch.setattr(ck, "_warned_compress_fallback", False)
    state = _state()
    with pytest.warns(UserWarning, match="compression unavailable"):
        path = ck.save_checkpoint(str(tmp_path), state, 1, compress=True)
    with open(path, "rb") as f:
        assert f.read(4) == ck.MAGIC_RAW
    state.step = 1
    _assert_same(ck.load_checkpoint(str(tmp_path), _fresh(), 1), state)


def test_a_jax_package_checkpoint_is_refused_by_name(tmp_path):
    """The JAX package's file (flax msgpack) is named as such, skipped by
    the newest-valid walk, and left alone by retention."""
    jmodel = jax_model("lenet", 10)
    jopt = jax_optimizer("sgd", lr=0.05, momentum=0.9)
    jstate = jax_create_state(jmodel, jopt, jax.random.PRNGKey(0),
                              jnp.zeros((1, 28, 28, 1), jnp.float32))
    jax_save_checkpoint(str(tmp_path), jstate, 5, compress=False)
    with pytest.raises(ck.CorruptCheckpointError, match="JAX package atomo_tpu"):
        ck.load_checkpoint(str(tmp_path), _fresh(), step=5)
    state = _state()
    ck.save_checkpoint(str(tmp_path), state, 2, compress=False, keep=1)
    assert ck.list_steps(str(tmp_path)) == [2, 5]
    with pytest.warns(UserWarning, match="JAX package"):
        assert ck.load_checkpoint(str(tmp_path), _fresh()).step == 2


def test_header_is_magic_crc_payload(tmp_path):
    _saved(tmp_path, steps=(1,))
    blob = open(ck.checkpoint_path(str(tmp_path), 1), "rb").read()
    assert blob[:4] == ck.MAGIC_RAW
    assert int.from_bytes(blob[4:8], "little") == zlib.crc32(blob[8:])


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("name,kw", [("sgd", {"momentum": 0.9}), ("adam", {})])
def test_train_loop_checkpoints_match_jax(tmp_path, monkeypatch, name, kw):
    ds = synthetic_dataset(SPECS["mnist"], True, size=64, seed=3)
    jmodel = jax_model("lenet", 10)
    jopt = jax_optimizer(name, lr=LR, **kw)
    x0 = next(BatchIterator(ds, 16, seed=3).epoch())[0]
    jinit = jax_create_state(jmodel, jopt, jax.random.PRNGKey(0), jnp.asarray(x0))
    jax_train_loop(jmodel, jopt, BatchIterator(ds, 16, seed=3), max_steps=6, seed=0,
                   train_dir=str(tmp_path / "jax"), save_freq=3, compress_ckpt=False,
                   log_every=0)

    model = get_model("lenet", 10, image_shape=JAX_SPECS["mnist"].image_shape)
    sd = state_dict_from_jax(model, jax.device_get(jinit.params))
    # the port's loop starts from the JAX package's init (the seeds differ)
    monkeypatch.setattr(port_trainer, "init_params", lambda m, seed: m.load_state_dict(sd))
    opt = make_optimizer(name, lr=LR, **kw)
    it = BatchIterator(ds, 16, seed=3)
    next(it.epoch())  # the JAX loop draws its sample batch so, one shuffle
    train_loop(model, opt, it, max_steps=6, seed=0,
               train_dir=str(tmp_path / "port"), save_freq=3, compress_ckpt=True,
               log_fn=lambda _: None, device="cpu")
    assert ck.list_steps(str(tmp_path / "port")) == [3, 6]

    for step in (3, 6):
        jstate = jax_load_checkpoint(str(tmp_path / "jax"), jinit, step)
        pstate = ck.load_checkpoint(
            str(tmp_path / "port"),
            create_state(get_model("lenet", 10), opt, 1, "cpu"), step)
        assert pstate.step == int(jstate.step) == step
        pparams, _ = jax_from_state_dict(pstate.model)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=1e-5),
            pparams, jax.device_get(jstate.params))
        popt = jax_opt_state(pstate.model, pstate.opt_state, jinit.opt_state)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5),
            popt, jax.device_get(jstate.opt_state))
