"""The LM slice: the transformer, its weight conversion, the train step and
the CLI of the port against the JAX package (CPU, float32).

Weights come from a Flax init (the LayerNorm scales perturbed from a numpy
seed, so that every converted field matters) and move over with
``atomo_tpu_torch.convert``; tokens are numpy draws. Tolerances:

* logits: atol 1e-5;
* the conversion round trip, the leaf order, the wire byte counts: exact;
* three train steps of ``make_lm_train_step`` on a (dp 1, sp 1) mesh with
  ``attn_impl="ulysses-flash"`` (the JAX flash kernel in interpret mode,
  the port's plain twin): loss rtol 1e-5; params atol 1e-5 with ``sgd`` and
  1e-4 with ``svd``, whose port is fed the draws the JAX codec makes under
  ``fold_in(fold_in(key, step), 0)`` folded with the leaf index, under
  ``aggregate`` ``gather`` and ``psum``; ``msg_bytes`` and ``dense_bytes``
  exactly equal.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.codecs import SvdCodec as JaxSvd
from atomo_tpu.models.transformer import TransformerLM as FlaxLM
from atomo_tpu.parallel import make_mesh
from atomo_tpu.parallel.lm import make_lm_train_step as jax_lm_step
from atomo_tpu.parallel.lm import shard_tokens
from atomo_tpu.training import create_state as jax_create_state
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu_torch import cli
from atomo_tpu_torch.codecs import SvdCodec, encode_tree
from atomo_tpu_torch.convert import (
    jax_from_state_dict,
    jax_layouts,
    jax_leaf_order,
    jax_view,
    state_dict_from_jax,
)
from atomo_tpu_torch.models.transformer import TransformerLM
from atomo_tpu_torch.ops import attention_kernels as A
from atomo_tpu_torch.parallel.lm import make_lm_train_step
from atomo_tpu_torch.training import make_optimizer
from atomo_tpu_torch.training.trainer import TrainState, leaf_params
from test_torch_svd import jax_draws

CFG = dict(vocab_size=16, max_len=32, width=32, depth=2, num_heads=2)
RECIPE = dict(vocab_size=256, max_len=1024, width=256, depth=4, num_heads=4)
LM_LINE = re.compile(
    r"^LM: Step: \d+, Layout: dp(-sp)?\(dp1xsp1\), Loss: \d+\.\d{4}, PPL: \d+\.\d{2}, "
    r"Time Cost: \d+\.\d{4}, Msg\(MB\): \d+\.\d{4}, Dense\(MB\): \d+\.\d{4}$")


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _flax_params(cfg=CFG, seed=0):
    model = FlaxLM(**cfg)
    tokens = jnp.asarray(_tokens((2, cfg["max_len"]), cfg["vocab_size"], seed))
    params = model.init({"params": jax.random.PRNGKey(seed)}, tokens)["params"]
    rng = np.random.default_rng(seed + 1)
    return model, jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), params)


def _port(params, cfg=CFG):
    model = TransformerLM(**cfg)
    model.load_state_dict(state_dict_from_jax(model, params, {}))
    return model


def test_logits_match_flax():
    fmodel, params = _flax_params()
    tokens = _tokens((3, CFG["max_len"]), CFG["vocab_size"], seed=5)
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(tokens)))
    model = _port(params)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # pos_offset embeds the positions of a later sequence shard
    short = tokens[:, :8]
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(short), pos_offset=8))
    with torch.no_grad():
        got = model(torch.from_numpy(short).long(), pos_offset=8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_convert_round_trip_and_leaf_order_are_exact():
    _, params = _flax_params()
    model = _port(params)
    back, stats = jax_from_state_dict(model)
    assert stats == {}
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    named = dict(model.named_parameters())
    order = jax_leaf_order(model)
    views = [tuple(jax_view(named[n], tr).shape) for n, tr in zip(order, jax_layouts(model))]
    assert views == [tuple(a.shape) for a in flat_a]
    assert len(order) == len(named)


def test_recipe_leaves_and_wire_bytes_match_jax():
    """The canonical recipe (vocab 256, seq 1024, width 256, depth 4, 4
    heads): 28 leaves, 3,541,248 parameters, and the svd payload at the
    auto rank 24 the JAX package's ``msg_bytes`` counts."""
    model = TransformerLM(**RECIPE)
    order = jax_leaf_order(model)
    shapes = jax.eval_shape(lambda t: FlaxLM(**RECIPE).init(jax.random.PRNGKey(0), t),
                            jax.ShapeDtypeStruct((1, 1024), jnp.int32))["params"]
    jshapes = [tuple(a.shape) for a in jax.tree_util.tree_leaves(shapes)]
    named = dict(model.named_parameters())
    grads = [jax_view(named[n], tr) for n, tr in zip(order, jax_layouts(model))]
    assert [tuple(g.shape) for g in grads] == jshapes
    assert len(order) == 28 and sum(p.numel() for p in named.values()) == 3_541_248
    rank = max(2, math.ceil(256 * 6 / 64))
    assert rank == 24
    want = sum(JaxSvd(rank=rank).leaf_payload_bytes(s) for s in jshapes)
    codec = SvdCodec(rank=rank)
    assert sum(codec.leaf_payload_bytes(s) for s in jshapes) == want
    gen = torch.Generator().manual_seed(0)
    port_grads = [torch.randn(named[n].shape, generator=gen) for n in order]
    _, stats = encode_tree(codec, 3, port_grads, layouts=jax_layouts(model))
    assert stats.payload_bytes == want
    assert stats.dense_bytes == 4 * 3_541_248


def _svd_draws(codec, key, step, params):
    k_codec = jax.random.fold_in(jax.random.fold_in(key, step), 0)
    return [jax_draws(codec, jax.random.fold_in(k_codec, i), tuple(a.shape))
            for i, a in enumerate(jax.tree_util.tree_leaves(params))]


@pytest.mark.parametrize("code,aggregate", [("sgd", "gather"), ("svd", "gather"),
                                            ("svd", "psum")])
def test_three_train_steps_match_jax(code, aggregate):
    lr, momentum, batch = 0.1, 0.9, 4
    _, params = _flax_params(seed=2)
    mesh = make_mesh(1, axes=(("dp", 1), ("sp", 1)))
    jopt = jax_optimizer("sgd", lr=lr, momentum=momentum)
    rank = max(2, math.ceil(CFG["width"] * 6 / 64))
    jcodec = JaxSvd(rank=rank) if code == "svd" else None
    jstep = jax_lm_step(CFG, jopt, mesh, jcodec, attn_impl="ulysses-flash",
                        aggregate=aggregate)
    tokens0 = jnp.asarray(_tokens((batch, CFG["max_len"]), CFG["vocab_size"], 0))
    jstate = jax_create_state(FlaxLM(**CFG), jopt, jax.random.PRNGKey(0), tokens0)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params))

    model = _port(params)
    opt = make_optimizer("sgd", lr=lr, momentum=momentum)
    state = TrainState(step=0, model=model, opt_state=opt.init(leaf_params(model)))
    codec = SvdCodec(rank=rank) if code == "svd" else None
    pstep = make_lm_train_step(model, opt, codec, attn_impl="ulysses-flash",
                               aggregate=aggregate)

    for i in range(1, 4):
        tokens = _tokens((batch, CFG["max_len"]), CFG["vocab_size"], seed=10 + i)
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        draws = _svd_draws(codec, key, int(jstate.step), jstate.params) if codec else None
        jstate, jm = jstep(jstate, key, shard_tokens(mesh, tokens))
        state, pm = pstep(state, i, torch.from_numpy(tokens).long(), draws=draws)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert pm["msg_bytes"] == int(jm["msg_bytes"])
        assert pm["dense_bytes"] == int(jm["dense_bytes"])
        if code == "svd":  # psum puts the dense mean on the wire
            assert (pm["msg_bytes"] < pm["dense_bytes"]) == (aggregate == "gather")
    pparams, _ = jax_from_state_dict(model)
    atol = 1e-4 if code == "svd" else 1e-5
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0),
        pparams, jax.device_get(jstate.params))


def _run(argv):
    lines = []
    state = cli.main(argv + ["--device", "cpu"], log_fn=lines.append)
    return state, lines


def test_cli_lm_prints_the_jax_line_and_goes_through_the_kernel_wrapper():
    A.reset_launch_counts()
    _, lines = _run(["lm", "--layout", "dp-sp", "--ways", "1", "--attn-impl", "ulysses-flash",
                     "--vocab-size", "16", "--seq-len", "32", "--width", "32", "--depth", "2",
                     "--num-heads", "2", "--batch-size", "4", "--max-steps", "3",
                     "--log-interval", "1", "--code", "svd", "--eval-freq", "3",
                     "--aggregate", "gather"])
    assert A.launch_counts() == {"flash_attention": 0}  # CPU tensors: the plain twin
    lm = [ln for ln in lines if ln.startswith("LM: ")]
    assert len(lm) == 3 and all(LM_LINE.match(ln) for ln in lm), lm
    assert "Layout: dp-sp(dp1xsp1)" in lm[0]
    msg, dense = (float(lm[0].split(f"{k}(MB): ")[1].split(",")[0]) for k in ("Msg", "Dense"))
    assert 0 < msg < dense
    assert any(ln.startswith("--svd-rank auto -> 3 for width 32") for ln in lines)
    assert any(re.match(r"^LM Validation: Step: 3, Loss: \d+\.\d{4}, PPL: \d+\.\d{2}$", ln)
               for ln in lines)


def test_cli_lm_dense_and_data_file(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(bytes(range(256)) * 4)
    _, lines = _run(["lm", "--vocab-size", "256", "--seq-len", "16", "--width", "16",
                     "--depth", "1", "--num-heads", "2", "--batch-size", "4", "--max-steps", "2",
                     "--log-interval", "1", "--code", "sgd", "--data-file", str(corpus)])
    lm = [ln for ln in lines if ln.startswith("LM: ")]
    assert len(lm) == 2 and all(LM_LINE.match(ln) for ln in lm), lm
    assert "Layout: dp(dp1xsp1)" in lm[0]
    msg, dense = (lm[0].split(f"{k}(MB): ")[1].split(",")[0] for k in ("Msg", "Dense"))
    assert msg == dense


@pytest.mark.parametrize("argv,match", [
    (["--layout", "dp-tp"], "--ways 2 does not divide 1 devices"),
    (["--layout", "dp-sp", "--ways", "2"], "does not divide 1 devices"),
])
def test_cli_lm_refuses_what_waits(argv, match):
    with pytest.raises(SystemExit, match=match):
        _run(["lm", "--max-steps", "1"] + argv)


def test_cli_train_svd_prints_the_worker_line():
    _, lines = _run(["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
                     "--batch-size", "16", "--max-steps", "2", "--log-interval", "1",
                     "--eval-freq", "0", "--code", "svd", "--svd-rank", "3"])
    worker = [ln for ln in lines if ln.startswith("Worker: 0, Step: ")]
    assert len(worker) == 2
    assert all(math.isfinite(float(ln.split("Loss: ")[1].split(",")[0])) for ln in worker)
    # the JAX package's wire bytes for LeNet at rank 3, in the column's MiB
    from atomo_tpu.models import get_model as jax_model

    shapes = jax.eval_shape(
        lambda x: jax_model("lenet", 10).init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 28, 28, 1), jnp.float32))["params"]
    msg = sum(JaxSvd(rank=3).leaf_payload_bytes(a.shape)
              for a in jax.tree_util.tree_leaves(shapes)) / 2**20
    assert all(f"Msg(MB): {msg: .4f}," in ln for ln in worker), (msg, worker)
