"""The LM layouts' families in one process against the JAX package.

From the JAX package's own init of each family's tree (numpy, seeded):

* ``lm_params_to_tp`` / ``tp_params_to_lm`` equal the JAX reshapes and
  round-trip exactly; the tp specs shard what the JAX ``tp_param_specs``
  shards;
* ``tp_lm_forward`` on the whole tp tree equals the JAX ``tp_lm_forward``
  and the stock LM on the equivalent stock tree, and ``tp_sharded_ce_terms``
  at one shard equals optax's cross-entropy (atol 2e-5 on logits of order
  one, float32);
* ``moe_mlp`` equals the JAX layer (output and aux loss, and the gradient
  of a loss through it), with a capacity that keeps every token and one
  that drops most of them: the port scatters and gathers the kept tokens
  where the JAX package multiplies one-hot tensors, the same function
  (float64 on both sides, rtol 1e-10; the aux loss rtol 1e-6 and the
  router's gradient rtol 1e-5, since both take the router's softmax in
  float32);
* ``moe_lm_forward``, ``pp_lm_forward_reference`` and each family's oracle
  forward (``model_axes.oracle_logits``) equal their JAX twins (float32,
  atol 2e-5);
* one step of each family at model ways 1 gives the loss of its oracle
  forward on the same parameters and tokens (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_dist_jax as J
import torch_dist_lm_jax as L

from atomo_tpu.models.transformer import TransformerLM as FlaxLM
from atomo_tpu.parallel import moe as jmoe
from atomo_tpu.parallel import pp as jpp
from atomo_tpu.parallel import tp as jtp
from atomo_tpu_torch.mesh.spec import MeshSpec
from atomo_tpu_torch.parallel import model_axes as MA
from atomo_tpu_torch.parallel import moe, pp, tp
from atomo_tpu_torch.parallel.common import map_tree
from atomo_tpu_torch.training import make_optimizer

torch.set_num_threads(1)


def _t(tree, dtype=torch.float32):
    return map_tree(lambda a: torch.tensor(np.asarray(a), dtype=dtype), tree)


def _tokens(cfg, batch=4, seed=5):
    return np.random.default_rng(seed).integers(0, cfg["vocab_size"],
                                                size=(batch, cfg["max_len"]))


def test_tp_relayout_round_trip_equals_jax():
    cfg = L.layout_cfg("dp-tp")
    stock = L.flax_params(cfg)
    want = jtp.lm_params_to_tp(stock, cfg["num_heads"])
    got = tp.lm_params_to_tp(jax.tree_util.tree_map(np.asarray, stock), cfg["num_heads"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    back = tp.tp_params_to_lm(got, cfg["num_heads"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, stock)
    back_t = tp.tp_params_to_lm(_t(got), cfg["num_heads"])
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                           back_t, stock)
    # the port shards the dimension the JAX spec names for the tp axis
    specs = tp.tp_param_specs(got)
    jspecs = jtp.tp_param_specs(want)
    jax.tree_util.tree_map(
        lambda d, s: (d is None and all(a is None for a in s)) or s[d] == "tp" or
        pytest.fail(f"{d} {s}"), specs, jspecs, is_leaf=lambda x: x is None)


def test_tp_forward_and_sharded_ce_equal_jax():
    cfg = L.layout_cfg("dp-tp")
    full = L.family_params("dp-tp")
    toks = _tokens(cfg)
    want = np.asarray(jtp.tp_lm_forward(full, jnp.asarray(toks)))
    got = tp.tp_lm_forward(_t(full), torch.from_numpy(toks)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    stock = np.asarray(FlaxLM(**cfg).apply({"params": jtp.tp_params_to_lm(
        full, cfg["num_heads"])}, jnp.asarray(toks)))
    np.testing.assert_allclose(got, stock, atol=2e-5, rtol=0)
    ce = tp.tp_sharded_ce_terms(torch.from_numpy(got[:, :-1]), torch.from_numpy(toks[:, 1:]))
    np.testing.assert_allclose(ce.numpy(), np.asarray(
        optax.softmax_cross_entropy_with_integer_labels(got[:, :-1], toks[:, 1:])), atol=2e-6)


@pytest.mark.parametrize("capacity", [64, 3])
def test_moe_mlp_equals_jax_in_float64(capacity):
    """Capacity 64 keeps all 32 tokens; 3 keeps at most 3 an expert (of 4)
    and drops the rest."""
    cfg = L.layout_cfg("dp-ep")
    full = L.family_params("dp-ep")
    bp = full["block1"]
    x = np.random.default_rng(3).standard_normal((32, cfg["width"]))
    with J.jax_x64(True):
        jbp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), bp)

        def jloss(p, xx):
            out, aux = jmoe.moe_mlp(p, xx, capacity=capacity)
            return jnp.sum(out ** 2) + aux, (out, aux)

        (jl, (jout, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(
            jbp, jnp.asarray(x, jnp.float64))
        jout, jaux, jg = np.asarray(jout), float(jaux), jax.tree_util.tree_map(np.asarray, jg)
    tbp = _t(bp, torch.float64)
    for v in jax.tree_util.tree_leaves(tbp):
        v.requires_grad_()
    out, aux = moe.moe_mlp(tbp, torch.from_numpy(x), capacity=capacity)
    ((out ** 2).sum() + aux).backward()
    kept = np.any(out.detach().numpy() != 0, axis=1).sum()
    assert (kept == 32) == (capacity == 64) and kept > 0
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-10, atol=1e-12)
    # the router's softmax runs in float32 in both packages, whatever the input
    np.testing.assert_allclose(float(aux.detach()), jaux, rtol=1e-6)
    for k in ("up", "down"):
        np.testing.assert_allclose(tbp[k]["kernel"].grad.numpy(), jg[k]["kernel"], rtol=1e-9,
                                   atol=1e-12)
    # the router's gradient passes through that float32 softmax
    np.testing.assert_allclose(tbp["router"]["kernel"].grad.numpy(), jg["router"]["kernel"],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("layout", ["dp-tp", "dp-ep", "dp-pp", "dp-tp-sp"])
def test_family_oracle_forwards_equal_jax(layout):
    cfg = L.layout_cfg(layout)
    full = L.family_params(layout)
    toks = _tokens(cfg)
    jt = jnp.asarray(toks)
    cap = moe.expert_capacity(toks.size, cfg.get("num_experts", 1))
    if layout == "dp-ep":
        want, aux = jmoe.moe_lm_forward(full, jt, cfg, capacity=cap)
        got, taux = moe.moe_lm_forward(_t(full), torch.from_numpy(toks), cfg, capacity=cap)
        np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)
    elif layout == "dp-pp":
        want = jpp.pp_lm_forward_reference(full, jt, cfg)
        got = pp.pp_lm_forward_reference(_t(full), torch.from_numpy(toks), cfg)
    else:
        want = FlaxLM(**cfg).apply({"params": jtp.tp_params_to_lm(full, cfg["num_heads"])}, jt)
        got = MA.oracle_logits(layout, _t(full), torch.from_numpy(toks), cfg, capacity=cap)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("layout", ["dp-tp", "dp-ep", "dp-pp", "dp-tp-sp"])
def test_one_step_loss_is_the_oracle_loss(layout):
    cfg = L.layout_cfg(layout)
    full = L.family_params(layout)
    toks = _tokens(cfg)
    spec = MeshSpec.from_layout(layout, 1, (1, 1) if layout == "dp-tp-sp" else 1)
    prog = MA.build_model_axis_program(spec, cfg, make_optimizer("sgd", lr=0.1), 0, None,
                                       layout=layout, params=full, device="cpu")
    cap = moe.expert_capacity(toks.size, cfg.get("num_experts", 1))
    t = torch.from_numpy(toks)
    with torch.no_grad():
        logits = MA.oracle_logits(layout, _t(full), t, cfg, capacity=cap)
        want = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, cfg["vocab_size"]),
                                                 t[:, 1:].reshape(-1))
        if layout == "dp-ep":  # the step adds the aux loss, weight 0.01
            want = want + 0.01 * moe.moe_lm_forward(_t(full), t, cfg, capacity=cap)[1]
    _, m = prog.step(prog.state, 1, t)
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-6)
