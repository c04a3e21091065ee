"""The port's optimizers against optax, the JAX package's ``make_optimizer``.

A LeNet-shaped tree of parameters and five steps of gradients, drawn from a
numpy seed (gradients shrinking over the steps, so that AMSGrad's running
maximum of the bias-corrected second moment is not the last value), go
through both packages: the JAX side in its layout, the port's through
``convert``. After every step the parameters agree, and after the last the
optimizer state (count, momentum trace, Adam's moments) through
``convert.opt_state_from_jax`` and ``convert.jax_opt_state``. Both compute in
float32 with the same formulas; the bias corrections and the schedule are
float32 values computed by numpy on one side and XLA on the other, so the
bar is float32 rounding: rtol 2e-6 plus atol 1e-7 of the leaf's largest
entry.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu_torch.convert import jax_from_state_dict, jax_leaf_order, jax_opt_state
from atomo_tpu_torch.convert import opt_state_from_jax
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import SgdState, make_optimizer
from atomo_tpu_torch.training.trainer import leaf_params

STEPS, LR = 5, 0.05
CASES = {
    "sgd": ("sgd", {}),
    "momentum": ("sgd", {"momentum": 0.9}),
    "nesterov": ("sgd", {"momentum": 0.9, "nesterov": True}),
    "momentum_wd": ("sgd", {"momentum": 0.9, "weight_decay": 1e-2}),
    "momentum_shrink": ("sgd", {"momentum": 0.5, "lr_shrinkage": 0.5, "shrinkage_freq": 2}),
    "wd_shrink": ("sgd", {"weight_decay": 1e-2, "lr_shrinkage": 0.5, "shrinkage_freq": 2}),
    "adam": ("adam", {}),
    "amsgrad": ("adam", {"amsgrad": True}),
    "adam_wd": ("adam", {"weight_decay": 1e-2}),
    "amsgrad_wd": ("adam", {"amsgrad": True, "weight_decay": 1e-2}),
    "adam_betas_shrink": ("adam", {"beta1": 0.8, "beta2": 0.99, "eps": 1e-6,
                                   "lr_shrinkage": 0.5, "shrinkage_freq": 2}),
}


def _tree(model, rng, scale=1.0):
    """A port-layout tensor per parameter, by state_dict key."""
    return {n: torch.from_numpy((scale * rng.standard_normal(tuple(p.shape)))
                                .astype(np.float32))
            for n, p in model.named_parameters()}


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7 * max(np.abs(b).max(), 1e-30))


def _run(name, kw, seed=0):
    """Both packages through STEPS steps; returns (port model, port state,
    JAX params, JAX optax state)."""
    rng = np.random.default_rng(seed)
    model = get_model("lenet", 10)
    model.load_state_dict(_tree(model, rng))
    grads = [_tree(model, rng, scale=1.0 / (1 + 3 * s)) for s in range(STEPS)]
    jparams, _ = jax_from_state_dict(model)
    jopt = jax_optimizer(name, lr=LR, **kw)
    jstate = jopt.init(jparams)
    opt = make_optimizer(name, lr=LR, **kw)
    params = leaf_params(model)
    state = opt.init(params)
    order = jax_leaf_order(model)
    for g in grads:
        jg, _ = jax_from_state_dict(model, g)
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state = opt.update([g[n] for n in order], state, params)
        pparams, _ = jax_from_state_dict(model)
        jax.tree_util.tree_map(_close, pparams, jax.device_get(jparams))
    return model, state, jparams, jstate


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_and_state_match_optax(case):
    name, kw = CASES[case]
    model, state, jparams, jstate = _run(name, kw)
    assert state.count == STEPS
    ported = opt_state_from_jax(model, jax.device_get(jstate))
    assert type(ported) is type(state) and ported.count == STEPS
    for f in ("trace", "mu", "nu", "nu_max"):
        ours, theirs = getattr(state, f, None), getattr(ported, f, None)
        assert (ours is None) == (theirs is None), f
        for a, b in zip(ours or [], theirs or []):
            _close(a.numpy(), b.numpy())
    back = jax_opt_state(model, state, jax_optimizer(name, lr=LR, **kw).init(jparams))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.device_get(jstate))
    jax.tree_util.tree_map(_close, back, jax.device_get(jstate))


@pytest.mark.parametrize("case", ["momentum", "amsgrad"])
def test_state_round_trips_through_the_jax_layout(case):
    """port -> optax -> port gives back the same tensors, bit for bit."""
    name, kw = CASES[case]
    model, state, jparams, _ = _run(name, kw, seed=1)
    back = opt_state_from_jax(
        model, jax_opt_state(model, state, jax_optimizer(name, lr=LR, **kw).init(jparams)))
    assert back.count == state.count
    for f in ("trace", "mu", "nu", "nu_max"):
        for a, b in zip(getattr(state, f, None) or [], getattr(back, f, None) or []):
            assert torch.equal(a, b)


def test_jax_opt_state_refuses_a_missing_field():
    model = get_model("lenet", 10)
    jparams, _ = jax_from_state_dict(model)
    with pytest.raises(ValueError, match="no 'trace'"):
        jax_opt_state(model, SgdState(count=0, trace=None),
                      jax_optimizer("sgd", lr=LR, momentum=0.9).init(jparams))


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="expected sgd|adam"):
        make_optimizer("rmsprop")
