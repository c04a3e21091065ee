"""The port's LM step on a dp x sp mesh of gloo ranks against the JAX
package's dp-sp step (CPU, float32 unless said).

Each case runs the JAX step (``build_model_axis_program`` on the forced CPU
mesh, :mod:`torch_dist_lm_jax`) and the port's ranks (:mod:`torch_dist`'s
``lm`` job, in a group of 2 or 4 workers) for 3 steps from the same Flax
init and token batches, the port's codec fed the draws the JAX codec makes
for its replica. The mesh sizes dp x sp are 1x2, 2x1, 2x2 and 1x4; each
attention (``ring``, ``ulysses``, ``ulysses-flash``: the JAX flash kernel in
interpret mode, the port's plain twin), each codec (``sgd``, ``svd``,
``qsgd``) and each aggregate (``gather``, ``psum``, ``ring``, the ring held
against the reference's ring) appears on both sides of the sp axis.

Tolerances. Every rank's parameters equal bit for bit after each step
(replicas and sequence shards alike); ``msg_bytes`` and ``dense_bytes``
exactly equal. Loss rtol 1e-5. Parameters after 3 steps at lr 0.1: atol
2e-5 with ``sgd`` (float32 sums over shards in other orders), 1e-4 with
``svd`` (as ``tests/test_torch_lm.py``: the factorisation's float32
differences), and for ``qsgd`` 2e-5 plus one quantization step (the largest
scale / levels) times lr for a level that moved on any step, carried by
momentum (``torch_dist_lm_jax.quantization_atol``).

Beside them: the gradient the dp tail receives at sp = 2 and 4 against the
unsharded one (no stray factor n_sp, see ``parallel/lm.py``), ``--bf16``
for 2 steps against the JAX step with ``compute_dtype=jnp.bfloat16``, and
``--optimizer adam``.

This file runs the cases on 2 ranks; ``test_torch_lm_dist_steps4.py`` runs
the same tests on 4 (a file a group, so that the two balance over test
workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_dist_lm_jax as L
from torch_dist import Groups

from atomo_tpu.models.transformer import TransformerLM as FlaxLM
from atomo_tpu_torch.convert import jax_layouts, jax_view
from atomo_tpu_torch.models.transformer import TransformerLM
from atomo_tpu_torch.parallel.lm import sp_boundary_targets_and_mask
from atomo_tpu_torch.training.trainer import leaf_params


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = Groups(tmp_path_factory, "lmgloo")
    yield gs
    gs.close()


@pytest.fixture(scope="module")
def start():
    params = L.flax_params()
    return params, L.port_state_dict(params)


def _run(groups, start, dp, sp, impl, code, aggregate, **kw):
    params, sd = start
    n = dp * sp
    out, final, draws = L.run(n, sp, impl, code, aggregate, params=params,
                              compute_dtype=jnp.bfloat16 if kw.get("bf16") else None,
                              **{k: v for k, v in kw.items() if k != "bf16"})
    answers = groups[n].run("lm", per_rank=[{"draws": d} for d in draws],
                            **L.job(sp, impl, code, aggregate, state_dict=sd, **kw))
    assert [a["mesh"] for a in answers] == [(r // sp, r % sp) for r in range(n)]
    return out, final, answers


CASES = [  # (dp, sp, attention, codec, aggregate)
    (1, 2, "ring", "sgd", "gather"),
    (1, 2, "ulysses-flash", "svd", "gather"),
    (1, 2, "ulysses", "qsgd", "psum"),
    (2, 1, "ring", "svd", "ring"),
    (2, 1, "ring", "qsgd", "gather"),
    (2, 2, "ulysses", "svd", "psum"),
    (2, 2, "ulysses-flash", "qsgd", "ring"),
    (2, 2, "ring", "svd", "gather"),
    (1, 4, "ring", "qsgd", "ring"),
    (1, 4, "ulysses-flash", "sgd", "psum"),
    (1, 4, "ulysses", "svd", "gather"),
]


def cases(world: int) -> list:
    """The cases on ``world`` ranks, as ``parametrize`` takes them."""
    return [pytest.param(*c, id="x".join(map(str, c[:2])) + "-" + "-".join(c[2:]))
            for c in CASES if c[0] * c[1] == world]


@pytest.mark.parametrize("dp,sp,impl,code,aggregate", cases(2))
def test_lm_steps_match_jax(groups, start, dp, sp, impl, code, aggregate):
    out, final, answers = _run(groups, start, dp, sp, impl, code, aggregate)
    atol = {"sgd": 2e-5, "svd": 1e-4, "qsgd": 2e-5}[code]
    atol += L.quantization_atol(answers, code, L.STEPS)
    L.assert_parity(out, final, answers, loss_rtol=1e-5, atol=atol)
    if code != "sgd":  # psum puts the dense mean on the wire
        msg, dense = out[0]["msg_bytes"], out[0]["dense_bytes"]
        assert (msg < dense) == (aggregate != "psum")


def _unsharded_grads(params, tokens):
    """The gradient of the global loss of the JAX package's own unsharded
    model: mean next-token cross-entropy with the final column masked."""
    model = FlaxLM(**L.CFG)
    targets, valid = (t.numpy() for t in sp_boundary_targets_and_mask(
        torch.from_numpy(tokens).long()))

    def loss_fn(p):
        ce = optax.softmax_cross_entropy_with_integer_labels(model.apply({"params": p},
                                                                         tokens), targets)
        return jnp.sum(ce * valid) / jnp.sum(valid)

    return jax.tree_util.tree_leaves(jax.grad(loss_fn)(params))


@pytest.mark.parametrize("sp", [2])
def test_sp_gradient_has_no_stray_factor(groups, start, sp):
    """The gradient the dp tail receives on every rank at sp = 2 and 4
    equals the unsharded model's gradient of the same loss (atol 1e-6,
    rtol 1e-4), not n_sp times it; the ring's ranks agree bit for bit."""
    params, sd = start
    job = L.job(sp, "ring", "sgd", "gather", state_dict=sd, steps=1)
    answers = groups[sp].run("lm", grads_only=True, **job)
    want = _unsharded_grads(params, job["batches"][0])
    for a in answers:
        for g, w in zip(a["grads"], answers[0]["grads"]):
            np.testing.assert_array_equal(g, w)
    model = TransformerLM(**L.CFG)
    got = [jax_view(torch.from_numpy(g), tr).numpy()
           for g, tr in zip(answers[0]["grads"], jax_layouts(model))]
    assert len(got) == len(want) == len(leaf_params(model))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
