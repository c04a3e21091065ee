"""The sp axis of the port over gloo ranks against the JAX package's: the
(dp, sp) process groups, the ring hop and the all-to-all with their
gradients, the shard-boundary targets, and the sequence-parallel attention
functions alone, forward and backward (CPU, float32).

The attention cases run ``ring``, ``ulysses`` and ``ulysses-flash`` (the
JAX flash kernel in interpret mode, the port's plain twin) at sp = 2 and 4
on (2, 4, 32, 8) inputs drawn with numpy, the JAX side through
``make_sequence_parallel_attention`` on the forced CPU mesh and
``jax.grad`` of the output against a fixed cotangent. Tolerances: outputs
atol 2e-5 and gradients atol 5e-5, those of ``tests/test_torch_attention.py``
(float32 sums in other orders). The collectives and the groups are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist import Group

from atomo_tpu.mesh.spec import MeshSpec
from atomo_tpu.parallel import make_mesh
from atomo_tpu.parallel import ring as jring
from atomo_tpu.parallel.lm import sp_boundary_targets_and_mask as jax_targets
from atomo_tpu_torch.parallel import launch
from atomo_tpu_torch.parallel import ring as pring

SHAPE = (2, 4, 32, 8)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {n: Group(n, tmp_path_factory.mktemp(f"spgloo{n}")) for n in (2, 4)}
    yield gs
    for g in gs.values():
        g.close()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _jax_attention(impl, sp, q, k, v, w, causal):
    mesh = make_mesh(sp, axes=(("sp", sp),))
    fn = jring.make_sequence_parallel_attention(mesh, "sp", causal=causal, impl=impl)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * w)

    out = fn(q, k, v)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses", "ulysses-flash"])
def test_sp_attention_matches_jax(groups, impl, sp):
    q, k, v, w = _inputs()
    want, want_grads = _jax_attention(impl, sp, q, k, v, w, causal=True)
    answers = groups[sp].run("attention", impl=impl, q=q, k=k, v=v, cotangent=w)
    got = np.concatenate([a["out"] for a in answers], axis=2)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    for i, wg in enumerate(want_grads):
        g = np.concatenate([a["grads"][i] for a in answers], axis=2)
        np.testing.assert_allclose(g, wg, atol=5e-5, rtol=0)


def test_ring_attention_without_the_causal_mask_matches_jax(groups):
    q, k, v, w = _inputs(seed=1)
    want, want_grads = _jax_attention("ring", 2, q, k, v, w, causal=False)
    answers = groups[2].run("attention", impl="ring", q=q, k=k, v=v, cotangent=w, causal=False)
    np.testing.assert_allclose(np.concatenate([a["out"] for a in answers], axis=2), want,
                               atol=2e-5, rtol=0)
    for i, wg in enumerate(want_grads):
        np.testing.assert_allclose(np.concatenate([a["grads"][i] for a in answers], axis=2),
                                   wg, atol=5e-5, rtol=0)


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_mesh_groups_follow_the_jax_device_order(groups, sp):
    """Rank r sits where ``MeshSpec.from_layout('dp-sp', 4, sp)`` puts
    device r; its sp group is its mesh row, its dp group its column."""
    answers = groups[4].run("mesh", n_sp=sp)
    devices = MeshSpec.from_layout("dp-sp", 4, sp).build().devices  # (dp, sp) array
    ids = np.vectorize(lambda d: d.id)(devices)
    for r, a in enumerate(answers):
        d, s = (int(x[0]) for x in np.nonzero(ids == r))
        assert tuple(a["position"]) == (d, s) == launch.mesh_position(r, sp)
        assert a["sp"] == sorted(ids[d].tolist()) and a["dp"] == sorted(ids[:, s].tolist())
        assert a["describe"] == f"dp{4 // sp}xsp{sp}"


@pytest.mark.parametrize("sp", [2, 4])
def test_shard_boundary_targets_match_jax(groups, sp):
    """The next shard's first token arrives over one ring hop; only the
    last shard masks its final column. Against the JAX function under
    ``shard_map``, exactly."""
    toks = np.random.default_rng(3).integers(0, 16, size=(3, 16)).astype(np.int32)
    mesh = make_mesh(sp, axes=(("sp", sp),))
    spec = jax.sharding.PartitionSpec(None, "sp")
    fn = jax.jit(jax.shard_map(lambda t: jax_targets(t, "sp", sp), mesh=mesh, in_specs=spec,
                               out_specs=(spec, spec), check_vma=False))
    want_t, want_v = (np.asarray(a) for a in fn(jnp.asarray(toks)))
    answers = groups[sp].run("targets", tokens=toks)
    got_t = np.concatenate([a["targets"] for a in answers], axis=1)
    got_v = np.concatenate([a["valid"] for a in answers], axis=1)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_v, want_v)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_hop_and_all_to_all_carry_their_gradients(groups, sp):
    """A hop sends rank i's tensor to i - 1 and its backward the cotangent
    to i + 1; the all-to-all's backward is the all-to-all of the
    cotangent. Exact."""
    answers = groups[sp].run("collectives")
    for r, a in enumerate(answers):
        assert a["hop"] == float((r + 1) % sp)  # rank r holds its right neighbour's
        assert a["hop_grad"] == float(10 * ((r - 1) % sp))  # the cotangent of r - 1
        assert a["a2a"] == [float(10 * i + r) for i in range(sp)]
        assert a["a2a_grad"] == [float(100 * i + r) for i in range(sp)]


def test_ulysses_refuses_heads_the_axis_does_not_divide():
    t = torch.zeros((1, 3, 8, 4))
    with pytest.raises(ValueError, match="divisible"):
        pring.ulysses_attention(t, t, t, axis_name="sp", axis_size=2)


def test_the_workers_load_no_jax(groups):
    """The workers import the port only: neither JAX nor the JAX package
    reaches them after every job of this file."""
    for mods in groups[4].run("modules") + groups[2].run("modules"):
        bad = sorted(set(mods) & {"jax", "jaxlib", "flax", "optax", "atomo_tpu"})
        assert not bad, bad
