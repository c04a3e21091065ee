"""The port's mesh grammar and model-axis collectives.

``MeshSpec.from_layout``, ``layout_name``, ``describe``, ``model_axes`` and
``n_devices`` equal the JAX package's for every layout and way count, and
every refusal is the same ``ValueError`` with the same message. On 4 gloo
ranks: ``build()`` places rank r at its row-major position and gives each
axis the ranks of its line (``(dp, sp)`` exactly as ``dp_sp_mesh``); the
pipeline hop sends i -> i+1 and its backward i+1 -> i (at 4 ranks the
opposite rotation from the ring hop is visible); Megatron's ``copy_to``
(identity, all-reduce backward) and ``reduce_from`` (all-reduce, identity
backward); ``pmax`` without a gradient; and the tiled all-to-all against
its definition, forward and backward. All exact.
"""

import numpy as np
import pytest
from torch_dist import Group

from atomo_tpu.mesh.spec import MeshSpec as JaxSpec
from atomo_tpu_torch.mesh.collectives import pipeline_perm, ring_perm
from atomo_tpu_torch.mesh.spec import LAYOUT_MODEL_AXES, MODEL_AXES, MeshSpec

LAYOUTS = sorted(LAYOUT_MODEL_AXES)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(4, tmp_path_factory.mktemp("meshspec4"))
    yield g
    g.close()


def _same(fn):
    try:
        want = fn(JaxSpec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn(MeshSpec)
        assert str(got.value) == str(e)
        return None
    got = fn(MeshSpec)
    assert got == want
    return got


def test_grammar_constants_equal_jax():
    from atomo_tpu.mesh import spec as js

    assert MODEL_AXES == js.MODEL_AXES and LAYOUT_MODEL_AXES == js.LAYOUT_MODEL_AXES
    assert pipeline_perm(4) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    assert ring_perm(4) == [(0, 3), (1, 0), (2, 1), (3, 2)]


@pytest.mark.parametrize("layout", LAYOUTS + ["dp-xx"])
@pytest.mark.parametrize("n", [0, 1, 2, 4, 6, 8])
def test_from_layout_and_renderers_equal_jax(layout, n):
    for ways in ([1, 2, 3, 4, 0, -1] if layout != "dp-tp-sp"
                 else [(1, 1), (2, 2), (1, 4), (3, 2), (2, 0), 2]):
        def render(cls):
            s = cls.from_layout(layout, n, ways)
            return (s.axes, s.describe(), s.n_devices, s.model_axes)

        if _same(render) is None:
            continue
        _same(lambda cls: cls.from_layout(layout, n, ways).layout_name())


@pytest.mark.parametrize("axes", [(), (("dp", 2), ("dp", 2)), (("dp", 0),),
                                  (("dp", 2), ("ici", 2)), (("dp", 1), ("tp", 2), ("ep", 2))])
def test_construction_errors_and_layout_name_equal_jax(axes):
    _same(lambda cls: cls(axes).layout_name())


@pytest.mark.parametrize("axes", [
    (("dp", 2), ("sp", 2)), (("dp", 1), ("tp", 2), ("sp", 2)), (("dp", 2), ("ep", 2)),
    (("dp", 4), ("pp", 1)), (("dp", 1), ("pp", 4))])
def test_build_places_ranks_row_major(group, axes):
    answers = group.run("mesh_spec", axes=list(axes))
    spec = MeshSpec(axes)
    sizes = [s for _, s in axes]
    for r, a in enumerate(answers):
        coords = tuple(int(c) for c in np.unravel_index(r, sizes))
        assert tuple(a["coords"]) == coords == spec.position(r)
        assert a["describe"] == JaxSpec(axes).describe()
        for k, ranks in enumerate(a["groups"]):
            want = [spec.rank_of(coords[:k] + (c,) + coords[k + 1:]) for c in range(sizes[k])]
            assert ranks == want


def test_model_axis_collectives(group):
    answers = group.run("model_collectives")
    n = 4
    for r, a in enumerate(answers):
        assert a["hop"] == (r - 1) % n  # pipeline_perm: from i - 1
        assert a["hop_grad"] == 10.0 * ((r + 1) % n)  # backward: from i + 1
        total = sum(1.0 + q for q in range(n))
        assert a["copy"] == (1.0 + r) * (r + 1)
        assert a["copy_grad"] == sum(q + 1 for q in range(n))  # all-reduced cotangent
        assert a["reduce"] == total * (r + 1)
        assert a["reduce_grad"] == r + 1  # identity backward
        assert a["pmax"] == n - 1 and a["psum"] == sum(range(n))
    src = [100.0 * q + np.arange(2.0 * n * 3).reshape(2, n, 3) for q in range(n)]
    cot = [np.full((2, 1, 3 * n), float(q)) + np.arange(2.0 * 3 * n).reshape(2, 1, 3 * n)
           for q in range(n)]
    for r, a in enumerate(answers):
        # chunk r of every source's axis 1, concatenated along axis 2 in source order
        np.testing.assert_array_equal(a["a2a"], np.concatenate(
            [s[:, r:r + 1] for s in src], axis=2))
        # backward: rank r's chunk j of axis 1 gets rank j's cotangent block r
        np.testing.assert_array_equal(a["a2a_grad"], np.concatenate(
            [c[:, :, 3 * r:3 * r + 3] for c in cot], axis=1))
