"""The topology layer (``atomo_tpu_torch/topology/``) against the JAX
package's, without ranks.

* The plan space: ``PLAN_NAMES``, ``plan_from_name`` (and its errors),
  ``enumerate_plans``, ``dense_outer_wins`` and ``plan_wire_bytes`` equal
  JAX's exactly; ``predict_plan_step_s`` and ``choose_plan`` (its reason
  string included) equal JAX's on a ``TwoTierFabric`` built with the same
  explicit fields in both packages and the same compute and tax figures
  (each package's default anchors are its own hardware's).
* ``resolve_two_tier``'s grammar on the port's tokens (``auto`` is NVLink
  inside a host and the 400 Gb/s NIC across hosts) and the JAX texts of its
  errors; ``MeshSpec.from_world`` against JAX's ``shape_dict``/``describe``.
* The keys: the sentinels are JAX's, the outer key is one per group, the
  inner key one per card, the streams disjoint.
* The host reference ``two_level_mean_host`` equals JAX's for each of the
  5 plans x {qsgd 4 bits, svd rank 3} given the JAX draws, within one
  quantization level a stage for QSGD (a field may move a level where the
  two programs' float-level difference crosses a uniform) and for SVD 1e-5
  of the leaf's largest entry after one stage, 2e-4 after two; and the boundary re-encode is unbiased by Monte Carlo for each codec
  (the JAX test's bounds, ``tests/test_topology.py:273-345``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_jax as J

import atomo_tpu.topology as JT
from atomo_tpu.mesh.spec import MeshSpec as JMeshSpec
from atomo_tpu.topology import execute as JE
from atomo_tpu.topology import schedule as JS
from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.mesh.spec import MeshSpec
from atomo_tpu_torch.topology import execute as PE
from atomo_tpu_torch.topology import fabric as PF
from atomo_tpu_torch.topology import schedule as PS

torch.set_num_threads(1)

# every field explicit: the packages' default latency anchors differ (the
# JAX package's are TPU estimates, the port's NVLink and NIC ones)
FIELDS = [
    dict(inner_bw=45e9, outer_bw=1.25e9, inner_ways=2, outer_ways=2,
         inner_latency_s=1e-6, outer_latency_s=25e-6),
    dict(inner_bw=450e9, outer_bw=50e9, inner_ways=4, outer_ways=2,
         inner_latency_s=3e-6, outer_latency_s=15e-6),
    dict(inner_bw=10e9, outer_bw=10e9, inner_ways=8, outer_ways=4,
         inner_latency_s=1e-6, outer_latency_s=25e-6),
    dict(inner_bw=2e9, outer_bw=0.1e9, inner_ways=1, outer_ways=8,
         inner_latency_s=0.0, outer_latency_s=1e-4),
]
BUDGETS = [(44.7e6, 7.6e6), (1.72e6, 0.29e6), (44.7e6, 40e6), (4.4e7, 0.0), (1e6, 1e6)]


def _fabrics(f):
    kw = dict(f, inner_label="nvlink", outer_label="dcn")
    return PF.TwoTierFabric(**kw), JT.TwoTierFabric(**kw)


# ------------------------------------------------------------ plan space


def test_plan_space_equals_jax():
    assert PS.PLAN_NAMES == JS.PLAN_NAMES
    assert (PS.INNER_PRIMITIVES, PS.OUTER_PRIMITIVES) == (JS.INNER_PRIMITIVES,
                                                          JS.OUTER_PRIMITIVES)
    assert [p.name for p in PS.enumerate_plans()] == [p.name for p in JS.enumerate_plans()]
    assert [p.name for p in PS.enumerate_plans(["cring+ring", "legacy"])] == \
        [p.name for p in JS.enumerate_plans(["cring+ring", "legacy"])]
    for name in PS.PLAN_NAMES + ("legacy",):
        p, j = PS.plan_from_name(name), JS.plan_from_name(name)
        assert (p.name, p.is_legacy, p.reencodes) == (j.name, j.is_legacy, j.reencodes)
    assert PS.LEGACY_PLAN.name == JS.LEGACY_PLAN.name == "psum+gather"


@pytest.mark.parametrize("name", ["warp+drive", "nope", "psum+psum", "cring+", "+gather"])
def test_plan_from_name_errors_equal_jax(name):
    with pytest.raises(ValueError) as want:
        JS.plan_from_name(name)
    with pytest.raises(ValueError) as got:
        PS.plan_from_name(name)
    assert str(got.value) == str(want.value)


def test_wire_bytes_and_dense_switch_equal_jax():
    for f in FIELDS:
        pf, jf = _fabrics(f)
        for dense, payload in BUDGETS:
            for name in PS.PLAN_NAMES:
                assert PS.plan_wire_bytes(PS.plan_from_name(name), dense_bytes=dense,
                                          payload_bytes=payload, fabric=pf) == \
                    JS.plan_wire_bytes(JS.plan_from_name(name), dense_bytes=dense,
                                       payload_bytes=payload, fabric=jf)
            for k in (1, 2, 3, 8):
                assert PS.dense_outer_wins(payload, dense, k) == \
                    JS.dense_outer_wins(payload, dense, k)


@pytest.mark.parametrize("fi", range(len(FIELDS)))
def test_predict_and_choose_plan_equal_jax(fi):
    pf, jf = _fabrics(FIELDS[fi])
    for dense, payload in BUDGETS:
        for compute_s, tax_s in ((0.03, 0.0349), (0.0065, 0.0025), (0.0, 0.0)):
            kw = dict(dense_bytes=dense, payload_bytes=payload, compute_s=compute_s,
                      tax_s=tax_s)
            for name in PS.PLAN_NAMES:
                assert PS.predict_plan_step_s(PS.plan_from_name(name), fabric=pf, **kw) == \
                    JS.predict_plan_step_s(JS.plan_from_name(name), fabric=jf, **kw)
            (pp, pr), (jp, jr) = (PS.choose_plan(fabric=pf, **kw),
                                  JS.choose_plan(fabric=jf, **kw))
            assert (pp.name, pr) == (jp.name, jr)
            (pp, pr), (jp, jr) = (PS.choose_plan(fabric=pf, plan_names=("cring+ring",), **kw),
                                  JS.choose_plan(fabric=jf, plan_names=("cring+ring",), **kw))
            assert (pp.name, pr) == (jp.name, jr)


def test_recommend_two_tier_equals_jax():
    pf, jf = _fabrics(FIELDS[0])
    kw = dict(codec_budgets={"dense": (44.7e6, 0), "svd3": (44.7e6, 0.6e6),
                             "qsgd4": (44.7e6, 7.6e6)},
              measured_ms={"dense": 30.1, "svd3": 65.0, "qsgd4": 40.0})
    assert PS.recommend_two_tier(fabric=pf, **kw) == JS.recommend_two_tier(fabric=jf, **kw)


def test_compute_anchor_is_the_cards():
    """The planner's compute estimate: the card's ResNet-18 sgd step (30.1
    ms for its 44,695,848 gradient bytes), linear in the gradient size."""
    from atomo_tpu_torch.utils import comm_model as PC

    assert PC.estimate_compute_s(PC._TAX_ANCHOR_BYTES) == pytest.approx(30.1e-3)
    assert PC.estimate_compute_s(PC._TAX_ANCHOR_BYTES / 2) == pytest.approx(15.05e-3)
    plan = PS.plan_from_name("psum+gather")
    pf, _ = _fabrics(FIELDS[0])
    w = PS.plan_wire_bytes(plan, dense_bytes=PC._TAX_ANCHOR_BYTES, payload_bytes=7.6e6,
                           fabric=pf)
    # the defaults: compute and one codec round trip (the boundary re-encode)
    assert PS.predict_plan_step_s(plan, dense_bytes=PC._TAX_ANCHOR_BYTES, payload_bytes=7.6e6,
                                  fabric=pf) == pytest.approx(
        30.1e-3 + 34.9e-3 + pf.tier_time_s(w["inner_bytes"], "inner", w["inner_hops"])
        + pf.tier_time_s(w["outer_bytes"], "outer", w["outer_hops"]))


# -------------------------------------------------------------- fabrics


@pytest.mark.parametrize("token,want", [
    ("auto", (450e9, 50e9, "nvlink", "dcn")),
    ("dcn", (450e9, 50e9, "nvlink", "dcn")),
    ("eth10g", (450e9, 1.25e9, "nvlink", "eth10g")),
    ("45:1.25", (45e9, 1.25e9, "45GBps", "1.25GBps")),
    ("ici:eth10g", (450e9, 1.25e9, "ici", "eth10g")),
    ("nvlink:3", (450e9, 3e9, "nvlink", "3GBps")),
])
def test_resolve_two_tier_grammar(token, want):
    f = PF.resolve_two_tier(token, dcn_ways=2, n_dev=4)
    assert (f.inner_bw, f.outer_bw, f.inner_label, f.outer_label) == want
    assert (f.inner_ways, f.outer_ways) == (2, 2)
    assert (f.inner_latency_s, f.outer_latency_s) == (PF.NVLINK_HOP_LATENCY_S,
                                                      PF.NIC_HOP_LATENCY_S)
    if ":" in token and token[0].isdigit():  # the numeric form is the JAX package's too
        j = JT.resolve_two_tier(token, dcn_ways=2, n_dev=4)
        assert (j.inner_bw, j.outer_bw, j.inner_label, j.outer_label) == want
        assert f.describe() == j.describe()


@pytest.mark.parametrize("token,k,n", [("auto", 3, 4), ("auto", 1, 4), ("auto", 8, 4),
                                       (":dcn", 2, 4), ("ici:", 2, 4), ("measured", 2, 4)])
def test_resolve_two_tier_errors_are_the_jax_texts(token, k, n):
    with pytest.raises(ValueError) as want:
        JT.resolve_two_tier(token, dcn_ways=k, n_dev=n)
    with pytest.raises(ValueError) as got:
        PF.resolve_two_tier(token, dcn_ways=k, n_dev=n)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("token,bad", [("nope", "nope"), ("ici:-3", "-3"),
                                       ("x:dcn", "x")])
def test_resolve_two_tier_bad_token_is_resolve_fabrics_error(token, bad):
    """A bad tier token raises the one parser's error (the port's list of
    presets: its FABRICS are the card's)."""
    from atomo_tpu_torch.utils.comm_model import resolve_fabric

    with pytest.raises(ValueError) as want:
        resolve_fabric(bad)
    with pytest.raises(ValueError) as got:
        PF.resolve_two_tier(token, dcn_ways=2, n_dev=4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,k", [(1, 0), (4, 0), (4, 1), (4, 2), (4, 4), (8, 2), (6, 3)])
def test_mesh_from_world_equals_jax(n, k):
    p, j = MeshSpec.from_world(n, k), JMeshSpec.from_world(n, k)
    assert (p.shape_dict(), p.describe(), p.data_axes, p.inner_axis, p.is_two_tier,
            p.n_devices) == (j.shape_dict(), j.describe(), j.data_axes, j.inner_axis,
                             j.is_two_tier, j.n_devices)
    assert MeshSpec.from_shape_dict(p.shape_dict()) == p


@pytest.mark.parametrize("n,k", [(4, 3), (4, 8), (0, 2)])
def test_mesh_from_world_errors_are_the_jax_texts(n, k):
    with pytest.raises(ValueError) as want:
        JMeshSpec.from_world(n, k)
    with pytest.raises(ValueError) as got:
        MeshSpec.from_world(n, k)
    assert str(got.value) == str(want.value)
    assert MeshSpec.from_shape_dict({}) is None and MeshSpec.from_shape_dict("x") is None
    assert MeshSpec.from_shape_dict({"dp": "two"}) is None


def test_two_tier_positions_are_the_jax_row_major_order():
    spec = MeshSpec.from_world(8, 2)
    assert [spec.position(r) for r in range(8)] == [(r // 4, r % 4) for r in range(8)]
    assert spec.describe() == "dp2xici4"


# ------------------------------------------------------------------ keys


def test_key_sentinels_and_streams():
    assert (PE.OUTER_KEY_SENTINEL, PE.INNER_KEY_SENTINEL) == (JE.OUTER_KEY_SENTINEL,
                                                              JE.INNER_KEY_SENTINEL)
    step_key = 12345
    outer = [PE.outer_codec_key(step_key, o) for o in range(4)]
    inner = [PE.inner_codec_key(step_key, c) for c in range(8)]
    assert len(set(outer)) == 4 and len(set(inner)) == 8
    assert not set(outer) & set(inner)
    assert PE.split_draws(None) == (None, None)
    assert PE.split_draws([1]) == (None, [1])
    assert PE.split_draws({"inner": [2], "outer": [3]}) == ([2], [3])


# ------------------------------------------------------ host reference

N_OUTER = N_INNER = 2
QSGD_BITS, SVD_RANK = 4, 3


def _trees(seed: int = 3):
    """Per card a JAX-layout tree (dict: leaves in key order bias, conv, fc)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for c in range(N_OUTER * N_INNER):
        kr = jax.random.fold_in(key, c)
        out.append({"bias": np.asarray(jax.random.normal(jax.random.fold_in(kr, 0), (8,))),
                     "conv": np.asarray(jax.random.normal(jax.random.fold_in(kr, 1),
                                                          (5, 5, 1, 8))),
                     "fc": np.asarray(jax.random.normal(jax.random.fold_in(kr, 2), (33, 17)))})
    return out


def _codecs(cname):
    from atomo_tpu.codecs import QsgdCodec, SvdCodec

    if cname == "qsgd":
        return (get_codec("qsgd", quantization_level=QSGD_BITS), QsgdCodec(bits=QSGD_BITS),
                lambda k, t: J.qsgd_draws(k, t))
    return (get_codec("svd", svd_rank=SVD_RANK), SvdCodec(rank=SVD_RANK),
            lambda k, t: J.svd_draws(k, t, SVD_RANK))


@pytest.mark.parametrize("cname", ["qsgd", "svd"])
@pytest.mark.parametrize("pname", list(PS.PLAN_NAMES))
def test_host_reference_equals_jax(cname, pname):
    pcodec, jcodec, draw = _codecs(cname)
    trees = _trees()
    step_key = jax.random.PRNGKey(11)
    want = JT.two_level_mean_host(jcodec, JS.plan_from_name(pname),
                                  [{k: jnp.asarray(v) for k, v in t.items()} for t in trees],
                                  step_key, n_outer=N_OUTER, n_inner=N_INNER)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    inner = [draw(JE.inner_codec_key(step_key, c), trees[c]) for c in range(len(trees))]
    outer = [draw(JE.outer_codec_key(step_key, o), trees[0]) for o in range(N_OUTER)]
    from torch_dist import _draws

    draws = {"inner": [_draws(d) for d in inner], "outer": [_draws(d) for d in outer]}
    leaves = [[torch.from_numpy(t[k].copy()) for k in ("bias", "conv", "fc")] for t in trees]
    got = PE.two_level_mean_host(pcodec, PS.plan_from_name(pname), leaves, 11,
                                 n_outer=N_OUTER, n_inner=N_INNER, layouts=[False] * 3,
                                 draws=draws, device="cpu")
    assert len(got) == len(want)
    plan = PS.plan_from_name(pname)
    stages = (plan.inner == "cring") + plan.reencodes
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if cname == "qsgd":
            # one level of the largest bucket scale a compressing stage
            scale = max(float(np.abs(np.stack([t[k] for t in trees])).max())
                        for k in ("bias", "conv", "fc"))
            atol = 1e-5 + stages * scale / ((1 << QSGD_BITS) - 1)
        else:
            # 1e-5 of the leaf's largest entry after one SVD stage (the
            # decode tolerance of tests/test_torch_svd.py); 2e-4 after two:
            # the boundary SVD factors an input that already differs at the
            # float32 level, and its singular vectors move by that
            # difference over the spectral gap
            atol = (1e-5 if stages == 1 else 2e-4) * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("cname", ["svd", "qsgd"])
def test_boundary_reencode_unbiased_monte_carlo(cname):
    """E over key draws of the two-level mean (both stages compressing,
    ``cring+ring``) is the true global mean: the average over 512 keys is
    within 0.12 of the largest entry and below 0.35 of one draw's error,
    the JAX test's bounds (an estimator biased at the boundary would leave a
    floor the averaging cannot remove)."""
    codec = (get_codec("qsgd", quantization_level=2, bucket_size=128) if cname == "qsgd"
             else get_codec("svd", svd_rank=2))
    gen = torch.Generator().manual_seed(0)
    trees = [[torch.randn(8, 6, generator=gen)] for _ in range(N_OUTER * N_INNER)]
    true_mean = torch.stack([t[0] for t in trees]).mean(0)
    plan = PS.plan_from_name("cring+ring")
    draws = torch.stack([PE.two_level_mean_host(codec, plan, trees, 1000 + i, n_outer=N_OUTER,
                                                n_inner=N_INNER, layouts=[False],
                                                device="cpu")[0] for i in range(512)])
    est = draws.mean(0)
    err_single = float((draws[0] - true_mean).abs().max())
    err_mc = float((est - true_mean).abs().max())
    scale = float(true_mean.abs().max())
    assert err_mc < 0.12 * scale, (err_mc, scale)
    assert err_mc < 0.35 * max(err_single, 1e-9), (err_mc, err_single)


def test_host_reference_refuses_the_cpu_fallback_and_bad_shapes():
    codec = get_codec("qsgd", quantization_level=4)
    trees = [[torch.zeros(4)] for _ in range(4)]
    with pytest.raises(ValueError, match="2x2 mesh"):
        PE.two_level_mean_host(codec, PS.LEGACY_PLAN, trees[:3], 0, n_outer=2, n_inner=2,
                               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PE.two_level_mean_host(codec, PS.LEGACY_PLAN, trees, 0, n_outer=2, n_inner=2)
