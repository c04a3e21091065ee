"""The quality probes (``--obs-quality``) of the port against the JAX package.

* ``quality_probe`` on the same payloads: LeNet's gradient (numpy, seeded)
  encoded by both packages under one key (the port fed the JAX codec's draws
  through the ``draws=`` hook), each package's probe over its own payloads:
  ``q_err2`` and ``q_rel`` within rtol 1e-5 (svd, qsgd), and the dense
  codec's error exactly zero in both.
* ``quality_meta``: the per-layer byte split equal to the JAX dict, key for
  key, for LeNet and ResNet-18 under svd rank 3 and qsgd 4 bits, with a
  hybrid plan's columns, and with ``stream_bucket_bytes``.
* The step: LeNet (batch 16, 3 steps, qsgd 4 bits, the JAX draws) on one
  device against ``make_train_step(track_quality=True)``, and over 2 gloo
  ranks against the JAX dp-2 step for gather, ring and psum and for the
  guarded gather with replica 1 poisoned at step 2 (its error left out of
  the mean): each step's ``q_err2`` and ``q_rel`` within rtol 2e-4, the
  gradients of the two packages differing by float32 rounding (a field the
  difference moves across its uniform moves one level). The superstep
  block of 3 equals the single steps' series bit for bit, and the probe
  changes nothing else: the parameters after each step equal the unarmed
  run's bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_jax as J
from torch_dist import Group

import atomo_tpu.training.resilience as JR
import atomo_tpu.utils.chaos as JC
from atomo_tpu.codecs import DenseCodec as JaxDense
from atomo_tpu.codecs import encode_tree as jax_encode_tree
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.obs import quality as jq
from atomo_tpu.sparse import hybrid as jhybrid
from atomo_tpu.training.trainer import make_train_step as jax_train_step
from atomo_tpu_torch.codecs import DenseCodec, encode_tree, get_codec
from atomo_tpu_torch.convert import jax_layouts, jax_leaf_order, state_dict_from_jax
from atomo_tpu_torch.data import to_device
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.obs import quality as pq
from atomo_tpu_torch.sparse import hybrid as phybrid
from atomo_tpu_torch.training import make_optimizer
from atomo_tpu_torch.training.trainer import TrainState, leaf_params, make_train_step

torch.set_num_threads(1)

STEPS, BATCH, RTOL = 3, 16, 2e-4


def _lenet_grads(seed=0):
    """A LeNet-shaped gradient: (JAX tree, port leaves, port model)."""
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    shapes = jax.eval_shape(lambda: jax_model("lenet", 10).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), train=False))["params"]
    r = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda s: (r.standard_normal(s.shape) * 1e-2).astype(np.float32), shapes)
    sd = state_dict_from_jax(model, tree, {})
    return tree, [sd[n] for n in jax_leaf_order(model)], model


@pytest.mark.parametrize("code", ["svd", "qsgd", "sgd"])
def test_quality_probe_matches_jax_on_the_same_payloads(code):
    tree, grads, model = _lenet_grads()
    key = jax.random.PRNGKey(5)
    jcodec = {"svd": J.CODECS["svd"][1], "qsgd": J.CODECS["qsgd"][1],
              "sgd": JaxDense}[code]()
    # one compiled program (op by op, each leaf compiles its own)
    want = jax.jit(lambda k, t: jq.quality_probe(jcodec, jax_encode_tree(jcodec, k, t)[0], t))(
        key, tree)
    if code == "sgd":
        codec, draws = DenseCodec(), None
    else:
        codec = get_codec(code, **J.CODECS[code][0][1])
        raw = {"svd": J.svd_draws, "qsgd": J.qsgd_draws}[code](key, tree)
        draws = [{k: torch.tensor(v) for k, v in d.items()} if isinstance(d, dict)
                 else torch.tensor(d) for d in raw]
    layouts = jax_layouts(model)
    payloads, _ = encode_tree(codec, 0, grads, draws, layouts)
    got = pq.quality_probe(codec, payloads, grads, layouts)
    for name in ("q_err2", "q_rel"):
        assert got[name].shape == (len(grads),) and got[name].dtype == torch.float32
        if code == "sgd":
            assert not got[name].any() and not np.asarray(want[name]).any()
        else:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5)
            # svd ships the 1-D biases dense: those read exactly 0
            assert (got[name] >= 0).all() and (got[name] > 0).sum() >= 4


def _meta_pair(network, image_shape, code, **kw):
    model = get_model(network, 10, image_shape=image_shape)
    shapes = jax.eval_shape(lambda: jax_model(network, 10).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + image_shape), train=False))["params"]
    if code == "qsgd":
        jc, pc = J.CODECS["qsgd"][1](), get_codec("qsgd", quantization_level=4)
    else:
        jc, pc = J.CODECS["svd"][1](), get_codec("svd", svd_rank=3)
    jkw = dict(kw)
    if "hybrid" in kw:
        jkw["hybrid"], kw["hybrid"] = kw["hybrid"]
    return pq.quality_meta(pc, model, **kw), jq.quality_meta(jc, shapes, **jkw)


@pytest.mark.parametrize("code", ["svd", "qsgd"])
@pytest.mark.parametrize("network,image_shape", [("lenet", (28, 28, 1)),
                                                  ("resnet18", (32, 32, 3))])
def test_quality_meta_equals_the_jax_dict(network, image_shape, code):
    got, want = _meta_pair(network, image_shape, code)
    assert got == want and got["n_layers"] == len(got["layers"])


def test_quality_meta_stream_bucket_bytes_and_hybrid_columns():
    got, want = _meta_pair("lenet", (28, 28, 1), "qsgd", stream_bucket_bytes=4 << 20)
    assert got == want and got["stream_bucket_bytes"] == 4 << 20
    # one plan, in each package's type: leaf 5 (Dense_0's kernel) sparse
    rows = []
    for i, name in enumerate(pq.quality_meta(get_codec("qsgd"), get_model(
            "lenet", 10, image_shape=(28, 28, 1)))["layers"]):
        sparse = i == 5
        rows.append(dict(index=i, name=name["name"], shape=tuple(name["shape"]),
                         kind="sparse" if sparse else "dense",
                         density=0.125 if sparse else 1.0, row_budget=64 if sparse else 0,
                         dense_bytes=name["dense_bytes"],
                         codec_payload_bytes=name["payload_bytes"],
                         payload_bytes=64 * (500 * 4 + 4) + 4 if sparse else name["payload_bytes"],
                         reason="test"))
    plans = (phybrid.HybridPlan(tuple(phybrid.LeafAssignment(**r) for r in rows)),
             jhybrid.HybridPlan(tuple(jhybrid.LeafAssignment(**r) for r in rows)))
    got, want = _meta_pair("lenet", (28, 28, 1), "qsgd", hybrid=plans)
    assert got == want
    assert got["layers"][5]["assignment"] == "sparse" and got["layers"][5]["row_budget"] == 64
    short = phybrid.HybridPlan(plans[0].assignments[:3])
    with pytest.raises(ValueError, match="plan and tree must match"):
        pq.quality_meta(get_codec("qsgd"), get_model("lenet", 10, image_shape=(28, 28, 1)),
                        hybrid=short)


@pytest.fixture(scope="module")
def ref():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


def test_single_device_series_match_the_jax_step(ref):
    """``make_train_step(track_quality=True)`` on one device, the JAX
    step's uniforms fed through the hook."""
    jstep = jax_train_step(ref.jmodel, ref.jopt, codec=J.CODECS["qsgd"][1](),
                           track_quality=True)
    jstate = jax.tree_util.tree_map(jnp.asarray, jax.device_get(ref.jstate))
    model = get_model("lenet", 10, image_shape=ref.image_shape)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ref.state_dict.items()})
    opt = make_optimizer("sgd", lr=J.LR, momentum=J.MOMENTUM)
    state = TrainState(step=0, model=model, opt_state=opt.init(leaf_params(model)))
    pstep = make_train_step(model, opt, codec=get_codec("qsgd", quantization_level=J.BITS),
                            track_quality=True)
    key = jax.random.PRNGKey(9)
    for s, (x, y) in enumerate(ref.batches):
        k_codec = jax.random.split(jax.random.fold_in(key, s), 3)[2]
        uniforms = [torch.tensor(u) for u in J.qsgd_draws(k_codec, jstate.params)]
        jstate, jm = jstep(jstate, key, jnp.asarray(x), jnp.asarray(y))
        state, pm = pstep(state, 9, *to_device(x, y, "cpu"), uniforms=uniforms)
        for name in ("q_err2", "q_rel"):
            assert pm[name].shape == (8,)
            np.testing.assert_allclose(pm[name].numpy(), np.asarray(jm[name]), rtol=RTOL)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


_CHAOS = []


def _guard_modes():
    if not _CHAOS:
        cfg = dataclasses.replace(JC.ChaosConfig.from_spec("nan@2", environ={}),
                                  target_replica=1)
        _CHAOS.append(JC.ChaosInjector(cfg, membership_epoch=0))
    return dict(guard=JR.GuardConfig(0.0), chaos=_CHAOS[0])


def _series(answers, name):
    return [s[name] for s in answers[0]["steps"]]


@pytest.mark.parametrize("aggregate,guarded", [("gather", False), ("ring", False),
                                               ("psum", False), ("gather", True)],
                         ids=["gather", "ring", "psum", "gather-guarded"])
def test_gloo2_series_match_the_jax_step(group, ref, aggregate, guarded):
    modes = _guard_modes() if guarded else {}
    out, per_rank = ref.run_ranks("qsgd", aggregate, 2, track_quality=True, **modes)
    extra = dict(guard=0.0, chaos="nan@2", target_replica=1) if guarded else {}
    answers = group.run("train", per_rank=per_rank, track_quality=True,
                        **ref.job("qsgd", aggregate, **extra))
    J.assert_parity(ref, out, answers, "qsgd")
    for name in ("q_err2", "q_rel"):
        got = np.asarray(_series(answers, name))
        want = np.stack([o[name] for o in out])
        assert got.shape == want.shape == (STEPS, 8)
        assert np.isfinite(got).all()  # the poisoned replica's NaN error is left out
        np.testing.assert_allclose(got, want, rtol=RTOL)
    if guarded:
        assert [s["dropped"] for s in answers[0]["steps"]] == [0.0, 1.0, 0.0]


def test_block_and_off_equal_the_armed_single_steps(group, ref):
    """The block of 3 carries the (3, L) series (each step's equal to the
    single steps' bit for bit); the unarmed run's states equal the armed
    run's after every step."""
    _, per_rank = ref.run_ranks("qsgd", "gather", 2)
    job = ref.job("qsgd", "gather")
    armed = group.run("train", per_rank=per_rank, track_quality=True, **job)
    block = group.run("train", per_rank=per_rank, track_quality=True, parts=[STEPS], **job)
    off = group.run("train", per_rank=per_rank, **job)
    for name in ("q_err2", "q_rel"):
        assert _series(block, name) == _series(armed, name)
        assert _series(off, name) == [None] * STEPS
    assert [s["hash"] for s in off[0]["steps"]] == [s["hash"] for s in armed[0]["steps"]]
    assert block[0]["steps"][-1]["hash"] == armed[0]["steps"][-1]["hash"]
    assert [s["loss"] for s in block[0]["steps"]] == [s["loss"] for s in armed[0]["steps"]]
