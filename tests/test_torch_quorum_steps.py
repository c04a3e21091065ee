"""The quorum step over N gloo ranks against the JAX package's dp-N quorum step.

LeNet on synthetic MNIST from a Flax init (and, for the BatchNorm
statistics, a DenseNet-BC of depth 10), each rank fed its replica's JAX
codec draws (:mod:`torch_dist`), ``quorum=`` at N 2 and 4, gather and
ring, qsgd 4 bits and svd rank 3, K 1 and 2, with a hand-written arrival
schedule of 7 steps (the ring wraps): present, stale (up to K),
dropped and absent entries, a corrupted entry past the bound, one step
where every entry is dropped (``kept == 0``: the step holds). With the
guard armed, chaos ``nan@3`` poisons replica 1's step-3 gradient, whose
slot a later step consumes stale (its flag rides the ring and masks it).

After every step: every rank's state hashes alike (replicas bit for bit);
``dropped``, ``quorum_kept``, ``stale_dropped`` and ``skipped`` equal the
JAX step's exactly, and so do the ring's slot flags; the loss within rtol
1e-5; the parameters, the momentum trace, the BatchNorm statistics and the
ring's decoded slots (the JAX ring converted to the port's bytes and back
exactly) within the tolerances of every cross-package parity
test here (``torch_dist_jax.assert_parity``: float32 convolutions summed in
other orders, plus one quantization level times lr a step for QSGD, whose
fields may move a level where the gradients' float-level difference crosses
a uniform). The bit-for-bit equalities of the operator itself (the same
payloads in, the same mean out) are ``test_torch_quorum_units.py``'s.

Beside them, in the port alone: with every payload arriving on time
(sigma all zero) the quorum step equals the guarded ``survivor_exact=True``
blocking step bit for bit (gather and ring), and the step factory's
refusals equal the JAX step factory's texts.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_dist_jax as J
from torch_dist import Groups

from atomo_tpu.quorum import QuorumConfig as JQuorumConfig
from atomo_tpu.quorum.schedule import ABSENT, DROPPED
from atomo_tpu_torch.codecs import decode_tree, encode_tree, get_codec
from atomo_tpu_torch.convert import jax_layouts, jax_quorum_ring, quorum_ring_from_jax
from atomo_tpu_torch.parallel.common import pack_spec, unpack_tree_buckets
from atomo_tpu_torch.training.trainer import leaf_params
import atomo_tpu.training.resilience as JR
import atomo_tpu.utils.chaos as JC

SPEC, MAXN, TARGET = "nan@3", 100.0, 1
BATCH = 16
A, D = ABSENT, DROPPED

# per (N, K): 7 steps of arrivals (1-based step s is row s - 1; K + 3 at least)
SCHEDULES = {
    (2, 1): [[0, 0], [0, A], [1, 0], [0, 1], [D, D], [1, 0], [0, 1]],
    (2, 2): [[0, 0], [A, 0], [2, 0], [0, 1], [D, D], [0, 2], [1, 4]],
    (4, 1): [[0, 0, 0, 0], [0, A, 0, 0], [1, 0, D, 0], [0, 1, 0, 1], [D, D, D, D],
             [1, 0, 0, 7], [0, 0, 1, 0]],
    (4, 2): [[0, 0, 0, 0], [0, A, A, 0], [2, 0, D, 1], [0, 1, 2, 0], [D, D, D, D],
             [1, 2, 0, 0], [0, 0, 1, 2]],
}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = Groups(tmp_path_factory, "quorum")
    yield gs
    gs.close()


@pytest.fixture(scope="module")
def lenet():
    return J.Reference("lenet", "mnist", BATCH, 7)


def _arrivals(n, k):
    return tuple(tuple(r) for r in SCHEDULES[n, k])


_CHAOS = []


def _jax_modes(n, k, guard):
    """The JAX step's quorum, arrivals and (with ``guard``) guard and chaos
    (one injector object, so that the reference's run cache serves every
    case alike)."""
    modes = {}
    if guard:
        if not _CHAOS:
            cfg = dataclasses.replace(JC.ChaosConfig.from_spec(SPEC, environ={}),
                                      target_replica=TARGET)
            _CHAOS.append(JC.ChaosInjector(cfg, membership_epoch=0))
        modes = dict(guard=JR.GuardConfig(MAXN), chaos=_CHAOS[0])
    return dict(modes, quorum=JQuorumConfig(1, staleness=k), arrivals=_arrivals(n, k))


def _ring_values(codec_spec, ring, spec, like):
    """Every (rank, slot) of a gathered ring decoded by the port's codec
    (the JAX package's slots converted to the port's bytes first)."""
    codec = get_codec(codec_spec[0], **codec_spec[1])
    n, depth = ring["ring"].shape[:2]
    rows = torch.as_tensor(ring["ring"]).reshape(n * depth, -1)
    out = []
    for i in range(n * depth):
        payloads = unpack_tree_buckets(rows[i], spec)
        out.append(torch.cat([v.reshape(-1) for v in decode_tree(codec, payloads, like[0],
                                                                 like[1])]))
    return torch.stack(out).numpy()


def _ring_layout(model, codec):
    """(the port's layout of one ring row, the decode's leaves and layouts)."""
    leaves = [p.detach() for p in leaf_params(model)]
    payloads, _ = encode_tree(codec, 0, leaves, None, jax_layouts(model))
    return pack_spec(payloads), ([torch.zeros_like(p) for p in leaves], jax_layouts(model))


def quorum_case(groups, ref, code, aggregate, n, k, guard=True):
    """The port's quorum ranks against the JAX quorum step, step by step."""
    out, per_rank = ref.run_ranks(code, aggregate, n, **_jax_modes(n, k, guard))
    args = ref.job(code, aggregate, quorum=(1, k), arrivals=[list(r) for r in _arrivals(n, k)],
                   per_step=True)
    if guard:
        args.update(guard=MAXN, chaos=SPEC, target_replica=TARGET)
    answers = groups[n].run("train", per_rank=per_rank, **args)
    levels = {"qsgd": (1 << J.BITS) - 1}.get(code)
    max_step = max(a["max_scale"] for a in answers) / levels if levels else 0.0
    codec_spec = J.CODECS[code][0]
    spec, like = _ring_layout(ref.port_model, get_codec(codec_spec[0], **codec_spec[1]))
    for s, want in enumerate(out):
        got = answers[0]["steps"][s]
        assert len({a["steps"][s]["hash"] for a in answers}) == 1, f"step {s + 1}: replicas differ"
        for key in ("dropped", "quorum_kept", "stale_dropped", "skipped"):
            assert got[key] == want[key], (s + 1, key, got[key], want[key])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["msg_bytes"] == want["msg_bytes"]
        np.testing.assert_array_equal(got["ring"]["ring_ok"], want["ring_ok"])
        atol = 1e-5 + J.LR * max_step * (s + 1)
        p_got, b_got = ref.port_trees(got["state_dict"])
        for a, b in zip(jax.tree_util.tree_leaves(p_got), jax.tree_util.tree_leaves(
                want["params"])):
            np.testing.assert_allclose(a, np.asarray(b), atol=atol)
        for a, b in zip(jax.tree_util.tree_leaves(b_got), jax.tree_util.tree_leaves(
                want["batch_stats"])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
        trace = _jax_trace(ref, want["opt_state"])
        np.testing.assert_allclose(got["opt"]["trace"], trace, atol=atol / J.LR)
        jring = quorum_ring_from_jax(want["ring"], want["ring_ok"], spec)
        back, back_ok = jax_quorum_ring(jring, spec)  # and back, exactly
        assert all(a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()
                   for a, b in zip(back, want["ring"]))
        assert np.array_equal(back_ok, want["ring_ok"])
        # a decoded slot is a gradient (not lr-scaled): float32 reconstructions
        # of values up to ~5 agree to 1e-4 a step taken (svd: the factors
        # of a gradient whose inputs drifted as the parameters did); qsgd,
        # to one level more.
        # Only the healthy slots: an unhealthy one is never read, and the
        # port's svd encodes a poisoned gradient with its non-finite entries
        # zeroed (torch's eigh refuses them) where XLA's carries NaN
        live = want["ring_ok"].reshape(-1) > 0
        np.testing.assert_allclose(_ring_values(codec_spec, got["ring"], spec, like)[live],
                                   _ring_values(codec_spec, jring, spec, like)[live],
                                   atol=1e-4 * (s + 1) + max_step * 1.0001, rtol=1e-4)
    return out, answers


def _jax_trace(ref, opt_state):
    from atomo_tpu_torch.convert import opt_state_from_jax

    st = opt_state_from_jax(ref.port_model, opt_state)
    return torch.cat([t.reshape(-1) for t in st.trace]).numpy()


@pytest.fixture(scope="module")
def densenet():
    return J.Reference(("DenseNet", {"growth_rate": 4, "depth": 10}), "cifar10", 4, 7)


# each factor at both levels, and every pair of (codec, aggregate) and of
# (N, K): the BatchNorm statistics on the DenseNet case, the hold without
# the guard on the last
@pytest.mark.parametrize("network,code,aggregate,n,k,guard", [
    ("densenet", "qsgd", "gather", 2, 1, True), ("lenet", "svd", "ring", 2, 2, True),
    ("lenet", "qsgd", "ring", 4, 2, True), ("lenet", "svd", "gather", 4, 1, True),
    ("lenet", "qsgd", "gather", 2, 2, False)])
def test_quorum_steps_match_jax(groups, request, network, code, aggregate, n, k, guard):
    out, answers = quorum_case(groups, request.getfixturevalue(network), code, aggregate, n,
                               k, guard)
    sched = SCHEDULES[n, k]
    kept = [o["quorum_kept"] for o in out]
    assert kept[4] == 0.0 and out[4]["skipped"] == 1.0  # every entry dropped: held
    assert kept[0] == float(n)
    assert [o["stale_dropped"] for o in out] == [float(sum(v == D for v in r))
                                                 for r in sched[:len(out)]]
    # the held step leaves the state (parameters and statistics) as it was;
    # the step after it moves them
    assert answers[0]["steps"][4]["hash"] == answers[0]["steps"][3]["hash"]
    assert answers[0]["steps"][5]["hash"] != answers[0]["steps"][4]["hash"]


@pytest.mark.parametrize("aggregate", ["gather", "ring"])
@pytest.mark.parametrize("code", ["qsgd", "svd"])
def test_all_arrived_equals_the_survivor_blocking_step(groups, lenet, code, aggregate):
    """sigma all zero: every rank's state after each step equals the guarded
    ``survivor_exact=True`` blocking step's bit for bit (chaos ``nan@3``
    masks replica 1 in both), and the wire is the same."""
    n = 2
    args = lenet.job(code, aggregate, guard=MAXN, chaos=SPEC, target_replica=TARGET)
    quorum = groups[n].run("train", quorum=(n, 1), arrivals=[[0] * n] * 7, **args)
    blocking = groups[n].run("train", survivor_exact=True, **args)
    for q, b in zip(quorum, blocking):
        assert [s["hash"] for s in q["steps"]] == [s["hash"] for s in b["steps"]]
        assert [s["msg_bytes"] for s in q["steps"]] == [s["msg_bytes"] for s in b["steps"]]
        assert [s["dropped"] for s in q["steps"]] == [s["dropped"] for s in b["steps"]]
    assert [s["quorum_kept"] for s in quorum[0]["steps"]] == [2, 2, 1, 2, 2, 2, 2]


@pytest.mark.parametrize("code,aggregate", [("qsgd", "gather"), ("svd", "ring")])
def test_survivor_exact_blocking_step_matches_jax(groups, lenet, code, aggregate):
    """``survivor_exact=True`` on the guarded blocking step against the JAX
    package's (chaos ``nan@3`` on replica 1: step 3's mean is the
    survivor's alone, one division), at ``assert_parity``'s tolerances."""
    modes = _jax_modes(2, 1, True)
    del modes["quorum"], modes["arrivals"]
    out, per_rank = lenet.run_ranks(code, aggregate, 2, survivor_exact=True, **modes)
    answers = groups[2].run("train", per_rank=per_rank, survivor_exact=True,
                            **lenet.job(code, aggregate, guard=MAXN, chaos=SPEC,
                                        target_replica=TARGET))
    J.assert_parity(lenet, out, answers, code)
    assert [s["dropped"] for s in answers[0]["steps"]] == [o["dropped"] for o in out]
    assert out[2]["dropped"] == 1.0


def _jax_build_error(code, n, **kw):
    from atomo_tpu.models import get_model
    from atomo_tpu.parallel import make_distributed_train_step, make_mesh
    from atomo_tpu.training import make_optimizer

    codec = J.CODECS[code][1]()
    try:
        make_distributed_train_step(get_model("lenet", 10), make_optimizer("sgd"),
                                    make_mesh(n_devices=n), codec,
                                    aggregate=kw.pop("aggregate", "gather"), **kw)
    except ValueError as e:
        return str(e)
    return None


BUILD_CASES = {
    "dense": ("sgd", {}),
    "psum": ("qsgd", {"aggregate": "psum"}),
    "range": ("qsgd", {"quorum_q": 3}),
    "delayed": ("qsgd", {"overlap": "delayed"}),
    "error_feedback": ("qsgd", {"error_feedback": True}),
    "survivor_exact": ("qsgd", {"survivor_exact": True}),
    "num_aggregate": ("qsgd", {"num_aggregate": 1}),
    "superstep": ("qsgd", {"superstep": 2}),
    "stream_encode": ("qsgd", {"stream_encode": True}),
    "track_quality": ("qsgd", {"track_quality": True}),
    "ring_ok": ("qsgd", {"aggregate": "ring"}),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_step_factory_refusals_are_the_jax_texts(groups, case):
    """Every quorum refusal of the step factory, word for word the JAX
    step factory's (the conflict matrix of ``tests/test_quorum.py``), and
    the clean ring build refused by neither."""
    from atomo_tpu_torch.quorum import QuorumConfig

    code, kw = BUILD_CASES[case]
    kw = dict(kw)
    q = kw.pop("quorum_q", 2)
    want = _jax_build_error(code, 2, quorum=JQuorumConfig(q, staleness=1), **kw)
    got = groups[2].run("build", network="lenet", image_shape=(28, 28, 1),
                        codec=J.CODECS[code][0],
                        kwargs=dict(kw, quorum=QuorumConfig(q, staleness=1)))
    assert got[0] == want
    assert (want is None) == (case == "ring_ok")


@pytest.mark.parametrize("partition", ["zero1", "sharded-update"])
def test_step_factory_refuses_the_partitions_as_jax(groups, partition):
    from atomo_tpu_torch.quorum import QuorumConfig

    got = groups[2].run("partition_build", network="lenet", image_shape=(28, 28, 1),
                        codec=J.CODECS["qsgd"][0], partition=partition,
                        kwargs={"quorum": QuorumConfig(2, staleness=1)})
    assert got[0] == ("quorum= does not compose with sharded-update/ZeRO-1 "
                      "yet: the staleness ring is untested against the sharded "
                      "state templates — run the replicated update")
