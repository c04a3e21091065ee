"""ZeRO-1 and the sharded update over 2 gloo ranks against the port's own
replicated step, bit for bit.

LeNet on synthetic MNIST (global batch 16, 3 steps) from one seeded port
init: for qsgd gather, qsgd ring, svd gather and dense psum, with momentum
SGD and with Adam, each partition's every step (loss, the materialized
parameters' hash on every rank), its final parameters, its optimizer state
(the flat slices gathered, trimmed of padding) and its count equal the
replicated run's exactly. The same holds with every composition the step
takes (``grad_accum``, ``stream_encode``, ``num_aggregate``, mixed precision,
the quality probes, superstep blocks, the guard, ``overlap='delayed'`` on
gather and ring; ZeRO-1 with the hybrid exchange on the embedding tower).
Under the sharded update each rank's persistent state is below
replicated/(N - 0.5) (``test_mesh.py:347-363``'s bar), ZeRO-1's between.
The guard holds both partitions' slices through the starred all-bad step.
The step factory's refusals carry the JAX package's messages.
"""

import numpy as np
import pytest
import torch
import torch_dist_jax as J
from torch_dist import Group

from atomo_tpu_torch.data import BatchIterator, zipf_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training.trainer import init_params

STEPS, BATCH, N = 3, 16, 2
CODECS = {"qsgd": ("qsgd", {"quantization_level": 4}), "svd": ("svd", {"svd_rank": 3}),
          "sgd": None}
OPTS = {"momentum": ("sgd", {"lr": 0.01, "momentum": 0.9}), "adam": ("adam", {"lr": 0.001})}
PARTS = ["zero1", "sharded-update"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(N, tmp_path_factory.mktemp("gloo_part"))
    yield g
    g.close()


def _start(network, image_shape, batches):
    model = get_model(network, 10, image_shape=image_shape)
    init_params(model, 0)
    return dict(network=network, num_classes=10, image_shape=image_shape,
                state_dict={k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
                num_aggregate=0, ring_bucket_size=65536, lr=J.LR, momentum=J.MOMENTUM,
                batches=batches, key=11)


LENET = _start("lenet", (28, 28, 1), J.batches("mnist", BATCH, STEPS))
_RUNS: dict = {}


def run(group, code, aggregate, opt="momentum", partition="replicated", start=None, **kw):
    """Every rank's answer of the ``train`` job (cached by arguments)."""
    key = (code, aggregate, opt, partition, start is None,
           tuple(sorted((k, repr(v)) for k, v in kw.items())))
    if key not in _RUNS:
        args = dict(start or LENET, codec=CODECS[code], aggregate=aggregate,
                    optimizer=OPTS[opt], partition=partition, **kw)
        _RUNS[key] = group.run("train", **args)
    return _RUNS[key]


def assert_same(got, want):
    """Two runs of every rank equal bit for bit: losses, each step's state
    hash, the final parameters, the optimizer state and its count."""
    for g, w in zip(got, want):
        assert [s["loss"] for s in g["steps"]] == [s["loss"] for s in w["steps"]]
        assert [s["hash"] for s in g["steps"]] == [s["hash"] for s in w["steps"]]
        assert g["count"] == w["count"]
        assert sorted(g["opt"]) == sorted(w["opt"])
        for k in g["opt"]:
            assert np.array_equal(g["opt"][k], w["opt"][k]), k
    for k, v in want[0]["state_dict"].items():
        assert np.array_equal(got[0]["state_dict"][k], v), k


@pytest.mark.parametrize("partition", PARTS)
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("code,aggregate", [("qsgd", "gather"), ("qsgd", "ring"),
                                            ("svd", "gather"), ("sgd", "psum")])
def test_partition_equals_replicated(group, code, aggregate, opt, partition):
    assert_same(run(group, code, aggregate, opt, partition),
                run(group, code, aggregate, opt))


def test_sharded_rank_state_shrinks(group):
    """Persistent bytes a rank (parameters or master slice, optimizer
    buffers, statistics) between steps: sharded < replicated / (N - 0.5),
    ZeRO-1 in between."""
    rep, z1, su = (run(group, "qsgd", "gather", "momentum", p)
                   for p in ("replicated", "zero1", "sharded-update"))
    for r in range(N):
        b = [a[r]["steps"][-1]["state_bytes"] for a in (rep, z1, su)]
        assert b[2] < b[0] / (N - 0.5) and b[2] < b[1] < b[0], b


COMPOSE = {
    "grad_accum": dict(grad_accum=2),
    "stream_encode": dict(stream_encode=True, stream_bucket_bytes=1 << 16),
    "num_aggregate": dict(num_aggregate=1),
    "bf16": dict(bf16=True),
    "quality": dict(track_quality=True),
    "superstep": dict(parts=[2, 1]),
}


@pytest.mark.parametrize("partition", PARTS)
@pytest.mark.parametrize("mode", sorted(COMPOSE))
def test_partition_composes(group, mode, partition):
    got = run(group, "qsgd", "gather", "momentum", partition, **COMPOSE[mode])
    want = run(group, "qsgd", "gather", "momentum", **COMPOSE[mode])
    assert_same(got, want)
    if mode == "quality":
        assert got[0]["steps"][-1]["q_err2"] == want[0]["steps"][-1]["q_err2"]
    if mode == "superstep":  # the blocks equal the single steps
        single = run(group, "qsgd", "gather", "momentum", partition)
        assert got[0]["steps"][-1]["hash"] == single[0]["steps"][-1]["hash"]


@pytest.mark.parametrize("partition", PARTS)
def test_guard_holds_the_slices(group, partition):
    """``nan@2`` on rank 1 drops its contribution (the survivor's mean
    rescaled), ``inf@3*`` drops every rank and holds the state: the
    parameters after step 3 equal those after step 2, and the whole run
    equals the replicated guarded run bit for bit (optimizer slices held
    through the skip included)."""
    kw = dict(guard=100.0, chaos="nan@2,inf@3*", target_replica=1)
    got = run(group, "qsgd", "gather", "momentum", partition, **kw)
    assert_same(got, run(group, "qsgd", "gather", "momentum", **kw))
    steps = got[0]["steps"]
    assert [(s["dropped"], s["skipped"]) for s in steps] == [(0.0, 0.0), (1.0, 0.0),
                                                             (2.0, 1.0)]
    assert steps[2]["hash"] == steps[1]["hash"]


@pytest.mark.parametrize("partition", PARTS)
@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_delayed_equals_replicated_delayed(group, aggregate, partition):
    kw = dict(overlap="delayed")
    got = run(group, "qsgd", aggregate, "momentum", partition, **kw)
    assert_same(got, run(group, "qsgd", aggregate, "momentum", **kw))
    assert got[0]["steps"][0]["skipped"] == 1.0


def test_hybrid_with_zero1_equals_replicated(group):
    """The sparse-row exchange on the embedding tower (zipf batches) under
    ZeRO-1 equals the replicated hybrid run bit for bit."""
    from atomo_tpu_torch.codecs import QsgdCodec
    from atomo_tpu_torch.sparse import plan_for_model

    slots = 8
    it = BatchIterator(zipf_dataset(True, size=BATCH * 2, seed=3), BATCH, seed=3).forever()
    batches = [next(it) for _ in range(2)]
    start = _start("embedding", (slots,), batches)
    model = get_model("embedding", 10, image_shape=(slots,))
    sd = {k: torch.from_numpy(v) for k, v in start["state_dict"].items()}
    plan = plan_for_model(QsgdCodec(bits=4), model, *batches[0], BATCH // N, slots,
                          state_dict=sd)
    assert plan.sparse_idxs
    got = run(group, "qsgd", "gather", "momentum", "zero1", start=start, hybrid=plan)
    assert_same(got, run(group, "qsgd", "gather", "momentum", start=start, hybrid=plan))
    with pytest.raises(AssertionError, match="sharded_update does not compose with hybrid="):
        run(group, "qsgd", "gather", "momentum", "sharded-update", start=start, hybrid=plan)


@pytest.mark.parametrize("partition,kwargs,with_zero1,match", [
    ("sharded-update", {}, True, "sharded_update supersedes zero1"),
    ("zero1", {"error_feedback": True}, False, "error_feedback does not compose with zero1/"),
    ("sharded-update", {"error_feedback": True}, False,
     "error_feedback does not compose with zero1/sharded-update yet"),
    ("sharded-update", {"overlap": "delayed", "_oracle_parts": True}, False,
     "the oracle and phase programs drive the replicated update"),
], ids=["both", "ef-zero1", "ef-sharded", "oracle"])
def test_step_factory_refusals(group, partition, kwargs, with_zero1, match):
    msgs = group.run("partition_build", network="lenet", image_shape=(28, 28, 1),
                     codec=CODECS["qsgd"], partition=partition, kwargs=kwargs,
                     with_zero1=with_zero1)
    assert msgs[0] is not None and match in msgs[0], msgs
