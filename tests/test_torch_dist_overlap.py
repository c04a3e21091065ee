"""``overlap='delayed'`` over 2 and 4 gloo ranks against the JAX package.

LeNet on synthetic MNIST (global batch 16, 3 steps) from the weights of a
Flax init: the port's ranks (:mod:`torch_dist`) run
``make_distributed_train_step(overlap="delayed")`` from
``init_delayed_state``, each rank fed its replica's JAX draws; the JAX
package runs its delayed dp-N step (``overlap="delayed"`` from its
``init_delayed_state``) on N of the conftest's forced CPU devices. The
tolerances are ``torch_dist_jax.assert_parity``'s (replicas bit for bit
after every step, loss rtol 1e-5, ``msg_bytes`` exact, parameters atol 1e-5
plus one 4-bit quantization step times lr a step); ``skipped`` is the JAX
step's exactly (1, then 0), and step 0 applies nothing: every rank's
parameters and buffers hash as they did before it (the BatchNorm case is in
``test_torch_dist_stream.py``). Within the port, bit for bit: stream-encode on the produce side changes nothing, a run
cut after step 2 and resumed from its checkpoint (every rank's in-flight
payload in it) equals the straight run, and the K = 3 block (the eager
block on the CPU) equals the single steps.
"""

import pytest
import torch_dist_jax as J
from torch_dist import Group

STEPS, BATCH = 3, 16
DELAYED = {"overlap": "delayed"}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {n: Group(n, tmp_path_factory.mktemp(f"gloo{n}")) for n in (2, 4)}
    yield gs
    for g in gs.values():
        g.close()


@pytest.fixture(scope="module")
def ref():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


def _skips(out, answers):
    assert [s["skipped"] for s in out] == [1.0] + [0.0] * (len(out) - 1)
    for a in answers:
        assert [s["skipped"] for s in a["steps"]] == [s["skipped"] for s in out]
        assert a["steps"][0]["hash"] == a["hash0"]  # step 0 held everything


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_delayed_steps_equal_the_jax_delayed_step(groups, ref, aggregate, n):
    out, per_rank = ref.run_ranks("qsgd", aggregate, n, **DELAYED)
    answers = groups[n].run("train", per_rank=per_rank, **ref.job("qsgd", aggregate, **DELAYED))
    J.assert_parity(ref, out, answers, "qsgd")
    _skips(out, answers)


def test_num_aggregate_picks_the_producing_steps_subset(groups, ref):
    out, per_rank = ref.run_ranks("qsgd", "gather", 4, 2, **DELAYED)
    answers = groups[4].run("train", per_rank=per_rank,
                            **ref.job("qsgd", "gather", num_aggregate=2, **DELAYED))
    J.assert_parity(ref, out, answers, "qsgd")
    _skips(out, answers)


def test_stream_encode_on_the_produce_side_changes_nothing(groups, ref):
    out, per_rank = ref.run_ranks("qsgd", "gather", 2, **DELAYED)
    plain = groups[2].run("train", per_rank=per_rank, **ref.job("qsgd", "gather", **DELAYED))
    streamed = groups[2].run("train", per_rank=per_rank, **ref.job(
        "qsgd", "gather", stream_encode=True, stream_bucket_bytes=1, **DELAYED))
    for a, b in zip(plain, streamed):
        assert [s["hash"] for s in a["steps"]] == [s["hash"] for s in b["steps"]]
    out_s, _ = ref.run_ranks("qsgd", "gather", 2, stream_encode=True, stream_bucket_bytes=1,
                             **DELAYED)
    J.assert_parity(ref, out_s, streamed, "qsgd")


def test_cut_and_resumed_delayed_run_equals_the_straight_run(groups, ref, tmp_path):
    _, per_rank = ref.run_ranks("qsgd", "ring", 2, **DELAYED)
    args = ref.job("qsgd", "ring", **DELAYED)
    straight = groups[2].run("train", per_rank=per_rank, **args)
    cut = groups[2].run("train", per_rank=per_rank, resume_at=2, train_dir=str(tmp_path),
                        **args)
    for a, b in zip(straight, cut):
        assert [s["hash"] for s in a["steps"]] == [s["hash"] for s in b["steps"]]
        assert [s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"]]


def test_delayed_block_of_three_equals_the_single_steps(groups, ref):
    _, per_rank = ref.run_ranks("qsgd", "gather", 2, **DELAYED)
    args = ref.job("qsgd", "gather", **DELAYED)
    single = groups[2].run("train", per_rank=per_rank, **args)
    blocked = groups[2].run("train", per_rank=per_rank, parts=[3], **args)
    for a, b in zip(single, blocked):
        assert [s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"]]
        assert [s["skipped"] for s in a["steps"]] == [s["skipped"] for s in b["steps"]]
        assert b["steps"][2]["hash"] == a["steps"][2]["hash"]
