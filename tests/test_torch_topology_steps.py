"""The two-tier step over four gloo ranks against the JAX package's
hierarchical step on the forced CPU mesh ``(dp=2, ici=2)``.

LeNet on synthetic MNIST from a Flax init, 2 steps, one world-4 gloo group
for the file: rank r sits at outer index r // 2 and inner index r % 2, the
JAX mesh's row-major order. Each rank gets its card's JAX draws
(``torch_dist_jax.two_tier_draws``: the boundary re-encode's under its
group's outer key, and under a ``cring`` inner its own encode's under its
inner key). The legacy plan for qsgd 4 bits and svd rank 3, and every other
plan for qsgd, against the JAX step with ``plan=``: after every step the
replicas hash alike (bit for bit), the loss within rtol 1e-5 and
``msg_bytes`` (the slow tier's bytes) exactly equal; after the last step
the parameters within the cross-package tolerance of
``torch_dist_jax.assert_parity`` (float32 convolutions summed in other
orders, plus one quantization level times lr a step for QSGD, whose fields
may move a level where the gradients' float-level difference crosses a
uniform). The inner mean of 2 ranks is a sum of two floats, exact in any
order, so the quantizer sees the JAX step's input bits.

The guard drill: chaos ``nan@2`` poisons card 0, so group 0's inner-reduced
gradient fails the screen and the whole group is masked at step 2 (kept 1
of 2, the update rescaled), ``dropped`` and ``skipped`` equal to the JAX
step's, for qsgd on the legacy plan and for svd on ``cring+gather``. In the port alone, ZeRO-1 and the sharded update under the two-tier
step equal the replicated two-tier step bit for bit, so do a superstep block
of 2 (eager, by the graph rule) and a run checkpointed after step 1 and
resumed, and the step factory's refusals equal the JAX factory's texts.
"""

import jax
import pytest
import torch_dist_jax as J
from torch_dist import Groups

from atomo_tpu.mesh.spec import MeshSpec as JMeshSpec
import atomo_tpu.parallel as JP
import atomo_tpu.training.resilience as JR
import atomo_tpu.utils.chaos as JC

BATCH, STEPS, DCN = 8, 2, 2
MAXN = 100.0


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = Groups(tmp_path_factory, "topology")
    yield gs
    gs.close()


@pytest.fixture(scope="module")
def lenet():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


def _case(groups, ref, code, plan, **modes):
    out, per_rank = ref.run_ranks(code, "hierarchical", 4, dcn_ways=DCN, plan=plan, **modes)
    args = ref.job(code, "hierarchical", dcn_ways=DCN, plan=plan)
    return out, per_rank, args


@pytest.mark.parametrize("code,plan", [("qsgd", None), ("svd", None), ("qsgd", "psum+ring"),
                                       ("qsgd", "cring+gather"), ("qsgd", "cring+ring"),
                                       ("qsgd", "cring+psum")])
def test_two_tier_steps_match_jax(groups, lenet, code, plan):
    out, per_rank, args = _case(groups, lenet, code, plan)
    answers = groups[4].run("train", per_rank=per_rank, **args)
    J.assert_parity(lenet, out, answers, code)
    # the slow tier's bytes: the payload a compressed outer ships, else dense
    dense = answers[0]["steps"][0]["dense_bytes"]
    msg = answers[0]["steps"][0]["msg_bytes"]
    assert (msg == dense) == (plan == "cring+psum"), (msg, dense)


_CHAOS = []


@pytest.mark.parametrize("code,plan,maxn", [("qsgd", None, MAXN), ("svd", "cring+gather", 0.0)])
def test_two_tier_guard_drops_group_zero_as_jax(groups, lenet, code, plan, maxn):
    """Card 0 poisoned at step 2: its group is the unit dropped. Under svd
    with a ``cring`` inner the port's encode takes the gradient with its
    non-finite entries zeroed, so the group's inner mean is finite: the
    group is dropped all the same, as the JAX step drops it. That case
    screens finiteness only (max norm 0): the mean of two rank-3 svd
    estimates passes a norm of 100 on every step at these shapes."""
    if not _CHAOS:
        _CHAOS.append(JC.ChaosInjector(JC.ChaosConfig.from_spec("nan@2", environ={}),
                                       membership_epoch=0))
    out, per_rank, args = _case(groups, lenet, code, plan, guard=JR.GuardConfig(maxn),
                                chaos=_CHAOS[0])
    args.update(guard=maxn, chaos="nan@2", target_replica=0)
    answers = groups[4].run("train", per_rank=per_rank, **args)
    got = answers[0]["steps"]
    assert [o["dropped"] for o in out] == [0.0, 1.0]
    assert [o["skipped"] for o in out] == [0.0, 0.0]
    assert [s["dropped"] for s in got] == [o["dropped"] for o in out]
    assert [s["skipped"] for s in got] == [o["skipped"] for o in out]
    J.assert_parity(lenet, out, answers, code)


@pytest.mark.parametrize("partition", ["zero1", "sharded-update"])
def test_two_tier_partitions_equal_replicated(groups, lenet, partition):
    """The partitions slice over both axes (the whole world): their
    trajectory is the replicated two-tier step's bit for bit."""
    _, per_rank, args = _case(groups, lenet, "qsgd", "cring+gather")
    base = groups[4].run("train", per_rank=per_rank, **args)
    part = groups[4].run("train", per_rank=per_rank, partition=partition, **args)
    assert [s["hash"] for s in part[0]["steps"]] == [s["hash"] for s in base[0]["steps"]]
    assert {a["steps"][-1]["hash"] for a in part} == {base[0]["steps"][-1]["hash"]}


@pytest.mark.parametrize("mode", ["superstep", "resume"])
def test_two_tier_block_and_resume_equal_the_straight_steps(groups, lenet, tmp_path, mode):
    """A superstep block of 2 (the eager block: the rule keeps a two-tier
    step off the graph) and a run cut after step 1, checkpointed and
    resumed (the state is replicated) end in the straight run's state bit
    for bit."""
    _, per_rank, args = _case(groups, lenet, "qsgd", "psum+ring")
    base = groups[4].run("train", per_rank=per_rank, **args)
    extra = (dict(parts=[2]) if mode == "superstep"
             else dict(resume_at=1, train_dir=str(tmp_path)))
    got = groups[4].run("train", per_rank=per_rank, **extra, **args)
    assert got[0]["steps"][-1]["hash"] == base[0]["steps"][-1]["hash"]
    assert [s["loss"] for s in got[0]["steps"]] == [s["loss"] for s in base[0]["steps"]]


def test_graph_rule_keeps_the_two_tier_step_eager():
    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.training.graph import graph_rule

    kw = dict(device="cuda", codec=get_codec("qsgd", quantization_level=4), backend="nccl",
              world=4)
    assert graph_rule(aggregate="gather", **kw)[0]
    ok, why = graph_rule(aggregate="hierarchical", **kw)
    assert not ok and why.startswith("hierarchical: the two-tier exchange runs over NCCL "
                                     "subgroups")


@pytest.mark.parametrize("code", ["qsgd", "svd"])
def test_planned_operator_bit_identical_to_canonical(groups, code):
    """Every plan's executed operator, the outer decode unfused, computes
    the bits of the canonical decode-order oracle over the same groups
    (``two_level_canonical_mean``: an all_gather and the unfused decode at
    every compressed tier), each rank's own draws under the step's keys; the
    fused decode the step runs within 1e-6 of the largest entry (SVD's
    fused product sums in another order); and rank 0's mean equals the
    host reference ``two_level_mean_host`` on the same gradients and keys
    within 1e-6 of the largest entry (the host's sums are its own)."""
    import numpy as np
    import torch

    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.topology import PLAN_NAMES, plan_from_name, two_level_mean_host

    rng = np.random.default_rng(5)
    shapes = [(8,), (5, 5, 1, 8), (33, 17)]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(4)]
    spec = J.CODECS[code][0]
    got = groups[4].run("two_tier", per_rank=[{"grads": g} for g in grads], codec=spec,
                        dcn_ways=DCN, plans=list(PLAN_NAMES), step_key=77)
    codec = get_codec(spec[0], **spec[1])
    for name in PLAN_NAMES:
        host = two_level_mean_host(codec, plan_from_name(name),
                                   [[torch.from_numpy(x) for x in g] for g in grads], 77,
                                   n_outer=2, n_inner=2, layouts=[False] * 3, device="cpu")
        for r, ans in enumerate(got):
            a = ans[name]
            for u, c, f, h in zip(a["unfused"], a["canonical"], a["fused"], host):
                assert u.tobytes() == c.tobytes(), (name, r)
                tol = 1e-6 * float(np.abs(c).max())
                np.testing.assert_allclose(f, c, rtol=0, atol=tol)
                np.testing.assert_allclose(u, h.numpy(), rtol=0, atol=tol)
        # the replicas agree: every rank holds rank 0's bits
        assert all(x.tobytes() == y.tobytes() for ans in got[1:]
                   for x, y in zip(ans[name]["unfused"], got[0][name]["unfused"]))


def _jax_refusal(kwargs):
    from atomo_tpu.codecs import QsgdCodec
    from atomo_tpu.models import get_model
    from atomo_tpu.training import make_optimizer

    mesh = JMeshSpec.from_world(4, DCN).build()
    codec = kwargs.pop("codec", QsgdCodec(bits=4))
    try:
        JP.make_distributed_train_step(get_model("lenet", 10), make_optimizer("sgd"), mesh,
                                       codec, **kwargs)
    except ValueError as e:
        return str(e)
    return None


# (the JAX factory's arguments, the port's): each refused by the same text
REFUSALS = {
    "no_inner_axis": (dict(aggregate="hierarchical"), dict(aggregate="hierarchical")),
    "no_codec": (dict(aggregate="hierarchical", inner_axis="ici", codec=None),
                 dict(aggregate="hierarchical", inner_axis="ici", codec=None)),
    "bad_axis": (dict(aggregate="hierarchical", inner_axis="sp"),
                 dict(aggregate="hierarchical", inner_axis="sp")),
    "inner_flat": (dict(aggregate="gather", inner_axis="ici"),
                   dict(aggregate="gather", inner_axis="ici")),
    "plan_flat": (dict(aggregate="gather", plan="cring+ring"),
                  dict(aggregate="gather", plan="cring+ring")),
    "delayed": (dict(aggregate="hierarchical", inner_axis="ici", overlap="delayed"),
                dict(aggregate="hierarchical", inner_axis="ici", overlap="delayed")),
    "stream": (dict(aggregate="hierarchical", inner_axis="ici", stream_encode=True),
               dict(aggregate="hierarchical", inner_axis="ici", stream_encode=True)),
    "ef": (dict(aggregate="hierarchical", inner_axis="ici", error_feedback=True),
           dict(aggregate="hierarchical", inner_axis="ici", error_feedback=True)),
    "quality": (dict(aggregate="hierarchical", inner_axis="ici", track_quality=True),
                dict(aggregate="hierarchical", inner_axis="ici", track_quality=True)),
    "survivor": (dict(aggregate="hierarchical", inner_axis="ici", survivor_exact=True),
                 dict(aggregate="hierarchical", inner_axis="ici", survivor_exact=True)),
    "num_aggregate": (dict(aggregate="hierarchical", inner_axis="ici", num_aggregate=1),
                      dict(aggregate="hierarchical", inner_axis="ici", num_aggregate=1)),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_two_tier_step_refusals_equal_jax(groups, name):
    from atomo_tpu.topology import plan_from_name as jplan
    from atomo_tpu_torch.topology import plan_from_name

    jkw, pkw = (dict(d) for d in REFUSALS[name])
    if "plan" in jkw:
        jkw["plan"], pkw["plan"] = jplan(jkw["plan"]), plan_from_name(pkw["plan"])
    codec = ("qsgd", {"quantization_level": 4})
    if "codec" in pkw:
        codec = pkw.pop("codec")
    want = _jax_refusal(jkw)
    assert want is not None, name
    got = groups[4].run("build", network="lenet", image_shape=(28, 28, 1), codec=codec,
                        kwargs=pkw, dcn_ways=DCN)
    assert got == [want] * 4, (got[0], want)
