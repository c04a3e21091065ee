"""The port's hybrid sparse-row exchange over N gloo ranks against the JAX package.

The embedding tower on zipf batches (global batch 16), from the weights of a
Flax init, through ``make_distributed_train_step(hybrid=plan)``: the port's
ranks (one gloo group for each N, :mod:`torch_dist`) against the JAX
package's dp-N hybrid step on N of the conftest's forced CPU devices, each
rank fed its replica's codec draws through the ``draws=`` hook. The port's
plan and the JAX plan are equal field for field. Tolerances are
``torch_dist_jax.assert_parity``'s (replicas bit for bit, loss rtol 1e-5,
``msg_bytes`` exact, params atol 1e-5 plus one quantization step times lr
a step); ``msg_bytes`` also equals ``plan.payload_bytes()`` and
``row_overflow`` the JAX step's, exactly. Two contracts hold bit for bit
within the port: the lossless ``DenseCodec`` hybrid against ``hybrid=None``,
and an all-dense plan (global leaf keys over the full leaf list) against
``hybrid=None`` on both QSGD paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch_dist_jax as J
from torch_dist import Group

from atomo_tpu.codecs import DenseCodec as JaxDense
from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.parallel import make_distributed_train_step, make_mesh, replicate_state, shard_batch
from atomo_tpu.sparse import hybrid as jax_hybrid
from atomo_tpu.training import create_state
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu_torch.codecs import DenseCodec, QsgdCodec
from atomo_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from atomo_tpu_torch.data import BatchIterator, zipf_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.sparse import HybridPlan, leaf_specs, plan_for_model, plan_hybrid

STEPS, BATCH, SLOTS = 2, 16, 8


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {n: Group(n, tmp_path_factory.mktemp(f"gloo{n}")) for n in (2, 4)}
    yield gs
    for g in gs.values():
        g.close()


class SparseRef:
    """The embedding tower's start (a Flax init, carried to the port) and
    the JAX package's dp-N hybrid run of it on zipf batches."""

    def __init__(self):
        ds = zipf_dataset(True, size=BATCH * STEPS, seed=3)
        it = BatchIterator(ds, BATCH, seed=3).forever()
        self.batches = [next(it) for _ in range(STEPS)]
        self.jmodel = jax_model("embedding", 10)
        self.jopt = jax_optimizer("sgd", lr=J.LR, momentum=J.MOMENTUM)
        self.jstate = create_state(self.jmodel, self.jopt, jax.random.PRNGKey(0),
                                   jnp.asarray(self.batches[0][0]))
        self.port_model = get_model("embedding", 10, image_shape=(SLOTS,))
        sd = state_dict_from_jax(self.port_model, jax.device_get(self.jstate.params))
        self.sd_tensors = sd
        self.state_dict = {k: v.numpy() for k, v in sd.items()}
        self.key = jax.random.PRNGKey(7)

    def plans(self, codec, jcodec, n: int):
        """(the port's plan, the JAX package's) for N ranks, checked equal."""
        x, y = self.batches[0]
        got = plan_for_model(codec, self.port_model, x, y, BATCH // n, SLOTS,
                             state_dict=self.sd_tensors)
        want = jax_hybrid.plan_for_model(jcodec, self.jmodel, x, y, BATCH // n, SLOTS)
        assert [dataclasses.asdict(a) for a in got.assignments] == \
            [dataclasses.asdict(a) for a in want.assignments]
        return got, want

    def run(self, jcodec, aggregate: str, n: int, jplan):
        """The JAX package's hybrid steps and each rank's qsgd draws."""
        mesh = make_mesh(n_devices=n)
        step = make_distributed_train_step(self.jmodel, self.jopt, mesh, jcodec,
                                           aggregate=aggregate, hybrid=jplan)
        state = replicate_state(mesh, jax.device_get(self.jstate))
        out, draws = [], [[] for _ in range(n)]
        for s, (x, y) in enumerate(self.batches):
            for r in range(n):
                draws[r].append(J.qsgd_draws(J.codec_key(self.key, s, r), state.params))
            state, m = step(state, self.key, *shard_batch(mesh, jnp.asarray(x),
                                                          jnp.asarray(y)))[:2]
            out.append({"params": jax.device_get(state.params), "batch_stats": {},
                        "loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"]),
                        "row_overflow": float(m["row_overflow"])})
        return out, draws

    def job(self, codec, aggregate: str, plan) -> dict:
        return dict(network="embedding", num_classes=10, image_shape=(SLOTS,),
                    state_dict=self.state_dict, codec=codec, aggregate=aggregate,
                    num_aggregate=0, ring_bucket_size=65536, lr=J.LR, momentum=J.MOMENTUM,
                    batches=self.batches, key=11, hybrid=plan)

    def port_trees(self, state_dict):
        import torch

        return jax_from_state_dict(self.port_model,
                                   {k: torch.from_numpy(v) for k, v in state_dict.items()})


@pytest.fixture(scope="module")
def ref():
    return SparseRef()


def _check(ref, groups, n, aggregate, plan, jplan):
    out, draws = ref.run(JaxQsgd(bits=J.BITS), aggregate, n, jplan)
    answers = groups[n].run("train", per_rank=[{"draws": d} for d in draws],
                            **ref.job(J.CODECS["qsgd"][0], aggregate, plan))
    J.assert_parity(ref, out, answers, "qsgd")
    for s, want in enumerate(out):
        got = answers[0]["steps"][s]
        assert got["msg_bytes"] == plan.payload_bytes() == want["msg_bytes"]
        assert got["row_overflow"] == want["row_overflow"]
    return out, answers


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_hybrid_steps_match_jax(ref, groups, aggregate, n):
    plan, jplan = ref.plans(QsgdCodec(bits=J.BITS), JaxQsgd(bits=J.BITS), n)
    assert plan.sparse_idxs == (4,)
    out, _ = _check(ref, groups, n, aggregate, plan, jplan)
    assert all(o["row_overflow"] == 0.0 for o in out)


def test_row_overflow_counted_as_jax_counts_it(ref, groups):
    """A table budget below the touched rows: the dropped rows summed over
    the ranks, equal to the JAX step's, and the parameters still its."""
    plan, _ = ref.plans(QsgdCodec(bits=J.BITS), JaxQsgd(bits=J.BITS), 2)
    small = [dataclasses.replace(a, row_budget=8, payload_bytes=8 * (16 * 4 + 4) + 4)
             if a.kind == "sparse" else a for a in plan.assignments]
    plan = HybridPlan(tuple(small))
    jplan = jax_hybrid.HybridPlan(tuple(jax_hybrid.LeafAssignment(**dataclasses.asdict(a))
                                        for a in small))
    out, _ = _check(ref, groups, 2, "gather", plan, jplan)
    assert all(o["row_overflow"] > 0 for o in out)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_dense_codec_hybrid_bit_identical_to_off(ref, groups, aggregate, n):
    """The lossless contract end to end: with ``DenseCodec`` on the tower,
    the hybrid's parameters equal ``hybrid=None``'s bit for bit after every
    step, on less wire."""
    plan, _ = ref.plans(DenseCodec(), JaxDense(), n)
    assert plan.any_sparse
    on = groups[n].run("train", **ref.job(("sgd", {}), aggregate, plan))
    off = groups[n].run("train", **ref.job(("sgd", {}), aggregate, None))
    for a, b in zip(on[0]["steps"], off[0]["steps"]):
        assert a["hash"] == b["hash"] and a["loss"] == b["loss"]
        assert a["msg_bytes"] == plan.payload_bytes() < b["msg_bytes"]
        assert a["row_overflow"] == 0.0 and b["row_overflow"] is None


@pytest.mark.parametrize("path", ["fused", "pack"])
@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_all_dense_plan_bit_identical_to_off(ref, groups, aggregate, path):
    """An all-dense plan keeps the global leaf keys and the full leaf list,
    so its qsgd steps (each rank drawing its own uniforms) equal
    ``hybrid=None``'s bit for bit, on the fused path and the pack path."""
    kw = {"quantization_level": J.BITS, "use_kernel": path == "fused",
          "pack_kernel": None if path == "fused" else True}
    specs = leaf_specs(ref.port_model)
    plan = plan_hybrid(QsgdCodec(bits=J.BITS), specs, [1.0] * len(specs), [None] * len(specs))
    assert not plan.any_sparse
    on = groups[2].run("train", **ref.job(("qsgd", kw), aggregate, plan))
    off = groups[2].run("train", **ref.job(("qsgd", kw), aggregate, None))
    for a, b in zip(on[0]["steps"], off[0]["steps"]):
        assert a["hash"] == b["hash"] and a["msg_bytes"] == b["msg_bytes"]
    assert on[0]["max_scale"] > 0  # the subset encode ran the codec


@pytest.mark.parametrize("kwargs,phrase", [
    (dict(aggregate="psum"), "degenerates"),
    (dict(aggregate="gather", codec=None), "per-leaf payload path"),
    (dict(aggregate="gather", num_aggregate=1), "num_aggregate"),
])
def test_step_factory_rejections(ref, groups, kwargs, phrase):
    plan, jplan = ref.plans(QsgdCodec(bits=J.BITS), JaxQsgd(bits=J.BITS), 2)
    kwargs = dict(kwargs)
    codec = kwargs.pop("codec", J.CODECS["qsgd"][0])
    msgs = groups[2].run("build", network="embedding", image_shape=(SLOTS,), codec=codec,
                         kwargs={**kwargs, "hybrid": plan})
    assert all(m is not None and phrase in m for m in msgs), msgs
    # the JAX step factory refuses the same cases with the same phrase
    jcodec = None if codec is None else JaxQsgd(bits=J.BITS)
    with pytest.raises(ValueError, match=phrase):
        make_distributed_train_step(ref.jmodel, ref.jopt, make_mesh(n_devices=2), jcodec,
                                    hybrid=jplan, **kwargs)
