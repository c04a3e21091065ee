"""Per-leaf budgets and error feedback over 2 gloo ranks against the JAX package.

LeNet on synthetic MNIST (global batch 16, 3 steps) from the weights of a
Flax init: the port's ranks (:mod:`torch_dist`) run
``make_distributed_train_step`` with a per-leaf codec (``budget_ks``: the
allocation the JAX solver makes on the JAX probe gradient) or with
``error_feedback``, each rank fed its replica's draws (the draws depend on
the key, the leaf's shape and its codec, not on the values, so they are the
same with error feedback); the JAX package runs its dp-2 step on 2 of the
conftest's forced CPU devices. Tolerances are
``torch_dist_jax.assert_parity``'s (replicas bit for bit, loss rtol 1e-5,
``msg_bytes`` exact, params atol 1e-5 plus one 4-bit quantization step
times lr a step); ``msg_bytes`` also equals the allocation's predicted
bytes exactly, and ``ef_res_norm`` the JAX step's within rtol 1e-4 (float32
decodes summed in other orders). Within the port, bit for bit: error
feedback's first step is the plain step (the residual starts at zero), and
a run cut after step 2 and resumed from its checkpoint (every rank's
residual gathered into it) equals the straight run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_dist_jax as J
from torch_dist import Group

from atomo_tpu import budget as jb
from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.codecs.svd import SvdCodec as JaxSvd
from atomo_tpu.parallel import (
    init_ef_state,
    make_distributed_train_step,
    make_mesh,
    replicate_state,
    shard_batch,
)
from atomo_tpu.sparse.hybrid import probe_gradient as jax_probe
from atomo_tpu_torch import budget as pb
from atomo_tpu_torch.codecs import QsgdCodec, SvdCodec

STEPS, BATCH, N = 3, 16, 2

# name -> (the port's codec spec, its codec, the JAX codec)
CODES = {
    "svd3": (("svd", {"svd_rank": 3}), SvdCodec(rank=3), JaxSvd(rank=3)),
    "svd_topk": (("svd", {"svd_rank": 3, "sample": "topk"}), SvdCodec(rank=3, sample="topk"),
                 JaxSvd(rank=3, sample="topk")),
    "qsgd": (("qsgd", {"quantization_level": J.BITS}), QsgdCodec(bits=J.BITS),
             JaxQsgd(bits=J.BITS)),
}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(N, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def ref():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


def allocation(ref, code: str):
    """The JAX solver's variance allocation (budget: the uniform total) on
    the JAX probe gradient, and the port's spectra carrying the same
    numbers."""
    _, port_c, jax_c = CODES[code]
    x, y = ref.batches[0]
    spectra = jb.measure_spectra(jax_c, jax_probe(ref.jmodel, x, y))
    alloc = jb.solve_allocation(jax_c, spectra)
    port = [pb.LayerSpectrum(index=s.index, name=s.name, shape=s.shape,
                             dense_bytes=s.dense_bytes, r_full=s.r_full, a=s.a,
                             base_k=s.base_k, adaptive=s.adaptive) for s in spectra]
    assert pb.solve_allocation(port_c, port).ks == alloc.ks
    return alloc, port


def _draws(code, k_codec, params, ks):
    """Each leaf's draws under its own codec (its rank or width)."""
    if code == "qsgd":  # a uniform per value: the same at every width
        return J.qsgd_draws(k_codec, params)
    base = CODES[code][1]
    return [J.jit_svd_draws(base if ks is None else SvdCodec(rank=ks[i], sample=base.sample),
                            jax.random.fold_in(k_codec, i), tuple(leaf.shape))
            for i, leaf in enumerate(jax.tree_util.tree_leaves(params))]


def jax_run(ref, code: str, aggregate: str, ks=None, ef: bool = False):
    """The JAX package's dp-2 steps and each rank's draws."""
    jcodec = CODES[code][2]
    if ks is not None:
        jcodec = jb.budgeted_codec(jcodec, ks)
    mesh = make_mesh(n_devices=N)
    step = make_distributed_train_step(ref.jmodel, ref.jopt, mesh, jcodec,
                                       aggregate=aggregate, error_feedback=ef)
    state = replicate_state(mesh, jax.device_get(ref.jstate))
    if ef:
        state = init_ef_state(mesh, state)
    out, draws = [], [[] for _ in range(N)]
    for s, (x, y) in enumerate(ref.batches):
        for r in range(N):
            draws[r].append(_draws(code, J.codec_key(ref.key, s, r), state.params, ks))
        state, m = step(state, ref.key, *shard_batch(mesh, jnp.asarray(x), jnp.asarray(y)))[:2]
        out.append({"params": jax.device_get(state.params),
                    "batch_stats": jax.device_get(state.batch_stats),
                    "loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"]),
                    "ef_res_norm": float(m["ef_res_norm"]) if ef else None})
    return out, draws


def job(ref, code: str, aggregate: str, draws, **kw):
    args = ref.job("qsgd", aggregate)
    args["codec"] = CODES[code][0]
    args.update(kw)
    return dict(per_rank=[{"draws": d} for d in draws], **args)


@pytest.mark.parametrize("code,aggregate", [
    ("svd3", "gather"), ("svd3", "ring"), ("qsgd", "gather"), ("qsgd", "ring"),
    ("qsgd", "psum"),
])
def test_variance_allocation_steps_match_jax(group, ref, code, aggregate):
    alloc, spectra = allocation(ref, code)
    assert len(set(alloc.ks)) > 1
    out, draws = jax_run(ref, code, aggregate, ks=alloc.ks)
    answers = group.run("train", **job(ref, code, aggregate, draws, budget_ks=alloc.ks))
    J.assert_parity(ref, out, answers, "qsgd" if code == "qsgd" else "svd")
    if aggregate != "psum":  # psum's wire is the dense bytes
        want = pb.allocation_payload_bytes(CODES[code][1], spectra, alloc.ks)
        assert {s["msg_bytes"] for s in answers[0]["steps"]} == {want, alloc.payload_bytes}


@pytest.mark.parametrize("code,aggregate", [
    ("svd_topk", "gather"), ("svd_topk", "ring"), ("qsgd", "gather"), ("qsgd", "psum"),
])
def test_error_feedback_steps_match_jax(group, ref, code, aggregate):
    out, draws = jax_run(ref, code, aggregate, ef=True)
    answers = group.run("train", **job(ref, code, aggregate, draws, error_feedback=True))
    J.assert_parity(ref, out, answers, "qsgd" if code == "qsgd" else "svd")
    got = [s["ef_res_norm"] for s in answers[0]["steps"]]
    np.testing.assert_allclose(got, [o["ef_res_norm"] for o in out], rtol=1e-4)
    assert all(g > 0 for g in got)
    # the first step starts from a zero residual: the plain step, bit for bit
    plain = group.run("train", **job(ref, code, aggregate, draws))
    assert answers[0]["steps"][0]["hash"] == plain[0]["steps"][0]["hash"]
    assert answers[0]["steps"][1]["hash"] != plain[0]["steps"][1]["hash"]


@pytest.mark.parametrize("code", ["svd_topk", "qsgd"])
def test_error_feedback_resume_is_bit_for_bit(group, ref, tmp_path, code):
    """Cut after step 2, every rank's residual saved and restored: steps 3
    on equal the straight run's bit for bit on every rank."""
    _, draws = jax_run(ref, code, "gather", ef=True)
    straight = group.run("train", **job(ref, code, "gather", draws, error_feedback=True))
    cut = group.run("train", **job(ref, code, "gather", draws, error_feedback=True,
                                   resume_at=2, train_dir=str(tmp_path)))
    for a, b in zip(straight, cut):
        assert [s["hash"] for s in a["steps"]] == [s["hash"] for s in b["steps"]]
        assert [s["ef_res_norm"] for s in a["steps"]] == [s["ef_res_norm"] for s in b["steps"]]


@pytest.mark.parametrize("kwargs,phrase", [
    (dict(codec=None), "dense training has no residual"),
    (dict(num_aggregate=1), "does not compose with num_aggregate"),
    (dict(hybrid=True), "does not compose with hybrid="),
])
def test_step_factory_refuses_error_feedback(group, ref, kwargs, phrase):
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.sparse import leaf_specs, plan_hybrid

    kwargs = dict(kwargs)
    codec = kwargs.pop("codec", CODES["qsgd"][0])
    if kwargs.pop("hybrid", False):
        specs = leaf_specs(get_model("lenet", 10, image_shape=(28, 28, 1)))
        kwargs["hybrid"] = plan_hybrid(QsgdCodec(bits=J.BITS), specs, [1.0] * len(specs),
                                       [None] * len(specs))
    msgs = group.run("build", network="lenet", image_shape=(28, 28, 1), codec=codec,
                     kwargs={**kwargs, "error_feedback": True})
    assert all(m is not None and phrase in m for m in msgs), msgs
    if "hybrid" not in kwargs:  # the JAX step factory refuses with the same words
        with pytest.raises(ValueError, match=phrase):
            make_distributed_train_step(ref.jmodel, ref.jopt, make_mesh(n_devices=N),
                                        None if codec is None else CODES["qsgd"][2],
                                        error_feedback=True, **kwargs)
