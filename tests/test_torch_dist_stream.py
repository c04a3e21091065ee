"""``stream_encode`` over 2 gloo ranks against the JAX package.

LeNet on synthetic MNIST (global batch 16, 3 steps) from the weights of a
Flax init, each rank fed its replica's JAX draws (:mod:`torch_dist`). Bit
for bit within the port: the hook-driven streamed step (each layer bucket
encoded as its last gradient arrives; under gather its own all_gather,
under ring its own mini-ring) equals ``stream_encode=False`` at bucket
sizes of one leaf, 4 KiB and the whole tree for qsgd, 4 KiB for svd
(svd's buckets encoded after backward, by the rule), and under
``grad_accum`` 2, ``--bf16`` and error feedback. Against the JAX package's
streamed dp-2 step: ``torch_dist_jax.assert_parity``'s tolerances.
"""

import pytest
import torch_dist_jax as J
from torch_dist import Group

STEPS, BATCH, N = 3, 16, 2


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(N, tmp_path_factory.mktemp("gloo2"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def ref():
    return J.Reference("lenet", "mnist", BATCH, STEPS)


def _same_hashes(a_runs, b_runs):
    for a, b in zip(a_runs, b_runs):
        assert [s["hash"] for s in a["steps"]] == [s["hash"] for s in b["steps"]]
        assert [s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"]]
        assert [s["msg_bytes"] for s in a["steps"]] == [s["msg_bytes"] for s in b["steps"]]


@pytest.mark.parametrize("code", ["qsgd", "svd"])
@pytest.mark.parametrize("aggregate", ["gather", "ring"])
def test_streamed_step_equals_off_and_the_jax_step(group, ref, aggregate, code):
    out, per_rank = ref.run_ranks(code, aggregate, N, stream_encode=True,
                                  stream_bucket_bytes=4096)
    off = group.run("train", per_rank=per_rank, **ref.job(code, aggregate))
    for bucket in (1, 4096, 0) if code == "qsgd" else (4096,):
        on = group.run("train", per_rank=per_rank, **ref.job(
            code, aggregate, stream_encode=True, stream_bucket_bytes=bucket))
        _same_hashes(off, on)
    J.assert_parity(ref, out, on, code)


@pytest.mark.parametrize("kw", [dict(grad_accum=2), dict(bf16=True),
                                dict(error_feedback=True)],
                         ids=["grad_accum", "bf16", "error_feedback"])
def test_streamed_step_composes(group, ref, kw):
    _, per_rank = ref.run_ranks("qsgd", "gather", N, kw.get("num_aggregate", 0),
                                kw.get("grad_accum", 1))
    args = ref.job("qsgd", "gather", grad_accum=kw.pop("grad_accum", 1))
    args.update(kw)
    off = group.run("train", per_rank=per_rank, **args)
    on = group.run("train", per_rank=per_rank, stream_encode=True, stream_bucket_bytes=1,
                   **args)
    _same_hashes(off, on)
    if "error_feedback" in kw:
        assert [s["ef_res_norm"] for s in off[0]["steps"]] == \
            [s["ef_res_norm"] for s in on[0]["steps"]]
