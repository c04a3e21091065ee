"""The LM's model-axis layouts on 4 gloo ranks against the JAX package's
step: the cases of ``test_torch_lm_dist_layouts.py`` at 4 ranks (dp-tp 2x2,
dp-ep 2x2, dp-pp 1x4 and 2x2, dp-tp-sp 1x2x2), and ``--stream-encode`` and
``--overlap delayed`` on dp-tp 2x2, with that file's tolerances (its
docstring). A file of its own, so that the 2-rank and the 4-rank cases
balance over test workers."""

import pytest
from test_torch_lm_dist_layouts import cases, groups, starts  # noqa: F401 (fixtures)

import test_torch_lm_dist_layouts as two


@pytest.mark.parametrize("layout,n,ways,code,aggregate,microbatches,attn_impl", cases(4))
def test_layout_steps_match_jax(groups, starts, layout, n, ways, code,  # noqa: F811
                                aggregate, microbatches, attn_impl):
    two.test_layout_steps_match_jax(groups, starts, layout, n, ways, code, aggregate,
                                    microbatches, attn_impl)


@pytest.mark.parametrize("modes", [
    dict(stream_encode=True, stream_bucket_bytes=1),
    dict(overlap="delayed"),
], ids=["stream-encode", "delayed"])
def test_dp_tp_exchange_modes_match_jax(groups, starts, modes):  # noqa: F811
    """``--stream-encode`` (one bucket a leaf; at tp 2 the buckets are
    encoded one after another after backward: the hooks serve only at
    model ways 1) and ``--overlap delayed`` (step 0 skipped) on dp-tp 2x2
    with qsgd, against the JAX package's ``DpExchange`` step."""
    two.dp_tp_exchange_modes_match_jax(groups, starts, modes)
