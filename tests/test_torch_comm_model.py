"""The port's comm-cost model and byte budgets against the JAX package's.

Every ported function of ``atomo_tpu_torch/utils/comm_model.py`` equals the
JAX one on a grid of byte budgets, device counts and fabrics: floats
exactly (the same arithmetic in the same order), ``choose_aggregate``'s
mode and its reason string letter for letter when ``fabric_bw`` and
``tax_s`` are given, the reports' dicts but for the ``assumptions`` text
(it names each package's own file). The anchors differ by design: the
port's codec tax anchor is the H100's and its single-host preset the H100
SXM datasheet's NVLink figure, so ``resolve_fabric`` gives the JAX value
or the JAX error for every number and every malformed token, and the
card's values for the presets. ``byte_budget`` (leaf shapes priced by each
codec's ``leaf_payload_bytes``, nothing encoded) equals the JAX package's
``eval_shape`` of the encode to the byte for LeNet, ResNet-18 and the LM
under sgd, svd, qsgd and terngrad.
"""

import jax
import jax.numpy as jnp
import pytest

from atomo_tpu.codecs import get_codec as jax_codec
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.models.transformer import TransformerLM as FlaxLM
from atomo_tpu.tuning import probe as jprobe
from atomo_tpu.utils import comm_model as J
from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.models.transformer import TransformerLM
from atomo_tpu_torch.tuning import probe
from atomo_tpu_torch.utils import comm_model as P

BUDGETS = [(44.7e6, 0.62e6), (1.2e6, 0.7e6), (8e6, 5e6), (3e5, 3e5), (2.5e7, 1e5)]
WAYS = [1, 2, 3, 4, 8, 16, 64]


@pytest.mark.parametrize("dense,payload", BUDGETS)
def test_byte_formulas_equal_jax(dense, payload):
    for n in WAYS:
        for name in ("ring_allreduce_wire_bytes", "gather_buffer_bytes",
                     "ring_allgather_wire_bytes"):
            arg = dense if name == "ring_allreduce_wire_bytes" else payload
            assert getattr(P, name)(arg, n) == getattr(J, name)(arg, n)
        assert P.ring_stream_wire_bytes(payload, dense, n) == J.ring_stream_wire_bytes(
            payload, dense, n)
        assert P.tp_psum_wire_bytes(dense, n, 4) == J.tp_psum_wire_bytes(dense, n, 4)
        assert P.moe_all_to_all_wire_bytes(payload, n, 3) == J.moe_all_to_all_wire_bytes(
            payload, n, 3)
        for tax in (0.0, 1e-3, 5e-2):
            assert (P.crossover_bandwidth(dense, payload, n, tax)
                    == J.crossover_bandwidth(dense, payload, n, tax))
    assert P.max_beneficial_ways(dense, payload) == J.max_beneficial_ways(dense, payload)
    for bucket in (0, 1 << 20, 4e6, dense / 3):
        assert P.stream_bucket_count(dense, bucket) == J.stream_bucket_count(dense, bucket)


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 2), (4, 2), (4, 8), (3, 5)])
def test_pipeline_and_overlap_terms_equal_jax(stages, micro):
    assert P.pipeline_bubble_fraction(stages, micro) == J.pipeline_bubble_fraction(stages,
                                                                                   micro)
    for comp in (0.0, 2e-3, 0.05):
        assert P.pipeline_bubble_s(comp, stages, micro) == J.pipeline_bubble_s(comp, stages,
                                                                               micro)
        for comm in (0.0, 1e-3, 0.2):
            assert P.overlap_hidden_comm_s(comm, comp) == J.overlap_hidden_comm_s(comm, comp)
            assert P.overlap_exposed_comm_s(comm, comp) == J.overlap_exposed_comm_s(comm,
                                                                                   comp)
    for enc in (0.0, 3e-3):
        assert P.stream_exposed_encode_s(enc, micro) == J.stream_exposed_encode_s(enc, micro)


@pytest.mark.parametrize("aggregate", ["gather", "ring"])
@pytest.mark.parametrize("stream", [False, True])
def test_overlap_report_equals_jax(aggregate, stream):
    for n, (d, p) in zip((2, 8, 16), BUDGETS):
        kw = dict(dense_bytes=d, payload_bytes=p, ways=n, fabric_bw=6.25e9, compute_s=4e-3,
                  decode_s=1e-3, aggregate=aggregate, encode_s=2e-3, stream_encode=stream,
                  stream_buckets=5, pipeline_stages=4, pipeline_microbatches=2)
        got, want = P.overlap_report(**kw), J.overlap_report(**kw)
        assert got.pop("assumptions") and want.pop("assumptions")
        assert got == want


def test_crossover_report_equals_jax_on_the_same_bandwidths():
    bws = (("a", 45e9), ("b", 6.25e9), ("c", 1.25e9))
    for d, p in BUDGETS:
        got = P.crossover_report(d, p, 6.5e-3, 9.0e-3, bandwidths=bws)
        want = J.crossover_report(d, p, 6.5e-3, 9.0e-3, bandwidths=bws)
        assert got.pop("assumptions") and want.pop("assumptions")
        assert got == want


@pytest.mark.parametrize("dense,payload", BUDGETS)
@pytest.mark.parametrize("allow_ring", [True, False])
def test_choose_aggregate_mode_and_reason_equal_jax(dense, payload, allow_ring):
    for n in WAYS:
        for bw in (45e9, 6.25e9, 1.25e9, 0.1e9):
            for tax in (0.0, 2.5e-3, 0.5):
                for has_codec in (True, False):
                    kw = dict(has_codec=has_codec, dense_bytes=dense, payload_bytes=payload,
                              ways=n, fabric_bw=bw, tax_s=tax, allow_ring=allow_ring)
                    assert P.choose_aggregate(**kw) == J.choose_aggregate(**kw), kw
    kw = dict(has_codec=True, dense_bytes=dense, payload_bytes=payload, ways=4,
              fabric_bw=1e9, tax_s=1e-3, cross_host=True)
    assert P.choose_aggregate(**kw) == J.choose_aggregate(**kw)


def test_codec_tax_estimate_is_the_cards_anchor():
    """The estimate scales the H100 anchor linearly with the gradient, as
    the JAX package scales its TPU one: the same law, the card's number."""
    d = 1.234e7
    assert P.estimate_codec_tax_s(d) == P._TAX_ANCHOR_S * d / P._TAX_ANCHOR_BYTES
    assert P.estimate_codec_tax_s(P._TAX_ANCHOR_BYTES) == pytest.approx(P._TAX_ANCHOR_S,
                                                                         rel=1e-15)
    assert (P._TAX_ANCHOR_S, P._TAX_ANCHOR_BYTES) != (J._TAX_ANCHOR_S, J._TAX_ANCHOR_BYTES)
    # the model's own ResNet-18 dense gradient is the anchor's byte count
    assert probe.byte_budget(None, get_model("resnet18", 10, image_shape=(32, 32, 3)))[0] \
        == P._TAX_ANCHOR_BYTES


@pytest.mark.parametrize("token", ["10", "0.5", "1e2", "6.25", "0", "-3", "nan", "inf",
                                   "fast", "", "ici:dcn", "10:1"])
def test_resolve_fabric_numbers_and_errors_equal_jax(token):
    try:
        want = J.resolve_fabric(token)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.resolve_fabric(token)
        # the same message, its preset list holding the card's nvlink besides
        assert str(got.value) == str(e).replace("| ici |", "| ici | nvlink |")
        return
    assert P.resolve_fabric(token) == want


def test_resolve_fabric_presets_are_the_cards():
    assert P.resolve_fabric("ici") == P.resolve_fabric("nvlink") == 450e9
    assert P.resolve_fabric("auto", n_proc=1) == 450e9
    assert P.resolve_fabric("auto", n_proc=2) == P.resolve_fabric("dcn") == 50e9
    assert P.resolve_fabric("eth10g") == J.resolve_fabric("eth10g")
    with pytest.raises(ValueError, match="obs/fabric.py"):
        P.resolve_fabric("measured")


def test_small_helpers_equal_jax():
    for delays in ([], [0.3], [0.5, 0.1, 0.2, 0.9], [1, 1, 2]):
        for q in (0, 1, 2, 3, 9):
            assert P.quorum_exposed_wait_s(delays, q) == J.quorum_exposed_wait_s(delays, q)
    pairs = [(10, 2), (5.5, 1), (0, 0)]
    assert P.leaf_budget_totals(pairs) == J.leaf_budget_totals(pairs)


CODES = {"sgd": None, "svd": dict(svd_rank=3), "qsgd": dict(quantization_level=4),
         "terngrad": {}}


def _jax_init(name):
    if name == "lm":
        cfg = dict(vocab_size=64, max_len=32, width=32, depth=2, num_heads=4)
        lm = FlaxLM(**cfg)
        return lambda: lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))["params"]
    shape = {"lenet": (1, 28, 28, 1), "resnet18": (1, 32, 32, 3)}[name]
    return jprobe.model_init_fn(jax_model(name, 10), jnp.zeros(shape, jnp.float32))


def _port_model(name):
    if name == "lm":
        return TransformerLM(vocab_size=64, max_len=32, width=32, depth=2, num_heads=4)
    return get_model(name, 10, image_shape={"lenet": (28, 28, 1),
                                            "resnet18": (32, 32, 3)}[name])


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("model", ["lenet", "resnet18", "lm"])
def test_byte_budget_equals_jax(model, code):
    kw = CODES[code]
    jc = None if kw is None else jax_codec(code, **kw)
    pc = None if kw is None else get_codec(code, **kw)
    want = jprobe.byte_budget(jc, _jax_init(model))
    got = probe.byte_budget(pc, _port_model(model))
    assert got == want
    leaves = probe.leaf_byte_budgets(pc, _port_model(model))
    assert leaves == [tuple(map(int, x)) for x in jprobe.leaf_byte_budgets(jc, _jax_init(model))]


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (512,), (256, 10), (7, 5, 3)])
@pytest.mark.parametrize("code", ["svd", "qsgd", "terngrad"])
def test_codec_leaf_payload_bytes_equals_jax(shape, code):
    kw = CODES[code]
    assert (P.codec_leaf_payload_bytes(get_codec(code, **kw), shape)
            == J.codec_leaf_payload_bytes(jax_codec(code, **kw), shape))
