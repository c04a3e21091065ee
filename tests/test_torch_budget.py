"""The port's budget package and per-leaf codecs against the JAX package.

Inputs are numpy arrays made from seeds, fed to both packages. Tolerances:
the allocation (``ks``, ``payload_bytes``, ``budget_bytes``, ``describe()``)
and every priced byte are exact; ``predicted_variance`` within rel 1e-12 on
the same spectra; a measured SVD numerator ``a`` within rel 1e-5 (numpy's
float32 SVD on the two packages' matrices), a QSGD one exactly.

The QSGD widths 1..16: the decodes (the pack path against the JAX jnp decode,
the fused twin against the Pallas kernel in interpret mode) and the bare
pack and unpack are bit for bit. The encodes, given the JAX draws through
the ``uniforms=`` hook, emit the JAX codec's words bit for bit in every
bucket whose scale is the same float (the scales agree within rtol 1e-6:
the packages sum a bucket's squares in other orders); in a bucket whose
scale sits one ulp away, a code may move one level, since at 12 bits and
more the ulp moves |x|/s * (2^b - 1) by a visible fraction of a level.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu import budget as jb
from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.codecs import encode_tree as jax_encode_tree
from atomo_tpu.codecs.svd import SvdCodec as JaxSvd
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.ops import pallas_quantize_pack, pallas_unpack_dequantize
from atomo_tpu.ops.qsgd_kernels import pallas_pack_bucketed, pallas_unpack_bucketed
from atomo_tpu_torch import budget as pb
from atomo_tpu_torch.codecs import (
    QsgdCodec,
    QsgdPayload,
    SvdCodec,
    codec_subset,
    decode_mean_tree,
    decode_tree,
    encode_leaf_subset,
    encode_tree,
    leaf_codec,
)
from atomo_tpu_torch.convert import jax_leaf_paths, jax_view
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.ops import qsgd_kernels as K
from atomo_tpu_torch.training.trainer import leaf_params

BUCKET = 512


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_shapes(network: str):
    """(names, JAX-layout shapes) of a registry model's leaves."""
    model = get_model(network, 10, image_shape=(32, 32, 3) if network != "LeNet" else
                      (28, 28, 1))
    return jax_leaf_paths(model), [tuple(jax_view(p.detach()).shape)
                                   for p in leaf_params(model)]


def _lenet_grad(seed: int):
    """A LeNet-shaped gradient (numpy, JAX layout, canonical order) and the
    same as the Flax params tree, each leaf at its own scale."""
    params = jax_model("LeNet", 10).init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)),
                                         train=False)["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(l.shape) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
            for l in leaves]
    return arrs, jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in arrs])


CODECS = {
    "svd3": (lambda: SvdCodec(rank=3), lambda: JaxSvd(rank=3)),
    "qsgd4": (lambda: QsgdCodec(bits=4), lambda: JaxQsgd(bits=4)),
}


def _spectra_pair(code: str, seed: int = 0):
    """The port's and the JAX package's measured spectra of one gradient."""
    port_c, jax_c = CODECS[code]
    arrs, tree = _lenet_grad(seed)
    want = jb.measure_spectra(jax_c(), tree)
    got = pb.measure_spectra(port_c(), [_t(a) for a in arrs], [w.name for w in want],
                             [False] * len(arrs))
    return got, want


def _port_spectra(want):
    return [pb.LayerSpectrum(**dataclasses.asdict(w)) for w in want]


@pytest.mark.parametrize("budget", ["none", "explicit", "huge", "uniform"])
@pytest.mark.parametrize("code", ["svd3", "qsgd4"])
def test_solve_allocation_equals_jax(code, budget):
    """On the same spectra: ks, bytes and describe() letter for letter."""
    _, want_spectra = _spectra_pair(code, seed=1)
    spectra = _port_spectra(want_spectra)
    port_c, jax_c = CODECS[code]
    uniform = jb.allocator.allocation_payload_bytes(jax_c(), want_spectra,
                                                    jb.uniform_ks(want_spectra))
    b = {"none": None, "explicit": int(0.8 * uniform), "huge": 10 ** 12,
         "uniform": None}[budget]
    mode = "uniform" if budget == "uniform" else "variance"
    want = jb.solve_allocation(jax_c(), want_spectra, budget_bytes=b, mode=mode)
    got = pb.solve_allocation(port_c(), spectra, budget_bytes=b, mode=mode)
    assert got.ks == want.ks and got.mode == want.mode
    assert got.payload_bytes == want.payload_bytes and got.budget_bytes == want.budget_bytes
    assert got.predicted_variance == pytest.approx(want.predicted_variance, rel=1e-12)
    assert got.describe() == want.describe()
    assert got.payload_bytes == pb.allocation_payload_bytes(port_c(), spectra, got.ks)
    assert pb.allocation_leaf_budgets(port_c(), spectra, got.ks) == \
        [tuple(p) for p in jb.allocation_leaf_budgets(jax_c(), want_spectra, want.ks)]
    if budget == "none" and code == "qsgd4":  # mixed widths, the case the slice is for
        assert len(set(got.ks)) > 1 and max(got.ks) > 8
    if budget == "huge" and code == "svd3":  # spend-everything: every leaf exact
        assert pb.predicted_variance(spectra, got.ks, port_c()) == 0.0


@pytest.mark.parametrize("code", ["svd3", "qsgd4"])
def test_measure_spectra_equals_jax(code):
    got, want = _spectra_pair(code, seed=2)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert (g.index, g.name, g.shape, g.dense_bytes, g.r_full, g.base_k, g.adaptive) == \
            (w.index, w.name, w.shape, w.dense_bytes, w.r_full, w.base_k, w.adaptive)
        if code == "svd3":
            assert g.a == pytest.approx(w.a, rel=1e-5)
        else:
            assert g.a == w.a
    port_c, jax_c = CODECS[code]
    assert pb.solve_allocation(port_c(), got).ks == jb.solve_allocation(jax_c(), want).ks


def test_measure_spectra_reads_port_tensors_in_the_jax_layout():
    """Port-layout tensors (conv OIHW, linear (out, in)) give the spectra of
    their JAX-layout views, names from ``jax_leaf_paths``."""
    model = get_model("LeNet", 10, image_shape=(28, 28, 1))
    rng = np.random.default_rng(5)
    grads = [_t(rng.standard_normal(p.shape).astype(np.float32)) for p in leaf_params(model)]
    views = [jax_view(g).contiguous() for g in grads]
    for code in CODECS:
        c = CODECS[code][0]()
        a = pb.measure_spectra(c, grads, jax_leaf_paths(model))
        b = pb.measure_spectra(c, views, jax_leaf_paths(model), [False] * len(views))
        assert a == b and a[1].name == "['Conv_0']['kernel']"


@pytest.mark.parametrize("network", ["LeNet", "ResNet18"])
@pytest.mark.parametrize("family", ["svd", "qsgd"])
def test_leaf_payload_bytes_equal_jax_at_every_knob(family, network):
    """Ranks 1..r_full (SVD, fixed_k) and widths 1..16 (QSGD) on every leaf
    shape of the model: the port's pricing is the JAX codec's, byte for byte."""
    _, shapes = _jax_shapes(network)
    for shape in set(shapes):
        if family == "qsgd":
            for b in range(1, pb.allocator.MAX_BITS + 1):
                assert QsgdCodec(bits=b).leaf_payload_bytes(shape) == \
                    JaxQsgd(bits=b).leaf_payload_bytes(shape), (shape, b)
            continue
        r_full = min(SvdCodec()._dims(shape))
        for r in range(1, r_full + 1):
            assert SvdCodec(rank=r).leaf_payload_bytes(shape) == \
                JaxSvd(rank=r).leaf_payload_bytes(shape), (shape, r)


def _fields(words, bits):
    """(R, vpw * nw) int64 codes of (R, nw) words."""
    w = torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32))
    g = K.geometry(0, bits)._replace(n_words=w.shape[-1])
    return K._split_fields(w.view(torch.uint32), g).reshape(w.shape[0], -1).numpy()


def _assert_words_match(got_w, got_s, want_w, want_s, bits):
    """Words bit for bit in buckets whose scales are the same float; one
    level at most, sign equal, where they sit an ulp apart."""
    got_w, want_w = np.asarray(got_w).reshape(-1, np.asarray(got_w).shape[-1]), \
        np.asarray(want_w).reshape(-1, np.asarray(want_w).shape[-1])
    got_s, want_s = np.asarray(got_s).reshape(-1), np.asarray(want_s).reshape(-1)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    same = got_s == want_s
    np.testing.assert_array_equal(got_w[same], want_w[same])
    if (~same).any():
        a, b = _fields(got_w[~same], bits), _fields(want_w[~same], bits)
        np.testing.assert_array_equal(a >> bits, b >> bits)
        assert int(np.abs((a & ((1 << bits) - 1)) - (b & ((1 << bits) - 1))).max()) <= 1


@pytest.mark.parametrize("bits", range(1, 17))
def test_qsgd_widths_match_jax(bits):
    """Both plain paths at width ``bits`` against the JAX codec given its
    uniforms, the decodes and the bare pack/unpack bit for bit."""
    for n in (1000, 9000):
        rng = np.random.default_rng(1000 * bits + n)
        x = rng.standard_normal(n).astype(np.float32)
        key = jax.random.PRNGKey(n + bits)
        jc = JaxQsgd(bits=bits, use_pallas=False)
        pj = jc.encode(key, jnp.asarray(x))
        u = np.asarray(jax.random.uniform(key, (-(-n // BUCKET), BUCKET), jnp.float32))
        dj = np.asarray(jc.decode(pj, (n,)))
        for use_kernel in (True, False):
            pt = QsgdCodec(bits=bits, use_kernel=use_kernel).encode(0, _t(x), uniforms=_t(u))
            assert pt.words.shape == pj.words.shape
            _assert_words_match(pt.words.numpy(), pt.scales.numpy(), pj.words, pj.scales, bits)
        back = QsgdCodec(bits=bits, use_kernel=False).decode(
            QsgdPayload(_t(pj.words), _t(pj.scales)), (n,))
        np.testing.assert_array_equal(back.numpy(), dj)
        if n > 1000:
            continue
        # the fused twin against the Pallas kernels (interpret mode)
        wj, sj = pallas_quantize_pack(jnp.asarray(x), 0, jnp.asarray(u), bits=bits,
                                      bucket_size=BUCKET, scheme="qsgd", interpret=True)
        wt, st = K.quantize_pack(_t(x), bits=bits, bucket_size=BUCKET, u=_t(u))
        _assert_words_match(wt.numpy(), st.numpy(), wj, sj, bits)
        dk = pallas_unpack_dequantize(wj, sj, bits=bits, bucket_size=BUCKET, n=n, interpret=True)
        np.testing.assert_array_equal(
            K.unpack_dequantize(_t(wj), _t(sj), bits=bits, bucket_size=BUCKET, n=n).numpy(),
            np.asarray(dk))
    codes = rng.integers(0, 1 << (bits + 1), (5, K.padded_bucket(BUCKET, bits)))
    pk = pallas_pack_bucketed(jnp.asarray(codes.astype(np.uint32)), bits=bits, interpret=True)
    wt = K.pack_bucketed(_t(codes.astype(np.int32)), bits)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(pk))
    np.testing.assert_array_equal(
        K.unpack_bucketed(wt, bits).numpy().astype(np.uint32),
        np.asarray(pallas_unpack_bucketed(pk, bits=bits, interpret=True)))


def test_geometry_takes_widths_up_to_16():
    g = [K.geometry(1000, b) for b in (8, 9, 10, 15, 16)]
    assert [x.vpw for x in g] == [3, 3, 2, 2, 1]
    assert [x.bucket_p for x in g] == [513, 513, 512, 512, 512]
    assert QsgdCodec(bits=16).levels == 65535
    with pytest.raises(ValueError, match="1..16"):
        K.geometry(10, 17)


def _tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return [_t(rng.standard_normal(s).astype(np.float32) * (0.01 * (1 + i % 5)))
            for i, s in enumerate(shapes)]


# port-layout shapes: conv OIHW, linear (out, in), and two of one shape
TREE = [(8, 3, 3, 3), (8,), (16, 8, 3, 3), (16,), (16, 8, 3, 3), (10, 64), (10,)]
BASES = {
    "svd": lambda: SvdCodec(rank=2),
    "qsgd_fused": lambda: QsgdCodec(bits=4, use_kernel=True),
    "qsgd_pack": lambda: QsgdCodec(bits=4, use_kernel=False, pack_kernel=True),
}


def _equal_payloads(a, b):
    assert type(a) is type(b)
    for x, y in zip(a, b):
        if x.dtype == torch.uint32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("base", sorted(BASES))
def test_wrapper_at_uniform_knobs_is_the_plain_codec(base):
    """The degenerate point: the wrapper with every leaf at the base knob
    gives the plain codec's payloads and decodes bit for bit."""
    c = BASES[base]()
    knob = pb.allocator.knob_name(c)
    wrapped = pb.budgeted_codec(c, [getattr(c, knob)] * len(TREE))
    assert all(w == c for w in wrapped.codecs)
    grads = _tree(TREE, 3)
    plain, ps = encode_tree(c, 77, grads)
    per, ws = encode_tree(wrapped, 77, grads)
    assert ps == ws
    for a, b in zip(plain, per):
        _equal_payloads(a, b)
    for a, b in zip(decode_tree(c, plain, grads), decode_tree(wrapped, per, grads)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("base", sorted(BASES))
def test_mixed_knobs_encode_each_leaf_with_its_codec(base):
    """Different knobs on leaves of one shape: every payload is its leaf's
    own codec's under the leaf's global seed, and the gathered decode of two
    replicas is each group's decode_mean."""
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets

    c = BASES[base]()
    ks = [1, 3, 2, 5, 9, 16, 4] if "qsgd" in base else [1, 1, 3, 2, 1, 4, 2]
    wrapped = pb.budgeted_codec(c, ks)
    grads = _tree(TREE, 4)
    payloads, stats = encode_tree(wrapped, 5, grads)
    assert stats.payload_bytes == sum(
        leaf_codec(wrapped, i).leaf_payload_bytes(tuple(jax_view(g).shape))
        for i, g in enumerate(grads))
    for i, p in enumerate(payloads):
        _equal_payloads(p, encode_leaf_subset(wrapped.codec_for(i), 5, grads, [i])[0])
    decoded = decode_tree(wrapped, payloads, grads)
    for i, (g, d) in enumerate(zip(grads, decoded)):
        assert d.shape == g.shape
        want = decode_tree(wrapped.codec_for(i), [payloads[i]], [g])[0]
        assert torch.equal(d, want)
    other, _ = encode_tree(wrapped, 6, grads)
    bufs = [pack_tree_buckets(p) for p in (payloads, other)]
    gathered = torch.stack([b for b, _ in bufs])
    parts = unpack_tree_buckets(gathered, bufs[0][1])
    mean = decode_mean_tree(wrapped, parts, grads, 2)
    for i, g in enumerate(grads):
        want = decode_mean_tree(wrapped.codec_for(i), [parts[i]], [g], 2)[0]
        assert torch.equal(mean[i], want)


def test_mixed_widths_match_the_jax_wrapper():
    """The JAX PerLeafCodec's encode_tree (jnp codec) and the port's at the
    allocator's mixed widths, the JAX draws fed per leaf."""
    arrs, tree = _lenet_grad(6)
    ks = (4, 15, 1, 15, 15, 3, 4, 15)
    jw = jb.budgeted_codec(JaxQsgd(bits=4, use_pallas=False), ks)
    key = jax.random.PRNGKey(9)
    want, _ = jax_encode_tree(jw, key, tree)
    want = jax.tree_util.tree_leaves(want, is_leaf=lambda x: hasattr(x, "words"))
    u = [_t(jax.random.uniform(jax.random.fold_in(key, i), (-(-a.size // BUCKET), BUCKET)))
         for i, a in enumerate(arrs)]
    for use_kernel in (True, False):
        pw = pb.budgeted_codec(QsgdCodec(bits=4, use_kernel=use_kernel), ks)
        got, _ = encode_tree(pw, 0, [_t(a) for a in arrs], draws=u,
                             layouts=[False] * len(arrs))
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_words_match(g.words.numpy(), g.scales.numpy(), w.words, w.scales, ks[i])


def test_per_leaf_codec_contract():
    c = QsgdCodec(bits=4)
    w = pb.budgeted_codec(c, [2, 9, 16])
    assert w.ks == (2, 9, 16) and w.name == "qsgd+ab" and w.n_leaves == 3
    assert leaf_codec(w, 1).bits == 9 and leaf_codec(c, 5) is c
    with pytest.raises(IndexError, match="covers 3 leaves"):
        w.codec_for(3)
    sub = codec_subset(w, [2, 0])
    assert sub.ks == (16, 2) and codec_subset(c, [2, 0]) is c
    assert not hasattr(w, "encode") and not hasattr(w, "decode")
    s = pb.budgeted_codec(SvdCodec(rank=3), [1, 5])
    assert s.ks == (1, 5) and s.name == "svd+ab"


def test_artifact_round_trip_reuse_and_refusal(tmp_path):
    """budget_alloc.json: the document equals the JAX package's on the same
    spectra, round-trips, is reused for the same codec and leaf count and
    refused otherwise, with the JAX package's reasons."""
    got_s, want_s = _spectra_pair("qsgd4", seed=3)
    spectra = _port_spectra(want_s)
    alloc = pb.solve_allocation(QsgdCodec(bits=4), spectra)
    doc = pb.new_alloc_doc(QsgdCodec(bits=4), spectra, alloc)
    jdoc = jb.new_alloc_doc(JaxQsgd(bits=4), want_s,
                            jb.solve_allocation(JaxQsgd(bits=4), want_s))
    assert json.loads(json.dumps(doc)) == json.loads(json.dumps(jdoc))
    path = pb.write_alloc(str(tmp_path), doc)
    assert path == str(tmp_path / pb.BUDGET_ALLOC_NAME)
    back = pb.read_alloc(str(tmp_path))
    assert back == json.loads(json.dumps(doc))
    assert pb.latest_epoch(back)["ks"] == list(alloc.ks)
    for kw in ({"codec_name": "qsgd", "n_leaves": 8}, {"codec_name": "svd", "n_leaves": 8},
               {"codec_name": "qsgd", "n_leaves": 9}):
        assert pb.alloc_reusable(back, **kw) == jb.alloc_reusable(back, **kw)
    assert pb.alloc_reusable(back, codec_name="qsgd", n_leaves=8)[0]
    assert not pb.alloc_reusable(back, codec_name="svd", n_leaves=8)[0]
    assert pb.alloc_reusable(None, codec_name="qsgd", n_leaves=8) == \
        jb.alloc_reusable(None, codec_name="qsgd", n_leaves=8)
    assert pb.read_alloc(str(tmp_path / "none")) is None
    doc2 = pb.append_epoch(back, QsgdCodec(bits=4), spectra,
                           dataclasses.replace(alloc, epoch=1), 10)
    assert pb.latest_epoch(doc2)["start_step"] == 10
    assert pb.allocation_meta(pb.latest_epoch(doc2)) == jb.allocation_meta(
        pb.latest_epoch(doc2))


def test_spectra_from_qerr2_equals_jax():
    _, want_s = _spectra_pair("svd3", seed=4)
    spectra = _port_spectra(want_s)
    ks = jb.uniform_ks(want_s)
    q = [0.5 * (i + 1) if i != 3 else float("nan") for i in range(len(ks))]
    for port_c, jax_c in (CODECS["svd3"], CODECS["qsgd4"]):
        got = pb.spectra_from_qerr2(spectra, q, ks, port_c())
        want = jb.spectra_from_qerr2(want_s, q, ks, jax_c())
        assert [g.a for g in got] == [w.a for w in want]
