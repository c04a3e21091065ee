"""The port's QSGD kernels' plain twins and codec against the JAX package.

Inputs come from numpy seeds and go through both packages. The Pallas
kernels run in interpret mode with explicit uniforms, as the JAX package's
own tests run them on the CPU. Tolerances: words and dequantized values are
compared bit for bit; scales within rtol 1e-6, since the two packages sum a
bucket's squares in different orders (float32, 512 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.ops import pallas_quantize_pack, pallas_unpack_dequantize
from atomo_tpu.ops.qsgd_kernels import pallas_pack_bucketed, pallas_unpack_bucketed
from atomo_tpu_torch.codecs import QsgdCodec, QsgdPayload, terngrad
from atomo_tpu_torch.ops import qsgd_kernels as K

BITS = [1, 2, 4, 8]
SCHEMES = ["qsgd", "terngrad"]
SIZES = [512, 1000, 4113]
BUCKET = 512


def _inputs(bits, n, scheme="qsgd"):
    rng = np.random.default_rng(1000 * bits + n + (7 if scheme == "terngrad" else 0))
    x = rng.standard_normal(n).astype(np.float32)
    u = rng.random((-(-n // BUCKET), BUCKET)).astype(np.float32)
    return x, u


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_pack_plain_matches_pallas(bits, scheme, n):
    x, u = _inputs(bits, n, scheme)
    wj, sj = pallas_quantize_pack(
        jnp.asarray(x), 0, jnp.asarray(u), bits=bits, bucket_size=BUCKET,
        scheme=scheme, interpret=True,
    )
    wt, st = K.quantize_pack(_t(x), bits=bits, bucket_size=BUCKET, scheme=scheme, u=_t(u))
    assert wt.dtype == torch.uint32 and st.dtype == torch.float32
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    # the decode twin repeats the Pallas decode bit for bit
    dj = pallas_unpack_dequantize(wj, sj, bits=bits, bucket_size=BUCKET, n=n, interpret=True)
    dt = K.unpack_dequantize(_t(wj), _t(sj), bits=bits, bucket_size=BUCKET, n=n)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("bits", BITS)
def test_codec_encode_matches_jax_codec(bits, scheme, n):
    """Both port paths (fused twin, torch quantizer + pack) emit the JAX
    codec's words given its uniforms, and decode its payload as it does."""
    x, _ = _inputs(bits, n, scheme)
    key = jax.random.PRNGKey(n + bits)
    jc = JaxQsgd(bits=bits, scheme=scheme, use_pallas=False)
    pj = jc.encode(key, jnp.asarray(x))
    u = np.asarray(jax.random.uniform(key, (-(-n // BUCKET), BUCKET), jnp.float32))
    dj = np.asarray(jc.decode(pj, (n,)))
    for use_kernel in (True, False):
        pc = QsgdCodec(bits=bits, scheme=scheme, use_kernel=use_kernel)
        pt = pc.encode(0, _t(x), uniforms=_t(u))
        np.testing.assert_array_equal(pt.words.numpy(), np.asarray(pj.words))
        np.testing.assert_allclose(pt.scales.numpy(), np.asarray(pj.scales), rtol=1e-6)
        if not use_kernel:  # the torch decode repeats the jnp decode
            back = pc.decode(QsgdPayload(_t(pj.words), _t(pj.scales)), (n,))
            np.testing.assert_array_equal(back.numpy(), dj)


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_bucketed_match_pallas(bits):
    bucket_p = K.padded_bucket(BUCKET, bits)
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << (bits + 1), (9, bucket_p)).astype(np.uint32)
    wj = pallas_pack_bucketed(jnp.asarray(codes), bits=bits, interpret=True)
    wt = K.pack_bucketed(_t(codes.astype(np.int32)), bits)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    cj = pallas_unpack_bucketed(wj, bits=bits, interpret=True)
    ct = K.unpack_bucketed(wt, bits)
    np.testing.assert_array_equal(ct.numpy().astype(np.uint32), np.asarray(cj))
    with pytest.raises(ValueError):
        K.pack_bucketed(torch.zeros((2, bucket_p + 1), dtype=torch.int32), bits)


@pytest.mark.parametrize("bits", [2, 4])
def test_payloads_cross_decode(bits):
    """A payload of either package decodes identically in the other."""
    n = 1000
    x, _ = _inputs(bits, n)
    jc = JaxQsgd(bits=bits, use_pallas=False)
    pc = QsgdCodec(bits=bits, use_kernel=True)
    # port payload, drawn by the in-kernel generator's twin
    pt = pc.encode(12345, _t(x))
    from_jax = np.asarray(jc.decode(
        type(jc.encode(jax.random.PRNGKey(0), jnp.asarray(x)))(
            jnp.asarray(pt.words.numpy()), jnp.asarray(pt.scales.numpy())),
        (n,),
    ))
    np.testing.assert_array_equal(pc.decode(pt, (n,)).numpy(), from_jax)
    # JAX payload
    pj = jc.encode(jax.random.PRNGKey(9), jnp.asarray(x))
    np.testing.assert_array_equal(
        QsgdCodec(bits=bits, use_kernel=False).decode(
            QsgdPayload(_t(pj.words), _t(pj.scales)), (n,)).numpy(),
        np.asarray(jc.decode(pj, (n,))),
    )


def test_philox_twin_known_answers():
    """The generator twin is Philox4x32-10 (Random123's test vectors)."""
    def run(c, k):
        t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
        return [int(v) for v in K.philox4x32_10([t(a) for a in c], t(k[0]), t(k[1]))]

    assert run((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_unbiasedness_over_seeds(use_kernel):
    """E_seed[decode(encode(x))] ~= x for both RNG paths (the check of
    tests/test_pallas_ops.py::test_unbiasedness_over_seeds)."""
    n, trials = 512, 200
    x = _t(np.random.default_rng(2).standard_normal(n).astype(np.float32))
    codec = QsgdCodec(bits=2, use_kernel=use_kernel)
    acc = torch.zeros(n, dtype=torch.float64)
    for seed in range(trials):
        acc += codec.decode(codec.encode(seed, x), (n,)).double()
    scale = float(torch.linalg.vector_norm(x))
    np.testing.assert_allclose((acc / trials).numpy(), x.numpy(),
                               atol=4 * scale / 3 / np.sqrt(trials))


def test_stacked_leaves_equal_one_by_one():
    """Encoding an (L, n) stack equals encoding each leaf alone."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((3, 700)).astype(np.float32))
    for codec in (QsgdCodec(bits=4, use_kernel=True), terngrad(use_kernel=True),
                  QsgdCodec(bits=4, use_kernel=False)):
        stacked = codec.encode_stack(x, [11, 22, 33])
        for i, s in enumerate([11, 22, 33]):
            one = codec.encode(s, x[i])
            np.testing.assert_array_equal(stacked.words[i].numpy(), one.words.numpy())
            np.testing.assert_array_equal(stacked.scales[i].numpy(), one.scales.numpy())
        back = codec.decode_stack(stacked, 700)
        for i in range(3):
            one = QsgdPayload(stacked.words[i], stacked.scales[i])
            np.testing.assert_array_equal(back[i].numpy(), codec.decode(one, (700,)).numpy())


def test_leaf_payload_bytes_match_jax():
    for bits in BITS:
        for shape in [(3, 3, 64, 64), (10,), (512, 10), (4113,)]:
            assert (QsgdCodec(bits=bits).leaf_payload_bytes(shape)
                    == JaxQsgd(bits=bits).leaf_payload_bytes(shape))


def test_quantize_pack_rejects_bad_arguments():
    with pytest.raises(ValueError):
        K.quantize_pack(torch.zeros(10), bits=2)  # neither seeds nor u
    with pytest.raises(ValueError):  # the kernels take widths 1..16
        K.quantize_pack(torch.zeros(10), bits=17, seeds=[1])
    with pytest.raises(ValueError):
        K.quantize_pack(torch.zeros(10), bits=0, seeds=[1])


# ------------------------------------------------------------- the tree encode
#
# One quantize_pack_tree call over every leaf of a gradient tree (one launch
# on the card) against the per-shape-group stacks it replaced. The plain
# twins run here; the card tests hold the kernel against them.


def _resnet_like_shapes():
    """ResNet-18's 62 leaf shapes (port layout, 17 shape groups), channels
    cut 16x so that the plain twins run quickly."""
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training.trainer import leaf_params

    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    return [tuple(d // 16 if d >= 64 else d for d in p.shape) for p in leaf_params(model)]


def _tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return [_t(rng.standard_normal(s).astype(np.float32) * (0.01 * (1 + i % 7)))
            for i, s in enumerate(shapes)]


def _uniforms(views, seed, bucket=BUCKET):
    rng = np.random.default_rng(seed)
    return [_t(rng.random((-(-v.numel() // bucket), bucket)).astype(np.float32)) for v in views]


@pytest.mark.parametrize("mode", ["seeds", "uniforms"])
@pytest.mark.parametrize("codec", [f"qsgd{b}" for b in BITS] + ["terngrad"])
def test_tree_encode_equals_per_group_stacks(codec, mode):
    """encode_leaves (one tree call) gives the per-shape-group encode_stack
    path's words and scales bit for bit on ResNet-18's leaf shapes."""
    from atomo_tpu_torch.codecs.base import _views, encode_groups

    c = (terngrad(use_kernel=True) if codec == "terngrad"
         else QsgdCodec(bits=int(codec[4:]), use_kernel=True))
    shapes = _resnet_like_shapes()
    assert len(shapes) == 62 and len(set(shapes)) == 17
    views = _views(_tree(shapes, 3), None)
    seeds = [1000003 * (i + 1) + c.bits for i in range(len(views))]
    draws = _uniforms(views, 4) if mode == "uniforms" else None
    tree = c.encode_leaves(views, seeds, draws)
    groups = encode_groups(c, views, seeds, draws)
    for t, g in zip(tree, groups):
        assert torch.equal(t.words.view(torch.int32), g.words.view(torch.int32))
        assert torch.equal(t.scales, g.scales)


@pytest.mark.parametrize("bits,scheme", [(2, "qsgd"), (4, "qsgd"), (1, "terngrad")])
def test_tree_encode_matches_jax_codec_per_leaf(bits, scheme):
    """Given the JAX codec's uniforms, each leaf of one tree encode carries
    the words the JAX codec emits for that leaf alone."""
    sizes = [4113, 700, 4113, 64, 1000]
    rng = np.random.default_rng(bits)
    xs = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    jc = JaxQsgd(bits=bits, scheme=scheme, use_pallas=False)
    keys = [jax.random.PRNGKey(100 + i) for i in range(len(sizes))]
    want = [jc.encode(k, jnp.asarray(x)) for k, x in zip(keys, xs)]
    u = [_t(jax.random.uniform(k, (-(-n // BUCKET), BUCKET), jnp.float32))
         for k, n in zip(keys, sizes)]
    got = QsgdCodec(bits=bits, scheme=scheme, use_kernel=True).encode_leaves(
        [_t(x) for x in xs], list(range(len(xs))), u)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.words.numpy(), np.asarray(w.words))
        np.testing.assert_allclose(g.scales.numpy(), np.asarray(w.scales), rtol=1e-6)


def test_encode_tree_makes_one_tree_call(monkeypatch):
    """encode_tree on a fused QSGD codec makes one quantize_pack_tree call
    for the whole tree and no per-group call; the torch-quantizer path makes
    one pack_bucketed_tree call and no per-group pack."""
    from atomo_tpu_torch.codecs import encode_tree
    from atomo_tpu_torch.codecs import qsgd as qsgd_mod

    calls = {"tree": 0, "stack": 0, "pack": 0, "pack_tree": 0}
    tree, stack = K.quantize_pack_tree, K.quantize_pack

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(K, "quantize_pack_tree", count("tree", tree))
    monkeypatch.setattr(K, "quantize_pack", count("stack", stack))
    grads = _tree(_resnet_like_shapes(), 5)
    payloads, stats = encode_tree(QsgdCodec(bits=4, use_kernel=True), 9, grads)
    assert calls == {"tree": 1, "stack": 0, "pack": 0, "pack_tree": 0}
    assert len(payloads) == 62
    assert stats.payload_bytes == sum(QsgdCodec(bits=4).leaf_payload_bytes(tuple(g.shape))
                                      for g in grads)
    monkeypatch.setattr(qsgd_mod, "pack_bucketed", count("pack", qsgd_mod.pack_bucketed))
    monkeypatch.setattr(qsgd_mod, "pack_bucketed_tree",
                        count("pack_tree", qsgd_mod.pack_bucketed_tree))
    encode_tree(QsgdCodec(bits=4, use_kernel=False), 9, grads)
    assert calls == {"tree": 1, "stack": 0, "pack": 0, "pack_tree": 1}


def test_tree_wrapper_checks_its_arguments():
    x = [torch.zeros(10), torch.zeros(600)]
    with pytest.raises(ValueError, match="seeds"):
        K.quantize_pack_tree(x, bits=2, seeds=[1])
    with pytest.raises(ValueError):
        K.quantize_pack_tree(x, bits=2)  # neither seeds nor u
    assert K.quantize_pack_tree([], bits=2, seeds=[]) == []
