"""The pack path's tree encode and tree bit-pack against the per-group path
they replaced and against the JAX package.

``encode_tree`` on a QSGD codec with the torch quantizer (``use_kernel=False``,
the CLI's ``--qsgd-path pack``) runs the quantizer once over the bucket rows
of every leaf and packs them with one ``pack_bucketed_tree`` call. Here, on
the CPU, the wrapper runs its plain twin; the card tests
(``tests/test_torch_cuda.py``) hold the kernel against that twin. Inputs are
made from numpy seeds.

Tolerances: words and scales equal the per-shape-group path's
(``encode_groups`` over ``encode_stack``) bit for bit, and the tree pack
equals the per-group pack and the JAX package's ``pallas_pack_bucketed``
(interpret mode) bit for bit. Against the JAX codec with ``pack_kernel=True``
words are equal and scales within rtol 1e-6, the tolerance of
``tests/test_torch_qsgd.py``: the two packages sum a bucket's squares in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.ops.qsgd_kernels import pallas_pack_bucketed
from atomo_tpu_torch.codecs import QsgdCodec, encode_tree, terngrad
from atomo_tpu_torch.codecs import qsgd as qsgd_mod
from atomo_tpu_torch.codecs.base import _shape_groups, _views, encode_groups
from atomo_tpu_torch.ops import qsgd_kernels as K
from atomo_tpu_torch.utils.rng import fold_in

BUCKET = 512
CODECS = [f"qsgd{b}" for b in range(1, 9)] + ["terngrad"]


def _codec(name, bucket_size=BUCKET):
    if name == "terngrad":
        return terngrad(bucket_size=bucket_size, use_kernel=False)
    return QsgdCodec(bits=int(name[4:]), bucket_size=bucket_size, use_kernel=False)


def _shapes(model):
    """Port-layout leaf shapes: ResNet-18's 62 (17 shape groups) with its
    channels cut 16x, or a small transformer LM's."""
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.training.trainer import leaf_params

    if model == "resnet18":
        shapes = [tuple(p.shape) for p in
                  leaf_params(get_model("resnet18", 10, image_shape=(32, 32, 3)))]
        return [tuple(d // 16 if d >= 64 else d for d in s) for s in shapes]
    lm = TransformerLM(vocab_size=16, max_len=8, width=16, depth=2, num_heads=2)
    return [tuple(p.shape) for p in leaf_params(lm)]


def _grads(model, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * (0.01 * (1 + i % 7)))
            for i, s in enumerate(_shapes(model))]


def _leaf_codes(shapes, bits, seed):
    """Per leaf, (n_buckets, bucket_p) int32 codes as the quantizer leaves
    them: random fields at the bucket's positions, zero past them."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        g = K.geometry(int(np.prod(s)), bits, BUCKET)
        c = np.zeros((g.n_buckets, g.bucket_p), np.int32)
        c[:, :BUCKET] = rng.integers(0, 1 << g.bpv, (g.n_buckets, BUCKET))
        out.append(torch.from_numpy(c))
    return out


def _same_words(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("model", ["resnet18", "lm"])
@pytest.mark.parametrize("bits", range(1, 9))
def test_tree_pack_equals_per_group_pack_and_pallas(bits, model):
    """One tree pack over every leaf's rows equals the per-shape-group packs
    and the JAX package's Pallas pack kernel (interpret mode)."""
    shapes = _shapes(model)
    per_leaf = _leaf_codes(shapes, bits, bits)
    codes = torch.cat(per_leaf)
    rows = [c.shape[0] for c in per_leaf]
    got = K.pack_bucketed_tree_plain(codes, rows, bits=bits)
    assert got[0].dtype == torch.uint32 and [w.shape[0] for w in got] == rows
    assert all(_same_words(a, b) for a, b in zip(got, K.pack_bucketed_tree(codes, rows, bits=bits)))
    for idxs in _shape_groups(shapes).values():
        words = K.pack_bucketed_plain(torch.cat([per_leaf[i] for i in idxs]), bits)
        for i, w in zip(idxs, words.split([rows[i] for i in idxs])):
            assert _same_words(got[i], w)
    want = np.asarray(pallas_pack_bucketed(jnp.asarray(codes.numpy().astype(np.uint32)),
                                           bits=bits, interpret=True))
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("mode", ["seeds", "uniforms"])
@pytest.mark.parametrize("codec", CODECS)
def test_tree_encode_equals_per_group_encode(codec, mode):
    """encode_leaves on the pack path (one quantizer pass, one tree pack)
    gives the per-shape-group encode_stack path's words and scales bit for
    bit on ResNet-18's leaf shapes, from seeds or given uniforms."""
    c = _codec(codec)
    views = _views(_grads("resnet18", 3), None)
    seeds = [1000003 * (i + 1) + c.bits for i in range(len(views))]
    draws = None
    if mode == "uniforms":
        rng = np.random.default_rng(4)
        draws = [torch.from_numpy(rng.random((-(-v.numel() // BUCKET), BUCKET)).astype(np.float32))
                 for v in views]
    tree = c.encode_leaves(views, seeds, draws)
    groups = encode_groups(c, views, seeds, draws)
    assert len(tree) == 62
    for t, g in zip(tree, groups):
        assert t.words.dtype == torch.uint32 and _same_words(t.words, g.words)
        assert torch.equal(t.scales, g.scales)


@pytest.mark.parametrize("bucket_size", [16, 100, 1000, 2048])
def test_tree_encode_at_other_bucket_sizes(bucket_size):
    """Buckets below a word's worth of fields and above 512, on the small
    LM's leaves (embedding tables and vectors included)."""
    c = _codec("qsgd3", bucket_size)
    grads = _grads("lm", bucket_size)
    tree, _ = encode_tree(c, 5, grads)
    groups = encode_groups(c, _views(grads, None), [fold_in(5, i) for i in range(len(grads))])
    for t, g in zip(tree, groups):
        assert _same_words(t.words, g.words) and torch.equal(t.scales, g.scales)


@pytest.mark.parametrize("bits,scheme", [(2, "qsgd"), (4, "qsgd"), (1, "terngrad")])
def test_tree_encode_matches_jax_pack_kernel_codec(bits, scheme):
    """Given the JAX codec's uniforms, each leaf of one tree encode carries
    the words the JAX codec with pack_kernel=True (its Pallas pack kernel in
    interpret mode) emits for that leaf alone."""
    sizes = [4113, 700]
    rng = np.random.default_rng(bits)
    xs = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    jc = JaxQsgd(bits=bits, scheme=scheme, use_pallas=False, pack_kernel=True)
    keys = [jax.random.PRNGKey(100 + i) for i in range(len(sizes))]
    want = [jc.encode(k, jnp.asarray(x)) for k, x in zip(keys, xs)]
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (-(-n // BUCKET), BUCKET),
                                                        jnp.float32)))
         for k, n in zip(keys, sizes)]
    got = QsgdCodec(bits=bits, scheme=scheme, use_kernel=False).encode_leaves(
        [torch.from_numpy(x) for x in xs], [0, 1], u)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.words.numpy(), np.asarray(w.words))
        np.testing.assert_allclose(g.scales.numpy(), np.asarray(w.scales), rtol=1e-6)


@pytest.mark.parametrize("codec", ["qsgd4", "terngrad"])
def test_encode_tree_makes_one_pack_tree_call(monkeypatch, codec):
    """encode_tree on the pack path makes one pack_bucketed_tree call for
    the whole tree and no per-group pack; its payloads are views of one
    words and one scales buffer."""
    calls = {"pack_bucketed_tree": 0, "pack_bucketed": 0}

    def count(name):
        fn = getattr(qsgd_mod, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(qsgd_mod, name, wrapped)

    for name in calls:
        count(name)
    grads = _grads("resnet18", 5)
    payloads, stats = encode_tree(_codec(codec), 9, grads)
    assert calls == {"pack_bucketed_tree": 1, "pack_bucketed": 0}
    assert len({p.words.untyped_storage().data_ptr() for p in payloads}) == 1
    assert len({p.scales.untyped_storage().data_ptr() for p in payloads}) == 1
    assert stats.payload_bytes == sum(_codec(codec).leaf_payload_bytes(tuple(g.shape))
                                      for g in grads)


def test_tree_rows_pads_each_leaf_to_whole_buckets():
    rng = np.random.default_rng(7)
    leaves = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              for n in (1000, 512, 3, 1536, 0, 513)]
    got = K.tree_rows(leaves, BUCKET)
    want = torch.cat([K._leaf_rows(x[None], K.geometry(x.numel(), 1, BUCKET)) for x in leaves])
    assert got.shape == (2 + 1 + 1 + 3 + 0 + 2, BUCKET) and torch.equal(got, want)


def _bad_pack(kind, bits=4):
    g = K.geometry(0, bits)
    codes = torch.zeros((5, g.bucket_p), dtype=torch.int32)
    rows = [2, 3]
    if kind == "rows_sum":
        rows = [2, 2]
    elif kind == "negative_rows":
        rows = [6, -1]
    elif kind == "bucket_p":
        codes = torch.zeros((5, g.bucket_p + 1), dtype=torch.int32)
    elif kind == "dtype":
        codes = codes.float()
    elif kind == "non_contiguous":
        codes = torch.zeros((g.bucket_p, 5), dtype=torch.int32).t()
    elif kind == "one_dim":
        codes = codes.reshape(-1)
    return codes, rows


@pytest.mark.parametrize("kind,error", [
    ("rows_sum", ValueError), ("negative_rows", ValueError), ("bucket_p", ValueError),
    ("dtype", TypeError), ("non_contiguous", ValueError), ("one_dim", ValueError)])
def test_pack_tree_wrapper_refuses_what_the_kernel_cannot_take(kind, error):
    codes, rows = _bad_pack(kind)
    with pytest.raises(error):
        K.pack_bucketed_tree(codes, rows, bits=4)
    good, _ = _bad_pack("none")
    assert [w.shape for w in K.pack_bucketed_tree(good, [2, 0, 3], bits=4)] == \
        [(2, good.shape[1] // 6), (0, good.shape[1] // 6), (3, good.shape[1] // 6)]
