"""The QSGD codec's tree decode against the decode it replaced and against
the JAX package.

``decode_tree`` / ``decode_mean_tree`` on a QSGD codec make one
``unpack_dequantize_tree`` call (fused path) or one ``unpack_bucketed_tree``
call and one dequantization (pack path) for the whole tree, writing each leaf
straight into the port layout. Here, on the CPU, the wrappers run their plain
twins; the card tests (``tests/test_torch_cuda.py``) hold the kernels against
those twins. Inputs are made from numpy seeds.

Tolerances: the tree decode equals the per-shape-group decode of the
earlier code (``_decode_groups`` over ``decode_stack``) and the JAX
package's ``decode_tree`` bit for bit, fused path against the Pallas kernel
(interpret mode) and pack path against the jnp path. The mean over N = 2 or
4 replicas sums in replica order and divides by N; the JAX package takes
``jnp.mean`` of a vmapped decode, which XLA may sum in another order, so
those means agree within 2 ulp of the JAX value; at N = 1 exactly.

The cases against the JAX package's ``decode_tree`` / ``decode_mean_tree``
are ``test_torch_decode_tree_jax.py`` (a file of its own, so that the two
balance over test workers); this file holds the tree call against the
per-group decode, the argument checks and the tree unpack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.codecs import QsgdPayload as JaxPayload
from atomo_tpu_torch.codecs import (
    QsgdCodec,
    QsgdPayload,
    decode_mean_tree,
    decode_tree,
    encode_tree,
    terngrad,
)
from atomo_tpu_torch.codecs import qsgd as qsgd_mod
from atomo_tpu_torch.codecs.base import _decode_groups
from atomo_tpu_torch.convert import jax_layouts, jax_view
from atomo_tpu_torch.ops import qsgd_kernels as K

CODECS = [f"qsgd{b}" for b in range(1, 9)] + ["terngrad"]
PATHS = ["fused", "pack"]


def _codec(name, path):
    fused = path == "fused"
    if name == "terngrad":
        return terngrad(use_kernel=fused)
    return QsgdCodec(bits=int(name[4:]), use_kernel=fused)


def _jax_codec(codec, path):
    return JaxQsgd(bits=codec.bits, scheme=codec.scheme, use_pallas=path == "fused")


def _model(name):
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.models.transformer import TransformerLM

    if name == "resnet18":
        return get_model("resnet18", 10, image_shape=(32, 32, 3))
    if name == "lenet":
        return get_model("lenet", 10, image_shape=(28, 28, 1))
    return TransformerLM(vocab_size=16, max_len=8, width=16, depth=2, num_heads=2)


def _leaves(name, seed):
    """Gradient-like port-layout leaves of a model (ResNet-18's channels cut
    16x, so that the twins run quickly) and their layouts."""
    from atomo_tpu_torch.training.trainer import leaf_params

    model = _model(name)
    shapes = [tuple(p.shape) for p in leaf_params(model)]
    if name == "resnet18":
        shapes = [tuple(d // 16 if d >= 64 else d for d in s) for s in shapes]
    rng = np.random.default_rng(seed)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * (0.01 * (1 + i % 7)))
             for i, s in enumerate(shapes)]
    return grads, jax_layouts(model)


def _per_group(codec, payloads, grads, layouts):
    """The decode the tree call replaced: per shape group, the stacked
    payloads through ``decode_stack``, then each leaf's layout copy."""
    return _decode_groups(codec, payloads, grads, layouts,
                          lambda p, n, shape: codec.decode_stack(p, n, shape=shape))


def _gathered(codec, grads, layouts, n_replicas):
    """Payloads of ``n_replicas`` encodes (keys 1..N) stacked leaf by leaf
    on a leading replica axis, as an all_gather hands them over."""
    per_rep = [encode_tree(codec, key, grads, layouts=layouts)[0]
               for key in range(1, n_replicas + 1)]
    return [QsgdPayload(torch.stack([p.words.view(torch.int32) for p in ps]).view(torch.uint32),
                        torch.stack([p.scales for p in ps]))
            for ps in zip(*per_rep)]


def _to_jax(payloads):
    return [JaxPayload(jnp.asarray(p.words.numpy()), jnp.asarray(p.scales.numpy()))
            for p in payloads]


def _jax_like(grads, layouts):
    return [jnp.asarray(jax_view(g, tr).numpy()) for g, tr in zip(grads, layouts)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("model", ["resnet18", "lenet"])
def test_tree_decode_equals_per_group_decode(model, codec, path):
    """One tree call per decode, bit for bit the per-group decode, on conv,
    linear and vector leaves."""
    c = _codec(codec, path)
    grads, layouts = _leaves(model, 1)
    payloads, _ = encode_tree(c, 7, grads, layouts=layouts)
    _assert_same(decode_tree(c, payloads, grads, layouts),
                 _per_group(c, payloads, grads, layouts))


def test_more_than_256_leaves():
    """A tree of 300 leaves (the kernel's table holds 256, so the card makes
    two launches) decodes leaf by leaf as the per-leaf decode does, and the
    stack API over 300 equal leaves as its twin."""
    c = QsgdCodec(bits=3, use_kernel=True)
    rng = np.random.default_rng(6)
    shapes = [((4, 3, 3, 3), (5, 7), (9,))[i % 3] for i in range(300)]
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    payloads, _ = encode_tree(c, 3, grads)
    got = decode_tree(c, payloads, grads)
    assert len(got) == 300
    for g, p, like in zip(got, payloads, grads):
        want = c.decode(p, tuple(jax_view(like).shape))
        assert g.shape == like.shape and torch.equal(jax_view(g), want)
    words = torch.stack([p.words.view(torch.int32) for p in payloads[2::3]]).view(torch.uint32)
    scales = torch.stack([p.scales for p in payloads[2::3]])
    assert torch.equal(K.unpack_dequantize(words, scales, bits=3, n=9),
                       torch.stack([jax_view(g).reshape(-1) for g in got[2::3]]))


@pytest.mark.parametrize("path", PATHS)
def test_decode_tree_makes_one_tree_call(monkeypatch, path):
    """decode_tree and decode_mean_tree on a QSGD codec make one tree call
    for the whole tree and no per-group call."""
    calls = {"unpack_dequantize_tree": 0, "unpack_dequantize": 0,
             "unpack_bucketed_tree": 0, "unpack_bucketed": 0}

    def count(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("unpack_dequantize_tree", "unpack_dequantize"):
        count(K, name)
    for name in ("unpack_bucketed_tree", "unpack_bucketed"):
        count(qsgd_mod, name)
    c = QsgdCodec(bits=4, use_kernel=path == "fused")
    grads, layouts = _leaves("resnet18", 8)
    payloads, _ = encode_tree(c, 2, grads)
    decode_tree(c, payloads, grads)
    decode_mean_tree(c, _gathered(c, grads, layouts, 2), grads, 2)
    tree = "unpack_dequantize_tree" if path == "fused" else "unpack_bucketed_tree"
    assert calls == {**{k: 0 for k in calls}, tree: 2}


def _bad_call(kind):
    grads = [torch.zeros((4, 3, 3, 3)), torch.zeros(10)]
    payloads, _ = encode_tree(QsgdCodec(bits=2, use_kernel=True), 1, grads)
    args = ([(p.words, p.scales) for p in payloads], grads)
    kw = dict(bits=2)
    if kind == "count":
        args = (args[0][:1], grads)
    elif kind == "dtype":
        args = (args[0], [grads[0].double(), grads[1]])
    elif kind == "size":
        args = (args[0], [grads[0], torch.zeros(600)])
    elif kind == "replicas":
        kw["n_replicas"] = 2
    elif kind == "layouts":
        args = args + ([True],)
    return args, kw


@pytest.mark.parametrize("kind,error", [
    ("count", ValueError), ("dtype", TypeError), ("size", ValueError),
    ("replicas", ValueError), ("layouts", ValueError)])
def test_tree_decode_checks_its_arguments(kind, error):
    args, kw = _bad_call(kind)
    with pytest.raises(error):
        K.unpack_dequantize_tree(*args, **kw)
    assert K.unpack_dequantize_tree([], [], bits=2) == []


@pytest.mark.parametrize("bits", range(1, 9))
def test_unpack_bucketed_tree_folds_replicas_into_rows(bits):
    """One tree unpack equals the per-leaf unpacks one after another, each
    leaf's replica axis folded into its rows."""
    g = K.geometry(0, bits)
    rng = np.random.default_rng(bits)
    codes = [torch.from_numpy(rng.integers(0, 1 << (bits + 1), (r, g.bucket_p)).astype(np.int32))
             for r in (3, 1, 8)]
    words = [K.pack_bucketed(c, bits) for c in codes]
    stacked = words[:2] + [words[2].view(torch.int32).view(2, 4, g.n_words).view(torch.uint32)]
    got = K.unpack_bucketed_tree(stacked, bits=bits)
    assert got.dtype == torch.int32 and torch.equal(got, torch.cat(codes))
    with pytest.raises(ValueError):
        K.unpack_bucketed_tree([], bits=bits)
