"""The QSGD codec's tree decode against the JAX package's ``decode_tree``
and ``decode_mean_tree`` (the companion of ``test_torch_decode_tree.py``,
whose helpers and tolerances it takes: bit for bit, the means over N = 2
and 4 replicas within 2 ulp of the JAX value, at N = 1 exactly). The fused
path is held against the Pallas kernel in interpret mode, the pack path
against the jnp path; on the CPU the port's wrappers run their plain twins.
"""

import numpy as np
import pytest
import torch
from test_torch_decode_tree import (
    CODECS,
    PATHS,
    _assert_same,
    _codec,
    _gathered,
    _jax_codec,
    _jax_like,
    _leaves,
    _per_group,
    _to_jax,
)

from atomo_tpu.codecs.base import decode_mean_tree as jax_decode_mean_tree
from atomo_tpu.codecs.base import decode_tree as jax_decode_tree
from atomo_tpu_torch.codecs import (
    QsgdCodec,
    QsgdPayload,
    decode_mean_tree,
    decode_tree,
    encode_tree,
)
from atomo_tpu_torch.convert import jax_view


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("codec", CODECS)
def test_tree_decode_matches_jax_decode_tree(codec, path):
    """The JAX package's decode_tree of the same payloads (LeNet: conv,
    linear and vector leaves), fused path against its Pallas kernel in
    interpret mode, pack path against its jnp path."""
    c = _codec(codec, path)
    grads, layouts = _leaves("lenet", 2)
    payloads, _ = encode_tree(c, 11, grads, layouts=layouts)
    want = jax_decode_tree(_jax_codec(c, path), _to_jax(payloads), _jax_like(grads, layouts))
    for got, w, tr in zip(decode_tree(c, payloads, grads, layouts), want, layouts):
        np.testing.assert_array_equal(jax_view(got, tr).numpy(), np.asarray(w))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("bits", [2, 4])
def test_lm_leaves_keep_the_embedding_untransposed(bits, path):
    """The LM's leaves (embedding tables lie alike in both packages, linear
    kernels transpose) against the per-group decode and the JAX package's
    decode_tree (Pallas interpret mode for the fused path, jnp for pack)."""
    c = QsgdCodec(bits=bits, use_kernel=path == "fused")
    grads, layouts = _leaves("lm", 3)
    assert not all(layouts) and any(layouts)
    payloads, _ = encode_tree(c, 5, grads, layouts=layouts)
    got = decode_tree(c, payloads, grads, layouts)
    _assert_same(got, _per_group(c, payloads, grads, layouts))
    want = jax_decode_tree(_jax_codec(c, path), _to_jax(payloads), _jax_like(grads, layouts))
    for g, w, tr in zip(got, want, layouts):
        np.testing.assert_array_equal(jax_view(g, tr).numpy(), np.asarray(w))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("n_replicas", [1, 2, 4])
def test_decode_mean_tree_against_jax(n_replicas, path):
    """The mean over N gathered replicas: at N = 1 exactly the decode and
    the JAX mean; at N = 2 and 4 within 2 ulp of the JAX package's
    decode_mean_tree (Pallas interpret mode for the fused path, jnp for
    pack), and exactly the in-order sum over N."""
    c = QsgdCodec(bits=4, use_kernel=path == "fused")
    grads, layouts = _leaves("lenet", 4)
    gathered = _gathered(c, grads, layouts, n_replicas)
    got = decode_mean_tree(c, gathered, grads, n_replicas, layouts)
    per_rep = [decode_tree(c, [QsgdPayload(p.words[r], p.scales[r]) for p in gathered],
                           grads, layouts) for r in range(n_replicas)]
    for i, g in enumerate(got):
        acc = per_rep[0][i]
        for r in range(1, n_replicas):
            acc = acc + per_rep[r][i]
        assert torch.equal(g, acc if n_replicas == 1 else acc / n_replicas)
    want = jax_decode_mean_tree(_jax_codec(c, path), _to_jax(gathered),
                                _jax_like(grads, layouts), n_replicas)
    for g, w, tr in zip(got, want, layouts):
        a, b = jax_view(g, tr).numpy(), np.asarray(w)
        if n_replicas == 1:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.all(np.abs(a - b) <= 2 * np.spacing(np.abs(b)))
