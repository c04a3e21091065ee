"""The port's SVD codec against the JAX package's (CPU, float32).

Inputs are numpy draws from fixed seeds. The JAX codec's random draws (the
Gaussian sketch, the Gumbel noise behind ``jax.random.categorical``, the
Rademacher probes, the uniforms behind ``jax.random.bernoulli``, the random
low bits of the bf16 wire) are recomputed outside ``jit`` from the leaf key
exactly as ``SvdCodec.encode`` splits it, and handed to the port through its
``draws=`` hook. Tolerances:

* shapes, byte counts and the matricization: exact;
* decoded leaves: rtol 1e-4 and atol 1e-5 of the leaf's largest entry.
  Parity is by reconstruction, not factor by factor (eigenvector signs and
  the order of near-equal eigenvalues are free). The leaves' singular values
  are well apart, as a gradient's leading ones are: the randomized and exact
  cases have a geometric spectrum under a noise floor, the gram cases one
  spread evenly over [0.3, 1] with no floor, since the full-spectrum Bernoulli samplers
  keep small atoms at weight 1/p, and the Gram matrix's eigh gives small
  singular vectors only to eps * s_max^2 / s_i^2 (in either package);
* CholeskyQR2: q within 1e-5 of JAX's on an ill-conditioned (cond 1e3)
  block, the projector q q^T within 1e-5 of JAX's on a rank-deficient one,
  and q^T q within 20 * eps * k of the identity (the jitter
  10 * eps * trace(G) shrinks every column by about that much);
* unbiasedness: over 256 seeds, ||mean decode - x||_F within twice the
  standard error sqrt(sum of per-entry variances / 256).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.codecs import svd as jsvd
from atomo_tpu.codecs.dense import DensePayload as JaxDense
from atomo_tpu_torch.codecs import (
    DenseCodec,
    QsgdCodec,
    SvdCodec,
    decode_mean_tree,
    decode_tree,
    encode_tree,
    get_codec,
)
from atomo_tpu_torch.codecs import svd as psvd
from atomo_tpu_torch.codecs.indicators import spectral_atoms_preferred
from atomo_tpu_torch.codecs.svd import resize_to_2d, undo_resize

SAMPLERS = ["fixed_k", "bernoulli_budget", "bernoulli", "topk"]
ALGOS = ["auto", "exact", "gram", "randomized"]
SHAPES = [(7,), (10,), (3, 3, 16, 32), (64, 10), (120, 84), (256, 768), (5, 5, 1, 6)]
# payload shapes are traced (jax.eval_shape) at a dense-fallback, a padded,
# a gram-sized and a randomized-sized leaf (under "auto"); byte counts are
# compared at every shape
TRACED = [(7,), (5, 5, 1, 6), (64, 10), (120, 84)]


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _low_rank(shape, seed, decay=0.7, noise=1e-3, spectrum=None):
    """A gradient-like leaf: a geometric (or the given) spectrum plus a
    little noise."""
    rng = np.random.default_rng(seed)
    m, n = shape[0], int(np.prod(shape[1:]))
    r = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, r)))
    v, _ = np.linalg.qr(rng.standard_normal((n, r)))
    s = decay ** np.arange(r) if spectrum is None else spectrum(r)
    x = (u * s) @ v.T + noise * rng.standard_normal((m, n))
    return x.reshape(shape).astype(np.float32)


def _jax_codec(c: SvdCodec):
    return jsvd.SvdCodec(rank=c.rank, sample=c.sample, reshape=c.reshape,
                         algorithm=c.algorithm, wire_dtype=c.wire_dtype)


def jax_draws(codec: SvdCodec, key, shape):
    """The draws ``atomo_tpu.codecs.svd.SvdCodec.encode`` makes for one leaf
    of ``shape`` under ``key``, as tensors keyed as the port's hook."""
    return {name: torch.from_numpy(np.asarray(a).copy())
            for name, a in jax_draw_arrays(codec, key, shape).items()}


def jax_draw_arrays(codec: SvdCodec, key, shape):
    """:func:`jax_draws` as JAX arrays (traceable: one jit a leaf shape)."""
    if codec._dense_fallback(shape):
        return {}
    m, n = codec._dims(shape)
    algorithm = codec._algorithm_for(m, n)
    key, k_sketch, k_wire = jax.random.split(key, 3)
    out = {}
    r_full = min(m, n)
    if algorithm == "randomized":
        r_full = min(codec.rank + codec.oversample, r_full)
        out["sketch"] = jax.random.normal(k_sketch, (n, r_full), jnp.float32)
    k = min(codec.rank, r_full) if codec.rank > 0 else r_full
    if codec.sample == "bernoulli":
        out["keep"] = jax.random.uniform(key, (r_full,), jnp.float32)
        u_cols = r_full
    elif codec.sample == "bernoulli_budget":
        rows = []
        for _ in range(max(1, codec.max_redraws)):
            key, sub = jax.random.split(key)
            rows.append(jax.random.uniform(sub, (r_full,), jnp.float32))
        out["keep"] = jnp.stack(rows)
        u_cols = codec._payload_k(r_full)
    elif codec.sample == "topk":
        u_cols = k
    else:
        key_idx, key_probe = jax.random.split(key)
        out["gumbel"] = jax.random.gumbel(key_idx, (k, r_full), jnp.float32)
        p = codec._n_probes(m, n)
        if p:
            out["probes"] = jax.random.rademacher(key_probe, (n, p), jnp.float32)
        u_cols = k + p
    if codec.wire_dtype == "bfloat16":
        ku, kv = jax.random.split(k_wire)
        out["wire_u"] = jax.random.bits(ku, (m, u_cols), jnp.uint16).astype(jnp.int32)
        out["wire_vt"] = jax.random.bits(kv, (u_cols, n), jnp.uint16).astype(jnp.int32)
    return out


def test_jax_draw_identities():
    """The hook rests on two facts of jax.random: categorical is argmax of
    logits plus Gumbel noise of shape (k, r), and bernoulli is u < p."""
    key = jax.random.PRNGKey(3)
    logits = jnp.log(jnp.array([0.5, 0.2, 0.2, 0.1]))
    want = jax.random.categorical(key, logits, shape=(6,))
    got = jnp.argmax(logits + jax.random.gumbel(key, (6, 4), jnp.float32), axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    p = jnp.array([0.1, 0.5, 0.9, 0.3])
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(key, p)),
        np.asarray(jax.random.uniform(key, (4,), jnp.float32) < p))


def test_square_dims_exact():
    for total in list(range(1, 300)) + [4096, 6144, 65536, 196608, 262144, 10**6 + 7]:
        for cap in (8, 64, 512):
            assert psvd._square_dims(total, cap) == jsvd._square_dims(total, cap)


@pytest.mark.parametrize("policy", ["square", "reference"])
@pytest.mark.parametrize("shape", [(), (7,), (8,), (6, 10), (3, 3, 4, 5), (3, 5, 2, 2), (1, 3, 3)])
def test_resize_and_undo_exact(policy, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm, jshape, jpad = jsvd.resize_to_2d(jnp.asarray(x), policy=policy, max_min_dim=4)
    pm, pshape, ppad = resize_to_2d(_t(x), policy=policy, max_min_dim=4)
    assert (tuple(pm.shape), pshape, ppad) == (tuple(jm.shape), jshape, jpad)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(undo_resize(pm, pshape, ppad).numpy(), x)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("sample", SAMPLERS)
def test_payload_bytes_and_shapes_match_jax(sample, algo, wire):
    codec = SvdCodec(rank=3, sample=sample, algorithm=algo, wire_dtype=wire)
    jc = _jax_codec(codec)
    for shape in SHAPES:
        assert codec.leaf_payload_bytes(shape) == jc.leaf_payload_bytes(shape), shape
        if shape not in TRACED:
            continue
        spec = jax.eval_shape(lambda g: jc.encode(jax.random.PRNGKey(0), g),
                              jax.ShapeDtypeStruct(shape, jnp.float32))
        grad = torch.zeros(shape)
        payload = codec.encode(0, grad, draws={
            k: v for k, v in jax_draws(codec, jax.random.PRNGKey(0), shape).items()})
        assert type(payload).__name__ == type(spec).__name__, shape
        for name, a in zip(payload._fields, payload):
            b = getattr(spec, name)
            want = tuple(b.shape) if name != "values" else (int(np.prod(shape)),)
            assert tuple(a.shape) == want, (shape, name)
            assert str(a.dtype).split(".")[-1] == str(b.dtype), (shape, name)


CASES = [  # (shape, codec): gram at a small leaf, randomized at (256, 768)
    ((16, 32), SvdCodec(rank=3)),
    ((16, 32), SvdCodec(rank=3, sample="topk")),
    ((16, 32), SvdCodec(rank=3, sample="bernoulli")),
    ((16, 32), SvdCodec(rank=3, sample="bernoulli_budget")),
    ((16, 32), SvdCodec(rank=3, algorithm="exact")),
    ((256, 768), SvdCodec(rank=24)),
]


@pytest.mark.parametrize("shape,codec", CASES, ids=[
    "gram-fixed_k", "gram-topk", "gram-bernoulli", "gram-budget", "exact-fixed_k",
    "randomized-fixed_k"])
def test_decoded_leaf_matches_jax(shape, codec):
    if codec._algorithm_for(*codec._dims(shape)) in ("randomized", "exact"):
        x = _low_rank(shape, seed=sum(shape))
    else:
        x = _low_rank(shape, seed=sum(shape), noise=0.0,
                      spectrum=lambda r: np.linspace(1.0, 0.3, r))
    jc = _jax_codec(codec)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 5)
    want = np.asarray(jc.decode(jc.encode(key, jnp.asarray(x)), shape))
    payload = codec.encode(0, _t(x), draws=jax_draws(codec, key, shape))
    got = codec.decode(payload, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(x).max()))


def test_stochastic_round_bits_match_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.standard_normal(4000) * 10.0 ** rng.integers(-20, 20, 4000),
                        [0.0, -0.0, 3.4e38, -3.4e38]]).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jsvd.stochastic_round(key, jnp.asarray(x))).view(np.uint16)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint16)).astype(np.int32)
    got = psvd.stochastic_round(_t(x), torch.from_numpy(bits))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


def _projector(q):
    return q @ q.T


def test_cholesky_qr2_ill_conditioned_block_matches_jax():
    rng = np.random.default_rng(2)
    u, _ = np.linalg.qr(rng.standard_normal((200, 12)))
    v, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    y = ((u * np.logspace(0, -3, 12)) @ v).astype(np.float32)  # cond 1e3
    want = np.asarray(jsvd.SvdCodec._orthonormalize(jnp.asarray(y)))
    q = SvdCodec._orthonormalize(_t(y)[None])[0].numpy()
    np.testing.assert_allclose(q.T @ q, np.eye(12), atol=20 * np.finfo(np.float32).eps * 12)
    np.testing.assert_allclose(q, want, atol=1e-5)


def test_cholesky_qr2_rank_deficient_and_zero_blocks():
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((64, 4)) @ rng.standard_normal((4, 8))).astype(np.float32)
    want = np.asarray(jsvd.SvdCodec._orthonormalize(jnp.asarray(y)))
    q = SvdCodec._orthonormalize(_t(y)[None])[0].numpy()
    assert np.isfinite(q).all()
    assert np.linalg.eigvalsh(q.T @ q).max() <= 1 + 1e-5
    np.testing.assert_allclose(_projector(q), _projector(want), atol=1e-5)
    zero = SvdCodec._orthonormalize(torch.zeros((1, 64, 8)))
    assert torch.equal(zero, torch.zeros_like(zero))


@pytest.mark.parametrize("algo", ["gram", "randomized"])
def test_zero_gradient_decodes_to_exact_zeros(algo):
    codec = SvdCodec(rank=3, algorithm=algo)
    payload = codec.encode(11, torch.zeros((96, 64)))
    assert all(bool(torch.isfinite(a.float()).all()) for a in payload)
    assert torch.equal(codec.decode(payload, (96, 64)), torch.zeros((96, 64)))


@pytest.mark.parametrize("codec", [
    SvdCodec(rank=3), SvdCodec(rank=3, algorithm="randomized"),
    SvdCodec(rank=3, sample="bernoulli_budget"), SvdCodec(rank=3, sample="bernoulli"),
    SvdCodec(rank=3, wire_dtype="bfloat16"),
], ids=["gram", "randomized", "budget", "bernoulli", "bf16-wire"])
def test_mean_decode_unbiased_over_seeds(codec):
    trials, shape = 256, (48, 64)
    x = _low_rank(shape, seed=9, decay=0.9, noise=0.05)
    stack = _t(x).reshape(1, -1).expand(trials, -1)
    payload = codec.encode_stack(stack, list(range(trials)), shape=shape)
    dec = codec.decode_stack(payload, x.size, shape=shape).double()
    err = float(torch.linalg.vector_norm(dec.mean(0) - torch.from_numpy(x.reshape(-1))))
    stderr = math.sqrt(float(dec.var(0, correction=0).sum()) / trials)
    assert err <= 2 * stderr, (err, stderr)


def test_stacked_leaves_equal_one_by_one():
    codec = SvdCodec(rank=4)
    xs = [_low_rank((32, 96), seed=s) for s in range(3)]
    stacked = codec.encode_stack(torch.stack([_t(x).reshape(-1) for x in xs]), [5, 6, 7],
                                 shape=(32, 96))
    for j, x in enumerate(xs):
        one = codec.encode(5 + j, _t(x))
        for a, b in zip(stacked, one):
            torch.testing.assert_close(a[j], b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("make", [lambda: SvdCodec(rank=3), lambda: QsgdCodec(bits=4),
                                  lambda: DenseCodec()], ids=["svd", "qsgd", "dense"])
def test_decode_mean_tree_over_replicas(make):
    """The mean decode over N = 3 gathered replicas equals the mean of the
    replicas' own decodes (SVD through its fused product)."""
    codec = make()
    grads = [_t(_low_rank((30, 40), seed=s)) for s in range(2)] + [_t(np.ones(30))]
    per_rep = [encode_tree(codec, key, grads)[0] for key in (1, 2, 3)]
    gathered = [type(ps[0])(*(torch.stack(parts) for parts in zip(*ps)))
                for ps in zip(*per_rep)]
    got = decode_mean_tree(codec, gathered, grads, 3)
    want = [torch.stack(d).mean(0) for d in zip(*(decode_tree(codec, p, grads) for p in per_rep))]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_get_codec_builds_svd_codecs():
    c = get_codec("svd", svd_rank=5, sample="topk", algorithm="gram", wire_dtype="bfloat16")
    assert (c.rank, c.sample, c.algorithm, c.wire_dtype) == (5, "topk", "gram", "bfloat16")
    assert get_codec("svd_budget", svd_rank=2).sample == "bernoulli_budget"
    with pytest.raises(ValueError, match="sgd\\|svd\\|svd_budget\\|qsgd\\|terngrad"):
        get_codec("nope")


def test_dense_fallback_leaf_matches_jax():
    codec = SvdCodec(rank=3)
    x = np.arange(10, dtype=np.float32)
    assert isinstance(_jax_codec(codec).encode(jax.random.PRNGKey(0), jnp.asarray(x)), JaxDense)
    p = codec.encode(0, _t(x))
    np.testing.assert_array_equal(codec.decode(p, (10,)).numpy(), x)


@pytest.mark.parametrize("shape", [(64, 64), (3, 3, 8, 16)])
def test_indicators_match_jax(shape):
    from atomo_tpu.codecs import indicators as jind

    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    x[: shape[0] // 2] *= 10
    want = bool(jind.spectral_atoms_preferred(jnp.asarray(x)))
    assert bool(spectral_atoms_preferred(_t(x))) == want
    lr = _low_rank((64, 64), seed=1)
    assert bool(spectral_atoms_preferred(_t(lr))) == bool(
        jind.spectral_atoms_preferred(jnp.asarray(lr)))
