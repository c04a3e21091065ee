"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip without one. This file imports no JAX, so
that the GPU machine (which has none) runs it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Words, codes and decoded values are compared bit for bit: kernel and plain
version do the same float32 operations in the same order (see
``atomo_tpu_torch/csrc/qsgd_kernels.cu``). Scales are compared within rtol
1e-6, the tolerance of the CPU tests. The tree encode (one launch over all of
ResNet-18's 62 leaves) is held against the plain twin and against the
per-shape-group stacks, and must run without a host sync; so are the tree
decode (one launch, straight into the port layout, over one replica or the
mean of four), the tree unpack, the tree pack (one launch over every leaf's
rows) and the pack path's encode. The tree decode and the tree unpack read
the rows of an (N, bytes) gathered buffer in place (N = 1, 2, 4, 8), equal
to their twins and to the replica-contiguous launch. At one rank of an NCCL
group the data-parallel QSGD step equals the single-device step bit for
bit, with one encode and one decode launch and no host sync.
"""

import dataclasses

import pytest
import torch

from atomo_tpu_torch.codecs import QsgdCodec, QsgdPayload, terngrad
from atomo_tpu_torch.ops import qsgd_kernels as K

pytestmark = pytest.mark.cuda

BUCKET = 512


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("scheme", ["qsgd", "terngrad"])
@pytest.mark.parametrize("n", [512, 1000, 4113, 300_001])
def test_kernels_match_plain(dev, bits, scheme, n):
    gen = torch.Generator(device=dev).manual_seed(1000 * bits + n)
    x = torch.randn((3, n), generator=gen, device=dev)
    g = K.geometry(n, bits, BUCKET)
    u = torch.rand((3, g.n_buckets, BUCKET), generator=gen, device=dev)
    seeds = [11, 1 << 40, 2 ** 63 - 1]
    K.reset_launch_counts()
    for kw in (dict(u=u), dict(seeds=seeds)):
        wk, sk = K.quantize_pack(x, bits=bits, bucket_size=BUCKET, scheme=scheme, **kw)
        wp, sp = K.quantize_pack_plain(x, bits=bits, bucket_size=BUCKET, scheme=scheme, **kw)
        torch.cuda.synchronize()
        assert wk.shape == (3, g.n_buckets, g.n_words) and wk.dtype == torch.uint32
        assert _same_bits(wk, wp)
        torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
        dk = K.unpack_dequantize(wk, sk, bits=bits, bucket_size=BUCKET, n=n)
        dp = K.unpack_dequantize_plain(wk, sk, bits=bits, bucket_size=BUCKET, n=n)
        assert torch.equal(dk, dp)
        ck = K.unpack_bucketed(wk.reshape(-1, g.n_words), bits)
        assert torch.equal(ck, K.unpack_bucketed_plain(wk.reshape(-1, g.n_words), bits))
        assert _same_bits(K.pack_bucketed(ck, bits), wk.reshape(-1, g.n_words))
    assert K.launch_counts() == {"quantize_pack": 2, "unpack_dequantize": 2,
                                 "pack_bucketed": 2, "unpack_bucketed": 2}


def test_one_leaf_and_stack_agree(dev):
    x = torch.randn((2, 2000), device=dev)
    w2, s2 = K.quantize_pack(x, bits=4, seeds=[5, 6])
    w1, s1 = K.quantize_pack(x[1].contiguous(), bits=4, seeds=[6])
    assert _same_bits(w2[1], w1) and torch.equal(s2[1], s1)


def _resnet18_grads(dev, seed=0):
    """Gradient-like tensors of ResNet-18's 62 leaves (port layout), each
    leaf at its own scale."""
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training.trainer import leaf_params

    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(p.shape, generator=gen, device=dev) * (0.01 * (1 + i % 7))
            for i, p in enumerate(leaf_params(model))]


@pytest.mark.parametrize("mode", ["seeds", "u"])
@pytest.mark.parametrize("bits,scheme", [(b, "qsgd") for b in range(1, 9)] + [(1, "terngrad")])
def test_tree_kernel_matches_plain_at_resnet18_leaves(dev, bits, scheme, mode):
    """One launch encodes all 62 leaves; every leaf's words equal the plain
    twin's bit for bit."""
    from atomo_tpu_torch.codecs.base import _views

    codec = terngrad() if scheme == "terngrad" else QsgdCodec(bits=bits)
    leaves = [codec._clip_leaf(v.reshape(-1)) for v in _views(_resnet18_grads(dev), None)]
    gen = torch.Generator(device=dev).manual_seed(bits)
    if mode == "u":
        kw = dict(u=[torch.rand((K.geometry(x.numel(), bits).n_buckets, BUCKET), generator=gen,
                                device=dev) for x in leaves])
    else:
        kw = dict(seeds=[1000003 * (i + 1) + bits for i in range(len(leaves))])
    K.reset_launch_counts()
    got = K.quantize_pack_tree(leaves, bits=bits, scheme=scheme, **kw)
    want = K.quantize_pack_tree_plain(leaves, bits=bits, scheme=scheme, **kw)
    torch.cuda.synchronize()
    assert K.launch_counts()["quantize_pack"] == 1 and len(got) == 62
    for (wk, sk), (wp, sp) in zip(got, want):
        assert wk.dtype == torch.uint32 and _same_bits(wk, wp)
        torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("make", [lambda: QsgdCodec(bits=4), lambda: terngrad()])
def test_encode_tree_is_one_launch_and_equals_the_group_path(dev, make):
    """encode_tree launches quantize_pack once for the whole tree, and its
    payloads equal the per-shape-group stacks' for the same seeds."""
    from atomo_tpu_torch.codecs import encode_tree
    from atomo_tpu_torch.codecs.base import _views, encode_groups
    from atomo_tpu_torch.utils.rng import fold_in

    codec, grads = make(), _resnet18_grads(dev, seed=1)
    K.reset_launch_counts()
    payloads, stats = encode_tree(codec, 11, grads)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"quantize_pack": 1, "unpack_dequantize": 0,
                                 "pack_bucketed": 0, "unpack_bucketed": 0}
    groups = encode_groups(codec, _views(grads, None), [fold_in(11, i) for i in range(62)])
    assert K.launch_counts()["quantize_pack"] == 1 + 17
    for a, b in zip(payloads, groups):
        assert _same_bits(a.words, b.words) and torch.equal(a.scales, b.scales)
    assert stats.payload_bytes == sum(codec.leaf_payload_bytes(tuple(g.shape)) for g in grads)


@pytest.mark.parametrize("make", [lambda: QsgdCodec(bits=4), lambda: terngrad()])
def test_encode_tree_makes_no_host_sync(dev, make):
    """The QSGD encode never waits for the card: no blocking copy, no read
    of a device value (torch raises on any sync it makes in this mode)."""
    from atomo_tpu_torch.codecs import encode_tree

    codec, grads = make(), _resnet18_grads(dev, seed=2)
    encode_tree(codec, 5, grads)  # loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        payloads, _ = encode_tree(codec, 6, grads)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(p.scales).all()) for p in payloads)


def _payload_tree(codec, grads, n_replicas, layouts=None):
    """Per leaf, the (words, scales) of ``n_replicas`` encodes, on a leading
    replica axis when there is more than one."""
    from atomo_tpu_torch.codecs import encode_tree

    reps = [encode_tree(codec, 100 + r, grads, layouts=layouts)[0] for r in range(n_replicas)]
    if n_replicas == 1:
        return [(p.words, p.scales) for p in reps[0]]
    return [(torch.stack([p.words.view(torch.int32) for p in ps]).view(torch.uint32),
             torch.stack([p.scales for p in ps])) for ps in zip(*reps)]


def _lm_grads(dev):
    """Gradient-like tensors of the LM recipe's 28 leaves and their layouts
    (embedding tables untransposed)."""
    from atomo_tpu_torch.convert import jax_layouts
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.training.trainer import leaf_params

    model = TransformerLM(vocab_size=256, max_len=1024, width=256, depth=4, num_heads=4)
    gen = torch.Generator(device=dev).manual_seed(9)
    grads = [torch.randn(p.shape, generator=gen, device=dev) * 0.01 for p in leaf_params(model)]
    return grads, jax_layouts(model)


@pytest.mark.parametrize("n_replicas", [1, 4])
@pytest.mark.parametrize("bits,scheme", [(b, "qsgd") for b in range(1, 9)] + [(1, "terngrad")])
def test_tree_decode_kernels_match_plain_at_resnet18_leaves(dev, bits, scheme, n_replicas):
    """One launch decodes all 62 leaves (or their mean over 4 replicas)
    into the port layout, and one launch unpacks their words; both equal
    their plain twins bit for bit."""
    codec = terngrad() if scheme == "terngrad" else QsgdCodec(bits=bits)
    grads = _resnet18_grads(dev, seed=bits)
    payloads = _payload_tree(codec, grads, n_replicas)
    K.reset_launch_counts()
    got = K.unpack_dequantize_tree(payloads, grads, bits=bits, n_replicas=n_replicas)
    codes = K.unpack_bucketed_tree([w for w, _ in payloads], bits=bits)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"quantize_pack": 0, "unpack_dequantize": 1,
                                 "pack_bucketed": 0, "unpack_bucketed": 1}
    want = K.unpack_dequantize_tree_plain(payloads, grads, bits=bits, n_replicas=n_replicas)
    for a, b, g in zip(got, want, grads):
        assert a.shape == g.shape and a.is_contiguous() and torch.equal(a, b)
    assert torch.equal(codes, K.unpack_bucketed_tree_plain([w for w, _ in payloads], bits=bits))


@pytest.mark.parametrize("n_replicas", [1, 4])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_tree_decode_kernel_matches_plain_at_lm_leaves(dev, bits, n_replicas):
    """The LM recipe's 28 leaves, embedding tables kept in their layout."""
    codec = QsgdCodec(bits=bits)
    grads, layouts = _lm_grads(dev)
    payloads = _payload_tree(codec, grads, n_replicas, layouts)
    got = K.unpack_dequantize_tree(payloads, grads, layouts, bits=bits, n_replicas=n_replicas)
    want = K.unpack_dequantize_tree_plain(payloads, grads, layouts, bits=bits,
                                          n_replicas=n_replicas)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bucket_size", [16, 100, 1000, 2048])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_tree_decode_kernels_match_plain_at_other_bucket_sizes(dev, bits, bucket_size):
    """Bucket sizes below a warp's 32 positions and above 512, powers of two
    (the kernel's shift-and-mask path) and not (its division path), over
    ResNet-18's leaves and 2 replicas."""
    codec = QsgdCodec(bits=bits, bucket_size=bucket_size)
    grads = _resnet18_grads(dev, seed=bucket_size)[-12:]
    payloads = _payload_tree(codec, grads, 2)
    kw = dict(bits=bits, bucket_size=bucket_size, n_replicas=2)
    for a, b in zip(K.unpack_dequantize_tree(payloads, grads, **kw),
                    K.unpack_dequantize_tree_plain(payloads, grads, **kw)):
        assert torch.equal(a, b)
    words = [w for w, _ in payloads]
    assert torch.equal(K.unpack_bucketed_tree(words, bits=bits),
                       K.unpack_bucketed_tree_plain(words, bits=bits))


@pytest.mark.parametrize("path", ["fused", "pack"])
@pytest.mark.parametrize("make", [lambda: QsgdCodec(bits=4), lambda: terngrad()])
def test_decode_tree_is_one_launch_and_equals_the_group_path(dev, make, path):
    """decode_tree launches one decode (fused) or one unpack (pack) for the
    whole tree, and equals the per-shape-group decode of the same payloads."""
    from atomo_tpu_torch.codecs import decode_tree, encode_tree
    from atomo_tpu_torch.codecs.base import _decode_groups

    codec = dataclasses.replace(make(), use_kernel=path == "fused")
    grads = _resnet18_grads(dev, seed=3)
    payloads, _ = encode_tree(codec, 4, grads)
    K.reset_launch_counts()
    got = decode_tree(codec, payloads, grads)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["unpack_dequantize"], counts["unpack_bucketed"]) == \
        ((1, 0) if path == "fused" else (0, 1))
    want = _decode_groups(codec, payloads, grads, None,
                          lambda p, n, shape: codec.decode_stack(p, n, shape=shape))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", ["fused", "pack"])
def test_decode_makes_no_host_sync(dev, path):
    """decode_tree and decode_mean_tree never wait for the card."""
    from atomo_tpu_torch.codecs import decode_mean_tree, decode_tree

    codec = QsgdCodec(bits=4, use_kernel=path == "fused")
    grads = _resnet18_grads(dev, seed=5)
    payloads = [QsgdPayload(w, s) for w, s in _payload_tree(codec, grads, 1)]
    gathered = [QsgdPayload(w, s) for w, s in _payload_tree(codec, grads, 4)]
    decode_tree(codec, payloads, grads)  # loads the library, fills the caches
    decode_mean_tree(codec, gathered, grads, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one = decode_tree(codec, payloads, grads)
        mean = decode_mean_tree(codec, gathered, grads, 4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(t).all()) for t in one + mean)


def test_tree_decode_splits_more_than_256_leaves(dev):
    codec = QsgdCodec(bits=3)
    gen = torch.Generator(device=dev).manual_seed(6)
    grads = [torch.randn(((4, 3, 3, 3), (5, 7), (9,))[i % 3], generator=gen, device=dev)
             for i in range(300)]
    payloads = _payload_tree(codec, grads, 1)
    K.reset_launch_counts()
    got = K.unpack_dequantize_tree(payloads, grads, bits=3)
    codes = K.unpack_bucketed_tree([w for w, _ in payloads], bits=3)
    torch.cuda.synchronize()
    assert K.launch_counts()["unpack_dequantize"] == 2
    assert K.launch_counts()["unpack_bucketed"] == 2
    for a, b in zip(got, K.unpack_dequantize_tree_plain(payloads, grads, bits=3)):
        assert torch.equal(a, b)
    assert torch.equal(codes, K.unpack_bucketed_tree_plain([w for w, _ in payloads], bits=3))


def _tree_codes(dev, grads, bits, bucket_size=BUCKET, layouts=None):
    """The codes of a tree's leaves in one (rows, bucket_p) buffer, as the
    pack path's quantizer leaves them (from a fused encode, unpacked), and
    each leaf's rows."""
    codec = QsgdCodec(bits=bits, bucket_size=bucket_size)
    payloads = _payload_tree(codec, grads, 1, layouts)
    return (K.unpack_bucketed_tree([w for w, _ in payloads], bits=bits),
            [s.shape[0] for _, s in payloads])


@pytest.mark.parametrize("bits", range(1, 9))
def test_tree_pack_kernel_matches_plain_at_resnet18_and_lm_leaves(dev, bits):
    """One launch packs the rows of all 62 ResNet-18 leaves (and of the LM
    recipe's 28), bit for bit the plain twin; a buffer that starts off 16
    bytes is packed too."""
    lm, layouts = _lm_grads(dev)
    for grads, lay in ((_resnet18_grads(dev, seed=bits), None), (lm, layouts)):
        codes, rows = _tree_codes(dev, grads, bits, layouts=lay)
        K.reset_launch_counts()
        words = K.pack_words(codes, bits)
        torch.cuda.synchronize()
        assert K.launch_counts()["pack_bucketed"] == 1
        want = K.pack_bucketed_plain(codes, bits)
        assert _same_bits(words, want)
        got = K.pack_bucketed_tree(codes, rows, bits=bits)
        assert [w.shape[0] for w in got] == rows
        assert _same_bits(torch.cat([w.view(torch.int32) for w in got]), want)
        odd = codes[1:]  # off 16 bytes unless bucket_p is a multiple of 4
        assert _same_bits(K.pack_words(odd, bits), want[1:])


@pytest.mark.parametrize("bucket_size", [16, 100, 512, 1000, 2048])
@pytest.mark.parametrize("bits", range(1, 9))
def test_tree_pack_kernel_matches_plain_at_other_bucket_sizes(dev, bits, bucket_size):
    """Rows from 18 to 2048 codes: tiles of many short rows and of few long
    ones, over ResNet-18's leaves."""
    codes, rows = _tree_codes(dev, _resnet18_grads(dev, seed=bucket_size)[-20:], bits,
                              bucket_size)
    for a, b in zip(K.pack_bucketed_tree(codes, rows, bits=bits),
                    K.pack_bucketed_tree_plain(codes, rows, bits=bits)):
        assert _same_bits(a, b)


def _ulps(a, b):
    """|a - b| in units of the last place of the larger, float32."""
    big = torch.maximum(a.abs(), b.abs())
    return (a - b).abs() / (torch.nextafter(big, torch.full_like(big, float("inf"))) - big)


@pytest.mark.parametrize("mode", ["seeds", "uniforms"])
@pytest.mark.parametrize("make", [lambda: QsgdCodec(bits=4, use_kernel=False),
                                  lambda: terngrad(use_kernel=False)])
def test_pack_path_encode_tree_is_one_pack_launch(dev, make, mode):
    """encode_tree on the pack path launches the pack kernel once for the
    whole tree (the decode's unpack once), and equals the per-shape-group
    path: scales within 1 ulp (the card's vector_norm may sum 21,847 rows in
    another order than 17 smaller stacks), words bit for bit in every row
    whose scale is the same."""
    from atomo_tpu_torch.codecs import decode_tree, encode_tree
    from atomo_tpu_torch.codecs.base import _views, encode_groups
    from atomo_tpu_torch.utils.rng import fold_in

    codec, grads = make(), _resnet18_grads(dev, seed=8)
    views = _views(grads, None)
    gen = torch.Generator(device=dev).manual_seed(4)
    draws = None if mode == "seeds" else [
        torch.rand((K.geometry(v.numel(), codec.bits).n_buckets, BUCKET), generator=gen,
                   device=dev) for v in views]
    K.reset_launch_counts()
    payloads, _ = encode_tree(codec, 11, grads, draws)
    decode_tree(codec, payloads, grads)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"quantize_pack": 0, "unpack_dequantize": 0,
                                 "pack_bucketed": 1, "unpack_bucketed": 1}
    groups = encode_groups(codec, views, [fold_in(11, i) for i in range(62)], draws)
    assert K.launch_counts()["pack_bucketed"] == 1 + 17
    for a, b in zip(payloads, groups):
        assert float(_ulps(a.scales, b.scales).max()) <= 1.0
        same = a.scales == b.scales
        assert _same_bits(a.words.view(torch.int32)[same], b.words.view(torch.int32)[same])


def test_pack_path_encode_makes_no_host_sync(dev):
    """The pack path's encode never waits for the card."""
    from atomo_tpu_torch.codecs import encode_tree

    for codec in (QsgdCodec(bits=4, use_kernel=False), terngrad(use_kernel=False)):
        grads = _resnet18_grads(dev, seed=2)
        encode_tree(codec, 5, grads)  # loads the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            payloads, _ = encode_tree(codec, 6, grads)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert all(bool(torch.isfinite(p.scales).all()) for p in payloads)


def test_tree_pack_takes_any_number_of_leaves_in_one_launch(dev):
    """300 leaves (more than the other tree kernels' 256-entry table): the
    pack kernel sees one buffer, so it is still one launch."""
    gen = torch.Generator(device=dev).manual_seed(6)
    grads = [torch.randn(((4, 3, 3, 3), (5, 7), (9,))[i % 3], generator=gen, device=dev)
             for i in range(300)]
    codes, rows = _tree_codes(dev, grads, 3)
    K.reset_launch_counts()
    got = K.pack_bucketed_tree(codes, rows, bits=3)
    torch.cuda.synchronize()
    assert K.launch_counts()["pack_bucketed"] == 1 and len(got) == 300
    for a, b in zip(got, K.pack_bucketed_tree_plain(codes, rows, bits=3)):
        assert _same_bits(a, b)


def test_tree_decode_refuses_what_it_cannot_write(dev):
    grads = _resnet18_grads(dev, seed=7)[:3]
    payloads = _payload_tree(QsgdCodec(bits=4), grads, 1)
    with pytest.raises(TypeError, match="float32"):
        K.unpack_dequantize_tree(payloads, [grads[0].bfloat16()] + grads[1:], bits=4)
    with pytest.raises(TypeError):
        K.unpack_dequantize_tree([(w.view(torch.int32).float(), s) for w, s in payloads],
                                 grads, bits=4)
    with pytest.raises(ValueError, match="share one device"):
        K.unpack_dequantize_tree([(payloads[0][0].cpu(), payloads[0][1])], grads[:1], bits=4)
    with pytest.raises(ValueError):
        K.unpack_bucketed_tree([payloads[0][0], payloads[1][0][:, :-1].contiguous()], bits=4)
    codes = K.unpack_bucketed_tree([w for w, _ in payloads], bits=4)  # rows of 3 leaves
    assert codes.shape[0] > 1  # so that a column slice is not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        K.pack_bucketed_tree(codes[:, :-6], [codes.shape[0]], bits=4)
    with pytest.raises(TypeError):
        K.pack_bucketed_tree(codes.float(), [codes.shape[0]], bits=4)
    with pytest.raises(ValueError):
        K.pack_bucketed_tree(codes, [codes.shape[0] + 1], bits=4)


def test_unbiased_over_seeds(dev):
    n, trials = 4096, 64
    x = torch.randn(n, device=dev)
    codec = QsgdCodec(bits=2)
    acc = torch.zeros(n, dtype=torch.float64, device=dev)
    for seed in range(trials):
        p = codec.encode(seed, x)
        acc += codec.decode(p, (n,)).double()
    bound = 4 * p.scales.double().repeat_interleave(BUCKET)[:n] / 3 / trials ** 0.5
    assert bool(((acc / trials - x.double()).abs() <= bound).all())


@pytest.mark.parametrize("make", [lambda: QsgdCodec(bits=4), lambda: terngrad()])
def test_fused_and_pack_paths_emit_the_same_words(dev, make):
    codec = make()
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((4, 3000), generator=gen, device=dev)
    u = torch.rand((4, 6, BUCKET), generator=gen, device=dev)
    fused = codec.encode_stack(x, [1, 2, 3, 4], u)
    packed = dataclasses.replace(codec, use_kernel=False).encode_stack(x, [1, 2, 3, 4], u)
    # the torch quantizer sums a bucket's squares in its own order: a scale
    # one ulp apart may move a field whose frac sits on its uniform
    g = K.geometry(3000, codec.bits, BUCKET)
    fa, fb = (K._split_fields(p.words.reshape(-1, g.n_words), g) for p in (fused, packed))
    assert (fa == fb).double().mean() >= 0.999
    torch.testing.assert_close(fused.scales, packed.scales, rtol=1e-6, atol=0.0)


def test_wrappers_check_their_inputs(dev):
    x = torch.randn((2, 1000), device=dev)
    with pytest.raises(TypeError):
        K.quantize_pack(x.double(), bits=4, seeds=[1, 2])
    with pytest.raises(ValueError):
        K.quantize_pack(x.t().contiguous().t(), bits=4, seeds=[1, 2])
    with pytest.raises(ValueError):
        K.quantize_pack(x, bits=4, seeds=[1])
    with pytest.raises(ValueError):
        K.quantize_pack(x, bits=4, seeds=[1, 2], u=torch.rand((2, 2, 7), device=dev))
    with pytest.raises(ValueError):
        QsgdCodec(bits=4, use_kernel=False, pack_kernel=False).encode(0, x[0])


# ------------------------------------------------------------ flash attention
#
# The kernel against its plain twin (flash_attention_plain) on the card. Both
# accumulate in float32 in other orders: float32 outputs agree within 2e-5;
# bfloat16 outputs within 2e-2 of the twin's float32 value on the same
# (bfloat16) inputs; gradients, which both take through the blockwise oracle
# from the kernel's or the twin's forward, within 5e-5.

from atomo_tpu_torch.ops import attention_kernels as A  # noqa: E402

RECIPE = (16, 4, 1024, 64)  # the LM recipe's (B, H, S, D)


def _qkv(dev, shape, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [RECIPE, (2, 3, 1000, 64), (2, 2, 300, 32), (2, 2, 257, 128)],
                         ids=["recipe", "ragged", "d32", "d128"])
def test_flash_matches_plain(dev, shape, causal):
    q, k, v = _qkv(dev, shape)
    A.reset_launch_counts()
    got = A.flash_attention_forward(q, k, v, causal=causal, block_q=512, block_k=512)
    want = A.flash_attention_plain(q, k, v, causal=causal, block_q=512, block_k=512)
    torch.cuda.synchronize()
    assert A.launch_counts() == {"flash_attention": 1}
    assert got.shape == shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-5


def test_flash_bf16_inputs(dev):
    q, k, v = _qkv(dev, RECIPE, torch.bfloat16, seed=1)
    got = A.flash_attention_forward(q, k, v, causal=True)
    want = A.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) <= 2e-2


def test_flash_reads_strided_head_views(dev):
    b, h, s, d = 2, 4, 200, 64
    qkv = torch.randn((b, s, 3 * h * d), device=dev)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    got = A.flash_attention_forward(q, k, v, causal=True)
    want = A.flash_attention_plain(q, k, v, causal=True)
    assert float((got - want).abs().max()) <= 2e-5


def test_flash_refuses_misaligned_views(dev):
    """The kernel copies rows in 16-byte chunks: a view whose base address or
    row stride is not a multiple of 16 bytes is refused, not served."""
    b, h, s, d = 1, 2, 64, 64
    qkv = torch.randn((b, s, 3 * h * d + 1), device=dev)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv[..., 1:].chunk(3, dim=-1))
    with pytest.raises(ValueError, match="16-byte"):
        A.flash_attention_forward(q, k, v, causal=True)
    q, k, v = (t.contiguous() for t in (q, k, v))
    assert float((A.flash_attention_forward(q, k, v, causal=True)
                  - A.flash_attention_plain(q, k, v, causal=True)).abs().max()) <= 2e-5


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match_plain(dev, causal):
    q, k, v = (t.requires_grad_() for t in _qkv(dev, (2, 2, 300, 64), seed=2))
    A.flash_attention(q, k, v, causal=causal, block_q=128, block_k=128).square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    A.flash_attention_plain(q, k, v, causal=causal, block_q=128, block_k=128).square().sum().backward()
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        assert float((a - b).abs().max()) <= 5e-5


def test_flash_wrapper_checks_its_inputs(dev):
    q, k, v = _qkv(dev, (1, 2, 64, 64))
    with pytest.raises(TypeError):
        A.flash_attention_forward(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        A.flash_attention_forward(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="share one device"):
        A.flash_attention_forward(q, k.cpu(), v)
    with pytest.raises(ValueError, match="shape"):
        A.flash_attention_forward(q, k[:, :, :32], v)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention_forward(*(t[..., :48].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="unit stride"):
        A.flash_attention_forward(*(t.transpose(2, 3) for t in (q, k, v)))


def test_lm_step_launches_the_kernel_once_per_layer_and_matches_the_cpu(dev):
    """A small LM train step (sgd) on the card: the flash kernel launches
    once per layer, and the step equals the CPU's (plain twin) within loss
    rtol 1e-4 and params atol 1e-5 (TF32 off)."""
    import copy

    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.parallel.lm import make_lm_train_step
    from atomo_tpu_torch.training import create_state, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    cfg = dict(vocab_size=64, max_len=128, width=128, depth=2, num_heads=2)
    opt = make_optimizer("sgd", lr=0.1, momentum=0.9)
    base = TransformerLM(**cfg)
    tokens = torch.randint(0, 64, (2, 128), generator=torch.Generator().manual_seed(0))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for d in ("cpu", dev):
            state = create_state(copy.deepcopy(base), opt, 1, d)
            step = make_lm_train_step(state.model, opt, None, attn_impl="ulysses-flash")
            A.reset_launch_counts()
            _, m = step(state, 1, tokens.to(d))
            out[str(d)] = (float(m["loss"]), [p.detach().cpu() for p in leaf_params(state.model)],
                           A.launch_counts()["flash_attention"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out["cpu"][2] == 0 and out["cuda"][2] == cfg["depth"]
    assert abs(out["cpu"][0] - out["cuda"][0]) <= 1e-4 * abs(out["cpu"][0])
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert float((a - b).abs().max()) <= 1e-5


# ------------------------------------------------ the exchange's gathered rows


def _gathered_tree(codec, grads, n):
    """n replicas' encodes (keys 100, 101, ...) packed rank by rank and
    stacked as ``all_gather_into_tensor`` leaves them: (gathered views,
    replica-contiguous payloads)."""
    from atomo_tpu_torch.codecs import encode_tree
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets

    reps = [encode_tree(codec, 100 + r, grads)[0] for r in range(n)]
    packed = [pack_tree_buckets(p) for p in reps]
    views = unpack_tree_buckets(torch.stack([b for b, _ in packed]), packed[0][1])
    return [(v.words, v.scales) for v in views], _payload_tree(codec, grads, n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("bits,scheme", [(2, "qsgd"), (4, "qsgd"), (8, "qsgd"), (1, "terngrad")])
def test_tree_kernels_read_gathered_rows_in_place(dev, bits, scheme, n):
    """The tree decode and the tree unpack over the rows of an (n, bytes)
    gathered buffer of ResNet-18's 62 leaves: one launch each, equal to their
    twins on the same views and to the replica-contiguous launch, bit for
    bit."""
    codec = terngrad() if scheme == "terngrad" else QsgdCodec(bits=bits)
    grads = _resnet18_grads(dev, seed=bits + n)
    views, contiguous = _gathered_tree(codec, grads, n)
    K.reset_launch_counts()
    got = K.unpack_dequantize_tree(views, grads, bits=bits, n_replicas=n)
    codes = K.unpack_bucketed_tree([w for w, _ in views], bits=bits)
    torch.cuda.synchronize()
    assert K.launch_counts()["unpack_dequantize"] == 1
    assert K.launch_counts()["unpack_bucketed"] == 1
    want = K.unpack_dequantize_tree(contiguous, grads, bits=bits, n_replicas=n)
    twin = K.unpack_dequantize_tree_plain(views, grads, bits=bits, n_replicas=n)
    for a, b, c in zip(got, want, twin):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(codes, K.unpack_bucketed_tree([w for w, _ in contiguous], bits=bits))
    assert torch.equal(codes, K.unpack_bucketed_tree_plain([w for w, _ in views], bits=bits))


@pytest.mark.parametrize("path", ["fused", "pack"])
def test_gathered_decode_mean_makes_no_host_sync(dev, path):
    from atomo_tpu_torch.codecs import decode_mean_tree

    codec = QsgdCodec(bits=4, use_kernel=path == "fused")
    grads = _resnet18_grads(dev, seed=11)
    views, _ = _gathered_tree(codec, grads, 4)
    views = [QsgdPayload(w, s) for w, s in views]
    decode_mean_tree(codec, views, grads, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mean = decode_mean_tree(codec, views, grads, 4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(t).all()) for t in mean)


def test_tree_kernels_refuse_replicas_they_cannot_read(dev):
    # leaves of several buckets, so that the rows below are not contiguous
    grads = [g for g in _resnet18_grads(dev, seed=3) if g.numel() > 4 * BUCKET][:3]
    views, _ = _gathered_tree(QsgdCodec(bits=4), grads, 2)
    w0, s0 = views[0]
    # each replica's (n_buckets, n_words) laid out column by column
    bad = [(w0.transpose(1, 2).contiguous().transpose(1, 2), s0)] + views[1:]
    with pytest.raises(ValueError, match="contiguous"):
        K.unpack_dequantize_tree(bad, grads, bits=4, n_replicas=2)
    with pytest.raises(ValueError, match="contiguous"):
        K.unpack_bucketed_tree([w for w, _ in bad], bits=4)


@pytest.fixture(scope="module")
def nccl_group(tmp_path_factory):
    """A one-rank NCCL group on the card (its collectives are real NCCL
    calls of one rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from atomo_tpu_torch.parallel import launch

    ctx = launch.initialize("cuda:0", init_method=f"file://{tmp_path_factory.mktemp('nccl')}/s",
                            world_size=1, rank=0)
    yield ctx
    launch.shutdown()


@pytest.mark.parametrize("aggregate", ["gather", "ring", "psum"])
def test_nccl_world_one_step_equals_the_single_device_step(dev, nccl_group, aggregate):
    """At one rank the data-parallel QSGD step is the single-device step:
    the same uniforms give the same parameters bit for bit after two steps
    (cuDNN held to its deterministic algorithms: its default weight-gradient
    algorithms may sum in another order on every call), and the second
    makes one encode and one decode launch and no host sync."""
    from atomo_tpu_torch.codecs.qsgd import QsgdCodec as Codec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel.replicated import make_distributed_train_step
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step
    from atomo_tpu_torch.training.trainer import leaf_params

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    states, steps = [], []
    for dist_step in (False, True):
        model = get_model("resnet18", 10, image_shape=(32, 32, 3))
        state = create_state(model, opt, 1, dev)
        make = make_distributed_train_step if dist_step else make_train_step
        kw = {"aggregate": aggregate} if dist_step else {}
        states.append(state)
        steps.append(make(model, opt, Codec(bits=4), **kw))
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((32, 3, 32, 32), generator=gen, device=dev)
    y = torch.randint(0, 10, (32,), generator=gen, device=dev)
    u = [torch.rand((-(-p.numel() // BUCKET), BUCKET), generator=gen, device=dev)
         for p in leaf_params(states[0].model)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):  # the second step of each runs warm
            states[0], m0 = steps[0](states[0], 5, x, y, uniforms=u)
        states[1], m1 = steps[1](states[1], 5, x, y, draws=u)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            states[1], m1 = steps[1](states[1], 5, x, y, draws=u)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    counts = K.launch_counts()
    assert counts["quantize_pack"] == 1 and counts["unpack_dequantize"] == 1, counts
    assert m0["msg_bytes"] == m1["msg_bytes"] or aggregate == "psum"
    for a, b in zip(states[0].model.state_dict().values(), states[1].model.state_dict().values()):
        assert torch.equal(a, b)
