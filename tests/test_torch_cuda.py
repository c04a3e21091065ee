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
bit, with one encode and one decode launch and no host sync, and so does
the LM step over that group's (dp 1, sp 1) mesh; the LM's bfloat16 step
launches the flash kernel's bfloat16 form and keeps its state float32. A resumed
ResNet-18 run equals the straight one bit for bit on the card, and a
compressed checkpoint comes back onto the card bit for bit. The sparse-row
codec's encode on the card equals the CPU's, without a host sync, and the
embedding tower's hybrid step at one NCCL rank sends the plan's bytes, its
``DenseCodec`` form equal to ``hybrid=None`` bit for bit. The QSGD encode's
device form (the key read from device memory, each leaf's index folded in on
the card) equals the by-value launch and the plain version at widths 1-16;
a captured step replayed K times equals K eager steps bit for bit
(``--superstep``: LeNet sgd, qsgd under Adam, VGG-11 with dropout, ResNet-18
qsgd and terngrad with augmentation and an LR change, a per-leaf width
allocation, and the data-parallel step at one NCCL rank with error
feedback, with the embedding tower's hybrid exchange and with the delayed
step's carry), with the same launches. The layer buckets' encodes (one
launch a bucket) equal the plain twin; a bucket's encode on the side stream
reads its gradient only after the event of the backward stream, however
late the device writes it; the delayed step's step 0 holds parameters,
momentum and BatchNorm statistics, and its next step decodes the carried
payload without a host sync.
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


@pytest.mark.parametrize("bits", range(1, 17))
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
@pytest.mark.parametrize("bits,scheme", [(b, "qsgd") for b in range(1, 17)] + [(1, "terngrad")])
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
@pytest.mark.parametrize("bits,scheme", [(b, "qsgd") for b in range(1, 17)] + [(1, "terngrad")])
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


@pytest.mark.parametrize("bits", range(1, 17))
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
@pytest.mark.parametrize("bits", range(1, 17))
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


def test_lm_bf16_step_launches_the_bf16_kernel_and_keeps_float32(dev):
    """A small LM step with ``compute_dtype=torch.bfloat16`` on the card:
    the flash kernel's bfloat16 form launches once per layer, the
    parameters and the momentum stay float32, and the loss is within 1e-2
    relative of the same step in float32 (bfloat16's 8-bit mantissa)."""
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.parallel.lm import make_lm_train_step
    from atomo_tpu_torch.training import create_state, make_optimizer

    cfg = dict(vocab_size=64, max_len=128, width=128, depth=2, num_heads=2)
    opt = make_optimizer("sgd", lr=0.1, momentum=0.9)
    tokens = torch.randint(0, 64, (2, 128), generator=torch.Generator().manual_seed(0)).to(dev)
    losses = {}
    for dtype in (None, torch.bfloat16):
        state = create_state(TransformerLM(**cfg), opt, 1, dev)
        step = make_lm_train_step(state.model, opt, None, attn_impl="ulysses-flash",
                                  compute_dtype=dtype)
        A.reset_launch_counts()
        state, m = step(state, 1, tokens)
        losses[dtype] = float(m["loss"])
        assert A.launch_counts()["flash_attention"] == cfg["depth"]
        assert A.bf16_launch_count() == (cfg["depth"] if dtype else 0)
        assert {p.dtype for p in state.model.parameters()} == {torch.float32}
        assert {t.dtype for t in state.opt_state.trace} == {torch.float32}
    assert abs(losses[torch.bfloat16] - losses[None]) <= 1e-2 * losses[None]


@pytest.mark.parametrize("aggregate", ["gather", "ring", "psum"])
def test_lm_nccl_world_one_step_equals_the_single_device_step(dev, nccl_group, aggregate):
    """The LM step over a one-rank NCCL group's (dp 1, sp 1) mesh (its dp
    exchange real NCCL calls) equals the step with no group bit for bit
    after two svd steps with the same draws, with the same message bytes
    and one flash launch per layer."""
    import copy

    from atomo_tpu_torch.codecs import SvdCodec
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.lm import DpExchange, make_lm_train_step
    from atomo_tpu_torch.training import create_state, make_optimizer

    cfg = dict(vocab_size=64, max_len=128, width=128, depth=2, num_heads=2)
    opt = make_optimizer("sgd", lr=0.1, momentum=0.9)
    base = TransformerLM(**cfg)
    tokens = torch.randint(0, 64, (2, 128), generator=torch.Generator().manual_seed(0)).to(dev)
    exchange = DpExchange("ring") if aggregate == "ring" else None
    out = []
    for mesh in (None, launch.dp_sp_mesh(1)):
        state = create_state(copy.deepcopy(base), opt, 1, dev)
        step = make_lm_train_step(state.model, opt, SvdCodec(rank=12),
                                  attn_impl="ulysses-flash", aggregate=aggregate,
                                  exchange=exchange, mesh=mesh)
        A.reset_launch_counts()
        for i in (1, 2):
            state, m = step(state, i, tokens)
        assert A.launch_counts()["flash_attention"] == 2 * cfg["depth"]
        out.append((state, m["msg_bytes"]))
    assert out[0][1] == out[1][1]
    for a, b in zip(out[0][0].model.state_dict().values(), out[1][0].model.state_dict().values()):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("path", ["fused", "pack"])
def test_mixed_width_tree_matches_plain(dev, path, n):
    """A per-leaf codec giving ResNet-18's 62 leaves every width 1..16: the
    encode is one launch per width, the gathered decode of n replicas one
    launch per width, each leaf read at its own offset and width. Against the
    plain versions on the CPU: scales within 1 ulp (the pack path's torch
    quantizer within rtol 1e-6: its vector_norm sums a bucket in other
    orders on the card and the CPU), words bit for bit in every bucket whose
    scale is the same, and the decoded mean of the card's payloads (fused
    path) or its codes and their packing again (pack path) bit for bit."""
    from atomo_tpu_torch.budget import budgeted_codec
    from atomo_tpu_torch.codecs import decode_mean_tree, encode_tree
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets

    codec = budgeted_codec(QsgdCodec(bits=4, use_kernel=path == "fused"),
                           [1 + i % 16 for i in range(62)])
    grads = _resnet18_grads(dev, seed=21)
    cpu = [g.cpu() for g in grads]
    gen = torch.Generator(device=dev).manual_seed(5)
    reps = []
    for r in range(n):
        u = [torch.rand((K.geometry(g.numel(), 1).n_buckets, BUCKET), generator=gen,
                        device=dev) for g in grads]
        K.reset_launch_counts()
        got = encode_tree(codec, 100 + r, grads, draws=u)[0]
        counts = K.launch_counts()
        assert counts["quantize_pack" if path == "fused" else "pack_bucketed"] == 16
        want = encode_tree(codec, 100 + r, cpu, draws=[t.cpu() for t in u])[0]
        for a, b in zip(got, want):
            sa = a.scales.cpu()
            if path == "fused":
                assert float(_ulps(sa, b.scales).max()) <= 1.0
            else:  # torch's vector_norm sums in other orders on the card and the CPU
                torch.testing.assert_close(sa, b.scales, rtol=1e-6, atol=0.0)
            same = sa == b.scales
            assert _same_bits(a.words.cpu().view(torch.int32)[same],
                              b.words.view(torch.int32)[same])
        reps.append(got)
    packed = [pack_tree_buckets(p) for p in reps]
    views = unpack_tree_buckets(torch.stack([b for b, _ in packed]), packed[0][1])
    K.reset_launch_counts()
    mean = decode_mean_tree(codec, views, grads, n)
    torch.cuda.synchronize()
    key = "unpack_dequantize" if path == "fused" else "unpack_bucketed"
    assert K.launch_counts()[key] == 16
    assert all(a.shape == g.shape for a, g in zip(mean, grads))
    if path == "fused":  # the decoded values
        plain = decode_mean_tree(codec, [QsgdPayload(v.words.cpu(), v.scales.cpu())
                                         for v in views], cpu, n)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(mean, plain))
    else:  # the unpack kernel's codes (the dequantize is torch's on either device)
        for k in range(1, 17):
            group = [v.words for v, w in zip(views, codec.ks) if w == k]
            codes = K.unpack_bucketed_tree(group, bits=k)
            assert torch.equal(codes.cpu(),
                               K.unpack_bucketed_tree_plain([w.cpu() for w in group], bits=k))
            rows = [w.numel() // w.shape[-1] for w in group]
            packed = torch.cat([w.view(torch.int32) for w in
                                K.pack_bucketed_tree(codes, rows, bits=k)])
            assert _same_bits(packed.cpu(), torch.cat([w.reshape(-1, w.shape[-1]).cpu().view(
                torch.int32) for w in group]))


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


# a process of its own: cuBLAS reads its workspace setting when its first
# handle is made, which in this process happened long before
RESUME_ON_THE_CARD = """
import sys, torch
torch.use_deterministic_algorithms(True, warn_only=True)
from atomo_tpu_torch import ops
from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import make_optimizer, train_loop

work, code = sys.argv[1], sys.argv[2]
ds = synthetic_dataset(SPECS["cifar10"], True, size=256, seed=3)

def run(d, steps, resume=False):
    codec = get_codec(code, quantization_level=4, svd_rank=3)
    return train_loop(get_model("resnet18", 10, image_shape=(32, 32, 3)),
                      make_optimizer("sgd", lr=0.01, momentum=0.9),
                      BatchIterator(ds, 32, seed=3), codec=codec, augment=True,
                      max_steps=steps, seed=3, train_dir=d, save_freq=2, resume=resume,
                      compress_ckpt=True, log_fn=lambda _: None, device="cuda")

ops.reset_launch_counts()
a = run(work + "/a", 4)
assert code != "qsgd" or ops.launch_counts()["quantize_pack"] == 4, ops.launch_counts()
run(work + "/b", 2)
b = run(work + "/b", 4, resume=True)
for x, y in zip(list(a.model.state_dict().values()) + a.opt_state.trace,
                list(b.model.state_dict().values()) + b.opt_state.trace):
    assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
print("bit-identical")
"""


@pytest.mark.parametrize("code", ["qsgd", "svd"])
def test_resume_is_bit_identical_on_the_card(dev, tmp_path, code):
    """ResNet-18 (batch 32, augmentation on) 4 steps straight, and 2 then
    resumed to 4, under torch's deterministic algorithms: every parameter,
    buffer and momentum tensor equal bit for bit."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run(
        [sys.executable, "-c", RESUME_ON_THE_CARD, str(tmp_path), code], capture_output=True,
        text=True, timeout=600, cwd=str(Path(__file__).resolve().parents[1]),
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert proc.returncode == 0 and proc.stdout.strip() == "bit-identical", proc.stderr[-3000:]


def test_compressed_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A ResNet-18 state with AMSGrad moments, saved compressed from the
    card and loaded back onto it: every tensor on the card and equal bit for
    bit."""
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import checkpoint as ck
    from atomo_tpu_torch.training import create_state, make_optimizer

    opt = make_optimizer("adam", amsgrad=True)

    def fresh(seed):
        return create_state(get_model("resnet18", 10, image_shape=(32, 32, 3)), opt, seed, dev)

    state = fresh(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in state.opt_state.mu + state.opt_state.nu + state.opt_state.nu_max:
        t.copy_(torch.rand(t.shape, generator=gen, device=dev))
    state.opt_state.count, state.step = 9, 9
    path = ck.save_checkpoint(str(tmp_path), state, compress=True)
    with open(path, "rb") as f:
        assert f.read(4) == ck.MAGIC_LZ
    back = ck.load_checkpoint(str(tmp_path), fresh(1))
    assert back.step == 9 and back.opt_state.count == 9
    ours = list(state.model.state_dict().values()) + state.opt_state.mu + state.opt_state.nu \
        + state.opt_state.nu_max
    theirs = list(back.model.state_dict().values()) + back.opt_state.mu + back.opt_state.nu \
        + back.opt_state.nu_max
    for a, b in zip(ours, theirs):
        assert b.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.parametrize("budget", [5, 300, 5000])
def test_row_codec_on_the_card_equals_the_cpu(dev, budget):
    """The row encode of a sparse gradient on the card equals the CPU's
    (rows, values, overflow), the decode is lossless within the budget, and
    the decode-mean over a strided gathered stack equals ``replica_mean`` of
    the replicas' decodes bit for bit."""
    from atomo_tpu_torch.ops.qsgd_kernels import replica_mean
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets
    from atomo_tpu_torch.sparse import RowCodec

    gen = torch.Generator(device=dev).manual_seed(budget)
    codec = RowCodec(max_rows=budget)
    grads, bufs = [], []
    for _ in range(3):
        g = torch.zeros((65536, 16), device=dev)
        rows = torch.randint(0, 65536, (400,), generator=gen, device=dev)
        g[rows] = torch.randn((400, 16), generator=gen, device=dev)
        p = codec.encode(0, g)
        want = codec.encode(0, g.cpu())
        assert all(torch.equal(a.cpu(), b) for a, b in zip(p, want))
        touched = int((g != 0).any(dim=1).sum())
        assert int(p.overflow) == max(0, touched - budget)
        if budget >= touched:
            assert torch.equal(codec.decode(p, g.shape), g)
        grads.append(codec.decode(p, g.shape))
        buf, spec = pack_tree_buckets([p])
        bufs.append(buf)
    (gathered,) = unpack_tree_buckets(torch.stack(bufs), spec)
    got = codec.decode_mean(gathered, (65536, 16), 3)
    assert torch.equal(got, replica_mean(torch.stack(grads)))


def test_row_encode_and_decode_make_no_host_sync(dev):
    from atomo_tpu_torch.sparse import RowCodec, RowPayload

    g = torch.zeros((4096, 16), device=dev)
    g[:50] = 1.0
    codec = RowCodec(max_rows=128)
    codec.decode(codec.encode(0, g), g.shape)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p = codec.encode(0, g)
        codec.decode_mean(RowPayload(*(t[None].expand(2, *t.shape) for t in p)), g.shape, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_hybrid_nccl_world_one_step(dev, nccl_group):
    """The embedding tower at one NCCL rank: the qsgd hybrid step sends the
    plan's bytes with no row dropped, launches one encode and one decode
    (the tower's leaves), and the ``DenseCodec`` hybrid's parameters equal
    ``hybrid=None``'s bit for bit after two steps."""
    from atomo_tpu_torch.codecs import DenseCodec
    from atomo_tpu_torch.data import to_device, zipf_dataset
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel.replicated import make_distributed_train_step
    from atomo_tpu_torch.sparse import plan_for_model
    from atomo_tpu_torch.training import create_state, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    ds = zipf_dataset(True, size=128, seed=0)
    batches = [to_device(ds.images[i * 64:(i + 1) * 64], ds.labels[i * 64:(i + 1) * 64], dev)
               for i in range(2)]
    opt = make_optimizer("sgd", lr=0.1, momentum=0.9)
    params = {}
    for label, codec, hybrid in (("qsgd", QsgdCodec(bits=4), True),
                                 ("dense_on", DenseCodec(), True),
                                 ("dense_off", DenseCodec(), False)):
        model = get_model("embedding", 10, image_shape=(8,))
        plan = plan_for_model(codec, model, ds.images[:64], ds.labels[:64], 64, 8)
        state = create_state(model, opt, 1, dev)
        step = make_distributed_train_step(model, opt, codec, aggregate="gather",
                                           hybrid=plan if hybrid else None)
        K.reset_launch_counts()
        for x, y in batches:
            state, m = step(state, 3, x, y)
        if hybrid:
            assert int(m["msg_bytes"]) == plan.payload_bytes() and float(m["row_overflow"]) == 0
        if label == "qsgd":
            counts = K.launch_counts()
            assert counts["quantize_pack"] == 2 and counts["unpack_dequantize"] == 2, counts
        params[label] = [p.detach().clone() for p in leaf_params(model)]
    assert all(torch.equal(a, b) for a, b in zip(params["dense_on"], params["dense_off"]))


@pytest.mark.parametrize("bits", range(1, 17))
def test_device_key_form_matches_by_value_and_plain(dev, bits):
    """The encode with its key in device memory (``FoldedSeeds``: the kernel
    folds each leaf's index into it) equals the launch with the folded
    seeds by value and the plain version, words bit for bit, scales equal;
    the tree launch and the (L, n) stack alike."""
    from atomo_tpu_torch.utils.rng import FoldedSeeds, fold_in

    gen = torch.Generator(device=dev).manual_seed(bits)
    leaves = [torch.randn((n,), generator=gen, device=dev) for n in (700, 4113, 512, 33)]
    key = (1 << 62) + 12345 * bits
    idxs = [5, 0, 17, 255]
    dkey = torch.tensor(key, dtype=torch.int64, device=dev)
    by_value = [fold_in(key, i) for i in idxs]
    K.reset_launch_counts()
    dev_form = K.quantize_pack_tree(leaves, bits=bits, seeds=FoldedSeeds(dkey, idxs))
    val_form = K.quantize_pack_tree(leaves, bits=bits, seeds=by_value)
    plain = K.quantize_pack_tree_plain(leaves, bits=bits, seeds=by_value)
    torch.cuda.synchronize()
    for (wd, sd), (wv, sv), (wp, sp) in zip(dev_form, val_form, plain):
        assert _same_bits(wd, wv) and _same_bits(wd, wp)
        assert torch.equal(sd, sv)
        torch.testing.assert_close(sd, sp, rtol=1e-6, atol=0.0)
    x = torch.randn((3, 1000), generator=gen, device=dev)
    wd, sd = K.quantize_pack(x, bits=bits, seeds=FoldedSeeds(dkey, [2, 9, 4]))
    wv, sv = K.quantize_pack(x, bits=bits, seeds=[fold_in(key, i) for i in (2, 9, 4)])
    assert _same_bits(wd, wv) and torch.equal(sd, sv)
    assert K.launch_counts()["quantize_pack"] == 4


# a process of its own: cuBLAS reads its workspace setting when its first
# handle is made, and the replay is held to the eager steps bit for bit
GRAPH_ON_THE_CARD = """
import json, sys, torch
torch.use_deterministic_algorithms(True, warn_only=True)
from atomo_tpu_torch import ops
from atomo_tpu_torch.budget import budgeted_codec
from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
from atomo_tpu_torch.data.pipeline import BlockStream, block_to_device
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step

network, code, optname, where, steps, work = sys.argv[1:7]
steps = int(steps)
cifar = network not in ("lenet", "embedding")
if network == "embedding":  # zipf row ids, (B, 8)
    from atomo_tpu_torch.data import zipf_dataset
    ds, shape = zipf_dataset(True, size=512, seed=0), (8,)
else:
    spec = SPECS["cifar10" if cifar else "mnist"]
    ds, shape = synthetic_dataset(spec, True, size=512, seed=3), spec.image_shape
make, kw = make_train_step, {}
if where != "single":
    from atomo_tpu_torch.parallel import launch
    from atomo_tpu_torch.parallel.replicated import make_distributed_train_step as make
    launch.initialize("cuda:0", init_method=f"file://{work}/s", world_size=1, rank=0)
    kw = {"error_feedback": where == "nccl-ef"}
    if where == "nccl-delayed":  # the stale-by-one step: its carry updated in place
        kw = {"overlap": "delayed"}

def codec():
    if code == "sgd":
        return None
    if code == "budget":  # a per-leaf width allocation: widths 2-9 over the leaves
        n = 62 if network == "resnet18" else 8
        return budgeted_codec(get_codec("qsgd"), [2 + i % 8 for i in range(n)])
    return get_codec(code, quantization_level=4)

if where == "nccl-hybrid":  # the table as lossless rows, the rest qsgd
    from atomo_tpu_torch.sparse import plan_for_model
    kw["hybrid"] = plan_for_model(codec(), get_model(network, 10, image_shape=shape),
                                  ds.images[:32], ds.labels[:32], 32, 8)
    assert kw["hybrid"].any_sparse

def fresh(k):
    model = get_model(network, 10, image_shape=shape)
    opt = make_optimizer(optname, lr=0.01, momentum=0.9, shrinkage_freq=5)
    state = create_state(model, opt, 3, "cuda")
    c = codec()
    if where == "nccl-delayed":
        from atomo_tpu_torch.parallel.replicated import init_delayed_state
        state = init_delayed_state(state, c)
    return state, make(model, opt, c, augment=cifar, superstep=k, **kw)

def carried(state):
    o = state.opt_state
    ts = list(state.model.state_dict().values())
    for name in ("trace", "mu", "nu", "nu_max"):
        ts += getattr(o, name, None) or []
    return ts + (state.residual or []) + ([state.carry.payload] if state.carry else [])

state, step = fresh(1)
stream = BatchIterator(ds, 32, seed=3).forever()
ops.reset_launch_counts()
losses = []
for _ in range(steps):
    state, m = step(state, 7, *to_device(*next(stream), "cuda"))
    losses.append(float(m["loss"]))
ref, ref_counts = carried(state), ops.launch_counts()
for k in (8, 3):
    state, block = fresh(k)
    assert block.mode == "graph", block.why
    blocks = BlockStream(BatchIterator(ds, 32, seed=3).forever())
    ops.reset_launch_counts()
    got, s = [], 0
    while s < steps:
        kb = min(k, steps - s)
        staged = block_to_device(*blocks.take(kb), "cuda")
        if staged.ready is not None:
            torch.cuda.current_stream().wait_event(staged.ready)
        state, m = block(state, 7, staged.images, staged.labels)
        got += m["loss"].tolist()
        s += kb
    assert state.step == steps and block.replays == steps - 1, (state.step, block.replays)
    assert got == losses, (k, got, losses)
    for a, b in zip(ref, carried(state)):
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), k
    assert ops.launch_counts() == ref_counts, (k, ops.launch_counts(), ref_counts)
print(json.dumps({"ok": True, "launches": ref_counts}))
"""


@pytest.mark.parametrize("network,code,optimizer,where,steps", [
    ("lenet", "sgd", "sgd", "single", 7),
    ("lenet", "qsgd", "adam", "single", 7),
    ("vgg11", "qsgd", "sgd", "single", 7),
    ("resnet18", "qsgd", "sgd", "single", 7),
    ("resnet18", "terngrad", "sgd", "single", 7),
    ("resnet18", "budget", "sgd", "single", 7),
    ("resnet18", "qsgd", "sgd", "nccl-ef", 7),
    ("lenet", "sgd", "sgd", "nccl", 7),
    ("embedding", "qsgd", "sgd", "nccl-hybrid", 7),
    ("resnet18", "qsgd", "sgd", "nccl-delayed", 7),
])
def test_graph_replay_equals_eager_steps(dev, tmp_path, network, code, optimizer, where, steps):
    """7 steps (an LR change at step 5, augmentation on CIFAR shapes,
    dropout in VGG-11) run eagerly one by one, then as blocks of 8 (one
    warm-up step, a capture, 6 replays) and of 3 (blocks 3, 3, 1): per-step
    losses, parameters, buffers, optimizer state, the residual and the
    delayed step's carried payload equal bit for bit under torch's
    deterministic algorithms, with the same kernel launches counted (the
    delayed step's warm-up is its step 0, which applies nothing)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run(
        [sys.executable, "-c", GRAPH_ON_THE_CARD, network, code, optimizer, where, str(steps),
         str(tmp_path)], capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parents[1]),
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"]
    if code in ("qsgd", "terngrad"):
        assert out["launches"]["quantize_pack"] == steps


def test_graph_rule_names_the_eager_steps(dev):
    """The rule sends svd, the pack path and num_aggregate to the eager
    block with their reasons, and qualifies the fused codec at one NCCL
    rank; the svd block on the card is the eager one."""
    from atomo_tpu_torch.codecs import get_codec
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import create_state, make_optimizer, make_train_step
    from atomo_tpu_torch.training.graph import graph_rule

    assert graph_rule(device=dev, codec=get_codec("qsgd"), backend="nccl")[0]
    assert "eigh" in graph_rule(device=dev, codec=get_codec("svd", svd_rank=3))[1]
    assert "pack path" in graph_rule(device=dev, codec=get_codec("qsgd", use_kernel=False,
                                                                 pack_kernel=True))[1]
    assert "num_aggregate" in graph_rule(device=dev, codec=get_codec("qsgd"), backend="nccl",
                                         world=2, k_agg=1)[1]
    model = get_model("lenet", 10)
    opt = make_optimizer("sgd")
    create_state(model, opt, 0, dev)
    block = make_train_step(model, opt, get_codec("svd", svd_rank=3), superstep=4)
    assert block.mode == "eager" and "eigh" in block.why
    assert make_train_step(model, opt, get_codec("qsgd"), superstep=4).mode == "graph"


def _resnet_grads(dev, seed: int = 0):
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training.trainer import leaf_params

    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model, [torch.randn(p.shape, generator=gen, device=dev) * (0.01 * (1 + i % 7))
                   for i, p in enumerate(leaf_params(model))]


def test_streamed_bucket_encodes_match_plain(dev):
    """The 4 MiB layer buckets of ResNet-18 encoded one tree launch a
    bucket (row 1, 10 launches) equal the plain twin on the same card
    tensors: words bit for bit, scales within rtol 1e-6; together they are
    the one-launch encode of the whole tree."""
    from atomo_tpu_torch.codecs import encode_leaf_subset, encode_tree
    from atomo_tpu_torch.convert import jax_layouts, jax_view
    from atomo_tpu_torch.parallel.common import plan_layer_buckets
    from atomo_tpu_torch.utils.rng import fold_in

    model, grads = _resnet_grads(dev)
    layouts = jax_layouts(model)
    codec = QsgdCodec(bits=4)
    plan = plan_layer_buckets(grads, 4 << 20)
    whole, _ = encode_tree(codec, 99, grads, None, layouts)
    K.reset_launch_counts()
    for idxs in plan.buckets:
        got = encode_leaf_subset(codec, 99, grads, idxs, None, layouts)
        want = K.quantize_pack_tree_plain(
            [jax_view(grads[i], layouts[i]).reshape(-1) for i in idxs], bits=4,
            seeds=[fold_in(99, i) for i in idxs])
        for i, g, (ww, ws) in zip(idxs, got, want):
            assert _same_bits(g.words, ww)
            torch.testing.assert_close(g.scales, ws, rtol=1e-6, atol=0.0)
            assert _same_bits(g.words, whole[i].words) and torch.equal(g.scales, whole[i].scales)
    assert K.launch_counts()["quantize_pack"] == plan.n_buckets == 10


class _SlowGrad(torch.autograd.Function):
    """The identity whose backward makes the gradient late on the device:
    a spin of the backward stream, then the product that writes it."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        torch.cuda._sleep(100_000_000)
        return g * 3.0


def test_bucket_encode_waits_for_its_gradient_event(dev):
    """The hook fires when backward's host side has issued a bucket's last
    gradient, long before the device has written it; the side stream's
    encode waits on the event the hook records, so it reads the finished
    gradient: the payload equals the encode of ``x.grad`` after a
    synchronise, bit for bit."""
    from atomo_tpu_torch.codecs import encode_leaf_subset
    from atomo_tpu_torch.parallel.common import plan_layer_buckets
    from atomo_tpu_torch.parallel.overlap import BucketStream, side_stream

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1 << 20, generator=gen, device=dev).requires_grad_()
    w = torch.randn(1 << 20, generator=gen, device=dev)
    codec = QsgdCodec(bits=4)
    plan = plan_layer_buckets([x], 0)
    bs = BucketStream(plan, codec, 5, layouts=None, feed=lambda i, g: g,
                      stream=side_stream(dev)).arm([x])
    (_SlowGrad.apply(x) * w).sum().backward()
    got = bs.finish()
    torch.cuda.synchronize()
    want = encode_leaf_subset(codec, 5, [x.grad], [0])
    assert bs.log == [("ready", 0), ("issue", 0)]
    assert _same_bits(got[0].words, want[0].words) and torch.equal(got[0].scales, want[0].scales)


def test_delayed_step0_holds_and_the_next_step_consumes(dev, nccl_group):
    """ResNet-18 at batch 32, qsgd 4 bits, delayed at one NCCL rank: step 0
    encodes (one row-1 launch), consumes nothing and leaves parameters,
    momentum and BatchNorm statistics bit for bit as they were; step 1
    decodes the carried payload (one row-2 launch) on the side stream with
    no host sync, and moves them."""
    from atomo_tpu_torch import ops
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset, to_device
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.parallel.replicated import (
        init_delayed_state,
        make_distributed_train_step,
    )
    from atomo_tpu_torch.training import create_state, make_optimizer

    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    model = get_model("resnet18", 10, image_shape=(32, 32, 3))
    codec = QsgdCodec(bits=4)
    state = init_delayed_state(create_state(model, opt, 1, dev), codec)
    step = make_distributed_train_step(model, opt, codec, overlap="delayed", augment=True)
    it = BatchIterator(synthetic_dataset(SPECS["cifar10"], True, size=256), 32, seed=1).epoch()

    def carried():
        return [t.detach().clone() for t in list(model.state_dict().values())
                + state.opt_state.trace]

    before = carried()
    ops.reset_launch_counts()
    state, m = step(state, 2, *to_device(*next(it), dev))
    torch.cuda.synchronize()
    assert float(m["skipped"]) == 1.0 and state.carry.valid
    assert all(torch.equal(a, b) for a, b in zip(before, carried()))
    assert ops.launch_counts()["quantize_pack"] == 1
    assert ops.launch_counts()["unpack_dequantize"] == 0
    x, y = to_device(*next(it), dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, 2, x, y)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(m["skipped"]) == 0.0
    assert ops.launch_counts()["unpack_dequantize"] == 1
    assert not all(torch.equal(a, b) for a, b in zip(before, carried()))


# ------------------------------------------------------- the LM layouts, ways 1


LAYOUT_CFG = dict(vocab_size=64, max_len=128, width=128, depth=2, num_heads=2, num_experts=4)


def _layout_step(layout, d, codec):
    import numpy as np

    from atomo_tpu_torch.mesh.spec import MeshSpec
    from atomo_tpu_torch.parallel import model_axes as MA
    from atomo_tpu_torch.training import make_optimizer

    cfg = dict(LAYOUT_CFG)
    if layout != "dp-ep":
        cfg.pop("num_experts")
    full = MA.full_family_init(layout, cfg, 0)
    # psum, what --aggregate auto takes at dp 1: at one replica its exchange
    # is no collective, so the CPU twin runs beside this file's NCCL group
    prog = MA.build_model_axis_program(
        MeshSpec.from_layout(layout, 1, (1, 1) if layout == "dp-tp-sp" else 1), cfg,
        make_optimizer("sgd", lr=0.1, momentum=0.9), 0, codec, layout=layout,
        attn_impl="ulysses-flash", aggregate="psum", params=full, device=d)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (4, 128))).to(d)
    K.reset_launch_counts()
    A.reset_launch_counts()
    state, m = prog.step(prog.state, 1, tokens)
    counts = {**K.launch_counts(), **A.launch_counts()}
    return float(m["loss"]), [p.detach().cpu() for p in state.model.parameters()], counts


def _held_to_plain(real, plain, check):
    """``real`` (a kernel wrapper) that, at each call, also runs its plain
    twin on the same inputs and hands both results to ``check``."""
    def run(*args, **kwargs):
        out = real(*args, **kwargs)
        check(out, plain(*args, **kwargs))
        return out
    return run


@pytest.mark.parametrize("layout", ["dp-tp", "dp-ep", "dp-pp", "dp-tp-sp"])
def test_layout_at_ways_one_runs_the_kernels_on_the_card(dev, layout, monkeypatch):
    """Each layout at model ways 1 on the card with qsgd 4 bits (psum, dp
    1): one fused encode and one tree decode a step (rows 1-2), dp-tp-sp
    the flash kernel once a layer (row 5). What rows 1-2 give the step
    equals their plain twins on the same inputs (words and decoded values
    bit for bit, scales within 1e-6 relative); the step's loss equals the
    CPU step's (plain twins) within 1e-4 relative (TF32 off)."""
    seen = {"encode": 0, "decode": 0}

    def check_encode(out, plain):
        for (w, sc), (pw, ps) in zip(out, plain):
            assert torch.equal(w, pw)
            torch.testing.assert_close(sc, ps, rtol=1e-6, atol=0.0)
        seen["encode"] += 1

    def check_decode(out, plain):
        assert all(torch.equal(a, b) for a, b in zip(out, plain))
        seen["decode"] += 1

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = _layout_step(layout, "cpu", QsgdCodec(bits=4))
        monkeypatch.setattr(K, "quantize_pack_tree", _held_to_plain(
            K.quantize_pack_tree, K.quantize_pack_tree_plain, check_encode))
        monkeypatch.setattr(K, "unpack_dequantize_tree", _held_to_plain(
            K.unpack_dequantize_tree, K.unpack_dequantize_tree_plain, check_decode))
        got = _layout_step(layout, dev, QsgdCodec(bits=4))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got[2]["quantize_pack"] == 1 and got[2]["unpack_dequantize"] == 1
    assert seen == {"encode": 1, "decode": 1}
    assert got[2]["flash_attention"] == (LAYOUT_CFG["depth"] if layout == "dp-tp-sp" else 0)
    assert sum(want[2].values()) == 0
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])


@pytest.mark.parametrize("layout", ["dp-tp", "dp-ep", "dp-pp", "dp-tp-sp"])
def test_layout_at_ways_one_dense_step_matches_the_cpu(dev, layout):
    """The same step with no codec: parameters within 1e-5 of the CPU's."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = _layout_step(layout, dev, None)
        want = _layout_step(layout, "cpu", None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    for a, b in zip(got[1], want[1]):
        assert float((a - b).abs().max()) <= 1e-5
