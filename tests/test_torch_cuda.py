"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip without one. This file imports no JAX, so
that the GPU machine (which has none) runs it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Words, codes and decoded values are compared bit for bit: kernel and plain
version do the same float32 operations in the same order (see
``atomo_tpu_torch/csrc/qsgd_kernels.cu``). Scales are compared within rtol
1e-6, the tolerance of the CPU tests.
"""

import dataclasses

import pytest
import torch

from atomo_tpu_torch.codecs import QsgdCodec, terngrad
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
