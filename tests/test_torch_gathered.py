"""The exchange's building blocks on the CPU: the packed payload buffer, the
tree decode reading a gathered buffer in place, the batch shard, the ring's
rotation and the one-device-per-process binding.

* ``pack_tree_buckets`` / ``unpack_tree_buckets`` round-trip every codec's
  payload tree bit for bit, and a stack of N ranks' buffers unpacks into
  each rank's payloads.
* The gathered layout. One ``all_gather_into_tensor`` of the packed buffers
  gives an (N, bytes) buffer: replica r of a leaf's words lies one rank's
  bytes after replica r - 1, not one after another. The tree decode (the
  twin of ``unpack_dequantize_tree_kernel``) and the tree unpack (the twin
  of ``unpack_codes_tree_kernel``), and the codec's ``decode_leaves`` on both
  paths, read those rows where they lie and equal the decode of the
  replica-contiguous payloads bit for bit, for N = 1, 2, 4 at 2, 4 and 8
  bits and TernGrad (the card tests hold the kernels against these twins).
* ``shard_batch`` gives rank r rows [r b/N, (r + 1) b/N) and refuses a batch
  that N does not divide with the JAX package's message; ``ring_perm`` is
  the reference's rotation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.mesh.collectives import ring_perm as jax_ring_perm
from atomo_tpu.parallel import make_mesh
from atomo_tpu.parallel import shard_batch as jax_shard_batch
from atomo_tpu_torch.codecs import (
    DenseCodec,
    QsgdCodec,
    QsgdPayload,
    SvdCodec,
    decode_mean_tree,
    decode_tree,
    encode_tree,
    payload_nbytes,
    terngrad,
)
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.ops import qsgd_kernels as K
from atomo_tpu_torch.parallel import launch
from atomo_tpu_torch.parallel.common import (
    hop_pieces,
    pack_tree_buckets,
    ring_perm,
    unpack_tree_buckets,
)
from atomo_tpu_torch.parallel.replicated import make_distributed_train_step, shard_batch
from atomo_tpu_torch.training import make_optimizer
from atomo_tpu_torch.training.trainer import leaf_params

# leaves of every kind the decode lays out: conv, linear, vector, and a leaf
# of several buckets with a ragged last one
SHAPES = [(8, 3, 3, 3), (10, 20), (10,), (3, 700), (16, 8, 1, 1)]


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in SHAPES]


def _codec(bits, fused):
    if bits == "terngrad":
        return terngrad(use_kernel=fused)
    return QsgdCodec(bits=bits, use_kernel=fused)


def _exchange(codec, n):
    """(gathered views, replica-contiguous payloads, grads_like) of n
    replicas' encodes, each of its own gradients and key."""
    per_rank = [encode_tree(codec, 10 + r, _grads(r))[0] for r in range(n)]
    packed = [pack_tree_buckets(p) for p in per_rank]
    spec = packed[0][1]
    gathered = torch.stack([b for b, _ in packed])  # what all_gather_into_tensor gives
    views = unpack_tree_buckets(gathered, spec)
    contiguous = [QsgdPayload(torch.stack([p.words.view(torch.int32) for p in ps])
                              .view(torch.uint32), torch.stack([p.scales for p in ps]))
                  for ps in zip(*per_rank)]
    if n > 1:
        assert not any(v.words.is_contiguous() for v in views)
    return views, contiguous, _grads(0)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("bits", [2, 4, 8, "terngrad"])
def test_tree_decode_reads_gathered_rows(bits, n):
    codec = _codec(bits, fused=True)
    views, contiguous, like = _exchange(codec, n)
    b = codec.bits
    want = K.unpack_dequantize_tree_plain(contiguous, like, bits=b, n_replicas=n)
    _same(K.unpack_dequantize_tree_plain(views, like, bits=b, n_replicas=n), want)
    _same(codec.decode_leaves(views, like, None, n), want)
    _same(decode_mean_tree(codec, views, like, n), want)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("bits", [2, 4, 8, "terngrad"])
def test_tree_unpack_reads_gathered_rows(bits, n):
    codec = _codec(bits, fused=False)
    views, contiguous, like = _exchange(codec, n)
    want = K.unpack_bucketed_tree_plain([p.words for p in contiguous], bits=codec.bits)
    _same([K.unpack_bucketed_tree_plain([v.words for v in views], bits=codec.bits)], [want])
    _same(codec.decode_leaves(views, like, None, n),
          codec.decode_leaves(contiguous, like, None, n))


def test_replica_stride_names_the_layouts_the_kernels_take():
    buf = torch.zeros((4, 64), dtype=torch.int32)
    rows = buf[:, 8:32].view(4, 3, 8)  # a field of a gathered buffer
    assert K.replica_stride(rows, 24, 4) == 64
    assert K.replica_stride(rows.contiguous(), 24, 4) == 24
    assert K.replica_stride(rows, 24, 3) == -1  # another size
    assert K.replica_stride(rows.transpose(1, 2), 24, 4) == -1  # a replica not contiguous


CODECS = {
    "qsgd": QsgdCodec(bits=4), "terngrad": terngrad(), "svd": SvdCodec(rank=3),
    "svd-bf16-wire": SvdCodec(rank=3, wire_dtype="bfloat16"),
    "svd-bernoulli": SvdCodec(rank=0, sample="bernoulli"), "dense": DenseCodec(),
}


@pytest.mark.parametrize("name", sorted(CODECS))
def test_pack_tree_buckets_round_trips(name):
    codec = CODECS[name]
    per_rank = [encode_tree(codec, 5 + r, _grads(r))[0] for r in range(3)]
    bufs = [pack_tree_buckets(p) for p in per_rank]
    buf, spec = bufs[0]
    assert buf.dtype == torch.uint8 and buf.shape == (spec.nbytes,) and spec.nbytes % 16 == 0
    assert sum(f[1] for leaf in spec.fields for f in leaf) == sum(
        payload_nbytes(p) for p in per_rank[0])  # the padding is all the buffer adds
    for got, want in zip(unpack_tree_buckets(buf, spec), per_rank[0]):
        assert type(got) is type(want)
        _same(list(got), list(want))
    stacked = unpack_tree_buckets(torch.stack([b for b, _ in bufs]), spec)
    for r, payloads in enumerate(per_rank):
        for got, want in zip(stacked, payloads):
            _same([f[r] for f in got], list(want))


def test_unfused_decode_mean_sums_replicas_in_order():
    """``fused=False``: each replica's decode summed in replica order, then
    divided (the ring's order)."""
    codec = SvdCodec(rank=2)
    per_rank = [encode_tree(codec, 3 + r, _grads(r))[0] for r in range(3)]
    stacked = [type(ps[0])(*(torch.stack(f) for f in zip(*ps))) for ps in zip(*per_rank)]
    like = _grads(0)
    dec = [decode_tree(codec, p, like) for p in per_rank]
    want = [(a + b + c) / torch.full_like(a, 3) for a, b, c in zip(*dec)]
    _same(decode_mean_tree(codec, stacked, like, 3, fused=False), want)


def test_shard_batch_gives_each_rank_its_rows():
    images, labels = np.arange(8 * 2).reshape(8, 2), np.arange(8)
    parts = [shard_batch(images, labels, r, 4) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), images)
    np.testing.assert_array_equal(parts[2][1], [4, 5])


def test_shard_batch_refuses_a_batch_n_does_not_divide():
    images, labels = np.zeros((6, 28, 28, 1), np.float32), np.zeros(6, np.int32)
    with pytest.raises(ValueError) as want:
        jax_shard_batch(make_mesh(n_devices=4), jnp.asarray(images), jnp.asarray(labels))
    with pytest.raises(ValueError) as got:
        shard_batch(images, labels, 0, 4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_ring_perm_is_the_reference_rotation(n):
    assert ring_perm(n) == jax_ring_perm(n)


def test_hop_pieces_cover_the_buffer_under_the_cap():
    assert hop_pieces(100, 0) == [(0, 100)]
    pieces = hop_pieces(100, 7)  # 28 bytes a message
    assert pieces[0] == (0, 28) and pieces[-1] == (84, 100)
    assert all(b == c for (_, b), (c, _) in zip(pieces, pieces[1:]))


def test_a_process_binds_one_device():
    binding = launch.DeviceBinding()
    binding.bind(torch.device("cpu"))
    binding.bind(torch.device("cpu"))  # the same device again is fine
    with pytest.raises(RuntimeError, match="one device per process"):
        binding.bind(torch.device("cuda", 1))
    with pytest.raises(ValueError, match="by index"):
        launch.DeviceBinding().bind(torch.device("cuda"))


def test_one_process_brings_up_no_group(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(launch, "PROCESS_DEVICE", launch.DeviceBinding())
    ctx = launch.initialize("cpu")
    assert (ctx.rank, ctx.world_size, ctx.backend) == (0, 1, None)
    assert not torch.distributed.is_initialized()
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    opt = make_optimizer("sgd", lr=0.01)
    opt.init(leaf_params(model))
    with pytest.raises(RuntimeError, match="no process group"):
        make_distributed_train_step(model, opt, None)
