"""The port's row codec (``sparse/rowcodec.py``) against the JAX package's.

Tolerance: none. The codec is lossless and selects rows by the same
two-band key, so ``rows``, ``values`` and ``overflow`` equal the JAX
payload's bit for bit; the decode, the mean over replicas and the round
trip are exact too (signed zeros compare equal, as the JAX package's own
contract states).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.sparse import RowCodec as JaxRowCodec
from atomo_tpu.sparse import row_payload_bytes as jax_row_payload_bytes
from atomo_tpu_torch.codecs import payload_nbytes
from atomo_tpu_torch.ops.qsgd_kernels import replica_mean
from atomo_tpu_torch.sparse import RowCodec, RowPayload, row_payload_bytes


def _sparse_grad(rows=64, cols=5, touched=(0, 3, 17, 40, 63), seed=0):
    g = np.zeros((rows, cols), np.float32)
    r = np.random.default_rng(seed)
    g[list(touched)] = r.standard_normal((len(touched), cols)).astype(np.float32)
    return g


@pytest.mark.parametrize("budget", [3, 5, 8, 64, 100])
@pytest.mark.parametrize("touched", [(0, 3, 17, 40, 63), (5, 6, 7), ()])
def test_payload_equals_jax(budget, touched):
    g = _sparse_grad(touched=touched)
    got = RowCodec(max_rows=budget).encode(0, torch.from_numpy(g))
    want = JaxRowCodec(max_rows=budget).encode(jax.random.PRNGKey(0), jnp.asarray(g))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.numpy().shape == b.shape
        assert a.numpy().tobytes() == b.tobytes()
    assert payload_nbytes(got) == row_payload_bytes(min(budget, 64), 5)


def test_lossless_round_trip_and_padding_identity():
    g = _sparse_grad()
    codec = RowCodec(max_rows=12)  # 7 padding slots pointing at row 0
    p = codec.encode(0, torch.from_numpy(g))
    assert p.rows.tolist()[:5] == [0, 3, 17, 40, 63] and p.rows.tolist()[5:] == [0] * 7
    assert float(p.values[5:].abs().sum()) == 0.0 and int(p.overflow) == 0
    back = codec.decode(p, g.shape)
    assert back.numpy().tobytes() == g.tobytes()
    want = JaxRowCodec(max_rows=12).decode(
        JaxRowCodec(max_rows=12).encode(jax.random.PRNGKey(0), jnp.asarray(g)), g.shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_overflow_counted_never_hidden():
    g = _sparse_grad()
    p = RowCodec(max_rows=3).encode(0, torch.from_numpy(g))
    assert int(p.overflow) == 2 and p.overflow.dtype == torch.int32
    assert p.rows.tolist() == [0, 3, 17]  # the first rows in ascending order
    back = RowCodec(max_rows=3).decode(p, g.shape).numpy()
    np.testing.assert_array_equal(back[:18], g[:18])
    assert not back[40:].any()


def test_rejects_non_2d_with_the_jax_message():
    for codec, x in ((RowCodec(4), torch.zeros(8)), (JaxRowCodec(4), jnp.zeros(8))):
        with pytest.raises(ValueError, match="RowCodec encodes 2-D"):
            codec.encode(0 if isinstance(x, torch.Tensor) else jax.random.PRNGKey(0), x)


def test_duplicate_rows_across_replicas_sum_exactly():
    """Replicas touching the same rows: the per-replica decodes summed in
    replica order, divided by N, equal the JAX package's
    ``jnp.mean(vmap(decode)(gathered), 0)`` and the port's ``replica_mean``
    of the dense gradients, bit for bit."""
    n, codec = 4, RowCodec(max_rows=8)
    grads = [_sparse_grad(touched=(1, 2, 9, 30 + r), seed=r) for r in range(n)]
    pays = [codec.encode(0, torch.from_numpy(g)) for g in grads]
    gathered = RowPayload(*(torch.stack(f) for f in zip(*pays)))
    got = codec.decode_mean(gathered, (64, 5), n)
    dense = replica_mean(torch.stack([torch.from_numpy(g) for g in grads]))
    assert got.numpy().tobytes() == dense.numpy().tobytes()
    jc = JaxRowCodec(max_rows=8)
    jg = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                *[jc.encode(jax.random.PRNGKey(0), jnp.asarray(g)) for g in grads])
    want = jnp.mean(jax.vmap(lambda q: jc.decode(q, (64, 5)))(jg), axis=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_mean_reads_a_strided_gathered_buffer():
    """The fields of a gathered (N, bytes) buffer lie at a replica stride;
    the decode-mean reads them in place and equals the mean of the
    contiguous payloads."""
    from atomo_tpu_torch.parallel.common import pack_tree_buckets, unpack_tree_buckets

    codec = RowCodec(max_rows=6)
    pays = [codec.encode(0, torch.from_numpy(_sparse_grad(touched=(2, 5, 7 + r), seed=r)))
            for r in range(3)]
    bufs = [pack_tree_buckets([p])[0] for p in pays]
    spec = pack_tree_buckets([pays[0]])[1]
    (strided,) = unpack_tree_buckets(torch.stack(bufs), spec)
    assert strided.values.stride(0) * 4 == spec.nbytes
    contiguous = RowPayload(*(torch.stack(f) for f in zip(*pays)))
    a = codec.decode_mean(strided, (64, 5), 3)
    b = codec.decode_mean(contiguous, (64, 5), 3)
    assert a.numpy().tobytes() == b.numpy().tobytes()
    assert int(strided.overflow.sum()) == 0


def test_row_payload_bytes_equal_jax():
    for args in ((128, 16), (1024, 16, 4), (7, 32, 2), (0, 8)):
        assert row_payload_bytes(*args) == jax_row_payload_bytes(*args)
