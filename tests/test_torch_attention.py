"""The port's attention against the JAX package's (CPU, float32 unless said).

The JAX ``flash_attention`` runs its Pallas kernel in interpret mode, as the
JAX package's own tests run it on the CPU (and falls back to its blockwise
oracle where S does not divide by the blocks); the port's CPU path is the
kernel's plain twin, ``flash_attention_plain``. Inputs are numpy draws from
fixed seeds. Tolerances:

* forward outputs: atol 2e-5 (float32, sums in other orders);
* bfloat16 inputs: outputs within one bfloat16 step of values below 4
  (atol 2**-6): both packages accumulate in float32 and round once;
* gradients (the port's autograd function against ``jax.grad`` of the JAX
  function, both through the blockwise oracle): atol 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu.ops.attention_kernels import flash_attention as jax_flash
from atomo_tpu.parallel import make_mesh
from atomo_tpu.parallel import ring as jring
from atomo_tpu_torch.ops import attention_kernels as A
from atomo_tpu_torch.parallel import ring as pring

SHAPE = (2, 3, 64, 16)


def _qkv(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block_q,block_k", [(16, 16), (32, 16), (64, 64)])
def test_flash_plain_matches_jax_kernel(block_q, block_k, causal):
    q, k, v = _qkv()
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=block_q,
                     block_k=block_k)
    got = A.flash_attention(*map(_t, (q, k, v)), causal=causal, block_q=block_q,
                            block_k=block_k)
    _close(got.numpy(), want, 2e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ragged_length_matches_jax_fallback(causal):
    """S = 50 does not divide by 16: JAX falls back to its blockwise oracle,
    the port's plain twin just runs a shorter last tile."""
    q, k, v = _qkv((2, 3, 50, 16), seed=1)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=16, block_k=16)
    got = A.flash_attention(*map(_t, (q, k, v)), causal=causal, block_q=16, block_k=16)
    _close(got.numpy(), want, 2e-5)


def test_bf16_inputs_match_jax_kernel():
    q, k, v = _qkv(seed=2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=True, block_q=32, block_k=32)
    pq, pk, pv = (_t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (jq, jk, jv))
    got = A.flash_attention(pq, pk, pv, causal=True, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float().numpy(), want.astype(jnp.float32), 2.0**-6)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_gradients_match_jax(causal):
    q, k, v = _qkv(seed=3)
    w = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)

    def jloss(a, b, c):
        return jnp.sum(jax_flash(a, b, c, causal=causal, block_q=32, block_k=16) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    pq, pk, pv = (_t(a).requires_grad_() for a in (q, k, v))
    (A.flash_attention(pq, pk, pv, causal=causal, block_q=32, block_k=16) * _t(w)).sum().backward()
    for g, jg in zip((pq.grad, pk.grad, pv.grad), want):
        _close(g.numpy(), jg, 5e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_oracles_match_jax(causal):
    q, k, v = _qkv((2, 3, 40, 8), seed=5)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pq, pk, pv = map(_t, (q, k, v))
    _close(pring.full_attention(pq, pk, pv, causal=causal).numpy(),
           jring.full_attention(jq, jk, jv, causal=causal), 2e-5)
    for block in (8, 16, 64):  # 16 leaves a ragged, padded last block
        _close(pring.blockwise_attention(pq, pk, pv, causal=causal, block_size=block).numpy(),
               jring.blockwise_attention(jq, jk, jv, causal=causal, block_size=block), 2e-5)


@pytest.mark.parametrize("impl", ["ring", "ulysses", "ulysses-flash"])
def test_sequence_parallel_impls_at_one_shard_match_jax(impl):
    q, k, v = _qkv((2, 4, 32, 16), seed=6)
    mesh = make_mesh(1, axes=(("sp", 1),))
    fn = jring.make_sequence_parallel_attention(mesh, "sp", causal=True, impl=impl)
    want = fn(*map(jnp.asarray, (q, k, v)))
    got = pring.ATTENTION_IMPLS[impl](*map(_t, (q, k, v)), axis_name="sp", axis_size=1,
                                      causal=True)
    _close(got.numpy(), want, 2e-5)


def test_sequence_axis_above_one_waits_for_the_multi_gpu_slice():
    """An sp axis above one runs over its process group
    (``tests/test_torch_lm_dist_attention.py``); without one it raises."""
    q = torch.zeros((1, 2, 8, 4))
    for impl in pring.ATTENTION_IMPLS.values():
        with pytest.raises(ValueError, match="needs its process group"):
            impl(q, q, q, axis_name="sp", axis_size=2)
    with pytest.raises(ValueError, match="blockwise\\|flash"):
        pring.ulysses_attention(q, q, q, axis_name="sp", axis_size=1, local_impl="nope")


def test_cpu_tensors_run_the_plain_twin_and_count_nothing():
    q, k, v = map(_t, _qkv((1, 2, 48, 32), seed=7))
    A.reset_launch_counts()
    got = A.flash_attention_forward(q, k, v, causal=True, block_q=16, block_k=16)
    assert A.launch_counts() == {"flash_attention": 0}
    torch.testing.assert_close(got, A.flash_attention_plain(q, k, v, causal=True,
                                                            block_q=16, block_k=16))
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        A.flash_attention_forward(q.to("meta"), k.to("meta"), v.to("meta"))
