"""Exact attention: the online-softmax oracles and the sequence-parallel
strategies.

Counterpart of ``atomo_tpu/parallel/ring.py``. ``full_attention`` and
``blockwise_attention`` are the single-device oracles, written as there,
-inf guards and ``finfo.tiny`` floor included. ``ring_attention`` and
``ulysses_attention`` keep their signatures (``axis_name``, ``axis_size``)
and take the sp axis's process group as ``group``; this rank's place on the
axis is its rank in the group. Each takes this rank's (B, H, S/n, D) block
of a sequence sharded shard-major over the axis (rank r holds positions
[r*S/n, (r+1)*S/n)) and returns its output block:

* ring: K/V rotate over the axis (``parallel.common.ring_hop``), each block
  folded into an online softmax with the causal bias of its global
  positions; the JAX loop's last hop only returns each block to where it
  started, so the port makes n - 1;
* Ulysses: one all-to-all of the stacked q/k/v swaps the sequence sharding
  for a head sharding, the local attention (the blockwise oracle, or the
  flash kernel for ``ulysses-flash``) runs on whole sequences of H/n heads,
  and one all-to-all swaps back.

At an axis of size one both are their single-device forms, with no
collective. All functions take float32 or bfloat16, compute in float32 and
return the input type.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.distributed as dist

from atomo_tpu_torch.parallel.common import all_to_all, ring_hop

_F32_TINY = float(torch.finfo(torch.float32).tiny)
NEG_INF = float("-inf")


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale


def _axis_index(axis_name: str, axis_size: int, group) -> int:
    """This rank's index on the axis: its rank in the axis's group."""
    if axis_size == 1:
        return 0
    if group is None:
        raise ValueError(f"{axis_name!r} axis of size {axis_size} needs its process group")
    if dist.get_world_size(group) != axis_size:
        raise ValueError(f"{axis_name!r} axis of size {axis_size}, but its group has "
                         f"{dist.get_world_size(group)} ranks")
    return dist.get_rank(group)


def _online_softmax_block(q, k_blk, v_blk, bias, m_prev, l_prev, o_prev, scale):
    """One streaming-softmax update: fold a new K/V block into (m, l, o).

    q: (B, H, Sq, D); k_blk/v_blk: (B, H, Sk, D) float32; bias: (Sq, Sk)
    additive mask (-inf for masked); m/l: (B, H, Sq); o: (B, H, Sq, D)."""
    s = torch.matmul(q.float(), k_blk.transpose(-1, -2))
    s = s * scale + bias[None, None, :, :]
    m_cur = s.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    # guard -inf (fully masked rows) against NaN in exp(m_prev - m_new)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe), 0.0)
    l_new = l_prev * alpha + p.sum(dim=-1)
    o_new = o_prev * alpha[..., None] + torch.matmul(p, v_blk)
    return m_new, l_new, o_new


def full_attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None):
    """Single-device exact attention (B, H, S, D), materializing the scores."""
    scale = _scale(q, scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _finish(o, l, dtype):
    return (o / torch.clamp_min(l, _F32_TINY)[..., None]).to(dtype)


def _init_state(q):
    b, h, s, d = q.shape
    m0 = torch.full((b, h, s), NEG_INF, device=q.device)
    return m0, torch.zeros((b, h, s), device=q.device), torch.zeros((b, h, s, d), device=q.device)


def blockwise_attention(
    q, k, v, *, causal: bool = False, scale: Optional[float] = None,
    block_size: int = 512,
):
    """Single-device exact attention that never materializes the S x S
    scores: K/V blocks stream through the online-softmax update, keys past
    S (the padded last block) masked out."""
    s = q.shape[2]
    scale = _scale(q, scale)
    blk = min(block_size, s)
    n_blocks = -(-s // blk)
    pad = n_blocks * blk - s
    kf, vf = k.float(), v.float()
    if pad:  # pad keys with fully-masked positions
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    q_pos = torch.arange(s, device=q.device)
    m, l, o = _init_state(q)
    for t in range(n_blocks):
        k_pos = t * blk + torch.arange(blk, device=q.device)
        valid = (k_pos[None, :] < s).expand(s, blk)
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        bias = torch.where(valid, 0.0, NEG_INF)
        m, l, o = _online_softmax_block(
            q, kf[:, :, t * blk : (t + 1) * blk], vf[:, :, t * blk : (t + 1) * blk],
            bias, m, l, o, scale,
        )
    return _finish(o, l, q.dtype)


def ring_attention(
    q, k, v, *, axis_name: str, axis_size: int, causal: bool = False,
    scale: Optional[float] = None, group=None,
):
    """Exact attention over a sequence sharded on the axis: this rank's
    queries against every shard's K/V, which rotate n - 1 hops around the
    ring; after t hops this rank holds shard ``(my + t) % n``'s block, whose
    global key positions give the causal bias."""
    n = axis_size
    my = _axis_index(axis_name, n, group)
    s_local = q.shape[2]
    scale = _scale(q, scale)
    q_pos = my * s_local + torch.arange(s_local, device=q.device)
    kv = torch.stack([k.float(), v.float()]) if n > 1 else (k.float(), v.float())
    m, l, o = _init_state(q)
    for t in range(n):
        k_pos = ((my + t) % n) * s_local + torch.arange(s_local, device=q.device)
        if causal:
            bias = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0, NEG_INF)
        else:
            bias = torch.zeros((s_local, s_local), device=q.device)
        m, l, o = _online_softmax_block(q, kv[0], kv[1], bias, m, l, o, scale)
        if t < n - 1:
            kv = ring_hop(kv, group, n)
    return _finish(o, l, q.dtype)


def ulysses_attention(
    q, k, v, *, axis_name: str, axis_size: int, causal: bool = False,
    scale: Optional[float] = None, block_size: int = 512,
    local_impl: str = "blockwise", group=None,
):
    """All-to-all sequence parallelism: one all-to-all of the stacked
    (3, B, H, S/n, D) q/k/v gives this rank heads [r*H/n, (r+1)*H/n) of
    the whole sequence, the local attention runs on them, "blockwise" (the
    oracle) or "flash" (the CUDA kernel,
    :func:`atomo_tpu_torch.ops.attention_kernels.flash_attention`), and one
    all-to-all gives back this rank's (B, H, S/n, D) block. Needs H
    divisible by n."""
    if local_impl not in ("blockwise", "flash"):
        raise ValueError(f"unknown local_impl {local_impl!r}; expected blockwise|flash")
    b, h, s_local, d = q.shape
    n = axis_size
    if h % n != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the {axis_name!r} "
            f"axis ({n}); use ring_attention otherwise"
        )
    _axis_index(axis_name, n, group)
    hl = h // n
    if n > 1:
        # heads split into n chunks, chunk j to rank j; rows come back in
        # source order, i.e. the sequence's shard order
        qkv = torch.stack([q, k, v]).reshape(3, b, n, hl, s_local, d).permute(2, 0, 1, 3, 4, 5)
        qkv = all_to_all(qkv, group, n).permute(1, 2, 3, 0, 4, 5).reshape(3, b, hl, n * s_local, d)
        q, k, v = qkv[0], qkv[1], qkv[2]
    if local_impl == "flash":
        from atomo_tpu_torch.ops.attention_kernels import flash_attention

        out = flash_attention(q, k, v, causal=causal, scale=scale,
                              block_q=block_size, block_k=block_size)
    else:
        out = blockwise_attention(q, k, v, causal=causal, scale=scale, block_size=block_size)
    if n == 1:
        return out
    # (B, H/n, S, D): the sequence split into n chunks, chunk j to rank j;
    # rows come back in source order, i.e. the heads' order
    out = all_to_all(out.reshape(b, hl, n, s_local, d).permute(2, 0, 1, 3, 4), group, n)
    return out.permute(1, 0, 2, 3, 4).reshape(b, h, s_local, d)


ATTENTION_IMPLS = {
    "ring": ring_attention,
    "ulysses": ulysses_attention,
    # Ulysses with the flash kernel as its local attention: the kernel is
    # reached from training (make_lm_train_step / `lm --attn-impl ulysses-flash`)
    "ulysses-flash": partial(ulysses_attention, local_impl="flash"),
}
