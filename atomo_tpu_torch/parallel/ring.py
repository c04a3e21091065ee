"""Exact attention: the online-softmax oracles and the sequence-parallel
strategies at a sequence axis of size one.

Counterpart of ``atomo_tpu/parallel/ring.py``. ``full_attention`` and
``blockwise_attention`` are the single-device oracles, written as there,
-inf guards and ``finfo.tiny`` floor included. ``ring_attention`` and
``ulysses_attention`` keep their signatures (``axis_name``, ``axis_size``),
but run on one device only: at an axis of size one the ring is a single
online-softmax pass over the whole sequence with the causal bias, and the
Ulysses all-to-all is the identity around its local attention (the blockwise
oracle, or the flash kernel for ``ulysses-flash``). A larger axis raises:
the NCCL collectives come with the multi-GPU slice.

All functions take (B, H, S, D) in float32 or bfloat16, compute in float32
and return the input type.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

_F32_TINY = float(torch.finfo(torch.float32).tiny)
NEG_INF = float("-inf")


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale


def _single_device(axis_name: str, axis_size: int) -> None:
    if axis_size != 1:
        raise ValueError(
            f"{axis_name!r} axis of size {axis_size}: sequence parallelism "
            "comes with the multi-GPU slice"
        )


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
    scale: Optional[float] = None,
):
    """Ring attention over a sequence axis of size one: one online-softmax
    pass over the whole local sequence with the causal bias."""
    _single_device(axis_name, axis_size)
    s = q.shape[2]
    scale = _scale(q, scale)
    pos = torch.arange(s, device=q.device)
    if causal:
        bias = torch.where(pos[:, None] >= pos[None, :], 0.0, NEG_INF)
    else:
        bias = torch.zeros((s, s), device=q.device)
    m, l, o = _online_softmax_block(q, k.float(), v.float(), bias, *_init_state(q), scale)
    return _finish(o, l, q.dtype)


def ulysses_attention(
    q, k, v, *, axis_name: str, axis_size: int, causal: bool = False,
    scale: Optional[float] = None, block_size: int = 512,
    local_impl: str = "blockwise",
):
    """Ulysses attention over a sequence axis of size one: the all-to-all
    pair is the identity, leaving the local attention on whole sequences,
    "blockwise" (the oracle) or "flash" (the CUDA kernel,
    :func:`atomo_tpu_torch.ops.attention_kernels.flash_attention`)."""
    if local_impl not in ("blockwise", "flash"):
        raise ValueError(f"unknown local_impl {local_impl!r}; expected blockwise|flash")
    h = q.shape[1]
    if h % axis_size != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the {axis_name!r} "
            f"axis ({axis_size}); use ring_attention otherwise"
        )
    _single_device(axis_name, axis_size)
    if local_impl == "flash":
        from atomo_tpu_torch.ops.attention_kernels import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=block_size, block_k=block_size)
    return blockwise_attention(q, k, v, causal=causal, scale=scale, block_size=block_size)


ATTENTION_IMPLS = {
    "ring": ring_attention,
    "ulysses": ulysses_attention,
    # Ulysses with the flash kernel as its local attention: the kernel is
    # reached from training (make_lm_train_step / `lm --attn-impl ulysses-flash`)
    "ulysses-flash": partial(ulysses_attention, local_impl="flash"),
}
