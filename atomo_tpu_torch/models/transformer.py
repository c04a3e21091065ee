"""Decoder-only transformer LM, with the Flax module's names and arithmetic.

Counterpart of ``atomo_tpu/models/transformer.py``: pre-LN blocks, bias-free
linears, a GELU MLP at 4x width, learned positional embeddings. Submodules
carry the Flax names (``tok_emb``, ``pos_emb``, ``block{i}``,
``MultiHeadAttention_0``, ``qkv``, ``proj``, ``ln1``, ``ln2``, ``up``,
``down``, ``ln_f``, ``head``), so the canonical leaf order and the weight
conversion follow from them (:mod:`atomo_tpu_torch.convert`).

Flax details kept: ``nn.LayerNorm(use_bias=False)`` (epsilon 1e-6, the
one-pass variance ``mean(x^2) - mean(x)^2``, see :class:`LayerNorm`);
``nn.gelu`` is the tanh approximation; ``pos_offset`` shifts the positions
embedded. ``attention_fn(q, k, v)`` on (B, H, S, D) is injectable, at
construction as in Flax or per call; the default is causal
:func:`~atomo_tpu_torch.parallel.ring.full_attention`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from atomo_tpu_torch.parallel.ring import full_attention

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _default_attention(q, k, v):
    return full_attention(q, k, v, causal=True)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(use_bias=False)`` over the last axis, its
    arithmetic written out: ``var = max(mean(x^2) - mean(x)^2, 0)``, then
    ``(x - mean) * (rsqrt(var + 1e-6) * scale)``. ``weight`` is Flax's
    ``scale``. (``torch.nn.LayerNorm`` takes a two-pass variance.)"""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight)


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, num_heads: int, head_dim: int,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.attention_fn = attention_fn
        self.qkv = nn.Linear(width, 3 * num_heads * head_dim, bias=False)
        self.proj = nn.Linear(num_heads * head_dim, width, bias=False)

    def forward(self, x: torch.Tensor, attention_fn: Optional[AttentionFn] = None):
        b, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).chunk(3, dim=-1)

        def heads(t):  # (B, S, H*D) -> (B, H, S, D), a view
            return t.reshape(b, s, h, d).transpose(1, 2)

        fn = attention_fn or self.attention_fn or _default_attention
        out = fn(heads(q), heads(k), heads(v))  # (B, H, S, D)
        return self.proj(out.transpose(1, 2).reshape(b, s, h * d))


class Block(nn.Module):
    def __init__(self, width: int, num_heads: int, head_dim: int, mlp_ratio: int = 4,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        self.ln1 = LayerNorm(width)
        self.MultiHeadAttention_0 = MultiHeadAttention(width, num_heads, head_dim, attention_fn)
        self.ln2 = LayerNorm(width)
        self.up = nn.Linear(width, mlp_ratio * width, bias=False)
        self.down = nn.Linear(mlp_ratio * width, width, bias=False)

    def forward(self, x: torch.Tensor, attention_fn: Optional[AttentionFn] = None):
        x = x + self.MultiHeadAttention_0(self.ln1(x), attention_fn)
        y = F.gelu(self.up(self.ln2(x)), approximate="tanh")
        return x + self.down(y)


class TransformerLM(nn.Module):
    """Causal LM: int64 tokens (B, S) -> logits (B, S, vocab). The Flax
    model's ``dropout`` is not ported (its default is 0)."""

    def __init__(self, vocab_size: int = 256, max_len: int = 1024, width: int = 256,
                 depth: int = 4, num_heads: int = 4,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        head_dim = width // num_heads
        self.tok_emb = nn.Embedding(vocab_size, width)
        self.pos_emb = nn.Embedding(max_len, width)
        for i in range(depth):
            self.add_module(f"block{i}", Block(width, num_heads, head_dim,
                                               attention_fn=attention_fn))
        self.depth = depth
        self.ln_f = LayerNorm(width)
        self.head = nn.Linear(width, vocab_size, bias=False)

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0,
                attention_fn: Optional[AttentionFn] = None) -> torch.Tensor:
        """``pos_offset`` is the global position of tokens[:, 0]."""
        s = tokens.shape[1]
        pos = torch.arange(pos_offset, pos_offset + s, device=tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb(pos)[None, :, :]
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, attention_fn)
        return self.head(self.ln_f(x))


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy: predict tokens[:, 1:] from logits[:, :-1]."""
    return F.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1)
    )
