"""Tensor parallelism: the Megatron-sharded LM with the compressed dp exchange.

Counterpart of ``atomo_tpu/parallel/tp.py:69-450``. The parameter tree is
the stock LM tree re-laid so that every sharded product is a clean slice
(:func:`lm_params_to_tp`, pure reshapes): the qkv kernel (W, 3HD) becomes
(W, 3, H, D), sharded on H; the output projection (HD, W) becomes (H, D,
W), sharded on H; the MLP's up kernel is sharded on its hidden columns,
down on its hidden rows, the head on the vocabulary; embeddings and
LayerNorm scales are replicated (:func:`tp_param_specs`). The port holds
each rank's slice in a :class:`~atomo_tpu_torch.parallel.common.ParamTree`
(the JAX layout, so the codecs read the leaves as the JAX package encodes
its shards).

Each block crosses two parallel regions (attention over the local heads,
the MLP over the local hidden width), each entered through Megatron's
:func:`~atomo_tpu_torch.mesh.collectives.copy_to` and left through
:func:`~atomo_tpu_torch.mesh.collectives.reduce_from`; the head is
vocab-sharded and the loss (:func:`tp_sharded_ce_terms`) never builds the
full logits: the max over tp (``pmax``, no gradient), the partition
function and the target logit each cross tp in one all-reduce. Every tp
rank computes the same loss and backward from it; the pair's backward
all-reduces make each rank's gradient the true one for its slice and for
the replicated leaves alike, so, unlike the JAX step (whose transpose of
``psum`` scales every shard's gradient by n_tp and divides it back), no
completion follows and nothing is divided. The two agree to float32
rounding.

``dp-tp-sp`` (:func:`make_tp_sp_lm_train_step`) adds a sequence axis: the
local heads attend with ``parallel.ring``'s ring or Ulysses attention over the sp
group (``ulysses-flash``: the flash kernel on the local head slice), the
loss is the exact global next-token loss over the sp shards, and the sp sum
of every rank's gradient completes it, as in the dp x sp step.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from atomo_tpu_torch.mesh.collectives import copy_to, pmax, psum, reduce_from
from atomo_tpu_torch.parallel.common import ParamTree, layernorm, map_tree
from atomo_tpu_torch.parallel.lm import (
    DpExchange,
    make_model_axis_step,
    sp_boundary_targets_and_mask,
)
from atomo_tpu_torch.parallel.replicated import _flat, _views_like
from atomo_tpu_torch.parallel.ring import ATTENTION_IMPLS, full_attention
from atomo_tpu_torch.training.trainer import TrainState, leaf_params


def _blocks(params) -> list[str]:
    return sorted((k for k in params if k.startswith("block")),
                  key=lambda k: int(k.removeprefix("block")))


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def lm_params_to_tp(params: dict, num_heads: int) -> dict:
    """Re-lay a stock LM tree (numpy or torch leaves) for head slicing:
    qkv (W, 3HD) -> (W, 3, H, D), proj (HD, W) -> (H, D, W). Inverse:
    :func:`tp_params_to_lm`."""
    out = _copy(params)
    for blk in _blocks(out):
        attn = out[blk]["MultiHeadAttention_0"]
        qkv = attn["qkv"]["kernel"]
        w = qkv.shape[0]
        d = qkv.shape[1] // (3 * num_heads)
        attn["qkv"]["kernel"] = qkv.reshape(w, 3, num_heads, d)
        proj = attn["proj"]["kernel"]
        attn["proj"]["kernel"] = proj.reshape(num_heads, d, proj.shape[1])
    return out


def tp_params_to_lm(params: dict, num_heads: int) -> dict:
    out = _copy(params)
    for blk in _blocks(out):
        attn = out[blk]["MultiHeadAttention_0"]
        w, _, h, d = attn["qkv"]["kernel"].shape
        attn["qkv"]["kernel"] = attn["qkv"]["kernel"].reshape(w, 3 * h * d)
        proj = attn["proj"]["kernel"]
        attn["proj"]["kernel"] = proj.reshape(h * d, proj.shape[2])
    return out


def tp_param_specs(tp_params: dict, path: tuple = ()) -> dict:
    """Per leaf the dimension sharded over tp, or None (replicated): qkv on
    heads (2), proj on heads (0), up on hidden (1), down on hidden (0),
    head on vocab (1); ``tp.py tp_param_specs``."""
    out = {}
    for k, v in tp_params.items():
        names = path + (k,)
        if isinstance(v, dict):
            out[k] = tp_param_specs(v, names)
        elif "MultiHeadAttention_0" in names and "qkv" in names:
            out[k] = 2
        elif "MultiHeadAttention_0" in names and "proj" in names:
            out[k] = 0
        elif "up" in names or "head" in names:
            out[k] = 1
        elif "down" in names:
            out[k] = 0
        else:
            out[k] = None
    return out


def check_tp_sizes(lm_config: dict, n_tp: int) -> None:
    """The JAX package's sizing errors (``create_tp_lm_state``)."""
    if lm_config["num_heads"] % n_tp:
        raise ValueError(f"num_heads {lm_config['num_heads']} not divisible by tp={n_tp}")
    if lm_config["vocab_size"] % n_tp:
        raise ValueError(f"vocab_size {lm_config['vocab_size']} not divisible by tp={n_tp}")
    if 4 * lm_config["width"] % n_tp:  # Block hardcodes mlp_ratio=4
        raise ValueError("MLP hidden width not divisible by tp")


def tp_lm_forward(params: dict, tokens: torch.Tensor, *, pos_offset: int = 0, group=None,
                  n_tp: int = 1, attention_fn=None) -> torch.Tensor:
    """This rank's forward on a tp-laid (and head/hidden/vocab-sliced) tree
    dict: (B, S) tokens -> the local vocab slice of the logits (B, S,
    V/n_tp). With ``n_tp = 1`` and the whole tree it equals the stock LM on
    the equivalent stock tree. ``attention_fn(q, k, v)`` on the local heads
    (B, H/n_tp, S, D) replaces the causal full attention (dp-tp-sp's ring
    or Ulysses)."""
    s = tokens.shape[1]
    attn = attention_fn or (lambda q, k, v: full_attention(q, k, v, causal=True))
    pos = torch.arange(pos_offset, pos_offset + s, device=tokens.device)
    x = params["tok_emb"]["embedding"][tokens] + params["pos_emb"]["embedding"][pos][None]
    for blk in _blocks(params):
        p = params[blk]
        y = copy_to(layernorm(x, p["ln1"]["scale"]), group, n_tp)
        qkv = torch.einsum("bsw,wthd->tbhsd", y, p["MultiHeadAttention_0"]["qkv"]["kernel"])
        out = attn(qkv[0], qkv[1], qkv[2])
        x = x + reduce_from(torch.einsum("bhsd,hdw->bsw", out,
                                         p["MultiHeadAttention_0"]["proj"]["kernel"]),
                            group, n_tp)
        y = copy_to(layernorm(x, p["ln2"]["scale"]), group, n_tp)
        h = F.gelu(y @ p["up"]["kernel"], approximate="tanh")
        x = x + reduce_from(h @ p["down"]["kernel"], group, n_tp)
    x = copy_to(layernorm(x, params["ln_f"]["scale"]), group, n_tp)
    return x @ params["head"]["kernel"]


def tp_sharded_ce_terms(logits_local: torch.Tensor, targets: torch.Tensor, *, group=None,
                        n_tp: int = 1, rank: int = 0) -> torch.Tensor:
    """Per-position next-token cross-entropy (B, S) over vocab-sharded
    logits (B, S, V/n_tp): ``logsumexp`` from the tp max and the tp sum of
    the local partition functions, minus the target logit from the rank
    whose slice holds it; ``targets`` are global ids."""
    v_local = logits_local.shape[-1]
    m = pmax(logits_local.max(dim=-1).values, group, n_tp)
    z = reduce_from(torch.exp(logits_local - m[..., None]).sum(dim=-1), group, n_tp)
    lse = torch.log(z) + m
    t_local = targets - rank * v_local
    in_range = (t_local >= 0) & (t_local < v_local)
    picked = logits_local.gather(-1, t_local.clamp(0, v_local - 1)[..., None])[..., 0]
    correct = reduce_from(torch.where(in_range, picked, torch.zeros_like(picked)), group, n_tp)
    return lse - correct


def _cast(tree: dict, dtype) -> dict:
    return tree if dtype is None else map_tree(lambda t: t.to(dtype), tree)


def _tp_grads_fn(model: ParamTree, mesh, compute_dtype, sp_attention=None):
    """grads_fn of the dp-tp (``sp_attention`` None) and dp-tp-sp steps."""
    params = leaf_params(model)
    n_tp, tp_group, rank_tp = mesh.size("tp"), mesh.group("tp"), mesh.index("tp")
    n_sp, sp_group, rank_sp = mesh.size("sp"), mesh.group("sp"), mesh.index("sp")

    def grads_fn(state: TrainState, tokens: torch.Tensor, bs):
        for p in params:
            p.grad = None
        with record_function("step.forward_backward"):
            if bs is not None:
                bs.arm(params)
            tree = _cast(model.tree(), compute_dtype)
            if sp_attention is None:
                logits = tp_lm_forward(tree, tokens, group=tp_group, n_tp=n_tp).float()
                ce = tp_sharded_ce_terms(logits[:, :-1], tokens[:, 1:], group=tp_group,
                                         n_tp=n_tp, rank=rank_tp)
                loss = ce.mean()
                loss.backward()
                return [p.grad for p in params], loss.detach()
            logits = tp_lm_forward(tree, tokens, pos_offset=rank_sp * tokens.shape[1],
                                   group=tp_group, n_tp=n_tp,
                                   attention_fn=sp_attention).float()
            targets, valid = sp_boundary_targets_and_mask(tokens, n_sp, sp_group)
            ce = tp_sharded_ce_terms(logits, targets, group=tp_group, n_tp=n_tp, rank=rank_tp)
            total = psum(valid.sum(), sp_group, n_sp)
            num = (ce * valid).sum()
            (num / total).backward()
        grads = [p.grad for p in params]
        if n_sp > 1:
            # each rank's backward started from its own term of the global
            # loss: the sp sum completes the gradient (and the loss)
            with record_function("step.sp_reduce"):
                flat = psum(torch.cat([_flat(grads), num.detach().reshape(1)]), sp_group, n_sp)
                grads = _views_like(flat[:-1], grads)
                num = flat[-1]
        return grads, num.detach() / total

    return params, grads_fn


def make_tp_lm_train_step(model: ParamTree, optimizer, mesh, codec=None, *,
                          compute_dtype=None, aggregate: str = "gather",
                          exchange: DpExchange | None = None):
    """``step(state, key, tokens, draws=None) -> (state, metrics)`` of the
    dp x tp layout on this rank's slice ``model``; ``tokens`` is this
    rank's (B/dp, S) block (replicated over tp)."""
    from atomo_tpu_torch.convert import jax_layouts

    params, grads_fn = _tp_grads_fn(model, mesh, compute_dtype)
    return make_model_axis_step(params, optimizer, codec, grads_fn, mesh=mesh,
                                layouts=jax_layouts(model), aggregate=aggregate,
                                exchange=exchange, hookable=mesh.size("tp") == 1)


def make_tp_sp_lm_train_step(model: ParamTree, optimizer, mesh, codec=None, *,
                             attn_impl: str = "ring", compute_dtype=None,
                             aggregate: str = "gather", exchange: DpExchange | None = None):
    """The dp x tp x sp step: heads, hidden and vocabulary over tp, the
    sequence over sp (``attn_impl`` ring | ulysses | ulysses-flash on the
    local heads); ``tokens`` is this rank's (B/dp, S/sp) block."""
    from atomo_tpu_torch.convert import jax_layouts

    if attn_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attn_impl {attn_impl!r}; expected one of {sorted(ATTENTION_IMPLS)}")
    attention = partial(ATTENTION_IMPLS[attn_impl], axis_name="sp", axis_size=mesh.size("sp"),
                        causal=True, group=mesh.group("sp"))
    params, grads_fn = _tp_grads_fn(model, mesh, compute_dtype, sp_attention=attention)
    return make_model_axis_step(params, optimizer, codec, grads_fn, mesh=mesh,
                                layouts=jax_layouts(model), aggregate=aggregate,
                                exchange=exchange,
                                hookable=mesh.size("tp") == 1 and mesh.size("sp") == 1)
