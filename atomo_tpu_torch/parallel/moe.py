"""Expert parallelism: the switch-MoE LM over an ep axis, with the dp exchange.

Counterpart of ``atomo_tpu/parallel/moe.py:60-324``. Each block is the
stock pre-LN attention sublayer (the plain causal ``full_attention``) and a
switch MoE MLP: top-1 routing (``argmax`` takes the first maximum in both
packages), a per-(rank, expert) capacity ``C = ceil(1.25 * T_local / E)``,
slot positions from a cumsum in local token order, overflow tokens dropped
(their MLP output is zero; the residual carries them). The experts are
stacked on a leading E axis, (E, W, F) and (E, F, W), and sharded over ep
(E/n a rank); every rank routes its own tokens, which the batch spreads
over (dp, ep), dp-major. Two tiled all-to-alls a layer move the slot
buffer to the ranks that hold the experts and back
(:func:`~atomo_tpu_torch.mesh.collectives.all_to_all_tiled`).

The JAX package writes dispatch and combine as one-hot einsums; the port
scatters the kept tokens into their (expert, slot) rows and gathers them
back, which is the same function (each slot receives exactly one token, or
none) without the (T, E, C) tensor. The expert products are batched
matmuls (``torch.bmm``), as the JAX package computes them outside any
kernel.

Loss and gradients (``:262-284``): each ep rank's objective is
``(sum(ce) + aux_weight * aux * n_ce) / (n_ep * n_ce)``, so the ep ranks of
a replica sum to the replica's mean loss. The all-to-all's backward is the
inverse all-to-all, so an expert's gradient collects the cotangents of
every rank's tokens and is exact; a replicated leaf's gradient is this
rank's partial, which one sum over ep completes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from atomo_tpu_torch.mesh.collectives import all_to_all_tiled, psum
from atomo_tpu_torch.parallel.common import (
    ParamTree,
    attention_sublayer,
    complete_model_axis_grads,
    dense_init,
    layernorm,
    map_tree,
)
from atomo_tpu_torch.parallel.lm import DpExchange, make_model_axis_step
from atomo_tpu_torch.training.trainer import TrainState, leaf_params


def init_moe_lm_params(seed: int, cfg: dict) -> dict:
    """The MoE LM's tree (``init_moe_lm_params``'s shapes and scales; the
    draws from a ``torch.Generator`` seeded with ``seed``). ``cfg``:
    vocab_size, max_len, width, depth, num_heads, num_experts, mlp_ratio
    (default 4)."""
    gen = torch.Generator().manual_seed(int(seed))
    w, e = cfg["width"], cfg["num_experts"]
    f = cfg.get("mlp_ratio", 4) * w
    hd = w // cfg["num_heads"] * cfg["num_heads"]
    params = {
        "tok_emb": {"embedding": torch.randn(cfg["vocab_size"], w, generator=gen) / math.sqrt(w)},
        "pos_emb": {"embedding": torch.randn(cfg["max_len"], w, generator=gen) / math.sqrt(w)},
        "ln_f": {"scale": torch.ones(w)},
        "head": {"kernel": dense_init(gen, (w, cfg["vocab_size"]))},
    }
    for i in range(cfg["depth"]):
        params[f"block{i}"] = {
            "ln1": {"scale": torch.ones(w)},
            "qkv": {"kernel": dense_init(gen, (w, 3 * hd))},
            "proj": {"kernel": dense_init(gen, (hd, w))},
            "ln2": {"scale": torch.ones(w)},
            "router": {"kernel": dense_init(gen, (w, e))},
            "up": {"kernel": dense_init(gen, (e, w, f), in_axis=1)},
            "down": {"kernel": dense_init(gen, (e, f, w), in_axis=1)},
        }
    return params


def moe_param_specs(params: dict, path: tuple = ()) -> dict:
    """Per leaf the dimension sharded over ep: 0 for the expert stacks
    ``up`` and ``down``, None (replicated) for the rest, the router
    included (every rank routes its own tokens)."""
    return {k: moe_param_specs(v, path + (k,)) if isinstance(v, dict)
            else (0 if {"up", "down"} & set(path) else None)
            for k, v in params.items()}


def expert_capacity(t_local: int, num_experts: int, capacity_factor: float = 1.25) -> int:
    """The per-(rank, expert) slot budget ``ceil(factor * T_local / E)``."""
    return max(1, math.ceil(capacity_factor * t_local / num_experts))


def moe_mlp(moe_params: dict, x: torch.Tensor, *, capacity: int, group=None,
            n_ep: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Switch top-1 MoE MLP on local tokens x (T, W) -> (out (T, W), aux).

    ``moe_params``: router (W, E) and the expert stacks up (E/n, W, F),
    down (E/n, F, W) of this rank (all E at ``n_ep = 1``). Of this rank's T
    tokens the first ``capacity`` routed to an expert are processed, the
    rest dropped. ``aux`` is the switch load-balancing loss ``E * sum_e
    f_e * p_e`` over the local tokens."""
    t, w = x.shape
    logits = x @ moe_params["router"]["kernel"]  # (T, E)
    n_experts = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)  # the first maximum
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, n_experts).float()
    # each token's position in its expert's local slot queue
    pos = ((onehot.cumsum(dim=0) - 1.0) * onehot).sum(dim=1).long()
    keep = pos < capacity
    slot = (expert * capacity + pos)[keep]
    inputs = x.new_zeros(n_experts * capacity, w).index_copy(0, slot, x[keep])
    inputs = inputs.view(n_experts, capacity, w)
    # dispatch: this rank keeps E/n experts and takes their slot blocks from
    # every rank -> (E/n, n*C, W)
    inputs = all_to_all_tiled(inputs, group, n_ep, split_axis=0, concat_axis=1)
    h = F.gelu(torch.bmm(inputs, moe_params["up"]["kernel"]), approximate="tanh")
    y = torch.bmm(h, moe_params["down"]["kernel"])
    # return: the slots travel back to the ranks that own the tokens
    y = all_to_all_tiled(y, group, n_ep, split_axis=1, concat_axis=0)
    picked = y.reshape(n_experts * capacity, w)[slot] * gate[keep][:, None].to(x.dtype)
    out = x.new_zeros(t, w).index_copy(0, keep.nonzero()[:, 0], picked)
    f_e = onehot.mean(dim=0)
    p_e = probs.mean(dim=0)
    return out, n_experts * (f_e * p_e).sum()


def moe_lm_forward(params: dict, tokens: torch.Tensor, cfg: dict, *, capacity: int, group=None,
                   n_ep: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> (logits (B, S, V), the mean aux loss over layers).
    Attention is local (whole sequences on each rank); only the MoE MLP
    crosses ranks. With ``n_ep = 1`` and every expert this is the
    single-device oracle."""
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)
    x = params["tok_emb"]["embedding"][tokens] + params["pos_emb"]["embedding"][pos][None]
    aux_total = 0.0
    for i in range(cfg["depth"]):
        p = params[f"block{i}"]
        x = attention_sublayer(p, x, cfg["num_heads"])
        y = layernorm(x, p["ln2"]["scale"])
        out, aux = moe_mlp(p, y.reshape(b * s, -1), capacity=capacity, group=group, n_ep=n_ep)
        aux_total = aux_total + aux
        x = x + out.reshape(b, s, -1)
    x = layernorm(x, params["ln_f"]["scale"])
    return x @ params["head"]["kernel"], aux_total / cfg["depth"]


def make_moe_lm_train_step(model: ParamTree, cfg: dict, optimizer, mesh, codec=None, *,
                           capacity_factor: float = 1.25, aux_weight: float = 0.01,
                           compute_dtype=None, aggregate: str = "gather",
                           exchange: DpExchange | None = None):
    """``step(state, key, tokens, draws=None) -> (state, metrics)`` of the
    dp x ep layout on this rank's slice ``model``; ``tokens`` is this
    rank's (B/(dp*ep), S) block (:func:`shard_moe_tokens`)."""
    from atomo_tpu_torch.convert import jax_layouts, tree_leaves

    params = leaf_params(model)
    n_ep, group = mesh.size("ep"), mesh.group("ep")
    sharded = [s is not None for s in tree_leaves(moe_param_specs(model.tree()))]

    def grads_fn(state: TrainState, tokens: torch.Tensor, bs):
        b_local, s = tokens.shape
        cap = expert_capacity(b_local * s, cfg["num_experts"], capacity_factor)
        for p in params:
            p.grad = None
        with record_function("step.forward_backward"):
            if bs is not None:
                bs.arm(params)
            tree = model.tree()
            if compute_dtype is not None:
                tree = map_tree(lambda t: t.to(compute_dtype), tree)
            logits, aux = moe_lm_forward(tree, tokens, cfg, capacity=cap, group=group,
                                         n_ep=n_ep)
            logits = logits.float()
            ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                 tokens[:, 1:].reshape(-1), reduction="none")
            loss = (ce.sum() + aux_weight * aux * ce.numel()) / (n_ep * ce.numel())
            loss.backward()
        grads = complete_model_axis_grads([p.grad for p in params], sharded, group, n_ep)
        return grads, psum(loss.detach(), group, n_ep)

    return make_model_axis_step(params, optimizer, codec, grads_fn, mesh=mesh,
                                layouts=jax_layouts(model), aggregate=aggregate,
                                exchange=exchange, hookable=n_ep == 1)


def shard_moe_tokens(tokens, mesh):
    """This rank's rows of a global (B, S) batch sharded over (dp, ep),
    dp-major: row block ``rank_dp * n_ep + rank_ep`` of ``dp * ep``."""
    n = mesh.n_dp * mesh.size("ep")
    i = mesh.rank_dp * mesh.size("ep") + mesh.index("ep")
    b = tokens.shape[0]
    if b % n:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split over {n} ranks")
    return tokens[i * b // n:(i + 1) * b // n]
