"""Pipeline parallelism: the GPipe-staged LM over a pp axis, with the dp exchange.

Counterpart of ``atomo_tpu/parallel/pp.py:57-288``. The transformer blocks
are stacked on a leading depth axis (``blocks``: ln1 (depth, W), qkv (depth,
W, 3HD), proj, ln2, up, down) and sharded over pp, depth/n blocks a stage;
embeddings, the final LayerNorm and the head are replicated and used on the
head (stage 0) and the tail (stage n-1) stages.

The JAX step runs the GPipe schedule as one ``lax.scan`` of ``M + n - 1``
ticks: at tick t stage k works on microbatch ``t - k`` (the head embeds
microbatch t), and every stage hands its output to the next with one
``ppermute`` (``pipeline_perm``, i -> i+1); the loss is the tail's, taken
once after the scan on its M live ticks. On the ticks where ``t - k`` is no
microbatch a stage computes garbage that never reaches the loss, so its
gradient is zero; the port skips that work (the gradients are the same)
and keeps the ticks: each of the ``M + n - 1`` forward ticks ends in one
:func:`~atomo_tpu_torch.mesh.collectives.pipeline_hop` on every stage (a
stage with nothing sends zeros). Autograd stays inside a tick: the tail
takes the loss over its M outputs and backward from it, then the ticks run
in reverse, each stage's tick backward from the cotangent of its output,
the cotangent of its input sent one stage back
(:func:`~atomo_tpu_torch.mesh.collectives.pipeline_hop_back`, i -> i-1).

Gradients: no collective lies on the loss path but the hops, whose
backward is exact, so a stage's block slices come out exact, and a
replicated leaf has a nonzero gradient only on the stage that used it: one
sum over pp completes them (``complete_model_axis_grads``), and the
replica loss is the sum over pp of the tail's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from atomo_tpu_torch.mesh.collectives import pipeline_hop, pipeline_hop_back, psum
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


def init_pp_lm_params(seed: int, cfg: dict) -> dict:
    """The stacked-blocks tree (``init_pp_lm_params``'s shapes and scales;
    the draws from a ``torch.Generator`` seeded with ``seed``)."""
    gen = torch.Generator().manual_seed(int(seed))
    w, dep = cfg["width"], cfg["depth"]
    f = cfg.get("mlp_ratio", 4) * w
    hd = w // cfg["num_heads"] * cfg["num_heads"]

    def stacked(shape):
        return torch.stack([dense_init(gen, shape) for _ in range(dep)])

    return {
        "tok_emb": {"embedding": torch.randn(cfg["vocab_size"], w, generator=gen) / math.sqrt(w)},
        "pos_emb": {"embedding": torch.randn(cfg["max_len"], w, generator=gen) / math.sqrt(w)},
        "blocks": {
            "ln1": {"scale": torch.ones(dep, w)},
            "qkv": {"kernel": stacked((w, 3 * hd))},
            "proj": {"kernel": stacked((hd, w))},
            "ln2": {"scale": torch.ones(dep, w)},
            "up": {"kernel": stacked((w, f))},
            "down": {"kernel": stacked((f, w))},
        },
        "ln_f": {"scale": torch.ones(w)},
        "head": {"kernel": dense_init(gen, (w, cfg["vocab_size"]))},
    }


def pp_param_specs(params: dict, path: tuple = ()) -> dict:
    """Per leaf the dimension sharded over pp: 0 (depth) for the stacked
    blocks, None for the replicated embeddings, final LayerNorm and head."""
    return {k: pp_param_specs(v, path + (k,)) if isinstance(v, dict)
            else (0 if "blocks" in path else None)
            for k, v in params.items()}


def _one_block(bp: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """One pre-LN block on unstacked block params."""
    x = attention_sublayer(bp, x, num_heads)
    y = layernorm(x, bp["ln2"]["scale"])
    return x + F.gelu(y @ bp["up"]["kernel"], approximate="tanh") @ bp["down"]["kernel"]


def block_stack(stacked: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The (local) stack of blocks in depth order."""
    for i in range(stacked["ln1"]["scale"].shape[0]):
        x = _one_block(map_tree(lambda t: t[i], stacked), x, num_heads)
    return x


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return params["tok_emb"]["embedding"][tokens] + params["pos_emb"]["embedding"][pos][None]


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    return layernorm(x, params["ln_f"]["scale"]) @ params["head"]["kernel"]


def pp_lm_forward_reference(params: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The single-device oracle: the function the pipeline distributes."""
    return _head(params, block_stack(params["blocks"], _embed(params, tokens),
                                     cfg["num_heads"]))


def make_pp_lm_train_step(model: ParamTree, cfg: dict, optimizer, mesh, codec=None, *,
                          num_microbatches: int = 2, compute_dtype=None,
                          aggregate: str = "gather", exchange: DpExchange | None = None):
    """``step(state, key, tokens, draws=None) -> (state, metrics)`` of the
    dp x pp layout on this stage's slice ``model``; ``tokens`` is this
    replica's (B/dp, S) block, cut into ``num_microbatches``."""
    from atomo_tpu_torch.convert import jax_layouts, tree_leaves

    params = leaf_params(model)
    n_pp, group, stage = mesh.size("pp"), mesh.group("pp"), mesh.index("pp")
    head, tail = stage == 0, stage == n_pp - 1
    m = num_microbatches
    sharded = [s is not None for s in tree_leaves(pp_param_specs(model.tree()))]
    act_dtype = compute_dtype or torch.float32

    def grads_fn(state: TrainState, tokens: torch.Tensor, bs):
        b_local, s = tokens.shape
        if b_local % m:
            raise ValueError(f"per-replica batch {b_local} not divisible by "
                             f"num_microbatches={m}")
        mb = b_local // m
        width = cfg["width"]
        for p in params:
            p.grad = None
        with record_function("step.forward_backward"):
            tree = model.tree()
            if compute_dtype is not None:
                tree = map_tree(lambda t: t.to(compute_dtype), tree)
            ticks = []  # per tick: (input, output) of this stage's work, or None
            recv = None
            for t in range(m + n_pp - 1):
                i = t - stage
                if 0 <= i < m:
                    if head:
                        x = _embed(tree, tokens[i * mb:(i + 1) * mb])
                    else:
                        x = recv.detach().requires_grad_()
                    y = block_stack(tree["blocks"], x, cfg["num_heads"])
                    ticks.append((x, y))
                    send = y.detach()
                else:
                    ticks.append(None)
                    send = torch.zeros((mb, s, width), dtype=act_dtype, device=tokens.device)
                recv = pipeline_hop(send, group, n_pp)
            if tail:  # the loss over the M live ticks, backward to their outputs
                outs = [ticks[n_pp - 1 + i][1].detach().requires_grad_() for i in range(m)]
                logits = _head(tree, torch.cat(outs)).float()
                ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                     tokens[:, 1:].reshape(-1), reduction="none")
                loss = ce.sum() / (b_local * (s - 1))
                loss.backward(retain_graph=True)
                dys = {n_pp - 1 + i: o.grad for i, o in enumerate(outs)}
                loss = loss.detach()
            else:
                dys, loss = {}, torch.zeros((), device=tokens.device)
            # the ticks backward, in reverse: each stage's tick from its
            # output's cotangent, its input's cotangent one stage back
            for t in reversed(range(m + n_pp - 1)):
                work = ticks[t]
                gx = None
                if work is not None and t in dys:
                    x, y = work
                    y.backward(dys[t], retain_graph=True)
                    gx = None if head else x.grad
                if t > 0:
                    send = gx if gx is not None else torch.zeros(
                        (mb, s, width), dtype=act_dtype, device=tokens.device)
                    got = pipeline_hop_back(send, group, n_pp)
                    if not tail:
                        dys[t - 1] = got
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grads = complete_model_axis_grads(grads, sharded, group, n_pp)
        return grads, psum(loss, group, n_pp)

    return make_model_axis_step(params, optimizer, codec, grads_fn, mesh=mesh,
                                layouts=jax_layouts(model), aggregate=aggregate,
                                exchange=exchange, hookable=False)
