"""Weights between the JAX package (Flax pytrees) and the port (state_dicts).

The port's models name their submodules as Flax names them (``Conv_0``,
``BatchNorm_1``, ``BasicBlock_3``...), so the Flax tree of a port model
follows from its module tree:

* ``nn.Conv2d``: ``kernel`` (HWIO there, OIHW here) and ``bias`` if any;
* ``nn.Linear``: ``kernel`` ((in, out) there, (out, in) here) and ``bias``;
* :class:`~atomo_tpu_torch.models.resnet.BatchNorm`: params ``scale`` and
  ``bias``, batch_stats ``mean`` and ``var``;
* :class:`~atomo_tpu_torch.models.transformer.LayerNorm`: ``scale``;
* ``nn.Embedding``: ``embedding``, (num, features) on both sides.

:func:`jax_view` / :func:`from_jax_view` are the one place that knows the
layout difference; the codecs read gradients through them too. An embedding
table lies alike in both packages, so its leaf is never transposed:
:func:`jax_layouts` says, leaf by leaf, which tensors take the view.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from atomo_tpu_torch.models.resnet import BatchNorm
from atomo_tpu_torch.models.transformer import LayerNorm

Tree = dict[str, Any]


def jax_view(t: torch.Tensor, transpose: bool = True) -> torch.Tensor:
    """The JAX package's layout of a port tensor: conv OIHW -> HWIO, linear
    (out, in) -> (in, out); vectors, and any tensor with ``transpose``
    False (an embedding table), unchanged."""
    if not transpose:
        return t
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2:
        return t.t()
    return t


def from_jax_view(t: torch.Tensor, transpose: bool = True) -> torch.Tensor:
    """Inverse of :func:`jax_view`."""
    if not transpose:
        return t
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    if t.dim() == 2:
        return t.t()
    return t


def _flax_tree(module: nn.Module, collection: str, prefix: str = "") -> Tree:
    """Nested dict of the Flax collection ("params" or "batch_stats"), with
    the port's state_dict key at each leaf."""
    tree: Tree = {}
    for name, child in module.named_children():
        key = f"{prefix}{name}."
        if isinstance(child, BatchNorm):
            leaves = (
                {"scale": "weight", "bias": "bias"} if collection == "params"
                else {"mean": "running_mean", "var": "running_var"}
            )
        elif isinstance(child, LayerNorm):
            if collection != "params":
                continue
            leaves = {"scale": "weight"}
        elif isinstance(child, nn.Embedding):
            if collection != "params":
                continue
            leaves = {"embedding": "weight"}
        elif isinstance(child, (nn.Conv2d, nn.Linear)):
            if collection != "params":
                continue
            leaves = {"kernel": "weight"}
            if child.bias is not None:
                leaves["bias"] = "bias"
        else:
            sub = _flax_tree(child, collection, key)
            if sub:
                tree[name] = sub
            continue
        tree[name] = {k: key + v for k, v in leaves.items()}
    return tree


def _flatten(tree: Tree, path: tuple = ()) -> list[tuple[tuple, str]]:
    """(path, state_dict key) pairs in ``jax.tree_util.tree_flatten`` order:
    dict keys sorted as strings at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_flatten(v, path + (k,)))
        else:
            out.append((path + (k,), v))
    return out


def jax_leaf_order(model: nn.Module) -> list[str]:
    """The model's parameter names in the order ``jax.tree_util.tree_flatten``
    gives the Flax params dict: the canonical leaf order of the codecs' wire
    contract (leaf ``i`` encodes under ``fold_in(key, i)``)."""
    return [name for _, name in _flatten(_flax_tree(model, "params"))]


def jax_layouts(model: nn.Module) -> list[bool]:
    """Per leaf, in :func:`jax_leaf_order`, whether :func:`jax_view`
    transposes it: False for embedding tables, True otherwise."""
    return [name not in _untransposed(model) for name in jax_leaf_order(model)]


def _untransposed(model: nn.Module) -> set[str]:
    """state_dict keys of the tensors that lie alike in both packages."""
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, nn.Embedding)}


def _get(tree: Tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def state_dict_from_jax(
    model: nn.Module, params: Tree, batch_stats: Optional[Tree] = None
) -> dict[str, torch.Tensor]:
    """The port's state_dict from the JAX package's ``params`` and
    ``batch_stats`` (nested dicts of arrays)."""
    sd: dict[str, torch.Tensor] = {}
    keep = _untransposed(model)
    for collection, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, name in _flatten(_flax_tree(model, collection)):
            arr = torch.from_numpy(np.array(_get(tree, path), dtype=np.float32))
            sd[name] = from_jax_view(arr, name not in keep).contiguous()
    return sd


def jax_from_state_dict(
    model: nn.Module, state_dict: Optional[dict[str, torch.Tensor]] = None
) -> tuple[Tree, Tree]:
    """(params, batch_stats) as nested dicts of numpy arrays, the inverse of
    :func:`state_dict_from_jax`."""
    sd = model.state_dict() if state_dict is None else state_dict
    keep = _untransposed(model)
    out = []
    for collection in ("params", "batch_stats"):
        tree: Tree = {}
        for path, name in _flatten(_flax_tree(model, collection)):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            view = jax_view(sd[name].detach().cpu(), name not in keep)
            node[path[-1]] = view.contiguous().numpy()
        out.append(tree)
    return out[0], out[1]
