"""Weights between the JAX package (Flax pytrees) and the port (state_dicts).

The port's models name their submodules as Flax names them (``Conv_0``,
``BatchNorm_1``, ``BasicBlock_3``...), so the Flax tree of a port model
follows from its module tree:

* ``nn.Conv2d``: ``kernel`` (HWIO there, OIHW here) and ``bias`` if any;
* ``nn.Linear``: ``kernel`` ((in, out) there, (out, in) here) and ``bias``;
* :class:`~atomo_tpu_torch.models.resnet.BatchNorm`: params ``scale`` and
  ``bias``, batch_stats ``mean`` and ``var``.

:func:`jax_view` / :func:`from_jax_view` are the one place that knows the
layout difference; the codecs read gradients through them too.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from atomo_tpu_torch.models.resnet import BatchNorm

Tree = dict[str, Any]


def jax_view(t: torch.Tensor) -> torch.Tensor:
    """The JAX package's layout of a port tensor: conv OIHW -> HWIO, linear
    (out, in) -> (in, out); vectors unchanged."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2:
        return t.t()
    return t


def from_jax_view(t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`jax_view`."""
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
    for collection, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, name in _flatten(_flax_tree(model, collection)):
            arr = torch.from_numpy(np.array(_get(tree, path), dtype=np.float32))
            sd[name] = from_jax_view(arr).contiguous()
    return sd


def jax_from_state_dict(
    model: nn.Module, state_dict: Optional[dict[str, torch.Tensor]] = None
) -> tuple[Tree, Tree]:
    """(params, batch_stats) as nested dicts of numpy arrays, the inverse of
    :func:`state_dict_from_jax`."""
    sd = model.state_dict() if state_dict is None else state_dict
    out = []
    for collection in ("params", "batch_stats"):
        tree: Tree = {}
        for path, name in _flatten(_flax_tree(model, collection)):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jax_view(sd[name].detach().cpu()).contiguous().numpy()
        out.append(tree)
    return out[0], out[1]
