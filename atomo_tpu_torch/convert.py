"""Weights between the JAX package (Flax pytrees) and the port (state_dicts).

The port's models name their submodules as Flax names them (``Conv_0``,
``BatchNorm_1``, ``BasicBlock_3``...), so the Flax tree of a port model
follows from its module tree:

* ``nn.Conv2d``: ``kernel`` (HWIO there, OIHW here) and ``bias`` if any;
* ``nn.Linear``: ``kernel`` ((in, out) there, (out, in) here) and ``bias``;
* :class:`~atomo_tpu_torch.models.resnet.BatchNorm`: params ``scale`` and
  ``bias``, batch_stats ``mean`` and ``var``;
* :class:`~atomo_tpu_torch.models.transformer.LayerNorm`: ``scale``;
* ``nn.Embedding``: ``embedding``, (num, features) on both sides;
* a parameter held on a module itself (``self.param`` in Flax, as the
  embedding tower's ``table``): its attribute name, laid out alike. The LM
  layouts' family trees (the tp-laid, MoE and pp-stacked trees) are held
  so (``parallel.common.ParamTree``), so they ARE the JAX layout:
  :func:`family_slice` cuts a full JAX tree (numpy) to one rank's slice of
  the port's state, and :func:`to_numpy_tree` gives it back.

:func:`opt_state_from_jax` / :func:`jax_opt_state` carry the optimizer
state (optax's momentum trace, Adam's count and moments) both ways, in the
same leaf order and layout. :func:`jax_view` / :func:`from_jax_view` are the
one place that knows the layout difference; the codecs read gradients
through them too. An embedding table lies alike in both packages, so its
leaf is never transposed: :func:`jax_layouts` says, leaf by leaf, which
tensors take the view.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch
from torch import nn

from atomo_tpu_torch.models.resnet import BatchNorm
from atomo_tpu_torch.models.transformer import LayerNorm

if TYPE_CHECKING:
    from atomo_tpu_torch.training.optim import OptState

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
    if collection == "params":
        for name, _ in module.named_parameters(recurse=False):
            tree[name] = prefix + name
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


def jax_leaf_paths(model: nn.Module) -> list[str]:
    """The leaves' paths in :func:`jax_leaf_order`, spelled as
    ``jax.tree_util.keystr`` spells them for the Flax params dict
    (``"['Dense_0']['kernel']"``, ``"['table']"``): the names the JAX
    package's per-leaf plans print."""
    return ["".join(f"[{k!r}]" for k in path)
            for path, _ in _flatten(_flax_tree(model, "params"))]


def jax_layouts(model: nn.Module) -> list[bool]:
    """Per leaf, in :func:`jax_leaf_order`, whether :func:`jax_view`
    transposes it: False for embedding tables, True otherwise."""
    return [name not in _untransposed(model) for name in jax_leaf_order(model)]


def _untransposed(model: nn.Module) -> set[str]:
    """state_dict keys of the tensors that lie alike in both packages:
    embedding tables, and parameters held on a module itself."""
    layers = (nn.Conv2d, nn.Linear, BatchNorm, LayerNorm, nn.Embedding)
    return ({f"{name}.weight" for name, m in model.named_modules()
             if isinstance(m, nn.Embedding)}
            | {f"{name}.{p}" if name else p for name, m in model.named_modules()
               if not isinstance(m, layers) for p, _ in m.named_parameters(recurse=False)})


def _get(tree: Tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _from_tree(model: nn.Module, collection: str, tree: Tree) -> dict[str, torch.Tensor]:
    """A Flax collection's arrays as port-layout tensors by state_dict key."""
    keep = _untransposed(model)
    out = {}
    for path, name in _flatten(_flax_tree(model, collection)):
        arr = torch.from_numpy(np.array(_get(tree, path), dtype=np.float32))
        out[name] = from_jax_view(arr, name not in keep).contiguous()
    return out


def _to_tree(model: nn.Module, collection: str, tensors: dict[str, torch.Tensor]) -> Tree:
    """Port tensors by state_dict key as a Flax collection of numpy arrays."""
    keep = _untransposed(model)
    tree: Tree = {}
    for path, name in _flatten(_flax_tree(model, collection)):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        view = jax_view(tensors[name].detach().cpu(), name not in keep)
        # a copy: a vector's numpy view would share the live parameter's
        # memory, which an in-place update (and JAX, aliasing host buffers
        # on the CPU) would then see change under it
        node[path[-1]] = view.contiguous().numpy().copy()
    return tree


def state_dict_from_jax(
    model: nn.Module, params: Tree, batch_stats: Optional[Tree] = None
) -> dict[str, torch.Tensor]:
    """The port's state_dict from the JAX package's ``params`` and
    ``batch_stats`` (nested dicts of arrays)."""
    return {**_from_tree(model, "params", params),
            **_from_tree(model, "batch_stats", batch_stats)}


def jax_from_state_dict(
    model: nn.Module, state_dict: Optional[dict[str, torch.Tensor]] = None
) -> tuple[Tree, Tree]:
    """(params, batch_stats) as nested dicts of numpy arrays, the inverse of
    :func:`state_dict_from_jax`."""
    sd = model.state_dict() if state_dict is None else state_dict
    return _to_tree(model, "params", sd), _to_tree(model, "batch_stats", sd)


# ---- optimizer state -----------------------------------------------------
# An optax state is a nest of tuples and NamedTuples: TraceState(trace) for
# momentum, ScaleByAdamState(count, mu, nu) or ScaleByAmsgradState(count,
# mu, nu, nu_max) for adam, ScaleByScheduleState(count) for the schedule,
# EmptyState() for weight decay and the identity. Each per-leaf field is a
# tree shaped like the params. The port keeps the same fields as lists in
# the canonical leaf order (SgdState, AdamState).

_PER_LEAF = ("trace", "mu", "nu", "nu_max")


def _named_states(tree):
    """The NamedTuples of an optax state, depth first."""
    if hasattr(tree, "_fields"):
        yield tree
    if isinstance(tree, tuple):
        for t in tree:
            yield from _named_states(t)


def opt_state_from_jax(model: nn.Module, opt_state) -> OptState:
    """The port's optimizer state (:class:`SgdState` or :class:`AdamState`,
    leaves in the canonical order and the port layout) from the JAX
    package's optax state of ``make_optimizer``."""
    # imported here: the training package imports the codecs, which import
    # this module
    from atomo_tpu_torch.training.optim import AdamState, SgdState

    fields = {f: getattr(s, f) for s in _named_states(opt_state) for f in s._fields}
    if "count" not in fields:
        raise ValueError("not an optax state of atomo_tpu's make_optimizer: no count")
    count = int(np.asarray(fields["count"]))
    order = jax_leaf_order(model)

    def leaves(key):
        if key not in fields:
            return None
        by_name = _from_tree(model, "params", fields[key])
        return [by_name[n] for n in order]

    if "mu" in fields:
        return AdamState(count=count, mu=leaves("mu"), nu=leaves("nu"),
                         nu_max=leaves("nu_max"))
    return SgdState(count=count, trace=leaves("trace"))


def jax_opt_state(model: nn.Module, state: OptState, template):
    """The JAX package's optax state of the port's ``state``: ``template``
    (the JAX optimizer's ``init(params)``, which fixes the structure) with
    every count and per-leaf tree replaced by numpy arrays. Raises when the
    template holds a field the port's state has not."""
    order = jax_leaf_order(model)
    values = {"count": np.asarray(state.count, np.int32)}
    for key in _PER_LEAF:
        tensors = getattr(state, key, None)
        if tensors is not None:
            values[key] = _to_tree(model, "params", dict(zip(order, tensors)))

    def fill(node):
        if hasattr(node, "_fields"):
            out = {}
            for f in node._fields:
                if f in values:
                    out[f] = values[f]
                elif isinstance(getattr(node, f), tuple):
                    out[f] = fill(getattr(node, f))
                else:
                    raise ValueError(f"the port's {type(state).__name__} has no {f!r} for "
                                     f"the optax {type(node).__name__}")
            return node._replace(**out)
        if isinstance(node, tuple):
            return tuple(fill(t) for t in node)
        return node

    return fill(template)


# ---- the LM layouts' family trees ------------------------------------------


def tree_leaves(tree: dict) -> list:
    """A nested dict's leaves in ``jax.tree_util.tree_flatten`` order (keys
    sorted as strings at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def slice_tree(full: dict, specs: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s slice of a full tree: one of ``n`` along each leaf's
    sharded dimension (``specs``: per leaf a dimension, or None for a
    replicated leaf)."""
    def one(leaf, dim):
        if dim is None or n == 1:
            return leaf
        k = leaf.shape[dim] // n
        idx = [slice(None)] * leaf.ndim
        idx[dim] = slice(rank * k, (rank + 1) * k)
        return leaf[tuple(idx)]

    if isinstance(full, dict):
        return {k: slice_tree(full[k], specs[k], rank, n) for k in full}
    return one(full, specs)


def family_slice(layout: str, full: dict, mesh) -> dict:
    """This rank's slice of a layout's full family tree (the JAX package's
    tp-laid, MoE or pp-stacked tree, numpy or torch): the leaves its model
    axis shards cut to this rank's index on that axis (``mesh``, a
    :class:`~atomo_tpu_torch.mesh.spec.ProcessMesh`)."""
    from atomo_tpu_torch.parallel.model_axes import FAMILY_AXIS, family_specs

    axis = FAMILY_AXIS[layout]
    return slice_tree(full, family_specs(layout, full), mesh.index(axis), mesh.size(axis))


def to_numpy_tree(tree: dict) -> dict:
    """A nested dict of tensors as numpy copies (a ParamTree's ``tree()``,
    a gathered full tree): the JAX package's layout as it is."""
    return {k: to_numpy_tree(v) if isinstance(v, dict)
            else np.array(v.detach().cpu().numpy(), copy=True) for k, v in tree.items()}


# ---- the flat layout of the partitioned update ------------------------------
# The JAX package's ZeRO-1 and sharded update ravel the params tree
# (``ravel_pytree``: the canonical leaf order, each leaf in the JAX layout)
# and pad it to chunk * N; the port's flat vector takes the same leaves in the
# same order, each in the PORT's layout (mesh.update), padded alike. The two
# hold the same values at other places within each leaf.


def _leaf_sizes(model: nn.Module) -> tuple[list, list, list]:
    """(names, port shapes, transposed?) of the params in canonical order."""
    named = dict(model.named_parameters())
    names = jax_leaf_order(model)
    keep = _untransposed(model)
    return names, [tuple(named[n].shape) for n in names], [n not in keep for n in names]


def port_flat_from_jax(model: nn.Module, flat) -> torch.Tensor:
    """A JAX flat vector (``ravel_pytree`` order and layout, any padding at
    the end, kept as it is) as the port's flat vector of the same length."""
    src = torch.from_numpy(np.array(flat, dtype=np.float32).reshape(-1))
    out = src.clone()
    at = 0
    for _, shape, tr in zip(*_leaf_sizes(model)):
        n = int(np.prod(shape, dtype=np.int64))
        jshape = tuple(jax_view(torch.empty(shape), tr).shape)
        out[at:at + n] = from_jax_view(src[at:at + n].view(jshape), tr).reshape(-1)
        at += n
    return out


def jax_flat_from_port(model: nn.Module, flat: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`port_flat_from_jax`: the port's flat vector as the
    JAX package's, the padding kept."""
    src = flat.detach().cpu().reshape(-1)
    out = src.clone()
    at = 0
    for _, shape, tr in zip(*_leaf_sizes(model)):
        n = int(np.prod(shape, dtype=np.int64))
        out[at:at + n] = jax_view(src[at:at + n].view(shape), tr).reshape(-1)
        at += n
    return out.numpy().copy()


def flat_opt_from_jax(model: nn.Module, opt_state) -> dict:
    """The JAX package's flat optimizer state (``flat_opt_state``'s: each
    per-leaf field one (N * chunk,) vector) as the port's full flat fields:
    ``{"count": int, field: [port flat vector]}`` for each field the optax
    state holds (``trace``; ``mu``, ``nu``, ``nu_max``)."""
    fields = {f: getattr(s, f) for s in _named_states(opt_state) for f in s._fields}
    if "count" not in fields:
        raise ValueError("not an optax state of atomo_tpu's make_optimizer: no count")
    out = {"count": int(np.asarray(fields["count"]))}
    for key in _PER_LEAF:
        if key in fields:
            out[key] = [port_flat_from_jax(model, np.asarray(fields[key]))]
    return out


def jax_flat_opt(model: nn.Module, full: dict, template):
    """The JAX package's flat optax state from the port's full flat fields
    (:func:`flat_opt_from_jax`'s form): ``template`` (the JAX optimizer's
    ``init`` on a flat vector) with its count and vectors replaced."""
    values = {"count": np.asarray(full["count"], np.int32)}
    for key in _PER_LEAF:
        if full.get(key) is not None:
            values[key] = jax_flat_from_port(model, full[key][0])

    def fill(node):
        if hasattr(node, "_fields"):
            return node._replace(**{f: values[f] if f in values else fill(getattr(node, f))
                                    for f in node._fields})
        if isinstance(node, tuple):
            return tuple(fill(t) for t in node)
        return node

    return fill(template)


# ------------------------------------------------ the quorum staleness ring
# The JAX package's QuorumCarry holds, per payload field (tree_leaves order:
# leaf by leaf in canonical order, each payload's fields in order), one
# (n_dev, K+1, *field shape) array and a (n_dev, K+1) ring_ok; the port's
# ring is a rank's (K+1, B) packed rows (parallel.common.PackSpec), and its
# checkpoint form every rank's, (N, K+1, B). A field lies alike in both
# packages (the codecs encode the JAX view), so a field's bytes move as
# they are.


_NP_DTYPES = {torch.uint8: np.uint8, torch.int32: np.int32, torch.uint32: np.uint32,
              torch.float32: np.float32, torch.bfloat16: np.uint16, torch.float16: np.float16,
              torch.int64: np.int64}


def _spec_fields(spec) -> list:
    return [f for leaf in spec.fields for f in leaf]


def quorum_ring_from_jax(fields, ring_ok, spec) -> dict:
    """A JAX ``QuorumCarry`` (its ``tree_leaves(ring)`` as numpy arrays and
    its ``ring_ok``) as the port's gathered ring: ``{"ring": (N, K+1, B)
    uint8, "ring_ok": (N, K+1) float32}``, ``spec`` the port's layout of one
    payload row (``QuorumCarry.spec``). Padding bytes are zero."""
    flat = _spec_fields(spec)
    if len(fields) != len(flat):
        raise ValueError(f"the JAX ring has {len(fields)} payload fields, the port's "
                         f"layout {len(flat)}")
    lead = tuple(np.asarray(ring_ok).shape)
    ring = np.zeros(lead + (spec.nbytes,), np.uint8)
    for a, (off, nbytes, dtype, shape, _) in zip(fields, flat):
        a = np.ascontiguousarray(a)
        if a.shape != lead + tuple(shape) or a.nbytes != nbytes * int(np.prod(lead)):
            raise ValueError(f"JAX ring field {a.shape} {a.dtype} does not fill the port's "
                             f"{lead + tuple(shape)} field of {nbytes} bytes")
        ring[..., off:off + nbytes] = a.view(np.uint8).reshape(lead + (nbytes,))
    return {"ring": torch.from_numpy(ring),
            "ring_ok": torch.from_numpy(np.asarray(ring_ok, np.float32).copy())}


def jax_quorum_ring(saved: dict, spec) -> tuple[list, np.ndarray]:
    """Inverse of :func:`quorum_ring_from_jax`: the port's gathered ring as
    the JAX ``QuorumCarry``'s (field arrays in ``tree_leaves`` order,
    ``ring_ok``), each field (N, K+1, *shape) in its own dtype."""
    ring = saved["ring"].detach().cpu().contiguous().numpy()
    lead = ring.shape[:-1]
    out = []
    for off, nbytes, dtype, shape, _ in _spec_fields(spec):
        np_dtype = _NP_DTYPES[dtype]
        out.append(np.ascontiguousarray(ring[..., off:off + nbytes]).view(np_dtype)
                   .reshape(lead + tuple(shape)))
    return out, saved["ring_ok"].detach().cpu().numpy().copy()
