"""Re-sharding a live state: a new world for the sharded update, a new model
axis for the LM.

Counterpart of ``atomo_tpu/mesh/reshard.py:36-88`` (``reshard_sharded_update``)
and ``:247-368`` (``reshard_model_axes``). The JAX package re-places device
buffers on a new mesh inside one process. The port runs one process per
device, so a state moves as host bytes: the old ranks gather it
(:func:`~atomo_tpu_torch.mesh.update.gather_host`, the same full vectors a
checkpoint holds) and the new ranks place their slices of it through the
same construction a fresh run performs. The resharded trajectory is then the
fresh build's by construction. Between LM layouts the world stays and the
move is one collective gather and a slice on each rank.

``reshard_replicated`` and ``reshard_plan`` serve the elastic coordinator,
which is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from atomo_tpu_torch.mesh.update import (
    ShardedUpdateSpecs,
    ShardedUpdateState,
    sharded_update_state,
)
from atomo_tpu_torch.training.trainer import TrainState, leaf_params


@torch.no_grad()
def reshard_sharded_update(host: dict, model, optimizer
                           ) -> tuple[ShardedUpdateState, ShardedUpdateSpecs]:
    """A sharded-update state of THIS process group built from ``host``,
    the gathered state of a run over any other world
    (:func:`~atomo_tpu_torch.mesh.update.gather_host` with its ``buffers``).
    The master is trimmed to the true flat vector and re-padded and
    re-sliced for this world; every optimizer buffer of the master's layout
    (momentum, Adam's moments) is re-sliced exactly, so the run continues
    the same optimizer trajectory, not a fresh-momentum one; the count and
    the step carry over. ``model`` (the run's, on its device) receives the
    parameters and statistics."""
    params = leaf_params(model)
    d_flat = sum(p.numel() for p in params)
    flat = host["master"].reshape(-1)[:d_flat]
    at = 0
    for p in params:
        p.copy_(flat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    named = dict(model.named_buffers())
    for k, v in host.get("buffers", {}).items():
        named[k].copy_(v)
    state = TrainState(step=int(host["step"]), model=model,
                       opt_state=optimizer.init(params))
    state, specs = sharded_update_state(state, optimizer)
    pad = specs.n_shards * specs.chunk - d_flat
    opt = state.opt_state
    saved = host["opt"]
    for f in dataclasses.fields(opt):
        mine = getattr(opt, f.name)
        if not isinstance(mine, list):
            continue
        for t, full in zip(mine, saved[f.name]):
            vec = torch.nn.functional.pad(full.reshape(-1)[:d_flat], (0, pad))
            t.copy_(specs.own(vec).to(t.device))
    opt = dataclasses.replace(opt, count=int(saved["count"]))
    return dataclasses.replace(state, opt_state=opt), specs


# the param families whose trees one bijection relates (dp-ep and dp-pp store
# layout-owned trees: expert- or stage-stacked)
_LAYOUT_PARAM_FAMILY = {"dp": "lm", "dp-sp": "lm", "dp-tp": "tp", "dp-tp-sp": "tp"}


def _full_trees(prog) -> tuple[dict, dict]:
    """(params, {optimizer field: tree}) of a program's state as full trees
    in the JAX layout (numpy), on every rank: a replicated layout reads its
    model, a family gathers its slices (collective over the world)."""
    from atomo_tpu_torch.convert import _to_tree, jax_from_state_dict, jax_leaf_order
    from atomo_tpu_torch.parallel.model_axes import _opt_fields, gather_leaves, tree_of

    state = prog.state
    opt = state.opt_state
    model = state.model
    names = jax_leaf_order(model)
    if prog.splits is None:
        params = jax_from_state_dict(model)[0]
        fields = {f: _to_tree(model, "params", dict(zip(names, getattr(opt, f))))
                  for f in _opt_fields(opt)}
        return params, fields

    def full(leaves):
        return tree_of(names, [t.cpu().numpy().copy()
                               for t in gather_leaves(leaves, prog.splits, prog.mesh)])

    return full(leaf_params(model)), {f: full(getattr(opt, f)) for f in _opt_fields(opt)}


@torch.no_grad()
def reshard_model_axes(prog, new_spec, lm_config: dict, optimizer, *, codec=None,
                       layout: Optional[str] = None, exchange=None, aggregate: str = "gather",
                       attn_impl: str = "ring", compute_dtype=None, device=None):
    """Redistribute a LIVE LM program's state (``prog``, a
    :class:`~atomo_tpu_torch.parallel.model_axes.ModelAxisProgram`) onto
    another layout of the same world, e.g. a replicated ``dp`` run onto a
    ``dp-tp`` mesh or back, without a checkpoint round trip. Collective
    over the world.

    The parameter re-layout is the layouts' own bijection
    (:func:`~atomo_tpu_torch.parallel.tp.lm_params_to_tp` /
    :func:`~atomo_tpu_torch.parallel.tp.tp_params_to_lm`), applied to the
    parameters AND to every optimizer buffer tree that mirrors them
    (momentum, Adam's moments), so the resharded run continues the same
    optimizer trajectory, exactly as if the target layout had been built
    fresh from these values; the step and the count carry over. A delayed
    program (its state with an overlap carry) needs ``codec``: the carry's
    payloads are the old layout's slices, which no bijection relates, so it
    resets to the fresh ``valid=0`` carry (``exchange`` with
    ``overlap='delayed'``): the next step skips, as step 0 does. dp-ep and
    dp-pp are refused, as in the JAX package. ``device`` defaults to the
    program's. Returns the new program (the same ``ModelAxisProgram``
    ``build_model_axis_program`` returns)."""
    from atomo_tpu_torch.convert import _from_tree, jax_leaf_order, tree_leaves
    from atomo_tpu_torch.parallel.model_axes import (
        _opt_fields,
        build_model_axis_program,
        slice_leaves,
    )
    from atomo_tpu_torch.parallel.overlap import OverlapCarry
    from atomo_tpu_torch.parallel.tp import lm_params_to_tp, tp_params_to_lm

    delayed = isinstance(prog.state.carry, OverlapCarry)
    if delayed and codec is None:
        raise ValueError(
            "resharding a DelayedState needs the run's codec: the "
            "fresh carry's zero-payload shapes come from the codec's "
            "encode over the NEW layout's local shard shapes")
    old_layout = prog.layout
    new_layout = layout or new_spec.layout_name()
    fam_old = _LAYOUT_PARAM_FAMILY.get(old_layout)
    fam_new = _LAYOUT_PARAM_FAMILY.get(new_layout)
    if fam_old is None or fam_new is None:
        bad = old_layout if fam_old is None else new_layout
        raise ValueError(
            f"layout {bad!r} stores a layout-owned param tree (expert/"
            "stage sharded); live redistribution is proven only between "
            f"{sorted(_LAYOUT_PARAM_FAMILY)} — go through a checkpoint "
            "save/restore instead")
    if delayed and (exchange is None or exchange.overlap != "delayed"):
        raise ValueError("resharding a delayed program needs its exchange "
                         "(overlap='delayed') for the fresh carry")
    num_heads = int(lm_config["num_heads"])
    device = device or leaf_params(prog.state.model)[0].device
    params, fields = _full_trees(prog)
    if fam_old != fam_new:
        convert = lm_params_to_tp if fam_new == "tp" else tp_params_to_lm
        params = convert(params, num_heads)
        fields = {f: convert(t, num_heads) for f, t in fields.items()}
    new = build_model_axis_program(new_spec, lm_config, optimizer, 0, codec, layout=new_layout,
                                   params=params, exchange=exchange, aggregate=aggregate,
                                   attn_impl=attn_impl, compute_dtype=compute_dtype,
                                   device=device)
    state = new.state
    opt = state.opt_state
    model = state.model
    for f in _opt_fields(opt):
        if new.splits is None:
            by_name = _from_tree(model, "params", fields[f])
            leaves = [by_name[n] for n in jax_leaf_order(model)]
        else:
            leaves = slice_leaves([torch.from_numpy(x) for x in tree_leaves(fields[f])],
                                  new.splits, new.mesh)
        for mine, t in zip(getattr(opt, f), leaves):
            mine.copy_(t)
    opt = dataclasses.replace(opt, count=prog.state.opt_state.count)
    return new._replace(state=dataclasses.replace(state, step=prog.state.step, opt_state=opt))
