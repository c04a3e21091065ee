"""One front end over the LM layouts: a layout's state, step and token shard.

Counterpart of ``atomo_tpu/parallel/model_axes.py:42-173``
(:class:`ModelAxisProgram`, :func:`build_model_axis_program`): one dispatch
for the six layouts, each family's dp tail through the one compressed
stack (``parallel.lm.make_model_axis_step``: gather, psum, ring,
``--stream-encode`` and ``--overlap delayed`` with every layout). Each
(dp, model-axis) rank encodes its own slice under its replica's key
``fold_in(fold_in(key, step), rank_dp)``; leaf i of the family's tree (in
``jax_leaf_order``) draws from ``fold_in(k_codec, i)``.

The dispatch key is the layout the caller names. The JAX package
dispatches on ``spec.layout_name()``, which drops model axes of size one,
so there ``--layout dp-ep --ways 1`` runs the dense dp LM; the port runs
the named family at any size (at ep 1 the MoE layer still routes, drops
and runs every expert; at pp 1 the pipeline still runs its microbatch
ticks), which is how one card runs every family. Above size one the two
agree.

Besides the step, a program carries what the CLI needs around it: the
sharding of each leaf (``splits``: per leaf in canonical order, the mesh
axis and dimension it is cut along, or None), :func:`gather_leaves` (the
full tree on every rank, for the eval forward and the checkpoints),
:func:`slice_leaves` (a full tree onto this rank) and :func:`oracle_logits`,
each family's single-device forward.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from atomo_tpu_torch.convert import tree_leaves
from atomo_tpu_torch.mesh.spec import LAYOUT_MODEL_AXES, MeshSpec
from atomo_tpu_torch.parallel.lm import DpExchange
from atomo_tpu_torch.utils.device import resolve_device

__all__ = ["LAYOUT_MODEL_AXES", "ModelAxisProgram", "build_model_axis_program",
           "gather_leaves", "oracle_logits", "slice_leaves"]

FAMILY_AXIS = {"dp-tp": "tp", "dp-tp-sp": "tp", "dp-ep": "ep", "dp-pp": "pp"}


class ModelAxisProgram(NamedTuple):
    """A runnable LM layout: everything a caller needs."""

    layout: str
    spec: MeshSpec
    mesh: Any  # DpSpMesh (dp, dp-sp) or ProcessMesh
    state: Any  # TrainState (with its carry under delayed)
    step: Callable  # (state, key, tokens, draws=None) -> (state, metrics)
    shard_tokens: Callable  # numpy (B, S) global batch -> this rank's block
    splits: Optional[list]  # per leaf (axis, dim) or None; None: replicated layouts


def family_specs(layout: str, tree: dict) -> dict:
    """Per leaf of a family tree the dimension sharded over its model axis."""
    from atomo_tpu_torch.parallel import moe, pp, tp

    return {"dp-tp": tp.tp_param_specs, "dp-tp-sp": tp.tp_param_specs,
            "dp-ep": moe.moe_param_specs, "dp-pp": pp.pp_param_specs}[layout](tree)


def family_state(layout: str, full: dict, mesh, optimizer, device):
    """A TrainState of this rank's slice of a full family tree (numpy or
    torch leaves, the JAX layout), held in a
    :class:`~atomo_tpu_torch.parallel.common.ParamTree` on ``device``."""
    from atomo_tpu_torch.convert import family_slice
    from atomo_tpu_torch.parallel.common import ParamTree
    from atomo_tpu_torch.training.trainer import TrainState, leaf_params

    tree = ParamTree(family_slice(layout, full, mesh)).to(device)
    return TrainState(step=0, model=tree, opt_state=optimizer.init(leaf_params(tree)))


def full_family_init(layout: str, lm_config: dict, seed: int) -> dict:
    """The full tree a layout starts from: the stock LM's init re-laid for
    tp, or the MoE or stacked tree's own init, drawn from ``seed``."""
    from atomo_tpu_torch.convert import jax_from_state_dict
    from atomo_tpu_torch.models.transformer import TransformerLM
    from atomo_tpu_torch.parallel import moe, pp, tp
    from atomo_tpu_torch.training.trainer import init_params

    if layout in ("dp-tp", "dp-tp-sp"):
        lm = TransformerLM(**lm_config)
        init_params(lm, seed)
        return tp.lm_params_to_tp(jax_from_state_dict(lm)[0], lm_config["num_heads"])
    if layout == "dp-ep":
        return moe.init_moe_lm_params(seed, lm_config)
    return pp.init_pp_lm_params(seed, lm_config)


def _block(tokens, rows: int, i: int, cols: int = 1, j: int = 0):
    b, s = tokens.shape
    if b % rows or s % cols:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split into {rows} x {cols}")
    return tokens[i * b // rows:(i + 1) * b // rows, j * s // cols:(j + 1) * s // cols]


def build_model_axis_program(
    spec: MeshSpec,
    lm_config: dict,
    optimizer,
    seed: int,
    codec=None,
    *,
    layout: Optional[str] = None,
    attn_impl: str = "ring",
    num_microbatches: int = 2,
    capacity_factor: float = 1.25,
    aux_weight: float = 0.01,
    compute_dtype=None,
    aggregate: str = "gather",
    exchange: Optional[DpExchange] = None,
    device=None,
    params=None,
) -> ModelAxisProgram:
    """Resolve a layout to its program on this process. ``layout`` (default
    ``spec.layout_name()``) picks the family; ``spec`` sizes the mesh over
    the process group that is up. ``params`` (a full tree in the JAX
    layout, numpy) replaces the init drawn from ``seed``: the stock LM tree
    for dp and dp-sp, the family tree otherwise. Under ``exchange.overlap ==
    "delayed"`` the state carries its fresh carry. ``device`` is CUDA unless
    the caller asks for the CPU. Sizing errors are the builders'
    ValueErrors."""
    from atomo_tpu_torch.parallel import launch, moe, pp, tp
    from atomo_tpu_torch.parallel import lm as L

    layout = layout or spec.layout_name()
    if layout not in LAYOUT_MODEL_AXES:
        raise ValueError(f"unknown layout {layout!r}")
    device = resolve_device(device)
    kw = dict(compute_dtype=compute_dtype, aggregate=aggregate, exchange=exchange)

    def finish(mesh, state, step, shard, splits):
        if exchange is not None and exchange.overlap == "delayed":
            state = L.init_model_axis_delayed_state(state, codec)
        return ModelAxisProgram(layout, spec, mesh, state, step, shard, splits)

    if layout in ("dp", "dp-sp"):
        from atomo_tpu_torch.convert import state_dict_from_jax
        from atomo_tpu_torch.models.transformer import TransformerLM
        from atomo_tpu_torch.parallel.replicated import replicate_state

        mesh = launch.dp_sp_mesh(dict(spec.axes).get("sp", 1))
        state = L.create_lm_state(lm_config, optimizer, seed, device)
        if params is not None:
            sd = state_dict_from_jax(TransformerLM(**lm_config), params, {})
            state.model.load_state_dict(sd)
        if dist.is_initialized():
            state = replicate_state(state)
        step = L.make_lm_train_step(state.model, optimizer, codec, attn_impl=attn_impl,
                                    mesh=mesh, **kw)
        return finish(mesh, state, step, lambda t: L.shard_tokens(t, mesh), None)

    mesh = spec.build()
    axis = FAMILY_AXIS[layout]
    if layout in ("dp-tp", "dp-tp-sp"):
        tp.check_tp_sizes(lm_config, mesh.size("tp"))
    elif layout == "dp-ep" and lm_config["num_experts"] % mesh.size("ep"):
        raise ValueError(f"num_experts {lm_config['num_experts']} not divisible by "
                         f"ep={mesh.size('ep')}")
    elif layout == "dp-pp" and lm_config["depth"] % mesh.size("pp"):
        raise ValueError(f"depth {lm_config['depth']} not divisible by pp={mesh.size('pp')}")
    full = full_family_init(layout, lm_config, seed) if params is None else params
    state = family_state(layout, full, mesh, optimizer, device)
    splits = [None if d is None else (axis, d)
              for d in tree_leaves(family_specs(layout, state.model.tree()))]
    if layout == "dp-tp":
        step = tp.make_tp_lm_train_step(state.model, optimizer, mesh, codec, **kw)
        shard = lambda t: _block(t, mesh.n_dp, mesh.rank_dp)  # noqa: E731
    elif layout == "dp-tp-sp":
        step = tp.make_tp_sp_lm_train_step(state.model, optimizer, mesh, codec,
                                           attn_impl=attn_impl, **kw)
        shard = lambda t: _block(t, mesh.n_dp, mesh.rank_dp, mesh.size("sp"),  # noqa: E731
                                 mesh.index("sp"))
    elif layout == "dp-ep":
        step = moe.make_moe_lm_train_step(state.model, lm_config, optimizer, mesh, codec,
                                          capacity_factor=capacity_factor,
                                          aux_weight=aux_weight, **kw)
        shard = lambda t: moe.shard_moe_tokens(t, mesh)  # noqa: E731
    else:
        step = pp.make_pp_lm_train_step(state.model, lm_config, optimizer, mesh, codec,
                                        num_microbatches=num_microbatches, **kw)
        shard = lambda t: _block(t, mesh.n_dp, mesh.rank_dp)  # noqa: E731
    return finish(mesh, state, step, shard, splits)


def gather_leaves(leaves, splits, mesh) -> list[torch.Tensor]:
    """The full leaves (canonical order) from every rank's slices: one
    all_gather over the leaf's axis group each, concatenated along its
    dimension. Collective over the world; every rank gets them."""
    out = []
    for t, sp in zip(leaves, splits):
        t = t.detach()
        if sp is None or mesh.size(sp[0]) == 1:
            out.append(t.clone())
            continue
        axis, d = sp
        parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
        dist.all_gather(parts, t.contiguous(), group=mesh.group(axis))
        out.append(torch.cat(parts, dim=d))
    return out


def slice_leaves(full, splits, mesh) -> list[torch.Tensor]:
    """This rank's slices of full leaves (canonical order)."""
    out = []
    for t, sp in zip(full, splits):
        if sp is not None:
            axis, d = sp
            k = t.shape[d] // mesh.size(axis)
            t = t.narrow(d, mesh.index(axis) * k, k)
        out.append(t)
    return out


def oracle_logits(layout: str, tree: dict, tokens: torch.Tensor, lm_config: dict,
                  capacity: Optional[int] = None) -> torch.Tensor:
    """Each family's single-device forward on a full tree (nested dict of
    tensors): (B, S) -> logits (B, S, V). dp-ep takes its ``capacity``."""
    from atomo_tpu_torch.parallel import moe, pp, tp

    if layout in ("dp-tp", "dp-tp-sp"):
        return tp.tp_lm_forward(tree, tokens)
    if layout == "dp-ep":
        return moe.moe_lm_forward(tree, tokens, lm_config, capacity=capacity)[0]
    return pp.pp_lm_forward_reference(tree, tokens, lm_config)


def tree_of(names: list[str], leaves) -> dict:
    """A nested dict from dotted names (a ParamTree's ``jax_leaf_order``)
    and leaves."""
    tree: dict = {}
    for name, leaf in zip(names, leaves):
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


_PER_LEAF = ("trace", "mu", "nu", "nu_max")


def _opt_fields(opt) -> list[str]:
    import dataclasses

    return [f.name for f in dataclasses.fields(opt)
            if f.name in _PER_LEAF and getattr(opt, f.name) is not None]


def save_program_checkpoint(prog: ModelAxisProgram, state, train_dir: str,
                            compress: bool = False) -> None:
    """Checkpoint a layout's ``state``: collective over the world. The
    replicated layouts (dp, dp-sp) write their state as it is; a family
    gathers its slices, and rank 0 writes the full tree of the family in the
    JAX layout (a :class:`~atomo_tpu_torch.parallel.common.ParamTree`) with
    its full optimizer state. Under delayed every rank's in-flight payload
    goes in too (``overlap.gather_carry``)."""
    import dataclasses

    from atomo_tpu_torch.convert import jax_leaf_order
    from atomo_tpu_torch.parallel.common import ParamTree
    from atomo_tpu_torch.parallel.overlap import OverlapCarry, gather_carry
    from atomo_tpu_torch.training.checkpoint import save_checkpoint
    from atomo_tpu_torch.training.trainer import TrainState, leaf_params

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    carry = state.carry
    if isinstance(carry, OverlapCarry):
        carry = gather_carry(carry, world)
    saved = dataclasses.replace(state, carry=carry)
    if prog.splits is not None:
        full = gather_leaves(leaf_params(state.model), prog.splits, prog.mesh)
        opt = state.opt_state
        opt = dataclasses.replace(opt, **{f: gather_leaves(getattr(opt, f), prog.splits,
                                                           prog.mesh)
                                          for f in _opt_fields(opt)})
        model = ParamTree(tree_of(jax_leaf_order(state.model), full))
        saved = TrainState(step=state.step, model=model, opt_state=opt, carry=carry)
    if rank == 0:
        save_checkpoint(train_dir, saved, compress=compress)
    if dist.is_initialized():
        dist.barrier()  # no rank goes on before the file is in place


@torch.no_grad()
def load_program_checkpoint(prog: ModelAxisProgram, train_dir: str):
    """The newest checkpoint of ``train_dir`` loaded into ``prog.state``
    (each rank takes its slices of a family's full tree): (state, the saved
    overlap carry dict or None). Collective over the world for a family."""
    import dataclasses

    from atomo_tpu_torch.convert import jax_leaf_order
    from atomo_tpu_torch.parallel.common import ParamTree
    from atomo_tpu_torch.training.checkpoint import load_checkpoint
    from atomo_tpu_torch.training.trainer import TrainState, leaf_params

    state = dataclasses.replace(prog.state, carry=None)
    if prog.splits is None:
        loaded = load_checkpoint(train_dir, state)
        return dataclasses.replace(loaded, carry=None), loaded.carry
    params = leaf_params(state.model)
    full = [t.cpu() for t in gather_leaves(params, prog.splits, prog.mesh)]
    template = TrainState(step=0, model=ParamTree(tree_of(jax_leaf_order(state.model), full)),
                          opt_state=dataclasses.replace(state.opt_state, **{
                              f: [t.cpu().clone() for t in gather_leaves(
                                  getattr(state.opt_state, f), prog.splits, prog.mesh)]
                              for f in _opt_fields(state.opt_state)}))
    loaded = load_checkpoint(train_dir, template)
    for p, t in zip(params, slice_leaves(leaf_params(loaded.model), prog.splits, prog.mesh)):
        p.copy_(t)
    opt = state.opt_state
    for f in _opt_fields(opt):
        for mine, t in zip(getattr(opt, f), slice_leaves(getattr(loaded.opt_state, f),
                                                         prog.splits, prog.mesh)):
            mine.copy_(t)
    opt = dataclasses.replace(opt, count=loaded.opt_state.count)
    return dataclasses.replace(state, step=loaded.step, opt_state=opt), loaded.carry
