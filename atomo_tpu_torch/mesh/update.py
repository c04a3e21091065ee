"""Cross-replica sharded weight update (Xu et al., 2004.13336) and ZeRO-1.

Counterpart of ``atomo_tpu/mesh/update.py`` and of ``zero1_state``
(``atomo_tpu/parallel/replicated.py:4666``). The replicated step keeps N
copies of everything: every rank holds the parameters and the optimizer
state and runs the whole update. Two partitions shard it over the ranks of
the process group:

* **ZeRO-1**: the parameters stay replicated, the optimizer state is sharded
  (each rank holds 1/N of every momentum or Adam buffer), each rank updates
  its slice of the parameters and one ``all_gather_into_tensor`` rebuilds
  the replicated parameters;
* **sharded update**: the parameters are sharded too. Each rank persistently
  holds its slice of the flat parameter vector (``master``) and of the
  optimizer buffers and nothing else; the dense model is materialized
  transiently at the start of each step (one ``all_gather_into_tensor`` of
  the masters into a working buffer), and released after it.

**The flat layout.** The flat vector concatenates the model's parameters in
the canonical order (:func:`~atomo_tpu_torch.convert.jax_leaf_order`), each
leaf in the PORT's layout, padded with zeros to ``chunk * N``
(:func:`chunk_len`); rank r owns ``[r * chunk, (r + 1) * chunk)``. The
model's parameters are views of one buffer of that layout (the specs'
``flat``), so the gather writes them in place. The update is elementwise, so
a slice's update is the slice of the full update whatever the chunk
boundaries (:func:`check_slice_invariant` probes it at set-up), and both
partitions' trajectories equal the replicated one bit for bit. The JAX
package ravels its tree in the same leaf order in its own layout (HWIO
kernels); :func:`atomo_tpu_torch.convert.port_flat_from_jax` and
:func:`~atomo_tpu_torch.convert.jax_flat_from_port` map between the two.

Per-rank persistent state, P parameters over N ranks (float32,
momentum SGD): replicated 8P bytes, ZeRO-1 4P + 4P/N, sharded update 8P/N.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from atomo_tpu_torch.convert import jax_leaf_order
from atomo_tpu_torch.training.optim import Optimizer
from atomo_tpu_torch.training.trainer import TrainState, leaf_params


@dataclasses.dataclass
class ShardedUpdateState(TrainState):
    """The sharded-persistent train state: ``master`` is this rank's
    ``(chunk,)`` slice of the flat parameter vector, ``opt_state`` holds the
    optimizer's buffers as ``(chunk,)`` slices of the same layout, the
    BatchNorm statistics stay in the model's buffers (replicated) and the
    model's parameters are views of the specs' working buffer, valid only
    while it is materialized."""

    master: Optional[torch.Tensor] = None


class ShardedUpdateSpecs:
    """The flat layout of one run (both partitions): ``n_shards`` ranks,
    this ``rank``, ``chunk`` (:func:`chunk_len`), ``d_flat`` values, the
    leaves' ``names`` (canonical order), ``shapes`` and ``offsets``, and
    ``flat``, the ``(n_shards * chunk,)`` buffer whose views the model's
    parameters are (persistent under ZeRO-1, the working buffer under the
    sharded update). One instance per run: the step's slices and the
    allocations read the same numbers."""

    def __init__(self, *, n_shards: int, rank: int, chunk: int, names, shapes, flat,
                 partition: str):
        self.n_shards = n_shards
        self.rank = rank
        self.chunk = chunk
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        self.offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        self.d_flat = sum(sizes)
        self.flat = flat
        self.partition = partition
        self._nbytes = flat.numel() * flat.element_size()

    @property
    def lo(self) -> int:
        return self.rank * self.chunk

    @property
    def hi(self) -> int:
        return self.lo + self.chunk

    def own(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's ``(chunk,)`` slice of a full flat vector."""
        return full[self.lo:self.hi]

    def materialized(self) -> bool:
        return self.flat.untyped_storage().nbytes() > 0

    @torch.no_grad()
    def materialize(self, master: torch.Tensor) -> None:
        """Rebuild the working buffer (and so the model's parameters) from
        every rank's ``master``: one ``all_gather_into_tensor``, a copy at
        one rank. Collective over the group."""
        if not self.materialized():
            self.flat.untyped_storage().resize_(self._nbytes)
        if self.n_shards > 1:
            dist.all_gather_into_tensor(self.flat, master)
        else:
            self.flat.copy_(master)

    @torch.no_grad()
    def release(self, params) -> None:
        """Free the working buffer's storage and the gradients: between
        steps a rank holds its slices and nothing else. The parameters stay
        views of the buffer; reading one before :meth:`materialize` raises.
        ``params`` are the model's parameters in canonical order."""
        for p in params:
            p.grad = None
        if not self.flat.untyped_storage().resizable():
            # a numpy view of a parameter (a CPU tensor's .numpy()) pins its
            # storage: the views move to a fresh buffer, which is released
            self.flat = torch.empty_like(self.flat)
            for p, o in zip(params, self.offsets):
                p.data = self.flat[o:o + p.numel()].view(p.shape)
        self.flat.untyped_storage().resize_(0)

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(chunk,)`` slice as one full ``(n_shards * chunk,)``
        vector on every rank (collective)."""
        if self.n_shards == 1:
            return part.clone()
        out = torch.empty((self.n_shards * self.chunk,), dtype=part.dtype, device=part.device)
        dist.all_gather_into_tensor(out, part.contiguous())
        return out

    def materialize_host(self, master: torch.Tensor) -> dict:
        """A full flat vector (gathered, e.g. a checkpoint's) as the
        parameters by name, port layout: the evaluation and template view."""
        flat = master.detach().cpu()
        return {n: flat[o:o + torch.Size(s).numel()].view(s).clone()
                for n, s, o in zip(self.names, self.shapes, self.offsets)}

    def grad_slice(self, grads) -> torch.Tensor:
        """This rank's ``(chunk,)`` slice of the flat mean gradient (leaves in
        canonical order, port layout), the padding zero: built from the
        pieces of the leaves that overlap the slice, no full flat copy."""
        pieces = []
        lo, hi = self.lo, min(self.hi, self.d_flat)
        for g, o in zip(grads, self.offsets):
            n = g.numel()
            a, b = max(lo, o), min(hi, o + n)
            if a < b:
                pieces.append(g.reshape(-1)[a - o:b - o])
        used = sum(p.numel() for p in pieces)
        if used < self.chunk:
            like = grads[0]
            pieces.append(torch.zeros((self.chunk - used,), dtype=like.dtype, device=like.device))
        return torch.cat(pieces) if len(pieces) > 1 else pieces[0].contiguous()


def chunk_len(flat_size: int, n_shards: int) -> int:
    """Per-rank slice length of the flat sharded buffers. ONE definition
    shared by the allocations here and the step's slices, or every momentum
    slice silently misaligns with its parameter slice."""
    return -(-flat_size // n_shards)


_NOT_SLICEABLE = (
    "sharded update: this optimizer's update is not "
    "slice-invariant (at gradient scale {scale:g}, a sliced "
    "update differs from the slice of the full update — e.g. "
    "a global-norm clip in the chain). Sharding the update "
    "would train silently wrong; use the replicated optimizer "
    "path or an elementwise chain (sgd/momentum/adam/wd).")


@torch.no_grad()
def check_slice_invariant(optimizer: Optimizer, n_shards: int,
                          dtype: torch.dtype = torch.float32) -> None:
    """The validity probe of both partitions: updating a SLICE of the flat
    parameter vector must equal the slice of the full-vector update, true
    for elementwise updates (momentum SGD, Adam, weight decay) and silently
    false for globally mixing ones (a global-norm clip, whose norm would be
    taken per slice). The optimizer runs on a tiny vector, sliced and whole,
    at gradient scales 1, 1e4 and 1e-4 (threshold-gated mixing shows only at
    some magnitudes); a divergence raises the JAX package's message."""
    n = max(int(n_shards), 1)
    probe_n = 8 * n
    gen = torch.Generator().manual_seed(17)
    p_full = torch.randn(probe_n, generator=gen).to(dtype)
    g_base = torch.randn(probe_n, generator=gen).to(dtype)
    chunk = probe_n // n
    for scale in (1.0, 1e4, 1e-4):
        g_full = g_base * scale
        p = p_full.clone()
        optimizer.update([g_full], optimizer.init([p]), [p])
        u_full = p - p_full
        parts = []
        for i in range(n):
            p_i = p_full[i * chunk:(i + 1) * chunk].clone()
            optimizer.update([g_full[i * chunk:(i + 1) * chunk]], optimizer.init([p_i]), [p_i])
            parts.append(p_i - p_full[i * chunk:(i + 1) * chunk])
        ref = torch.cat(parts)
        tol = 1e-5 * float(u_full.abs().max()) + 1e-12
        if not torch.allclose(u_full, ref, rtol=1e-5, atol=tol):
            raise ValueError(_NOT_SLICEABLE.format(scale=scale))


def flat_opt_state(optimizer: Optimizer, chunk: int, device, dtype=torch.float32):
    """ONE construction of the flat sharded optimizer state (shared by
    :func:`zero1_state` and :func:`sharded_update_state`): the optimizer's
    init on this rank's zero ``(chunk,)`` slice (its buffers start at zero,
    its count at 0)."""
    return optimizer.init([torch.zeros((chunk,), dtype=dtype, device=device)])


def _group() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@torch.no_grad()
def _bind_flat(model, chunk: int, n: int, partition: str) -> ShardedUpdateSpecs:
    """Move the model's parameters into one padded flat buffer of the port
    layout (canonical order) and make each a view of it."""
    params = leaf_params(model)
    names = jax_leaf_order(model)
    rank, _ = _group()
    first = params[0]
    flat = torch.zeros((n * chunk,), dtype=first.dtype, device=first.device)
    specs = ShardedUpdateSpecs(n_shards=n, rank=rank, chunk=chunk, names=names,
                               shapes=[p.shape for p in params], flat=flat, partition=partition)
    for p, o in zip(params, specs.offsets):
        view = flat[o:o + p.numel()].view(p.shape)
        view.copy_(p)
        p.data = view
    return specs


def _layout(state: TrainState, optimizer: Optimizer, n: Optional[int]):
    rank, world = _group()
    n = world if n is None else n
    params = leaf_params(state.model)
    d_flat = sum(p.numel() for p in params)
    check_slice_invariant(optimizer, n, params[0].dtype)
    return n, chunk_len(d_flat, n)


def zero1_state(state: TrainState, optimizer: Optimizer) -> tuple[TrainState, ShardedUpdateSpecs]:
    """ZeRO-1 over the process group: the parameters become views of one
    persistent flat buffer (replicated), the optimizer state is this rank's
    flat slice (:func:`flat_opt_state`). Pass ``zero1=specs`` to
    ``make_distributed_train_step``."""
    n, chunk = _layout(state, optimizer, None)
    specs = _bind_flat(state.model, chunk, n, "zero1")
    opt = flat_opt_state(optimizer, chunk, specs.flat.device, specs.flat.dtype)
    return dataclasses.replace(state, opt_state=opt), specs


def sharded_update_state(state: TrainState, optimizer: Optimizer
                         ) -> tuple[ShardedUpdateState, ShardedUpdateSpecs]:
    """The sharded-persistent state of ``state`` (its model's parameters and
    statistics, its step and carry; the optimizer state starts fresh):
    the parameters move into the working buffer, ``master`` is this rank's
    slice of it, the optimizer is initialized on the flat layout as ZeRO-1's.
    Pass ``sharded_update=specs`` to ``make_distributed_train_step``. At one
    rank the chunk is the whole (padded) vector and the gather a copy."""
    n, chunk = _layout(state, optimizer, None)
    specs = _bind_flat(state.model, chunk, n, "sharded-update")
    master = specs.own(specs.flat).clone()
    opt = flat_opt_state(optimizer, chunk, master.device, master.dtype)
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(TrainState)}
    fields.update(opt_state=opt, held=None, residual=None)
    return ShardedUpdateState(**fields, master=master), specs


@torch.no_grad()
def place_sharded_update(state, host: dict, specs: ShardedUpdateSpecs):
    """Copy this rank's slices of a host-side full layout into a live state
    of either partition, in place (a checkpoint restore, a reshard source):
    ``host["master"]`` (sharded update; under ZeRO-1 the parameters come from
    the model's state_dict) and ``host["opt"]``, the optimizer's fields with
    every buffer a full ``(n_shards * chunk,)`` vector. Returns the state
    with the host's step and optimizer count. Resume and fresh init place
    identically, so a restored trajectory continues the uninterrupted one."""
    opt = state.opt_state
    saved = host["opt"]
    for name in [f.name for f in dataclasses.fields(opt)]:
        mine = getattr(opt, name)
        if isinstance(mine, list):
            for t, full in zip(mine, saved[name]):
                t.copy_(specs.own(full.reshape(-1)).to(t.device))
    opt = dataclasses.replace(opt, count=int(saved["count"]))
    out = dataclasses.replace(state, step=int(host["step"]), opt_state=opt, held=None)
    if isinstance(state, ShardedUpdateState):
        out.master.copy_(specs.own(host["master"].reshape(-1)).to(out.master.device))
        specs.materialize(out.master)
    return out


def sharded_state_from_params(state: TrainState, optimizer: Optimizer
                              ) -> tuple[ShardedUpdateState, ShardedUpdateSpecs]:
    """A fresh-momentum sharded state from a state whose model holds the
    parameters and statistics to keep (a replicated checkpoint restored
    into a sharded-update run): the parameters carry over, the optimizer
    state re-initializes sharded, and the caller warns, as the ZeRO-1
    fallback does."""
    return sharded_update_state(state, optimizer)


def gather_host(state, specs: ShardedUpdateSpecs) -> dict:
    """Every rank's slices gathered to full CPU vectors (collective): the
    ``master`` (sharded update only), the optimizer's fields (``count`` and
    each buffer list as full flat vectors), the step and the BatchNorm
    statistics (``buffers``). What a checkpoint holds and a reshard starts
    from."""
    opt = state.opt_state
    out_opt = {}
    for f in dataclasses.fields(opt):
        v = getattr(opt, f.name)
        out_opt[f.name] = ([specs.gather(t).cpu() for t in v] if isinstance(v, list)
                           else v)
    out = {"step": state.step, "opt": out_opt,
           "buffers": {k: v.detach().cpu().clone() for k, v in state.model.named_buffers()}}
    if isinstance(state, ShardedUpdateState):
        out["master"] = specs.gather(state.master).cpu()
    return out

