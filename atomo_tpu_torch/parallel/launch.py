"""Process-group launch: one process per device over ``torch.distributed``.

Counterpart of ``atomo_tpu/parallel/launch.py:30 initialize``. The JAX
package runs one process per host and addresses every chip from it; the
port runs one process per device, as ``torchrun`` starts them, and brings
up a ``torch.distributed`` process group among them:

* from the standard environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR`` / ``MASTER_PORT``, ``LOCAL_RANK``), or from an explicit
  ``init_method`` (a ``file://`` store, which the tests use, or
  ``tcp://localhost:<port>``) with ``world_size`` and ``rank``;
* the backend follows the device, ``nccl`` for CUDA and ``gloo`` for the
  CPU, unless the caller names one (two processes on one card must share
  it over ``gloo``: NCCL refuses two ranks on one device);
* with one process and nothing that asks for a group, it brings up nothing,
  as the reference does on one host;
* the reference's retry with exponential backoff on connection failures
  (``attempts``, ``backoff``) and its per-attempt ``init_timeout``.

For the LM's dp x sp layouts, :func:`dp_sp_mesh` builds the process
groups of a (dp, sp) mesh over the world: rank ``r`` is mesh position
``(r // sp, r % sp)``, the row-major device order of the JAX package's
``MeshSpec.from_layout`` / ``make_mesh``, with one sp group per dp row (the
sequence shards of one replica) and one dp group per sp column (the replicas
that exchange gradients).

One device per process. Each rank binds its device (``cuda:LOCAL_RANK``
unless the caller names one) with ``torch.cuda.set_device`` before any
kernel launches, and the binding is checked: a process that binds a second,
different device raises. The kernels' launch helpers keep caches per
process, not per device (the pack grid in ``csrc/qsgd_kernels.cu
pack_grid``, the shared-memory attribute in ``csrc/flash_attention.cu
launch``), which this invariant makes right.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import time
from typing import Optional, Union

import torch
import torch.distributed as dist

from atomo_tpu_torch.utils.device import resolve_device

Device = Union[str, torch.device]
_CONNECT_ERRORS = (RuntimeError, ConnectionError, OSError, TimeoutError)


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Where this process stands: its rank, the world's size, its device,
    and the backend of its group (None when no group was brought up)."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str]


class DeviceBinding:
    """The one device a process runs its kernels on. The kernels' launch
    helpers cache per process, so a process binds one device and keeps it."""

    def __init__(self):
        self.device: Optional[torch.device] = None

    def bind(self, device: torch.device) -> torch.device:
        if device.type == "cuda" and device.index is None:
            raise ValueError("bind a CUDA device by index (cuda:N)")
        if self.device is not None and self.device != device:
            raise RuntimeError(
                f"this process already runs on {self.device}; the port runs one device "
                f"per process (the kernels' launch caches are per process), so it "
                f"cannot also run on {device}")
        self.device = device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return device


# The process's binding: the kernels' caches it guards are the process's too.
PROCESS_DEVICE = DeviceBinding()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _with_retries(fn, attempts: int, backoff: float):
    for i in range(1, max(attempts, 1) + 1):
        try:
            return fn()
        except _CONNECT_ERRORS as exc:
            if i >= attempts:
                raise
            print(f"torch.distributed.init_process_group failed (attempt {i}): {exc}; "
                  "retrying", file=sys.stderr, flush=True)
            time.sleep(backoff * 2 ** (i - 1))
    return None


def initialize(
    device: Optional[Device] = None,
    *,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    attempts: int = 3,
    backoff: float = 1.0,
    init_timeout: Optional[float] = None,
) -> DistContext:
    """Bring up this process's group and bind its device; returns its
    :class:`DistContext`.

    ``device`` "cuda" (the default) binds ``cuda:LOCAL_RANK``, "cpu" the CPU,
    "cuda:i" that card. ``world_size``, ``rank`` and ``local_rank`` default
    from ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; ``init_method`` from
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``). A group that is already
    up is kept (the call is idempotent). Connection failures retry
    ``attempts`` times with exponential backoff (``backoff`` base seconds);
    ``init_timeout`` (seconds) bounds each attempt's rendezvous, and the
    group's collectives after it."""
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank or 0)
    PROCESS_DEVICE.bind(dev)
    if dist.is_initialized():
        return DistContext(dist.get_rank(), dist.get_world_size(), dev, dist.get_backend())
    if init_method is None and (world_size or 1) == 1 and "MASTER_ADDR" not in os.environ:
        return DistContext(0, 1, dev, None)  # one process: no group
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = dict(backend=backend, init_method=init_method or "env://",
              world_size=world_size if world_size is not None else 1,
              rank=rank if rank is not None else 0)
    if init_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=max(1.0, float(init_timeout)))
    if backend == "nccl":
        kw["device_id"] = dev  # binds NCCL's communicator to this rank's card
    _with_retries(lambda: dist.init_process_group(**kw), attempts, backoff)
    return DistContext(dist.get_rank(), dist.get_world_size(), dev, backend)


@dataclasses.dataclass(frozen=True)
class DpSpMesh:
    """This process's place in a (dp, sp) mesh of processes: its replica
    (``rank_dp`` of ``n_dp``) and sequence shard (``rank_sp`` of ``n_sp``),
    and the process groups of its dp column and sp row. A group is None
    only where no process group is up (one device, ``n_dp = n_sp = 1``);
    a group that spans the world is the world's group."""

    n_dp: int = 1
    n_sp: int = 1
    rank_dp: int = 0
    rank_sp: int = 0
    dp_group: Optional[object] = None
    sp_group: Optional[object] = None

    def describe(self) -> str:
        """The JAX package's ``MeshSpec.describe()``: ``dp2xsp2``."""
        return f"dp{self.n_dp}xsp{self.n_sp}"


def mesh_position(rank: int, n_sp: int) -> tuple[int, int]:
    """Rank ``rank``'s (dp, sp) position: row-major, as ``make_mesh`` lays
    the devices of a (dp, sp) mesh out."""
    return rank // n_sp, rank % n_sp


def dp_sp_mesh(n_sp: int = 1) -> DpSpMesh:
    """The (world / n_sp, n_sp) mesh over the process group that is up, or
    the one-device mesh when none is. Every rank creates every subgroup, in
    the same order (``torch.distributed.new_group`` is collective over the
    world): the sp groups of dp rows 0, 1, ..., then the dp groups of sp
    columns 0, 1, .... At ``n_sp = 1`` the dp group is the world's."""
    if not dist.is_initialized():
        if n_sp != 1:
            raise ValueError(f"an sp axis of {n_sp} needs a process group of one "
                             "process per device; none is up")
        return DpSpMesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_sp < 1 or world % n_sp:
        raise ValueError(f"sp ways {n_sp} does not divide {world} devices")
    n_dp = world // n_sp

    def group(ranks: list[int]):
        # the world's own group for a group of every rank (one communicator)
        return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)

    d, s = mesh_position(rank, n_sp)
    sp_groups = [group([r * n_sp + c for c in range(n_sp)]) for r in range(n_dp)]
    dp_groups = [group([r * n_sp + c for r in range(n_dp)]) for c in range(n_sp)]
    return DpSpMesh(n_dp, n_sp, d, s, dp_groups[s], sp_groups[d])


def shutdown() -> None:
    """Tear down this process's group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
