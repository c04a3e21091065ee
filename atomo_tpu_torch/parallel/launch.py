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

Failure detection (``atomo_tpu/parallel/launch.py:150-244``): the train
loops ``beat()`` a :class:`HealthMonitor` after every step (every block under
``--superstep``), and a :class:`HealthWatchdog` thread checks it. When the
heartbeat stops, the default failure path prints the diagnosis, interrupts
the main thread (a SIGINT, so a blocking call returns and the
``KeyboardInterrupt`` it raises becomes exit 13 at the process entry), and, should the main thread not return
within a grace period (a collective or a graph replay that never ends runs
no bytecode), hard-exits with 13 so a scheduler sees a dead process.

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
import threading
import time
from typing import Callable, Optional, Union

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
    the one-device mesh when none is: :meth:`~atomo_tpu_torch.mesh.spec.
    MeshSpec.build` over ``(dp, sp)``, which creates on every rank, in the
    same order, the sp groups of dp rows 0, 1, ..., then the dp groups of
    sp columns 0, 1, .... At ``n_sp = 1`` the dp group is the world's."""
    from atomo_tpu_torch.mesh.spec import MeshSpec

    if not dist.is_initialized():
        if n_sp != 1:
            raise ValueError(f"an sp axis of {n_sp} needs a process group of one "
                             "process per device; none is up")
        return DpSpMesh()
    world = dist.get_world_size()
    if n_sp < 1 or world % n_sp:
        raise ValueError(f"sp ways {n_sp} does not divide {world} devices")
    m = MeshSpec((("dp", world // n_sp), ("sp", n_sp))).build()
    return DpSpMesh(m.n_dp, n_sp, m.index("dp"), m.index("sp"), m.group("dp"), m.group("sp"))


def shutdown() -> None:
    """Tear down this process's group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


class HealthMonitor:
    """Step-heartbeat failure detector: ``beat(step)`` after every
    completed step; ``check()`` raises ``RuntimeError`` once no beat came
    for ``timeout`` seconds."""

    def __init__(self, timeout: float = 300.0):
        self.timeout = timeout
        self._last = time.monotonic()
        self._last_step = -1

    def beat(self, step: int) -> None:
        self._last = time.monotonic()
        self._last_step = step

    def check(self) -> None:
        silent = time.monotonic() - self._last
        if silent > self.timeout:
            raise RuntimeError(
                f"no training heartbeat for {silent:.0f}s "
                f"(last completed step {self._last_step}); "
                "restart from the latest checkpoint")


_EXIT_GRACE_S = 30.0
WATCHDOG_EXIT_CODE = 13
# set when the default failure path fired: the process entry turns the
# KeyboardInterrupt it sent into the watchdog's exit code
WATCHDOG_FIRED = threading.Event()


def _default_failure(exc: RuntimeError) -> None:
    """Print the diagnosis, interrupt the main thread, and hard-exit with
    13 after a grace period: a main thread inside a collective or a graph
    replay that never returns runs no bytecode, so the interrupt alone
    would leave the process hung."""
    import signal

    print(f"HealthWatchdog: {exc}", file=sys.stderr, flush=True)
    WATCHDOG_FIRED.set()
    # a real SIGINT to the main thread (not _thread.interrupt_main, which
    # only sets a flag): a blocking sleep or wait returns with EINTR and the
    # KeyboardInterrupt is raised at once
    signal.pthread_kill(threading.main_thread().ident, signal.SIGINT)
    time.sleep(_EXIT_GRACE_S)
    print(f"HealthWatchdog: main thread did not exit within {_EXIT_GRACE_S}s "
          "of interrupt (hung collective?); hard-exiting for scheduler restart",
          file=sys.stderr, flush=True)
    os._exit(WATCHDOG_EXIT_CODE)


class HealthWatchdog:
    """A daemon thread that calls ``monitor.check()`` every ``interval``
    seconds and ``on_failure(exc)`` (default: :func:`_default_failure`)
    when the heartbeat stopped."""

    def __init__(self, monitor: HealthMonitor, interval: float = 10.0,
                 on_failure: Optional[Callable[[RuntimeError], None]] = None):
        self.monitor = monitor
        self.interval = interval
        self.on_failure = on_failure or _default_failure
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HealthWatchdog":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.monitor.check()
            except RuntimeError as exc:
                self._fired.set()
                self.on_failure(exc)
                return

    def stop(self) -> None:
        self._stop.set()
        # a fired watchdog sits in its grace period: the process is ending
        if self._thread is not None and not self._fired.is_set():
            self._thread.join(timeout=5.0)
