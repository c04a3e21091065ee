"""The mesh grammar of the LM layouts, over process groups.

Counterpart of ``atomo_tpu/mesh/spec.py:36-250``: :class:`MeshSpec` names
the axes of a mesh (``dp`` first, then the model axes of a ``--layout``)
and renders them as the JAX package does (``describe``: ``dp2xtp2``,
``dp2xici2``; ``layout_name``: ``dp-tp``). Its ``from_layout`` and
``from_world`` (the data-parallel mesh of ``--n-devices`` and
``--dcn-ways``: ``dpN`` flat, ``dpK x ici(N/K)`` two-tier) raise the same
``ValueError`` s.

The JAX package builds a ``jax.sharding.Mesh`` over the chips of its
processes; the port runs one process per device, so :meth:`MeshSpec.build`
places this process on the mesh and makes one process group per axis line
over the world: rank ``r`` is the mesh position of ``r`` in row-major
order over the axes (``make_mesh``'s device order), and the group of axis
``a`` holds the ranks that differ from it only along ``a``. Every rank
creates every group, in the same order (``new_group`` is collective over
the world): the innermost axis first, its lines in row-major order of the
other coordinates, then the next axis out. A line that spans the world is
the world's own group. :func:`atomo_tpu_torch.parallel.launch.dp_sp_mesh`
is this builder over ``(dp, sp)``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch.distributed as dist

#: Model axes the layout grammar understands, in layout-name order. They
#: shard the model (or the sequence), not the replicas: gradients are
#: completed across them before the dp exchange.
MODEL_AXES = ("tp", "pp", "ep", "sp")

#: ``lm --layout`` -> the model axes it adds after ``dp``.
LAYOUT_MODEL_AXES = {
    "dp": (),
    "dp-sp": ("sp",),
    "dp-tp": ("tp",),
    "dp-ep": ("ep",),
    "dp-pp": ("pp",),
    "dp-tp-sp": ("tp", "sp"),
}


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's place on a built :class:`MeshSpec`: per axis, its
    size, this rank's index and the process group of its line (None where
    no process group is up: one device). ``n_dp``/``rank_dp``/``dp_group``
    are what the dp exchange reads."""

    spec: "MeshSpec"
    coords: tuple[int, ...]
    groups: tuple[Optional[object], ...]

    def size(self, axis: str) -> int:
        return dict(self.spec.axes).get(axis, 1)

    def index(self, axis: str) -> int:
        names = self.spec.names
        return self.coords[names.index(axis)] if axis in names else 0

    def group(self, axis: str):
        names = self.spec.names
        return self.groups[names.index(axis)] if axis in names else None

    @property
    def n_dp(self) -> int:
        """The ``dp`` axis alone: on a two-tier mesh the OUTER groups, not
        the data-parallel world (which is ``n_dp * size("ici")``)."""
        return self.size("dp")

    @property
    def rank_dp(self) -> int:
        return self.index("dp")

    @property
    def dp_group(self):
        return self.group("dp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """An ordered tuple of named mesh axes, e.g. ``(("dp", 2), ("tp", 2))``."""

    axes: tuple[tuple[str, int], ...]

    def __post_init__(self):
        if not self.axes:
            raise ValueError("MeshSpec needs at least one axis")
        names = [a for a, _ in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names: {names}")
        for name, size in self.axes:
            if size < 1:
                raise ValueError(f"mesh axis {name!r} has size {size}")

    @classmethod
    def from_world(cls, n_devices: int, dcn_ways: int = 0) -> "MeshSpec":
        """(``--n-devices``, ``--dcn-ways``) -> the data-parallel mesh:
        ``dpN`` flat (``dcn_ways`` <= 1), or the two-tier ``dpK x ici(N/K)``
        of the hierarchical schedules, K dividing N."""
        n = int(n_devices)
        k = int(dcn_ways)
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n}")
        if k > 1:
            if n % k or not 1 < k <= n:
                raise ValueError(
                    f"dcn_ways {k} must divide n_devices {n} "
                    "(outer slow-fabric groups x inner fast-fabric chips)"
                )
            return cls((("dp", k), ("ici", n // k)))
        return cls((("dp", n),))

    @classmethod
    def from_shape_dict(cls, d) -> Optional["MeshSpec"]:
        """Inverse of :meth:`shape_dict` (its key order is the axis order);
        None for a missing, empty or malformed document."""
        if not isinstance(d, dict) or not d:
            return None
        try:
            return cls(tuple((str(k), int(v)) for k, v in d.items()))
        except (TypeError, ValueError):
            return None

    @classmethod
    def from_layout(cls, layout: str, n_devices: int, ways=1) -> "MeshSpec":
        """(``--layout``, ``--ways``) -> the mesh: ``dp`` is ``(dp=N,
        sp=1)``, a 2-D layout ``(dp=N/ways, <axis>=ways)``, and ``dp-tp-sp``
        takes ``ways`` as a ``(tp, sp)`` pair. The model ways must divide
        the device count."""
        if layout not in LAYOUT_MODEL_AXES:
            raise ValueError(
                f"unknown layout {layout!r}; expected one of "
                f"{sorted(LAYOUT_MODEL_AXES)}"
            )
        n = int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n}")
        model = LAYOUT_MODEL_AXES[layout]
        if layout == "dp-tp-sp":
            try:
                tp_ways, sp_ways = (int(w) for w in ways)
            except TypeError:
                raise ValueError(
                    "layout 'dp-tp-sp' takes ways as a (tp, sp) pair"
                ) from None
            sizes = (tp_ways, sp_ways)
        else:
            sizes = (int(ways),) * len(model)
        m = 1
        for s in sizes:
            if s < 1:
                raise ValueError(f"model ways must be >= 1, got {s}")
            m *= s
        if n % m:
            raise ValueError(
                f"model ways {m} (layout {layout!r}) does not divide "
                f"{n} devices"
            )
        if layout == "dp":
            return cls((("dp", n), ("sp", 1)))
        return cls((("dp", n // m),) + tuple(zip(model, sizes)))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    @property
    def data_axes(self) -> tuple[str, ...]:
        """The axes the batch spans: ``("dp",)`` flat, ``("dp", "ici")``
        two-tier."""
        return tuple(n for n in self.names if n in ("dp", "ici"))

    @property
    def inner_axis(self) -> Optional[str]:
        return "ici" if "ici" in self.names else None

    @property
    def is_two_tier(self) -> bool:
        return self.inner_axis is not None

    @property
    def model_axes(self) -> tuple[tuple[str, int], ...]:
        """The non-data axes with their sizes, in mesh order (size-1 axes
        included)."""
        return tuple((n, s) for n, s in self.axes if n not in ("dp", "ici"))

    def shape_dict(self) -> dict:
        """The artifact form, ``{"dp": K, "sp": M}`` in mesh order (the
        ``model_axes`` meta record of ``lm``'s ``metrics.jsonl``)."""
        return {name: size for name, size in self.axes}

    def describe(self) -> str:
        """``dp4``, ``dp2xtp2``: the string the log lines print."""
        return "x".join(f"{n}{s}" for n, s in self.axes)

    def layout_name(self) -> str:
        """The ``--layout`` this shape answers to, up to size-1 model axes
        (``dp4 x sp1`` is ``dp``). Raises for shapes outside the grammar."""
        live = tuple(n for n, s in self.model_axes if s > 1)
        name = "-".join(("dp",) + live)
        if "ici" in self.names or name not in LAYOUT_MODEL_AXES:
            raise ValueError(
                f"mesh shape {self.describe()} is not an LM model-axis "
                f"layout (grammar: {sorted(LAYOUT_MODEL_AXES)})"
            )
        return name

    def position(self, rank: int) -> tuple[int, ...]:
        """Rank ``rank``'s coordinates, row-major over the axes."""
        coords = []
        for _, s in reversed(self.axes):
            coords.append(rank % s)
            rank //= s
        return tuple(reversed(coords))

    def rank_of(self, coords) -> int:
        r = 0
        for c, (_, s) in zip(coords, self.axes):
            r = r * s + c
        return r

    def build(self) -> ProcessMesh:
        """This process's :class:`ProcessMesh` over the process group that
        is up (one group per axis line, made on every rank in the order the
        module docstring gives), or the one-device mesh when none is."""
        if not dist.is_initialized():
            if self.n_devices != 1:
                raise ValueError(f"a {self.describe()} mesh needs a process group of "
                                 f"{self.n_devices} processes, one per device; none is up")
            return ProcessMesh(self, (0,) * len(self.axes), (None,) * len(self.axes))
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != self.n_devices:
            raise ValueError(f"a {self.describe()} mesh needs {self.n_devices} processes; "
                             f"this group has {world}")
        mine = self.position(rank)
        groups: list = [None] * len(self.axes)
        for a in reversed(range(len(self.axes))):
            others = [range(s) for i, (_, s) in enumerate(self.axes) if i != a]
            for rest in itertools.product(*others):
                ranks = []
                for c in range(self.axes[a][1]):
                    coords = list(rest)
                    coords.insert(a, c)
                    ranks.append(self.rank_of(coords))
                g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                if rank in ranks:
                    groups[a] = g
        return ProcessMesh(self, mine, tuple(groups))
