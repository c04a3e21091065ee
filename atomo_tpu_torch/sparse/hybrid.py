"""Per-layer hybrid exchange plan: sparse rows vs the dense (codec) path.

Counterpart of ``atomo_tpu/sparse/hybrid.py``. The right exchange
representation is a per-leaf decision (Parallax): an embedding table's
gradient is row-sparse, so (row, value) pairs beat any dense form by about
1/density, while the tower's dense gradients keep the compressed
gather/ring path. The selection rule is SparCML's crossover, stated in
every assignment's reason line:

    sparse  iff  B·(c·s + 4) + 4  <  P_codec(leaf)
    i.e.    b = B/R  <  D* = P_codec / (R·(c·s + 4))

with R rows, c columns, s the value itemsize, B = min(R, worst-case touched
rows) the static budget, b the budgeted density and D* the crossover.
Measured density (nonzero rows / R on a probe gradient) rides along; the
assignment keys off the worst-case budget, because losslessness must hold
for every step.

The planner is pure: leaf specs (name, shape, dtype in the JAX layout, the
canonical order), densities and row bounds in, a :class:`HybridPlan` out.
Leaf names are the JAX keystr paths (``convert.jax_leaf_paths``:
``['table']``, ``['Dense_0']['kernel']``), and shapes the JAX layout's, so a
plan's fields and strings read as the JAX package's do. The dense path's
bytes come from the codec's static geometry (``leaf_payload_bytes``),
which is what an encode of the leaf would ship, without encoding.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from atomo_tpu_torch.sparse.rowcodec import RowCodec, row_payload_bytes

# parameter-path substrings that mark a leaf as a lookup table whose per-step
# row support is bounded by batch x slots (a lookup touches at most one row
# per (sample, slot))
TABLE_NAME_HINTS = ("table", "embedding")


class LeafSpec(NamedTuple):
    """One leaf as the planner sees it: its JAX keystr path, its JAX-layout
    shape and its dtype, in the canonical order."""

    name: str
    shape: tuple
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class LeafAssignment:
    """One leaf's exchange decision and the numbers that justify it."""

    index: int  # canonical flatten-order leaf index
    name: str  # jax.tree_util.keystr path
    shape: tuple
    kind: str  # "sparse" | "dense"
    density: float  # measured nonzero-row fraction (1.0 for non-2-D leaves)
    row_budget: int  # static worst-case rows (0 for dense-assigned)
    dense_bytes: int
    codec_payload_bytes: int  # the dense path's wire bytes for this leaf
    payload_bytes: int  # the assigned path's wire bytes
    reason: str


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """The per-leaf partition that ``make_distributed_train_step(hybrid=...)``
    runs. ``dense_idxs`` ascends, so the dense-assigned encode
    (``encode_leaf_subset``, global leaf keys) gives the payloads of the
    all-dense run for those leaves."""

    assignments: tuple

    @property
    def sparse_idxs(self) -> tuple:
        return tuple(a.index for a in self.assignments if a.kind == "sparse")

    @property
    def dense_idxs(self) -> tuple:
        return tuple(a.index for a in self.assignments if a.kind == "dense")

    @property
    def n_leaves(self) -> int:
        return len(self.assignments)

    @property
    def any_sparse(self) -> bool:
        return any(a.kind == "sparse" for a in self.assignments)

    def row_codec(self, index: int) -> RowCodec:
        a = self.assignments[index]
        if a.kind != "sparse":
            raise ValueError(f"leaf {index} ({a.name}) is dense-assigned")
        return RowCodec(max_rows=a.row_budget)

    def payload_bytes(self) -> int:
        """Wire bytes per replica under this plan: the step's ``msg_bytes``."""
        return int(sum(a.payload_bytes for a in self.assignments))

    def leaf_budgets(self) -> list:
        """Per-leaf ``(dense_bytes, payload_bytes)`` in canonical order."""
        return [(int(a.dense_bytes), int(a.payload_bytes)) for a in self.assignments]

    def describe(self) -> str:
        s = self.sparse_idxs
        return (
            f"hybrid plan: {len(s)}/{self.n_leaves} leaves sparse-row, "
            f"{self.payload_bytes() / 1e6:.3f} MB/replica on the wire vs "
            f"{sum(a.codec_payload_bytes for a in self.assignments) / 1e6:.3f}"
            " MB all-dense-assigned"
        )


def leaf_specs(model: torch.nn.Module) -> list[LeafSpec]:
    """The model's leaves as :class:`LeafSpec` s, canonical order."""
    from atomo_tpu_torch.convert import jax_layouts, jax_leaf_paths, jax_view
    from atomo_tpu_torch.training.trainer import leaf_params

    return [LeafSpec(name, tuple(jax_view(p.detach(), tr).shape), p.dtype)
            for name, p, tr in zip(jax_leaf_paths(model), leaf_params(model),
                                   jax_layouts(model))]


def measured_densities(grads: Sequence[torch.Tensor],
                       layouts: Optional[Sequence[bool]] = None) -> list:
    """Per-leaf nonzero-row fraction of a gradient list (canonical order,
    port layout; ``layouts`` as for ``codecs.encode_tree``), each leaf read
    in the JAX layout; non-2-D leaves report 1.0. Call it on a probe
    gradient (:func:`probe_gradient`), never inside the step."""
    from atomo_tpu_torch.convert import jax_view

    out = []
    for i, g in enumerate(grads):
        v = jax_view(g.detach(), True if layouts is None else layouts[i])
        if v.dim() != 2 or v.shape[0] == 0:
            out.append(1.0)
            continue
        nnz = int((v != 0).any(dim=1).sum())
        out.append(nnz / v.shape[0])
    return out


def probe_gradient(model: torch.nn.Module, images, labels,
                   state_dict: Optional[dict] = None) -> list[torch.Tensor]:
    """One backward pass over a fixed batch on a copy of ``model``: the
    measured-density probe. The copy starts from ``state_dict`` where given,
    else from ``init_params`` with seed 0 (the JAX package's probe inits its
    own parameters too); its dropout draws under key 0. Feed a batch that
    does not advance the training stream (slice ``train_iter.images``).
    Returns the gradients in the canonical order, port layout, on the CPU."""
    from atomo_tpu_torch.data.pipeline import to_device
    from atomo_tpu_torch.models.dropout import dropout_stream
    from atomo_tpu_torch.training.trainer import init_params, leaf_params

    probe = copy.deepcopy(model).cpu()
    if state_dict is not None:
        probe.load_state_dict(state_dict)
    else:
        init_params(probe, 0)
    probe.train()
    x, y = to_device(np.asarray(images), np.asarray(labels), "cpu")
    with dropout_stream(0):
        loss = torch.nn.functional.cross_entropy(probe(x), y)
    return [g.detach() for g in torch.autograd.grad(loss, leaf_params(probe))]


def infer_row_bounds(specs: Sequence[LeafSpec], batch_per_chip: int, slots: int,
                     hints=TABLE_NAME_HINTS) -> list:
    """Per-leaf worst-case touched-row bound, canonical order: a 2-D leaf
    whose path names a lookup table (``hints`` substring match) is touched
    on at most ``batch_per_chip x slots`` rows a step; every other leaf gets
    ``None`` (no provable bound, never sparse-assignable)."""
    cap = max(int(batch_per_chip), 1) * max(int(slots), 1)
    out = []
    for s in specs:
        name = s.name.lower()
        if len(s.shape) == 2 and any(h in name for h in hints):
            out.append(min(int(s.shape[0]), cap))
        else:
            out.append(None)
    return out


def plan_hybrid(codec, specs: Sequence[LeafSpec], densities, row_bounds) -> HybridPlan:
    """The pure per-leaf partitioner (module docstring formula). ``specs``,
    ``densities`` and ``row_bounds`` are canonical-order lists of one tree
    (:func:`leaf_specs`, :func:`measured_densities`,
    :func:`infer_row_bounds`); ``row_bounds[i] is None`` means dense."""
    if not (len(specs) == len(densities) == len(row_bounds)):
        raise ValueError(
            f"plan_hybrid: {len(specs)} leaves vs {len(densities)} "
            f"densities vs {len(row_bounds)} row bounds — all three must "
            "come from the same tree in canonical order"
        )
    entries = []
    for i, spec in enumerate(specs):
        name = spec.name
        shape = tuple(int(d) for d in spec.shape)
        itemsize = torch.empty((), dtype=spec.dtype).element_size()
        dense_b = int(np.prod(shape or (1,))) * itemsize
        codec_b = int(codec.leaf_payload_bytes(shape))  # the dense path's wire
        bound = row_bounds[i]
        d = float(densities[i])
        if bound is not None and len(shape) == 2 and shape[0] > 0:
            r, c = shape
            budget = min(int(bound), r)
            sparse_b = row_payload_bytes(budget, c, itemsize)
            b_density = budget / r
            d_star = codec_b / (r * (c * itemsize + 4))
            if sparse_b < codec_b:
                entries.append(LeafAssignment(
                    index=i, name=name, shape=shape, kind="sparse",
                    density=d, row_budget=budget, dense_bytes=dense_b,
                    codec_payload_bytes=codec_b, payload_bytes=sparse_b,
                    reason=(
                        f"sparse: B={budget} rows x ({c}x{itemsize}+4) B "
                        f"= {sparse_b} B < {codec_b} B dense-path payload "
                        f"(SparCML crossover: budget density b=B/R="
                        f"{b_density:.4g} < D*=P/(R(c*s+4))={d_star:.4g}; "
                        f"measured density {d:.4g})"
                    ),
                ))
                continue
            entries.append(LeafAssignment(
                index=i, name=name, shape=shape, kind="dense",
                density=d, row_budget=0, dense_bytes=dense_b,
                codec_payload_bytes=codec_b, payload_bytes=codec_b,
                reason=(
                    f"dense: B={budget} rows would cost {sparse_b} B >= "
                    f"{codec_b} B dense-path payload (budget density "
                    f"b={b_density:.4g} >= crossover D*={d_star:.4g})"
                ),
            ))
            continue
        entries.append(LeafAssignment(
            index=i, name=name, shape=shape, kind="dense",
            density=d, row_budget=0, dense_bytes=dense_b,
            codec_payload_bytes=codec_b, payload_bytes=codec_b,
            reason="dense: no provable per-step row bound (not a table "
                   "leaf) — sparse rows would be lossy, rejected",
        ))
    return HybridPlan(assignments=tuple(entries))


def plan_for_model(codec, model: torch.nn.Module, images, labels, batch_per_chip: int,
                   slots: int, state_dict: Optional[dict] = None) -> HybridPlan:
    """Probe gradient -> measured densities + inferred bounds ->
    :func:`plan_hybrid`, the composition the CLI runs."""
    from atomo_tpu_torch.convert import jax_layouts

    grads = probe_gradient(model, images, labels, state_dict)
    specs = leaf_specs(model)
    return plan_hybrid(codec, specs, measured_densities(grads, jax_layouts(model)),
                       infer_row_bounds(specs, batch_per_chip, slots))
