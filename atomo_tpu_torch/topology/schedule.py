"""Deterministic cost-driven planner for two-level aggregation schedules.

Counterpart of ``atomo_tpu/topology/schedule.py``, whole: pure Python over
the port's ``utils.comm_model`` wire formulas and anchors. The legacy
``--aggregate hierarchical`` is one plan (a dense mean over the fast tier,
one factor all_gather over the slow one); this module makes it a point of a
plan space and picks the plan per (model, mesh, codec, fabric).

An :class:`AggregationPlan` is (inner primitive, outer primitive):

  inner ``psum``   dense all-reduce over the fast tier (the legacy inner).
  inner ``cring``  compressed ring over the fast tier: each card encodes its
                   RAW gradient under its own key and the payloads rotate
                   through ``parallel.replicated.ring_stream_mean``.
  outer ``gather`` boundary re-encode + payload all_gather across the slow
                   tier (the legacy outer under a psum inner).
  outer ``ring``   boundary re-encode + the ring's streamed exchange across
                   the slow tier.
  outer ``psum``   DENSE all-reduce across the slow tier: the SparCML
                   representation switch, once the payload's all_gather
                   would move as many bytes as the dense all-reduce
                   (:func:`dense_outer_wins`).

Between the tiers sits the boundary RE-ENCODE: the inner-reduced gradient is
compressed again under a fresh outer key. Each stage is an unbiased
estimator of its input's mean and the key streams are disjoint
(``topology.execute``'s sentinels), so the two-level estimate is unbiased by
composition (Monte-Carlo-tested per codec). ``(psum, psum)`` is left out: it
is the flat dense all-reduce of ``--aggregate psum``.

:func:`choose_plan` is a pure function of the byte budget and the
:class:`~atomo_tpu_torch.topology.fabric.TwoTierFabric`, ties broken by
name. Its predictions use the card's stated anchors and only order the
plans.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from atomo_tpu_torch.topology.fabric import TwoTierFabric
from atomo_tpu_torch.utils.comm_model import (
    estimate_codec_tax_s,
    estimate_compute_s,
    ring_allgather_wire_bytes,
    ring_allreduce_wire_bytes,
    ring_stream_wire_bytes,
)

INNER_PRIMITIVES = ("psum", "cring")
OUTER_PRIMITIVES = ("gather", "ring", "psum")


@dataclasses.dataclass(frozen=True)
class AggregationPlan:
    """One point in the two-level schedule space: ``inner`` primitive over
    the fast tier, ``outer`` primitive over the slow tier (module
    docstring for the vocabulary). ``reencodes`` says whether the plan
    performs the boundary re-encode (every compressed outer does; a dense
    outer ships the inner-reduced gradient as-is)."""

    inner: str
    outer: str

    def __post_init__(self):
        if self.inner not in INNER_PRIMITIVES:
            raise ValueError(
                f"unknown inner primitive {self.inner!r}; "
                f"expected one of {INNER_PRIMITIVES}"
            )
        if self.outer not in OUTER_PRIMITIVES:
            raise ValueError(
                f"unknown outer primitive {self.outer!r}; "
                f"expected one of {OUTER_PRIMITIVES}"
            )
        if self.inner == "psum" and self.outer == "psum":
            raise ValueError(
                "plan psum+psum telescopes to the flat dense all-reduce; "
                "use aggregate='psum' instead"
            )

    @property
    def name(self) -> str:
        return f"{self.inner}+{self.outer}"

    @property
    def is_legacy(self) -> bool:
        return self == LEGACY_PLAN

    @property
    def reencodes(self) -> bool:
        """True when the plan re-compresses at the boundary (compressed
        outer). With a dense inner this is the plan's ONLY encode — the
        legacy single draw; with a compressed inner it is a genuine
        second draw over the inner estimate."""
        return self.outer in ("gather", "ring")


# the plan the pre-topology `--aggregate hierarchical` hard-coded
LEGACY_PLAN = AggregationPlan("psum", "gather")

PLAN_NAMES = tuple(
    AggregationPlan(i, o).name
    for i in INNER_PRIMITIVES
    for o in OUTER_PRIMITIVES
    if not (i == "psum" and o == "psum")
)


def plan_from_name(name: str) -> AggregationPlan:
    """Inverse of ``AggregationPlan.name`` (+ the ``legacy`` alias); the
    CLI's ``--plan`` and the decision artifact both speak this string."""
    if name == "legacy":
        return LEGACY_PLAN
    inner, sep, outer = name.partition("+")
    if not sep:
        raise ValueError(
            f"unknown plan {name!r}; expected 'legacy' or one of "
            f"{', '.join(PLAN_NAMES)}"
        )
    return AggregationPlan(inner, outer)


def enumerate_plans(plan_names=None) -> list[AggregationPlan]:
    """The plan space, deterministic order (``plan_names`` narrows it)."""
    names = PLAN_NAMES if plan_names is None else tuple(plan_names)
    return [plan_from_name(n) for n in names]


def dense_outer_wins(
    payload_bytes: float, dense_bytes: float, outer_ways: int
) -> bool:
    """The SparCML representation switch, as the comm model prices it:
    ship the boundary DENSE once the compressed exchange would move at
    least as many bytes over the slow tier — payload all_gather
    P*(K-1) vs dense all-reduce 2*D*(K-1)/K, i.e. density has crossed
    P >= 2D/K. (The planner does not special-case this rule: the dense-
    outer plans are priced like every other candidate and win exactly in
    this regime; the helper states the crossover for advisories/tests.)"""
    k = max(int(outer_ways), 2)
    return ring_allgather_wire_bytes(
        payload_bytes, k
    ) >= ring_allreduce_wire_bytes(dense_bytes, k)


def plan_wire_bytes(
    plan: AggregationPlan,
    *,
    dense_bytes: float,
    payload_bytes: float,
    fabric: TwoTierFabric,
) -> dict:
    """Per-chip per-TIER wire bytes of one plan — the honest-accounting
    formulas of utils/comm_model applied tier by tier. Returns
    ``{"inner_bytes", "outer_bytes", "inner_hops", "outer_hops"}`` (hops =
    serialized collective rounds for the latency floor)."""
    n_in, k = fabric.inner_ways, fabric.outer_ways
    if plan.inner == "psum":
        inner_b = ring_allreduce_wire_bytes(dense_bytes, n_in)
        inner_h = 2 * (n_in - 1)
    else:  # cring: N-1 payload hops + the segment all_gather (PR-3 rule)
        inner_b = ring_stream_wire_bytes(payload_bytes, dense_bytes, n_in)
        inner_h = 2 * (n_in - 1)
    if plan.outer == "gather":
        outer_b = ring_allgather_wire_bytes(payload_bytes, k)
        outer_h = k - 1
    elif plan.outer == "ring":
        outer_b = ring_stream_wire_bytes(payload_bytes, dense_bytes, k)
        outer_h = 2 * (k - 1)
    else:  # dense fallback across the slow tier
        outer_b = ring_allreduce_wire_bytes(dense_bytes, k)
        outer_h = 2 * (k - 1)
    return {
        "inner_bytes": inner_b,
        "outer_bytes": outer_b,
        "inner_hops": inner_h,
        "outer_hops": outer_h,
    }


def predict_plan_step_s(
    plan: AggregationPlan,
    *,
    dense_bytes: float,
    payload_bytes: float,
    fabric: TwoTierFabric,
    compute_s: Optional[float] = None,
    tax_s: Optional[float] = None,
    dispatch_s: float = 0.0,
    superstep: int = 1,
) -> float:
    """Model one plan's synchronous step time (seconds): compute + the
    per-tier comm terms + one codec round-trip tax per compression STAGE
    (inner cring and the boundary re-encode each pay one; the anchors are
    the same stated estimates ``comm_model.predict_step_s`` uses, and the
    measured probe ladder corrects them)."""
    dense_bytes = float(dense_bytes)
    if compute_s is None:
        compute_s = estimate_compute_s(dense_bytes)
    if tax_s is None:
        tax_s = estimate_codec_tax_s(dense_bytes)
    wires = plan_wire_bytes(
        plan,
        dense_bytes=dense_bytes,
        payload_bytes=payload_bytes,
        fabric=fabric,
    )
    t = compute_s + dispatch_s / max(int(superstep), 1)
    t += fabric.tier_time_s(wires["inner_bytes"], "inner", wires["inner_hops"])
    t += fabric.tier_time_s(wires["outer_bytes"], "outer", wires["outer_hops"])
    stages = (1 if plan.inner == "cring" else 0) + (1 if plan.reencodes else 0)
    t += stages * tax_s
    return t


def choose_plan(
    *,
    dense_bytes: float,
    payload_bytes: float,
    fabric: TwoTierFabric,
    compute_s: Optional[float] = None,
    tax_s: Optional[float] = None,
    plan_names=None,
) -> tuple[AggregationPlan, str]:
    """The planner: rank the plan space by predicted step time (ties by
    name — deterministic) and return ``(plan, one-line reason)`` quoting
    PER-TIER numbers, the advisory a blended bandwidth could never state.
    Pure function of its inputs; the caller prints the line so the
    selection is never silent."""
    rows = []
    for plan in enumerate_plans(plan_names):
        s = predict_plan_step_s(
            plan,
            dense_bytes=dense_bytes,
            payload_bytes=payload_bytes,
            fabric=fabric,
            compute_s=compute_s,
            tax_s=tax_s,
        )
        rows.append((s, plan.name, plan))
    rows.sort(key=lambda r: (r[0], r[1]))
    best_s, _, best = rows[0]
    wires = plan_wire_bytes(
        best,
        dense_bytes=dense_bytes,
        payload_bytes=payload_bytes,
        fabric=fabric,
    )
    t_in = fabric.tier_time_s(wires["inner_bytes"], "inner", wires["inner_hops"])
    t_out = fabric.tier_time_s(
        wires["outer_bytes"], "outer", wires["outer_hops"]
    )
    bits = [
        f"plan {best.name} predicted {best_s * 1e3:.2f} ms/step",
        f"inner tier moves {wires['inner_bytes'] / 1e6:.2f} MB/chip over "
        f"{fabric.inner_label} @ {fabric.inner_bw / 1e9:.2f} GB/s "
        f"(~{t_in * 1e3:.2f} ms)",
        f"outer tier moves {wires['outer_bytes'] / 1e6:.2f} MB/chip over "
        f"{fabric.outer_label} @ {fabric.outer_bw / 1e9:.2f} GB/s "
        f"(~{t_out * 1e3:.2f} ms)",
    ]
    if best.outer == "psum":
        bits.append(
            "dense outer: boundary density crossed the crossover "
            f"(payload {payload_bytes / 1e6:.2f} MB vs dense "
            f"{dense_bytes / 1e6:.2f} MB at {fabric.outer_ways} outer ways "
            "— the SparCML representation switch)"
        )
    elif best.reencodes:
        bits.append(
            "boundary re-encode: fresh outer-keyed draw over the "
            "inner-reduced gradient (unbiased by composition)"
        )
    if len(rows) > 1:
        bits.append(
            f"runner-up {rows[1][1]} at {rows[1][0] * 1e3:.2f} ms/step"
        )
    return best, "; ".join(bits)


def recommend_two_tier(
    *,
    codec_budgets: dict,
    measured_ms: dict,
    fabric: TwoTierFabric,
    dense_key: str = "dense",
) -> dict:
    """Two-tier twin of the JAX package's ``comm_model.
    recommend_for_scenario`` (the same row shape): per codec, the
    best PLAN at this fabric from the measured single-card anchors
    (dense entry = compute anchor, a codec's excess = its measured tax).
    Dense training has no two-level schedule — its entry is the flat
    dense all-reduce priced at the outer (slowest) tier, the honest
    baseline the plans must beat."""
    if dense_key not in measured_ms:
        raise ValueError(f"measured_ms needs the {dense_key!r} anchor")
    compute_s = float(measured_ms[dense_key]) / 1e3
    n_total = fabric.inner_ways * fabric.outer_ways
    rows = []
    for name, (db, pb) in sorted(codec_budgets.items()):
        has_codec = name != dense_key and pb
        if not has_codec:
            wire = ring_allreduce_wire_bytes(db, n_total)
            s = compute_s + fabric.tier_time_s(
                wire, "outer", 2 * (n_total - 1)
            )
            rows.append(
                {
                    "code": name,
                    "candidate": "flat psum",
                    "predicted_ms_per_step": round(s * 1e3, 4),
                    "measured_1chip_ms": measured_ms.get(name),
                    "codec_tax_ms": 0.0,
                }
            )
            continue
        tax_s = (
            max(float(measured_ms[name]) / 1e3 - compute_s, 0.0)
            if name in measured_ms
            else None
        )
        plan, _ = choose_plan(
            dense_bytes=db,
            payload_bytes=pb,
            fabric=fabric,
            compute_s=compute_s,
            tax_s=tax_s,
        )
        s = predict_plan_step_s(
            plan,
            dense_bytes=db,
            payload_bytes=pb,
            fabric=fabric,
            compute_s=compute_s,
            tax_s=tax_s,
        )
        rows.append(
            {
                "code": name,
                "candidate": f"hier[{plan.name}]",
                "predicted_ms_per_step": round(s * 1e3, 4),
                "measured_1chip_ms": measured_ms.get(name),
                "codec_tax_ms": (
                    round(tax_s * 1e3, 3) if tax_s is not None else None
                ),
            }
        )
    rows.sort(key=lambda r: (r["predicted_ms_per_step"], r["code"]))
    return {"winner": rows[0], "ranked": rows}
