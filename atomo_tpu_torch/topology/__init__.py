"""Two-tier aggregation: the fabric model, the plan space and its planner,
and the plans' execution over process groups.

Counterpart of ``atomo_tpu/topology/__init__.py``. A mesh of hosts is not
flat: NVLink joins the cards of a host, a NIC joins the hosts, and one
bandwidth cannot price a program whose collectives cross both.

  fabric    :class:`TwoTierFabric`, the per-tier bandwidth and latency and
            the (outer, inner) group shape; ``resolve_two_tier`` reads a
            ``--fabric`` value as two tiers through the one parser.
  schedule  :class:`AggregationPlan` and the deterministic planner
            (``choose_plan``): inner dense mean or compressed ring over the
            fast tier, outer re-encoded gather, ring or dense fallback over
            the slow one.
  execute   ``planned_two_level_mean``, a plan run inside the data-parallel
            step over the mesh's ``ici`` and ``dp`` groups, with the
            boundary RE-ENCODE between the tiers (the inner-reduced
            gradient compressed again under a fresh per-group key: unbiased
            by composition).
"""

from atomo_tpu_torch.topology.fabric import (  # noqa: F401
    TwoTierFabric,
    resolve_two_tier,
)
from atomo_tpu_torch.topology.schedule import (  # noqa: F401
    AggregationPlan,
    LEGACY_PLAN,
    PLAN_NAMES,
    choose_plan,
    enumerate_plans,
    plan_from_name,
    plan_wire_bytes,
    predict_plan_step_s,
)
from atomo_tpu_torch.topology.execute import (  # noqa: F401
    planned_two_level_mean,
    two_level_canonical_mean,
    two_level_mean_host,
)
