"""Two-tier fabric description: the topology the comm model can price.

Counterpart of ``atomo_tpu/topology/fabric.py``. ``utils.comm_model.
resolve_fabric`` returns ONE bandwidth, the slowest link on the gradient
path; on a two-tier mesh (NVLink inside a host, a NIC between hosts) that
prices the inner hops at the NIC's rate. :class:`TwoTierFabric` keeps the
two tiers apart, so an advisory can say what each tier moves and costs.

Parsing (:func:`resolve_two_tier`) puts every tier token through
``comm_model.resolve_fabric``'s grammar (a named preset or a positive finite
GB/s figure), so that the advisory and the planner cannot disagree about a
fabric string. The forms of ``--fabric`` on a two-tier mesh:

  ``auto``            inner = the ``nvlink`` preset, outer = the ``dcn``
                      preset (one 400 Gb/s NIC a card)
  ``<outer>``         one token names the OUTER (slow) tier; the inner
                      stays ``nvlink`` (the one-scalar meaning: the
                      slowest link on the gradient path)
  ``<inner>:<outer>`` both tiers, e.g. ``nvlink:eth10g`` or ``45:1.25``
                      (GB/s a card)
  ``measured``        both tiers from the startup probe's
                      ``fabric_probe.json`` (bandwidths and per-hop
                      latencies, :func:`atomo_tpu_torch.obs.fabric.
                      measured_two_tier`)

The per-hop latency anchors are the card's, stated estimates, not
measurements: NCCL's own cost model (``src/graph/tuning.cc``, its hardware
latency table) charges a ring step a few microseconds over NVLink and more
than ten over the network. They keep many-hop collectives on the slow tier
from being priced as free below the bandwidth floor; ``--fabric measured``
replaces them by the probe's fitted intercepts.
"""

from __future__ import annotations

import dataclasses

from atomo_tpu_torch.utils.comm_model import FABRICS, resolve_fabric

# stated per-hop latency estimates (seconds), see the module docstring: an
# NVLink ring step inside a host, a ring step through a NIC between hosts
NVLINK_HOP_LATENCY_S = 3e-6
NIC_HOP_LATENCY_S = 15e-6


@dataclasses.dataclass(frozen=True)
class TwoTierFabric:
    """Per-tier bandwidth and latency and the (outer, inner) group shape.

    ``inner_*`` is the fast tier (NVLink inside a host): groups of
    ``inner_ways`` cards. ``outer_*`` is the slow tier (the NICs between
    hosts): ``outer_ways`` groups exchanging over it. ``outer_ways *
    inner_ways`` is the data-parallel world. Bandwidths are a card's
    effective ring bandwidth (bytes/s), the convention of
    ``comm_model.FABRICS``."""

    inner_bw: float
    outer_bw: float
    inner_ways: int
    outer_ways: int
    inner_latency_s: float = NVLINK_HOP_LATENCY_S
    outer_latency_s: float = NIC_HOP_LATENCY_S
    inner_label: str = "nvlink"
    outer_label: str = "dcn"

    def tier_ways(self, tier: str) -> int:
        return self.inner_ways if tier == "inner" else self.outer_ways

    def tier_bw(self, tier: str) -> float:
        return self.inner_bw if tier == "inner" else self.outer_bw

    def tier_time_s(self, nbytes: float, tier: str, hops: int = 0) -> float:
        """Seconds to move ``nbytes`` a card over one tier, plus the per-hop
        latency floor for ``hops`` serialized collective hops (0: the
        bandwidth term alone)."""
        lat = self.inner_latency_s if tier == "inner" else self.outer_latency_s
        return float(nbytes) / self.tier_bw(tier) + lat * max(int(hops), 0)

    def describe(self) -> str:
        """One advisory line: both tiers with their group shape and
        bandwidth."""
        return (
            f"inner {self.inner_ways}x {self.inner_label} @ "
            f"{self.inner_bw / 1e9:.2f} GB/s/chip, outer {self.outer_ways}x "
            f"{self.outer_label} @ {self.outer_bw / 1e9:.2f} GB/s/chip"
        )


def _tier_label(token: str) -> str:
    return token if token in FABRICS else f"{token}GBps"


def resolve_two_tier(fabric: str, *, dcn_ways: int, n_dev: int, n_proc: int = 1,
                     measured=None) -> TwoTierFabric:
    """A ``--fabric`` value as the :class:`TwoTierFabric` of ``n_dev``
    data-parallel cards in ``dcn_ways`` slow-fabric groups (grammar in the
    module docstring; every token through ``resolve_fabric``). Raises
    ``ValueError`` with the JAX package's texts on a bad token or a group
    shape that does not divide the world. ``measured`` (the
    ``fabric_probe.json`` document) serves the ``measured`` form and a
    ``measured`` token inside ``<inner>:<outer>`` (the slowest tier)."""
    k = int(dcn_ways)
    n = int(n_dev)
    if not (1 < k <= n) or n % k:
        raise ValueError(
            f"two-tier fabric needs 1 < dcn_ways <= n_dev with "
            f"dcn_ways | n_dev; got dcn_ways={k}, n_dev={n}"
        )
    if fabric == "measured":
        from atomo_tpu_torch.obs.fabric import measured_two_tier

        if measured is None:
            raise ValueError(
                "--fabric measured resolves from a fabric_probe.json "
                "artifact and this surface has none — run `train "
                "--fabric measured` with a --train-dir so the startup "
                "probe measures both tiers (--dcn-ways set)"
            )
        return measured_two_tier(measured, dcn_ways=k, n_dev=n)
    if fabric == "auto":
        inner_tok, outer_tok = "nvlink", "dcn"
    elif ":" in fabric:
        inner_tok, _, outer_tok = fabric.partition(":")
        if not inner_tok or not outer_tok:
            raise ValueError(
                f"--fabric {fabric!r}: two-tier form is <inner>:<outer> "
                "with each side a named preset or a positive GB/s number"
            )
    else:
        # the one-scalar meaning: the slowest link = the OUTER tier
        inner_tok, outer_tok = "nvlink", fabric
    return TwoTierFabric(
        inner_bw=resolve_fabric(inner_tok, n_proc=1, measured=measured),
        outer_bw=resolve_fabric(outer_tok, n_proc=n_proc, measured=measured),
        inner_ways=n // k,
        outer_ways=k,
        inner_label=_tier_label(inner_tok),
        outer_label=_tier_label(outer_tok),
    )
