"""Analytic comm-cost model: when does gradient compression win wall-clock?

Counterpart of ``atomo_tpu/utils/comm_model.py:70-592`` and ``:1180-1266``
(the byte formulas, ``choose_aggregate`` behind ``--aggregate auto``,
``resolve_fabric``, the overlap and pipeline-bubble pricing and the
crossover report). The autopilot's predictor (``:595-1178``) is not ported.

Model (the JAX package's, unchanged):

* synchronous data parallelism over ring collectives, no compute/comm
  overlap;
* the dense exchange is a ring all-reduce of the D-byte gradient, per-card
  wire traffic ``2*D*(N-1)/N`` through one link direction;
* the compressed exchange all-gathers the fixed-size payload P, per-card
  traffic ``P*(N-1)``; every card decodes every payload (no extra wire);
* the codec tax (encode + decode-mean) is a measured single-card step
  difference, charged at every N;
* a bandwidth is the per-card effective ring bandwidth of the slowest link
  on the gradient path.

The anchors are the card's own, not the TPU's of the JAX package:

* ``FABRICS["nvlink"]`` (alias ``ici``, the JAX spelling of the intra-host
  tier, so a JAX script runs unchanged) is the H100 SXM datasheet's NVLink
  figure, 900 GB/s of total bandwidth, i.e. 450 GB/s per direction: a
  datasheet figure, not a measurement;
* ``FABRICS["dcn"]`` is one 400 Gb/s InfiniBand NIC per card (50 GB/s), the
  NIC-per-GPU pairing of the DGX H100 datasheet, again a datasheet figure;
  ``eth10g`` is 10 GbE, the reference's EC2 regime;
* the codec tax anchor ``_TAX_ANCHOR_S`` is ResNet-18 svd3's step minus its
  ``sgd`` step, both measured on one H100 by ``chip_smoke.py``'s ``comm``
  lines (see the constant's comment).
"""

from __future__ import annotations

import math

DEFAULT_WAYS = (8, 16, 32, 64)
# (label, bytes/s): per-card effective ring bandwidths to tabulate (the
# FABRICS presets below, datasheet figures)
DEFAULT_BANDWIDTHS = (
    ("nvlink_450GBps", 450e9),
    ("ib400_50GBps", 50e9),
    ("eth10G_1.25GBps", 1.25e9),
)

# named fabric presets for --fabric (per-card effective ring bandwidth of the
# slowest link on the gradient path, bytes/s). nvlink: H100 SXM datasheet,
# NVLink 900 GB/s total = 450 GB/s per direction; dcn: one 400 Gb/s NIC per
# card (DGX H100 datasheet); eth10g: 10 GbE. "ici" is accepted as the JAX
# package's spelling of the intra-host tier and resolves to nvlink.
FABRICS = {"nvlink": 450e9, "ici": 450e9, "dcn": 50e9, "eth10g": 1.25e9}

# Measured single-card codec tax anchor: ResNet-18 (CIFAR-10 shapes, batch
# 128) svd rank 3 median step minus the sgd median step, both through the
# train CLI on an NVIDIA H100 80GB HBM3 at 700.00 W, as chip_smoke.py's
# `comm codec tax anchor` line prints them: 65.000 - 30.100 = 34.900 ms
# (PR 14, chip call 4, the script run from a `git archive` of its tree).
# The dense gradient is ResNet-18's 11,173,962 float32 values.
# `estimate_codec_tax_s` scales the anchor linearly with the dense gradient
# size. The card's host speed moves it between calls (the same line read
# 46.650 ms in call 3), and for any other model it is an estimate, not a
# measurement: --codec-tax-ms overrides it.
_TAX_ANCHOR_S = 34.9e-3
_TAX_ANCHOR_BYTES = 44_695_848


def estimate_codec_tax_s(dense_bytes: float) -> float:
    return _TAX_ANCHOR_S * float(dense_bytes) / _TAX_ANCHOR_BYTES


def choose_aggregate(
    *,
    has_codec: bool,
    dense_bytes: float,
    payload_bytes: float,
    ways: int,
    fabric_bw: float,
    tax_s: float | None = None,
    cross_host: bool = False,
    allow_ring: bool = True,
) -> tuple[str, str]:
    """``--aggregate auto``: (mode, one-line reason), as the JAX package's.

    * no compressing codec -> psum;
    * one device -> psum (no exchange);
    * the mesh crosses hosts -> hierarchical (the caller refuses it: the
      two-tier schedule is not ported);
    * one fabric: both modes pay the codec round trip, so wire bytes
      decide: gather iff ``P*(N-1) < 2*D*(N-1)/N``; within gather's region,
      once the gathered buffer ``N*P`` reaches the dense gradient D, ring
      (``allow_ring``). The gather pick carries a NOTE when the wire saving
      at ``fabric_bw`` is below the codec tax ``tax_s`` (default: the
      card's anchor scaled by D)."""
    if not has_codec:
        return "psum", "no compressing codec: dense all-reduce (psum)"
    if ways <= 1:
        return (
            "psum",
            "single device: no exchange; psum keeps codec semantics "
            "without a gather",
        )
    if cross_host:
        return (
            "hierarchical",
            "mesh crosses hosts: dense psum over ICI, factors over the "
            "slow inter-host fabric (artifacts/COMM_CROSSOVER.md concl. 2)",
        )
    ar = ring_allreduce_wire_bytes(dense_bytes, ways)
    ag = ring_allgather_wire_bytes(payload_bytes, ways)
    n_star = max_beneficial_ways(dense_bytes, payload_bytes)
    if ag >= ar:
        return (
            "psum",
            f"dense all-reduce wins at {ways} ways: the factor all_gather "
            f"would move {ag / 1e6:.2f} MB/chip >= {ar / 1e6:.2f} MB/chip "
            f"dense (compression stops paying past N = 2x reduction = "
            f"{n_star:.0f}); the codec round trip runs either way",
        )
    if tax_s is None:
        tax_s = estimate_codec_tax_s(dense_bytes)

    def tax_advisory(saved_s: float) -> str:
        if saved_s >= tax_s:
            return ""
        return (
            f"; NOTE on {fabric_bw / 1e9:.2f} GB/s/chip the wire saving "
            f"{saved_s * 1e3:.2f} ms < codec tax ~{tax_s * 1e3:.2f} ms — "
            "compression is costing wall-clock here; dense training "
            "(--code sgd) would be faster end-to-end"
        )

    buf = gather_buffer_bytes(payload_bytes, ways)
    if allow_ring and buf >= dense_bytes:
        rs = ring_stream_wire_bytes(payload_bytes, dense_bytes, ways)
        return (
            "ring",
            f"ring-streamed gather at {ways} ways: the gathered buffer "
            f"would hold {buf / 1e6:.2f} MB/chip >= the {dense_bytes / 1e6:.2f} "
            f"MB dense gradient; streaming rotates payloads over {ways - 1} "
            f"ppermute hops with decode overlapped ({rs / 1e6:.2f} MB/chip "
            f"on the wire incl. the segment all_gather) and never "
            "materializes the buffer; NOTE total wire >= the "
            f"{ar / 1e6:.2f} MB/chip dense all-reduce at this N — the pick "
            "buys O(1) payload memory and decode/transfer overlap, not "
            "bytes (use --aggregate gather to minimize wire)",
        )
    saved_s = (ar - ag) / fabric_bw
    reason = (
        f"factor all_gather wins at {ways} ways: {ag / 1e6:.2f} MB/chip "
        f"vs {ar / 1e6:.2f} MB/chip dense (both modes pay the codec "
        "round trip, so wire bytes decide)"
    ) + tax_advisory(saved_s)
    return "gather", reason


def quorum_exposed_wait_s(delays, quorum: int) -> float:
    """The Q-th smallest per-replica delay (seconds): what a quorum-Q step
    waits for, where a blocking step waits for the largest."""
    d = sorted(float(x) for x in delays)
    if not d:
        return 0.0
    q = min(max(int(quorum), 1), len(d))
    return d[q - 1]


def leaf_budget_totals(leaf_budgets) -> tuple[float, float]:
    """Sum per-leaf ``(dense_bytes, payload_bytes)`` pairs into the
    ``(dense, payload)`` totals every wire formula consumes."""
    d = 0.0
    p = 0.0
    for pair in leaf_budgets:
        d += float(pair[0])
        p += float(pair[1])
    return d, p


def codec_leaf_payload_bytes(codec, shape, dtype="float32") -> int:
    """One leaf's wire bytes under ``codec``, priced from its (JAX-layout)
    shape by the codec's own ``leaf_payload_bytes`` (the clamped actual: a
    leaf the codec ships dense pays its dense bytes). Every codec of the
    port publishes it, so nothing is encoded; a codec without it is
    refused rather than encoded (the JAX package's eval_shape fallback has
    no zero-cost counterpart here)."""
    fn = getattr(codec, "leaf_payload_bytes", None)
    if fn is None:
        raise TypeError(
            f"codec {getattr(codec, 'name', type(codec).__name__)!r} publishes no "
            "leaf_payload_bytes; its wire bytes cannot be priced without encoding")
    if str(dtype) not in ("float32", "torch.float32"):
        raise ValueError(f"leaf dtype {dtype}: the codecs price float32 gradients")
    return int(fn(tuple(int(d) for d in shape)))


def ring_allreduce_wire_bytes(dense_bytes: float, ways: int) -> float:
    """Per-card one-direction wire traffic of a ring all-reduce."""
    return 2.0 * dense_bytes * (ways - 1) / ways


def ring_allgather_wire_bytes(payload_bytes: float, ways: int) -> float:
    """Per-card wire traffic of a ring all-gather of per-card payloads."""
    return float(payload_bytes) * (ways - 1)


def ring_stream_wire_bytes(
    payload_bytes: float, dense_bytes: float, ways: int
) -> float:
    """Per-card wire traffic of ``aggregate='ring'``: the N-1 payload hops
    plus the all_gather of the decoded mean's dense/N segments."""
    return float(payload_bytes) * (ways - 1) + float(dense_bytes) * (
        ways - 1
    ) / ways


def gather_buffer_bytes(payload_bytes: float, ways: int) -> float:
    """Live memory of gather's all_gather destination, ``N * P``."""
    return float(payload_bytes) * ways


def stream_bucket_count(dense_bytes: float, bucket_bytes: float) -> int:
    """Layer-bucket count of a ``--stream-encode`` plan, estimated from
    byte totals under uniform packing (the planner never splits a leaf, so
    the real plan may have fewer). ``bucket_bytes <= 0`` is one bucket."""
    if bucket_bytes <= 0:
        return 1
    return max(1, int(math.ceil(float(dense_bytes) / float(bucket_bytes))))


def stream_exposed_encode_s(encode_s: float, n_buckets: int) -> float:
    """Encode seconds still on the critical path under ``--stream-encode``:
    the last bucket's share, ``encode / n``."""
    return max(float(encode_s), 0.0) / max(int(n_buckets), 1)


def pipeline_bubble_fraction(n_stages: int, microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: ``(n-1) / (m + n-1)``."""
    n = max(int(n_stages), 1)
    m = max(int(microbatches), 1)
    return (n - 1) / (m + n - 1)


def pipeline_bubble_s(compute_s: float, n_stages: int, microbatches: int) -> float:
    """Wall-clock the bubble adds to a replica step: ``compute * (n-1)/m``."""
    n = max(int(n_stages), 1)
    m = max(int(microbatches), 1)
    return max(float(compute_s), 0.0) * (n - 1) / m


def tp_psum_wire_bytes(
    activation_bytes: float, ways: int, n_blocks: int
) -> float:
    """Per-card wire bytes of the Megatron tp all-reduces of one step: two
    a block forward and two in backward, each a ring all-reduce of the
    (B_local, S, W) activation: ``4 * n_blocks * allreduce(act, ways)``.
    (The port's Megatron pair runs the same four: the exit all-reduce of
    each parallel region forward, the entry all-reduce of each backward.)"""
    return (
        4.0
        * max(int(n_blocks), 0)
        * ring_allreduce_wire_bytes(float(activation_bytes), ways)
    )


def moe_all_to_all_wire_bytes(
    dispatch_bytes: float, ways: int, n_layers: int
) -> float:
    """Per-card wire bytes of the MoE expert shuffle of one step: two
    tiled all_to_alls a layer forward and two backward over the (E, C, W)
    slot buffer, each keeping 1/n local:
    ``4 * n_layers * dispatch_bytes * (ways-1)/ways``."""
    w = max(int(ways), 1)
    return (
        4.0
        * max(int(n_layers), 0)
        * max(float(dispatch_bytes), 0.0)
        * (w - 1)
        / w
    )


def overlap_hidden_comm_s(comm_s: float, compute_s: float) -> float:
    """Seconds of the exchange+decode chain ``--overlap delayed`` hides:
    ``min(comm, compute)``."""
    return min(max(float(comm_s), 0.0), max(float(compute_s), 0.0))


def overlap_exposed_comm_s(comm_s: float, compute_s: float) -> float:
    """Seconds of the chain still exposed under delayed:
    ``max(0, comm - compute)``."""
    return max(0.0, float(comm_s) - float(compute_s))


def overlap_report(
    *,
    dense_bytes: float,
    payload_bytes: float,
    ways: int,
    fabric_bw: float,
    compute_s: float,
    decode_s: float = 0.0,
    aggregate: str = "gather",
    encode_s: float = 0.0,
    stream_encode: bool = False,
    stream_buckets: int = 1,
    pipeline_stages: int = 1,
    pipeline_microbatches: int = 1,
) -> dict:
    """What ``--overlap delayed`` buys at N ``ways`` over a fabric: the
    blocking and the delayed step, the chain's hidden and exposed parts,
    the encode's exposed tail under ``stream_encode`` and the GPipe bubble
    (which under delayed also hides chain time), as the JAX package's
    report computes them."""
    if aggregate == "ring":
        wire = ring_stream_wire_bytes(payload_bytes, dense_bytes, ways)
    else:
        wire = ring_allgather_wire_bytes(payload_bytes, ways)
    comm_s = wire / float(fabric_bw) + max(float(decode_s), 0.0)
    hidden = overlap_hidden_comm_s(comm_s, compute_s)
    exposed = overlap_exposed_comm_s(comm_s, compute_s)
    enc = max(float(encode_s), 0.0)
    enc_exposed = (
        stream_exposed_encode_s(enc, stream_buckets) if stream_encode
        else enc
    )
    bubble = pipeline_bubble_s(
        compute_s, pipeline_stages, pipeline_microbatches
    )
    bubble_hidden = min(exposed, bubble)
    delayed_exposed = max(0.0, comm_s - float(compute_s) - bubble)
    return {
        "aggregate": aggregate,
        "ways": ways,
        "wire_mb_per_chip": round(wire / 1e6, 3),
        "comm_chain_ms": round(comm_s * 1e3, 3),
        "compute_ms": round(float(compute_s) * 1e3, 3),
        "hidden_ms": round(hidden * 1e3, 3),
        "exposed_ms": round(exposed * 1e3, 3),
        "encode_ms": round(enc * 1e3, 3),
        "encode_exposed_ms": round(enc_exposed * 1e3, 3),
        "encode_hidden_ms": round((enc - enc_exposed) * 1e3, 3),
        "stream_encode": bool(stream_encode),
        "stream_buckets": int(stream_buckets) if stream_encode else 1,
        "pipeline_bubble_ms": round(bubble * 1e3, 3),
        "pipeline_bubble_fraction": round(
            pipeline_bubble_fraction(pipeline_stages, pipeline_microbatches),
            4,
        ),
        "bubble_hidden_ms": round(bubble_hidden * 1e3, 3),
        "blocking_step_ms": round(
            (compute_s + comm_s + enc_exposed + bubble) * 1e3, 3
        ),
        "delayed_step_ms": round(
            (compute_s + delayed_exposed + enc_exposed + bubble) * 1e3, 3
        ),
        "assumptions": (
            "delayed overlaps exchange+decode with fwd/bwd+update; hides "
            "min(comm, compute), exposes the excess; encode consumes this "
            "step's gradient — fully exposed without --stream-encode, and "
            "with it the layer-bucket pipeline hides all but the tail "
            "(exposed encode = max(0, encode_tail) = encode/n_buckets, "
            "uniform-bucket model); pipeline_stages>1 adds the GPipe "
            "bubble compute*(n_stages-1)/microbatches to both step "
            "numbers, and under delayed the bubble is ALSO hiding budget "
            "(bubble_hidden_ms): exposed = max(0, comm - compute - "
            "bubble) — see atomo_tpu_torch/utils/comm_model.py"
        ),
    }


def resolve_fabric(fabric: str, *, n_proc: int = 1, measured=None) -> float:
    """Per-card bandwidth (bytes/s) for a ``--fabric`` value: ``auto``
    (nvlink on one host, dcn across hosts; ``n_proc`` counts HOSTS), a named
    preset, or a positive finite per-card GB/s number. Raises ValueError
    with the usage line on anything else, in the JAX package's words.
    ``measured`` is not ported: the startup fabric probe it reads
    (``obs/fabric.py``) waits for a later slice."""
    if fabric == "measured":
        raise ValueError(
            "--fabric measured needs the startup fabric probe (obs/fabric.py), "
            "which this port does not have yet; pass a preset or a GB/s number")
    if fabric == "auto":
        return FABRICS["dcn" if n_proc > 1 else "nvlink"]
    if fabric in FABRICS:
        return FABRICS[fabric]
    try:
        bw = float(fabric) * 1e9
    except (TypeError, ValueError):
        bw = -1.0
    if not (0 < bw < float("inf")):  # also rejects nan/inf strings
        raise ValueError(
            f"--fabric {fabric!r}: expected auto | measured | "
            f"{' | '.join(sorted(FABRICS))} | <positive finite GB/s>"
            + (
                " (two-tier <inner>:<outer> strings are accepted by the "
                "two-tier surfaces — topology.fabric.resolve_two_tier — "
                "with each side any of the forms above)"
                if ":" in str(fabric)
                else " | <inner>:<outer> on two-tier surfaces"
            )
        )
    return bw


def max_beneficial_ways(dense_bytes: float, payload_bytes: float) -> float:
    """N above which the all_gather moves more bytes than the dense
    all-reduce."""
    return 2.0 * dense_bytes / max(float(payload_bytes), 1.0)


def crossover_bandwidth(
    dense_bytes: float, payload_bytes: float, ways: int, codec_tax_s: float
) -> float | None:
    """Bandwidth below which compression wins the synchronous step; None
    when the byte saving is not positive at this N."""
    saved = ring_allreduce_wire_bytes(dense_bytes, ways) - ring_allgather_wire_bytes(
        payload_bytes, ways
    )
    if saved <= 0:
        return None
    if codec_tax_s <= 0:
        return float("inf")  # compression is free -> wins at any bandwidth
    return saved / codec_tax_s


def crossover_report(
    dense_bytes: float,
    payload_bytes: float,
    dense_step_s: float,
    svd_step_s: float,
    ways_list=DEFAULT_WAYS,
    bandwidths=DEFAULT_BANDWIDTHS,
) -> dict:
    """The per-config comm model (JSON-ready) from measured single-card
    dense and compressed step times; the model adds the fabric term."""
    tax_s = max(svd_step_s - dense_step_s, 0.0)
    rows = []
    for ways in ways_list:
        ar = ring_allreduce_wire_bytes(dense_bytes, ways)
        ag = ring_allgather_wire_bytes(payload_bytes, ways)
        bw_star = crossover_bandwidth(dense_bytes, payload_bytes, ways, tax_s)
        per_bw = {}
        for label, bw in bandwidths:
            t_dense = dense_step_s + ar / bw
            t_svd = svd_step_s + ag / bw
            per_bw[label] = {
                "dense_ms": round(t_dense * 1e3, 3),
                "compressed_ms": round(t_svd * 1e3, 3),
                "speedup": round(t_dense / t_svd, 3),
            }
        is_inf = bw_star is not None and bw_star == float("inf")
        rows.append(
            {
                "ways": ways,
                "allreduce_wire_mb": round(ar / 1e6, 3),
                "allgather_wire_mb": round(ag / 1e6, 3),
                "crossover_bw_gbps_per_chip": (
                    None if (bw_star is None or is_inf)
                    else round(bw_star / 1e9, 2)
                ),
                "crossover": (
                    "never" if bw_star is None
                    else ("any_bandwidth" if is_inf else "below_listed_bw")
                ),
                "implied": per_bw,
            }
        )
    return {
        "assumptions": (
            "sync ring collectives, no comm/compute overlap; dense=allreduce "
            "2D(N-1)/N, compressed=allgather P(N-1) bytes/chip; codec tax = "
            "measured single-chip svd-dense step delta; see "
            "atomo_tpu_torch/utils/comm_model.py"
        ),
        "dense_bytes": int(dense_bytes),
        "payload_bytes": int(payload_bytes),
        "codec_tax_ms": round(tax_s * 1e3, 3),
        "max_beneficial_ways": round(
            max_beneficial_ways(dense_bytes, payload_bytes), 1
        ),
        "ways": rows,
    }
