"""Measured fabric: the bandwidth and per-hop latency of the run's own
process group, probed at startup (``train --fabric measured``).

Counterpart of ``atomo_tpu/obs/fabric.py``. Every prediction of the port
(``--aggregate auto``, the sparse hybrid crossover) prices from a fabric
value; ``--fabric measured`` replaces the named preset by a measurement:

* :func:`probe_fabric` runs fenced ladders over a size sweep on the run's
  group: one ring hop (a ``batch_isend_irecv`` to rank + 1 and from rank -
  1, the ring exchange's own hop) and one ``all_gather_into_tensor`` of an
  S-byte buffer a rank, each timed by :func:`fenced_seconds_per_call` (the
  port of ``atomo_tpu/tuning/probe.py:139-160``: warm-up calls, a dispatch
  loop, a host read of the last output as the fence, the best of a few
  loops). :func:`_fit_tier` fits the per-rank ring bandwidth from the hop's
  size slope and the per-hop latency from its small-size intercept, with
  the all_gather's bandwidth as the recorded cross-check. Every rank runs
  the ladder and takes rank 0's fit, so every rank prices alike;
* the document goes to ``train_dir/fabric_probe.json`` through
  ``write_json_atomic``, and a ``--resume`` of the same group shape reuses
  it (:func:`ensure_fabric_probe`);
* ``--fabric measured`` resolves from it through the one parser,
  ``utils.comm_model.resolve_fabric(measured=doc)``: the slowest tier's
  bandwidth.

What each backend sends: over NCCL the buffers live on the card, over gloo
they are host buffers, which is what the port's host-staged gloo exchange
sends. ``meta`` records both the device platform (``backend``, the JAX
package's word: ``gpu`` or ``cpu``) and the group's backend
(``group_backend``), so a gloo figure is never read as an NVLink one.

Probe isolation (``atomo_tpu/obs/fabric.py:34-39``): the buffers are
deterministic ``ones``; the probe draws no random number and never touches
the data iterator, so a run under ``--fabric measured`` trains bit for bit
as the same run under ``--fabric <its measured GB/s>``.

With ``dcn_ways`` K > 1 the probe measures the two tiers of the ``(dp=K,
ici=N/K)`` mesh apart (``atomo_tpu/obs/fabric.py:249-320``): the ``ici``
tier's ladder over this rank's inner group, the ``dcn`` tier's over its
outer group (a 1-wide axis has no hop to time and is skipped), and
:func:`measured_two_tier` builds the topology layer's
:class:`~atomo_tpu_torch.topology.fabric.TwoTierFabric` from them, measured
bandwidths and per-hop latencies both. The JAX module's drift-blame
re-probe (:func:`quick_probe`) is here, but nothing calls it yet: its caller
is the online tuner (item 12).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

FABRIC_PROBE_NAME = "fabric_probe.json"

# probe size sweep (bytes a rank a hop): small sizes expose the per-hop
# latency floor, large ones the bandwidth asymptote
DEFAULT_SIZES = (1 << 12, 1 << 16, 1 << 20, 1 << 23)
# the drift-blame re-probe: two points give the slope
QUICK_SIZES = (1 << 12, 1 << 20)

def probe_path(train_dir: str) -> str:
    return os.path.join(train_dir, FABRIC_PROBE_NAME)


def read_fabric_probe(train_dir: str) -> Optional[dict]:
    """The recorded probe document, or None when it is absent or does not
    parse (a torn artifact is no measurement, never a crash)."""
    try:
        with open(probe_path(train_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def measured_bandwidths(doc: dict) -> dict:
    """``{tier label: per-chip bandwidth bytes/s}`` from a probe doc —
    the shape the ONE fabric parsers consume via ``measured=``."""
    out = {}
    for tier in (doc or {}).get("tiers", []):
        bw = tier.get("bandwidth_gbps")
        if isinstance(bw, (int, float)) and bw > 0:
            out[str(tier.get("label"))] = float(bw) * 1e9
    return out


def measured_outer_bw(doc: dict) -> float:
    """The SLOWEST measured tier's bandwidth (bytes/s) — the historical
    single-scalar meaning of a fabric value (the slowest link on the
    gradient path). Raises ValueError on an artifact with no usable
    tier, with the re-probe instruction in the message."""
    bws = measured_bandwidths(doc)
    if not bws:
        raise ValueError(
            "fabric_probe.json carries no usable tier measurement — "
            "delete it and re-run with --fabric measured to re-probe"
        )
    return min(bws.values())


def measured_two_tier(doc: dict, *, dcn_ways: int, n_dev: int):
    """A :class:`~atomo_tpu_torch.topology.fabric.TwoTierFabric` built from
    the probe document: measured bandwidths AND measured per-hop latencies a
    tier (the stated anchors stand in for a tier without a fitted latency).
    Needs a probe that measured both tiers (``--dcn-ways`` was set when it
    ran)."""
    from atomo_tpu_torch.topology.fabric import (
        NIC_HOP_LATENCY_S,
        NVLINK_HOP_LATENCY_S,
        TwoTierFabric,
    )

    k = int(dcn_ways)
    tiers = {str(t.get("label")): t for t in (doc or {}).get("tiers", [])}
    if "ici" not in tiers and int(n_dev) // k == 1 and "dcn" in tiers:
        # dcn_ways == n_dev: every inner group is one card, with no hop to
        # probe, and its bandwidth prices zero bytes: the dcn tier stands in
        tiers = dict(tiers, ici=tiers["dcn"])
    if "ici" not in tiers or "dcn" not in tiers:
        raise ValueError(
            "--fabric measured on a two-tier mesh needs a probe artifact "
            "with both ici and dcn tiers (found: "
            f"{sorted(tiers) or 'none'}); delete fabric_probe.json and "
            "re-run with --dcn-ways set so both axes are probed"
        )

    def _bw(t):
        return float(t["bandwidth_gbps"]) * 1e9

    def _lat(t, default):
        v = t.get("latency_us")
        return float(v) / 1e6 if isinstance(v, (int, float)) else default

    return TwoTierFabric(
        inner_bw=_bw(tiers["ici"]),
        outer_bw=_bw(tiers["dcn"]),
        inner_ways=int(n_dev) // k,
        outer_ways=k,
        inner_latency_s=_lat(tiers["ici"], NVLINK_HOP_LATENCY_S),
        outer_latency_s=_lat(tiers["dcn"], NIC_HOP_LATENCY_S),
        inner_label="measured_ici",
        outer_label="measured_dcn",
    )


# ------------------------------------------------------------------ probe


def fenced_seconds_per_call(call, *, reps: int, warmup: int = 2,
                            best_of: int = 1) -> tuple[float, bool]:
    """Best-of-``best_of`` mean seconds a ``call()`` over ``reps``-call
    dispatch loops, each fenced by a host read of the last call's output (a
    tensor). Returns ``(seconds, sync_ok)``: ``sync_ok`` False when the
    fenced value came back non-finite (the measurement is then invalid,
    reported, never trusted)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = call()
    sync = float(out.sum())  # drains the warm-up
    best = float("inf")
    for _ in range(max(best_of, 1)):
        t0 = time.perf_counter()
        for _ in range(max(reps, 1)):
            out = call()
        sync = float(out.sum())
        best = min(best, (time.perf_counter() - t0) / max(reps, 1))
    return best, bool(math.isfinite(sync))


def _ladder(sizes, *, reps: int, warmup: int, best_of: int, device, group=None) -> list[dict]:
    """One tier's measured rows: fenced seconds for one ring hop and one
    all_gather of an S-byte buffer a rank, for each size. The buffers are
    ``ones``: no random draw, no contact with the data stream."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    to, frm = (rank + 1) % world, (rank - 1) % world
    if group is not None:  # point-to-point peers are global ranks
        to, frm = dist.get_global_rank(group, to), dist.get_global_rank(group, frm)
    rows = []
    for size in sizes:
        n_elem = max(int(size) // 4, 1)  # float32 elements a rank
        buf = torch.ones(n_elem, dtype=torch.float32, device=device)
        nxt = torch.empty_like(buf)
        gathered = torch.empty(world * n_elem, dtype=torch.float32, device=device)

        def hop():
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, to, group),
                                           dist.P2POp(dist.irecv, nxt, frm, group)])
            for r in reqs:
                r.wait()
            return nxt[:1]

        def gather():
            dist.all_gather_into_tensor(gathered, buf, group=group)
            return gathered[:1]

        t_pp, ok_pp = fenced_seconds_per_call(hop, reps=reps, warmup=warmup, best_of=best_of)
        t_ag, ok_ag = fenced_seconds_per_call(gather, reps=reps, warmup=warmup, best_of=best_of)
        rows.append({
            "bytes": int(size),
            "ppermute_ms": round(t_pp * 1e3, 6),
            "allgather_ms": round(t_ag * 1e3, 6),
            "sync_ok": bool(ok_pp and ok_ag),
        })
    return rows


def _fit_tier(rows: list[dict], ways: int) -> dict:
    """Bandwidth from the ppermute size slope, per-hop latency from the
    small-size intercept (t(S) = lat + S/bw — a stated two-point fit,
    not a regression), all_gather bandwidth as the recorded cross-check.
    Rows whose fence came back non-finite are excluded from the fit."""
    ok = [r for r in rows if r.get("sync_ok", True)]
    out = {"bandwidth_gbps": None, "latency_us": None,
           "allgather_gbps": None}
    if not ok:
        return out
    lo, hi = min(ok, key=lambda r: r["bytes"]), max(
        ok, key=lambda r: r["bytes"]
    )
    t_lo, t_hi = lo["ppermute_ms"] / 1e3, hi["ppermute_ms"] / 1e3
    if hi["bytes"] > lo["bytes"] and t_hi > t_lo:
        bw = (hi["bytes"] - lo["bytes"]) / (t_hi - t_lo)
    elif t_hi > 0:
        bw = hi["bytes"] / t_hi  # degenerate sweep: asymptote only
    else:
        return out
    out["bandwidth_gbps"] = round(bw / 1e9, 4)
    out["latency_us"] = round(max(t_lo - lo["bytes"] / bw, 0.0) * 1e6, 3)
    t_ag = hi["allgather_ms"] / 1e3
    if t_ag > 0 and ways > 1:
        out["allgather_gbps"] = round(
            hi["bytes"] * (ways - 1) / t_ag / 1e9, 4
        )
    return out


def _platform(device) -> str:
    """The JAX package's word for a device platform."""
    import torch

    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def probe_fabric(*, n_dev: int, dcn_ways: int = 0, sizes=DEFAULT_SIZES, reps: int = 3,
                 warmup: int = 1, best_of: int = 2, log_fn=print, device=None,
                 group=None, mesh=None) -> dict:
    """Measure the group's fabric (module docstring): flat, one tier
    labelled ``ici`` (the JAX package's label for the fabric joining one
    mesh's chips) over the ``n_dev`` ranks of ``group`` (the default group
    when None); with ``dcn_ways`` K > 1 dividing ``n_dev`` (and the default
    group), the ``ici`` and ``dcn`` tiers of the ``(dp=K, ici=N/K)`` mesh,
    each over this rank's line of its axis: the groups of ``mesh``, the
    run's built two-tier mesh, or when None of ``MeshSpec.from_world(N,
    K).build()``, whose groups every rank makes. Every rank calls it.
    ``device`` is the run's device; over gloo the buffers are host tensors.
    Returns the probe document; writing it is :func:`ensure_fabric_probe`'s
    move."""
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    n = int(n_dev)
    if n < 2:
        raise ValueError(
            "--fabric measured needs a multi-device mesh: a single "
            "device has no inter-chip fabric to measure"
        )
    k = int(dcn_ways)
    two_tier = k > 1 and n % k == 0 and k <= n
    if not dist.is_initialized() or dist.get_world_size(group) != n:
        raise ValueError(
            f"--fabric measured probes the run's process group, which must hold the "
            f"{n} ranks of the mesh (one per device)")
    backend = dist.get_backend(group)
    run_device = torch.device("cpu" if device is None else device)
    buffers = torch.device("cpu") if backend == "gloo" else run_device
    if two_tier:
        if mesh is None:
            from atomo_tpu_torch.mesh.spec import MeshSpec

            mesh = MeshSpec.from_world(n, k).build()
        tiers = []
        for label, axis in (("ici", "ici"), ("dcn", "dp")):
            ways = mesh.size(axis)
            if ways < 2:
                continue  # a 1-wide axis has no hops to time
            rows = _ladder(sizes, reps=reps, warmup=warmup, best_of=best_of, device=buffers,
                           group=mesh.group(axis))
            tiers.append({"label": label, "axis": axis, "ways": ways,
                          **_fit_tier(rows, ways), "rows": rows})
    else:
        rows = _ladder(sizes, reps=reps, warmup=warmup, best_of=best_of, device=buffers,
                       group=group)
        tiers = [{"label": "ici", "axis": "dp", "ways": n, **_fit_tier(rows, n), "rows": rows}]
    doc = {
        "kind": "fabric_probe",
        "meta": {
            "backend": _platform(run_device),
            "group_backend": backend,
            "buffers": buffers.type,
            "n_devices": n,
            "dcn_ways": k if two_tier else 0,
            "sizes_bytes": [int(s) for s in sizes],
            "reps": int(reps),
            "best_of": int(best_of),
            "probe_wall_s": round(time.perf_counter() - t0, 3),
        },
        "tiers": tiers,
        "complete": all(t.get("bandwidth_gbps") for t in tiers) and bool(tiers),
    }
    # every rank fitted its own timings: rank 0's document is the group's,
    # so that every rank prices (and picks) alike
    box = [doc]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0) if group is not None
                               else 0, group=group)
    doc = box[0]
    tiers = doc["tiers"]
    for t in tiers:
        log_fn(
            f"Fabric probe: {t['label']} ({t['ways']} ways, {backend} group, {buffers.type} "
            f"buffers) measured {t['bandwidth_gbps']} GB/s/chip, {t['latency_us']} us/hop "
            f"(all_gather cross-check {t['allgather_gbps']} GB/s)"
        )
    return doc


def write_fabric_probe(train_dir: str, doc: dict) -> str:
    """Atomic artifact write (the one discipline — write_json_atomic)."""
    from atomo_tpu_torch.utils.tracing import write_json_atomic

    path = probe_path(train_dir)
    write_json_atomic(path, doc)
    return path


def ensure_fabric_probe(train_dir: str, *, n_dev: int, dcn_ways: int = 0, reuse: bool = False,
                        log_fn=print, write: bool = True, device=None, group=None, mesh=None,
                        **probe_kw) -> dict:
    """The CLI's ``--fabric measured`` startup hook, which every rank
    calls: reuse a complete recorded probe when ``reuse`` (a ``--resume``
    must not re-measure — the resumed pricing should match the original
    run's), else probe the group and (``write``: rank 0) write
    ``train_dir/fabric_probe.json``. A recorded probe of another group shape
    is never reused. ``mesh`` (the run's two-tier mesh, when built) and
    ``probe_kw`` reach :func:`probe_fabric` (the sweep)."""
    # normalize the requested shape the way probe_fabric records it (a
    # non-dividing or degenerate dcn_ways probes flat with meta.dcn_ways=0),
    # or a --resume of such a run would re-probe forever on a mismatch
    # that is not one
    k = int(dcn_ways)
    k_norm = k if (1 < k <= int(n_dev) and int(n_dev) % k == 0) else 0
    if reuse:
        doc = read_fabric_probe(train_dir)
        if doc and doc.get("complete"):
            meta = doc.get("meta") or {}
            if (
                meta.get("n_devices") == int(n_dev)
                and int(meta.get("dcn_ways") or 0) == k_norm
            ):
                log_fn(
                    f"Fabric probe: reusing {probe_path(train_dir)} "
                    "(delete the file to re-measure)"
                )
                return doc
            log_fn(
                "Fabric probe: NOT reusing the recorded artifact (it "
                f"measured n_devices={meta.get('n_devices')}, "
                f"dcn_ways={meta.get('dcn_ways')} — this run has "
                f"{n_dev}/{dcn_ways}); re-probing"
            )
    doc = probe_fabric(n_dev=n_dev, dcn_ways=dcn_ways, log_fn=log_fn, device=device,
                       group=group, mesh=mesh, **probe_kw)
    if write:
        path = write_fabric_probe(train_dir, doc)
        log_fn(f"Fabric probe: artifact -> {path}")
    return doc


def quick_probe(*, n_dev: int, dcn_ways: int = 0, log_fn=print, device=None,
                group=None) -> dict:
    """The drift-blame re-probe: the same ladder at two sizes, one rep —
    cheap enough for a checkpoint boundary, accurate enough to answer
    "did the fabric move by >1.5x", which is the only question blame
    asks of it."""
    return probe_fabric(n_dev=n_dev, dcn_ways=dcn_ways, sizes=QUICK_SIZES, reps=1, warmup=1,
                        best_of=1, log_fn=log_fn, device=device, group=group)


# ------------------------------------------------- per-tier prediction


def predicted_tier_ms(
    *,
    aggregate: str,
    dense_bytes: float,
    payload_bytes: float,
    ways: int,
    fabric_bw: Optional[float] = None,
    fabric_label: str = "fabric",
    fabric2=None,
    plan_name: Optional[str] = None,
) -> dict:
    """``{tier label: predicted comm ms}`` — the per-tier decomposition
    of an aggregate's predicted comm time: a flat aggregate crosses one
    tier (the wire formula per mode), a hierarchical plan over a two-tier
    fabric (``fabric2``) both, through ``topology.schedule.
    plan_wire_bytes``. Returns {} when the context cannot be priced (no
    bandwidth): an absent column, never a made-up one."""
    from atomo_tpu_torch.utils.comm_model import (
        ring_allgather_wire_bytes,
        ring_allreduce_wire_bytes,
        ring_stream_wire_bytes,
    )

    ways = int(ways)
    if ways <= 1:
        return {}
    if aggregate == "hierarchical" and fabric2 is not None:
        from atomo_tpu_torch.topology.schedule import plan_from_name, plan_wire_bytes

        wires = plan_wire_bytes(plan_from_name(plan_name or "legacy"),
                                dense_bytes=dense_bytes, payload_bytes=payload_bytes,
                                fabric=fabric2)
        return {
            fabric2.inner_label: round(fabric2.tier_time_s(
                wires["inner_bytes"], "inner", wires["inner_hops"]) * 1e3, 4),
            fabric2.outer_label: round(fabric2.tier_time_s(
                wires["outer_bytes"], "outer", wires["outer_hops"]) * 1e3, 4),
        }
    if not fabric_bw or fabric_bw <= 0:
        return {}
    if aggregate == "psum" or not payload_bytes:
        wire = ring_allreduce_wire_bytes(dense_bytes, ways)
    elif aggregate == "ring":
        wire = ring_stream_wire_bytes(payload_bytes, dense_bytes, ways)
    else:
        wire = ring_allgather_wire_bytes(payload_bytes, ways)
    return {fabric_label: round(wire / float(fabric_bw) * 1e3, 4)}
