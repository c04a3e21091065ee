"""The measured fabric (``obs/fabric.py``, ``--fabric measured``) against the
JAX package, and its probe over a gloo group of two ranks.

* The reading side equals the JAX functions on the same inputs:
  ``_fit_tier`` (hypothesis over ladder rows, and the degenerate sweeps),
  ``measured_bandwidths``, ``measured_outer_bw`` (and its refusal), the
  flat ``predicted_tier_ms`` and ``resolve_fabric(measured=)``.
* ``ensure_fabric_probe`` writes the artifact, reuses it on a resume of the
  same group shape, re-probes a changed shape, and reuses a probe taken
  under a non-dividing ``dcn_ways`` (the JAX tests' cases, the probe itself
  stubbed); ``measured_two_tier`` and the hierarchical ``predicted_tier_ms``
  equal the JAX functions on the same documents and fabrics (the two-tier
  probe over four ranks is ``test_torch_topology_cli.py``'s), and a
  one-device probe is refused.
* The CLI's preflight texts are the JAX verb's, and so is ``lm``'s refusal
  of ``--fabric measured`` (it has no probe).
* Over two gloo ranks: ``train --fabric measured`` writes a complete
  ``fabric_probe.json`` with one ``ici`` tier and the JAX document's keys,
  which the JAX package reads; the run prints the ``--aggregate auto`` line
  of the same run with ``--fabric`` pinned to the measured GB/s and ends in
  its checkpoint bit for bit (the probe draws nothing and leaves the data
  stream alone); ``--resume`` reuses the artifact.
"""

import json
import os
import re

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_dist import Group

from atomo_tpu import cli as jax_cli
from atomo_tpu.obs import fabric as J
from atomo_tpu.utils import comm_model as JC
from atomo_tpu_torch import cli
from atomo_tpu_torch.obs import fabric as P
from atomo_tpu_torch.utils import comm_model as PC

torch.set_num_threads(1)


def _fake_doc(tiers, n_dev=4):
    """A synthetic probe document: {label: (gbps, lat_us)}."""
    return {
        "kind": "fabric_probe",
        "meta": {"backend": "cpu", "n_devices": n_dev, "dcn_ways": 0, "reps": 1},
        "tiers": [{"label": lbl, "axis": "dp", "ways": n_dev, "bandwidth_gbps": g,
                   "latency_us": lat, "allgather_gbps": g, "rows": []}
                  for lbl, (g, lat) in tiers.items()],
        "complete": True,
    }


ROW = st.fixed_dictionaries({
    "bytes": st.integers(1, 1 << 24),
    "ppermute_ms": st.floats(0.0, 50.0, allow_nan=False),
    "allgather_ms": st.floats(0.0, 50.0, allow_nan=False),
    "sync_ok": st.booleans(),
})


@settings(max_examples=60, deadline=None)
@given(rows=st.lists(ROW, max_size=5), ways=st.integers(1, 8))
def test_fit_tier_equals_jax(rows, ways):
    assert P._fit_tier(rows, ways) == J._fit_tier(rows, ways)


@pytest.mark.parametrize("rows", [
    [],
    [{"bytes": 4096, "ppermute_ms": 0.1, "allgather_ms": 0.1, "sync_ok": False}],
    [{"bytes": 4096, "ppermute_ms": 0.2, "allgather_ms": 0.3}],
    [{"bytes": 4096, "ppermute_ms": 0.5, "allgather_ms": 0.1},
     {"bytes": 1 << 20, "ppermute_ms": 0.4, "allgather_ms": 0.9}],
    [{"bytes": 4096, "ppermute_ms": 0.0, "allgather_ms": 0.0},
     {"bytes": 4096, "ppermute_ms": 0.0, "allgather_ms": 0.0}],
], ids=["empty", "fence-failed", "one-row", "falling", "zero"])
def test_fit_tier_degenerate_sweeps_equal_jax(rows):
    for ways in (1, 2, 4):
        assert P._fit_tier(rows, ways) == J._fit_tier(rows, ways)


DOCS = {
    "flat": {"ici": (40.0, 2.0)},
    "two": {"ici": (40.0, 2.0), "dcn": (5.0, 20.0)},
    "unusable": {"ici": (None, None)},
    "none": {},
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_measured_bandwidths_and_outer_bw_equal_jax(name):
    doc = _fake_doc(DOCS[name])
    assert P.measured_bandwidths(doc) == J.measured_bandwidths(doc)
    try:
        want = J.measured_outer_bw(doc)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.measured_outer_bw(doc)
        assert str(got.value) == str(e)
        return
    assert P.measured_outer_bw(doc) == want


@pytest.mark.parametrize("name", sorted(DOCS))
def test_resolve_fabric_measured_equals_jax(name):
    doc = _fake_doc(DOCS[name])
    try:
        want = JC.resolve_fabric("measured", measured=doc)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PC.resolve_fabric("measured", measured=doc)
        assert str(got.value) == str(e)
        return
    assert PC.resolve_fabric("measured", measured=doc) == want


def test_resolve_fabric_measured_without_a_document_is_the_jax_refusal():
    with pytest.raises(ValueError) as want:
        JC.resolve_fabric("measured")
    with pytest.raises(ValueError) as got:
        PC.resolve_fabric("measured")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("aggregate", ["gather", "ring", "psum"])
@pytest.mark.parametrize("payload", [0.0, 3.0e5])
@pytest.mark.parametrize("ways,bw", [(1, 4e10), (4, 4e10), (8, None), (2, 1.25e9)])
def test_predicted_tier_ms_flat_equals_jax(aggregate, payload, ways, bw):
    kw = dict(aggregate=aggregate, dense_bytes=4.4e7, payload_bytes=payload, ways=ways,
              fabric_bw=bw, fabric_label="measured_ici")
    assert P.predicted_tier_ms(**kw) == J.predicted_tier_ms(**kw)


def _fabric_fields(f) -> tuple:
    return (f.inner_bw, f.outer_bw, f.inner_ways, f.outer_ways, f.inner_latency_s,
            f.outer_latency_s, f.inner_label, f.outer_label)


# (probe document's tiers, dcn_ways, n_dev): both tiers; the dcn tier
# standing in for a one-card inner group (dcn_ways == n_dev); a tier missing
TWO_TIER = {
    "two": (DOCS["two"], 2, 4),
    "one_card_groups": ({"dcn": (5.0, 20.0)}, 4, 4),
    "flat_only": (DOCS["flat"], 2, 4),
    "none": ({}, 2, 4),
}


@pytest.mark.parametrize("name", sorted(TWO_TIER))
def test_measured_two_tier_equals_jax(name):
    tiers, k, n = TWO_TIER[name]
    doc = _fake_doc(tiers, n_dev=n)
    try:
        want = J.measured_two_tier(doc, dcn_ways=k, n_dev=n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.measured_two_tier(doc, dcn_ways=k, n_dev=n)
        assert str(got.value) == str(e)
        return
    assert _fabric_fields(P.measured_two_tier(doc, dcn_ways=k, n_dev=n)) == \
        _fabric_fields(want)


def test_measured_two_tier_without_latency_takes_the_cards_anchors():
    """A tier without a fitted latency falls back to the port's stated
    NVLink and NIC hop latencies (the JAX package's are TPU estimates)."""
    from atomo_tpu_torch.topology.fabric import NIC_HOP_LATENCY_S, NVLINK_HOP_LATENCY_S

    f = P.measured_two_tier(_fake_doc({"ici": (40.0, None), "dcn": (5.0, None)}),
                            dcn_ways=2, n_dev=4)
    assert (f.inner_latency_s, f.outer_latency_s) == (NVLINK_HOP_LATENCY_S, NIC_HOP_LATENCY_S)
    assert (f.inner_bw, f.outer_bw) == (40e9, 5e9)


def test_probe_of_one_device_keeps_the_multi_device_refusal():
    with pytest.raises(ValueError, match="multi-device"):
        P.probe_fabric(n_dev=1)
    with pytest.raises(ValueError, match="multi-device"):
        P.probe_fabric(n_dev=1, dcn_ways=2)


@pytest.mark.parametrize("plan", [None, "psum+gather", "psum+ring", "cring+gather",
                                  "cring+ring", "cring+psum"])
@pytest.mark.parametrize("payload", [0.0, 3.0e5])
def test_predicted_tier_ms_hierarchical_equals_jax(plan, payload):
    from atomo_tpu.topology import TwoTierFabric as JF
    from atomo_tpu_torch.topology import TwoTierFabric as PF

    fields = dict(inner_bw=4e10, outer_bw=1.25e9, inner_ways=2, outer_ways=2,
                  inner_latency_s=2e-6, outer_latency_s=2e-5, inner_label="measured_ici",
                  outer_label="measured_dcn")
    kw = dict(aggregate="hierarchical", dense_bytes=4.4e7, payload_bytes=payload, ways=4,
              plan_name=plan)
    assert P.predicted_tier_ms(fabric2=PF(**fields), **kw) == \
        J.predicted_tier_ms(fabric2=JF(**fields), **kw)


def _stub(monkeypatch):
    """probe_fabric replaced by a recorder of its calls returning a fake
    document of the asked shape (the JAX tests stub the ladder the same
    way: only the reuse rules are under test)."""
    calls = []

    def fake(**kw):
        calls.append(kw)
        k = int(kw.get("dcn_ways") or 0)
        n = int(kw["n_dev"])
        doc = _fake_doc({"ici": (40.0, 2.0)}, n_dev=n)
        doc["meta"]["dcn_ways"] = k if (1 < k <= n and n % k == 0) else 0
        return doc

    monkeypatch.setattr(P, "probe_fabric", fake)
    return calls


def test_ensure_probe_writes_reuses_and_reprobes(tmp_path, monkeypatch):
    calls = _stub(monkeypatch)
    d, quiet = str(tmp_path), (lambda *_: None)
    doc = P.ensure_fabric_probe(d, n_dev=4, log_fn=quiet)
    assert os.path.exists(P.probe_path(d)) and len(calls) == 1
    assert P.read_fabric_probe(d)["complete"] is True
    assert J.read_fabric_probe(d) == P.read_fabric_probe(d)  # the JAX reader takes it
    lines = []
    assert P.ensure_fabric_probe(d, n_dev=4, reuse=True, log_fn=lines.append)["meta"] == \
        doc["meta"]
    assert len(calls) == 1 and lines == [f"Fabric probe: reusing {P.probe_path(d)} "
                                         "(delete the file to re-measure)"]
    # ... but never a measurement of a group shape that no longer exists
    P.ensure_fabric_probe(d, n_dev=2, reuse=True, log_fn=quiet)
    assert len(calls) == 2 and P.read_fabric_probe(d)["meta"]["n_devices"] == 2
    # without reuse (a fresh run) the probe always runs; a non-writer rank
    # probes and writes nothing
    os.remove(P.probe_path(d))
    P.ensure_fabric_probe(d, n_dev=2, log_fn=quiet, write=False)
    assert len(calls) == 3 and not os.path.exists(P.probe_path(d))


def test_ensure_probe_reuse_normalizes_nondividing_dcn(tmp_path, monkeypatch):
    calls = _stub(monkeypatch)
    d = str(tmp_path)
    P.ensure_fabric_probe(d, n_dev=4, dcn_ways=3, log_fn=lambda *_: None)
    assert P.read_fabric_probe(d)["meta"]["dcn_ways"] == 0
    P.ensure_fabric_probe(d, n_dev=4, dcn_ways=3, reuse=True, log_fn=lambda *_: None)
    assert len(calls) == 1


def test_quick_probe_is_the_jax_sweep(monkeypatch):
    """The drift-blame re-probe: the JAX package's two sizes, one rep."""
    calls = _stub(monkeypatch)
    P.quick_probe(n_dev=2, log_fn=lambda *_: None)
    (kw,) = calls
    assert P.QUICK_SIZES == J.QUICK_SIZES and P.DEFAULT_SIZES == J.DEFAULT_SIZES
    assert (kw["sizes"], kw["reps"], kw["warmup"], kw["best_of"]) == (J.QUICK_SIZES, 1, 1, 1)


def test_read_fabric_probe_tolerates_torn_files(tmp_path):
    (tmp_path / P.FABRIC_PROBE_NAME).write_text('{"kind": "fabric_pro')
    assert P.read_fabric_probe(str(tmp_path)) is None
    (tmp_path / P.FABRIC_PROBE_NAME).write_text("[1, 2]")
    assert P.read_fabric_probe(str(tmp_path)) is None


@pytest.mark.parametrize("argv", [
    ["--train-dir", "", "--n-devices", "4"],
    ["--train-dir", "x", "--n-devices", "1"],
], ids=["no-train-dir", "one-device"])
def test_preflight_texts_are_the_jax_verbs(argv):
    argv = ["train", "--fabric", "measured", "--synthetic"] + argv
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"], log_fn=lambda _: None)
    assert str(got.value.code) == str(want.value.code)


def test_one_resolved_device_is_refused_with_the_jax_text(tmp_path, monkeypatch):
    """``--n-devices 0`` with no group resolves to one device: the JAX
    verb's resolved-count text (``atomo_tpu/cli.py:2470-2476``)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as got:
        cli.main(["train", "--fabric", "measured", "--synthetic", "--train-dir",
                  str(tmp_path), "--device", "cpu"], log_fn=lambda _: None)
    assert str(got.value.code) == (
        "--fabric measured needs a multi-device mesh: this host resolved to 1 device, "
        "so there is no inter-chip fabric to measure")


def test_lm_fabric_measured_is_the_jax_verbs():
    """``lm`` has no startup probe: under ``--aggregate auto`` the token is
    the JAX verb's refusal, word for word."""
    argv = ["lm", "--fabric", "measured", "--layout", "dp", "--vocab-size", "16", "--seq-len",
            "8", "--width", "16", "--depth", "1", "--num-heads", "2", "--batch-size", "8",
            "--max-steps", "1", "--code", "svd", "--svd-rank", "2"]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"], log_fn=lambda _: None)
    assert str(got.value.code) == str(want.value.code) and "fabric_probe.json" in \
        str(got.value.code)


# ------------------------------------------------------------- two ranks

# the codec tax pinned far above any wire saving a gloo fabric can show:
# ``--aggregate auto`` prints its NOTE (and with it the GB/s it priced on)
# only where the saving at the measured rate falls below the tax, and the
# default tax (the card's anchor scaled to LeNet's 1.72 MB) sits near the
# saving at 1 GB/s, which a probe of two loaded CPU ranks can measure
LENET = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic", "--batch-size",
         "16", "--log-interval", "2", "--eval-freq", "0", "--device", "cpu", "--n-devices",
         "2", "--code", "qsgd", "--codec-tax-ms", "100000", "--max-steps", "4",
         "--save-freq", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Over one gloo group of two ranks: the measured run, the run pinned to
    its GB/s, and the measured run resumed to step 6. Rank 0's answers."""
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    try:
        measured = tmp_path_factory.mktemp("measured")
        out = {"measured": g.run("cli", argv=LENET + ["--fabric", "measured", "--train-dir",
                                                      str(measured)])[0]}
        doc = json.loads((measured / P.FABRIC_PROBE_NAME).read_text())
        gbps = doc["tiers"][0]["bandwidth_gbps"]
        pinned = tmp_path_factory.mktemp("pinned")
        out["pinned"] = g.run("cli", argv=LENET + ["--fabric", repr(gbps), "--train-dir",
                                                   str(pinned)])[0]
        out["resumed"] = g.run("cli", argv=LENET[:-4] + [
            "--max-steps", "6", "--save-freq", "2", "--fabric", "measured", "--resume",
            "--train-dir", str(measured)])[0]
    finally:
        g.close()
    for r in out.values():
        assert r["rc"] == 0 and r["exit"] is None, r
    return out, measured, pinned, doc


def test_probe_over_two_gloo_ranks_writes_the_jax_document(runs):
    out, measured, _, doc = runs
    assert doc["kind"] == "fabric_probe" and doc["complete"] is True
    (tier,) = doc["tiers"]
    assert sorted(tier) == ["allgather_gbps", "axis", "bandwidth_gbps", "label", "latency_us",
                            "rows", "ways"]
    assert tier["label"] == "ici" and tier["ways"] == 2 and tier["bandwidth_gbps"] > 0
    assert [r["bytes"] for r in tier["rows"]] == list(J.DEFAULT_SIZES)
    assert all(sorted(r) == ["allgather_ms", "bytes", "ppermute_ms", "sync_ok"] and r["sync_ok"]
               for r in tier["rows"])
    assert {k: doc["meta"][k] for k in ("backend", "group_backend", "buffers", "n_devices",
                                        "dcn_ways")} == {
        "backend": "cpu", "group_backend": "gloo", "buffers": "cpu", "n_devices": 2,
        "dcn_ways": 0}
    assert J.measured_bandwidths(J.read_fabric_probe(str(measured))) == {
        "ici": tier["bandwidth_gbps"] * 1e9}
    lines = out["measured"]["lines"]
    assert lines[0].startswith(f"Fabric probe: ici (2 ways, gloo group, cpu buffers) measured "
                               f"{tier['bandwidth_gbps']} GB/s/chip")
    assert lines[1] == f"Fabric probe: artifact -> {P.probe_path(str(measured))}"


def test_measured_prices_and_trains_as_the_pinned_run(runs):
    out, measured, pinned, doc = runs

    def auto(lines):
        return [ln for ln in lines if ln.startswith("--aggregate auto ->")]

    def workers(lines):
        return [re.sub(r"Time Cost: [0-9.]+", "", ln) for ln in lines
                if ln.startswith("Worker:")]

    gbps = doc["tiers"][0]["bandwidth_gbps"]
    assert auto(out["measured"]["lines"]) == auto(out["pinned"]["lines"])
    assert f"on {gbps:.2f} GB/s/chip" in auto(out["measured"]["lines"])[0]
    assert workers(out["measured"]["lines"]) == workers(out["pinned"]["lines"])
    # the trajectory and the data stream are untouched: the same states
    for s in (2, 4):
        assert (measured / f"model_step_{s}").read_bytes() == \
            (pinned / f"model_step_{s}").read_bytes()


def test_resume_reuses_the_recorded_probe(runs):
    out, measured, _, doc = runs
    lines = out["resumed"]["lines"]
    assert f"Fabric probe: reusing {P.probe_path(str(measured))} (delete the file to " \
        "re-measure)" in lines
    assert not any(ln.startswith("Fabric probe: ici") for ln in lines)
    assert json.loads((measured / P.FABRIC_PROBE_NAME).read_text()) == doc
