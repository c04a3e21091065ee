"""The online budget re-allocation (``budget/retune.py``) against the JAX
package, and its loop over two gloo ranks.

* The retuner on both packages over the same recorded series (the JAX
  tests' fixtures, ``tests/test_budget.py:300-395``: a series that drifts
  towards the least-fed leaf, and one that agrees with the startup spectra)
  and the same starting spectra and allocation: the same ``ks_new``, the
  same artifact epochs, the same incident keys and actions, for svd rank 3
  and qsgd 4 bits. The sample gate: no decision and no incident without a
  series.
* The loop's refusals (the JAX loop's texts): the doctor, no recorded
  series, no save cadence.
* The CLI over a gloo group of two ranks: LeNet svd rank 3 with
  ``--budget-alloc variance --obs-record --obs-quality --save-freq 8``
  arms the retuner with the JAX verb's line, re-allocates at a boundary
  (the recorded series of the run itself calls for it: a
  ``realloc->epoch1`` incident, a second epoch in ``budget_alloc.json``,
  the new ``budget_epoch`` column, a wire that moves with it), the JAX
  package's ``report`` over the directory passes ``budget_alloc_consistent``;
  a run killed after the boundary (``--chaos kill@19``, two ``torchrun``
  ranks) and resumed writes the straight run's final checkpoint bit for
  bit.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import pytest
import torch
from torch_dist import ROOT, Group

from atomo_tpu import budget as jb
from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.codecs.svd import SvdCodec as JaxSvd
from atomo_tpu.obs.report import build_report as jax_build_report
from atomo_tpu.utils.tracing import IncidentLog as JaxIncidents
from atomo_tpu_torch import budget as pb
from atomo_tpu_torch.codecs import QsgdCodec, SvdCodec
from atomo_tpu_torch.obs.recorder import FlightRecorder, metrics_path
from atomo_tpu_torch.obs.report import build_report
from atomo_tpu_torch.utils.tracing import IncidentLog, read_jsonl

torch.set_num_threads(1)

CODECS = {
    "svd3": (lambda: SvdCodec(rank=3), lambda: JaxSvd(rank=3)),
    "qsgd4": (lambda: QsgdCodec(bits=4), lambda: JaxQsgd(bits=4)),
}


def _grad_tree(key=0):
    """The JAX tests' gradient tree (``tests/test_budget.py:84``)."""
    k = jax.random.PRNGKey(key)
    return {
        "conv": jax.random.normal(k, (5, 5, 10, 20)),
        "fc": jax.random.normal(jax.random.fold_in(k, 1), (320, 50)) * 3.0,
        "bias": jax.random.normal(jax.random.fold_in(k, 2), (10,)),
        "fc2": jax.random.normal(jax.random.fold_in(k, 3), (50, 10)),
    }


def _start(code):
    """(port codec, JAX codec, port spectra, JAX spectra, JAX allocation):
    the port's spectra are the JAX package's field for field."""
    port_c, jax_c = (f() for f in CODECS[code])
    spectra = jb.measure_spectra(jax_c, _grad_tree())
    alloc = jb.solve_allocation(jax_c, spectra, mode="variance")
    return port_c, jax_c, [pb.LayerSpectrum(**dataclasses.asdict(s)) for s in spectra], \
        spectra, alloc


def _write_series(d, rows):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.jsonl"), "w") as f:
        for s, q in enumerate(rows, start=1):
            f.write(json.dumps({"kind": "step", "step": s, "q_err2": q}) + "\n")


def _run_both(tmp_path, code, rows, step=10):
    """The retuner of each package over the same series: (port's codec,
    JAX's codec, port's artifact, JAX's artifact, port's incidents, JAX's
    incidents)."""
    port_c, jax_c, p_spec, j_spec, alloc = _start(code)
    p_alloc = pb.Allocation(**dataclasses.asdict(alloc))
    out = []
    for pkg, codec, spec, a, mod_new, mod_write, mod_read, log, retuner in (
            ("port", port_c, p_spec, p_alloc, pb.new_alloc_doc, pb.write_alloc, pb.read_alloc,
             IncidentLog, pb.BudgetRetuner),
            ("jax", jax_c, j_spec, alloc, jb.new_alloc_doc, jb.write_alloc, jb.read_alloc,
             JaxIncidents, jb.BudgetRetuner)):
        d = str(tmp_path / pkg)
        doc = mod_new(codec, spec, a)
        mod_write(d, doc)
        if rows is not None:
            _write_series(d, rows)
        rt = retuner(train_dir=d, base_codec=codec, spectra=spec, alloc=a, doc=doc,
                     incidents=log.for_train_dir(d), log_fn=lambda *_: None)
        new = rt.maybe_realloc(step)
        recs = log.read(os.path.join(d, "incidents.jsonl"))
        out.append((new, mod_read(d), [r for r in recs if r.get("cause") == "budget_realloc"]))
    return out


def _drifted_rows(code):
    """The leaf the startup allocation fed least suddenly carries all the
    error mass (``test_retuner_reallocates_on_drifted_spectra``)."""
    _, _, _, spectra, alloc = _start(code)
    target = min((s for s in spectra if s.adaptive and alloc.ks[s.index] < s.r_full),
                 key=lambda s: (alloc.ks[s.index], s.index)).index
    row = [0.0] * len(spectra)
    row[target] = 1e6
    return [row] * 10, target


def _agreeing_rows(code):
    """q == A/k of the startup spectra (``..._keeps_without_signal_or_gain``);
    a QSGD leaf's law is B / (2^b - 1)^2."""
    _, jax_c, _, spectra, alloc = _start(code)
    row = [jb.allocator.variance_at(jax_c, s.a, alloc.ks[s.index]) if s.adaptive else 0.0
           for s in spectra]
    return [row] * 10


def _epochs(doc):
    return [{k: v for k, v in ep.items() if k != "predicted_variance"} for ep in doc["epochs"]]


@pytest.mark.parametrize("code", ["svd3", "qsgd4"])
def test_retuner_reallocates_on_drifted_spectra_as_jax(tmp_path, code):
    rows, target = _drifted_rows(code)
    (p_new, p_doc, p_inc), (j_new, j_doc, j_inc) = _run_both(tmp_path, code, rows)
    assert p_new is not None and j_new is not None
    assert p_new.ks == tuple(j_new.ks) and p_new.ks[target] > _start(code)[4].ks[target]
    assert _epochs(p_doc) == _epochs(j_doc) and len(p_doc["epochs"]) == 2
    assert p_doc["epochs"][1]["start_step"] == 10
    for a, b in zip(p_doc["epochs"], j_doc["epochs"]):
        assert a["predicted_variance"] == pytest.approx(b["predicted_variance"], rel=1e-12)
    (p,), (j,) = p_inc, j_inc
    assert sorted(p) == sorted(j) and p["action"] == j["action"] == "realloc->epoch1"
    assert p["ks_new"] == j["ks_new"] and p["ks_old"] == j["ks_old"] and p["moved"] == j["moved"]
    assert p["predicted_variance_old"] > p["predicted_variance_new"]


@pytest.mark.parametrize("code", ["svd3", "qsgd4"])
def test_retuner_keeps_without_signal_or_gain_as_jax(tmp_path, code):
    # no recorded series: not even a decision (no incident) on either side
    (p_new, p_doc, p_inc), (j_new, j_doc, j_inc) = _run_both(tmp_path / "none", code, None)
    assert p_new is None and j_new is None and p_inc == j_inc == []
    assert len(p_doc["epochs"]) == len(j_doc["epochs"]) == 1
    # a series that agrees with the startup spectra: keep, on the record
    (p_new, p_doc, p_inc), (j_new, j_doc, j_inc) = _run_both(
        tmp_path / "agree", code, _agreeing_rows(code))
    assert p_new is None and j_new is None
    (p,), (j,) = p_inc, j_inc
    assert sorted(p) == sorted(j) and p["action"] == j["action"] == "keep"
    assert p["reason"] == j["reason"] and len(p_doc["epochs"]) == 1


def test_retuner_sample_gate_and_window(tmp_path):
    """Fewer than ``min_samples`` records in (last boundary, step] is no
    decision; the window moves on with each decision."""
    port_c, _, spec, _, alloc = _start("svd3")
    d = str(tmp_path)
    doc = pb.new_alloc_doc(port_c, spec, pb.Allocation(**dataclasses.asdict(alloc)))
    rows, _ = _drifted_rows("svd3")
    _write_series(d, rows * 2)
    rt = pb.BudgetRetuner(train_dir=d, base_codec=port_c, spectra=spec,
                          alloc=pb.Allocation(**dataclasses.asdict(alloc)), doc=doc,
                          log_fn=lambda *_: None)
    assert rt._window_qerr2(7) is None  # 7 records: below the gate
    assert rt.maybe_realloc(10) is not None and rt.last_boundary == 10 and rt.epoch == 1
    assert rt._window_qerr2(17) is None and len(rt._window_qerr2(18)) == len(spec)


@pytest.mark.parametrize("kwargs,match", [
    (dict(diverge=True), "does not compose with --on-diverge"),
    (dict(track_quality=False), "needs its signal on disk"),
    (dict(save_freq=0), "needs a save cadence"),
], ids=["diverge", "no-signal", "no-cadence"])
def test_loop_refuses_with_the_jax_texts(tmp_path, kwargs, match):
    """The loop's preconditions (``atomo_tpu/parallel/replicated.py:
    3054-3072``), checked before any collective."""
    from atomo_tpu_torch.training import distributed_train_loop
    from atomo_tpu_torch.training.resilience import DetectorConfig, DivergeConfig

    kw = dict(track_quality=True, save_freq=2, train_dir=str(tmp_path), recorder=object())
    kw.update(kwargs)
    if kw.pop("diverge", False):
        kw["diverge"] = DivergeConfig(remedy="skip", detector=DetectorConfig(), max_rollbacks=1)
    with pytest.raises(ValueError, match=match):
        distributed_train_loop(None, None, None, codec=SvdCodec(rank=3), budget_tuner=object(),
                               **kw)


# ------------------------------------------------------- the loop, two ranks

LENET_SVD = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
             "--batch-size", "16", "--log-interval", "8", "--eval-freq", "0", "--device", "cpu",
             "--n-devices", "2", "--code", "svd", "--svd-rank", "3", "--budget-alloc",
             "variance", "--obs-record", "--obs-quality", "--save-freq", "8",
             "--aggregate", "gather"]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The 24-step run in a gloo group of two ranks: (dir, rank 0's lines)."""
    d = tmp_path_factory.mktemp("straight")
    g = Group(2, tmp_path_factory.mktemp("gloo2"))
    try:
        out = g.run("cli", argv=LENET_SVD + ["--max-steps", "24", "--train-dir", str(d)])
    finally:
        g.close()
    assert out[0]["rc"] == 0, out[0]
    return d, out[0]["lines"]


def test_cli_arms_the_retuner_and_reallocates(straight):
    d, lines = straight
    assert ("Budget: online re-allocation armed (q_err2-fed re-solve at checkpoint "
            "boundaries; decisions land in incidents.jsonl as budget_realloc)") in lines
    recs = [r for r in read_jsonl(os.path.join(str(d), "incidents.jsonl"))
            if r["cause"] == "budget_realloc"]
    assert [r["step"] for r in recs] == [8, 16, 24]
    assert "realloc->epoch1" in [r["action"] for r in recs]
    moved = next(r for r in recs if r["action"] == "realloc->epoch1")
    assert any(ln.startswith(f"Budget: spectrum drift re-allocation at step {moved['step']}: "
                             "epoch 0 -> 1") for ln in lines)
    doc = pb.read_alloc(str(d))
    assert [e["epoch"] for e in doc["epochs"]] == [0, 1]
    assert doc["epochs"][1]["start_step"] == moved["step"]
    steps = FlightRecorder.read_steps(metrics_path(str(d)))
    assert [s["budget_epoch"] for s in steps] == \
        [0 if s["step"] <= moved["step"] else 1 for s in steps]
    wire = {int(s["budget_epoch"]): s["msg_bytes"] for s in steps}
    assert wire[0] == doc["epochs"][0]["payload_bytes"] and \
        wire[1] == doc["epochs"][1]["payload_bytes"] and wire[0] != wire[1]


def test_report_audits_the_reallocated_run(straight):
    d, _ = straight
    for doc in (build_report(str(d)), jax_build_report(str(d))):
        check = [c for c in doc["checks"] if c["name"] == "budget_alloc_consistent"][0]
        assert check["ok"] and not check["skipped"], check


def test_kill_and_resume_across_the_boundary_equals_the_straight_run(straight, tmp_path):
    """``--chaos kill@19`` ends both ranks after the boundary at 16; the
    resumed run takes the recorded epoch and writes the straight run's
    checkpoint at 24 bit for bit."""
    d0, _ = straight
    d = tmp_path / "killed"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    for k in ("ATOMO_CHAOS", "ATOMO_RUN_ATTEMPT", "ATOMO_SUPERVISED", "WORLD_SIZE"):
        env.pop(k, None)

    def torchrun(*extra):
        with socket.socket() as sock:  # a free port for the rendezvous
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        return subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
             "--master-addr", "127.0.0.1", "--master-port", str(port), "-m", "atomo_tpu_torch",
             *LENET_SVD, "--max-steps", "24", "--train-dir", str(d), *extra], env=env,
            capture_output=True, text=True, timeout=240, cwd=str(ROOT))

    p = torchrun("--chaos", "kill@19")
    assert p.returncode != 0 and "CHAOS: killing process before step 19" in p.stderr
    p = torchrun("--resume")
    assert p.returncode == 0, p.stderr[-3000:]
    assert f"Resumed from {d} at step 16" in p.stdout
    assert "Budget: reusing recorded allocation epoch 1" in p.stdout
    assert (d / "model_step_24").read_bytes() == (d0 / "model_step_24").read_bytes()
    assert pb.read_alloc(str(d))["epochs"] == pb.read_alloc(str(d0))["epochs"]
    steps = FlightRecorder.read_steps(metrics_path(str(d)))
    assert [s["step"] for s in steps] == list(range(1, 25))
