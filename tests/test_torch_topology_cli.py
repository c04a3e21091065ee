"""``train --aggregate hierarchical --dcn-ways K --plan P`` and the two-tier
branch of ``--aggregate auto``, against the JAX verb.

* The argv refusals of ``--plan`` and of hierarchical aggregation beside
  the flags that do not compose with it equal the JAX verb's texts (no
  ranks: the preflight runs before any process group).
* ``--aggregate auto --dcn-ways 2 --fabric 45:1.25 --codec-tax-ms 30``
  prints ``--aggregate auto -> hierarchical (...)`` with the JAX verb's
  plan and per-tier byte figures (LeNet, qsgd 4 bits and svd rank 3, 4
  devices); the ms figures are the port's own (its latency anchors). A
  pinned ``--plan`` is priced and stashes no plan, as in the JAX verb.
* Over four CPU gloo ranks: ``train --n-devices 4 --aggregate hierarchical
  --dcn-ways 2`` (the legacy plan: no ``Topology plan:`` line) and ``--plan
  cring+gather`` (the line), each with the ``Worker:`` lines of the JAX
  verb's Msg(MB) (the slow tier's payload); ``--aggregate auto --dcn-ways 2
  --fabric measured --plan psum+gather`` writes a probe document with both
  tiers, which the JAX package's ``measured_two_tier`` reads as the port's
  does, and its advisory prices the pinned plan from it.
* ``--plan`` on one device warns with the JAX verb's text and trains; the
  evaluator takes the new flags.
"""

import json
import re

import pytest
import torch
from torch_dist import Groups

from atomo_tpu import cli as jax_cli
from atomo_tpu.obs import fabric as JF
from atomo_tpu_torch import cli
from atomo_tpu_torch.obs import fabric as PF

torch.set_num_threads(1)

BASE = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic", "--n-devices", "4",
        "--max-steps", "1"]
TRAIN = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic", "--batch-size",
         "16", "--log-interval", "1", "--eval-freq", "0", "--device", "cpu", "--n-devices",
         "4", "--code", "qsgd", "--max-steps", "2"]

REFUSALS = {
    "bad_plan": ["--aggregate", "hierarchical", "--dcn-ways", "2", "--plan", "warp+drive",
                 "--code", "svd"],
    "plan_flat": ["--aggregate", "gather", "--plan", "cring+ring", "--code", "svd"],
    "delayed_hier": ["--overlap", "delayed", "--aggregate", "hierarchical", "--code", "qsgd"],
    "delayed_plan": ["--overlap", "delayed", "--plan", "cring+ring", "--code", "qsgd"],
    "stream_hier": ["--stream-encode", "on", "--aggregate", "hierarchical", "--code", "qsgd"],
    "stream_plan": ["--stream-encode", "on", "--plan", "cring+ring", "--code", "qsgd"],
    "sparse_hier": ["--sparse-rows", "on", "--aggregate", "hierarchical", "--code", "qsgd"],
    "sparse_plan": ["--sparse-rows", "auto", "--plan", "psum+ring", "--code", "qsgd"],
    "quality_hier": ["--obs-quality", "--aggregate", "hierarchical", "--code", "qsgd"],
    "quality_plan": ["--obs-quality", "--plan", "cring+psum", "--code", "qsgd"],
    "budget_hier": ["--budget-alloc", "variance", "--aggregate", "hierarchical", "--code",
                    "qsgd"],
    "ef_hier": ["--error-feedback", "--aggregate", "hierarchical", "--code", "qsgd"],
    "ef_plan": ["--error-feedback", "--plan", "cring+gather", "--code", "qsgd"],
    "quorum_hier": ["--quorum", "1", "--aggregate", "hierarchical", "--code", "qsgd"],
    "quorum_plan": ["--quorum", "1", "--plan", "cring+gather", "--code", "qsgd"],
    "densify_hier": ["--on-diverge", "densify", "--aggregate", "hierarchical", "--code",
                     "qsgd", "--grad-guard", "--train-dir", "/nonexistent/t",
                     "--save-freq", "2"],
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_argv_refusals_are_the_jax_verbs(name):
    argv = BASE + REFUSALS[name]
    with pytest.raises(SystemExit) as want:
        jax_cli._argv_preflight(jax_cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"], log_fn=lambda _: None)
    assert str(got.value.code) == str(want.value.code)


# ------------------------------------------------------------ the advisory

MOVES = re.compile(r"(inner|outer) tier moves ([0-9.]+) MB/chip over (\S+) @ ([0-9.]+) GB/s")


def _auto_lines(code_flags, extra=()):
    """(port's line, port's stashed plan, JAX's line, JAX's stashed plan)."""
    import jax.numpy as jnp

    from atomo_tpu.codecs import get_codec
    from atomo_tpu.models import get_model
    from atomo_tpu.tuning.probe import model_init_fn

    argv = BASE + ["--aggregate", "auto", "--dcn-ways", "2", "--fabric", "45:1.25",
                   "--codec-tax-ms", "30"] + code_flags + list(extra)
    pargs = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    model, _ = cli._model_and_test_iter(pargs)
    lines = []
    assert cli.resolve_auto_aggregate(pargs, cli._codec(pargs), model, 4,
                                      log=lines.append) == "hierarchical"
    jargs = jax_cli.build_parser().parse_args(argv)
    jlines = []
    jcodec = get_codec(jargs.code, svd_rank=jargs.svd_rank,
                       quantization_level=jargs.quantization_level,
                       bucket_size=jargs.bucket_size, sample=jargs.sample)
    init = model_init_fn(get_model("lenet", 10), jnp.zeros((1, 28, 28, 1), jnp.float32))
    assert jax_cli._resolve_auto_aggregate(jargs, jcodec, init, 4,
                                           log=jlines.append) == "hierarchical"
    assert len(lines) == len(jlines) == 1
    return (lines[0], getattr(pargs, "_auto_plan", None), jlines[0],
            getattr(jargs, "_auto_plan", None))


@pytest.mark.parametrize("code_flags", [["--code", "qsgd"], ["--code", "svd", "--svd-rank", "3"]],
                         ids=["qsgd4", "svd3"])
def test_auto_two_tier_advisory_is_the_jax_plan_and_bytes(code_flags):
    line, plan, jline, jplan = _auto_lines(code_flags)
    assert plan == jplan and plan is not None
    assert line.startswith("--aggregate auto -> hierarchical (inner 2x 45GBps @ 45.00 "
                           "GB/s/chip, outer 2x 1.25GBps @ 1.25 GB/s/chip; plan " + plan)
    assert MOVES.findall(line) == MOVES.findall(jline) and len(MOVES.findall(line)) == 2
    runner = re.compile(r"runner-up (\S+) at")
    assert runner.findall(line) == runner.findall(jline)


def test_auto_two_tier_advisory_prices_a_pinned_plan():
    line, plan, jline, jplan = _auto_lines(["--code", "qsgd"], ["--plan", "cring+ring"])
    assert plan is None and jplan is None
    assert "plan cring+ring predicted" in line and line.endswith(
        " — pinned by --plan, planner selection skipped)")
    assert MOVES.findall(line) == MOVES.findall(jline)


# ------------------------------------------------------------- four ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Over one gloo group of four ranks: the legacy plan, cring+gather, and
    the measured two-tier probe with a pinned plan. Rank 0's answers."""
    gs = Groups(tmp_path_factory, "topocli")
    try:
        g = gs[4]
        measured = tmp_path_factory.mktemp("measured")
        out = {
            "legacy": g.run("cli", argv=TRAIN + ["--aggregate", "hierarchical", "--dcn-ways",
                                                 "2", "--train-dir", ""])[0],
            "cring": g.run("cli", argv=TRAIN + ["--aggregate", "hierarchical", "--dcn-ways",
                                                "2", "--plan", "cring+gather",
                                                "--train-dir", ""])[0],
            "measured": g.run("cli", argv=TRAIN + [
                "--aggregate", "auto", "--dcn-ways", "2", "--fabric", "measured", "--plan",
                "psum+gather", "--codec-tax-ms", "30", "--train-dir", str(measured)])[0],
        }
    finally:
        gs.close()
    for r in out.values():
        assert r["rc"] == 0 and r["exit"] is None, r
    return out, measured


def _msg_mb(lines):
    return [re.search(r"Msg\(MB\): +([0-9.]+)", ln).group(1) for ln in lines
            if ln.startswith("Worker:")]


def _jax_msg_mb() -> str:
    """The JAX verb's Msg(MB) of the two-tier step: one payload on the slow
    tier, the JAX codec's encode of LeNet's gradient tree."""
    import jax
    import jax.numpy as jnp

    from atomo_tpu.codecs import QsgdCodec, encode_tree
    from atomo_tpu.models import get_model

    params = get_model("lenet", 10).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 28, 28, 1), jnp.float32))["params"]
    _, stats = encode_tree(QsgdCodec(bits=4), jax.random.PRNGKey(1), params)
    return f"{stats.payload_bytes / 2 ** 20:.4f}"  # the Worker line's MB: MiB


def test_four_ranks_train_the_legacy_and_a_pinned_plan(runs):
    out, _ = runs
    want = _jax_msg_mb()
    legacy, cring = out["legacy"]["lines"], out["cring"]["lines"]
    assert not any(ln.startswith("Topology plan:") for ln in legacy)
    assert "Topology plan: cring+gather" in cring
    for lines in (legacy, cring):
        assert _msg_mb(lines) == [want, want]
        assert [ln.split(",")[1] for ln in lines if ln.startswith("Worker:")] == \
            [" Step: 1", " Step: 2"]


def test_four_ranks_probe_both_tiers(runs):
    out, measured = runs
    doc = json.loads((measured / PF.FABRIC_PROBE_NAME).read_text())
    assert doc["complete"] is True and doc["meta"]["dcn_ways"] == 2
    assert [(t["label"], t["axis"], t["ways"]) for t in doc["tiers"]] == [
        ("ici", "ici", 2), ("dcn", "dp", 2)]
    assert all(t["bandwidth_gbps"] > 0 for t in doc["tiers"])
    p = PF.measured_two_tier(doc, dcn_ways=2, n_dev=4)
    j = JF.measured_two_tier(doc, dcn_ways=2, n_dev=4)
    assert (p.inner_bw, p.outer_bw, p.inner_latency_s, p.outer_latency_s, p.inner_label) == \
        (j.inner_bw, j.outer_bw, j.inner_latency_s, j.outer_latency_s, j.inner_label)
    lines = out["measured"]["lines"]
    assert lines[0].startswith("Fabric probe: ici (2 ways, gloo group, cpu buffers) measured")
    assert lines[1].startswith("Fabric probe: dcn (2 ways, gloo group, cpu buffers) measured")
    (auto,) = [ln for ln in lines if ln.startswith("--aggregate auto -> ")]
    assert auto.startswith(f"--aggregate auto -> hierarchical ({p.describe()}; plan "
                           "psum+gather predicted")
    assert auto.endswith(" — pinned by --plan, planner selection skipped)")
    assert "Topology plan: psum+gather" in lines
    assert _msg_mb(lines) == [_jax_msg_mb()] * 2


def test_plan_on_one_device_warns_as_the_jax_verb(capsys):
    argv = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
            "--batch-size", "8", "--max-steps", "1", "--log-interval", "1", "--eval-freq", "0",
            "--n-devices", "1", "--code", "qsgd", "--plan", "cring+ring", "--train-dir", ""]
    with pytest.warns(UserWarning) as want:
        assert jax_cli.main(argv) == 0
    capsys.readouterr()
    lines = []
    with pytest.warns(UserWarning) as got:
        assert cli.main(argv + ["--device", "cpu"], log_fn=lines.append) == 0
    plan_warning = [str(w.message) for w in want if "--plan" in str(w.message)]
    assert plan_warning and [str(w.message) for w in got if "--plan" in str(w.message)] == \
        plan_warning
    assert any(ln.startswith("Worker: 0, Step: 1,") for ln in lines)


def test_evaluate_takes_the_two_tier_flags():
    args = cli.build_parser().parse_args(["evaluate", "--aggregate", "hierarchical",
                                          "--dcn-ways", "2", "--plan", "cring+ring"])
    assert (args.aggregate, args.dcn_ways, args.plan) == ("hierarchical", 2, "cring+ring")


@pytest.mark.parametrize("k", [1, 3, 8])
def test_bad_dcn_ways_exits_with_the_jax_text(k):
    """A K that is not a two-tier split of 4 devices exits with the JAX
    verb's text (``atomo_tpu/cli.py:3012-3016``) before any group is made."""
    args = cli.build_parser().parse_args(BASE + ["--aggregate", "hierarchical", "--dcn-ways",
                                                 str(k), "--code", "qsgd"])
    with pytest.raises(SystemExit) as got:
        cli._two_tier(args, cli._codec(args), 4, log=lambda _: None)
    assert str(got.value.code) == (f"--dcn-ways {k} must divide --n-devices 4 (outer "
                                   "slow-fabric groups x inner fast-fabric chips)")


def test_probe_and_step_share_one_built_mesh(monkeypatch):
    """``--fabric measured --dcn-ways 2``: the probe and the step take the
    same mesh, whose groups are made once (one ``build``)."""
    from types import SimpleNamespace

    from atomo_tpu_torch.mesh.spec import MeshSpec, ProcessMesh

    built, probed = [], []
    monkeypatch.setattr(MeshSpec, "build", lambda self: built.append(self)
                        or ProcessMesh(self, (0, 0), (None, None)))
    monkeypatch.setattr(PF, "ensure_fabric_probe",
                        lambda *a, mesh=None, **kw: probed.append(mesh) or {"tiers": []})
    args = cli.build_parser().parse_args(BASE + [
        "--aggregate", "hierarchical", "--dcn-ways", "2", "--code", "qsgd", "--fabric",
        "measured", "--train-dir", "/nonexistent/t", "--device", "cpu"])
    cli._fabric_probe(args, 4, SimpleNamespace(rank=0, device=torch.device("cpu")),
                      lambda _: None)
    mesh, plan = cli._two_tier(args, cli._codec(args), 4, log=lambda _: None)
    assert built == [MeshSpec.from_world(4, 2)] and probed == [mesh] and plan is None
