"""The resilience stack's pure parts against the JAX package's, on the CPU.

Every chaos spec of ``tests/test_chaos.py`` (and the bad ones) parses to the
same fields, with the same error text; the in-step faults give the same
gradients (the host selector for an int step and the device table for a
tensor step alike); the file damage is the same byte for byte; the guard's
helpers (``grad_ok``, ``select_state``, ``zero_if``, ``rescale_by_survivors``,
``remedy_scale``) give equal values on the same numpy inputs (exactly:
elementwise float32 arithmetic); the detector gives the same states and
alarms on the same series for any block partition (hypothesis); the
conflict matrix gives the same text row by row; the backoff the same
delays from the same seed; the incident logs of both packages read and
summarize alike; healthy tags, ``prune_after`` and the retention anchor;
``restream`` replays ``forever``'s batches; and row 2's flag form on the CPU
(its plain twin), on a gathered buffer whose masked replica holds NaN
scales, equals the decode of the JAX package's ``_mask_gathered`` payloads
bit for bit, and the JAX package's masked ``decode_mean_tree`` within 4 ulp
of each leaf's largest value (its ``jnp.mean`` may sum the replicas in
another order, which shows where they cancel, and multiplies by 1/N).
"""

import dataclasses
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import atomo_tpu.training.resilience as JR
import atomo_tpu.utils.chaos as JC
import atomo_tpu.utils.tracing as JT
import atomo_tpu_torch.training.resilience as R
import atomo_tpu_torch.utils.chaos as C
import atomo_tpu_torch.utils.tracing as T
from atomo_tpu_torch.training import checkpoint as CK

torch.set_num_threads(1)

SPECS = [
    "nan@3,inf@5,explode@7,slow@2:0.5,kill@6,truncate@4,bitflip@8,badmagic@9",
    "nan@2,inf@5*", "spike@7:3,crashloop@2", "spike@5", "die@5:1", "die@3",
    "slow@4:2:0.3", "slow@3", "hostdie@3:1", "slowlink@2:1:0.5",
    "partition@3:0-1:0.8", "kill@4", "crashloop@5", "nan@2*", " nan@1 , ,kill@3 ",
    "explode@4,spike@1:2,die@2:3,slow@1:0:1e-2",
]
BAD_SPECS = [
    "frobnicate@3", "nan", "nan@x", "kill@3:oops,", "spike@5:0", "die@3:-1",
    "slow@2:-1:0.5", "slow@2:1:0", "slowlink@2:1", "slowlink@2:-1:1",
    "partition@2:1:1", "partition@2:1-1:1", "partition@2:0-1:0", "kill@3:1:2",
    "nan@4,inf@4", "hostdie@2:-1", "frob@3",
]


def _error(fn, *args, **kw):
    try:
        return fn(*args, **kw), None
    except ValueError as exc:
        return None, str(exc)


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_to_the_jax_fields(spec):
    env = {"ATOMO_CHAOS_SEED": "7", "ATOMO_CHAOS_SPIKE_SCALE": "12.5"}
    mine, want = C.ChaosConfig.from_spec(spec, environ=env), JC.ChaosConfig.from_spec(
        spec, environ=env)
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    assert mine.enabled() == want.enabled()
    assert C.CHAOS_EXIT_CODE == JC.CHAOS_EXIT_CODE == 43


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_chaos_spec_raises_the_jax_text(spec):
    _, mine = _error(C.ChaosConfig.from_spec, spec, environ={})
    _, want = _error(JC.ChaosConfig.from_spec, spec, environ={})
    assert want is not None and mine == want


def test_chaos_env_paths_match_jax():
    for env in ({}, {"ATOMO_CHAOS": "  "}, {"ATOMO_CHAOS": "kill@4", "ATOMO_CHAOS_SEED": "7"},
                {"ATOMO_CHAOS": "spike@4:2", "ATOMO_CHAOS_SPIKE_SCALE": "12.5"}):
        mine, want = C.ChaosConfig.from_env(env), JC.ChaosConfig.from_env(env)
        assert (mine is None) == (want is None)
        if mine is not None:
            assert dataclasses.asdict(mine) == dataclasses.asdict(want)
            assert C.ChaosInjector.from_env(env).should_die(4) == \
                JC.ChaosInjector.from_env(env).should_die(4)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 3))]


@pytest.mark.parametrize("spec", ["nan@2,inf@3,explode@4", "nan@2,inf@5*", "spike@3:2",
                                  "die@2:1", "die@3:0,spike@1:1,explode@5*"])
@pytest.mark.parametrize("replica", [None, 0, 1])
def test_injected_gradients_equal_jax(spec, replica):
    """Every step 1..6, host int and device-table step alike, against JAX's
    in-graph injection (NaN where JAX has NaN, the same values elsewhere)."""
    cfg = C.ChaosConfig.from_spec(spec, environ={})
    mine, want_inj = C.ChaosInjector(cfg, membership_epoch=0), JC.ChaosInjector(
        JC.ChaosConfig.from_spec(spec, environ={}), membership_epoch=0)
    g = _grads()
    for step in range(1, 7):
        rep = None if replica is None else jnp.int32(replica)
        want = [np.asarray(w) for w in want_inj.inject_grads(
            [jnp.asarray(a) for a in g], jnp.int32(step), replica=rep)]
        for s in (step, torch.tensor(step)):
            got = mine.inject_grads([torch.from_numpy(a) for a in g], s, replica=replica)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b)


def test_generations_and_host_faults_match_jax():
    spec = "spike@3:2,nan@5,kill@7,slow@2:0.01,truncate@4,slow@1:1:0.2,crashloop@2"
    mine = C.ChaosInjector(C.ChaosConfig.from_spec(spec, environ={}), membership_epoch=0)
    want = JC.ChaosInjector(JC.ChaosConfig.from_spec(spec, environ={}), membership_epoch=0)
    for gen in (0, 1):
        m, w = mine.with_generation(gen), want.with_generation(gen)
        for step in range(1, 9):
            assert m.should_die(step) == w.should_die(step)
            assert m.ckpt_fault_for(step) == w.ckpt_fault_for(step)
            assert m.grad_fault_code(step) == int(w.grad_fault_code(step))
            assert m.replica_delays(step, 3) == w.replica_delays(step, 3)
        assert m.maybe_sleep(2) == w.maybe_sleep(2)
        assert m.config.crashloop == w.config.crashloop == 2


@pytest.mark.parametrize("kind,seed", [("truncate", 0), ("bitflip", 5), ("bitflip", 11),
                                       ("badmagic", 0)])
def test_file_damage_equals_jax(tmp_path, kind, seed):
    blob = bytes(range(256)) * 3
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_bytes(blob)
    b.write_bytes(blob)
    C.corrupt_file(str(a), kind, seed=seed)
    JC.corrupt_file(str(b), kind, seed=seed)
    assert a.read_bytes() == b.read_bytes() != blob
    with pytest.raises(ValueError, match="unknown corruption kind"):
        C.corrupt_file(str(a), "gamma-ray")


# ------------------------------------------------------------- the guard


def _jax_tree(arrs):
    return {f"l{i}": jnp.asarray(a) for i, a in enumerate(arrs)}


@pytest.mark.parametrize("poison,max_norm", [(None, 0.0), ("nan", 0.0), ("inf", 0.0),
                                             (None, 3.0), (None, 30.0), ("big", 1e3),
                                             ("big", 0.0)])
def test_guard_helpers_equal_jax(poison, max_norm):
    g = _grads(1)
    if poison == "nan":
        g[1][2] = np.nan
    elif poison == "inf":
        g[2][0, 1, 2] = -np.inf
    elif poison == "big":
        g[0] *= np.float32(1e20)  # finite, its square overflows
    tg = [torch.from_numpy(a) for a in g]
    ok = R.grad_ok(tg, max_norm)
    jok = JR.grad_ok(_jax_tree(g), max_norm)
    assert bool(ok) == bool(jok)
    old = _grads(2)
    for flag in (True, False):
        sel = R.select_state(torch.tensor(flag), tg, [torch.from_numpy(a) for a in old])
        jsel = JR.select_state(jnp.bool_(flag), _jax_tree(g), _jax_tree(old))
        for a, b in zip(sel, jax.tree_util.tree_leaves(jsel)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        z = R.zero_if(torch.tensor(flag), tg)
        jz = JR.zero_if(jnp.bool_(flag), _jax_tree(g))
        for a, b in zip(z, jax.tree_util.tree_leaves(jz)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    live = [t.clone() for t in tg]
    R.hold_(torch.tensor(False), live, [torch.from_numpy(a) for a in old])
    for a, b in zip(live, old):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(
        R.global_sq_norm(tg).numpy(), np.float32(JR.global_sq_norm(_jax_tree(g))))


@pytest.mark.parametrize("n,kept", [(4, 3.0), (4, 1.0), (4, 0.0), (3, 2.0), (8, 5.0)])
def test_rescale_by_survivors_equals_jax(n, kept):
    g = _grads(3)
    got = R.rescale_by_survivors([torch.from_numpy(a) for a in g], n,
                                 torch.tensor(kept, dtype=torch.float32))
    want = JR.rescale_by_survivors(_jax_tree(g), n, jnp.float32(kept))
    for a, b in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("start,window,floor", [(10, 5, 0.2), (0, 16, 0.1), (3, 1, 0.5)])
def test_remedy_ramp_equals_jax(start, window, floor):
    cfg, jcfg = R.RemedyConfig(start, window, floor), JR.RemedyConfig(start, window, floor)
    g = _grads(4)
    for step in range(0, 30, 3):
        want = np.float32(JR.remedy_scale(jcfg, step))
        assert np.float32(R.remedy_scale(cfg, step)) == want
        assert R.remedy_scale(cfg, torch.tensor(step)).item() == want
        got = R.apply_remedy(cfg, step, [torch.from_numpy(a) for a in g])
        jgot = JR.apply_remedy(jcfg, step, _jax_tree(g))
        for a, b in zip(got, jax.tree_util.tree_leaves(jgot)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------- the detector


def _det(**kw):
    base = dict(window=4, zmax=4.0, patience=2, min_history=4)
    base.update(kw)
    return R.DetectorConfig(**base), JR.DetectorConfig(**base)


@settings(max_examples=40, deadline=None)
@given(losses=st.lists(st.floats(0.01, 100.0), min_size=4, max_size=30),
       skips=st.lists(st.integers(0, 1), min_size=30, max_size=30),
       gns=st.lists(st.floats(0.01, 1e3), min_size=30, max_size=30),
       parts=st.lists(st.integers(1, 7), min_size=1, max_size=30))
def test_detector_alarms_equal_jax_for_any_partition(losses, skips, gns, parts):
    cfg, jcfg = _det()
    n = len(losses)
    skips, gns = skips[:n], gns[:n]
    want_st, want_step, want_reason = JR.detector_scan(jcfg, JR.DetectorState(), losses, skips,
                                                       gns)

    def run(sizes):
        state, i, first = R.DetectorState(), 0, 1
        for k in sizes:
            if i >= n:
                break
            state, step, reason = R.detector_scan(cfg, state, losses[i:i + k], skips[i:i + k],
                                                  gns[i:i + k], first_step=first)
            if reason is not None:
                return state, step, reason
            first += len(losses[i:i + k])
            i += k
        if i < n:
            return R.detector_scan(cfg, state, losses[i:], skips[i:], gns[i:], first_step=first)
        return state, None, None

    for sizes in ([1] * n, parts):
        state, step, reason = run(sizes)
        assert (step, reason) == (want_step, want_reason)
        assert dataclasses.asdict(state) == dataclasses.asdict(want_st)


@pytest.mark.parametrize("kw", [dict(window=1), dict(window=0), dict(patience=0),
                                dict(zmax=0.0), dict(min_history=-1)])
def test_detector_knob_refusals_equal_jax(kw):
    _, mine = _error(R.DetectorConfig, **kw)
    _, want = _error(JR.DetectorConfig, **kw)
    assert want is not None and mine == want


_OK = dict(train_dir="/tmp/x", codec=object())
CONFLICTS = [
    ("skip", dict(train_dir="/t", save_freq=0)), ("skip", _OK), ("densify", _OK),
    ("skip", dict(train_dir="")), ("skip", dict(train_dir="/t", zero1=True)),
    ("skip", dict(train_dir="/t", phase_metrics=True)), ("densify", dict(train_dir="/t")),
    ("densify", dict(_OK, overlap="delayed")), ("densify", dict(_OK, aggregate="hierarchical")),
    ("densify", dict(_OK, num_aggregate=2)), ("rewarm", dict(_OK, overlap="delayed")),
    ("skip", dict(_OK, keep_ckpts=1, save_freq=10, window=16)),
    ("skip", dict(_OK, keep_ckpts=2, save_freq=8, window=16)),
    ("skip", dict(_OK, keep_ckpts=1, save_freq=0, window=16)),
]


@pytest.mark.parametrize("remedy,kw", CONFLICTS)
def test_diverge_conflict_text_equals_jax(remedy, kw):
    assert R.diverge_conflict(remedy, **kw) == JR.diverge_conflict(remedy, **kw)
    assert R.PHASE_METRICS_HINT == JT.PHASE_METRICS_HINT


def test_remedy_name_refusal_and_exit_codes_equal_jax():
    _, mine = _error(R.DivergeConfig, remedy="nope")
    _, want = _error(JR.DivergeConfig, remedy="nope")
    assert mine == want
    for name in ("SUPERVISED_ENV", "ROLLBACK_EXIT_CODE", "CONFIG_EXIT_CODE",
                 "MEMBERSHIP_EXIT_CODE", "ATTEMPT_ENV"):
        assert getattr(R, name) == getattr(JR, name)
    assert T.MEMBERSHIP_EPOCH_ENV == JT.MEMBERSHIP_EPOCH_ENV


def test_backoff_and_retries_equal_jax():
    a, b = random.Random(3), random.Random(3)
    pa = pb = 0.5
    for _ in range(8):
        da, pa = R.decorrelated_delay(pa, 0.5, 4.0, a)
        db, pb = JR.decorrelated_delay(pb, 0.5, 4.0, b)
        assert (da, pa) == (db, pb)
    for mod in (R, JR):
        calls, slept = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("blip")
            return "ok"

        assert mod.with_retries(flaky, attempts=3, sleep=slept.append, jitter=False)() == "ok"
        assert slept == [0.1, 0.2]
    with pytest.raises(ValueError, match="attempts must be >= 1"):
        R.with_retries(lambda: None, attempts=0)


# ------------------------------------------------------- incidents, tags


def test_incident_logs_read_and_summarize_alike(tmp_path):
    """Each package reads the other's incidents.jsonl, key for key, and the
    one-line formats agree (a torn tail skipped)."""
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    for log in (T.IncidentLog.for_train_dir(str(mine)),
                JT.IncidentLog.for_train_dir(str(theirs))):
        log.append("crash", action="restart", attempt=0, rc=43, backoff_s=0.1)
        log.append("divergence", action="rollback+skip", step=7, target=4, reason="loss_zscore")
        log.append("membership_change", action="reshape->3", epoch=1, world=3, rc=29)
        log.append("clean_exit", action="done", attempt=2)
    for path in (mine / "incidents.jsonl", theirs / "incidents.jsonl"):
        with open(path, "a") as f:
            f.write('{"cause": "torn')
    a, b = T.read_jsonl(str(mine / "incidents.jsonl")), JT.read_jsonl(
        str(theirs / "incidents.jsonl"))
    assert [sorted(r) for r in a] == [sorted(r) for r in b]
    strip = [{k: v for k, v in r.items() if k not in ("ts", "uptime_s")} for r in a]
    assert strip == [{k: v for k, v in r.items() if k not in ("ts", "uptime_s")} for r in b]
    for r in a + b:
        assert T.format_incident(r) == JT.format_incident(r)
    for p in (mine, theirs):
        path = str(p / "incidents.jsonl")
        body = lambda s: [line.split(" ", 1)[1] for line in s.splitlines()[1:]]  # noqa: E731
        assert body(T.IncidentLog.summarize(path)) == body(JT.IncidentLog.summarize(path))
    assert T.IncidentLog.summarize(str(tmp_path / "none")) == JT.IncidentLog.summarize(
        str(tmp_path / "none"))
    T.write_json_atomic(str(tmp_path / "a" / "x.json"), {"k": [1, 2]})
    assert json.loads((tmp_path / "a" / "x.json").read_text()) == {"k": [1, 2]}


def _state(v: float):
    from atomo_tpu_torch.models import get_model
    from atomo_tpu_torch.training import TrainState, make_optimizer
    from atomo_tpu_torch.training.trainer import leaf_params

    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(v)
    opt = make_optimizer("sgd", lr=0.1, momentum=0.9)
    return TrainState(step=0, model=model, opt_state=opt.init(leaf_params(model)))


def test_healthy_tags_prune_and_the_retention_anchor(tmp_path):
    d = str(tmp_path)
    CK.reset_verify_cache()
    st0 = _state(1.0)
    for s in (2, 4):
        CK.save_checkpoint(d, st0, s, compress=False)
    CK.mark_healthy(d, 2)
    assert CK.is_marked_healthy(d, 2) and not CK.is_marked_healthy(d, 4)
    assert CK.latest_healthy_step(d) == 2
    # keep=2: the healthy step 2 rides outside the budget until a newer tag
    for s in (6, 8):
        CK.save_checkpoint(d, st0, s, compress=False, keep=2)
    assert CK.list_steps(d) == [2, 6, 8]
    CK.mark_healthy(d, 6)
    CK.save_checkpoint(d, st0, 10, compress=False, keep=2)
    assert CK.list_steps(d) == [8, 10] or CK.list_steps(d) == [6, 8, 10]
    assert CK.latest_healthy_step(d) in (6, None) or CK.list_steps(d) == [8, 10]
    assert not os.path.exists(CK.healthy_marker_path(d, 2))  # the tag left with its file
    assert CK.prune_after(d, 8) == [10]
    assert CK.list_steps(d)[-1] == 8
    # the verify memo: a damaged file (a new inode) is checked again
    assert CK.verify_checkpoint(d, 8)
    C.corrupt_file(CK.checkpoint_path(d, 8), "bitflip", seed=1)
    assert not CK.verify_checkpoint(d, 8)


def test_healthy_tags_are_the_jax_sidecars(tmp_path):
    """The tag file is the JAX package's (``model_step_N.healthy``): each
    package sees the other's tags."""
    from atomo_tpu.training import checkpoint as JCK

    d = str(tmp_path)
    CK.save_checkpoint(d, _state(0.5), 3, compress=False)
    JCK.mark_healthy(d, 3)
    assert CK.is_marked_healthy(d, 3)
    CK.mark_healthy(d, 5)
    assert JCK.is_marked_healthy(d, 5)
    assert CK.healthy_marker_path(d, 5) == JCK.healthy_marker_path(d, 5)


def test_doctor_tags_plans_and_gives_up(tmp_path):
    d = str(tmp_path)
    st0 = _state(0.25)
    log = T.IncidentLog.for_train_dir(d)
    lines = []
    cfg = R.DivergeConfig(remedy="skip", detector=R.DetectorConfig(window=4, min_history=0),
                          max_rollbacks=1)
    doc = R.DivergenceDoctor(cfg, d, log, lines.append)
    for s in (2, 4, 6):
        CK.save_checkpoint(d, st0, s, compress=False)
        doc.note_save(s)
    doc.observe_block(1, [2.0] * 7)  # steps 1..7: step 2's window cleared
    assert CK.is_marked_healthy(d, 2) and not CK.is_marked_healthy(d, 4)
    plan = doc.plan_rollback(8, "loss_zscore")
    assert (plan.target, plan.generation, plan.remedy) == (2, 1, "skip")
    assert CK.list_steps(d) == [2]
    assert lines[-1] == ("Doctor: divergence at step 8 (loss_zscore); rolling back to step 2 "
                         "with remedy 'skip' (rollback 1/1, pruned steps [4, 6])")
    with pytest.raises(R.DivergenceError, match="budget exhausted"):
        doc.plan_rollback(9, "loss_zscore")
    causes = [(r["cause"], r["action"]) for r in T.read_jsonl(os.path.join(d,
                                                                         "incidents.jsonl"))]
    assert causes == [("divergence", "rollback+skip"), ("divergence", "give_up")]


def test_restream_replays_the_stream_and_the_jax_signature():
    from atomo_tpu.data import BatchIterator as JB
    from atomo_tpu.data import SPECS as JSPECS
    from atomo_tpu.data import synthetic_dataset as jsyn
    from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset

    it = BatchIterator(synthetic_dataset(SPECS["mnist"], True, size=64), 16, seed=3)
    jit = JB(jsyn(JSPECS["mnist"], True, size=64), 16, seed=3)
    assert it.rng_signature() == jit.rng_signature()
    snap = it.snapshot_rng()
    first = [b[1].copy() for b, _ in zip(it.forever(), range(9))]
    again = [b[1].copy() for b, _ in zip(it.restream(snap, skip=3), range(6))]
    for a, b in zip(first[3:], again):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- row 2 with replica flags


def _gathered_qsgd(n_rep, bits=4, seed=0, poison=2):
    from atomo_tpu.codecs import QsgdCodec as JQ
    from atomo_tpu.codecs import encode_tree as jencode

    rng = np.random.default_rng(seed)
    shapes = [(6, 5, 3, 3), (300,), (4, 700)]
    jc = JQ(bits=bits)
    per = []
    for r in range(n_rep):
        grads = {f"l{i}": jnp.asarray(rng.standard_normal(s).astype(np.float32))
                 for i, s in enumerate(shapes)}
        pays, _ = jencode(jc, jax.random.PRNGKey(r), grads)
        per.append(jax.tree_util.tree_leaves(pays, is_leaf=lambda p: hasattr(p, "words")))
    gathered = [type(per[0][i])(*(jnp.stack([np.asarray(getattr(per[r][i], f))
                                             for r in range(n_rep)])
                                  for f in per[0][i]._fields)) for i in range(len(shapes))]
    if poison is not None:  # the masked replica's scales are NaN
        gathered = [p._replace(scales=p.scales.at[poison].set(jnp.nan)) for p in gathered]
    return jc, gathered, shapes


@pytest.mark.parametrize("n_rep,poison,flags", [
    (4, 2, [1, 1, 0, 1]), (4, 0, [0, 1, 1, 1]), (3, None, [1, 1, 1]), (4, 3, [1, 0, 1, 0]),
    (2, 1, [1, 0]), (4, None, [0, 0, 0, 0]),
])
def test_row2_flags_equal_jax_masked_decode(n_rep, poison, flags):
    """The tree decode with ``replica_ok`` (the plain twin, on the CPU)
    against the JAX package's ``_mask_gathered`` then ``decode_mean_tree``,
    bit for bit; with the flags None it is today's call."""
    from atomo_tpu.codecs import decode_mean_tree as jdecode_mean
    from atomo_tpu.parallel.replicated import _mask_gathered
    from atomo_tpu_torch.convert import jax_view
    from atomo_tpu_torch.ops import qsgd_kernels as K

    jc, gathered, shapes = _gathered_qsgd(n_rep, poison=poison)
    okg = jnp.asarray(flags, jnp.float32)
    like = {f"l{i}": jnp.zeros(s, jnp.float32) for i, s in enumerate(shapes)}
    masked = _mask_gathered({f"l{i}": p for i, p in enumerate(gathered)}, okg)
    want = [np.asarray(v) for v in jax.tree_util.tree_leaves(
        jdecode_mean(jc, masked, like, n_rep))]
    # the port decodes into the port layout of the leaves' torch shapes
    port_like = [torch.zeros((s[3], s[2], s[0], s[1]) if len(s) == 4 else
                             (s[1], s[0]) if len(s) == 2 else s) for s in shapes]
    pays = [(torch.from_numpy(np.asarray(p.words).view(np.uint32).copy()),
             torch.from_numpy(np.asarray(p.scales).copy())) for p in gathered]
    got = K.unpack_dequantize_tree(pays, port_like, bits=4, n_replicas=n_rep,
                                   replica_ok=torch.tensor(flags, dtype=torch.float32))
    # bit for bit: the port's decode of the JAX package's masked payloads
    jpays = [(torch.from_numpy(np.asarray(p.words).view(np.uint32).copy()),
              torch.from_numpy(np.asarray(p.scales).copy()))
             for p in jax.tree_util.tree_leaves(masked, is_leaf=lambda p: hasattr(p, "words"))]
    for g, w in zip(got, K.unpack_dequantize_tree(jpays, port_like, bits=4, n_replicas=n_rep)):
        assert torch.equal(g, w) and torch.isfinite(g).all()
    # the JAX package's decode_mean_tree: its jnp.mean may sum the replicas
    # in another order (where they cancel, a few ulp of the summands) and
    # multiply by 1/N, so within 4 ulp of the leaf's largest value
    for g, w in zip(got, want):
        a = jax_view(g).numpy()
        assert np.all(np.abs(a - w) <= 4 * np.spacing(np.abs(w).max()))
    if poison is None and all(flags):
        plain = K.unpack_dequantize_tree(pays, port_like, bits=4, n_replicas=n_rep)
        for g, p in zip(got, plain):
            assert torch.equal(g, p)


@pytest.mark.parametrize("code", ["svd", "qsgd-pack"])
def test_masked_decode_of_the_other_codecs_equals_jax(code):
    """SVD's gathered factors and the pack path's words and scales are
    masked with ``where`` (:func:`mask_gathered`) as in the JAX package."""
    from atomo_tpu.parallel.replicated import _mask_gathered
    from atomo_tpu_torch.codecs import decode_mean_tree, get_codec
    from atomo_tpu_torch.codecs.base import mask_gathered

    if code == "svd":
        c = get_codec("svd", svd_rank=2)
    else:
        c = get_codec("qsgd", quantization_level=4, use_kernel=False, pack_kernel=True)
    rng = np.random.default_rng(5)
    shapes = [(8, 6), (7, 3, 3, 3), (10,)]
    like = [torch.zeros(s) for s in shapes]
    from atomo_tpu_torch.codecs import encode_tree
    per = [encode_tree(c, r, [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                              for s in shapes])[0] for r in range(3)]
    gathered = [type(per[0][i])(*(torch.stack([getattr(per[r][i], f) for r in range(3)])
                                  for f in per[0][i]._fields)) for i in range(len(shapes))]
    gathered[1] = gathered[1]._replace(**{gathered[1]._fields[0]: gathered[1][0].clone()})
    field0 = gathered[1][0]
    if field0.is_floating_point():
        field0[1] = float("nan")
    flags = torch.tensor([1.0, 0.0, 1.0])
    masked = mask_gathered(gathered, flags)
    jmasked = _mask_gathered([tuple(jnp.asarray(t.view(torch.int32).numpy()
                                                if t.dtype == torch.uint32 else t.numpy())
                                    for t in p) for p in gathered], jnp.asarray(flags.numpy()))
    for p, jp in zip(masked, jmasked):
        for t, jt in zip(p, jp):
            a = t.view(torch.int32) if t.dtype == torch.uint32 else t
            np.testing.assert_array_equal(a.numpy(), np.asarray(jt))
    got = decode_mean_tree(c, gathered, like, 3, replica_ok=flags)
    want = decode_mean_tree(c, masked, like, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b) and torch.isfinite(a).all()
