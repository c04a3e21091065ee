"""The quorum family's host side and its survivor-exact mean against the JAX package.

* ``staleness_vector`` and ``lateness_steps`` return the JAX functions'
  values exactly (sigma, the exposed wait, the drops) over a grid of steps
  1-12, N 2-8, Q 1-N, K 0-3, periods 0.05-0.3 s and 0-3 ``slow@`` faults
  (two on one replica among them), by hypothesis and by hand-picked cases
  of warm-up absences, drops and the quorum floor's promotions;
  ``QuorumConfig`` refuses with the JAX texts.
* The port's rig and the JAX rig on one chaos table write equal
  ``arrival_schedule.jsonl`` files line for line and equal incidents; a
  replay sleeps nothing (``time.sleep`` patched) and re-records the
  vectors; the meta check refuses with the JAX text; ``prune_past`` cuts
  the tail; each package reads the other's file.
* ``survivor_decode_mean`` over gathered LeNet payloads of N 2-4 replicas
  with every absent subset (all absent too) equals the JAX function: QSGD
  2 and 4 bits on the fused path (row 2's survivor mode, its plain twin
  here) and the pack path bit for bit, SVD rank 3 within 1e-5 (the SVD
  gather parity tests' float32 tolerance); a flagged-out replica's NaN
  bytes never reach the mean; with every flag up row 2's survivor mode is
  its flagged form bit for bit.
* The loop's quorum refusals are the JAX loop's texts.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import atomo_tpu.quorum.rig as JRig
import atomo_tpu.quorum.schedule as JS
from atomo_tpu.codecs import QsgdCodec as JQsgd
from atomo_tpu.codecs import SvdCodec as JSvd
from atomo_tpu.codecs import encode_tree as jax_encode_tree
from atomo_tpu.elastic.shrink import survivor_decode_mean as jax_survivor_mean
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.quorum import QuorumConfig as JQuorumConfig
from atomo_tpu.quorum.artifact import read_schedule as jax_read_schedule
from atomo_tpu.utils.chaos import ChaosConfig as JChaosConfig
from atomo_tpu.utils.chaos import ChaosInjector as JChaosInjector
from atomo_tpu.utils.tracing import IncidentLog as JIncidentLog
from atomo_tpu_torch import quorum as Q
from atomo_tpu_torch.codecs import QsgdCodec, SvdCodec
from atomo_tpu_torch.elastic import mask_absent, roster_fold_sum, survivor_decode_mean
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.ops import qsgd_kernels as K
from atomo_tpu_torch.quorum import rig as PRig
from atomo_tpu_torch.quorum import schedule as PS
from atomo_tpu_torch.quorum.artifact import append_record, read_schedule, schedule_path
from atomo_tpu_torch.utils.chaos import ChaosConfig, ChaosInjector
from atomo_tpu_torch.utils.tracing import IncidentLog

# ------------------------------------------------------------- schedule

FAULT = st.tuples(st.integers(1, 12), st.integers(0, 7),
                  st.sampled_from([0.01, 0.05, 0.1, 0.12, 0.25, 0.3, 0.5, 0.9]))


@settings(max_examples=300, deadline=None)
@given(step=st.integers(1, 12), n=st.integers(2, 8), data=st.data(),
       k=st.integers(0, 3), period=st.sampled_from([0.05, 0.1, 0.15, 0.2, 0.3]),
       faults=st.lists(FAULT, max_size=3))
def test_staleness_vector_equals_jax(step, n, data, k, period, faults):
    q = data.draw(st.integers(1, n))
    faults = tuple((s, r % n, sec) for s, r, sec in faults)
    kw = dict(n_dev=n, quorum=q, staleness=k, faults=faults, period_s=period)
    assert PS.staleness_vector(step, **kw) == JS.staleness_vector(step, **kw)


@pytest.mark.parametrize("step,n,q,k,faults", [
    (2, 4, 1, 1, ((1, 1, 0.25),)),            # warm-up absence
    (5, 4, 3, 1, ((1, 1, 0.25),)),            # a drop past the bound
    (5, 4, 4, 1, ((1, 1, 0.25),)),            # the floor promotes the drop
    (20, 4, 3, 1, ((1, 1, 0.3), (1, 2, 0.5))),  # the Q-th order statistic
    (9, 3, 2, 2, ((2, 0, 0.15), (4, 0, 0.35))),  # two faults on one replica
    (7, 8, 8, 0, ((1, 3, 0.2), (3, 5, 0.1), (6, 7, 0.4))),  # K 0: blocking
    (12, 2, 1, 3, ((1, 1, 0.3), (1, 1, 0.3))),  # equal faults tie on start
])
def test_staleness_vector_cases_equal_jax(step, n, q, k, faults):
    for period in (0.05, 0.1, 0.3):
        kw = dict(n_dev=n, quorum=q, staleness=k, faults=faults, period_s=period)
        assert PS.staleness_vector(step, **kw) == JS.staleness_vector(step, **kw)
    for sec in (0.01, 0.1, 0.25, 0.31):
        assert PS.lateness_steps(sec, 0.1) == JS.lateness_steps(sec, 0.1)


@pytest.mark.parametrize("kw", [dict(quorum=0), dict(quorum=2, staleness=-1),
                                dict(quorum=2, period_s=0.0)])
def test_quorum_config_refuses_as_jax(kw):
    with pytest.raises(ValueError) as want:
        JQuorumConfig(**kw)
    with pytest.raises(ValueError) as got:
        Q.QuorumConfig(**kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- artifact and rig

SLOW = "slow@2:1:0.25,slow@4:3:0.12"


def _rigs(tmp_path, monkeypatch, cfg_kw, replay=None, chaos=SLOW, n=4):
    """The JAX rig and the port's on one chaos table, each into a directory
    of its own; their sleeps recorded, not slept (both modules sleep through
    the one ``time`` module)."""
    assert JRig.time is PRig.time
    slept = []
    monkeypatch.setattr(PRig.time, "sleep", slept.append)
    out = {}
    for name, (cfgc, rigc, chc, chi, inc) in {
        "jax": (JQuorumConfig, JRig.QuorumRig, JChaosConfig, JChaosInjector, JIncidentLog),
        "port": (Q.QuorumConfig, PRig.QuorumRig, ChaosConfig, ChaosInjector, IncidentLog),
    }.items():
        d = tmp_path / name
        injector = chi(chc.from_spec(chaos, environ={}), membership_epoch=0) if chaos else None
        out[name] = rigc(cfgc(**cfg_kw), n_dev=n, train_dir=str(d), chaos=injector,
                         incidents=inc.for_train_dir(str(d)),
                         replay_path=None if replay is None else replay[name],
                         log_fn=lambda _: None)
    return out, slept


def _incidents(d):
    return [{k: v for k, v in r.items() if k not in ("ts", "uptime_s")}
            for r in IncidentLog.read(os.path.join(d, "incidents.jsonl"))]


def test_rigs_write_the_jax_schedule_and_incidents(tmp_path, monkeypatch):
    rigs, slept = _rigs(tmp_path, monkeypatch, dict(quorum=3, staleness=1, period_s=0.1))
    for step in range(1, 9):
        assert rigs["jax"].begin_step(step).tolist() == rigs["port"].begin_step(step).tolist()
    # the JAX rig's wait, then the port's, each step the floor waited
    assert slept and slept[::2] == slept[1::2]
    a, b = (tmp_path / n / Q.ARRIVAL_SCHEDULE_NAME for n in ("jax", "port"))
    assert a.read_text().splitlines() == b.read_text().splitlines()
    assert _incidents(str(tmp_path / "jax")) == _incidents(str(tmp_path / "port"))
    assert any(r["cause"] == "staleness_exceeded" for r in _incidents(str(tmp_path / "port")))
    # each package reads the other's file alike
    assert read_schedule(str(a)) == jax_read_schedule(str(b)) == read_schedule(str(b))


def test_replay_is_wait_free_and_re_records(tmp_path, monkeypatch):
    live, _ = _rigs(tmp_path / "live", monkeypatch, dict(quorum=4, staleness=1))
    for step in range(1, 7):
        live["port"].begin_step(step)
        live["jax"].begin_step(step)
    src = {n: schedule_path(str(tmp_path / "live" / n)) for n in ("jax", "port")}
    rep, slept = _rigs(tmp_path / "rep", monkeypatch, dict(quorum=4, staleness=1),
                       replay=src, chaos="")
    for step in range(1, 7):
        assert rep["port"].begin_step(step).tolist() == rep["jax"].begin_step(step).tolist()
    assert slept == []
    for n in ("jax", "port"):
        assert read_schedule(schedule_path(str(tmp_path / "rep" / n)))[1] == \
            read_schedule(src[n])[1]
    assert _incidents(str(tmp_path / "rep" / "port")) == _incidents(str(tmp_path / "rep" / "jax"))
    with pytest.raises(ValueError, match="no step 7") as got:
        rep["port"].begin_step(7)
    with pytest.raises(ValueError) as want:
        rep["jax"].begin_step(7)
    assert str(got.value) == str(want.value)


def test_meta_refusal_and_prune_past_as_jax(tmp_path):
    d = str(tmp_path)
    p = schedule_path(d)
    append_record(p, {"kind": "meta", "what": "quorum_config", "quorum": 3, "staleness": 2,
                      "n_replicas": 4, "period_s": 0.1})
    for s in range(1, 5):
        append_record(p, {"kind": "arrival", "step": s, "staleness": [0, 0, 0, 0],
                          "kept": 4, "dropped": 0, "exposed_wait_ms": 0.0})
    for cfg, kw in ((dict(quorum=3, staleness=1), dict(train_dir=d)),
                    (dict(quorum=2, staleness=2), dict(replay_path=p))):
        with pytest.raises(ValueError) as want:
            JRig.QuorumRig(JQuorumConfig(**cfg), n_dev=4, **kw)
        with pytest.raises(ValueError, match="refusing to mix schedules") as got:
            PRig.QuorumRig(Q.QuorumConfig(**cfg), n_dev=4, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JRig.QuorumRig(JQuorumConfig(5), n_dev=4)
    with pytest.raises(ValueError) as got:
        PRig.QuorumRig(Q.QuorumConfig(5), n_dev=4)
    assert str(got.value) == str(want.value)
    rig = PRig.QuorumRig(Q.QuorumConfig(3, staleness=2), n_dev=4, train_dir=d)
    rig.prune_past(2)
    meta, arrivals = read_schedule(p)
    assert meta["staleness"] == 2 and sorted(arrivals) == [1, 2]
    assert jax_read_schedule(p) == (meta, arrivals)


# ------------------------------------------------------- the survivor mean


# a small tree with every kind of leaf the decode lays out: a conv kernel
# and a linear kernel (transposed between the packages), an untransposed
# table, a bias; sorted keys are the canonical order. JAX shape, port shape,
# transposed?
LEAVES = {
    "a_conv": ((5, 5, 20, 50), (50, 20, 5, 5), True),
    "b_dense": ((120, 84), (84, 120), True),
    "c_table": ((64, 24), (64, 24), False),
    "d_bias": ((84,), (84,), True),
}


@pytest.fixture(scope="module")
def lenet():
    """The leaves in both packages' layouts, and per replica a gradient
    made from a seed: (the port's leaves and layouts, JAX tree of shapes,
    gradients as JAX trees)."""
    model = ([torch.zeros(port) for _, port, _ in LEAVES.values()],
             [tr for *_, tr in LEAVES.values()])
    jparams = {k: jax.ShapeDtypeStruct(j, jnp.float32) for k, (j, _, _) in LEAVES.items()}
    rng = np.random.default_rng(19)
    grads = [{k: (rng.standard_normal(j) * 0.1).astype(np.float32)
              for k, (j, _, _) in LEAVES.items()} for _ in range(4)]
    return model, jparams, grads


def _subsets(n):
    return [m for r in range(n + 1) for m in itertools.combinations(range(n), r)]


def _gathered(jcodec, grads, n, poison=()):
    """Every replica's JAX payloads stacked on a leading axis (a replica in
    ``poison`` encodes a NaN gradient)."""
    trees = []
    for r in range(n):
        g = grads[r]
        if r in poison:
            g = jax.tree_util.tree_map(lambda a: np.full_like(a, np.nan), g)
        trees.append(jax_encode_tree(jcodec, jax.random.PRNGKey(100 + r), g)[0])
    return jax.tree_util.tree_map(lambda *a: np.stack([np.asarray(x) for x in a]), *trees,
                                  is_leaf=lambda x: isinstance(x, np.ndarray))


def _port_payloads(jgathered, model, ptype):
    """The JAX gathered payload tree as the port's per-leaf payload list
    (canonical leaf order; the fields alike in both packages)."""
    leaves = jax.tree_util.tree_leaves(jgathered, is_leaf=lambda x: hasattr(x, "_fields"))
    return [ptype(*(torch.from_numpy(np.ascontiguousarray(f)) for f in p)) for p in leaves]


def _port_like(model):
    return model


def _port_to_jax(values, model):
    """The port's per-leaf means as flat JAX-layout vectors in canonical order."""
    from atomo_tpu_torch.convert import jax_view

    return np.concatenate([jax_view(v, tr).reshape(-1).numpy()
                           for v, tr in zip(values, model[1])])


def _jax_flat(tree):
    return np.concatenate([np.asarray(a).reshape(-1) for a in jax.tree_util.tree_leaves(tree)])


def _subset_ok(n, keep):
    ok = np.zeros(n, np.float32)
    ok[list(keep)] = 1.0
    return ok


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_qsgd_pack_survivor_mean_equals_jax_bit_for_bit(lenet, n, bits):
    """The pack path against the JAX function on its jnp path, op by op
    (under jit XLA turns the division by the level count into a product
    with its reciprocal), every absent subset."""
    from atomo_tpu_torch.codecs.qsgd import QsgdPayload

    model, jparams, grads = lenet
    jcodec = JQsgd(bits=bits, use_pallas=False)
    codec = QsgdCodec(bits=bits, use_kernel=False)
    jg = _gathered(jcodec, grads, n)
    payloads = _port_payloads(jg, model, QsgdPayload)
    like, layouts = _port_like(model)
    for keep in _subsets(n):
        ok = _subset_ok(n, keep)
        want = _jax_flat(jax_survivor_mean(jcodec, jg, jnp.asarray(ok), jparams))
        got = _port_to_jax(survivor_decode_mean(codec, payloads, torch.from_numpy(ok), like,
                                                layouts), model)
        np.testing.assert_array_equal(got, want, err_msg=f"kept {keep}")


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_qsgd_fused_survivor_mean_equals_jax_bit_for_bit(lenet, n, bits):
    """The fused path (row 2's survivor mode; its plain twin here) against
    the JAX function over the Pallas kernel (interpret mode), as the tree
    decode tests hold it. The interpreted kernel costs seconds a call, so
    the JAX function itself runs on the all-up and one-down subsets, and
    every subset is held against the same function composed of its own
    parts on one interpreted decode of the replicas: its ``roster_fold_sum``
    of the decodes (a masked replica's zero payload decodes to +0.0, as
    checked) and its one division by max(kept, 1)."""
    from atomo_tpu.elastic.shrink import roster_fold_sum as jax_fold
    from atomo_tpu_torch.codecs.qsgd import QsgdPayload

    model, jparams, grads = lenet
    jcodec = JQsgd(bits=bits, use_pallas=True)
    codec = QsgdCodec(bits=bits, use_kernel=True)
    jg = _gathered(JQsgd(bits=bits), grads, n)  # the jnp encode: the same payloads, cheaper
    payloads = _port_payloads(jg, model, QsgdPayload)
    like, layouts = _port_like(model)
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    p_leaves = treedef.flatten_up_to(jg)

    @jax.jit
    def decodes(p_leaves):
        return [jax.vmap(lambda q, s=tuple(g.shape): jcodec.decode(q, s))(p)
                for p, g in zip(p_leaves, leaves)]

    dec = decodes(p_leaves)
    zero = jax.tree_util.tree_map(lambda a: jnp.zeros_like(a[:1]), p_leaves)
    assert all(not np.signbit(np.asarray(d)).any() and not np.asarray(d).any()
               for d in decodes(zero))

    def composed(ok):
        okj = jnp.asarray(ok)
        out = []
        for d in dec:
            keep = (okj > 0).reshape((-1,) + (1,) * (d.ndim - 1))
            out.append(jax_fold(jnp.where(keep, d, 0.0)) / jnp.maximum(jnp.sum(okj), 1.0))
        return jax.tree_util.tree_unflatten(treedef, out)

    full = jax.jit(lambda g, ok: jax_survivor_mean(jcodec, g, ok, jparams))
    for keep in _subsets(n):
        ok = _subset_ok(n, keep)
        want = _jax_flat(composed(ok))
        if len(keep) == n or keep == tuple(range(1, n)):  # the function itself
            np.testing.assert_array_equal(_jax_flat(full(jg, jnp.asarray(ok))), want)
        got = _port_to_jax(survivor_decode_mean(codec, payloads, torch.from_numpy(ok), like,
                                                layouts), model)
        np.testing.assert_array_equal(got, want, err_msg=f"kept {keep}")


@pytest.mark.parametrize("n", [2, 4])
def test_svd_survivor_mean_equals_jax(lenet, n):
    from atomo_tpu_torch.codecs.svd import SvdPayload
    from atomo_tpu_torch.codecs.dense import DensePayload

    model, jparams, grads = lenet
    jcodec = JSvd(rank=3)
    jg = _gathered(jcodec, grads, n)
    leaves = jax.tree_util.tree_leaves(jg, is_leaf=lambda x: hasattr(x, "_fields"))
    payloads = [(SvdPayload if len(p) == 3 else DensePayload)(
        *(torch.from_numpy(np.ascontiguousarray(f)) for f in p)) for p in leaves]
    like, layouts = _port_like(model)
    for keep in _subsets(n):
        ok = np.zeros(n, np.float32)
        ok[list(keep)] = 1.0
        want = _jax_flat(jax_survivor_mean(jcodec, jg, jnp.asarray(ok), jparams))
        got = _port_to_jax(survivor_decode_mean(SvdCodec(rank=3), payloads,
                                                torch.from_numpy(ok), like, layouts), model)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"kept {keep}")


def test_flagged_out_nan_bytes_never_reach_the_mean(lenet):
    """Replica 1 holds a NaN gradient's payload: flagged out, the mean is
    the other replicas' one division, finite, on both QSGD paths and SVD."""
    from atomo_tpu_torch.codecs.dense import DensePayload
    from atomo_tpu_torch.codecs.qsgd import QsgdPayload
    from atomo_tpu_torch.codecs.svd import SvdPayload

    model, jparams, grads = lenet
    like, layouts = _port_like(model)
    ok = np.asarray([1, 0, 1], np.float32)
    for jcodec, codec, ptype in ((JQsgd(bits=4), QsgdCodec(bits=4, use_kernel=True), None),
                                 (JQsgd(bits=4), QsgdCodec(bits=4, use_kernel=False), None),
                                 (JSvd(rank=3), SvdCodec(rank=3), "svd")):
        jg = _gathered(jcodec, grads, 3, poison=(1,))
        leaves = jax.tree_util.tree_leaves(jg, is_leaf=lambda x: hasattr(x, "_fields"))
        if ptype is None:
            payloads = [QsgdPayload(*(torch.from_numpy(np.ascontiguousarray(f)) for f in p))
                        for p in leaves]
        else:
            payloads = [(SvdPayload if len(p) == 3 else DensePayload)(
                *(torch.from_numpy(np.ascontiguousarray(f)) for f in p)) for p in leaves]
        assert any(torch.isnan(p[-1]).any() or torch.isnan(p[0].float()).any()
                   for p in payloads) or ptype is None
        got = _port_to_jax(survivor_decode_mean(codec, payloads, torch.from_numpy(ok), like,
                                                layouts), model)
        assert np.isfinite(got).all()
        want = _jax_flat(jax_survivor_mean(jcodec, jg, jnp.asarray(ok), jparams))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_row2_survivor_mode_all_up_is_the_flagged_form(lenet):
    """The plain twin of row 2's survivor mode: every flag up divides by N,
    bit for bit the flagged form; one flag down is the JAX fold of the
    masked replicas over max(kept, 1); none up is zeros."""
    from atomo_tpu_torch.codecs.qsgd import QsgdPayload

    model, jparams, grads = lenet
    jg = _gathered(JQsgd(bits=4), grads, 4)
    payloads = [(p.words, p.scales) for p in _port_payloads(jg, model, QsgdPayload)]
    like, layouts = _port_like(model)
    kw = dict(bits=4, bucket_size=512, n_replicas=4)
    up = torch.ones(4)
    a = K.unpack_dequantize_tree(payloads, like, layouts, replica_ok=up, survivor=True, **kw)
    b = K.unpack_dequantize_tree(payloads, like, layouts, replica_ok=up, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ok = torch.tensor([1.0, 0.0, 1.0, 1.0])
    got = K.unpack_dequantize_tree(payloads, like, layouts, replica_ok=ok, survivor=True, **kw)
    rows = [K.unpack_dequantize_tree([(w[r], s[r]) for w, s in payloads], like, layouts,
                                     bits=4, bucket_size=512) for r in range(4)]
    for i, g in enumerate(got):
        stacked = torch.stack([rows[r][i] if ok[r] > 0 else torch.zeros_like(rows[r][i])
                               for r in range(4)])
        assert torch.equal(g, roster_fold_sum(stacked) / torch.tensor(3.0))
    none = K.unpack_dequantize_tree(payloads, like, layouts, replica_ok=torch.zeros(4),
                                    survivor=True, **kw)
    assert all(not v.any() for v in none)
    with pytest.raises(ValueError, match="pass replica_ok"):
        K.unpack_dequantize_tree(payloads, like, layouts, survivor=True, **kw)
    masked = mask_absent([QsgdPayload(torch.stack([w for w in p[0]]), p[1])
                          for p in payloads[:1]], ok)
    assert not masked[0].words[1].any() and masked[0].words[0].equal(payloads[0][0][0])


# ------------------------------------------------------- the loop's refusals


def _loop_cases():
    from atomo_tpu_torch.quorum import QuorumConfig

    return {
        "dense": dict(codec=None, aggregate="psum"),
        "delayed": dict(overlap="delayed"),
        "error_feedback": dict(error_feedback=True),
        "superstep": dict(superstep=2),
        "num_aggregate": dict(num_aggregate=1),
        "stream_encode": dict(stream_encode=True),
        "track_quality": dict(track_quality=True),
        "phase_metrics": dict(phase_metrics=True),
        "replay_without_quorum": dict(quorum=None, quorum_replay="/tmp/nope.jsonl"),
        "partition": dict(partition="zero1"),
    }, QuorumConfig


@pytest.mark.parametrize("case", sorted(_loop_cases()[0]))
def test_loop_refusals_are_the_jax_loops(case):
    from atomo_tpu.data import SPECS, BatchIterator, synthetic_dataset
    from atomo_tpu.parallel import distributed_train_loop as jax_loop
    from atomo_tpu.parallel import make_mesh
    from atomo_tpu.training import make_optimizer as jax_opt
    from atomo_tpu_torch.training import make_optimizer
    from atomo_tpu_torch.training.trainer import distributed_train_loop

    cases, QuorumConfig = _loop_cases()
    kw = dict(cases[case])
    jkw = dict(kw)
    partition = jkw.pop("partition", None)
    if partition:
        jkw["zero1"] = True
    jkw["quorum"] = JQuorumConfig(2) if "quorum" not in kw else kw["quorum"]
    codec = jkw.pop("codec", JQsgd(bits=4))
    it = BatchIterator(synthetic_dataset(SPECS["mnist"], True, size=64), 16, seed=0)
    with pytest.raises(ValueError) as want:
        jax_loop(jax_model("lenet", 10), jax_opt("sgd"), make_mesh(2), it, codec=codec,
                 aggregate=jkw.pop("aggregate", "gather"), max_steps=1, log_every=0,
                 eval_freq=0, **jkw)
    kw.setdefault("quorum", QuorumConfig(2))
    pcodec = kw.pop("codec", QsgdCodec(bits=4))
    with pytest.raises(ValueError) as got:
        distributed_train_loop(get_model("lenet", 10, image_shape=(28, 28, 1)),
                               make_optimizer("sgd"), None, codec=pcodec,
                               aggregate=kw.pop("aggregate", "gather"), max_steps=1,
                               log_every=0, device="cpu", **kw)
    assert str(got.value) == str(want.value)
