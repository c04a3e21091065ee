"""The guarded one-device step against the JAX package's guarded step.

LeNet on synthetic MNIST from the weights of a Flax init, 5 steps of
momentum SGD, for each codec (``sgd``, ``svd`` rank 3, ``qsgd`` 4 bits)
under the plan ``nan@2,explode@3,inf@4*`` with ``max_grad_norm`` 100: a
non-finite gradient at 2, a finite gradient above the ceiling at 3, the
starred (all-replica) form at 4, each skipped; one run a codec, one case a
fault. Both steps take the guard and the chaos injector; the port's codec
is fed the draws the JAX codec makes (``split(fold_in(key, step), 3)[2]``
folded with the leaf index).

Each step: ``skipped`` equal to the JAX step's; on a skipped step the port's
parameters and momentum equal the step before's bit for bit (the hold), its
loss within rtol 1e-5 of JAX's; the optimizer count held by the skipped
steps. After 5 steps the parameters against JAX: atol 1e-5 (sgd), 1e-4 (svd, the factorisation's
float32 differences, as ``tests/test_torch_lm.py``), 1e-5 plus one
quantization step (the largest scale / 15) times lr for each step taken
(qsgd: a field may move one level where the float-level gradient difference
crosses its uniform, ``torch_dist_jax.assert_parity``'s allowance). The rewarm remedy's
ramp scales the update as the JAX step's does (``remedy=``, 1e-5), and the
guarded step's grad-norm series equals JAX's (rtol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_jax as J

import atomo_tpu.training.resilience as JR
import atomo_tpu.utils.chaos as JC
import atomo_tpu_torch.training.resilience as R
import atomo_tpu_torch.utils.chaos as C
from atomo_tpu.training.trainer import create_state
from atomo_tpu.training.trainer import make_train_step as jax_train_step
from atomo_tpu_torch.codecs import get_codec
from atomo_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from atomo_tpu_torch.data import to_device
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import TrainState, make_optimizer
from atomo_tpu_torch.training import trainer
from atomo_tpu_torch.training.trainer import leaf_params, make_train_step

torch.set_num_threads(1)

LR, MOMENTUM, STEPS, BATCH, KEY = 0.01, 0.9, 5, 16, 5
# one plan for the three faults: nan at 2, explode at 3 (above the ceiling
# of 100), the starred inf at 4; step 5 clean
PLAN, MAXN = "nan@2,explode@3,inf@4*", 100.0
FAULTS = {"nan": 2, "explode": 3, "inf-all": 4}


@pytest.fixture(scope="module")
def start():
    batches = J.batches("mnist", BATCH, STEPS)
    jmodel = J.jax_build("lenet")
    jopt = J.jax_optimizer("sgd", lr=LR, momentum=MOMENTUM)
    jstate = create_state(jmodel, jopt, jax.random.PRNGKey(0), jnp.asarray(batches[0][0]))
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    sd = state_dict_from_jax(model, jax.device_get(jstate.params),
                             jax.device_get(jstate.batch_stats))
    return batches, jmodel, jopt, jax.device_get(jstate), sd


def _draws(code, k_codec, params):
    if code == "qsgd":
        return [torch.from_numpy(np.array(u)) for u in J.qsgd_draws(k_codec, params)]
    if code == "svd":
        return [{k: torch.from_numpy(v) for k, v in d.items()}
                for d in J.svd_draws(k_codec, params)]
    return None


def _run(start, code, spec, max_norm, remedy=None, track=False):
    batches, jmodel, jopt, jstate, sd = start
    jcodec = J.CODECS[code][1]()
    jkw = dict(guard=JR.GuardConfig(max_norm), chaos=JC.ChaosInjector(
        JC.ChaosConfig.from_spec(spec, environ={}), membership_epoch=0))
    pkw = dict(guard=R.GuardConfig(max_norm), chaos=C.ChaosInjector(
        C.ChaosConfig.from_spec(spec, environ={}), membership_epoch=0))
    if remedy is not None:
        jkw["remedy"], pkw["remedy"] = JR.RemedyConfig(*remedy), R.RemedyConfig(*remedy)
    jstep = jax_train_step(jmodel, jopt, codec=jcodec, track_grad_norm=track, **jkw)
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    model.load_state_dict(sd)
    opt = make_optimizer("sgd", lr=LR, momentum=MOMENTUM)
    state = TrainState(step=0, model=model, opt_state=opt.init(leaf_params(model)))
    spec_codec = J.CODECS[code][0]
    pstep = make_train_step(model, opt, codec=None if spec_codec is None else get_codec(
        spec_codec[0], **spec_codec[1]), track_grad_norm=track, **pkw)
    key = jax.random.PRNGKey(KEY)
    js = jax.tree_util.tree_map(jnp.asarray, jstate)
    out = []
    max_scale = [0.0]
    encode = trainer.encode_tree

    def recording_encode(*args, **kw):  # the largest quantization step taken
        payloads, stats = encode(*args, **kw)
        for p in payloads:
            if hasattr(p, "scales") and bool(torch.isfinite(p.scales).all()):
                max_scale[0] = max(max_scale[0], float(p.scales.max()))
        return payloads, stats

    trainer.encode_tree = recording_encode
    for s, (x, y) in enumerate(batches):
        k_codec = jax.random.split(jax.random.fold_in(key, s), 3)[2]
        draws = _draws(code, k_codec, js.params)
        before = [p.detach().clone() for p in model.parameters()]
        trace = [t.clone() for t in state.opt_state.trace]
        js, jm = jstep(js, key, jnp.asarray(x), jnp.asarray(y))
        state, pm = pstep(state, KEY, *to_device(x, y, "cpu"), uniforms=draws)
        out.append(dict(jskip=float(jm["skipped"]), pskip=float(pm["skipped"]),
                        held=all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
                        and all(torch.equal(a, b) for a, b in zip(trace,
                                                                  state.opt_state.trace)),
                        loss=(float(pm["loss"]), float(jm["loss"])),
                        gn=(float(pm["grad_norm"]), float(jm["grad_norm"])) if track else None))
    trainer.encode_tree = encode
    return out, js, model, state, max_scale[0]


_RUNS: dict = {}


def _plan_run(start, code):
    """The plan's run of ``code``, made once for its three fault cases."""
    if code not in _RUNS:
        _RUNS[code] = _run(start, code, PLAN, MAXN)
    return _RUNS[code]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("code", ["sgd", "svd", "qsgd"])
def test_guarded_step_matches_jax(start, code, fault):
    out, js, model, state, max_scale = _plan_run(start, code)
    bad = FAULTS[fault]
    o = out[bad - 1]
    assert o["pskip"] == o["jskip"] == 1.0 and o["held"], (bad, o)
    np.testing.assert_allclose(o["loss"][0], o["loss"][1], rtol=1e-5)
    for s, o in enumerate(out, start=1):
        assert o["pskip"] == o["jskip"] == (1.0 if s in FAULTS.values() else 0.0), (s, o)
        assert o["held"] == (s in FAULTS.values()), (s, o)
    assert int(state.held) == 3 and state.opt_state.count == STEPS
    atol = {"sgd": 1e-5, "svd": 1e-4}.get(code, 1e-5 + LR * STEPS * max_scale / 15)
    params, _ = jax_from_state_dict(model)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def test_rewarm_remedy_and_grad_norm_match_jax(start):
    """``remedy=`` scales the decoded gradient by the ramp of the step
    counter, and ``track_grad_norm`` reports the raw norm, as in JAX."""
    out, js, model, _, _ = _run(start, "sgd", "nan@3", 0.0, remedy=(1, 3, 0.2), track=True)
    for o in out:
        np.testing.assert_allclose(o["gn"][0], o["gn"][1], rtol=1e-5)
    params, _ = jax_from_state_dict(model)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_held_count_reaches_the_checkpoint(start, tmp_path):
    """A guarded state's checkpoint holds the optimizer count less the
    skipped steps (optax's count in the JAX state), and a resume carries on
    from it."""
    from atomo_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

    _, _, _, state, _ = _run(start, "sgd", "nan@2", 0.0)
    save_checkpoint(str(tmp_path), state, compress=False)
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    opt = make_optimizer("sgd", lr=LR, momentum=MOMENTUM)
    fresh = TrainState(step=0, model=model, opt_state=opt.init(leaf_params(model)))
    loaded = load_checkpoint(str(tmp_path), fresh)
    assert (loaded.step, loaded.opt_state.count, loaded.held) == (STEPS, STEPS - 1, None)
    assert dataclasses.replace(state, held=None).step == loaded.step
