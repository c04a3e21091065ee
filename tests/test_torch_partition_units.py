"""The partitioned update's pieces that need no process group: the slice
probe, the flat layout against the JAX package's at one device, the
``convert`` maps, the checkpoint refusal of ``load_params``, the CLI's
pre-flight refusals and the ``train`` parser's flags against the JAX verb's.

The probe (``mesh.update.check_slice_invariant``) accepts every option of the
port's ``Sgd`` and ``Adam`` and refuses a global-norm clip, with the JAX
package's message, at the gradient scale where the clip fires. At one device
the port's flat master is the JAX package's ``sharded_update_state`` master
under ``convert.port_flat_from_jax`` bit for bit (and back), with the same
chunk and padding. A sharded-update checkpoint has no per-leaf parameters,
so ``load_params`` raises ``KeyError`` on it in both packages. Each argv
refusal exits with the JAX verb's text (``atomo_tpu/cli.py:849-930,
1045-1060,1325``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomo_tpu import cli as jax_cli
from atomo_tpu.mesh.update import sharded_update_state as jax_sharded_state
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.parallel import make_mesh
from atomo_tpu.parallel.replicated import zero1_state as jax_zero1_state
from atomo_tpu.training import create_state as jax_create_state
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu_torch import cli
from atomo_tpu_torch.convert import (
    flat_opt_from_jax,
    jax_flat_from_port,
    jax_flat_opt,
    jax_leaf_order,
    port_flat_from_jax,
    state_dict_from_jax,
)
from atomo_tpu_torch.mesh import update as U
from atomo_tpu_torch.models import get_model
from atomo_tpu_torch.training import TrainState, make_optimizer
from atomo_tpu_torch.training.checkpoint import load_params, read_checkpoint, save_checkpoint
from atomo_tpu_torch.training.optim import Sgd, stepwise_shrink
from atomo_tpu_torch.training.trainer import leaf_params


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("sgd", {"momentum": 0.5, "weight_decay": 1e-4}), ("adam", {}),
    ("adam", {"amsgrad": True}), ("adam", {"weight_decay": 1e-4, "beta1": 0.8}),
], ids=["sgd", "momentum", "nesterov", "wd", "adam", "amsgrad", "adam-wd"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_probe_accepts_every_elementwise_option(name, kw, n):
    U.check_slice_invariant(make_optimizer(name, lr=0.01, **kw), n)


@dataclasses.dataclass(frozen=True)
class _ClipSgd(Sgd):
    """SGD behind a global-norm clip at 10: the norm mixes every element."""

    def update(self, grads, state, params, scalars=None):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(10.0 / norm, max=1.0)
        return super().update([g * scale for g in grads], state, params, scalars)


def test_probe_refuses_a_global_norm_clip():
    opt = _ClipSgd(schedule=stepwise_shrink(0.01), momentum=0.9)
    with pytest.raises(ValueError, match=r"not slice-invariant \(at gradient scale 10000"):
        U.check_slice_invariant(opt, 2)
    U.check_slice_invariant(opt, 1)  # one slice is the whole vector


def _jax_lenet():
    model = jax_model("lenet", 10)
    opt = jax_optimizer("sgd", lr=0.01, momentum=0.9)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 28, 28, 1), np.float32))
    return model, opt, jax.device_get(jax_create_state(model, opt, jax.random.PRNGKey(0), x))


def _port_lenet(host):
    model = get_model("lenet", 10, image_shape=(28, 28, 1))
    model.load_state_dict(state_dict_from_jax(model, host.params, host.batch_stats))
    opt = make_optimizer("sgd", lr=0.01, momentum=0.9)
    return model, opt, TrainState(0, model, opt.init(leaf_params(model)))


@pytest.mark.parametrize("partition", ["zero1", "sharded-update"])
def test_one_device_layout_is_the_jax_layout(partition):
    """No group: one rank, the chunk the whole padded vector; the port's
    flat parameters and optimizer buffers against the JAX package's
    ``zero1_state`` / ``sharded_update_state`` on a one-device mesh."""
    jmodel, jopt, host = _jax_lenet()
    model, opt, state = _port_lenet(host)
    mesh = make_mesh(1)
    if partition == "zero1":
        jst, _ = jax_zero1_state(mesh, jax.device_get(host), jopt)
        st, spec = U.zero1_state(state, opt)
        port_flat = spec.flat
    else:
        jst, su = jax_sharded_state(mesh, host, jopt)
        st, spec = U.sharded_update_state(state, opt)
        port_flat = st.master
        assert (spec.chunk, spec.d_flat) == (su.chunk, su.d_flat)
        master = np.asarray(jax.device_get(jst.master))
        assert torch.equal(port_flat_from_jax(model, master), st.master)
        assert np.array_equal(jax_flat_from_port(model, st.master), master)
    assert torch.equal(port_flat[:spec.d_flat],
                       torch.cat([p.detach().reshape(-1) for p in leaf_params(model)]))
    by_name = spec.materialize_host(port_flat)
    assert all(torch.equal(by_name[n], p) for n, p in zip(jax_leaf_order(model),
                                                          leaf_params(model)))
    full = flat_opt_from_jax(model, jax.device_get(jst.opt_state))
    assert full["count"] == st.opt_state.count == 0
    assert torch.equal(full["trace"][0], st.opt_state.trace[0])
    back = jax_flat_opt(model, full, jax.device_get(jst.opt_state))
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax.device_get(jst.opt_state))))


def test_convert_maps_are_inverse_and_move_kernels():
    """A JAX flat vector with distinct values per place: the port's flat
    holds each conv kernel transposed (HWIO -> OIHW), and the round trip
    is the identity, padding included."""
    jmodel, _, host = _jax_lenet()
    model, _, _ = _port_lenet(host)
    from jax.flatten_util import ravel_pytree

    flat, unravel = ravel_pytree(host.params)
    vec = np.arange(flat.size + 3, dtype=np.float32)
    port = port_flat_from_jax(model, vec)
    assert np.array_equal(jax_flat_from_port(model, port), vec)
    tree = unravel(jnp.asarray(vec[:flat.size]))
    sd = state_dict_from_jax(model, tree, host.batch_stats)
    want = torch.cat([sd[n].reshape(-1) for n in jax_leaf_order(model)])
    assert torch.equal(port[:flat.size], want)
    assert not torch.equal(port, torch.from_numpy(vec))  # the layouts differ


def test_load_params_refuses_a_sharded_checkpoint_as_jax_does(tmp_path):
    """The JAX package's ``load_params`` reads ``d["params"]``, which a
    sharded-update checkpoint lacks: KeyError; the port's alike."""
    from atomo_tpu.training.checkpoint import load_params as jax_load_params
    from atomo_tpu.training.checkpoint import save_checkpoint as jax_save

    jmodel, jopt, host = _jax_lenet()
    jst, _ = jax_sharded_state(make_mesh(1), host, jopt)
    jax_save(str(tmp_path / "jax"), jax.device_get(jst), 3)
    with pytest.raises(KeyError, match="params"):
        jax_load_params(str(tmp_path / "jax"), host)
    model, opt, state = _port_lenet(host)
    st, spec = U.sharded_update_state(state, opt)
    save_checkpoint(str(tmp_path / "port"), st, 3)
    with pytest.raises(KeyError, match="params"):
        load_params(str(tmp_path / "port"), get_model("lenet", 10, image_shape=(28, 28, 1)))
    d = read_checkpoint(str(tmp_path / "port"))
    assert torch.equal(d["master"], st.master) and "model" not in d


def _jax_preflight_message(argv):
    args = jax_cli.build_parser().parse_args(argv)
    with pytest.raises(SystemExit) as e:
        jax_cli._argv_preflight(args)
    return str(e.value.code)


T = "/nonexistent/partition_preflight"
BASE = ["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic"]


@pytest.mark.parametrize("extra", [
    ["--zero1", "--partition", "sharded-update"],
    ["--partition", "sharded-update", "--phase-metrics"],
    ["--partition", "sharded-update", "--on-diverge", "skip", "--train-dir", T],
    ["--partition", "sharded-update", "--sparse-rows", "on", "--n-devices", "2"],
    ["--error-feedback", "--zero1", "--code", "svd", "--n-devices", "2"],
    ["--error-feedback", "--partition", "sharded-update", "--code", "svd", "--n-devices", "2"],
    ["--zero1", "--overlap", "delayed", "--max-restarts", "1", "--train-dir", T, "--code",
     "qsgd", "--n-devices", "2"],
    ["--partition", "zero1", "--on-diverge", "skip", "--n-devices", "2", "--train-dir", T,
     "--save-freq", "2"],
], ids=["zero1-vs-sharded", "phase-metrics", "on-diverge", "sparse-rows", "ef-zero1",
        "ef-sharded", "zero1-delayed-supervised", "zero1-on-diverge"])
def test_cli_preflight_refusals_match_the_jax_verb(extra):
    want = _jax_preflight_message(BASE + extra)
    with pytest.raises(SystemExit) as e:
        cli.main(BASE + extra + ["--device", "cpu"], log_fn=lambda line: None)
    assert str(e.value.code) == want


def test_sharded_delayed_supervised_passes_the_preflight():
    """``--max-restarts`` with ``--partition sharded-update --overlap
    delayed`` is allowed (its checkpoints carry the payload), as in JAX."""
    argv = BASE + ["--partition", "sharded-update", "--overlap", "delayed", "--max-restarts",
                   "1", "--train-dir", T, "--code", "qsgd", "--n-devices", "2"]
    jax_cli._argv_preflight(jax_cli.build_parser().parse_args(argv))
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    cli._partition_preflight(args)
    cli._overlap_preflight(args)


# the JAX train flags the port has not yet (ROADMAP.md, queue 1 items 11-12)
NOT_PORTED = {"--elastic", "--elastic-reshard", "--elastic-patience",
              "--readmit-at", "--auto", "--tune-steps", "--tune-reps", "--tune-top"}


def _train_actions(parser) -> dict:
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {s: a for a in sub.choices["train"]._actions for s in a.option_strings
            if s.startswith("--")}


def test_train_parser_has_every_jax_flag_but_the_listed_ones():
    jax_flags = _train_actions(jax_cli.build_parser())
    port = _train_actions(cli.build_parser())
    assert set(jax_flags) - set(port) == NOT_PORTED
    for flag in set(jax_flags) & set(port):
        assert (port[flag].default, port[flag].choices) == (jax_flags[flag].default,
                                                            jax_flags[flag].choices), flag
