"""The JAX package's side of the multi-rank parity tests.

Runs the reference's ``make_distributed_train_step`` on the conftest's forced
CPU mesh (a sub-mesh of N devices) and computes, for each step and each
replica r, the draws its codec makes: the codec key is
``split(fold_in(fold_in(key, step), r), 3)[2]`` (``replicated.py:1502-1503``)
and leaf i draws from ``fold_in(k_codec, i)``; its dropout layers draw
under ``k_drop``, the split's second key (``fold_in(k_drop, i)`` for
microbatch i under ``grad_accum``), the keep-masks that
:func:`flax_dropout_masks` captures. On the two-tier mesh (``dcn_ways``)
card r draws under its group's outer key and, under a ``cring`` inner, its
own inner key (:func:`two_tier_draws`). The port's ranks get those draws
through the step's ``draws=`` and ``dropout_masks=`` hooks, as numpy arrays
(:mod:`torch_dist`).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.codecs import svd as jsvd
from atomo_tpu.data import SPECS as JAX_SPECS
from atomo_tpu.models import get_model as jax_model
from atomo_tpu.parallel import make_distributed_train_step, make_mesh, replicate_state, shard_batch
from atomo_tpu.training import create_state, make_optimizer as jax_optimizer
from atomo_tpu_torch.codecs import SvdCodec
from atomo_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from atomo_tpu_torch.data import SPECS, BatchIterator, synthetic_dataset
from atomo_tpu_torch.models import get_model
from test_torch_svd import jax_draw_arrays
from torch_dist import build_model

LR, MOMENTUM = 0.001, 0.9
BITS = 4
# the port's codec by CLI name and arguments (get_codec), the JAX package's twin
CODECS = {
    "qsgd": (("qsgd", {"quantization_level": BITS}), lambda: JaxQsgd(bits=BITS)),
    "terngrad": (("terngrad", {}),
                 lambda: JaxQsgd(bits=1, scheme="terngrad", name="terngrad")),
    "svd": (("svd", {"svd_rank": 3}), lambda: jsvd.SvdCodec(rank=3)),
    "sgd": (None, lambda: None),
}


def batches(dataset: str, batch: int, steps: int, seed: int = 3):
    """The same synthetic global batches for both packages (numpy, NHWC)."""
    ds = synthetic_dataset(SPECS[dataset], True, size=64, seed=seed)
    it = BatchIterator(ds, batch, seed=seed).forever()
    return [next(it) for _ in range(steps)]


_UNIFORMS: dict = {}


def _uniform_fn(shape: tuple):
    """``jax.random.uniform`` of one shape (in the default float type) as one
    compiled program: the same draws as its op-by-op run."""
    key = (shape, bool(jax.config.jax_enable_x64))
    if key not in _UNIFORMS:
        _UNIFORMS[key] = jax.jit(lambda k: jax.random.uniform(k, shape))
    return _UNIFORMS[key]


def qsgd_draws(k_codec, params, bucket: int = 512):
    """The uniforms the JAX QSGD codec draws for each leaf under ``k_codec``."""
    return [np.asarray(_uniform_fn((-(-leaf.size // bucket), bucket))(
                jax.random.fold_in(k_codec, i)))
            for i, leaf in enumerate(jax.tree_util.tree_leaves(params))]


_SVD_DRAWS: dict = {}


def jit_svd_draws(codec, key, shape: tuple) -> dict:
    """``test_torch_svd.jax_draws`` as numpy arrays, one compiled program a
    (codec, leaf shape): the same draws as its op-by-op run, compiled once a
    shape instead of once an op."""
    if (codec, shape) not in _SVD_DRAWS:
        _SVD_DRAWS[codec, shape] = jax.jit(lambda k: jax_draw_arrays(codec, k, shape))
    return {k: np.asarray(v) for k, v in _SVD_DRAWS[codec, shape](key).items()}


def svd_draws(k_codec, params, rank: int = 3):
    """The draws the JAX SVD codec makes for each leaf under ``k_codec``."""
    codec = SvdCodec(rank=rank)
    return [jit_svd_draws(codec, jax.random.fold_in(k_codec, i), tuple(leaf.shape))
            for i, leaf in enumerate(jax.tree_util.tree_leaves(params))]


_MASK_FNS: dict = {}


def _dropout_apply(model, variables, x, key, has_bn: bool):
    """The train-mode apply with its Dropout layers' keep-masks captured:
    (masks in call order, output)."""
    import flax.linen as nn

    masks = []

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, nn.Dropout) and context.method_name == "__call__"
                and not mod.deterministic and 0.0 < mod.rate < 1.0):
            rng = mod.make_rng(mod.rng_collection)
            masks.append(jax.random.bernoulli(rng, 1.0 - mod.rate, args[0].shape))
            return next_fun(*args, **kwargs, rng=rng)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(intercept):
        out = model.apply(variables, x, train=True, rngs={"dropout": key},
                          mutable=["batch_stats"] if has_bn else [])
    if has_bn or isinstance(out, tuple):
        out = out[0]
    return masks, out


def flax_dropout_masks(model, variables, x, key, return_output: bool = False):
    """The keep-masks the Flax model's ``nn.Dropout`` layers draw in a
    train-mode apply on ``x`` under dropout key ``key``, in call order.

    An interceptor around ``nn.Dropout.__call__`` draws each layer's key
    with ``make_rng`` (once, as the layer itself would), takes the mask
    ``bernoulli(rng, 1 - rate)`` that the layer draws from it, and hands the
    layer that key; the apply's output is unchanged. A mask depends on the
    key and the shape alone, so the masks of a step's apply are those of
    this one on an input of the same shape. Run it under the x64 setting of
    the step it stands for: the draw's uniform takes the default float.
    The masks alone come from one compiled program a model and x64 setting
    (op by op, every layer compiles its own): a draw is integer arithmetic
    on the key, the same bits either way. With ``return_output`` the apply
    runs op by op, its output the JAX package's eager one."""
    has_bn = "batch_stats" in variables
    if return_output:
        masks, out = _dropout_apply(model, variables, jnp.asarray(x), key, has_bn)
        return [np.asarray(m) for m in masks], out
    fkey = (id(model), has_bn, bool(jax.config.jax_enable_x64))
    if fkey not in _MASK_FNS:
        # the model is kept with its program, so that its id stays its own
        _MASK_FNS[fkey] = (model, jax.jit(
            lambda v, xx, k: _dropout_apply(model, v, xx, k, has_bn)[0]))
    return [np.asarray(m) for m in _MASK_FNS[fkey][1](variables, jnp.asarray(x), key)]


def two_tier_draws(draw, plan, key, step: int, chip: int, n_inner: int, tree):
    """Card ``chip``'s draws of a two-tier step (``atomo_tpu/topology/
    execute.py:52-76``): the boundary re-encode's under its group's outer key
    and, under a ``cring`` inner, its own encode's under its inner key; a
    dict of the parts the plan draws (the port's ``draws=`` for the step)."""
    from atomo_tpu.topology.execute import inner_codec_key, outer_codec_key

    step_key = jax.random.fold_in(key, step)
    out = {}
    if plan.inner == "cring":
        out["inner"] = draw(inner_codec_key(step_key, chip), tree)
    if plan.outer != "psum":
        out["outer"] = draw(outer_codec_key(step_key, chip // n_inner), tree)
    return out


def codec_key(key, step: int, replica: int):
    return jax.random.split(jax.random.fold_in(jax.random.fold_in(key, step), replica), 3)[2]


def drop_key(key, step: int, replica: int):
    """Replica ``replica``'s dropout key of step ``step`` (``replicated.py:1502-1503``)."""
    return jax.random.split(jax.random.fold_in(jax.random.fold_in(key, step), replica), 3)[1]


def jax_build(network):
    """The JAX package's model: a registry name, or ``(class name, kwargs)``
    of ``atomo_tpu.models`` (a reduced VGG or DenseNet)."""
    import atomo_tpu.models as jm

    if isinstance(network, str):
        return jax_model(network, 10)
    name, kw = network
    return getattr(jm, name)(num_classes=10, **kw)



@contextlib.contextmanager
def jax_x64(on: bool):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(on))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


class Reference:
    """One model's start (a Flax init) and the JAX package's dp-N run of it,
    in float64 where ``x64`` is set (the port starts from the float32 init
    either way): ResNet-18's, as ``tests/test_torch_trainer.py`` explains,
    since XLA's float32 BatchNorm variance on the CPU loses to cancellation
    what the comparison would measure."""

    def __init__(self, network, dataset: str, batch: int, steps: int, x64: bool = False):
        self.network, self.dataset, self.x64 = network, dataset, x64
        self.batches = batches(dataset, batch, steps)
        self.image_shape = JAX_SPECS[dataset].image_shape
        self.jmodel = jax_build(network)
        self.jopt = jax_optimizer("sgd", lr=LR, momentum=MOMENTUM)
        self.jstate = create_state(self.jmodel, self.jopt, jax.random.PRNGKey(0),
                                   jnp.asarray(self.batches[0][0]))
        self.port_model = build_model(network, 10, self.image_shape)
        sd = state_dict_from_jax(self.port_model, jax.device_get(self.jstate.params),
                                 jax.device_get(self.jstate.batch_stats))
        self.state_dict = {k: v.numpy() for k, v in sd.items()}
        if x64:
            with jax_x64(True):
                self.jstate = jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float64) if a.dtype == np.float32 else a,
                    jax.device_get(self.jstate))
        self.key = jax.random.PRNGKey(7)
        self._runs: dict = {}
        self._has_dropout = None

    def run(self, code: str, aggregate: str, n: int, num_aggregate: int = 0):
        """The reference's steps: per step the params and batch_stats
        (numpy trees) and metrics, and the per-rank draws for the port
        (run once for each set of arguments)."""
        out, per_rank = self.run_ranks(code, aggregate, n, num_aggregate)
        return out, [r["draws"] for r in per_rank]

    def run_ranks(self, code: str, aggregate: str, n: int, num_aggregate: int = 0,
                  grad_accum: int = 1, **modes):
        """As :meth:`run`, with each rank's arguments of the ``train`` job:
        its codec draws and the dropout keep-masks its replica drew (None
        for a model without dropout). ``modes`` go to the JAX step factory
        (``overlap="delayed"``, ``stream_encode``, ``stream_bucket_bytes``,
        ``guard``, ``chaos``); each step's ``skipped`` metric comes back
        under delayed or the guard, ``dropped`` under the guard."""
        args = (code, aggregate, n, num_aggregate, grad_accum, tuple(sorted(modes.items())))
        if args not in self._runs:
            with jax_x64(self.x64):
                self._runs[args] = self._run(*args[:-1], **modes)
        return self._runs[args]

    def _masks(self, x, k_drop, grad_accum: int):
        """One replica's dropout keep-masks of a step, over its microbatches
        in order (microbatch i under ``fold_in(k_drop, i)``); none, without
        a draw, for a model that has no dropout."""
        if self._has_dropout is False:
            return []
        variables = {"params": self.jstate.params}
        if jax.tree_util.tree_leaves(self.jstate.batch_stats):
            variables["batch_stats"] = self.jstate.batch_stats
        if grad_accum <= 1:
            masks = flax_dropout_masks(self.jmodel, variables, x, k_drop)
        else:
            mb = x.shape[0] // grad_accum
            masks = [m for i in range(grad_accum) for m in flax_dropout_masks(
                self.jmodel, variables, x[i * mb:(i + 1) * mb],
                jax.random.fold_in(k_drop, i))]
        self._has_dropout = bool(masks)
        return masks

    def _run(self, code, aggregate, n, num_aggregate, grad_accum, partition=None,
             arrivals=None, dcn_ways=0, plan=None, **modes):
        from atomo_tpu.parallel import init_delayed_state
        from atomo_tpu.parallel.replicated import init_quorum_state

        _, make = CODECS[code]
        mesh = make_mesh(n_devices=n)
        topo = None  # the two-tier step's plan, and its key helpers
        if dcn_ways:
            from atomo_tpu.mesh.spec import MeshSpec as JMeshSpec
            from atomo_tpu.topology import LEGACY_PLAN, plan_from_name

            mesh = JMeshSpec.from_world(n, dcn_ways).build()
            modes.update(inner_axis="ici",
                         plan=plan_from_name(plan) if plan is not None else None)
            topo = modes["plan"] or LEGACY_PLAN
        codec = make()
        # from host copies: the step donates its state's buffers
        state, su = replicate_state(mesh, jax.device_get(self.jstate)), None
        if partition == "zero1":
            from atomo_tpu.parallel.replicated import zero1_state

            state, modes["zero1_specs"] = zero1_state(mesh, state, self.jopt)
        elif partition == "sharded-update":
            from atomo_tpu.mesh.update import sharded_update_state

            state, su = sharded_update_state(mesh, jax.device_get(self.jstate), self.jopt)
            modes["sharded_update"] = su
        step = make_distributed_train_step(self.jmodel, self.jopt, mesh, codec,
                                           aggregate=aggregate, num_aggregate=num_aggregate,
                                           grad_accum=grad_accum, **modes)
        tree = jax.device_get(self.jstate.params)  # the leaf shapes the draws take
        delayed = modes.get("overlap") == "delayed"
        if delayed:
            state = init_delayed_state(mesh, state, codec)
        quorum = modes.get("quorum")
        if quorum is not None:  # the step takes arrivals[s] at step s
            state = init_quorum_state(mesh, state, codec, quorum.staleness)
        draw = {"qsgd": qsgd_draws, "terngrad": qsgd_draws, "svd": svd_draws}.get(code)
        out = []
        draws = [[] for _ in range(n)]
        masks = [[] for _ in range(n)]
        for s, (x, y) in enumerate(self.batches):
            per = x.shape[0] // n
            for r in range(n):
                if draw is not None and topo is not None:
                    draws[r].append(two_tier_draws(draw, topo, self.key, s, r,
                                                   n // dcn_ways, tree))
                elif draw is not None:
                    draws[r].append(draw(codec_key(self.key, s, r), tree))
                masks[r].append(self._masks(x[r * per:(r + 1) * per],
                                            drop_key(self.key, s, r), grad_accum))
            x = jnp.asarray(x, jnp.float64 if self.x64 else jnp.float32)
            extra = () if quorum is None else (jnp.asarray(np.asarray(arrivals[s], np.int32)),)
            axes = ("dp", "ici") if topo is not None else "dp"
            state, m = step(state, self.key, *shard_batch(mesh, x, jnp.asarray(y), axis=axes),
                            *extra)[:2]
            guarded = modes.get("guard") is not None or quorum is not None
            train = state.train if hasattr(state, "train") else state
            out.append({"params": (su.materialize_host(train.master) if su is not None
                                   else jax.device_get(train.params)),
                        "batch_stats": jax.device_get(train.batch_stats),
                        "opt_state": jax.device_get(train.opt_state),
                        "loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"]),
                        "skipped": float(m["skipped"]) if delayed or guarded else None,
                        "dropped": float(m["dropped"]) if guarded else None,
                        **{q: np.asarray(m[q]) for q in ("q_err2", "q_rel") if q in m},
                        **{q: float(m[q]) for q in ("quorum_kept", "stale_dropped") if q in m},
                        **({"ring": [np.asarray(a) for a in
                                     jax.tree_util.tree_leaves(jax.device_get(state.carry.ring))],
                            "ring_ok": np.asarray(jax.device_get(state.carry.ring_ok))}
                           if quorum is not None else {})})
        return out, [{"draws": draws[r] if draw is not None else None,
                      "dropout_masks": masks[r] if any(masks[r]) else None}
                     for r in range(n)]

    def job(self, code: str, aggregate: str, num_aggregate: int = 0,
            ring_bucket_size: int = 65536, grad_accum: int = 1, **modes) -> dict:
        """The shared arguments of the ``train`` job for the port's ranks
        (``modes``: the step's ``overlap``, ``stream_encode``,
        ``stream_bucket_bytes``)."""
        return dict(network=self.network, num_classes=10, image_shape=self.image_shape,
                    state_dict=self.state_dict, codec=CODECS[code][0], aggregate=aggregate,
                    num_aggregate=num_aggregate, ring_bucket_size=ring_bucket_size, lr=LR,
                    momentum=MOMENTUM, batches=self.batches, key=11, grad_accum=grad_accum,
                    **modes)

    def port_trees(self, state_dict):
        """A port state_dict (numpy) as the JAX package's (params,
        batch_stats) trees."""
        import torch

        return jax_from_state_dict(self.port_model,
                                   {k: torch.from_numpy(v) for k, v in state_dict.items()})


def assert_parity(ref: Reference, out, answers, code: str) -> None:
    """The port's ranks against the reference's run, step by step. Every
    rank's parameters and buffers hash alike after each step (replicas bit
    for bit); rank 0's loss within rtol 1e-5 and its ``msg_bytes`` exactly
    equal; after the last step its parameters within 1e-5 (float32
    convolutions summed in other orders), plus, for QSGD and TernGrad, one
    quantization step (largest scale / levels) times lr for each step taken
    (a field may move a level where the gradients' float-level difference
    crosses its uniform): the tolerances of ``tests/test_torch_trainer.py``'s
    LeNet cases. BatchNorm statistics, where the model has them, within
    1e-5 + rtol 1e-4."""
    for s, want in enumerate(out):
        hashes = {a["steps"][s]["hash"] for a in answers}
        assert len(hashes) == 1, f"step {s + 1}: replicas differ ({len(hashes)} states)"
        got = answers[0]["steps"][s]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["msg_bytes"] == want["msg_bytes"], (s, got["msg_bytes"], want["msg_bytes"])
    levels = {"qsgd": (1 << BITS) - 1, "terngrad": 1}.get(code)
    max_step = max(a["max_scale"] for a in answers) / levels if levels else 0.0
    atol = 1e-5 + LR * max_step * len(out)
    params, stats = ref.port_trees(answers[0]["state_dict"])
    for got, want, tol in ((params, out[-1]["params"], dict(atol=atol)),
                           (stats, out[-1]["batch_stats"], dict(rtol=1e-4, atol=1e-5))):
        got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), **tol)
