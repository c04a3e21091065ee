"""The JAX package's side of the multi-rank parity tests.

Runs the reference's ``make_distributed_train_step`` on the conftest's forced
CPU mesh (a sub-mesh of N devices) and computes, for each step and each
replica r, the draws its codec makes: the codec key is
``split(fold_in(fold_in(key, step), r), 3)[2]`` (``replicated.py:1502-1503``)
and leaf i draws from ``fold_in(k_codec, i)``; its dropout layers draw
under ``k_drop``, the split's second key (``fold_in(k_drop, i)`` for
microbatch i under ``grad_accum``), the keep-masks that
:func:`flax_dropout_masks` captures. The port's ranks get those draws
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
from test_torch_svd import jax_draws
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


def qsgd_draws(k_codec, params, bucket: int = 512):
    """The uniforms the JAX QSGD codec draws for each leaf under ``k_codec``."""
    return [np.asarray(jax.random.uniform(jax.random.fold_in(k_codec, i),
                                          (-(-leaf.size // bucket), bucket)))
            for i, leaf in enumerate(jax.tree_util.tree_leaves(params))]


def svd_draws(k_codec, params, rank: int = 3):
    """The draws the JAX SVD codec makes for each leaf under ``k_codec``."""
    codec = SvdCodec(rank=rank)
    return [{k: v.numpy() for k, v in
             jax_draws(codec, jax.random.fold_in(k_codec, i), tuple(leaf.shape)).items()}
            for i, leaf in enumerate(jax.tree_util.tree_leaves(params))]


def flax_dropout_masks(model, variables, x, key, return_output: bool = False):
    """The keep-masks the Flax model's ``nn.Dropout`` layers draw in a
    train-mode apply on ``x`` under dropout key ``key``, in call order.

    An interceptor around ``nn.Dropout.__call__`` draws each layer's key
    with ``make_rng`` (once, as the layer itself would), takes the mask
    ``bernoulli(rng, 1 - rate)`` that the layer draws from it, and hands the
    layer that key; the apply's output is unchanged. A mask depends on the
    key and the shape alone, so the masks of a step's apply are those of
    this one on an input of the same shape. Run it under the x64 setting of
    the step it stands for: the draw's uniform takes the default float."""
    import flax.linen as nn

    masks = []

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, nn.Dropout) and context.method_name == "__call__"
                and not mod.deterministic and 0.0 < mod.rate < 1.0):
            rng = mod.make_rng(mod.rng_collection)
            masks.append(np.asarray(jax.random.bernoulli(rng, 1.0 - mod.rate,
                                                         args[0].shape)))
            return next_fun(*args, **kwargs, rng=rng)
        return next_fun(*args, **kwargs)

    has_bn = "batch_stats" in variables
    with nn.intercept_methods(intercept):
        out = model.apply(variables, jnp.asarray(x), train=True, rngs={"dropout": key},
                          mutable=["batch_stats"] if has_bn else [])
    if has_bn or isinstance(out, tuple):
        out = out[0]
    return (masks, out) if return_output else masks


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
                  grad_accum: int = 1):
        """As :meth:`run`, with each rank's arguments of the ``train`` job:
        its codec draws and the dropout keep-masks its replica drew (None
        for a model without dropout)."""
        args = (code, aggregate, n, num_aggregate, grad_accum)
        if args not in self._runs:
            with jax_x64(self.x64):
                self._runs[args] = self._run(*args)
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

    def _run(self, code, aggregate, n, num_aggregate, grad_accum):
        _, make = CODECS[code]
        mesh = make_mesh(n_devices=n)
        step = make_distributed_train_step(self.jmodel, self.jopt, mesh, make(),
                                           aggregate=aggregate, num_aggregate=num_aggregate,
                                           grad_accum=grad_accum)
        # from host copies: the step donates its state's buffers
        state = replicate_state(mesh, jax.device_get(self.jstate))
        draw = {"qsgd": qsgd_draws, "terngrad": qsgd_draws, "svd": svd_draws}.get(code)
        out = []
        draws = [[] for _ in range(n)]
        masks = [[] for _ in range(n)]
        for s, (x, y) in enumerate(self.batches):
            per = x.shape[0] // n
            for r in range(n):
                if draw is not None:
                    draws[r].append(draw(codec_key(self.key, s, r), state.params))
                masks[r].append(self._masks(x[r * per:(r + 1) * per],
                                            drop_key(self.key, s, r), grad_accum))
            x = jnp.asarray(x, jnp.float64 if self.x64 else jnp.float32)
            state, m = step(state, self.key, *shard_batch(mesh, x, jnp.asarray(y)))[:2]
            out.append({"params": jax.device_get(state.params),
                        "batch_stats": jax.device_get(state.batch_stats),
                        "loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"])})
        return out, [{"draws": draws[r] if draw is not None else None,
                      "dropout_masks": masks[r] if any(masks[r]) else None}
                     for r in range(n)]

    def job(self, code: str, aggregate: str, num_aggregate: int = 0,
            ring_bucket_size: int = 65536, grad_accum: int = 1) -> dict:
        """The shared arguments of the ``train`` job for the port's ranks."""
        return dict(network=self.network, num_classes=10, image_shape=self.image_shape,
                    state_dict=self.state_dict, codec=CODECS[code][0], aggregate=aggregate,
                    num_aggregate=num_aggregate, ring_bucket_size=ring_bucket_size, lr=LR,
                    momentum=MOMENTUM, batches=self.batches, key=11, grad_accum=grad_accum)

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
