"""The JAX package's side of the multi-rank parity tests.

Runs the reference's ``make_distributed_train_step`` on the conftest's forced
CPU mesh (a sub-mesh of N devices) and computes, for each step and each
replica r, the draws its codec makes: the codec key is
``split(fold_in(fold_in(key, step), r), 3)[2]`` (``replicated.py:1502-1503``)
and leaf i draws from ``fold_in(k_codec, i)``. The port's ranks get those
draws through the step's ``draws=`` hook, as numpy arrays (:mod:`torch_dist`).
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


def codec_key(key, step: int, replica: int):
    return jax.random.split(jax.random.fold_in(jax.random.fold_in(key, step), replica), 3)[2]


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

    def __init__(self, network: str, dataset: str, batch: int, steps: int, x64: bool = False):
        self.network, self.dataset, self.x64 = network, dataset, x64
        self.batches = batches(dataset, batch, steps)
        self.image_shape = JAX_SPECS[dataset].image_shape
        self.jmodel = jax_model(network, 10)
        self.jopt = jax_optimizer("sgd", lr=LR, momentum=MOMENTUM)
        self.jstate = create_state(self.jmodel, self.jopt, jax.random.PRNGKey(0),
                                   jnp.asarray(self.batches[0][0]))
        self.port_model = get_model(network, 10, image_shape=self.image_shape)
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

    def run(self, code: str, aggregate: str, n: int, num_aggregate: int = 0):
        """The reference's steps: per step the params and batch_stats
        (numpy trees) and metrics, and the per-rank draws for the port
        (run once for each set of arguments)."""
        args = (code, aggregate, n, num_aggregate)
        if args not in self._runs:
            with jax_x64(self.x64):
                self._runs[args] = self._run(*args)
        return self._runs[args]

    def _run(self, code, aggregate, n, num_aggregate):
        _, make = CODECS[code]
        mesh = make_mesh(n_devices=n)
        step = make_distributed_train_step(self.jmodel, self.jopt, mesh, make(),
                                           aggregate=aggregate, num_aggregate=num_aggregate)
        # from host copies: the step donates its state's buffers
        state = replicate_state(mesh, jax.device_get(self.jstate))
        out, draws = [], []
        for s, (x, y) in enumerate(self.batches):
            if code in ("qsgd", "terngrad"):
                draws.append([qsgd_draws(codec_key(self.key, s, r), state.params)
                              for r in range(n)])
            elif code == "svd":
                draws.append([svd_draws(codec_key(self.key, s, r), state.params)
                              for r in range(n)])
            x = jnp.asarray(x, jnp.float64 if self.x64 else jnp.float32)
            state, m = step(state, self.key, *shard_batch(mesh, x, jnp.asarray(y)))[:2]
            out.append({"params": jax.device_get(state.params),
                        "batch_stats": jax.device_get(state.batch_stats),
                        "loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"])})
        per_rank = [None] * n if not draws else [[d[r] for d in draws] for r in range(n)]
        return out, per_rank

    def job(self, code: str, aggregate: str, num_aggregate: int = 0,
            ring_bucket_size: int = 65536) -> dict:
        """The shared arguments of the ``train`` job for the port's ranks."""
        return dict(network=self.network, num_classes=10, image_shape=self.image_shape,
                    state_dict=self.state_dict, codec=CODECS[code][0], aggregate=aggregate,
                    num_aggregate=num_aggregate, ring_bucket_size=ring_bucket_size, lr=LR,
                    momentum=MOMENTUM, batches=self.batches, key=11)

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
