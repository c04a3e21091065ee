"""The JAX package's side of the LM's multi-rank parity tests.

Runs the reference's dp x sp LM step (``MeshSpec.from_layout`` and
``build_model_axis_program``, as ``cmd_lm`` does) on the conftest's forced
CPU mesh, from one Flax init with its LayerNorm scales perturbed from a numpy
seed (so that every converted field matters), on token batches drawn with
numpy, and computes for each step and each dp replica r the draws its codec
makes: the codec key is ``fold_in(fold_in(key, step), r)`` (``lm.py:612-614``)
and leaf i draws from ``fold_in(k_codec, i)``. The port's ranks get those
draws through the step's ``draws=`` hook, every sp rank of replica r those
of r (:mod:`torch_dist`'s ``lm`` job).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch_dist_jax as J

from atomo_tpu.codecs import QsgdCodec as JaxQsgd
from atomo_tpu.codecs import svd as jsvd
from atomo_tpu.mesh.spec import MeshSpec
from atomo_tpu.models.transformer import TransformerLM as FlaxLM
from atomo_tpu.parallel import replicate_state
from atomo_tpu.parallel.lm import DpExchange
from atomo_tpu.parallel.model_axes import build_model_axis_program
from atomo_tpu.training import make_optimizer as jax_optimizer
from atomo_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from atomo_tpu_torch.models.transformer import TransformerLM

# width 32 and 4 heads (head dim 8), two blocks, 32 positions: small, and
# every sp size the tests take (2, 4) divides both the heads and the sequence
CFG = dict(vocab_size=16, max_len=32, width=32, depth=2, num_heads=4)
BATCH, STEPS, KEY = 4, 3, 7
LR, MOMENTUM = 0.1, 0.9
BITS, SVD_RANK = 4, 3  # rank 3: the auto rank of width 32
CODECS = {
    "sgd": (None, lambda: None),
    "svd": (("svd", {"svd_rank": SVD_RANK}), lambda: jsvd.SvdCodec(rank=SVD_RANK)),
    "qsgd": (("qsgd", {"quantization_level": BITS}), lambda: JaxQsgd(bits=BITS)),
}


def tokens(step: int, cfg=CFG, batch=BATCH) -> np.ndarray:
    """Step ``step``'s global batch (int32 numpy)."""
    return np.random.default_rng(100 + step).integers(
        0, cfg["vocab_size"], size=(batch, cfg["max_len"])).astype(np.int32)


def flax_params(cfg=CFG, seed: int = 0):
    """A Flax init of the LM with its LayerNorm scales perturbed."""
    sample = jnp.zeros((1, cfg["max_len"]), jnp.int32)
    params = FlaxLM(**cfg).init({"params": jax.random.PRNGKey(seed)}, sample)["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), params)


def port_state_dict(params, cfg=CFG) -> dict:
    """A JAX parameter tree as the port's state_dict (numpy)."""
    sd = state_dict_from_jax(TransformerLM(**cfg), params, {})
    return {k: v.numpy() for k, v in sd.items()}


def jax_params(state_dict, cfg=CFG):
    """A port state_dict (numpy) as the JAX package's parameter tree."""
    import torch

    model = TransformerLM(**cfg)
    return jax_from_state_dict(model, {k: torch.from_numpy(v) for k, v in state_dict.items()})[0]


def step_key(i: int):
    return jax.random.fold_in(jax.random.PRNGKey(KEY), i)


def codec_draws(code: str, k_codec, params):
    if code == "qsgd":
        return J.qsgd_draws(k_codec, params)
    if code == "svd":
        return J.svd_draws(k_codec, params, rank=SVD_RANK)
    return None


def batches(steps: int = STEPS, cfg=CFG):
    """The global batches of steps 1..``steps``."""
    return [tokens(s + 1, cfg) for s in range(steps)]


def run(n_dev: int, ways: int, attn_impl: str, code: str, aggregate: str, *,
        optimizer: str = "sgd", lr: float = LR, compute_dtype=None, cfg=CFG,
        steps: int = STEPS, params=None, token_batches=None, **modes):
    """The reference's steps on a (n_dev / ways, ways) mesh from ``params``
    (default :func:`flax_params`) over ``token_batches`` (default
    :func:`batches` of ``steps``), step i's key ``fold_in(key(7), i)``:
    per step the loss, msg and dense bytes, the final parameters (numpy
    tree), and for each port rank (mesh position r // ways, r % ways) the
    draws of its replica, one list per step. ``modes`` (``stream_encode``,
    ``stream_bucket_bytes``, ``overlap``) go to the step's ``DpExchange``;
    under ``overlap="delayed"`` each step's ``skipped`` comes back too."""
    from atomo_tpu.parallel.replicated import DelayedState

    params = flax_params(cfg) if params is None else params
    token_batches = batches(steps, cfg) if token_batches is None else token_batches
    jopt = jax_optimizer(optimizer, lr=lr, momentum=MOMENTUM)
    spec = MeshSpec.from_layout("dp-sp", n_dev, ways)
    exchange = (DpExchange(aggregate=aggregate, **modes) if aggregate == "ring" or modes
                else None)
    prog = build_model_axis_program(
        spec, cfg, jopt, jax.random.PRNGKey(0), CODECS[code][1](), attn_impl=attn_impl,
        compute_dtype=compute_dtype, aggregate="gather" if exchange else aggregate,
        exchange=exchange)
    delayed = isinstance(prog.state, DelayedState)
    train = prog.state.train if delayed else prog.state
    train = train.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          opt_state=jopt.init(params))
    state = replicate_state(prog.mesh, jax.device_get(train))
    if delayed:  # the carry keeps its placement, one row per device
        state = DelayedState(train=state, carry=prog.state.carry)
    n_dp = n_dev // ways
    out, draws = [], [[] for _ in range(n_dp)]
    for s, toks in enumerate(token_batches):
        key = step_key(s + 1)
        for r in range(n_dp):
            k_codec = jax.random.fold_in(jax.random.fold_in(key, s), r)
            draws[r].append(codec_draws(code, k_codec, state.params))
        state, m = prog.step(state, key, prog.shard_tokens(toks))
        out.append({"loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"]),
                    "dense_bytes": int(m["dense_bytes"]),
                    "skipped": float(m["skipped"]) if delayed else None})
    final = jax.device_get(state.params)
    per_rank = [draws[r // ways] if code != "sgd" else None for r in range(n_dev)]
    return out, final, per_rank


def job(ways: int, attn_impl: str, code: str, aggregate: str, *, optimizer: str = "sgd",
        lr: float = LR, bf16: bool = False, cfg=CFG, steps: int = STEPS, state_dict=None,
        token_batches=None, **modes) -> dict:
    """The shared arguments of the ``lm`` job for the port's ranks
    (``modes``: the ``DpExchange``'s ``stream_encode``,
    ``stream_bucket_bytes``, ``overlap``)."""
    token_batches = batches(steps, cfg) if token_batches is None else token_batches
    return dict(n_sp=ways, cfg=cfg, state_dict=state_dict or port_state_dict(flax_params(cfg)),
                codec=CODECS[code][0], attn_impl=attn_impl, aggregate=aggregate,
                optimizer=(optimizer, dict(lr=lr, momentum=MOMENTUM)), batches=token_batches,
                keys=list(range(1, len(token_batches) + 1)), bf16=bf16, modes=modes)


def quantization_atol(answers, code: str, steps: int) -> float:
    """For QSGD, what a field that moved one level on some step can leave
    in the parameters: one quantization step (the largest scale / levels)
    times lr, carried by momentum through the later steps."""
    if code != "qsgd":
        return 0.0
    carried = sum(sum(MOMENTUM ** j for j in range(steps - t)) for t in range(steps))
    return LR * carried * max(a["max_scale"] for a in answers) / ((1 << BITS) - 1)


def assert_parity(out, final, answers, *, loss_rtol: float, atol: float, cfg=CFG) -> None:
    """Every rank's parameters hash alike after each step (replicas and sp
    shards bit for bit); rank 0's loss within ``loss_rtol`` of the
    reference's and its ``msg_bytes`` and ``dense_bytes`` exactly equal;
    after the last step its parameters within ``atol``."""
    for s, want in enumerate(out):
        hashes = {a["steps"][s]["hash"] for a in answers}
        assert len(hashes) == 1, f"step {s + 1}: ranks differ ({len(hashes)} states)"
        got = answers[0]["steps"][s]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
        assert got["msg_bytes"] == want["msg_bytes"], (s, got["msg_bytes"], want["msg_bytes"])
        assert got["dense_bytes"] == want["dense_bytes"]
    got = jax.tree_util.tree_leaves(jax_params(answers[0]["state_dict"], cfg))
    want = jax.tree_util.tree_leaves(final)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


# ---- the model-axis layouts (dp-tp, dp-ep, dp-pp, dp-tp-sp) ---------------

LAYOUT_CFG = dict(vocab_size=16, max_len=8, width=16, depth=4, num_heads=2)
EXPERTS = 4


def layout_cfg(layout: str) -> dict:
    """The small LM of the layout cases: dp-ep adds its experts, dp-tp-sp
    takes 4 heads (Ulysses splits tp's local heads again over sp)."""
    cfg = dict(LAYOUT_CFG)
    if layout == "dp-ep":
        cfg["num_experts"] = EXPERTS
    if layout == "dp-tp-sp":
        cfg["num_heads"] = 4
    return cfg


def family_params(layout: str, seed: int = 0):
    """The JAX package's own init of a layout's full tree (numpy), its
    LayerNorm scales perturbed from a numpy seed so that every leaf
    matters: the stock LM re-laid for tp, the MoE tree, the stacked tree."""
    from atomo_tpu.parallel import moe as jmoe
    from atomo_tpu.parallel import pp as jpp
    from atomo_tpu.parallel import tp as jtp

    cfg = layout_cfg(layout)
    key = jax.random.PRNGKey(seed)
    if layout in ("dp-tp", "dp-tp-sp"):
        tree = jtp.lm_params_to_tp(flax_params(cfg, seed), cfg["num_heads"])
    elif layout == "dp-ep":
        tree = jmoe.init_moe_lm_params(key, cfg)
    else:
        tree = jpp.init_pp_lm_params(key, cfg)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        a = np.array(a, dtype=np.float32)
        names = jax.tree_util.keystr(path)
        if layout in ("dp-ep", "dp-pp") and "scale" in names:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def layout_batches(steps: int = STEPS, batch: int = BATCH, cfg=LAYOUT_CFG) -> list:
    return [tokens(s + 1, cfg, batch) for s in range(steps)]


def _local_shapes(layout: str, params, coords: dict):
    """Rank ``coords``' slice of the full tree (numpy), cut as the port cuts
    it (``parallel.model_axes.family_specs``), for the draws' shapes."""
    from atomo_tpu_torch.parallel.model_axes import FAMILY_AXIS, family_specs
    from atomo_tpu_torch.convert import slice_tree

    axis = FAMILY_AXIS[layout]
    return slice_tree(params, family_specs(layout, params), coords[axis], coords["n_" + axis])


def run_layout(layout: str, n_dev: int, ways, code: str, aggregate: str, *,
               microbatches: int = 2, attn_impl: str = "ring", params=None,
               token_batches=None, steps: int = STEPS, compute_dtype=None, **modes):
    """The reference's steps of ``layout`` on ``n_dev`` devices (``ways``
    its model ways; a (tp, sp) pair for dp-tp-sp) from ``params`` (default
    :func:`family_params`): per step the loss, msg and dense bytes, the
    final full tree (numpy), and per port rank (row-major over the mesh
    axes) the draws of its slice under its replica's key, one list a
    step."""
    from atomo_tpu.parallel.common import shard_state
    from atomo_tpu.parallel.replicated import DelayedState

    cfg = layout_cfg(layout)
    params = family_params(layout) if params is None else params
    token_batches = layout_batches(steps) if token_batches is None else token_batches
    jopt = jax_optimizer("sgd", lr=LR, momentum=MOMENTUM)
    spec = MeshSpec.from_layout(layout, n_dev, ways)
    exchange = (DpExchange(aggregate=aggregate, **modes) if aggregate == "ring" or modes
                else None)
    prog = build_model_axis_program(
        spec, cfg, jopt, jax.random.PRNGKey(0), CODECS[code][1](), attn_impl=attn_impl,
        num_microbatches=microbatches, compute_dtype=compute_dtype,
        aggregate="gather" if exchange else aggregate, exchange=exchange)
    delayed = isinstance(prog.state, DelayedState)
    train = prog.state.train if delayed else prog.state
    train = train.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          opt_state=jopt.init(params))
    state = shard_state(prog.mesh, train, prog.state_specs)
    if delayed:
        state = DelayedState(train=state, carry=prog.state.carry)
    axes = spec.axes
    ranks = []
    for r in range(n_dev):
        coords, rest = {}, r
        for name, size in reversed(axes):
            coords[name], coords["n_" + name] = rest % size, size
            rest //= size
        ranks.append(coords)
    out, draws = [], [[] for _ in range(n_dev)]
    for s, toks in enumerate(token_batches):
        key = step_key(s + 1)
        for r, coords in enumerate(ranks):
            k_codec = jax.random.fold_in(jax.random.fold_in(key, s), coords["dp"])
            local = _local_shapes(layout, params, coords)
            draws[r].append(codec_draws(code, k_codec, local))
        state, m = prog.step(state, key, prog.shard_tokens(toks))
        out.append({"loss": float(m["loss"]), "msg_bytes": int(m["msg_bytes"]),
                    "dense_bytes": int(m["dense_bytes"]),
                    "skipped": float(m["skipped"]) if delayed else None})
    final = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    return out, final, [d if code != "sgd" else None for d in draws]


def layout_job(layout: str, ways, code: str, aggregate: str, *, params, microbatches: int = 2,
               attn_impl: str = "ring", token_batches=None, steps: int = STEPS,
               bf16: bool = False, **modes) -> dict:
    """The shared arguments of the ``layout`` job for the port's ranks."""
    token_batches = layout_batches(steps) if token_batches is None else token_batches
    return dict(layout=layout, ways=ways, cfg=layout_cfg(layout), params=params,
                codec=CODECS[code][0], aggregate=aggregate, microbatches=microbatches,
                attn_impl=attn_impl, optimizer=("sgd", dict(lr=LR, momentum=MOMENTUM)),
                batches=token_batches, keys=list(range(1, len(token_batches) + 1)),
                bf16=bf16, modes=modes)


def assert_layout_parity(out, final, answers, *, loss_rtol: float, atol: float) -> None:
    """Ranks that hold the same slice (the replicas) hash alike after each
    step; rank 0's loss within ``loss_rtol`` of the reference's, its
    ``msg_bytes`` and ``dense_bytes`` exactly equal; after the last step
    the gathered full tree within ``atol``."""
    for s, want in enumerate(out):
        by_slice: dict = {}
        for a in answers:
            by_slice.setdefault(a["slice"], set()).add(a["steps"][s]["hash"])
        assert all(len(h) == 1 for h in by_slice.values()), f"step {s + 1}: replicas differ"
        got = answers[0]["steps"][s]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
        assert got["msg_bytes"] == want["msg_bytes"], (s, got["msg_bytes"], want["msg_bytes"])
        assert got["dense_bytes"] == want["dense_bytes"]
    got = jax.tree_util.tree_leaves_with_path(answers[0]["full"])
    want = dict((jax.tree_util.keystr(p), v) for p, v in
                jax.tree_util.tree_leaves_with_path(final))
    assert len(got) == len(want)
    for p, a in got:
        np.testing.assert_allclose(a, np.asarray(want[jax.tree_util.keystr(p)]), atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(p))
