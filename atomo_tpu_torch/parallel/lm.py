"""LM training with the compressed data-parallel update, on one device.

Counterpart of the one-device part of ``atomo_tpu/parallel/lm.py``: the
dp x sp step of ``make_lm_train_step`` at dp = sp = 1, which is what the JAX
package runs for ``lm --layout dp`` and ``lm --layout dp-sp --ways 1`` on one
chip. Each step:

* forward and backward of :class:`~atomo_tpu_torch.models.transformer.
  TransformerLM` with the chosen sequence-parallel attention
  (``ATTENTION_IMPLS``) at an axis of size one: ``ulysses-flash`` runs the
  flash kernel, four launches a step at depth 4;
* the loss of ``sp_boundary_targets_and_mask`` at sp = 1: targets
  ``tokens[:, 1:]`` plus the wrapped first token, the last column masked;
* ``compressed_dp_update`` on a dp axis of one replica: encode, "gather" the
  one payload and take its mean decode (``gather``), or decode and average
  densely (``psum``), then momentum SGD.

The codec key is ``fold_in(fold_in(key, step), dp_index=0)`` as in
``lm.py:612-614`` (not the image trainer's three-way split). Phases are
``record_function`` ranges: ``step.forward_backward``, ``step.encode``,
``step.decode_mean``, ``step.update``. A dp or sp axis above one raises: the
exchange comes with the multi-GPU slice.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from atomo_tpu_torch.codecs import decode_mean_tree, decode_tree, encode_tree, tree_nbytes
from atomo_tpu_torch.convert import jax_layouts
from atomo_tpu_torch.models.transformer import TransformerLM
from atomo_tpu_torch.parallel.ring import ATTENTION_IMPLS
from atomo_tpu_torch.training.optim import Sgd
from atomo_tpu_torch.training.trainer import TrainState, create_state, leaf_params
from atomo_tpu_torch.utils.rng import fold_in

AGGREGATES = ("gather", "psum")


def _one_replica(n_dp: int) -> None:
    if n_dp != 1:
        raise ValueError(
            f"dp axis of {n_dp} replicas: the gradient exchange comes with the "
            "multi-GPU slice"
        )


def create_lm_state(lm_config: dict, optimizer: Sgd, seed: int, device) -> TrainState:
    """A fresh :class:`TransformerLM` (``lm_config`` are its kwargs) with
    Flax's initialisers drawn from ``seed``, on ``device``."""
    return create_state(TransformerLM(**lm_config), optimizer, seed, device)


def sp_boundary_targets_and_mask(tokens: torch.Tensor, n_sp: int = 1):
    """Next-token targets and the valid mask of a sequence shard, at sp = 1:
    the shard's last target is the first token of the next shard, which on
    one shard is its own first token, and that global final position is
    masked out. Returns (targets, valid), both (B, S)."""
    if n_sp != 1:
        raise ValueError("sequence parallelism comes with the multi-GPU slice")
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = torch.ones(targets.shape, device=tokens.device)
    valid[:, -1] = 0.0
    return targets, valid


def compressed_dp_update(
    optimizer: Sgd,
    codec,
    state: TrainState,
    k_codec: int,
    grads: Sequence[torch.Tensor],
    loss: torch.Tensor,
    *,
    params: Sequence[torch.Tensor],
    layouts: Optional[Sequence[bool]] = None,
    n_dp: int = 1,
    aggregate: str = "gather",
    draws: Optional[Sequence[Any]] = None,
):
    """The tail of a compressed-DP step on a dp axis of ``n_dp`` (one)
    replicas: encode, exchange, mean decode, update ``params`` in place.
    ``codec=None`` is the dense mean. Returns (new state, metrics);
    ``msg_bytes`` counts what the wire carries (dense bytes for ``psum``)."""
    _one_replica(n_dp)
    if aggregate not in AGGREGATES:
        raise ValueError(f"unknown aggregate mode {aggregate!r}; expected one of {AGGREGATES}")
    dense_bytes = tree_nbytes(grads)
    msg_bytes = dense_bytes
    if codec is not None:
        with record_function("step.encode"):
            payloads, stats = encode_tree(codec, k_codec, grads, draws, layouts)
        with record_function("step.decode_mean"):
            if aggregate == "gather":
                # the all_gather of one replica's payloads: a leading axis of 1
                gathered = [type(p)(*(a[None] for a in p)) for p in payloads]
                grads = decode_mean_tree(codec, gathered, grads, n_dp, layouts)
                msg_bytes = stats.payload_bytes
            else:  # psum: the dense mean of one replica's decode is the decode
                grads = decode_tree(codec, payloads, grads, layouts)
    with record_function("step.update"):
        opt_state = optimizer.update(grads, state.opt_state, params)
    metrics = {"loss": loss.detach(), "msg_bytes": msg_bytes, "dense_bytes": dense_bytes}
    return TrainState(step=state.step + 1, model=state.model, opt_state=opt_state), metrics


def make_lm_train_step(
    model: TransformerLM,
    optimizer: Sgd,
    codec=None,
    *,
    attn_impl: str = "ring",
    aggregate: str = "gather",
):
    """Build ``step(state, key, tokens, draws=None) -> (state, metrics)``
    over ``model`` (which ``state.model`` must be). ``tokens`` is an int64
    (B, S) batch on the model's device; ``draws`` (one entry per leaf,
    canonical order) is the codec's parity hook. ``metrics`` holds the loss
    as a 0-d tensor (no host sync) and ``msg_bytes``/``dense_bytes`` as ints."""
    if attn_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attn_impl {attn_impl!r}; expected one of {sorted(ATTENTION_IMPLS)}"
        )
    attention = partial(ATTENTION_IMPLS[attn_impl], axis_name="sp", axis_size=1, causal=True)
    params = leaf_params(model)
    layouts = jax_layouts(model)

    def step(state: TrainState, key: int, tokens: torch.Tensor,
             draws: Optional[Sequence[Any]] = None):
        k_codec = fold_in(fold_in(key, state.step), 0)  # dp index 0
        model.train()
        for p in params:
            p.grad = None
        with record_function("step.forward_backward"):
            logits = model(tokens, attention_fn=attention)
            targets, valid = sp_boundary_targets_and_mask(tokens)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                                 reduction="none").view(valid.shape)
            loss = (ce * valid).sum() / valid.sum()
            loss.backward()
        return compressed_dp_update(
            optimizer, codec, state, k_codec, [p.grad for p in params], loss,
            params=params, layouts=layouts, aggregate=aggregate, draws=draws,
        )

    return step
