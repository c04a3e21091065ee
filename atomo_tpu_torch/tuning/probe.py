"""The byte budget of one gradient exchange, priced from leaf shapes.

Counterpart of ``atomo_tpu/tuning/probe.py:96-136`` (``leaf_byte_budgets``
and ``byte_budget``). The JAX package prices the payloads with
``jax.eval_shape`` over the encode; the port prices each leaf with its
codec's ``leaf_payload_bytes`` (:func:`~atomo_tpu_torch.utils.comm_model.
codec_leaf_payload_bytes`) over the model's leaves in ``jax_leaf_order``,
each in its JAX-layout shape, and encodes nothing. The rest of the JAX
module (the measured probe ladder) is not ported.
"""

from __future__ import annotations

from torch import nn

from atomo_tpu_torch.codecs import leaf_codec
from atomo_tpu_torch.convert import jax_layouts, jax_view
from atomo_tpu_torch.training.trainer import leaf_params
from atomo_tpu_torch.utils.comm_model import codec_leaf_payload_bytes, leaf_budget_totals


def leaf_shapes(model: nn.Module) -> list[tuple[int, ...]]:
    """The model's parameter shapes in the canonical leaf order, each as
    the JAX package lays the leaf out (``convert.jax_view``)."""
    return [tuple(jax_view(p.detach(), tr).shape)
            for p, tr in zip(leaf_params(model), jax_layouts(model))]


def leaf_byte_budgets(codec, model: nn.Module) -> list[tuple[int, int]]:
    """Per-leaf ``(dense_bytes, payload_bytes)`` in the canonical order;
    ``codec=None`` (dense training) reports payload 0 per leaf; a per-leaf
    codec (a budget allocation) prices leaf ``i`` by its own codec."""
    out = []
    for i, (shape, p) in enumerate(zip(leaf_shapes(model), leaf_params(model))):
        pay = 0 if codec is None else codec_leaf_payload_bytes(leaf_codec(codec, i), shape)
        out.append((p.numel() * 4, pay))
    return out


def byte_budget(codec, model: nn.Module) -> tuple[int, int]:
    """(dense_bytes, payload_bytes) of one gradient exchange: the sum of
    :func:`leaf_byte_budgets` through ``comm_model.leaf_budget_totals``."""
    d, p = leaf_budget_totals(leaf_byte_budgets(codec, model))
    return int(d), int(p)
