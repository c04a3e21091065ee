"""The in-step estimator-quality probes (``--obs-quality``).

Counterpart of ``atomo_tpu/obs/quality.py``. Per layer ``l`` of the
gradient, in the canonical leaf order
(:func:`~atomo_tpu_torch.convert.jax_leaf_order`):

* ``q_err2[l] = ||decode(encode(g_l)) - g_l||^2`` in float32, the squared
  error of this step's own encode; over codec keys its expectation is the
  unbiased estimator's variance;
* ``q_rel[l] = q_err2[l] / max(||g_l||^2, 1e-30)``, the scale-free form
  that makes layers comparable (a zero-gradient layer reads 0, not NaN).

The probe decodes the replica's own payloads with the tree decode (for QSGD
on the card, one launch of ``unpack_dequantize_tree_kernel`` with one
replica), then takes the per-leaf sums in multi-tensor passes
(``torch._foreach_*``), not one reduction a leaf, and reads nothing on the
host: the series are device ``(L,)`` float32 tensors. Off, nothing of it is
built. The static half, the per-layer byte split, is :func:`quality_meta`,
recorded once as a ``meta`` line; it prices each layer with the codec's own
``leaf_payload_bytes`` and encodes nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from atomo_tpu_torch.codecs import decode_tree, leaf_codec

Q_REL_FLOOR = 1e-30


def quality_probe(codec, payloads, grads: Sequence[torch.Tensor],
                  layouts: Optional[Sequence[bool]] = None) -> dict:
    """``{"q_err2": (L,), "q_rel": (L,)}`` of one encode: ``payloads`` is
    the encode of ``grads`` (this replica's own, before any exchange), both
    in the canonical leaf order, ``layouts`` as for
    :func:`~atomo_tpu_torch.codecs.encode_tree`."""
    return quality_from_decoded(decode_tree(codec, payloads, grads, layouts), grads)


def quality_from_decoded(d_leaves: Sequence[torch.Tensor],
                         g_leaves: Sequence[torch.Tensor]) -> dict:
    """The error arithmetic of :func:`quality_probe` over already-decoded
    leaves: shared with the error-feedback decode and with the hybrid
    exchange, whose sparse-assigned leaves decode losslessly and read 0."""
    g = [t.float() for t in g_leaves]
    diff = torch._foreach_sub([t.float() for t in d_leaves], g)
    q_err2 = torch.stack(torch._foreach_norm(diff, 2)).square()
    q_g2 = torch.stack(torch._foreach_norm(g, 2)).square()
    return {"q_err2": q_err2, "q_rel": q_err2 / torch.clamp(q_g2, min=Q_REL_FLOOR)}


def quality_meta(codec, model: torch.nn.Module, stream_bucket_bytes: Optional[int] = None,
                 hybrid=None) -> dict:
    """The per-layer byte split of ``model``'s gradient under ``codec``, as
    the JAX package's ``quality_meta`` records it: each layer's
    ``jax.tree_util.keystr`` name, its JAX-layout shape, its dense bytes and
    its payload bytes, in the order ``q_err2`` indexes. ``hybrid`` (a
    :class:`~atomo_tpu_torch.sparse.HybridPlan`) adds each layer's
    assignment, measured density and, for a sparse-assigned layer, its row
    budget, and prices the layers by the plan; ``stream_bucket_bytes``
    records the ``--stream-encode`` bucket size."""
    from atomo_tpu_torch.convert import jax_leaf_paths
    from atomo_tpu_torch.tuning.probe import leaf_shapes
    from atomo_tpu_torch.utils.comm_model import codec_leaf_payload_bytes

    names, shapes = jax_leaf_paths(model), leaf_shapes(model)
    if hybrid is not None and hybrid.n_leaves != len(names):
        raise ValueError(
            f"hybrid plan covers {hybrid.n_leaves} leaves but the tree "
            f"has {len(names)} — plan and tree must match")
    layers = []
    for i, (name, shape) in enumerate(zip(names, shapes)):
        n = 1
        for d in shape:
            n *= int(d)
        row = {
            "name": name,
            "shape": [int(d) for d in shape],
            "dense_bytes": n * 4,
            "payload_bytes": codec_leaf_payload_bytes(leaf_codec(codec, i), shape),
        }
        if hybrid is not None:
            a = hybrid.assignments[i]
            row["assignment"] = a.kind
            row["density"] = round(float(a.density), 6)
            row["payload_bytes"] = int(a.payload_bytes)
            if a.kind == "sparse":
                row["row_budget"] = int(a.row_budget)
        layers.append(row)
    out = {
        "what": "obs_quality",
        "codec": getattr(codec, "name", str(codec)),
        "n_layers": len(layers),
        "dense_bytes": int(sum(r["dense_bytes"] for r in layers)),
        "payload_bytes": int(sum(r["payload_bytes"] for r in layers)),
        "layers": layers,
    }
    if stream_bucket_bytes is not None:
        out["stream_bucket_bytes"] = int(stream_bucket_bytes)
    return out
