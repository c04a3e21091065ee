"""Sparse gradient exchange: lossless row codec and per-layer hybrid plans.

Counterpart of ``atomo_tpu/sparse/``. The workload is the embedding tower
(``models/embedding.py``) over zipf row ids (``data/zipf.py``); the codec
(:mod:`~atomo_tpu_torch.sparse.rowcodec`) moves (row-index, row-value) pairs
with a static budget, losslessly; the plan (:mod:`~atomo_tpu_torch.sparse.hybrid`)
assigns each leaf sparse rows or the codec's dense path, and
``make_distributed_train_step(hybrid=...)`` runs it.
"""

from atomo_tpu_torch.sparse.hybrid import (  # noqa: F401
    HybridPlan,
    LeafAssignment,
    LeafSpec,
    infer_row_bounds,
    leaf_specs,
    measured_densities,
    plan_for_model,
    plan_hybrid,
    probe_gradient,
)
from atomo_tpu_torch.sparse.rowcodec import (  # noqa: F401
    RowCodec,
    RowPayload,
    row_payload_bytes,
)
