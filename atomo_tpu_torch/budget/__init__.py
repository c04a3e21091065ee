"""Adaptive variance budgets: ATOMO's per-layer allocation of atoms under a
wire budget.

Counterpart of ``atomo_tpu/budget/`` (the same names):

* :mod:`~atomo_tpu_torch.budget.allocator`: per-layer spectra measured from
  a probe gradient and the water-filling solver that spreads a global
  wire-byte budget over the layers to minimise the total estimator
  variance (SVD ranks under ``fixed_k``, QSGD bit widths 1-16);
* :mod:`~atomo_tpu_torch.budget.codec`: :class:`PerLeafCodec`, the wrapper
  that carries the allocation's per-leaf knobs through the tree walkers;
* :mod:`~atomo_tpu_torch.budget.artifact`: ``budget_alloc.json``, written
  atomically and reused on ``--resume``;
* :mod:`~atomo_tpu_torch.budget.retune`: :class:`BudgetRetuner`, the online
  re-solve at checkpoint boundaries from the recorded ``--obs-quality``
  q_err2 series.
"""

from atomo_tpu_torch.budget.allocator import (  # noqa: F401
    Allocation,
    LayerSpectrum,
    allocation_leaf_budgets,
    allocation_payload_bytes,
    measure_spectra,
    predicted_variance,
    solve_allocation,
    spectra_from_qerr2,
    uniform_ks,
)
from atomo_tpu_torch.budget.artifact import (  # noqa: F401
    BUDGET_ALLOC_NAME,
    alloc_path,
    alloc_reusable,
    allocation_meta,
    append_epoch,
    latest_epoch,
    new_alloc_doc,
    read_alloc,
    write_alloc,
)
from atomo_tpu_torch.budget.codec import PerLeafCodec, budgeted_codec  # noqa: F401
from atomo_tpu_torch.budget.retune import BudgetRetuner  # noqa: F401
