"""Sparsity indicators: which atomic basis sparsifies a gradient better.

Counterpart of ``atomo_tpu/codecs/indicators.py`` (the reference's
``src/codings/utils.py:3-8``): the nuclear indicator ``sum(s) * sqrt(m + n)``
and the L1 indicator ``||x||_1 * sqrt(numel)``; the basis with the smaller
one yields lower variance at equal budget.
"""

from __future__ import annotations

import math

import torch

from atomo_tpu_torch.codecs.svd import resize_to_2d


def nuclear_indicator(mat: torch.Tensor) -> torch.Tensor:
    """Sum of singular values * sqrt(m + n)."""
    m, n = mat.shape
    return torch.linalg.svdvals(mat).sum() * math.sqrt(m + n)


def l1_indicator(x: torch.Tensor) -> torch.Tensor:
    """L1 norm * sqrt(numel)."""
    return x.abs().sum() * math.sqrt(x.numel())


def spectral_atoms_preferred(
    grad: torch.Tensor, policy: str = "square", max_min_dim: int = 512
) -> torch.Tensor:
    """True when the SVD basis beats the entry-wise basis for this gradient;
    both indicators are taken on the same matricized (padded) matrix."""
    mat, _, _ = resize_to_2d(grad, policy=policy, max_min_dim=max_min_dim)
    return nuclear_indicator(mat) < l1_indicator(mat)
