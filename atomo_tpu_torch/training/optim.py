"""Momentum SGD and the reference LR schedule, as small functions on tensors.

Counterpart of ``atomo_tpu/training/optim.py`` (the optax chain
``add_decayed_weights -> sgd(momentum, nesterov)``), written out rather than
built from ``torch.optim.SGD``: the update consumes externally supplied
(decoded) gradients, and the schedule is read at the pre-increment step count
exactly as optax reads it. Per leaf, with g the decoded gradient:

    g     = g + wd * p                  (weight decay, when set)
    trace = g + m * trace               (momentum, when set; trace starts at 0)
    u     = g + m * trace if nesterov else trace
    p     = p + (-lr(count)) * u        then count += 1

The learning rate is the float32 value optax computes, and the product
``(-lr) * u`` is formed before the add, as optax does: ``p.add_(u, alpha=-lr)``
may fuse into one FMA and round differently.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def stepwise_shrink(
    base_lr: float, shrinkage: float = 0.95, freq: int = 50
) -> Callable[[int], float]:
    """lr(step) = base * shrinkage ** (step // freq), in float32."""

    def schedule(step: int) -> float:
        k = np.float32(step // freq)
        return float(np.float32(base_lr) * np.power(np.float32(shrinkage), k))

    return schedule


@dataclasses.dataclass
class SgdState:
    count: int
    trace: Optional[list[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Sgd:
    schedule: Callable[[int], float]
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init(self, params: Sequence[torch.Tensor]) -> SgdState:
        trace = [torch.zeros_like(p) for p in params] if self.momentum else None
        return SgdState(count=0, trace=trace)

    @torch.no_grad()
    def update(
        self,
        grads: Sequence[torch.Tensor],
        state: SgdState,
        params: Sequence[torch.Tensor],
    ) -> SgdState:
        """Apply one step to ``params`` in place; returns the new state (the
        momentum buffers are updated in place too)."""
        neg_lr = -self.schedule(state.count)
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.weight_decay:
                g = g + self.weight_decay * p
            if state.trace is not None:
                t = state.trace[i]
                t.copy_(g + self.momentum * t)
                g = g + self.momentum * t if self.nesterov else t
            p.add_(g * neg_lr)
        return SgdState(count=state.count + 1, trace=state.trace)


def make_optimizer(
    name: str = "sgd",
    *,
    lr: float = 0.01,
    lr_shrinkage: float = 0.95,
    shrinkage_freq: int = 50,
    momentum: float = 0.0,
    nesterov: bool = False,
    weight_decay: float = 0.0,
) -> Sgd:
    """The optimizer of ``atomo_tpu.training.make_optimizer`` (sgd only for
    now; adam comes with a later slice)."""
    if name.lower() != "sgd":
        raise ValueError(f"optimizer {name!r} is not ported yet; expected sgd")
    return Sgd(
        schedule=stepwise_shrink(lr, lr_shrinkage, shrinkage_freq),
        momentum=momentum, nesterov=nesterov, weight_decay=weight_decay,
    )
