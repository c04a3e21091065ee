"""SGD, Adam and the reference LR schedule, as small functions on tensors.

Counterpart of ``atomo_tpu/training/optim.py`` (the optax chains
``add_decayed_weights -> sgd(momentum, nesterov)`` and
``add_decayed_weights -> adam | amsgrad``), written out rather than built
from ``torch.optim``: the update consumes externally supplied (decoded)
gradients, the schedule is read at the pre-increment step count exactly as
optax reads it, and ``torch.optim.Adam(amsgrad=True)`` keeps the running
maximum of the raw second moment where optax keeps that of the
bias-corrected one. Per leaf, with g the decoded gradient:

    g     = g + wd * p                  (weight decay, when set)
  sgd:
    trace = g + m * trace               (momentum, when set; trace starts at 0)
    u     = g + m * trace if nesterov else trace
  adam (optax scale_by_adam / scale_by_amsgrad, eps_root 0):
    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * g * g + b2 * nu
    nu_hat = nu / (1 - b2 ** (count + 1)), mu_hat likewise with b1
    v     = max(nu_max, nu_hat) -> nu_max if amsgrad else nu_hat
    u     = mu_hat / (sqrt(v) + eps)
  both:
    p     = p + (-lr(count)) * u        then count += 1

The learning rate is the float32 value optax computes, and the product
``(-lr) * u`` is formed before the add, as optax does: ``p.add_(u, alpha=-lr)``
may fuse into one FMA and round differently.

The step's host values (``-lr(count)``, Adam's bias corrections) have a
device form for a CUDA graph, which replays one captured update with the
arguments it captured: :meth:`Sgd.step_scalars` / :meth:`Adam.step_scalars`
give them as float32 values for a device tensor written before each replay,
and ``update(..., scalars=)`` reads them from it. The products are the
same: ``g * neg_lr`` with a 0-d float32 tensor rounds as with the float32
Python scalar, and Adam's divisions by a bias correction become products
with its float32 reciprocal, which is what CUDA computes for a division by a
Python scalar (so the device form equals the host form on the card, not on
the CPU, where a scalar divisor divides).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

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

    def step_scalars(self, count: int) -> list[float]:
        """The device form's values at optimizer step ``count``: [-lr]."""
        return [-self.schedule(count)]

    @torch.no_grad()
    def update(
        self,
        grads: Sequence[torch.Tensor],
        state: SgdState,
        params: Sequence[torch.Tensor],
        scalars: Optional[torch.Tensor] = None,
    ) -> SgdState:
        """Apply one step to ``params`` in place; returns the new state (the
        momentum buffers are updated in place too). ``scalars`` (float32,
        :meth:`step_scalars`'s values on the device) replaces the host's."""
        neg_lr = -self.schedule(state.count) if scalars is None else scalars[0]
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.weight_decay:
                g = g + self.weight_decay * p
            if state.trace is not None:
                t = state.trace[i]
                t.copy_(g + self.momentum * t)
                g = g + self.momentum * t if self.nesterov else t
            p.add_(g * neg_lr)
        return SgdState(count=state.count + 1, trace=state.trace)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


@dataclasses.dataclass
class AdamState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    nu_max: Optional[list[torch.Tensor]]  # amsgrad only


@dataclasses.dataclass(frozen=True)
class Adam:
    schedule: Callable[[int], float]
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    amsgrad: bool = False
    weight_decay: float = 0.0

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        def zeros():
            return [torch.zeros_like(p) for p in params]

        return AdamState(count=0, mu=zeros(), nu=zeros(),
                         nu_max=zeros() if self.amsgrad else None)

    def step_scalars(self, count: int) -> list[float]:
        """The device form's values at optimizer step ``count``: [-lr,
        1 / bc1, 1 / bc2], the reciprocals in float32."""
        inv = [float(np.float32(1.0) / np.float32(_bias_correction(b, count + 1)))
               for b in (self.beta1, self.beta2)]
        return [-self.schedule(count)] + inv

    @torch.no_grad()
    def update(
        self,
        grads: Sequence[torch.Tensor],
        state: AdamState,
        params: Sequence[torch.Tensor],
        scalars: Optional[torch.Tensor] = None,
    ) -> AdamState:
        """Apply one step to ``params`` in place; returns the new state (the
        moment buffers are updated in place too). ``scalars`` (float32,
        :meth:`step_scalars`'s values on the device) replaces the host's."""
        b1, b2 = self.beta1, self.beta2
        if scalars is None:
            neg_lr = -self.schedule(state.count)
            bc1 = _bias_correction(b1, state.count + 1)
            bc2 = _bias_correction(b2, state.count + 1)

            def corrected(t, bc):
                return t / bc
        else:
            neg_lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]

            def corrected(t, inv_bc):
                return t * inv_bc
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu, nu = state.mu[i], state.nu[i]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            v = corrected(nu, bc2)
            if state.nu_max is not None:
                v = torch.maximum(state.nu_max[i], v, out=state.nu_max[i])
            p.add_(corrected(mu, bc1) / (torch.sqrt(v) + self.eps) * neg_lr)
        return AdamState(count=state.count + 1, mu=state.mu, nu=state.nu,
                         nu_max=state.nu_max)


Optimizer = Union[Sgd, Adam]
OptState = Union[SgdState, AdamState]


def make_optimizer(
    name: str = "sgd",
    *,
    lr: float = 0.01,
    lr_shrinkage: float = 0.95,
    shrinkage_freq: int = 50,
    momentum: float = 0.0,
    nesterov: bool = False,
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    amsgrad: bool = False,
) -> Optimizer:
    """The optimizer of ``atomo_tpu.training.make_optimizer``: ``sgd``
    (momentum, nesterov) or ``adam`` (``amsgrad``), each after weight decay
    when it is set, on the stepwise-shrink schedule."""
    schedule = stepwise_shrink(lr, lr_shrinkage, shrinkage_freq)
    name = name.lower()
    if name == "sgd":
        return Sgd(schedule=schedule, momentum=momentum, nesterov=nesterov,
                   weight_decay=weight_decay)
    if name == "adam":
        return Adam(schedule=schedule, beta1=beta1, beta2=beta2, eps=eps, amsgrad=amsgrad,
                    weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}; expected sgd|adam")
