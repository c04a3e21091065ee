"""Flax's ``nn.Dropout`` and the step's dropout stream.

:class:`Dropout` repeats Flax's arithmetic: in training each value is kept
with probability ``1 - rate`` and a kept value is divided by ``1 - rate``
(``where(keep, x / keep_prob, 0)``); in eval mode, or at rate 0, the input
passes through. Its keep-mask comes from the stream that
:func:`dropout_stream` opens around a forward pass:

* a key (:mod:`atomo_tpu_torch.utils.rng`): one generator seeded from it,
  made on the input's device at the first draw, drives every ``Dropout`` of
  the pass in call order, as the JAX train step's ``k_drop`` drives Flax's;
* or ``masks``: one boolean keep-mask per ``Dropout`` call, in call order,
  used as given. Threefry cannot be reproduced in torch, so this is the
  hook through which a parity test hands the port the masks Flax drew.

With no stream open, a training-mode ``Dropout`` draws from torch's global
generator, as ``torch.nn.Dropout`` does. :func:`record_dropout_calls` lists
the calls of the passes run inside it (which stream, shape, keep
probability), so that a CUDA graph's masks can be drawn outside it in the
order the eager step draws them.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn

from atomo_tpu_torch.utils.rng import generator


class _Stream:
    def __init__(self, key: Optional[int], masks: Optional[Sequence[torch.Tensor]]):
        self.key = key
        self.masks = None if masks is None else list(masks)
        self.gen: Optional[torch.Generator] = None
        self.calls = 0
        self.index = None  # its place among the streams a recording saw
        if _RECORDING:
            rec = _RECORDING[-1]
            self.index = rec["streams"]
            rec["streams"] += 1

    def keep(self, x: torch.Tensor, keep_prob: float) -> torch.Tensor:
        i = self.calls
        self.calls += 1
        if _RECORDING:
            _RECORDING[-1]["calls"].append((self.index, tuple(x.shape), keep_prob))
        if self.masks is not None:
            if i >= len(self.masks):
                raise ValueError(f"dropout call {i + 1} but only {len(self.masks)} masks given")
            mask = self.masks[i].to(device=x.device, dtype=torch.bool)
            if tuple(mask.shape) != tuple(x.shape):
                raise ValueError(f"dropout mask {i} has shape {tuple(mask.shape)}, the "
                                 f"input {tuple(x.shape)}")
            return mask
        if self.gen is None:
            self.gen = generator(self.key, x.device)
        return torch.rand(x.shape, generator=self.gen, device=x.device) < keep_prob


_ACTIVE: list[_Stream] = []
_RECORDING: list[dict] = []


@contextlib.contextmanager
def record_dropout_calls():
    """Yield a list that fills with ``(stream index, shape, keep_prob)`` for
    every stream-driven ``Dropout`` call inside, the streams numbered in the
    order they open."""
    rec = {"streams": 0, "calls": []}
    _RECORDING.append(rec)
    try:
        yield rec["calls"]
    finally:
        _RECORDING.pop()


@contextlib.contextmanager
def dropout_stream(key: Optional[int] = None,
                   masks: Optional[Sequence[torch.Tensor]] = None):
    """Drive every training-mode :class:`Dropout` called inside from
    ``key`` or, when given, from ``masks`` (one keep-mask per call, in call
    order). Yields the stream; its ``calls`` counts the draws taken."""
    stream = _Stream(key, masks)
    _ACTIVE.append(stream)
    try:
        yield stream
    finally:
        _ACTIVE.pop()
    if stream.masks is not None and stream.calls not in (0, len(stream.masks)):
        raise ValueError(f"{len(stream.masks)} dropout masks given, {stream.calls} used")


class Dropout(nn.Module):
    """Flax ``nn.Dropout(rate)`` (no broadcast dims)."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if _ACTIVE:
            keep = _ACTIVE[-1].keep(x, keep_prob)
        else:
            keep = torch.rand(x.shape, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
