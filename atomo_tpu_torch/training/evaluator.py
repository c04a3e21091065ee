"""Checkpoint-polling evaluator: the reference's distributed_evaluator.

Counterpart of ``atomo_tpu/training/evaluator.py``. The reference
(src/distributed_evaluator.py:58-133) polls ``--model-dir`` for
``model_step_N`` files every 10 s, loads each new one and prints its test
loss and prec@1/prec@5. Here each file restores only the parameters and
BatchNorm statistics into the model (never the optimizer state, so any
optimizer's checkpoints evaluate), and ``max_polls`` / ``stop_when_idle``
bound the loop without a wall-clock dependency.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from torch import nn

from atomo_tpu_torch.training.checkpoint import list_steps, load_params
from atomo_tpu_torch.training.trainer import evaluate
from atomo_tpu_torch.utils.device import resolve_device


class CheckpointEvaluator:
    """Evaluates every new checkpoint of ``model_dir`` on ``test_iter`` with
    ``model`` (built for the checkpoints' network), on CUDA unless
    ``device='cpu'``."""

    def __init__(self, model: nn.Module, test_iter, model_dir: str, *,
                 poll_interval: float = 10.0, log_fn: Callable[[str], None] = print,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.test_iter = test_iter
        self.model_dir = model_dir
        self.poll_interval = poll_interval
        self.log_fn = log_fn
        self._seen: set[int] = set()

    def evaluate_step(self, step: int) -> dict[str, float]:
        load_params(self.model_dir, self.model, step)
        metrics = evaluate(self.model, self.test_iter, self.device)
        # the reference's line (distributed_evaluator.py:105-109)
        self.log_fn("Evaluator: Step: {}, Loss: {:.4f}, Prec@1: {:.4f}, Prec@5: {:.4f}".format(
            step, metrics["loss"], metrics["prec1"], metrics["prec5"]))
        return metrics

    def poll_once(self) -> list[int]:
        """Evaluate every checkpoint not seen yet; returns their steps."""
        new = [s for s in list_steps(self.model_dir) if s not in self._seen]
        for s in new:
            self.evaluate_step(s)
            self._seen.add(s)
        return new

    def run(self, max_polls: Optional[int] = None, stop_when_idle: bool = False) -> None:
        """The reference's poll loop (distributed_evaluator.py:74-88)."""
        polls = 0
        while max_polls is None or polls < max_polls:
            new = self.poll_once()
            polls += 1
            if not new:
                if stop_when_idle:
                    return
                time.sleep(self.poll_interval)
