"""Metrics, per-step records and the reference's log lines.

Counterpart of ``atomo_tpu/utils/metrics.py``: the worker line is byte for
byte the JAX package's (and the reference's, which its tuning parser reads).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Sequence

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk: Sequence[int] = (1, 5)):
    """prec@k percentages as 0-d tensors (no host sync)."""
    k_max = min(max(topk), logits.shape[-1])
    pred = logits.topk(k_max, dim=-1).indices
    correct = pred == labels[:, None]
    out = []
    for k in topk:
        k_eff = min(k, logits.shape[-1])
        out.append(correct[:, :k_eff].any(dim=1).float().mean() * 100.0)
    return out


@dataclasses.dataclass
class StepMetrics:
    """One training step's record (the reference log line, structured)."""

    rank: int = 0
    step: int = 0
    epoch: int = 0
    samples_seen: int = 0
    dataset_size: int = 0
    loss: float = 0.0
    time_cost: float = 0.0
    comp_dur: float = 0.0
    encode_dur: float = 0.0
    comm_dur: float = 0.0
    msg_bytes: int = 0
    prec1: float = 0.0
    prec5: float = 0.0

    def worker_line(self) -> str:
        pct = 100.0 * self.samples_seen / max(self.dataset_size, 1)
        return (
            "Worker: {}, Step: {}, Epoch: {} [{}/{} ({:.0f}%)], Loss: {:.4f}, "
            "Time Cost: {:.4f}, Comp: {:.4f}, Encode: {: .4f}, Comm: {: .4f}, "
            "Msg(MB): {: .4f}, Prec@1: {: .4f}, Prec@5: {: .4f}".format(
                self.rank,
                self.step,
                self.epoch,
                self.samples_seen,
                self.dataset_size,
                pct,
                self.loss,
                self.time_cost,
                self.comp_dur,
                self.encode_dur,
                self.comm_dur,
                self.msg_bytes / (1024.0**2),
                self.prec1,
                self.prec5,
            )
        )

    def json_line(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def master_line(step: int, decode_dur: float, lr: float, gather_dur: float) -> str:
    """Reference master print format (sync_replicas_master_nn.py:221)."""
    return "Master: Step: {}, Decode Cost: {}, Cur lr {}, Gather: {}".format(
        step, decode_dur, lr, gather_dur
    )


class Timer:
    """Wall-clock span timer. Spans of CUDA work are only meaningful when
    the caller has synchronised (reading a loss as a float does)."""

    def __init__(self):
        self.t0 = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self.t0
        self.t0 = now
        return dt
