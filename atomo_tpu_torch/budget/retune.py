"""Checkpoint-boundary budget re-allocation (the online re-solve).

Counterpart of ``atomo_tpu/budget/retune.py``. A gradient spectrum drifts
over training (early spectra are spiky, late ones noise-flat), so the
startup allocation goes stale. The retuner closes the loop the JAX package's
way: observe online, act only at checkpoint boundaries, record every
decision as an incident.

The online signal is the ``--obs-quality`` q_err2 series the flight
recorder already lands in ``metrics.jsonl``: under the stated fixed_k law
``E q_err2_l = A_l / k_l`` (QSGD: ``B_l / (2^b - 1)^2``) the window mean at
the current knob is a fresh per-layer numerator with no extra device work
(:func:`~atomo_tpu_torch.budget.allocator.spectra_from_qerr2`). At each
checkpoint boundary the data-parallel loop's retune hook calls
:meth:`BudgetRetuner.maybe_realloc`; the solver re-runs at the same byte
budget, and an allocation that changed past the hysteresis (a knob moved
AND the predicted variance improves by ``min_gain``) lands as:

* a new epoch appended to ``budget_alloc.json`` (atomic rewrite, the
  resume source of truth),
* a ``budget_realloc`` incident quoting the old and new per-layer splits
  and the predicted variance both ways (both allocations priced under the
  fresh spectra),
* a ``budget_alloc_epochN`` meta line and the ``budget_epoch`` context
  column in ``metrics.jsonl``,
* a rebuilt step from the loop (the payload sizes changed: the packed
  buffers, the gather's receive buffer and a CUDA graph's static buffers
  are built anew, never reused), snapped to the checkpoint, so kill,
  restart and resume replay the run bit for bit from the recorded epoch.

Every rank of the group runs the re-solve on the same recorded series (rank
0 wrote it before the save's barrier) and so decides alike; only the
``owner`` (rank 0) writes the artifact, the incident and the recorder's
lines. Armed only when the series lands on disk (``--obs-quality`` and
``--obs-record``): a retuner without its signal would be guessing.
"""

from __future__ import annotations

import math
from typing import Optional

from atomo_tpu_torch.budget.allocator import (
    predicted_variance,
    solve_allocation,
    spectra_from_qerr2,
)
from atomo_tpu_torch.budget.artifact import (
    allocation_meta,
    append_epoch,
    write_alloc,
)
from atomo_tpu_torch.budget.codec import budgeted_codec


class BudgetRetuner:
    """Fold the recorded q_err2 stream; re-solve at checkpoint
    boundaries; re-allocate out loud (module docstring)."""

    def __init__(
        self,
        *,
        train_dir: str,
        base_codec,
        spectra,
        alloc,
        doc: dict,
        min_samples: int = 8,
        min_gain: float = 0.02,
        incidents=None,
        recorder=None,
        log_fn=print,
        owner: bool = True,
    ):
        self.train_dir = train_dir
        self.base_codec = base_codec
        self.spectra = list(spectra)
        self.alloc = alloc
        self.doc = doc
        self.min_samples = int(min_samples)
        self.min_gain = float(min_gain)
        self.incidents = incidents
        self.recorder = recorder
        self.log_fn = log_fn
        self.owner = bool(owner)
        self.last_boundary = int(
            (doc.get("epochs") or [{}])[-1].get("start_step", 0)
        )
        self.reallocs = 0

    @property
    def epoch(self) -> int:
        return int(self.alloc.epoch)

    def bind(self, incidents=None, recorder=None, log_fn=None):
        """Late-bind the loop-owned incident log / recorder / logger
        (the OnlineRetuner.bind precedent)."""
        if incidents is not None:
            self.incidents = incidents
        if recorder is not None:
            self.recorder = recorder
        if log_fn is not None:
            self.log_fn = log_fn
        return self

    def _window_qerr2(self, step: int) -> Optional[list]:
        """Per-layer mean of the recorded q_err2 series over steps in
        (last_boundary, step]; None when fewer than ``min_samples``
        usable records landed (a gap is not a sample)."""
        from atomo_tpu_torch.obs.recorder import FlightRecorder, metrics_path

        recs = [
            r
            for r in FlightRecorder.read_steps(
                metrics_path(self.train_dir)
            )
            if self.last_boundary < int(r.get("step", -1)) <= step
            and isinstance(r.get("q_err2"), list)
        ]
        if len(recs) < self.min_samples:
            return None
        n = len(self.spectra)
        sums = [0.0] * n
        counts = [0] * n
        for r in recs:
            q = r["q_err2"]
            for i in range(min(n, len(q))):
                v = q[i]
                if isinstance(v, (int, float)) and math.isfinite(float(v)):
                    sums[i] += float(v)
                    counts[i] += 1
        return [
            (sums[i] / counts[i]) if counts[i] else None for i in range(n)
        ]

    def maybe_realloc(self, step: int):
        """Execute the boundary re-solve. Returns the new wrapped codec
        when the allocation changed (the loop rebuilds the step from
        it), else None. Every outcome past the sample gate is one
        incident record — switch or keep."""
        qmeans = self._window_qerr2(step)
        if qmeans is None:
            return None  # not enough recorded signal yet: not a decision
        fresh = spectra_from_qerr2(
            self.spectra, qmeans, self.alloc.ks, codec=self.base_codec
        )
        new = solve_allocation(
            self.base_codec, fresh,
            budget_bytes=self.alloc.budget_bytes,
            mode="variance", epoch=self.alloc.epoch + 1,
        )
        # predicted variance BOTH WAYS under the SAME fresh spectra: the
        # old split re-priced vs the new split
        var_old = predicted_variance(fresh, self.alloc.ks, self.base_codec)
        var_new = float(new.predicted_variance)
        changed = tuple(new.ks) != tuple(self.alloc.ks)
        improved = (
            var_old > 0
            and (var_old - var_new) / var_old >= self.min_gain
        )
        self.last_boundary = int(step)
        if not (changed and improved):
            if self.incidents is not None and self.owner:
                self.incidents.append(
                    "budget_realloc",
                    action="keep",
                    step=step,
                    epoch=self.epoch,
                    predicted_variance_old=round(var_old, 8),
                    predicted_variance_new=round(var_new, 8),
                    reason=(
                        "allocation unchanged" if not changed else
                        f"gain {(var_old - var_new) / max(var_old, 1e-30):.3%}"
                        f" below the {self.min_gain:.0%} hysteresis"
                    ),
                )
            self.log_fn(
                f"Budget: boundary re-solve at step {step} keeps "
                f"allocation epoch {self.epoch} (predicted variance "
                f"{var_old:.4g} -> {var_new:.4g} under fresh spectra)"
            )
            return None
        old_ks = list(self.alloc.ks)
        self.spectra = fresh
        self.alloc = new
        self.doc = append_epoch(
            self.doc, self.base_codec, fresh, new, start_step=step
        )
        if self.owner:
            write_alloc(self.train_dir, self.doc)
        self.reallocs += 1
        moved = [
            {
                "name": self.spectra[i].name,
                "k_old": int(old_ks[i]),
                "k_new": int(new.ks[i]),
            }
            for i in range(len(old_ks))
            if old_ks[i] != new.ks[i]
        ]
        if self.incidents is not None and self.owner:
            self.incidents.append(
                "budget_realloc",
                action=f"realloc->epoch{new.epoch}",
                step=step,
                epoch=new.epoch,
                budget_bytes=int(new.budget_bytes),
                payload_bytes=int(new.payload_bytes),
                predicted_variance_old=round(var_old, 8),
                predicted_variance_new=round(var_new, 8),
                ks_old=[int(k) for k in old_ks],
                ks_new=[int(k) for k in new.ks],
                moved=moved,
            )
        if self.recorder is not None and self.owner:
            ep_rec = (self.doc.get("epochs") or [])[-1]
            self.recorder.write_meta(allocation_meta(ep_rec))
            self.recorder.set_context(budget_epoch=new.epoch)
        self.log_fn(
            f"Budget: spectrum drift re-allocation at step {step}: "
            f"epoch {new.epoch - 1} -> {new.epoch}, "
            f"{len(moved)} layer(s) moved, predicted variance "
            f"{var_old:.4g} -> {var_new:.4g} at "
            f"{new.payload_bytes / 1e6:.4f} MB wire (budget "
            f"{new.budget_bytes / 1e6:.4f} MB); program rebuilt at this "
            "checkpoint boundary"
        )
        return budgeted_codec(self.base_codec, new.ks)
