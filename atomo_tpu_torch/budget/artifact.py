"""budget_alloc.json: the allocation as a run artifact.

Counterpart of ``atomo_tpu/budget/artifact.py``; the document's keys and
values are the JAX package's for the same run. A frozen allocation is the
same on every rank because it is fixed before the first step; a resume
rebuilds the wrapped codec from the recorded epoch instead of measuring the
spectra again, so kill, restart and resume replay the run bit for bit. A
document recorded for another codec or leaf count is refused, and the run
re-allocates. Written atomically (temporary file and ``os.replace``).

Document shape::

    {"kind": "budget_alloc", "complete": true,
     "codec": "svd", "sample": "fixed_k", "alloc": "variance",
     "budget_bytes": B, "n_leaves": L,
     "epochs": [{"epoch": 0, "start_step": 0, "mode": "variance",
                 "ks": [...], "payload_bytes": P, "budget_bytes": B,
                 "predicted_variance": V,
                 "layers": [{"name", "k", "adaptive", "dense_bytes",
                             "payload_bytes"}, ...]}, ...]}
"""

from __future__ import annotations

import json
import os
from typing import Optional

from atomo_tpu_torch.budget.allocator import Allocation, allocation_leaf_budgets
from atomo_tpu_torch.utils.tracing import write_json_atomic

BUDGET_ALLOC_NAME = "budget_alloc.json"


def alloc_path(train_dir: str) -> str:
    return os.path.join(train_dir, BUDGET_ALLOC_NAME)


def _epoch_record(codec, spectra, alloc: Allocation, start_step: int) -> dict:
    pairs = allocation_leaf_budgets(codec, spectra, alloc.ks)
    return {
        "epoch": int(alloc.epoch),
        "start_step": int(start_step),
        "mode": alloc.mode,
        "ks": [int(k) for k in alloc.ks],
        "payload_bytes": int(alloc.payload_bytes),
        "budget_bytes": int(alloc.budget_bytes),
        "predicted_variance": float(alloc.predicted_variance),
        "layers": [
            {
                "name": l.name,
                "k": int(alloc.ks[l.index]),
                "adaptive": bool(l.adaptive),
                "dense_bytes": int(l.dense_bytes),
                "payload_bytes": int(pairs[l.index][1]),
            }
            for l in spectra
        ],
    }


def new_alloc_doc(codec, spectra, alloc: Allocation) -> dict:
    base = getattr(codec, "base", codec)
    return {
        "kind": "budget_alloc",
        "complete": True,
        "codec": getattr(base, "name", str(base)),
        "sample": getattr(base, "sample", None),
        "alloc": alloc.mode,
        "budget_bytes": int(alloc.budget_bytes),
        "n_leaves": len(spectra),
        "epochs": [_epoch_record(codec, spectra, alloc, 0)],
    }


def append_epoch(doc: dict, codec, spectra, alloc: Allocation, start_step: int) -> dict:
    doc = dict(doc)
    doc["epochs"] = list(doc.get("epochs", [])) + [
        _epoch_record(codec, spectra, alloc, start_step)]
    return doc


def write_alloc(train_dir: str, doc: dict) -> str:
    path = alloc_path(train_dir)
    write_json_atomic(path, doc)
    return path


def read_alloc(train_dir: Optional[str]) -> Optional[dict]:
    """The parsed budget_alloc.json, or None when it is missing or
    unparseable (the caller re-allocates and says so)."""
    if not train_dir:
        return None
    try:
        with open(alloc_path(train_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def latest_epoch(doc: Optional[dict]) -> Optional[dict]:
    if not doc:
        return None
    epochs = doc.get("epochs") or []
    return epochs[-1] if epochs else None


def alloc_reusable(doc: Optional[dict], *, codec_name: str, n_leaves: int) -> tuple:
    """(whether a ``--resume`` may reuse this recorded allocation, why): a
    document for another codec or leaf count would size payloads for a model
    that is not this one."""
    if not doc or not doc.get("complete"):
        return False, "budget_alloc.json is missing or incomplete"
    ep = latest_epoch(doc)
    if not ep or not ep.get("ks"):
        return False, "budget_alloc.json records no allocation epoch"
    if doc.get("codec") != codec_name:
        return False, (
            f"allocation was recorded for codec {doc.get('codec')!r} but "
            f"this run compresses with {codec_name!r} — re-allocating"
        )
    if int(doc.get("n_leaves", -1)) != int(n_leaves):
        return False, (
            f"allocation covers {doc.get('n_leaves')} leaves but this "
            f"model has {n_leaves} — re-allocating"
        )
    return True, (
        f"reusing recorded allocation epoch {ep.get('epoch')} "
        f"({ep.get('payload_bytes')} B predicted wire)"
    )


def allocation_meta(epoch_record: dict) -> dict:
    """The flight recorder's meta record of one allocation epoch."""
    return {
        "what": f"budget_alloc_epoch{int(epoch_record['epoch'])}",
        "budget_epoch": int(epoch_record["epoch"]),
        "start_step": int(epoch_record["start_step"]),
        "mode": epoch_record.get("mode"),
        "payload_bytes": int(epoch_record["payload_bytes"]),
        "predicted_variance": epoch_record.get("predicted_variance"),
        "layers": [
            {"name": l["name"], "k": int(l["k"]), "payload_bytes": int(l["payload_bytes"])}
            for l in epoch_record.get("layers", [])
        ],
    }
