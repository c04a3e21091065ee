"""CRC checkpoints of the port, with resume and keep-last-K retention.

Counterpart of ``atomo_tpu/training/checkpoint.py`` (its sharded loads
excepted: every family's full tree is saved and loaded whole). Files keep the reference's ``train_dir/model_step_N``
naming (src/sync_replicas_master_nn.py:331-336), so tools that poll the
directory work unchanged.

A file is ``magic(4) | crc32(payload) LE(4) | payload``. The payload is
``torch.save`` of ``{"step", "model" (the state_dict: parameters and
BatchNorm statistics), "opt_state" (the optimizer state's fields)}``, with
``"ef_residual"`` beside them (a guarded state's optimizer count is saved
held, less the steps the guard skipped) when the state carries ``--error-feedback``'s
residual (every rank's, one (N, d) tensor) and ``"overlap_carry"`` when it
carries ``--overlap delayed``'s in-flight payload (``{"payload": (N, B)
uint8, "ok": (N,) float32, "valid": 0-d float32}``, every rank's) and
``"quorum_carry"`` when it carries ``--quorum``'s staleness ring (``{"ring":
(N, K+1, B) uint8, "ring_ok": (N, K+1) float32}``, every rank's), every
tensor on the CPU, read back with ``torch.load(weights_only=True)`` and
copied into the caller's model and optimizer state on their device. A
``--partition sharded-update`` state saves ``"master"`` (the gathered flat
parameter vector, :mod:`atomo_tpu_torch.mesh.update`'s layout) and
``"buffers"`` (the BatchNorm statistics) in the place of ``"model"``, its
optimizer fields as full flat vectors (ZeRO-1's are saved so too, beside
its ``"model"``); such a file is read with :func:`read_checkpoint` and has no
per-leaf parameters, so :func:`load_params` refuses it as the JAX package's
does. With
``compress`` it goes through the port's lossless codec
(:mod:`atomo_tpu_torch.native.lossless`) first. The port reads flax msgpack
no more than it imports flax, so its magics are its own, and a file of the
JAX package (``ATR2``/``ATZ2``, legacy ``ATMO``/``ATMZ``) is refused by that
name: no file is ever misread.

Every read checks the CRC: a truncated, bit-flipped or foreign file raises
:class:`CorruptCheckpointError`. Loading with ``step=None`` walks the files
newest first and returns the newest valid one, warning for each file it
skips; an explicit ``step`` that is corrupt raises. Saves write a temporary
file and ``os.replace`` it into place; ``keep=K`` then prunes all but the
file just written and the newest K - 1 valid others.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
import warnings
import zlib
from typing import Optional

import torch
from torch import nn

STEP_RE = re.compile(r"^model_step_(\d+)$")
MAGIC_RAW = b"APT1"  # torch.save payload + crc32
MAGIC_LZ = b"APZ1"  # the same payload, lossless-compressed
# the JAX package's headers (flax msgpack payloads): crc32 raw and
# compressed, and the legacy ones without a CRC
JAX_MAGICS = (b"ATR2", b"ATZ2", b"ATMO", b"ATMZ")
HEADER_LEN = 8  # magic + crc32


class CorruptCheckpointError(ValueError):
    """A model_step_N file exists but cannot be trusted: truncated, failed
    its CRC, bad magic, a JAX-package file, or an undecodable payload."""


def checkpoint_path(train_dir: str, step: int) -> str:
    """The reference's ``_generate_model_path``
    (sync_replicas_master_nn.py:331-332)."""
    return os.path.join(train_dir, f"model_step_{step}")


def list_steps(train_dir: str) -> list[int]:
    if not os.path.isdir(train_dir):
        return []
    return sorted(int(m.group(1)) for m in map(STEP_RE.match, os.listdir(train_dir)) if m)


def latest_step(train_dir: str) -> Optional[int]:
    steps = list_steps(train_dir)
    return steps[-1] if steps else None


# path -> ((mtime_ns, size, inode), crc_ok, full_ok); full_ok None while only
# the CRC probe ran for that stat
_verify_cache: dict = {}


def reset_verify_cache() -> None:
    """Forget every memoized verdict."""
    _verify_cache.clear()


def _cache_key(path: str):
    try:
        st = os.stat(path)
    except OSError:
        _verify_cache.pop(path, None)
        return None
    return st.st_mtime_ns, st.st_size, st.st_ino


def _cache_get(path: str, *, full: bool):
    key = _cache_key(path)
    if key is None:
        return False  # a missing file is invalid
    hit = _verify_cache.get(path)
    if hit is None or hit[0] != key:
        return None
    return hit[2] if full else hit[1]


def _cache_put(path: str, *, crc_ok: bool, full_ok: Optional[bool]) -> None:
    key = _cache_key(path)
    if key is None:
        return
    prev = _verify_cache.get(path)
    if full_ok is None and prev is not None and prev[0] == key:
        full_ok = prev[2]  # keep the stronger verdict the probe cannot give
    _verify_cache[path] = (key, crc_ok, full_ok)


def healthy_marker_path(train_dir: str, step: int) -> str:
    return checkpoint_path(train_dir, step) + ".healthy"


def mark_healthy(train_dir: str, step: int) -> None:
    """Grant model_step_N the healthy tag (an atomic sidecar write)."""
    path = healthy_marker_path(train_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("healthy\n")
    os.replace(tmp, path)


def is_marked_healthy(train_dir: str, step: int) -> bool:
    return os.path.exists(healthy_marker_path(train_dir, step))


def latest_healthy_step(train_dir: str) -> Optional[int]:
    """The newest step both tagged healthy and passing the checks."""
    for s in reversed(list_steps(train_dir)):
        if is_marked_healthy(train_dir, s) and verify_checkpoint(train_dir, s):
            return s
    return None


def prune_after(train_dir: str, step: int) -> list[int]:
    """Remove every model_step_N (and its tag) with N > ``step``: the
    rollback's cut of the diverged timeline. Returns the steps removed. The
    flight recorder's ``metrics.jsonl`` is cut past ``step`` in the same
    call (:func:`~atomo_tpu_torch.obs.recorder.prune_metrics_after`), so both
    prune surfaces, the doctor's rollback and the supervisor's exit-23 cut,
    leave no metrics tail of a discarded timeline."""
    removed = []
    for s in list_steps(train_dir):
        if s <= step:
            continue
        for path in (checkpoint_path(train_dir, s), healthy_marker_path(train_dir, s)):
            try:
                os.remove(path)
            except OSError:
                pass
        _verify_cache.pop(checkpoint_path(train_dir, s), None)
        removed.append(s)
    from atomo_tpu_torch.obs.recorder import prune_metrics_after

    prune_metrics_after(train_dir, step)
    return removed


def _cpu(t: Optional[list[torch.Tensor]]):
    return None if t is None else [x.detach().cpu() for x in t]


def _payload(state, step: int) -> bytes:
    opt = state.opt_state
    # a guarded state's optimizer count is its host count less the steps the
    # guard held (the count the JAX package's optax state keeps)
    held = getattr(state, "held", None)
    count = opt.count - (int(held) if held is not None else 0)
    obj = {
        "step": step,
        "opt_state": {f.name: (count if f.name == "count" else _cpu(getattr(opt, f.name)))
                      for f in dataclasses.fields(opt)},
    }
    master = getattr(state, "master", None)
    if master is None:
        obj["model"] = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    else:  # the sharded update: the gathered flat master and the statistics
        obj["master"] = master.detach().cpu()
        obj["buffers"] = {k: v.detach().cpu() for k, v in state.model.named_buffers()}
    if getattr(state, "residual", None) is not None:
        obj["ef_residual"] = state.residual.detach().cpu()
    carry = getattr(state, "carry", None)
    if carry is not None:
        if not isinstance(carry, dict):
            raise TypeError("save the overlap carry in its gathered form "
                            "(parallel.overlap.gather_carry): every rank's payload")
        obj["overlap_carry"] = {k: v.detach().cpu() for k, v in carry.items()}
    ring = getattr(state, "ring", None)
    if ring is not None:
        if not isinstance(ring, dict):
            raise TypeError("save the quorum ring in its gathered form "
                            "(parallel.replicated.gather_ring): every rank's ring")
        obj["quorum_carry"] = {k: v.detach().cpu() for k, v in ring.items()}
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


_warned_compress_fallback = False


def save_checkpoint(train_dir: str, state, step: Optional[int] = None,
                    compress: bool = True, keep: int = 0) -> str:
    """Write ``state`` (a :class:`~atomo_tpu_torch.training.trainer.TrainState`)
    to ``train_dir/model_step_N`` (CRC header, atomic rename) and return the
    path. ``keep`` > 0 then prunes all but the file just written and the
    newest ``keep`` - 1 valid others; a JAX-package file is left alone and
    takes no slot. With ``compress`` and no codec (no ``g++``, a failed
    build) the file is written raw, with one warning."""
    global _warned_compress_fallback
    os.makedirs(train_dir, exist_ok=True)
    step = state.step if step is None else step
    payload = _payload(state, step)
    magic = MAGIC_RAW
    if compress:
        try:
            from atomo_tpu_torch.native import lossless

            payload = lossless.compress(payload)
            magic = MAGIC_LZ
        except (OSError, RuntimeError) as exc:
            # the host codec cannot be built or loaded, or refused the
            # buffer: a raw file is still a whole checkpoint, but say so
            if not _warned_compress_fallback:
                _warned_compress_fallback = True
                warnings.warn("checkpoint compression unavailable "
                              f"({type(exc).__name__}: {exc}); writing raw")
    path = checkpoint_path(train_dir, step)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(magic + zlib.crc32(payload).to_bytes(4, "little") + payload)
    os.replace(tmp, path)
    if keep > 0:
        # retained: the file just written and the newest keep - 1 VALID
        # others. By step order alone a stale higher-numbered corpse would
        # push out the new file (a timeline resumed below the corpse), and
        # a corrupt file in a slot would halve the redundancy and live on.
        # The newest healthy-tagged file is the doctor's rollback anchor: it
        # rides outside the budget until a newer save earns the tag.
        retained = 0
        anchor_kept = is_marked_healthy(train_dir, step)
        for s in sorted((s for s in list_steps(train_dir) if s != step), reverse=True):
            other = checkpoint_path(train_dir, s)
            ok = _crc_ok(other)
            if ok is None:
                continue
            if ok and retained < keep - 1:
                retained += 1
                anchor_kept = anchor_kept or is_marked_healthy(train_dir, s)
                continue
            if ok and not anchor_kept and is_marked_healthy(train_dir, s):
                anchor_kept = True
                continue
            # the tag follows its file out: an orphaned tag would let a later
            # file of the same step inherit a verdict it never earned
            for victim in (other, healthy_marker_path(train_dir, s)):
                try:
                    os.remove(victim)
                except OSError:
                    pass  # already gone: retention is best effort
            _verify_cache.pop(other, None)
    return path


def _crc_ok(path: str) -> Optional[bool]:
    """Header and CRC only (no decompress, no unpickling): the retention
    probe, memoized. None for a JAX-package file, which is not the port's
    to judge."""
    cached = _cache_get(path, full=False)
    if cached is not None:
        return cached
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return False
    if blob[:4] in JAX_MAGICS:
        return None
    ok = (blob[:4] in (MAGIC_RAW, MAGIC_LZ) and len(blob) >= HEADER_LEN
          and zlib.crc32(blob[HEADER_LEN:]) == int.from_bytes(blob[4:HEADER_LEN], "little"))
    _cache_put(path, crc_ok=ok, full_ok=None if ok else False)
    return ok


def _read_payload(path: str) -> dict:
    """One file checked and decoded down to its payload dict. Raises
    :class:`CorruptCheckpointError` for anything untrustworthy; a missing
    file raises ``FileNotFoundError``."""
    with open(path, "rb") as f:
        blob = f.read()
    magic = blob[:4]
    if magic in JAX_MAGICS:
        raise CorruptCheckpointError(
            f"{path!r}: a checkpoint of the JAX package atomo_tpu (magic {magic!r}, a "
            "flax msgpack payload); the port reads only its own files")
    if magic not in (MAGIC_RAW, MAGIC_LZ):
        raise CorruptCheckpointError(f"{path!r}: not an atomo_tpu_torch checkpoint "
                                     f"(magic {magic!r})")
    if len(blob) < HEADER_LEN:
        raise CorruptCheckpointError(f"{path!r}: truncated header")
    want = int.from_bytes(blob[4:HEADER_LEN], "little")
    payload = blob[HEADER_LEN:]
    got = zlib.crc32(payload)
    if got != want:
        raise CorruptCheckpointError(
            f"{path!r}: CRC mismatch (header {want:#010x}, payload {got:#010x}): "
            "truncated or corrupted file")
    if magic == MAGIC_LZ:
        from atomo_tpu_torch.native import lossless

        try:
            payload = lossless.decompress(payload)
        except ValueError as exc:
            raise CorruptCheckpointError(f"{path!r}: {exc}") from exc
    try:
        d = torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True)
    except Exception as exc:  # the unpickler raises several kinds
        raise CorruptCheckpointError(f"{path!r}: undecodable payload ({exc})") from exc
    if (not isinstance(d, dict) or not {"step", "opt_state"} <= set(d)
            or not ({"model"} <= set(d) or {"master", "buffers"} <= set(d))):
        raise CorruptCheckpointError(f"{path!r}: not a checkpoint payload")
    return d


def verify_checkpoint(train_dir: str, step: int) -> bool:
    """True iff model_step_N exists and passes the header, CRC and payload
    checks (memoized by the file's stat)."""
    path = checkpoint_path(train_dir, step)
    cached = _cache_get(path, full=True)
    if cached is not None:
        return cached
    try:
        _read_payload(path)
        ok = True
    except CorruptCheckpointError:
        ok = False
    except OSError:
        return False  # a transient read failure is not memoized
    _cache_put(path, crc_ok=ok, full_ok=ok)
    return ok


def latest_valid_step(train_dir: str) -> Optional[int]:
    """Newest step whose file passes the checks (None if none does)."""
    for s in reversed(list_steps(train_dir)):
        if verify_checkpoint(train_dir, s):
            return s
    return None


def _read(train_dir: str, step: Optional[int]) -> dict:
    if step is not None:
        # an explicit step: corruption is an error the caller asked to see
        return _read_payload(checkpoint_path(train_dir, step))
    steps = list_steps(train_dir)
    if not steps:
        raise FileNotFoundError(f"no model_step_N checkpoints in {train_dir!r}")
    for s in reversed(steps):
        path = checkpoint_path(train_dir, s)
        try:
            return _read_payload(path)
        except (CorruptCheckpointError, OSError) as exc:
            warnings.warn(f"skipping invalid checkpoint {path!r}: {exc}; "
                          "falling back to the previous step")
    raise FileNotFoundError(
        f"no VALID model_step_N checkpoints in {train_dir!r} "
        f"(all {len(steps)} candidates failed integrity checks)")


@torch.no_grad()
def _load_model(model: nn.Module, sd: dict) -> None:
    try:
        model.load_state_dict(sd)  # copies into the model's tensors, bit for bit
    except RuntimeError as exc:
        raise ValueError(f"the checkpoint does not fit this model: {exc}") from exc


@torch.no_grad()
def _load_opt_state(template, saved: dict):
    names = [f.name for f in dataclasses.fields(template)]
    if sorted(saved) != sorted(names):
        raise ValueError(f"the checkpoint's optimizer state has {sorted(saved)}, this "
                         f"optimizer's {sorted(names)}: resume with the optimizer it was "
                         "written with")
    out = {}
    for name in names:
        want, got = getattr(template, name), saved[name]
        if name == "count":
            out[name] = int(got)
        elif want is None or got is None:
            if (want is None) != (got is None):
                raise ValueError(f"optimizer state {name!r}: the checkpoint has "
                                 f"{'none' if got is None else 'one'}, this optimizer "
                                 f"{'none' if want is None else 'one'}")
            out[name] = None
        else:
            if [t.shape for t in want] != [t.shape for t in got]:
                raise ValueError(f"optimizer state {name!r}: shapes differ from the model's")
            for w, g in zip(want, got):
                w.copy_(g)
            out[name] = want
    return type(template)(**out)


def load_checkpoint(train_dir: str, state, step: Optional[int] = None):
    """Restore a full train state into ``state`` (built by ``create_state``
    with the same model and optimizer: its model and optimizer tensors are
    overwritten in place) and return it with the checkpoint's step, its
    error-feedback carry (the saved (N, d) tensor on the CPU, or None), its
    overlap carry and its quorum ring (the saved dicts on the CPU, or
    None).

    ``step=None`` loads the newest file that passes the checks, skipping
    corrupt ones with a warning, and raises ``FileNotFoundError`` when the
    directory holds none; an explicit ``step`` raises
    :class:`CorruptCheckpointError` rather than substitute other weights."""
    d = _read(train_dir, step)
    _load_model(state.model, _params_of(d))
    opt_state = _load_opt_state(state.opt_state, d["opt_state"])
    return dataclasses.replace(state, step=int(d["step"]), opt_state=opt_state,
                               residual=d.get("ef_residual"), carry=d.get("overlap_carry"),
                               ring=d.get("quorum_carry"), held=None)


def load_params(train_dir: str, model: nn.Module, step: Optional[int] = None) -> int:
    """Restore only the parameters and BatchNorm statistics into ``model``
    and return the checkpoint's step: the evaluator's path, whatever
    optimizer wrote the file."""
    d = _read(train_dir, step)
    _load_model(model, _params_of(d))
    return int(d["step"])


def _params_of(d: dict) -> dict:
    """A payload's per-leaf state_dict. A sharded-update file has none: the
    JAX package's ``load_params`` reads ``d["params"]`` and raises KeyError
    on such a file (``atomo_tpu/training/checkpoint.py:438-449``), and the
    port refuses it alike."""
    if "model" not in d:
        raise KeyError(
            "params: a --partition sharded-update checkpoint holds the flat "
            "master vector, not per-leaf parameters (read it with "
            "read_checkpoint)")
    return d["model"]


def read_checkpoint(train_dir: str, step: Optional[int] = None) -> dict:
    """The checked payload of the newest valid checkpoint (or of ``step``),
    as :func:`load_checkpoint` reads it: the dict of CPU tensors, whatever
    layout wrote it (``"model"`` per leaf, or the sharded update's
    ``"master"``)."""
    return _read(train_dir, step)
