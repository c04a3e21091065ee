"""Per-layer spectra and the ATOMO water-filling byte allocator.

Counterpart of ``atomo_tpu/budget/allocator.py``: host math, the same
arithmetic in the same order, so that the same spectra give the same
allocation (``ks``, bytes, ``describe()``) as the JAX package.

THE VARIANCE MODEL. The ``fixed_k`` sampler draws k atoms with replacement,
q_i = s_i / sum(s), coefficients s_i / (k q_i). Its error is

    E ||ghat - g||_F^2 = ((sum_i s_i)^2 - sum_i s_i^2) / k = A / k,

so an allocation {k_l} has variance sum_l A_l / k_l, and minimising it under
a wire budget sum_l bytes_l(k_l) <= B is a water-filling problem with
diminishing returns per atom. The solver is an exact greedy: the next atom
goes to the layer with the best variance drop per byte, ties broken by leaf
index, so the allocation is a pure function of (spectra, budget).

THE QSGD BIT LAW. Stochastic rounding of |x|/s onto L(b) = 2^b - 1 levels
has, under the uniform-residual model, E ||ghat - g||^2 = B_l / (2^b - 1)^2
with B_l = (1/6) sum_buckets n_b s_b^2. The knob is the leaf's bit width b
(1 .. :data:`MAX_BITS`), priced by the codec's packed-word accounting; the
wire format has no dense fallback, so the solver never buys a width whose
payload meets the dense bytes.

Degenerate points: ``uniform`` is every adaptive layer at the base knob, the
plain codec byte for byte; an unbounded budget drives every SVD layer to the
codec's exact dense fallback.

Pricing is the codec's own ``leaf_payload_bytes``, so the predicted total
equals the executed step's ``msg_bytes`` to the byte.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional, Sequence

import numpy as np
import torch

# the widest width (16): past it a bit buys nothing on float32 inputs (24
# significand bits), and it is the widest the QSGD kernels take
from atomo_tpu_torch.ops.qsgd_kernels import MAX_BITS


@dataclasses.dataclass(frozen=True)
class LayerSpectrum:
    """One leaf's allocation inputs, canonical order.

    ``a`` is the variance numerator: A = (sum s)^2 - sum s^2 of the leaf's
    matricized spectrum for SVD ranks, or B = (1/6) sum n_b s_b^2 of its
    bucket norms for QSGD bits; ``r_full`` caps the useful knob (full rank,
    or the last width whose payload still beats dense); ``adaptive`` is
    False for leaves with no knob (SVD leaves shipped dense at any rank,
    QSGD leaves whose 1-bit payload already meets dense)."""

    index: int
    name: str
    shape: tuple
    dense_bytes: int
    r_full: int
    a: float
    base_k: int
    adaptive: bool


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A solved per-layer budget split (the artifact's epoch body)."""

    mode: str  # "uniform" | "variance"
    ks: tuple  # per-leaf knob (SVD rank or QSGD bits), canonical order
    payload_bytes: int  # predicted total wire bytes
    budget_bytes: int  # the budget the solver was given
    predicted_variance: float  # sum of the stated per-leaf law
    epoch: int = 0

    def describe(self) -> str:
        return (
            f"budget allocation ({self.mode}, epoch {self.epoch}): "
            f"{self.payload_bytes / 1e6:.4f} MB/replica predicted wire "
            f"of a {self.budget_bytes / 1e6:.4f} MB budget, predicted "
            f"variance {self.predicted_variance:.6g}"
        )


def knob_name(codec) -> str:
    """The field the allocator waters: ``rank`` (SVD) or ``bits`` (QSGD)."""
    return "rank" if hasattr(codec, "rank") else "bits"


def _with_knob(codec, k: int):
    return dataclasses.replace(codec, **{knob_name(codec): int(k)})


def variance_at(codec, a: float, k: int) -> float:
    """The per-leaf law at knob ``k``: A/k for SVD ranks, B/(2^b - 1)^2 for
    QSGD bits."""
    if knob_name(codec) == "bits":
        lv = float((1 << int(k)) - 1)
        return a / (lv * lv)
    return a / k


def _leaf_bytes(codec, spectrum: LayerSpectrum, k: int) -> int:
    """Wire bytes of this leaf at knob ``k``: the codec's own pricing."""
    return int(_with_knob(codec, k).leaf_payload_bytes(spectrum.shape))


def _jax_leaves(grads, layouts):
    """(numpy float32 leaf in the JAX layout, its shape) per gradient leaf."""
    from atomo_tpu_torch.convert import jax_view

    out = []
    for i, g in enumerate(grads):
        tr = True if layouts is None else bool(layouts[i])
        arr = jax_view(g.detach().cpu(), tr).contiguous().numpy().astype(np.float32)
        out.append((arr, tuple(int(d) for d in arr.shape)))
    return out


def measure_spectra(codec, grads: Sequence, names: Optional[Sequence[str]] = None,
                    layouts: Optional[Sequence[bool]] = None) -> list:
    """Per-leaf :class:`LayerSpectrum` of a probe gradient.

    ``grads`` is the canonical-order gradient list (port-layout tensors, each
    read in the JAX layout, ``layouts`` as for ``codecs.encode_tree``), taken
    over a fixed batch that does not advance the training stream
    (``sparse.hybrid.probe_gradient``); ``names`` are the leaves' printed
    names (``convert.jax_leaf_paths``).
    SVD: each leaf matricized with the codec's own resize policy and its
    singular values taken on the host (numpy, float32). A ``bits`` codec
    (QSGD) measures its bucket norms instead."""
    leaves = _jax_leaves(grads, layouts)
    names = [str(i) for i in range(len(leaves))] if names is None else list(names)
    if knob_name(codec) == "bits":
        return _measure_bit_spectra(codec, leaves, names)
    from atomo_tpu_torch.codecs.svd import resize_to_2d

    out = []
    for i, (arr, shape) in enumerate(leaves):
        dense_b = int(arr.size) * 4
        mat, _, _pad = resize_to_2d(torch.from_numpy(arr), policy=codec.reshape,
                                    max_min_dim=codec.max_min_dim)
        mat = mat.numpy()
        r_full = int(min(mat.shape))
        s = np.linalg.svd(mat, compute_uv=False)
        a = float(np.sum(s)) ** 2 - float(np.sum(s * s))
        base_k = max(min(int(codec.rank), r_full), 1)
        # adaptive iff rank 1 already beats dense: otherwise the codec ships
        # this leaf dense at every rank and there is no knob
        adaptive = not _always_dense(codec, shape)
        out.append(LayerSpectrum(index=i, name=names[i], shape=shape, dense_bytes=dense_b,
                                 r_full=r_full, a=max(a, 0.0), base_k=base_k,
                                 adaptive=adaptive))
    return out


def _measure_bit_spectra(codec, leaves, names) -> list:
    """Per-leaf :class:`LayerSpectrum` for QSGD bit allocation: B_l =
    (1/6) sum_b n_b s_b^2 over the leaf's real (unpadded) bucket contents;
    ``r_full`` the last width (<= MAX_BITS) whose payload still beats dense;
    ``base_k`` the codec's ``bits`` unclamped (the uniform point is the
    plain codec). TernGrad is refused: its law is not stated."""
    if getattr(codec, "scheme", "qsgd") != "qsgd":
        raise ValueError(
            f"bit allocation needs the L2-scale qsgd scheme, got "
            f"{codec.scheme!r}: the terngrad max-norm law is not stated"
        )
    out = []
    for i, (arr, shape) in enumerate(leaves):
        arr = arr.reshape(-1)
        dense_b = int(arr.size) * 4
        bs = int(codec.bucket_size)
        b_num = 0.0
        for start in range(0, arr.size, bs):
            chunk = arr[start:start + bs]
            s_b = float(np.linalg.norm(chunk))
            b_num += chunk.size * s_b * s_b
        b_num /= 6.0
        adaptive = not _always_dense(codec, shape)
        r_full = 1
        for b in range(1, MAX_BITS + 1):
            if _with_knob(codec, b).leaf_payload_bytes(shape) < dense_b:
                r_full = b
        base_k = int(codec.bits)
        if not adaptive:
            r_full = base_k
        out.append(LayerSpectrum(index=i, name=names[i], shape=shape, dense_bytes=dense_b,
                                 r_full=r_full, a=max(b_num, 0.0), base_k=base_k,
                                 adaptive=adaptive))
    return out


def _always_dense(codec, shape) -> bool:
    """Is this leaf knob-less? SVD: the dense fallback already at rank 1.
    QSGD: the 1-bit payload already meets the dense bytes."""
    shape = tuple(shape)
    if knob_name(codec) == "bits":
        dense = 4
        for d in shape:
            dense *= int(d)
        return _with_knob(codec, 1).leaf_payload_bytes(shape) >= dense
    return bool(_with_knob(codec, 1)._dense_fallback(shape))


def spectra_from_qerr2(spectra: Sequence[LayerSpectrum], qerr2_mean: Sequence[float],
                       current_ks: Sequence[int], codec=None) -> list:
    """Fold an observed per-layer q_err2 series into fresh spectra: under
    the law E q_err2 = A/k (SVD; QSGD: B = q_err2 (2^b - 1)^2 when ``codec``
    is a bits codec) the mean at the current allocation estimates the
    numerator. Non-adaptive leaves, unusable samples (non-finite, negative)
    and leaves whose current payload is the exact dense fallback (their
    q_err2 is 0 because the wire is exact) keep the prior A."""
    out = []
    for l in spectra:
        a = l.a
        if l.adaptive and l.index < len(qerr2_mean):
            q = qerr2_mean[l.index]
            k = max(int(current_ks[l.index]), 1)
            at_dense = codec is not None and _leaf_bytes(codec, l, k) >= l.dense_bytes
            if not at_dense and q is not None and math.isfinite(float(q)) and float(q) >= 0:
                if codec is not None and knob_name(codec) == "bits":
                    a = float(q) / variance_at(codec, 1.0, k)
                else:
                    a = float(q) * k
        out.append(dataclasses.replace(l, a=a))
    return out


def uniform_ks(spectra: Sequence[LayerSpectrum]) -> tuple:
    """The uniform point: every leaf at its (clamped) base knob."""
    return tuple(l.base_k for l in spectra)


def predicted_variance(spectra: Sequence[LayerSpectrum], ks: Sequence[int],
                       codec=None) -> float:
    """Total predicted variance under the per-leaf law. SVD: sum A_l / k_l
    over adaptive leaves (a leaf at its dense fallback, priced when
    ``codec`` is given, and a non-adaptive leaf are exact: 0). QSGD: sum
    B_l / (2^b - 1)^2 over every leaf (no exact point in the format)."""
    bits = codec is not None and knob_name(codec) == "bits"
    total = 0.0
    for l in spectra:
        k = max(int(ks[l.index]), 1)
        if bits:
            total += variance_at(codec, l.a, k)
            continue
        if not l.adaptive:
            continue
        if codec is not None and _leaf_bytes(codec, l, k) >= l.dense_bytes:
            continue  # the dense fallback ships exact: zero variance
        total += l.a / k
    return total


def allocation_payload_bytes(codec, spectra: Sequence[LayerSpectrum],
                             ks: Sequence[int]) -> int:
    """Predicted total wire bytes of an allocation: the per-leaf pricing
    summed, which the executed step's ``msg_bytes`` equals."""
    return int(sum(_leaf_bytes(codec, l, ks[l.index]) for l in spectra))


def allocation_leaf_budgets(codec, spectra: Sequence[LayerSpectrum],
                            ks: Sequence[int]) -> list:
    """Per-leaf ``(dense_bytes, payload_bytes)`` pairs, canonical order."""
    return [(int(l.dense_bytes), _leaf_bytes(codec, l, ks[l.index])) for l in spectra]


def solve_allocation(codec, spectra: Sequence[LayerSpectrum],
                     budget_bytes: Optional[int] = None, mode: str = "variance",
                     epoch: int = 0) -> Allocation:
    """Distribute ``budget_bytes`` of wire across layers to minimise the
    total predicted variance. Pure and deterministic: the greedy's heap
    breaks ties by leaf index.

    ``budget_bytes`` None (or <= 0) spends exactly the uniform allocation's
    total (the equal-wire comparison); ``mode="uniform"`` returns the
    uniform point; a budget at or past every layer's dense cost returns the
    spend-everything point."""
    n = len(spectra)
    base = uniform_ks(spectra)
    uniform_total = allocation_payload_bytes(codec, spectra, base)
    if budget_bytes is None or int(budget_bytes) <= 0:
        budget_bytes = uniform_total
    budget_bytes = int(budget_bytes)
    if mode == "uniform":
        return Allocation(mode="uniform", ks=base, payload_bytes=uniform_total,
                          budget_bytes=budget_bytes,
                          predicted_variance=predicted_variance(spectra, base, codec),
                          epoch=epoch)
    if mode != "variance":
        raise ValueError(f"unknown allocation mode {mode!r}: expected uniform | variance")
    ks = [1] * n
    spent = 0
    for l in spectra:
        if not l.adaptive:
            ks[l.index] = l.base_k  # fixed leaves: priced, never re-ranked
        spent += _leaf_bytes(codec, l, ks[l.index])
    # each move raises one adaptive leaf's knob by one; its gain is the
    # law's marginal drop (SVD: A (1/k - 1/(k+1)), or the whole A/k when the
    # next rank crosses into the exact dense fallback; QSGD: B (1/L(b)^2 -
    # 1/L(b+1)^2), never a width whose payload meets dense) per byte. heapq
    # is a min-heap: push -gain/byte.
    bits_knob = knob_name(codec) == "bits"
    heap: list = []

    def push_move(l: LayerSpectrum, k: int):
        if k >= l.r_full:
            return
        here = _leaf_bytes(codec, l, k)
        if here >= l.dense_bytes:
            return  # already at the exact dense fallback: nothing to buy
        nxt = _leaf_bytes(codec, l, k + 1)
        d_bytes = nxt - here
        if bits_knob:
            if nxt >= l.dense_bytes:
                return  # never pay dense wire for a lossy payload
            gain = variance_at(codec, l.a, k) - variance_at(codec, l.a, k + 1)
        elif nxt >= l.dense_bytes:
            gain = l.a / k  # crossing into the exact dense fallback
        else:
            gain = l.a * (1.0 / k - 1.0 / (k + 1))
        # a free (or byte-saving) raise goes first; ties still break by index
        ratio = math.inf if d_bytes <= 0 else gain / d_bytes
        heapq.heappush(heap, (-ratio, l.index, k, d_bytes))

    by_index = {l.index: l for l in spectra}
    for l in spectra:
        if l.adaptive:
            push_move(l, ks[l.index])
    while heap:
        _neg_ratio, idx, k, d_bytes = heapq.heappop(heap)
        if ks[idx] != k:
            continue  # stale move (the leaf advanced past it)
        if spent + d_bytes > budget_bytes:
            continue  # unaffordable; cheaper moves may still fit
        ks[idx] = k + 1
        spent += d_bytes
        push_move(by_index[idx], k + 1)
    ks_t = tuple(ks)
    return Allocation(mode="variance", ks=ks_t,
                      payload_bytes=allocation_payload_bytes(codec, spectra, ks_t),
                      budget_bytes=budget_bytes,
                      predicted_variance=predicted_variance(spectra, ks_t, codec),
                      epoch=epoch)
