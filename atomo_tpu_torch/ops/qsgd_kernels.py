"""QSGD / TernGrad kernels: CUDA wrappers and their plain PyTorch twins.

Counterpart of ``atomo_tpu/ops/qsgd_kernels.py``. The four Pallas TPU kernels
there become four hand-written CUDA kernels in ``csrc/qsgd_kernels.cu``
(built for sm_90a by :mod:`atomo_tpu_torch.ops._build`):

=========================  =============================================
wrapper                    replaces (atomo_tpu/ops/qsgd_kernels.py)
=========================  =============================================
``quantize_pack``,         ``pallas_quantize_pack`` (fused encode)
``quantize_pack_tree``
``unpack_dequantize``,     ``pallas_unpack_dequantize`` (fused decode)
``unpack_dequantize_tree``
``pack_bucketed``,         ``pallas_pack_bucketed`` (bare bit-pack)
``pack_bucketed_tree``
``unpack_bucketed``,       ``pallas_unpack_bucketed`` (bare bit-unpack)
``unpack_bucketed_tree``
=========================  =============================================

Each wrapper runs its kernel on a CUDA tensor (or raises: there is no
fallback) and its ``*_plain`` twin on a CPU tensor. The twin computes the same
function with vectorised torch ops in the same planar layout and repeats the
kernel's roundings, including the order of the per-bucket scale reduction and
the Philox4x32-10 stream of the in-kernel generator, so kernel and twin agree
bit for bit on the same inputs. Every wrapper counts its launches in
``<wrapper>.launches``.

Wire format: words (n_buckets, words_per_bucket) uint32 and scales
(n_buckets,) float32, the JAX package's planar layout (bucket position
p = j * n_words + w sits in word w at bit j * (bits + 1)). One
:func:`quantize_pack_tree` call encodes every leaf of a gradient tree, of any
shapes, in one launch: the leaf table rides in the kernel's arguments (host
memory, no copy to the device, no host sync), and each leaf's payload is a
view into one flat words and one flat scales buffer. The decode mirrors
it: one :func:`unpack_dequantize_tree` call decodes every leaf (or the mean
over a leading replica axis) in one launch, straight into the port's layout
(conv OIHW, linear (out, in)), and one :func:`unpack_bucketed_tree` call
unpacks every leaf's words. Both decode kernels read a leaf's replicas at a
replica stride of their leaf table, so the rows of a gathered (N, bytes)
buffer (:func:`atomo_tpu_torch.parallel.common.unpack_tree_buckets`) are
decoded where they lie, with no copy into a replica-contiguous layout; one
:func:`pack_bucketed_tree` call packs the
codes of every leaf, its rows one after another in one buffer, in one launch.
:func:`quantize_pack`, :func:`unpack_dequantize`, :func:`pack_bucketed` and
:func:`unpack_bucketed` are the same kernels over the L equal leaves of an
(L, n) stack (one leaf for the last two).

Widths run from 1 to :data:`MAX_BITS` = 16 magnitude bits, the budget
allocator's ceiling (a sign bit beside them, so a field is ``bits + 1``
bits). Up to 8 bits a word holds ``vpw = 32 // (bits + 1)`` = 16 .. 3
fields; above, 3 at 9 bits, 2 at 10-15 and 1 at 16, so a bucket of 512
values pads to 513 positions at 9 bits and to 512 at 10 and above. A field
stays below 2^17, so codes leave :func:`unpack_bucketed` as int32 (the JAX
kernel returns uint32) with the same bits, and torch's int32 takes the
shifts and masks that its uint32 does not. Each launch takes one width: a
tree whose leaves differ in width (a per-leaf budget allocation) is one
launch per distinct width (:mod:`atomo_tpu_torch.codecs.base`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from atomo_tpu_torch.ops import _build
from atomo_tpu_torch.utils.rng import FoldedSeeds

_LIB = "qsgd_kernels"
_F32_TINY = float(np.finfo(np.float32).tiny)
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U24 = 1.0 / (1 << 24)
MAX_BITS = 16  # widest field the kernels take (csrc/qsgd_kernels.cu QSGD_DISPATCH_BITS)

Seeds = Union[torch.Tensor, Sequence[int], FoldedSeeds]


class Geometry(NamedTuple):
    """Bucket layout of one leaf of ``n`` values."""

    bits: int
    bucket_size: int
    n: int
    bpv: int  # bits per value: sign + magnitude
    vpw: int  # values per uint32 word
    bucket_p: int  # bucket padded to whole words
    n_words: int  # words per bucket
    n_buckets: int
    levels: int


@functools.lru_cache(maxsize=4096)
def geometry(n: int, bits: int, bucket_size: int = 512) -> Geometry:
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits must be in 1..{MAX_BITS}, got {bits}")
    if bucket_size < 1:
        raise ValueError(f"bucket_size must be positive, got {bucket_size}")
    bpv = bits + 1
    vpw = 32 // bpv
    bucket_p = -(-bucket_size // vpw) * vpw
    return Geometry(
        bits=bits, bucket_size=bucket_size, n=n, bpv=bpv, vpw=vpw,
        bucket_p=bucket_p, n_words=bucket_p // vpw,
        n_buckets=-(-n // bucket_size), levels=(1 << bits) - 1,
    )


def padded_bucket(bucket_size: int, bits: int) -> int:
    """Bucket size rounded up to a whole number of uint32 words."""
    return geometry(0, bits, bucket_size).bucket_p


def words_per_bucket(bucket_size: int, bits: int) -> int:
    return geometry(0, bits, bucket_size).n_words


def block_threads(n_words: int) -> int:
    """Threads of one quantize_pack block: the power of two >= n_words,
    clamped to [32, 1024]. The plain twin reduces over the same count."""
    t = 32
    while t < n_words and t < 1024:
        t *= 2
    return t


# ---------------------------------------------------------------- plain twins


def _as_leaves(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if x.dim() == 1:
        return x.unsqueeze(0), True
    if x.dim() != 2:
        raise ValueError(f"x must be (n,) or (L, n), got {tuple(x.shape)}")
    return x, False


def _bucket_planar(rows: torch.Tensor, g: Geometry) -> torch.Tensor:
    """(R, bucket_size) -> (R, vpw, n_words), zero-padded to bucket_p."""
    out = rows.new_zeros((rows.shape[0], g.bucket_p))
    out[:, : g.bucket_size] = rows
    return out.view(-1, g.vpw, g.n_words)


def _leaf_rows(x: torch.Tensor, g: Geometry) -> torch.Tensor:
    """(L, n) -> (L * n_buckets, bucket_size), zero-padded past n."""
    out = x.new_zeros((x.shape[0], g.n_buckets * g.bucket_size))
    out[:, : g.n] = x
    return out.view(-1, g.bucket_size)


def tree_rows(leaves: Sequence[torch.Tensor], bucket_size: int) -> torch.Tensor:
    """1-D leaves -> their (rows, bucket_size) buckets, the leaves' rows one
    after another, each leaf zero-padded to whole buckets (one concatenation)."""
    pad = leaves[0].new_zeros(bucket_size)
    parts = []
    for x in leaves:
        parts.append(x)
        tail = -x.numel() % bucket_size
        if tail:
            parts.append(pad[:tail])
    return torch.cat(parts).view(-1, bucket_size)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """32x32 -> 64-bit product of uint32 values held in int64, split in
    16-bit halves so that no intermediate leaves int64."""
    p1 = a * (b & 0xFFFF)
    p2 = a * (b >> 16)
    t = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values, the twin of the
    kernel's generator: counter ``c`` (4 tensors), key (k0, k1)."""
    c0, c1, c2, c3 = c
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seeds: torch.Tensor, g: Geometry) -> torch.Tensor:
    """The in-kernel generator's uniforms as a planar (L * n_buckets, vpw,
    n_words) tensor: word w of bucket lb of leaf l draws counter
    (w, j // 4, lb, 0) under key seeds[l] and takes output j % 4."""
    dev = seeds.device
    n_leaves = seeds.shape[0]
    q = -(-g.vpw // 4)
    s = seeds.to(torch.int64).repeat_interleave(g.n_buckets).view(-1, 1, 1)
    k0, k1 = s & _MASK32, (s >> 32) & _MASK32
    lb = torch.arange(g.n_buckets, device=dev, dtype=torch.int64).repeat(n_leaves)
    c0 = torch.arange(g.n_words, device=dev, dtype=torch.int64).view(1, 1, -1)
    c1 = torch.arange(q, device=dev, dtype=torch.int64).view(1, -1, 1)
    c2 = lb.view(-1, 1, 1)
    shape = (lb.shape[0], q, g.n_words)
    c = [t.expand(shape) for t in (c0, c1, c2, torch.zeros_like(c2))]
    r = torch.stack(philox4x32_10(c, k0, k1), dim=2)  # (R, q, 4, n_words)
    r = r.reshape(lb.shape[0], 4 * q, g.n_words)[:, : g.vpw]
    return (r >> 8).to(torch.float32) * _U24


def _or_fields(codes: torch.Tensor, bpv: int) -> torch.Tensor:
    """(R, vpw, n_words) int64 codes -> (R, n_words) uint32 words."""
    acc = codes[:, 0]
    for j in range(1, codes.shape[1]):
        acc = acc | (codes[:, j] << (j * bpv))
    return acc.to(torch.uint32)


def _split_fields(words: torch.Tensor, g: Geometry) -> torch.Tensor:
    """(R, n_words) uint32 words -> (R, vpw, n_words) int64 codes."""
    w = words.to(torch.int64)
    mask = (1 << g.bpv) - 1
    return torch.stack([(w >> (j * g.bpv)) & mask for j in range(g.vpw)], dim=1)


def _bucket_scales(planar: torch.Tensor, g: Geometry, terngrad: bool) -> torch.Tensor:
    """Per-bucket scale in the kernel's reduction order: thread t sums words
    t, t + nt, ... field by field, then a halving tree over the nt threads."""
    nt = block_threads(g.n_words)
    k = -(-g.n_words // nt)
    xr = planar.new_zeros((planar.shape[0], g.vpw, k * nt))
    xr[:, :, : g.n_words] = planar
    xr = xr.view(planar.shape[0], g.vpw, k, nt)
    acc = planar.new_zeros((planar.shape[0], nt))
    for kk in range(k):
        for j in range(g.vpw):
            v = xr[:, j, kk]
            acc = torch.maximum(acc, v.abs()) if terngrad else acc + v * v
    h = nt // 2
    while h:
        a, b = acc[:, :h], acc[:, h : 2 * h]
        acc = torch.maximum(a, b) if terngrad else a + b
        h //= 2
    total = acc[:, 0]
    return total if terngrad else torch.sqrt(total)


def _check_scheme(scheme: str) -> bool:
    if scheme not in ("qsgd", "terngrad"):
        raise ValueError(f"scheme must be 'qsgd' or 'terngrad', got {scheme!r}")
    return scheme == "terngrad"


def _seed_tensor(seeds: Seeds, n_leaves: int, device) -> torch.Tensor:
    if isinstance(seeds, FoldedSeeds):  # the device form's seeds, read on the host
        seeds = list(seeds)
    s = torch.as_tensor(seeds, dtype=torch.int64, device=device).reshape(-1)
    if s.shape[0] != n_leaves:
        raise ValueError(f"need {n_leaves} seeds, got {s.shape[0]}")
    return s


def quantize_pack_plain(
    x: torch.Tensor,
    *,
    bits: int,
    bucket_size: int = 512,
    scheme: str = "qsgd",
    seeds: Optional[Seeds] = None,
    u: Optional[torch.Tensor] = None,
):
    """Plain twin of :func:`quantize_pack`."""
    terngrad = _check_scheme(scheme)
    x2, squeeze = _as_leaves(x)
    g = geometry(x2.shape[1], bits, bucket_size)
    n_leaves = x2.shape[0]
    planar = _bucket_planar(_leaf_rows(x2.float(), g), g)
    scale = _bucket_scales(planar, g, terngrad)
    safe = torch.clamp_min(scale, _F32_TINY)
    if u is not None:
        up = _bucket_planar(u.reshape(-1, g.bucket_size).float(), g)
    elif seeds is not None:
        up = philox_uniforms(_seed_tensor(seeds, n_leaves, x2.device), g)
    else:
        raise ValueError("quantize_pack needs seeds (in-kernel generator) or u")
    y = planar.abs() / safe[:, None, None] * g.levels
    lo = torch.floor(y)
    frac = y - lo
    level = torch.clamp(lo + (up < frac).float(), 0, g.levels).to(torch.int64)
    sign = (planar < 0).to(torch.int64)
    words = _or_fields((sign << bits) | level, g.bpv)
    words = words.view(n_leaves, g.n_buckets, g.n_words)
    scales = scale.view(n_leaves, g.n_buckets)
    return (words[0], scales[0]) if squeeze else (words, scales)


def quantize_pack_tree_plain(
    leaves: Sequence[torch.Tensor],
    *,
    bits: int,
    bucket_size: int = 512,
    scheme: str = "qsgd",
    seeds: Optional[Sequence[int]] = None,
    u: Optional[Sequence[torch.Tensor]] = None,
) -> list:
    """Plain twin of :func:`quantize_pack_tree`: each leaf encoded alone."""
    _check_tree_args(leaves, seeds, u)
    return [
        quantize_pack_plain(
            x, bits=bits, bucket_size=bucket_size, scheme=scheme,
            seeds=None if u is not None else [seeds[i]],
            u=None if u is None else u[i],
        )
        for i, x in enumerate(leaves)
    ]


def _check_tree_args(leaves, seeds, u) -> None:
    if u is None and seeds is None:
        raise ValueError("quantize_pack needs seeds (in-kernel generator) or u")
    for name, per_leaf in (("seeds", seeds), ("u", u)):
        if per_leaf is not None and len(per_leaf) != len(leaves):
            raise ValueError(f"need {len(leaves)} {name}, got {len(per_leaf)}")


def unpack_dequantize_plain(
    words: torch.Tensor,
    scales: torch.Tensor,
    *,
    bits: int,
    bucket_size: int = 512,
    n: int,
) -> torch.Tensor:
    """Plain twin of :func:`unpack_dequantize`."""
    g = geometry(n, bits, bucket_size)
    squeeze = scales.dim() == 1
    codes = _split_fields(words.reshape(-1, g.n_words), g)
    level = (codes & g.levels).to(torch.float32)
    sign = 1.0 - 2.0 * ((codes >> bits) & 1).to(torch.float32)
    step = float(np.float32(1.0 / g.levels)) * scales.reshape(-1)[:, None, None]
    vals = sign * level * step
    vals = vals.reshape(-1, g.bucket_p)[:, :bucket_size]
    out = vals.reshape(-1, g.n_buckets * bucket_size)[:, :n]
    return out[0] if squeeze else out


def leaf_dims(shape: Sequence[int], transpose: bool = True) -> Optional[tuple]:
    """How the tree decode lays out a leaf of port ``shape``: (A, B, C) where
    the JAX layout (A, B, C) becomes the port's (C, B, A), or None where the
    two lie alike. A conv OIHW weight is (H*W, I, O) in the JAX layout (HWIO),
    a linear (out, in) weight (1, in, out); vectors, and any leaf with
    ``transpose`` False (an embedding table), are None
    (:func:`atomo_tpu_torch.convert.jax_view` in index form)."""
    if transpose and len(shape) == 4:
        o, i, h, w = shape
        return (h * w, i, o)
    if transpose and len(shape) == 2:
        o, i = shape
        return (1, i, o)
    return None


def to_port_layout(flat: torch.Tensor, shape: Sequence[int], transpose: bool = True):
    """A leaf's (n,) values in the JAX layout -> contiguous port ``shape``."""
    dims = leaf_dims(shape, transpose)
    if dims is None:
        return flat.reshape(shape).contiguous()
    return flat.view(dims).permute(2, 1, 0).contiguous().view(shape)


def replica_mean(vals: torch.Tensor, divisor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, n) -> (n,): the replicas summed in order 0..N-1 in float32, then
    divided by N, the order of the tree kernel (one replica is itself).
    ``divisor`` (a 0-d float32 tensor on the values' device: the survivor
    mode's max(kept, 1)) divides in place of N."""
    acc = vals[0]
    for r in range(1, vals.shape[0]):
        acc = acc + vals[r]
    if divisor is not None:
        return acc / divisor.to(acc.dtype).expand_as(acc)
    if vals.shape[0] == 1:
        return acc
    # a tensor divisor: on CUDA, torch multiplies by the reciprocal of a
    # Python scalar divisor, which is not the division for every N
    return acc / torch.full_like(acc, vals.shape[0])


def survivor_divisor(replica_ok: Optional[torch.Tensor]) -> torch.Tensor:
    """The survivor mode's divisor: max(kept, 1), kept the flags of the (N,)
    ``replica_ok`` above 0, as a 0-d float32 tensor on its device (no host
    read)."""
    _check_survivor(True, replica_ok)
    return torch.clamp((replica_ok > 0).sum().to(torch.float32), min=1.0)


def tree_layouts(outs_like: Sequence[torch.Tensor], layouts) -> tuple:
    """One flag per leaf for :func:`leaf_dims`: ``layouts`` as bools, or
    True for every leaf when it is None."""
    if layouts is None:
        return (True,) * len(outs_like)
    if len(layouts) != len(outs_like):
        raise ValueError(f"need {len(outs_like)} layouts, got {len(layouts)}")
    return tuple(bool(v) for v in layouts)


def _rest_contiguous(t: torch.Tensor) -> bool:
    """Whether ``t`` without its leading axis lies contiguous."""
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def replica_stride(t: torch.Tensor, inner: int, n_replicas: int) -> int:
    """Elements between the replicas of a payload field of ``n_replicas``
    replicas of ``inner`` elements: ``inner`` for a contiguous field (the
    replicas one after another), the leading axis' stride for a view with a
    leading replica axis over a contiguous rest (a field of a gathered
    buffer); -1 for another size or layout, which the kernels do not take."""
    if t.numel() != n_replicas * inner:
        return -1
    if t.is_contiguous():
        return inner
    if t.dim() >= 2 and t.shape[0] == n_replicas and _rest_contiguous(t):
        return t.stride(0)
    return -1


def check_decode_args(payloads, outs_like, n_replicas: int, geoms) -> None:
    """The checks both decode paths make: one payload per float32 leaf, each
    of the size its geometry and ``n_replicas`` give."""
    if len(payloads) != len(outs_like):
        raise ValueError(f"need one payload per leaf: {len(payloads)} payloads, "
                         f"{len(outs_like)} leaves")
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be positive, got {n_replicas}")
    for i, ((w, s), like, g) in enumerate(zip(payloads, outs_like, geoms)):
        if like.dtype != torch.float32:
            raise TypeError(f"leaf {i} is {like.dtype}: the tree decode writes float32 leaves")
        if (w.numel() != n_replicas * g.n_buckets * g.n_words
                or s.numel() != n_replicas * g.n_buckets):
            raise ValueError(
                f"payload {i}: words {tuple(w.shape)} and scales {tuple(s.shape)} do not "
                f"hold {n_replicas} x {g.n_buckets} buckets of {g.n_words} words")


def mask_replica_rows(t: torch.Tensor, replica_ok: torch.Tensor) -> torch.Tensor:
    """``t`` (a payload field with a leading axis of N replicas) with the
    rows of every replica whose flag in the (N,) float32 ``replica_ok`` is
    not above 0 zeroed: the JAX package's ``_mask_gathered`` (``where``, not
    a product, which would keep NaN; a uint32 field through an int32 view)."""
    keep = (replica_ok > 0).reshape((replica_ok.shape[0],) + (1,) * (t.dim() - 1))
    if t.dtype == torch.uint32:
        return torch.where(keep, t.view(torch.int32), 0).view(torch.uint32)
    return torch.where(keep, t, torch.zeros((), dtype=t.dtype, device=t.device))


def mask_replicas(payloads: Sequence, replica_ok: torch.Tensor) -> list:
    """(words, scales) pairs with the flagged-out replicas' fields zeroed
    (:func:`mask_replica_rows`)."""
    n = replica_ok.shape[0]
    return [(mask_replica_rows(w.reshape((n,) + tuple(w.shape[-2:])), replica_ok),
             mask_replica_rows(sc.reshape(n, -1), replica_ok)) for w, sc in payloads]


def unpack_dequantize_tree_plain(
    payloads: Sequence,
    outs_like: Sequence[torch.Tensor],
    layouts: Optional[Sequence[bool]] = None,
    *,
    bits: int,
    bucket_size: int = 512,
    n_replicas: int = 1,
    replica_ok: Optional[torch.Tensor] = None,
    survivor: bool = False,
) -> list:
    """Plain twin of :func:`unpack_dequantize_tree`: each leaf decoded alone
    by :func:`unpack_dequantize_plain`, the replicas averaged by
    :func:`replica_mean`, then laid out as the port holds it. Takes the
    payloads the kernel takes, views of a gathered buffer included; with
    ``replica_ok`` the payloads are :func:`mask_replicas`'s first (the JAX
    package's masked decode), and ``survivor`` divides by
    :func:`survivor_divisor` (the JAX package's roster fold over the
    survivors, one division by the kept count)."""
    geoms = [geometry(like.numel(), bits, bucket_size) for like in outs_like]
    check_decode_args(payloads, outs_like, n_replicas, geoms)
    divisor = survivor_divisor(replica_ok) if survivor else None
    if replica_ok is not None:
        payloads = mask_replicas(payloads, replica_ok)
    out = []
    for (words, scales), like, tr, g in zip(payloads, outs_like,
                                            tree_layouts(outs_like, layouts), geoms):
        vals = unpack_dequantize_plain(
            words.reshape(n_replicas, g.n_buckets, g.n_words),
            scales.reshape(n_replicas, g.n_buckets),
            bits=bits, bucket_size=bucket_size, n=g.n,
        )
        out.append(to_port_layout(replica_mean(vals, divisor), like.shape, tr))
    return out


def _check_survivor(survivor: bool, replica_ok) -> None:
    if survivor and replica_ok is None:
        raise ValueError("the survivor mode divides by the flags above 0: pass replica_ok")


def unpack_bucketed_tree_plain(words_per_leaf: Sequence[torch.Tensor], *, bits: int):
    """Plain twin of :func:`unpack_bucketed_tree`, views of a gathered
    buffer included (each replica's rows in order)."""
    return torch.cat([unpack_bucketed_plain(w.reshape(-1, w.shape[-1]), bits)
                      for w in words_per_leaf])


def _check_pack_shape(bucket_p: int, g: Geometry) -> None:
    if bucket_p % g.vpw:
        raise ValueError(
            f"bucket_p {bucket_p} must be a multiple of vals-per-word {g.vpw} "
            "(pad with zero codes first)"
        )


def pack_bucketed_plain(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain twin of :func:`pack_bucketed`: (nb, bucket_p) codes ->
    (nb, bucket_p / vpw) uint32 words."""
    g = geometry(0, bits)
    nb, bucket_p = codes.shape
    _check_pack_shape(bucket_p, g)
    lanes = codes.to(torch.int64).view(nb, g.vpw, bucket_p // g.vpw)
    return _or_fields(lanes, g.bpv)


def _check_tree_rows(codes: torch.Tensor, rows: Sequence[int]) -> list:
    rows = [int(r) for r in rows]
    if codes.dim() != 2 or any(r < 0 for r in rows) or sum(rows) != codes.shape[0]:
        raise ValueError(f"rows {rows} do not split codes {tuple(codes.shape)} into leaves")
    return rows


def pack_bucketed_tree_plain(codes: torch.Tensor, rows: Sequence[int], *, bits: int) -> list:
    """Plain twin of :func:`pack_bucketed_tree`: the tree's rows packed in
    one call, then split into leaves."""
    rows = _check_tree_rows(codes, rows)
    return list(pack_bucketed_plain(codes, bits).split(rows))


def unpack_bucketed_plain(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain twin of :func:`unpack_bucketed`: (nb, wpb) words ->
    (nb, wpb * vpw) int32 codes."""
    g = geometry(0, bits)
    g = g._replace(n_words=words.shape[1])
    return _split_fields(words, g).reshape(words.shape[0], -1).to(torch.int32)


# ------------------------------------------------------------- CUDA wrappers


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if not getattr(lib, "_qsgd_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qsgd_quantize_pack.argtypes = [p, p, p, p, p, p, i, p, p, i, i, i, i, i, p]
        lib.qsgd_unpack_dequantize_tree.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p,
                                                    p, i]
        lib.qsgd_pack_codes_tree.argtypes = [p, p, i, i, i, p]
        lib.qsgd_unpack_codes_tree.argtypes = [p, p, p, p, i, p, i, i, p]
        for fn in (lib.qsgd_quantize_pack, lib.qsgd_unpack_dequantize_tree,
                   lib.qsgd_pack_codes_tree, lib.qsgd_unpack_codes_tree):
            fn.restype = ctypes.c_int
        lib._qsgd_typed = True
    return lib


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain twin); anything else is refused."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors must share one device, got {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no QSGD kernel for device {dev}")


def _require(t: torch.Tensor, name: str, dtypes, shape) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_if(rc: int, fn: str) -> None:
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


_MAX_LEAVES = 256  # table entries of one launch (csrc/qsgd_kernels.cu kMaxLeaves)


class _TreeLayout(NamedTuple):
    """Where a tree's leaves go in the flat output, as the kernel takes it."""

    n_buckets: tuple  # per leaf
    rows: int
    ns: ctypes.Array  # per leaf, long long
    row0: ctypes.Array  # first row of each leaf and the total, int


@functools.lru_cache(maxsize=64)
def _tree_layout(ns: tuple, bits: int, bucket_size: int) -> _TreeLayout:
    n_buckets = tuple(geometry(n, bits, bucket_size).n_buckets for n in ns)
    row0 = np.concatenate([[0], np.cumsum(n_buckets, dtype=np.int64)])
    if row0[-1] >= 1 << 31:
        raise ValueError(f"{row0[-1]} buckets do not fit the kernel's int32 rows")
    return _TreeLayout(n_buckets, int(row0[-1]), (ctypes.c_longlong * len(ns))(*ns),
                       (ctypes.c_int * (len(ns) + 1))(*row0.tolist()))


def _key_args(seeds, n_leaves: int, device):
    """(seeds or fold indices as ints, device key or None) of a launch:
    :class:`FoldedSeeds` give their indices and key (the device form)."""
    if isinstance(seeds, FoldedSeeds):
        key = seeds.key
        if key.device != device:
            raise ValueError(f"the seeds' key lies on {key.device}, the leaves on {device}")
        seeds, key = list(seeds.idxs), key
    else:
        key = None
        seeds = [int(v) for v in (seeds.tolist() if torch.is_tensor(seeds) else seeds)]
    if len(seeds) != n_leaves:
        raise ValueError(f"need {n_leaves} seeds, got {len(seeds)}")
    return seeds, key


def _launch_quantize_pack(xs, us, seeds, layout, *, bits, bucket_size, terngrad, device,
                          key=None):
    """Launch the tree kernel over leaves at the data pointers ``xs`` (and
    uniforms ``us``, 0 for Philox keyed on ``seeds``, or with a 0-d int64
    device ``key`` on ``fold_in(key, seeds[l])``) laid out as ``layout``;
    returns the flat (rows, n_words) words as uint32 and (rows,) scales."""
    g = geometry(0, bits, bucket_size)
    n_leaves = len(xs)
    words = torch.empty((layout.rows, g.n_words), dtype=torch.int32, device=device)
    scales = torch.empty((layout.rows,), dtype=torch.float32, device=device)
    vp = ctypes.c_void_p
    rc = _lib().qsgd_quantize_pack(
        (vp * n_leaves)(*xs), (vp * n_leaves)(*us),
        None if seeds is None else (ctypes.c_ulonglong * n_leaves)(
            *(int(v) & 0xFFFFFFFFFFFFFFFF for v in seeds)), _ptr(key),
        layout.ns, layout.row0, n_leaves, _ptr(words), _ptr(scales), bucket_size,
        g.n_words, bits, int(terngrad), block_threads(g.n_words), _stream(),
    )
    _raise_if(rc, "qsgd_quantize_pack")
    quantize_pack.launches += -(-n_leaves // _MAX_LEAVES)
    return words.view(torch.uint32), scales


def quantize_pack(
    x: torch.Tensor,
    *,
    bits: int,
    bucket_size: int = 512,
    scheme: str = "qsgd",
    seeds: Optional[Seeds] = None,
    u: Optional[torch.Tensor] = None,
):
    """Fused QSGD encode of x, (n,) or (L, n) float32 ->
    (words (…, n_buckets, n_words) uint32, scales (…, n_buckets) float32).

    ``u`` (…, n_buckets, bucket_size) supplies the stochastic-rounding
    uniforms (bit-parity mode); otherwise ``seeds`` (one per leaf) key the
    in-kernel Philox generator, by value or, as
    :class:`~atomo_tpu_torch.utils.rng.FoldedSeeds`, read from device memory
    (the same draws). The tree kernel over the L rows: one launch for up to
    256 of them."""
    if not _on_card(x, u):
        return quantize_pack_plain(
            x, bits=bits, bucket_size=bucket_size, scheme=scheme, seeds=seeds, u=u
        )
    terngrad = _check_scheme(scheme)
    x2, squeeze = _as_leaves(x)
    n_leaves, n = x2.shape
    g = geometry(n, bits, bucket_size)
    _require(x2, "x", (torch.float32,), (n_leaves, n))
    if u is not None:
        lead = () if squeeze else (n_leaves,)
        _require(u, "u", (torch.float32,), lead + (g.n_buckets, bucket_size))
        us = [u.data_ptr() + 4 * i * g.n_buckets * bucket_size for i in range(n_leaves)]
        seeds = None
        key = None
    elif seeds is not None:
        seeds, key = _key_args(seeds, n_leaves, x2.device)
        us = [0] * n_leaves
    else:
        raise ValueError("quantize_pack needs seeds (in-kernel generator) or u")
    xs = [x2.data_ptr() + 4 * i * n for i in range(n_leaves)]
    words, scales = _launch_quantize_pack(
        xs, us, seeds, _tree_layout((n,) * n_leaves, bits, bucket_size), bits=bits,
        bucket_size=bucket_size, terngrad=terngrad, device=x2.device, key=key,
    )
    words = words.view(n_leaves, g.n_buckets, g.n_words)
    scales = scales.view(n_leaves, g.n_buckets)
    return (words[0], scales[0]) if squeeze else (words, scales)


def quantize_pack_tree(
    leaves: Sequence[torch.Tensor],
    *,
    bits: int,
    bucket_size: int = 512,
    scheme: str = "qsgd",
    seeds: Optional[Seeds] = None,
    u: Optional[Sequence[torch.Tensor]] = None,
) -> list:
    """Fused QSGD encode of every leaf of a tree in one launch: ``leaves``
    are 1-D float32 tensors of any lengths -> one (words (n_buckets,
    n_words) uint32, scales (n_buckets,) float32) pair per leaf, views into
    one flat buffer each. ``seeds`` (one int per leaf) key the in-kernel
    Philox generator unless ``u`` (one (n_buckets, bucket_size) tensor per
    leaf) gives the uniforms. The seeds ride in the kernel's arguments: the
    call copies nothing to the device and never waits for it. Given as
    :class:`~atomo_tpu_torch.utils.rng.FoldedSeeds`, the kernel reads their
    key from device memory and folds each leaf's index in (the device form
    that a CUDA graph replays; the same draws)."""
    if not leaves:
        return []
    if not _on_card(*leaves, *(u or ())):
        return quantize_pack_tree_plain(leaves, bits=bits, bucket_size=bucket_size,
                                        scheme=scheme, seeds=seeds, u=u)
    terngrad = _check_scheme(scheme)
    _check_tree_args(leaves, seeds, u)
    key = None
    if u is None:
        seeds, key = _key_args(seeds, len(leaves), leaves[0].device)
    layout = _tree_layout(tuple(x.numel() for x in leaves), bits, bucket_size)
    for i, x in enumerate(leaves):
        if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
            _require(x, f"leaf {i}", (torch.float32,), (x.numel(),))
        if u is not None and (u[i].shape != (layout.n_buckets[i], bucket_size)
                              or u[i].dtype != torch.float32 or not u[i].is_contiguous()):
            _require(u[i], f"u[{i}]", (torch.float32,), (layout.n_buckets[i], bucket_size))
    words, scales = _launch_quantize_pack(
        [x.data_ptr() for x in leaves],
        [0] * len(leaves) if u is None else [t.data_ptr() for t in u],
        None if u is not None else seeds, layout, bits=bits, bucket_size=bucket_size,
        terngrad=terngrad, device=leaves[0].device, key=key,
    )
    return list(zip(words.split(layout.n_buckets), scales.split(layout.n_buckets)))


class _DecodeLayout(NamedTuple):
    """The static half of a tree decode's leaf table, cached by the tree's
    shapes, layouts and geometry; each call patches in the pointers."""

    geoms: tuple  # per leaf Geometry
    views: tuple  # per leaf (shape, contiguous strides, first value in the buffer)
    n_words: tuple  # per leaf, words of one replica's payload
    total: int
    ns: ctypes.Array  # per leaf, int
    dims: ctypes.Array  # per leaf (A, B, C), A = 0 for a flat leaf; int
    offsets: ctypes.Array  # per leaf, its first value in the buffer; long long


@functools.lru_cache(maxsize=64)
def _decode_layout(shapes: tuple, layouts: tuple, bits: int, bucket_size: int,
                   pad: bool) -> _DecodeLayout:
    geoms = tuple(geometry(int(np.prod(s, dtype=np.int64)), bits, bucket_size) for s in shapes)
    if any(g.n >= 1 << 31 for g in geoms):
        raise ValueError("a leaf of 2^31 values or more does not fit the kernel's int32 positions")
    # each leaf starts on 16 bytes, so that a transposed leaf's rows may
    # take 16-byte stores
    sizes = tuple(-(-g.n // 4) * 4 if pad else g.n for g in geoms)
    offsets = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).tolist()
    dims = [leaf_dims(s, tr) or (0, 0, 0) for s, tr in zip(shapes, layouts)]
    n = len(shapes)
    strides = [tuple(np.cumprod((1,) + tuple(s[:0:-1]), dtype=np.int64)[::-1].tolist())
               if len(s) else () for s in shapes]
    return _DecodeLayout(
        geoms, tuple(zip(shapes, strides, offsets)),
        tuple(g.n_buckets * g.n_words for g in geoms), offsets[-1],
        (ctypes.c_int * n)(*(g.n for g in geoms)),
        (ctypes.c_int * (3 * n))(*(d for t in dims for d in t)),
        (ctypes.c_longlong * n)(*offsets[:-1]),
    )


def _launch_unpack_dequantize(words, scales, wstrides, sstrides, out, layout, *, bits,
                              bucket_size, n_replicas, replica_ok=None, survivor=False):
    """Launch the tree decode over leaves whose words and scales lie at the
    data pointers ``words`` and ``scales``, replica r's ``r * wstrides[l]``
    words and ``r * sstrides[l]`` scales on, into ``out`` laid out as
    ``layout``; ``replica_ok`` (device pointer to N float32 flags, or None)
    leaves the flagged-out replicas out, and ``survivor`` divides by
    max(kept, 1) in place of N."""
    n_leaves = len(words)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    rc = _lib().qsgd_unpack_dequantize_tree(
        (vp * n_leaves)(*words), (vp * n_leaves)(*scales), (ll * n_leaves)(*wstrides),
        (ll * n_leaves)(*sstrides), _ptr(out), layout.offsets,
        layout.ns, layout.dims, n_leaves, bucket_size, layout.geoms[0].n_words, bits,
        n_replicas, _stream(), _ptr(replica_ok), int(bool(survivor)),
    )
    _raise_if(rc, "qsgd_unpack_dequantize_tree")
    unpack_dequantize.launches += -(-n_leaves // _MAX_LEAVES)
    if survivor:
        unpack_dequantize.survivor_launches += -(-n_leaves // _MAX_LEAVES)


def unpack_dequantize_tree(
    payloads: Sequence,
    outs_like: Sequence[torch.Tensor],
    layouts: Optional[Sequence[bool]] = None,
    *,
    bits: int,
    bucket_size: int = 512,
    n_replicas: int = 1,
    replica_ok: Optional[torch.Tensor] = None,
    survivor: bool = False,
) -> list:
    """Fused QSGD decode of a whole tree in one launch: ``payloads`` holds
    one (words, scales) pair per leaf, words (n_buckets, n_words) uint32 and
    scales (n_buckets,) float32, each with a leading axis of ``n_replicas``
    when that is above one (any leading axis of that size is taken): the
    replicas one after another, or at any stride, as the rows of a gathered
    buffer lie (:func:`replica_stride`), read in place. Leaf i
    comes back shaped like ``outs_like[i]`` (float32, port layout: conv
    OIHW, linear (out, in); ``layouts[i]`` False keeps the JAX layout, as for
    an embedding table), contiguous, a view into one buffer; over replicas
    it is their mean, summed in order and divided by ``n_replicas``. The
    leaf table rides in the kernel's arguments: no copy to the device and
    no host sync.

    ``replica_ok`` (the guard's flags: an (n_replicas,) float32 tensor on
    the payloads' device, or None) leaves out every replica whose flag is
    not above 0: the kernel adds ``0.0f`` at its place in the replica order
    and never reads its words or scales, which is the arithmetic of the JAX
    package's ``where(ok, payload, 0)`` followed by the decode, bit for bit
    (a zeroed payload decodes to +0.0, so a partial sum of -0.0 becomes
    +0.0 there too). None launches as before.

    ``survivor`` (with ``replica_ok``) is the survivor mode of the elastic
    operator (``atomo_tpu/elastic/shrink.py:102-167``): the kernel counts
    the flags above 0 itself and divides each sum by max(kept, 1) in place
    of ``n_replicas``, so the divisor never leaves the card. With every
    flag up it is the flagged form's division, bit for bit."""
    if not payloads:
        return []
    w0 = payloads[0][0]
    if replica_ok is not None and (replica_ok.dtype != torch.float32
                                   or tuple(replica_ok.shape) != (n_replicas,)):
        raise ValueError(f"replica_ok must be ({n_replicas},) float32, got "
                         f"{tuple(replica_ok.shape)} {replica_ok.dtype}")
    _check_survivor(survivor, replica_ok)
    if not _on_card(w0):
        _on_card(*(t for p in payloads for t in p))  # refuses a mix of devices
        return unpack_dequantize_tree_plain(payloads, outs_like, layouts, bits=bits,
                                            bucket_size=bucket_size, n_replicas=n_replicas,
                                            replica_ok=replica_ok, survivor=survivor)
    if replica_ok is not None:
        _on_card(w0, replica_ok)  # the flags on the payloads' card
        replica_ok = replica_ok.contiguous()
    layout = _decode_layout(tuple(g.shape for g in outs_like),
                            tree_layouts(outs_like, layouts), bits, bucket_size, True)
    if len(payloads) != len(outs_like) or n_replicas < 1:
        check_decode_args(payloads, outs_like, n_replicas, layout.geoms)
    # the host work of every step: one pass of cheap checks, the pointers
    dev, f32, u32, i32 = w0.get_device(), torch.float32, torch.uint32, torch.int32
    word_ptrs, scale_ptrs, wstrides, sstrides = [], [], [], []
    for (w, s), like, nw, g in zip(payloads, outs_like, layout.n_words, layout.geoms):
        ws, ss = replica_stride(w, nw, n_replicas), replica_stride(s, g.n_buckets, n_replicas)
        if (like.dtype is not f32 or s.dtype is not f32
                or (w.dtype is not u32 and w.dtype is not i32)
                or w.get_device() != dev or s.get_device() != dev or ws < 0 or ss < 0):
            _refuse_decode(payloads, outs_like, n_replicas, layout.geoms)
        word_ptrs.append(w.data_ptr())
        scale_ptrs.append(s.data_ptr())
        wstrides.append(ws)
        sstrides.append(ss)
    out = torch.empty((layout.total,), dtype=f32, device=w0.device)
    _launch_unpack_dequantize(word_ptrs, scale_ptrs, wstrides, sstrides, out, layout,
                              bits=bits, bucket_size=bucket_size, n_replicas=n_replicas,
                              replica_ok=replica_ok, survivor=survivor)
    return [out.as_strided(shape, stride, offset) for shape, stride, offset in layout.views]


def _refuse_decode(payloads, outs_like, n_replicas, geoms):
    """Raise what is wrong with a tree decode's arguments."""
    _on_card(*(t for p in payloads for t in p))
    check_decode_args(payloads, outs_like, n_replicas, geoms)
    for i, ((w, s), g) in enumerate(zip(payloads, geoms)):
        if w.dtype not in (torch.uint32, torch.int32) or s.dtype != torch.float32:
            raise TypeError(f"payload {i}: words must be uint32 or int32 and scales "
                            f"float32, got {w.dtype} and {s.dtype}")
        if (replica_stride(w, g.n_buckets * g.n_words, n_replicas) < 0
                or replica_stride(s, g.n_buckets, n_replicas) < 0):
            raise ValueError(f"payload {i}: each replica's words and scales must lie "
                             "contiguous (the field contiguous, or a leading replica axis "
                             "over a contiguous rest)")
    raise ValueError("unpack_dequantize_tree: payloads the kernel cannot take")


def unpack_dequantize(
    words: torch.Tensor,
    scales: torch.Tensor,
    *,
    bits: int,
    bucket_size: int = 512,
    n: int,
) -> torch.Tensor:
    """Fused QSGD decode: words (…, n_buckets, n_words), scales
    (…, n_buckets) -> float32 (…, n). The tree kernel over the L rows as
    flat leaves: one launch for up to 256 of them."""
    if not _on_card(words, scales):
        return unpack_dequantize_plain(
            words, scales, bits=bits, bucket_size=bucket_size, n=n
        )
    g = geometry(n, bits, bucket_size)
    squeeze = scales.dim() == 1
    n_leaves = 1 if squeeze else scales.shape[0]
    lead = () if squeeze else (n_leaves,)
    _require(scales, "scales", (torch.float32,), lead + (g.n_buckets,))
    _require(words, "words", (torch.uint32, torch.int32),
             lead + (g.n_buckets, g.n_words))
    out = torch.empty((n_leaves, n), dtype=torch.float32, device=words.device)
    if n_leaves:
        layout = _decode_layout(((n,),) * n_leaves, (False,) * n_leaves, bits, bucket_size,
                                False)
        wb, sb = words.data_ptr(), scales.data_ptr()
        _launch_unpack_dequantize(
            [wb + 4 * i * g.n_buckets * g.n_words for i in range(n_leaves)],
            [sb + 4 * i * g.n_buckets for i in range(n_leaves)],
            [g.n_buckets * g.n_words] * n_leaves, [g.n_buckets] * n_leaves, out, layout,
            bits=bits, bucket_size=bucket_size, n_replicas=1,
        )
    return out[0] if squeeze else out


def pack_words(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """One launch of the pack kernel over checked (rows, bucket_p) codes on
    the card -> (rows, bucket_p / vpw) uint32 words."""
    g = geometry(0, bits)
    rows, bucket_p = codes.shape
    words = torch.empty((rows, bucket_p // g.vpw), dtype=torch.int32, device=codes.device)
    if rows:
        rc = _lib().qsgd_pack_codes_tree(_ptr(codes), _ptr(words), rows, bucket_p // g.vpw,
                                         bits, _stream())
        _raise_if(rc, "qsgd_pack_codes_tree")
        pack_bucketed.launches += 1
    return words.view(torch.uint32)


def pack_bucketed_tree(codes: torch.Tensor, rows: Sequence[int], *, bits: int) -> list:
    """Bit-pack the codes of a whole tree in one launch: codes (total_rows,
    bucket_p) int32, the leaves' rows one after another (the layout
    :func:`unpack_bucketed_tree` returns), ``rows[i]`` of them for leaf i ->
    one (rows[i], bucket_p / vpw) uint32 words tensor per leaf, views into
    one buffer. The kernel sees one buffer, so it takes any number of leaves
    in one launch and needs no leaf table."""
    rows = _check_tree_rows(codes, rows)
    _check_pack_shape(codes.shape[1], geometry(0, bits))
    _require(codes, "codes", (torch.int32, torch.uint32), codes.shape)
    if not _on_card(codes):
        return pack_bucketed_tree_plain(codes, rows, bits=bits)
    if codes.shape[0] >= 1 << 31:
        raise ValueError(f"{codes.shape[0]} rows do not fit the kernel's int32 rows")
    return list(pack_words(codes, bits).split(rows))


def pack_bucketed(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Bucketed bit-pack: (nb, bucket_p) int32 codes -> (nb, bucket_p / vpw)
    uint32 words, planar layout; the tree kernel over one leaf."""
    return pack_bucketed_tree(codes, codes.shape[:1], bits=bits)[0]


@functools.lru_cache(maxsize=64)
def _row0(rows: tuple) -> ctypes.Array:
    row0 = np.concatenate([[0], np.cumsum(rows, dtype=np.int64)])
    if row0[-1] >= 1 << 31:
        raise ValueError(f"{row0[-1]} rows do not fit the kernel's int32 rows")
    return (ctypes.c_int * len(row0))(*row0.tolist())


def unpack_bucketed_tree(words_per_leaf: Sequence[torch.Tensor], *, bits: int) -> torch.Tensor:
    """Bit-unpack the words of a whole tree in one launch: each leaf's words
    (…, n_words) uint32, all of one n_words, any leading axes (a replica
    axis included) folded into rows -> one (rows, n_words * vpw) int32
    tensor, the leaves' rows one after another. A leaf's words may be
    contiguous, or an (N, n_buckets, n_words) view whose replicas lie at any
    stride (the rows of a gathered buffer), read in place."""
    g = geometry(0, bits)
    if not words_per_leaf:
        raise ValueError("unpack_bucketed_tree needs at least one leaf")
    if not _on_card(*words_per_leaf):
        return unpack_bucketed_tree_plain(words_per_leaf, bits=bits)
    n_words = words_per_leaf[0].shape[-1]
    rows, nbs, strides = [], [], []
    for i, w in enumerate(words_per_leaf):
        if w.dim() < 1 or w.shape[-1] != n_words or w.dtype not in (torch.uint32, torch.int32):
            _require(w, f"words[{i}]", (torch.uint32, torch.int32), (w.numel() // n_words,
                                                                    n_words))
        if w.is_contiguous():
            nb, stride = w.numel() // n_words, w.numel()
        else:  # replicas of (nb, n_words) at a stride
            nb = w[0].numel() // n_words if w.dim() == 3 else 0
            stride = replica_stride(w, nb * n_words, w.shape[0]) if nb else -1
            if stride < 0:
                raise ValueError(f"words[{i}] {tuple(w.shape)} with strides {w.stride()}: "
                                 "each replica's (n_buckets, n_words) must lie contiguous")
        rows.append(w.numel() // n_words)
        nbs.append(nb)
        strides.append(stride)
    row0 = _row0(tuple(rows))
    ptrs = [w.data_ptr() for w in words_per_leaf]
    codes = torch.empty((row0[len(rows)], n_words * g.vpw), dtype=torch.int32,
                        device=words_per_leaf[0].device)
    n_leaves = len(ptrs)
    rc = _lib().qsgd_unpack_codes_tree(
        (ctypes.c_void_p * n_leaves)(*ptrs), (ctypes.c_longlong * n_leaves)(*strides),
        (ctypes.c_int * n_leaves)(*nbs), row0, n_leaves, _ptr(codes), n_words, bits,
        _stream(),
    )
    _raise_if(rc, "qsgd_unpack_codes_tree")
    unpack_bucketed.launches += -(-n_leaves // _MAX_LEAVES)
    return codes


def unpack_bucketed(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bucketed`: (nb, wpb) words -> (nb, wpb * vpw)
    int32 codes; the tree kernel over one leaf."""
    if not _on_card(words):
        return unpack_bucketed_plain(words, bits)
    nb, n_words = words.shape
    _require(words, "words", (torch.uint32, torch.int32), (nb, n_words))
    return unpack_bucketed_tree([words], bits=bits)


KERNELS = (quantize_pack, unpack_dequantize, pack_bucketed, unpack_bucketed)
for _fn in KERNELS:
    _fn.launches = 0
# row 2's launches in its survivor mode, counted in unpack_dequantize.launches
# too: the survivor form's own entry in a report
unpack_dequantize.survivor_launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    unpack_dequantize.survivor_launches = 0
