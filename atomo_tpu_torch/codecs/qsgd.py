"""QSGD / TernGrad codec: stochastic quantization with uint32 bit-packing.

Counterpart of ``atomo_tpu/codecs/qsgd.py``, with the same planar wire
format: per leaf, words (n_buckets, words_per_bucket) uint32 and scales
(n_buckets,) float32 (see :mod:`atomo_tpu_torch.ops.qsgd_kernels`).

Two interchangeable encode/decode paths share that format:

* the fused kernels (``use_kernel``): scale, stochastic rounding, coding and
  packing in one CUDA kernel, decode in another. ``use_kernel=None`` picks
  them for CUDA tensors; on CPU tensors ``use_kernel=True`` runs their plain
  twins, whose arithmetic is the Pallas kernels'. :meth:`QsgdCodec.encode_leaves`
  encodes a whole gradient tree with one launch of the encode kernel, its
  seeds in the launch's arguments, so the encode never waits for the card;
  :meth:`QsgdCodec.decode_leaves` decodes it with one launch of the decode
  kernel, straight into the port's layout;
* torch ops for the quantizer (the counterpart of the JAX codec's jnp path)
  with the bit-pack stage as the pack/unpack kernels (their plain versions
  run for CPU tensors). :meth:`QsgdCodec.encode_leaves` runs the quantizer
  once over the bucket rows of every leaf and packs them with one
  :func:`pack_bucketed_tree` call; the decode unpacks them with one
  :func:`unpack_bucketed_tree` call.

On a CUDA tensor every path runs kernels: ``pack_kernel=False`` (the JAX
codec's jnp pack) is refused there, since the plain versions serve the CPU
tests only; on a CPU tensor it is the plain pack, as every value is.

Uniforms: given (the bit-parity hook), they are used as they are; otherwise
the fused kernel draws them from its Philox generator keyed on the leaf
seed, and the torch quantizer from a ``torch.Generator`` seeded with it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from atomo_tpu_torch.ops import qsgd_kernels as K
from atomo_tpu_torch.ops.qsgd_kernels import (  # noqa: F401
    pack_bucketed,
    pack_bucketed_tree,
    padded_bucket,
    unpack_bucketed,
    unpack_bucketed_tree,
)
from atomo_tpu_torch.utils.rng import generator

_F32_TINY = float(np.finfo(np.float32).tiny)


class QsgdPayload(NamedTuple):
    words: torch.Tensor  # (…, n_buckets, words_per_bucket) uint32 packed codes
    scales: torch.Tensor  # (…, n_buckets) float32 per-bucket scale


@dataclasses.dataclass(frozen=True)
class QsgdCodec:
    """Stochastic b-bit quantization with per-bucket scaling.

    bits: magnitude bits; levels = 2^bits - 1 (``--quantization-level``).
    bucket_size: values per scale (``--bucket-size``, default 512).
    scheme: "qsgd" (L2-norm scale) or "terngrad" (max-norm scale after a
        2.5-sigma clip of the whole leaf).
    use_kernel: None = the fused kernels on CUDA tensors, the torch quantizer
        on CPU tensors; True/False force one path.
    pack_kernel: for the torch-quantizer path; None and True pack with the
        kernel wrappers (their plain versions for CPU tensors); False is
        accepted for CPU tensors only (the plain pack).
    """

    bits: int = 2
    bucket_size: int = 512
    scheme: str = "qsgd"
    use_kernel: Optional[bool] = None
    pack_kernel: Optional[bool] = None
    name: str = "qsgd"

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1

    def leaf_payload_bytes(self, grad_shape: tuple[int, ...]) -> int:
        """Wire bytes of one leaf: per bucket, its words and one scale."""
        g = K.geometry(int(np.prod(grad_shape, dtype=np.int64)), self.bits,
                       self.bucket_size)
        return g.n_buckets * (g.n_words * 4 + 4)

    def _fused(self, x: torch.Tensor) -> bool:
        return x.is_cuda if self.use_kernel is None else bool(self.use_kernel)

    def _check_pack(self, x: torch.Tensor) -> None:
        if x.is_cuda and self.pack_kernel is False:
            raise ValueError(
                "pack_kernel=False runs the plain pack, which serves CPU "
                "tensors only; on CUDA the codec packs with the kernel"
            )

    def _clip_leaf(self, x: torch.Tensor) -> torch.Tensor:
        """TernGrad's clip of one flat leaf at 2.5 sigma of the whole leaf
        (population std, as jnp.std); other schemes pass x through. Taken
        leaf by leaf in both encode paths, so that the tree launch and the
        per-group stacks see the same limit to the bit: a reduction over an
        (L, n) stack may sum in another order than over one leaf."""
        if self.scheme == "terngrad":
            limit = 2.5 * torch.std(x, correction=0)
            return torch.clamp(x, -limit, limit)
        return x

    def _clip(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`_clip_leaf` of each row of an (L, n) stack."""
        if self.scheme == "terngrad":
            return torch.stack([self._clip_leaf(row) for row in x])
        return x

    def encode_stack(
        self,
        x: torch.Tensor,
        seeds: Sequence[int],
        uniforms: Optional[torch.Tensor] = None,
        *,
        shape: Optional[Sequence[int]] = None,
    ) -> QsgdPayload:
        """Encode an (L, n) stack of flattened leaves; leaf l draws from
        ``seeds[l]`` unless ``uniforms`` (L, n_buckets, bucket_size) is given.
        The leaves' shape does not matter to the codec."""
        del shape
        x = self._clip(x.to(torch.float32))
        n_leaves, n = x.shape
        g = K.geometry(n, self.bits, self.bucket_size)
        if self._fused(x):
            words, scales = K.quantize_pack(
                x, bits=self.bits, bucket_size=self.bucket_size,
                scheme=self.scheme, seeds=None if uniforms is not None else seeds,
                u=uniforms,
            )
            return QsgdPayload(words=words, scales=scales)

        buckets = K._leaf_rows(x, g)  # (L * n_buckets, bucket_size)
        if uniforms is not None:
            # kept in their own type, so that float64 draws (the JAX
            # codec's under x64) compare with frac as they do there
            rnd = uniforms.reshape(buckets.shape)
        else:
            rnd = torch.cat([
                torch.rand((g.n_buckets, self.bucket_size), device=x.device,
                           generator=generator(s, x.device))
                for s in seeds
            ])
        codes, scales = self._quantize(buckets, rnd)
        self._check_pack(x)
        words = pack_bucketed(codes, self.bits)
        return QsgdPayload(
            words=words.view(n_leaves, g.n_buckets, g.n_words),
            scales=scales.view(n_leaves, g.n_buckets),
        )

    def _quantize(self, buckets: torch.Tensor, rnd: torch.Tensor):
        """The torch quantizer: (rows, bucket_size) float32 buckets and their
        uniforms -> per-row scales and (rows, bucket_p) int32 codes, zero
        past bucket_size."""
        if self.scheme == "terngrad":
            scales = buckets.abs().amax(dim=1)
        else:
            scales = torch.linalg.vector_norm(buckets, dim=1)
        safe = torch.clamp_min(scales, _F32_TINY)
        y = buckets.abs() / safe[:, None] * self.levels
        lo = torch.floor(y)
        frac = y - lo
        level = torch.clamp(lo + (rnd < frac).float(), 0, self.levels).to(torch.int32)
        sign = (buckets < 0).to(torch.int32)
        codes = torch.zeros((buckets.shape[0], padded_bucket(self.bucket_size, self.bits)),
                            dtype=torch.int32, device=buckets.device)
        codes[:, : self.bucket_size] = (sign << self.bits) | level
        return codes, scales

    def _encode_rows(self, leaves, seeds, uniforms) -> list[QsgdPayload]:
        """The torch-quantizer path over a tree of clipped 1-D leaves: their
        bucket rows in one buffer, each leaf's uniforms drawn into its slice
        of one buffer (or given), one quantizer pass over all rows and one
        :func:`pack_bucketed_tree` call; each payload is a view."""
        self._check_pack(leaves[0])
        dev, bs = leaves[0].device, self.bucket_size
        n_buckets = [K.geometry(x.numel(), self.bits, bs).n_buckets for x in leaves]
        buckets = K.tree_rows(leaves, bs)
        if uniforms is not None:
            rnd = torch.cat([u.reshape(-1, bs) for u in uniforms])
        else:
            rnd = torch.empty(buckets.shape, device=dev)
            for part, s in zip(rnd.split(n_buckets), seeds):
                part.uniform_(generator=generator(s, dev))  # torch.rand's draws
        codes, scales = self._quantize(buckets, rnd)
        words = pack_bucketed_tree(codes, n_buckets, bits=self.bits)
        return [QsgdPayload(words=w, scales=s) for w, s in zip(words, scales.split(n_buckets))]

    def encode_leaves(
        self,
        views: Sequence[torch.Tensor],
        seeds: Sequence[int],
        uniforms: Optional[Sequence[torch.Tensor]] = None,
    ) -> list[QsgdPayload]:
        """Encode every leaf of a tree (JAX-layout views of any shapes; leaf i
        draws from ``seeds[i]`` unless ``uniforms[i]`` is given). The fused
        path is one :func:`quantize_pack_tree` call (one launch on the card);
        the pack path one pass of the torch quantizer over the rows of every
        leaf and one :func:`pack_bucketed_tree` call (one launch). Each gives
        the per-shape-group stacks' payloads (``encode_groups``)."""
        leaves = [self._clip_leaf(v.reshape(-1).to(torch.float32)) for v in views]
        if not self._fused(leaves[0]):
            return self._encode_rows(leaves, seeds, uniforms)
        out = K.quantize_pack_tree(
            leaves, bits=self.bits, bucket_size=self.bucket_size, scheme=self.scheme,
            seeds=None if uniforms is not None else seeds, u=uniforms,
        )
        return [QsgdPayload(words=w, scales=s) for w, s in out]

    def decode_leaves(
        self,
        payloads: Sequence[QsgdPayload],
        grads_like: Sequence[torch.Tensor],
        layouts: Optional[Sequence[bool]] = None,
        n_replicas: int = 1,
    ) -> list[torch.Tensor]:
        """Decode every leaf of a tree straight into the port layout of
        ``grads_like`` (float32; ``layouts`` as for :func:`encode_tree`); with
        ``n_replicas`` above one each payload has that leading replica axis
        and the leaf is the mean of the replicas' decodes, summed in order.
        The replicas may lie one after another or, as the fields of a
        gathered (N, bytes) buffer do, at a stride: both kernels read them in
        place. The fused path is one :func:`unpack_dequantize_tree` call (one
        launch on the card); the pack path one :func:`unpack_bucketed_tree`
        call and one dequantization over the rows of every leaf."""
        if not payloads:
            return []
        if self._fused(payloads[0].words):
            # a QsgdPayload is the (words, scales) pair the wrapper takes
            return K.unpack_dequantize_tree(
                payloads, grads_like, layouts, bits=self.bits,
                bucket_size=self.bucket_size, n_replicas=n_replicas,
            )
        self._check_pack(payloads[0].words)
        geoms = [K.geometry(g.numel(), self.bits, self.bucket_size) for g in grads_like]
        K.check_decode_args(payloads, grads_like, n_replicas, geoms)
        codes = unpack_bucketed_tree([p.words for p in payloads], bits=self.bits)
        vals = self._dequantize(codes, torch.cat([p.scales.reshape(-1) for p in payloads]))
        layouts = K.tree_layouts(grads_like, layouts)
        out, row = [], 0
        for g, like, tr in zip(geoms, grads_like, layouts):
            rows = n_replicas * g.n_buckets
            leaf = vals[row: row + rows].reshape(n_replicas, -1)[:, : g.n]
            out.append(K.to_port_layout(K.replica_mean(leaf), like.shape, tr))
            row += rows
        return out

    def decode_stack(self, payload: QsgdPayload, n: int, *,
                     shape: Optional[Sequence[int]] = None) -> torch.Tensor:
        """(L, n) float32 values of a stacked payload."""
        del shape
        g = K.geometry(n, self.bits, self.bucket_size)
        if self._fused(payload.words):
            return K.unpack_dequantize(
                payload.words, payload.scales, bits=self.bits,
                bucket_size=self.bucket_size, n=n,
            )
        n_leaves = payload.scales.shape[0]
        self._check_pack(payload.words)
        codes = unpack_bucketed(payload.words.reshape(-1, g.n_words), self.bits)
        vals = self._dequantize(codes, payload.scales.reshape(-1))
        return vals.reshape(n_leaves, -1)[:, :n]

    def _dequantize(self, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
        """(rows, bucket_p) codes and (rows,) scales -> (rows, bucket_size)
        float32 values, in the JAX jnp path's association:
        ``sign * level / levels * scale``."""
        codes = codes[:, : self.bucket_size]
        level = (codes & self.levels).to(torch.float32)
        sign = 1.0 - 2.0 * ((codes >> self.bits) & 1).to(torch.float32)
        return sign * level / self.levels * scales[:, None]

    def encode(self, seed: int, grad: torch.Tensor,
               uniforms: Optional[torch.Tensor] = None) -> QsgdPayload:
        """Encode one leaf (flattened as it lies)."""
        u = None if uniforms is None else uniforms[None]
        p = self.encode_stack(grad.reshape(1, -1), [seed], u)
        return QsgdPayload(words=p.words[0], scales=p.scales[0])

    def decode(self, payload: QsgdPayload, grad_shape: tuple[int, ...]) -> torch.Tensor:
        n = int(np.prod(grad_shape, dtype=np.int64))
        stacked = QsgdPayload(words=payload.words[None], scales=payload.scales[None])
        return self.decode_stack(stacked, n)[0].reshape(grad_shape)


def terngrad(bucket_size: int = 512, use_kernel: Optional[bool] = None,
             pack_kernel: Optional[bool] = None) -> QsgdCodec:
    """TernGrad = 1-bit-magnitude QSGD with max-norm scale + sigma clip."""
    return QsgdCodec(
        bits=1, bucket_size=bucket_size, scheme="terngrad",
        use_kernel=use_kernel, pack_kernel=pack_kernel, name="terngrad",
    )
