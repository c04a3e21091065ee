"""ATOMO's SVD codec: atomic sparsification on the singular-value basis.

Counterpart of ``atomo_tpu/codecs/svd.py``, with the same wire format,
samplers, algorithms and byte counts. The codec has no kernel: its encode is
Gram products, ``eigh``, a Halko sketch orthonormalized by CholeskyQR2, and
triangular solves, which here are torch ops (cuBLAS/cuSOLVER on the card).
Every leaf of one shape group resizes to the same (m, n), so
:meth:`SvdCodec.encode_stack` runs the linear algebra batched over the L
leaves of the group: ``torch.linalg.eigh``, ``cholesky_ex`` (no host sync on
its ``info``) and ``solve_triangular`` on (L, ., .) stacks. On the card
``eigh`` still reads its convergence flag on the host, once per call.

Random draws. Leaf ``l`` draws from its seed ``seeds[l]`` (the port's
``fold_in(key, i)``), split three ways (``svd.py:523``): the sampler's key,
the sketch's key, the wire's key; ``fixed_k`` splits the sampler's key again
into the categorical's and the probes' (``svd.py:583``). The draws are
torch's from those keys, not JAX's. ``draws=`` is the parity hook that takes
the draws JAX made instead, stacked over the group's leaves:

* ``"sketch"``: the Gaussian sketch, (L, n, rank + oversample);
* ``"gumbel"``: the Gumbel noise behind ``jax.random.categorical``, (L, k, r)
  (the categorical is ``argmax(logits + gumbel, -1)``);
* ``"probes"``: the Rademacher probes, (L, n, residual_probes);
* ``"keep"``: the uniforms behind ``jax.random.bernoulli`` (keep = u < p),
  (L, r) for ``bernoulli``, (L, max(1, max_redraws), r) for
  ``bernoulli_budget`` (draw t of the bounded redraw chain in row t);
* ``"wire_u"``, ``"wire_vt"``: the 16 random low bits of the bf16 wire's
  stochastic rounding, integers shaped like ``u`` and ``vt``.

SVD parity is by reconstruction, not factor by factor: eigenvector signs and
the order of near-equal eigenvalues are free (``svd.py:48-53``), so the tests
compare ``u @ diag(c) @ vt`` and decoded leaves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from atomo_tpu_torch.codecs.dense import DensePayload
from atomo_tpu_torch.utils.rng import fold_in, generator, split3

_F32 = torch.finfo(torch.float32)


class SvdPayload(NamedTuple):
    """Fixed-shape wire format: ``k`` sampled (and rescaled) atoms."""

    u: torch.Tensor  # (..., m, k) sampled left singular vectors
    coeff: torch.Tensor  # (..., k) importance-sampling coefficients
    vt: torch.Tensor  # (..., k, n) sampled right singular vectors


class SvdMaskedPayload(NamedTuple):
    """Full-width masked factors (reference-faithful Bernoulli mode)."""

    u: torch.Tensor  # (..., m, r)
    s: torch.Tensor  # (..., r) masked + 1/p rescaled singular values
    vt: torch.Tensor  # (..., r, n)


def _square_dims(total: int, cap: int) -> tuple[int, int]:
    """Near-square power-of-two matricization, capped at ``cap``: m from the
    two powers of two bracketing sqrt(total), whichever minimizes the rank-k
    payload factor m + ceil(total/m)."""
    if total <= 1:
        return 1, 1
    lo = 1 << int(math.floor(math.log2(math.sqrt(total))))
    candidates = [min(lo, cap), min(lo * 2, cap)]
    m = min(candidates, key=lambda c: c + -(-total // c))
    return m, -(-total // m)


def _reference_dims(shape: tuple[int, ...]) -> tuple[int, int]:
    """The matrix shape of ``resize_to_2d(policy="reference")``."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        n = shape[0]
        return (n + n % 2) // 2, 2
    if len(shape) == 2:
        return shape
    a, b = shape[0], shape[1]
    rest = math.prod(shape[2:])
    if (a * b) % 2 == 0:
        return a * b // 2, 2 * rest
    return a * b, rest


def matrix_dims(shape: Sequence[int], policy: str = "square",
                max_min_dim: int = 512) -> tuple[int, int]:
    """(m, n) of a leaf of ``shape`` under :func:`resize_to_2d`."""
    shape = tuple(int(d) for d in shape)
    if policy == "square":
        return _square_dims(math.prod(shape), max_min_dim)
    if policy != "reference":
        raise ValueError(f"unknown resize policy {policy!r}")
    return _reference_dims(shape)


def resize_to_2d(x: torch.Tensor, policy: str = "reference", max_min_dim: int = 512):
    """Reshape a gradient to 2-D for SVD; returns (matrix, original_shape,
    pad), ``pad`` being the zeros appended to the flattened tensor.

    ``"reference"``: 0-d -> (1, 1); 1-D (n,) -> (n/2, 2), an odd n padded by
    one zero; 2-D unchanged; (a, b, *c) -> (a*b/2, 2*prod(c)) when a*b is
    even, else (a*b, prod(c)). ``"square"``: flattened and zero-padded to
    the near-square (m, ceil(total/m)) of :func:`_square_dims`. Both are
    row-major reshapes of the flattened tensor, padded at the end."""
    shape = tuple(x.shape)
    m, n = matrix_dims(shape, policy, max_min_dim)
    pad = m * n - x.numel()
    flat = x.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(m, n), shape, pad


def undo_resize(mat: torch.Tensor, orig_shape: tuple[int, ...], pad: int) -> torch.Tensor:
    """Inverse of :func:`resize_to_2d`."""
    flat = mat.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(orig_shape)


def stochastic_round(x: torch.Tensor, low_bits: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 with E[result] == x, given 16 random low bits per
    value (integers in [0, 65536)): add them to the float32 pattern, then
    keep its bfloat16 prefix. Within a binade the mantissa grid is uniform,
    so the chance of rounding up is the fractional position between the two
    neighbours; a carry out of the mantissa lands on the next binade's first
    value, the right upper neighbour."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    out = (bits + low_bits.to(torch.int64)) & 0xFFFF0000
    out = torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
    return out.view(torch.float32).to(torch.bfloat16)


def _s_floor(s: torch.Tensor) -> torch.Tensor:
    """Divisor floor eps * s_max + tiny for factor rows recovered as
    (basis^T @ mat) / s; s sorted descending along its last axis."""
    return torch.maximum(s, _F32.eps * s[..., :1] + _F32.tiny)


def _safe_probs(s: torch.Tensor) -> torch.Tensor:
    """q_i = s_i / sum(s), uniform for an all-zero spectrum."""
    total = s.sum(dim=-1, keepdim=True)
    uniform = torch.full_like(s, 1.0 / s.shape[-1])
    return torch.where(total > 0, s / torch.where(total > 0, total, 1.0), uniform)


def bernoulli_probs(s: torch.Tensor, rank: int) -> torch.Tensor:
    """Reference keep-probabilities: rank 0 -> s_i / s_0; rank >= 1 ->
    clip(rank * s_i / sum(s), 0, 1)."""
    if rank == 0:
        p = s / torch.clamp_min(s[..., :1], _F32.tiny)
    else:
        p = rank * s / torch.clamp_min(s.sum(dim=-1, keepdim=True), _F32.tiny)
    return torch.clamp(p, 0.0, 1.0)


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, as ``jax.random.gumbel``: -log(-log(u)) with u
    uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=device).clamp_min(_F32.tiny)
    return -torch.log(-torch.log(u))


class _Draws:
    """The random numbers of one ``encode_stack`` call: taken from the
    parity hook when it is given, else drawn leaf by leaf from a
    ``torch.Generator`` seeded with that leaf's key."""

    def __init__(self, given: Optional[dict], device):
        self.given, self.device = given, device

    def __call__(self, name: str, keys: Sequence[int],
                 make: Callable[[torch.Generator], torch.Tensor]) -> torch.Tensor:
        if self.given is not None:
            return self.given[name].to(self.device)
        return torch.stack([make(generator(k, self.device)) for k in keys])


def _take_cols(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (L, m, r), idx (L, k) -> (L, m, k): per leaf, columns idx."""
    return a.gather(2, idx[:, None, :].expand(a.shape[0], a.shape[1], idx.shape[1]))


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (L, r, n), idx (L, k) -> (L, k, n): per leaf, rows idx."""
    return a.gather(1, idx[:, :, None].expand(a.shape[0], idx.shape[1], a.shape[2]))


@dataclasses.dataclass(frozen=True)
class SvdCodec:
    """Atomic sparsification with a fixed atom budget (static wire shape).

    The fields and their defaults are the JAX codec's: ``sample`` one of
    fixed_k | bernoulli_budget | bernoulli | topk; ``reshape`` square |
    reference; ``algorithm`` auto | exact | gram | randomized (auto: the
    Halko sketch when min(m, n) >= ``auto_min_dim``, gram otherwise, gram
    always for the Bernoulli samplers); ``wire_dtype`` float32 | bfloat16
    (stochastically rounded factors). Leaves too small for SVD to beat dense
    ship as a :class:`DensePayload`."""

    rank: int = 3
    sample: str = "fixed_k"
    reshape: str = "square"
    max_min_dim: int = 512
    algorithm: str = "auto"
    oversample: int = 8
    power_iters: int = 1
    residual_probes: int = 2
    auto_min_dim: int = 64
    budget_slack: int = 4
    max_redraws: int = 4
    wire_dtype: str = "float32"
    name: str = "svd"

    # -- static, shape-only decisions ---------------------------------------
    def _dims(self, shape: Sequence[int]) -> tuple[int, int]:
        return matrix_dims(shape, self.reshape, self.max_min_dim)

    def _algorithm_for(self, m: int, n: int) -> str:
        if self.algorithm != "auto":
            return self.algorithm
        if self.sample in ("bernoulli", "bernoulli_budget"):
            return "gram"
        return "randomized" if min(m, n) >= self.auto_min_dim else "gram"

    def _payload_k(self, r_full: int) -> int:
        """Static atom-slot count of the wire payload for this sampler."""
        if self.rank <= 0:
            return r_full
        if self.sample == "bernoulli_budget":
            return min(self.rank + self.budget_slack, r_full)
        return min(self.rank, r_full)

    def _n_probes(self, m: int, n: int) -> int:
        """Residual-probe atoms of a sketched fixed_k payload."""
        if self.sample != "fixed_k" or self.residual_probes <= 0:
            return 0
        if self._algorithm_for(m, n) != "randomized":
            return 0
        return self.residual_probes

    def _dense_fallback(self, grad_shape: Sequence[int]) -> bool:
        if self.sample == "bernoulli":
            return False  # full-width payload by design
        total = math.prod(grad_shape)
        m, n = self._dims(grad_shape)
        k = self._payload_k(min(m, n)) + self._n_probes(m, n)
        return k * (m + n + 1) >= total

    def leaf_payload_bytes(self, grad_shape: Sequence[int]) -> int:
        """Wire bytes of one leaf's payload, priced from its shape alone."""
        shape = tuple(int(d) for d in grad_shape)
        total = math.prod(shape)
        if self._dense_fallback(shape):
            return total * 4  # exact DensePayload, f32 values
        m, n = self._dims(shape)
        wire = 2 if self.wire_dtype == "bfloat16" else 4
        if self.sample == "bernoulli":
            r = min(m, n)
            return (m * r + r * n) * wire + r * 4
        k = self._payload_k(min(m, n)) + self._n_probes(m, n)
        return (m * k + k * n) * wire + k * 4

    # -- linear algebra, batched over the leading axis ------------------------
    @staticmethod
    def _orthonormalize(y: torch.Tensor, passes: int = 2) -> torch.Tensor:
        """CholeskyQR orthonormalization of tall-skinny blocks (L, m, k): per
        pass one Gram product, a Cholesky and a triangular solve. The jitter
        10 * eps * trace(G) keeps the Cholesky definite; ``tiny`` is added
        outside the product, so a zero block gives q = 0, not NaN."""
        k = y.shape[-1]
        eye = torch.eye(k, dtype=y.dtype, device=y.device)
        for _ in range(passes):
            g = y.mT @ y
            trace = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
            jitter = 10.0 * _F32.eps * trace + _F32.tiny
            el, _ = torch.linalg.cholesky_ex(g + jitter[..., None, None] * eye)
            # y <- y @ el^{-T}: solve x @ el^T = y
            y = torch.linalg.solve_triangular(el.mT, y, upper=True, left=False)
        return y

    @staticmethod
    def _gram_svd(mat: torch.Tensor):
        """Full spectrum from the eigh of the smaller Gram matrix; the
        reconstruction u @ diag(s) @ vt is exact to float32 rounding even
        where the small singular values are squared away."""
        m, n = mat.shape[-2:]
        if m <= n:
            w, u = torch.linalg.eigh(mat @ mat.mT)  # ascending
            w, u = w.flip(-1), u.flip(-1)
            s = torch.sqrt(torch.clamp_min(w, 0.0))
            vt = (u.mT @ mat) / _s_floor(s)[..., :, None]
            return u, s, vt
        w, v = torch.linalg.eigh(mat.mT @ mat)
        w, v = w.flip(-1), v.flip(-1)
        s = torch.sqrt(torch.clamp_min(w, 0.0))
        u = (mat @ v) / _s_floor(s)[..., None, :]
        return u, s, v.mT

    def _svd(self, mat: torch.Tensor, sketch: Callable[[int], torch.Tensor]):
        """Thin SVD of each (m, n) matrix of the stack: "exact"
        (``torch.linalg.svd``), "gram", or "randomized" (the Halko sketch of
        rank + oversample columns, ``power_iters`` power iterations, and the
        eigh of the sliver's (k, k) Gram); ``sketch(k)`` gives the Gaussian
        test matrices (L, n, k)."""
        m, n = mat.shape[-2:]
        algorithm = self._algorithm_for(m, n)
        if algorithm == "exact":
            return torch.linalg.svd(mat, full_matrices=False)
        if algorithm == "gram":
            return self._gram_svd(mat)
        if algorithm != "randomized":
            raise ValueError(f"unknown svd algorithm {self.algorithm!r}")
        q = self._orthonormalize(mat @ sketch(min(self.rank + self.oversample, min(m, n))))
        for _ in range(self.power_iters):
            z = self._orthonormalize(mat.mT @ q, passes=1)  # scale guard only
            q = self._orthonormalize(mat @ z)
        b = q.mT @ mat  # (L, sketch, n)
        w, ub = torch.linalg.eigh(b @ b.mT)
        w, ub = w.flip(-1), ub.flip(-1)
        s = torch.sqrt(torch.clamp_min(w, 0.0))
        vt = (ub.mT @ b) / _s_floor(s)[..., :, None]
        return q @ ub, s, vt

    # -- encode --------------------------------------------------------------
    def encode_stack(
        self,
        x: torch.Tensor,
        seeds: Sequence[int],
        draws: Optional[dict] = None,
        *,
        shape: Optional[Sequence[int]] = None,
    ):
        """Encode an (L, total) stack of flattened leaves of ``shape`` (the
        JAX layout; (total,) when omitted). Returns the payload with a
        leading L axis. ``draws`` is the parity hook (module docstring)."""
        x = x.to(torch.float32)
        n_leaves, total = x.shape
        shape = (total,) if shape is None else tuple(shape)
        if self._dense_fallback(shape):
            return DensePayload(values=x)
        m, n = self._dims(shape)
        pad = m * n - total
        mat = (torch.nn.functional.pad(x, (0, pad)) if pad else x).reshape(n_leaves, m, n)
        dev = x.device
        keys = [split3(s) for s in seeds]  # (sampler, sketch, wire)
        pick = _Draws(draws, dev)
        u, s, vt = self._svd(mat, lambda k: pick(
            "sketch", [kk[1] for kk in keys],
            lambda g: torch.randn((n, k), generator=g, device=dev)))
        r_full = s.shape[-1]  # randomized: only the sketched triplets exist
        tiny = _F32.tiny

        if self.sample == "bernoulli":
            p = bernoulli_probs(s, self.rank)
            keep = (pick("keep", [kk[0] for kk in keys],
                         lambda g: torch.rand((r_full,), generator=g, device=dev)) < p)
            s_hat = torch.where(p > 0, s * keep / torch.clamp_min(p, tiny), 0.0)
            return self._narrow_payload(pick, keys, SvdMaskedPayload(u=u, s=s_hat, vt=vt))

        if self.sample == "bernoulli_budget":
            # keep atom i with p_i = min(1, rank*s_i/sum(s)), rescaled 1/p_i,
            # packed into k_max slots (coeff 0 marks an empty one); a keep-set
            # over k_max is redrawn, at most max_redraws draws in all, the
            # last one then truncated to its top-s atoms
            k_max = self._payload_k(r_full)
            p = bernoulli_probs(s, self.rank)
            n_draws = max(1, self.max_redraws)
            keeps = pick("keep", [kk[0] for kk in keys],
                         lambda g: torch.rand((n_draws, r_full), generator=g,
                                              device=dev)) < p[:, None, :]
            fits = keeps.sum(dim=-1) <= k_max  # (L, n_draws)
            first = torch.where(fits.any(dim=-1), fits.to(torch.int8).argmax(dim=-1),
                                n_draws - 1)
            keep = keeps[torch.arange(n_leaves, device=dev), first]  # (L, r)
            order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
            idx = order[:, :k_max]
            valid = keep.gather(1, idx)
            coeff = torch.where(
                valid, s.gather(1, idx) / torch.clamp_min(p.gather(1, idx), tiny), 0.0)
            return self._narrow_payload(pick, keys, SvdPayload(
                u=_take_cols(u, idx), coeff=coeff, vt=_take_rows(vt, idx)))

        k = min(self.rank, r_full) if self.rank > 0 else r_full
        if self.sample == "topk":
            # deterministic top-k (biased; the reference master's path)
            return self._narrow_payload(pick, keys, SvdPayload(
                u=u[:, :, :k], coeff=s[:, :k], vt=vt[:, :k, :]))
        if self.sample != "fixed_k":
            raise ValueError(f"unknown sample mode {self.sample!r}")

        # fixed_k: k atoms with replacement, atom i with probability q_i
        q = _safe_probs(s)
        logits = torch.log(torch.clamp_min(q, tiny))
        gumbel = pick("gumbel", [fold_in(kk[0], 0) for kk in keys],
                      lambda g: _gumbel((k, r_full), g, dev))
        idx = torch.argmax(logits[:, None, :] + gumbel, dim=-1)  # (L, k)
        coeff = s.gather(1, idx) / (k * torch.clamp_min(q.gather(1, idx), tiny))
        # all-zero gradient: s[idx] == 0 -> coeff 0, decode gives exact zeros
        u_k, c_k, vt_k = _take_cols(u, idx), coeff, _take_rows(vt, idx)
        n_probes = self._n_probes(m, n)
        if n_probes:
            # residual probes ((1/p) * R w_j, w_j), Rademacher w_j, restore
            # in expectation the residual R = mat - u u^T mat the sketch drops
            w = pick("probes", [fold_in(kk[0], 1) for kk in keys],
                     lambda g: (torch.randint(0, 2, (n, n_probes), generator=g, device=dev)
                                * 2 - 1).to(torch.float32))
            xw = mat @ w  # (L, m, p)
            rw = xw - u @ (u.mT @ xw)
            u_k = torch.cat([u_k, rw], dim=2)
            c_k = torch.cat([c_k, torch.full((n_leaves, n_probes), 1.0 / n_probes,
                                             device=dev)], dim=1)
            vt_k = torch.cat([vt_k, w.mT], dim=1)
        return self._narrow_payload(pick, keys, SvdPayload(u=u_k, coeff=c_k, vt=vt_k))

    def _narrow_payload(self, pick: _Draws, keys, payload):
        """Apply the wire dtype: stochastically round the factors to bf16,
        independent draws for u and vt; the coefficients stay float32."""
        if self.wire_dtype == "float32":
            return payload
        if self.wire_dtype != "bfloat16":
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}")

        def bits(name, t, part):
            return pick(name, [fold_in(kk[2], part) for kk in keys],
                        lambda g: torch.randint(0, 1 << 16, t.shape[1:], generator=g,
                                                device=t.device))

        u, vt = payload.u, payload.vt
        return payload._replace(u=stochastic_round(u, bits("wire_u", u, 0)),
                                vt=stochastic_round(vt, bits("wire_vt", vt, 1)))

    def encode(self, seed: int, grad: torch.Tensor, draws: Optional[dict] = None):
        """Encode one leaf (in the JAX layout); ``draws`` without the L axis."""
        given = None if draws is None else {k: v[None] for k, v in draws.items()}
        p = self.encode_stack(grad.reshape(1, -1), [seed], given, shape=tuple(grad.shape))
        return type(p)(*(a[0] for a in p))

    # -- decode --------------------------------------------------------------
    @staticmethod
    def decode_matrix(payload) -> torch.Tensor:
        """U @ diag(c) @ Vt in float32 (bf16 wire factors cast up first)."""
        c = payload.s if isinstance(payload, SvdMaskedPayload) else payload.coeff
        return (payload.u.float() * c[..., None, :]) @ payload.vt.float()

    def decode_stack(self, payload, n: int, *, shape: Optional[Sequence[int]] = None):
        """(L, n) float32 values of a stacked payload."""
        if isinstance(payload, DensePayload):
            return payload.values.reshape(payload.values.shape[0], n)
        mat = self.decode_matrix(payload)
        return mat.reshape(mat.shape[0], -1)[:, :n]

    def decode(self, payload, grad_shape: Sequence[int]) -> torch.Tensor:
        """Reconstruct one leaf of ``grad_shape`` (JAX layout)."""
        n = math.prod(grad_shape)
        stacked = type(payload)(*(a[None] for a in payload))
        return self.decode_stack(stacked, n, shape=grad_shape)[0].reshape(tuple(grad_shape))

    def decode_mean_stack(self, gathered, n: int, n_replicas: int, *,
                          shape: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Fused mean of decodes for payloads with leading (L, N) axes, the
        stacked ``decode_mean`` of the JAX codec: the N rank-k factor blocks
        of a leaf are concatenated and its mean is ONE (m, N*k) @ (N*k, n)
        product. Returns (L, n)."""
        if isinstance(gathered, DensePayload):
            return gathered.values.reshape(*gathered.values.shape[:2], n).mean(dim=1)
        c = gathered.s if isinstance(gathered, SvdMaskedPayload) else gathered.coeff
        u, vt = gathered.u.float(), gathered.vt.float()
        n_leaves, n_rep, m, k = u.shape
        u_cat = u.permute(0, 2, 1, 3).reshape(n_leaves, m, n_rep * k)
        scaled = u_cat * (c.reshape(n_leaves, n_rep * k) / n_replicas)[:, None, :]
        mat = scaled @ vt.reshape(n_leaves, n_rep * k, vt.shape[-1])
        return mat.reshape(n_leaves, -1)[:, :n]
