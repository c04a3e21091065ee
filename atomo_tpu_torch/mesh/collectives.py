"""The model-axis collectives over process groups, differentiable.

Counterpart of ``atomo_tpu/mesh/collectives.py:19-77``. Each takes the
axis's process group and size; at size 1 each is the identity. Where the
JAX package differentiates a collective (AD transposes ``psum`` into
``psum``, ``ppermute`` into the inverse permutation, ``all_to_all`` into
the inverse ``all_to_all``), the port writes the backward out:

* tp's psum is Megatron's pair, not the JAX transpose: :func:`copy_to`
  (identity forward, all-reduce backward) where a replicated activation
  enters a parallel region, :func:`reduce_from` (all-reduce forward,
  identity backward) where the region's partial sums leave it. Under the
  JAX transpose every tp shard's gradient comes out n_tp times the true
  one and is divided back (``atomo_tpu/parallel/common.py``'s
  ``complete_model_axis_grads(divide_by=)``); under the pair each shard's gradient is the true one and
  nothing is divided, so the two agree to float32 rounding, not bit for
  bit;
* :func:`pmax` carries no gradient (the JAX step takes it of a
  ``stop_gradient``);
* :func:`pipeline_hop` sends rank i's tensor to i+1 (mod n), the opposite
  rotation from ``parallel.common.ring_hop``; its backward sends the
  cotangent the other way, i+1 to i;
* :func:`all_to_all_tiled` splits ``split_axis`` over the n ranks (chunk j
  to rank j) and concatenates what arrives along ``concat_axis`` in source
  order; its backward is the inverse all-to-all.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from atomo_tpu_torch.parallel.common import _send_recv, all_to_all, ring_hop, ring_perm

__all__ = ["all_to_all_tiled", "copy_to", "pipeline_hop", "pipeline_hop_back",
           "pipeline_perm", "pmax", "psum", "reduce_from", "ring_hop", "ring_perm"]


def pipeline_perm(n: int) -> list[tuple[int, int]]:
    """The pipeline shift ``i -> i+1 (mod n)`` as (source, destination)
    pairs: stage i's activations move to stage i+1 each tick."""
    return [(i, (i + 1) % n) for i in range(n)]


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def psum(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over the axis, not differentiated (gradient completion,
    metrics)."""
    return x if n == 1 else _all_reduce(x, group)


def pmax(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The maximum over the axis, detached: it carries no gradient."""
    x = x.detach()
    return x if n == 1 else _all_reduce(x, group, dist.ReduceOp.MAX)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Megatron's entry to a parallel region: the identity forward, the
    all-reduce of the cotangent backward."""
    return x if n == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Megatron's exit from a parallel region: the all-reduce of the
    partial sums forward, the identity backward."""
    return x if n == 1 else _ReduceFrom.apply(x, group)


def pipeline_hop_back(grad: torch.Tensor, group, n: int) -> torch.Tensor:
    """The transpose of :func:`pipeline_hop`: rank i sends to i - 1 and
    receives from i + 1."""
    if n == 1:
        return grad
    i = dist.get_rank(group)
    return _send_recv(grad, group, (i - 1) % n, (i + 1) % n)


class _PipelineHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n: int):
        ctx.group, ctx.n = group, n
        i = dist.get_rank(group)
        return _send_recv(x, group, (i + 1) % n, (i - 1) % n)

    @staticmethod
    def backward(ctx, grad):
        return pipeline_hop_back(grad, ctx.group, ctx.n), None, None


def pipeline_hop(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """One pipeline tick over the ``n`` ranks of ``group``: rank i sends
    to i + 1 and receives from i - 1 (:func:`pipeline_perm`).
    Differentiable; the identity at ``n = 1``."""
    if n == 1:
        return x
    if group is None:
        raise ValueError(f"a pipeline of {n} stages needs their process group")
    return _PipelineHop.apply(x, group, n)


def all_to_all_tiled(x: torch.Tensor, group: Optional[object], n: int, *,
                     split_axis: int, concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all of ``jax.lax.all_to_all(..., tiled=True)``:
    ``x``'s ``split_axis`` cut into n chunks, chunk j to rank j, the chunks
    received concatenated along ``concat_axis`` in source-rank order.
    Differentiable; the identity at ``n = 1``."""
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all over {n} ranks: axis {split_axis} of "
                         f"{tuple(x.shape)} does not split")
    rows = all_to_all(torch.stack(x.chunk(n, dim=split_axis)), group, n)
    return torch.cat(rows.unbind(0), dim=concat_axis)
