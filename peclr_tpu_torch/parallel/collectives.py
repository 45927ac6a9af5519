"""Collectives with autograd over a mesh's ranks.

A module of the port's own: the reference's step is one global-view jit,
and XLA inserts its collectives.  Both functions here are built on
`all_reduce` alone.  gloo runs only all_reduce and broadcast on CUDA
tensors, and gloo is what runs two ranks on one card (NCCL refuses them);
torch.distributed.nn.functional.all_gather's backward needs reduce-scatter
or all-to-all, which gloo lacks there.  At the recipe the tensors are small
(NT-Xent's gathered projections: 256 × 256 f32).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from peclr_tpu_torch.parallel.mesh import Mesh


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, size, group):
        ctx.rows, ctx.rank, ctx.group = x.shape[0], rank, group
        out = x.new_zeros((size * x.shape[0],) + tuple(x.shape[1:]))
        out[rank * x.shape[0]:(rank + 1) * x.shape[0]] = x
        dist.all_reduce(out, group=group)  # x + 0 is x: the gather is exact
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None, None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of x over the ranks, on every rank; the backward sums the
    gradient over the ranks too."""
    return _AllReduceSum.apply(x, mesh.group)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x (the same shape on each) stacked along dim 0 in rank
    order.  The backward sums the gradient over the ranks and keeps this
    rank's rows: with a loss that every rank computes alike from the
    gathered rows, each rank's gradient is then W times its rows' share,
    which DistributedDataParallel's mean over W turns into the global
    gradient."""
    return _AllGather.apply(x, mesh.rank, mesh.size, mesh.group)
