"""BatchNorm with the reference's running statistics.

In train mode flax's BatchNorm normalises with the batch statistics and
updates its running variance with the *biased* batch variance, while
torch.nn.BatchNorm uses the unbiased one (n/(n-1) larger: 0.4% at the
projection head's 256 rows).  These subclasses keep torch's parameters,
buffers, state-dict keys and eval mode, and in train mode take the batch
statistics from the same fused F.batch_norm call (into scratch buffers at
momentum 1), then update the running buffers as flax does: momentum 0.1 in
torch terms, biased variance, eps 1e-5.

Across data-parallel ranks (`set_mesh`), train mode takes the statistics of
the global batch, as the reference's global-view step does: each call
all-reduces one packed tensor, the per-channel sums of x and x² and the
count, normalises with the global mean and flax's max(E[x²] - E[x]², 0),
and all-reduces the gradient's per-channel sums in its backward
(_GlobalBatchNorm).  The sums are f64 from the statistics kernel of
ops/batch_norm_act.py for a channels-last CUDA tensor (so that the
statistics are those of the path without a mesh, rounded once to f32),
else f32.  Eval mode, and the module without a mesh, are as above.

`batch_norm_act(bn, x, residual, relu)` is the ResNet trunk's BatchNorm,
then the optional residual add, then the optional ReLU.  For a CUDA tensor
laid out channels-last in train mode without a mesh it runs as four
hand-written CUDA passes (ops/batch_norm_act.py: statistics and running
statistics, the apply with the add and the ReLU, and the backward's reduce
and elementwise passes; _BatchNormAct); the module's own forward takes the
same path for such a tensor (the downsample's BatchNorm).  Everything else
(CPU tensors, eval mode, other layouts, a mesh) is the module's forward,
then the add, then torch.relu, as before.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from peclr_tpu_torch.ops import batch_norm_act as bnk

#: running-statistics momentum in torch terms (flax's 0.9)
MOMENTUM = 0.1


def _dims_and_shape(x: torch.Tensor):
    c = x.shape[1]
    return [0] + list(range(2, x.dim())), (1, c) + (1,) * (x.dim() - 2)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _local_moments(x: torch.Tensor) -> torch.Tensor:
    """This rank's per-channel sums of x and x² and its count, packed (2C +
    1,): f64 from the statistics kernel where it takes x (bnk.takes), else
    f32."""
    dims, _ = _dims_and_shape(x)
    n = x.numel() // x.shape[1]
    if bnk.takes(x):
        moments = bnk.batch_norm_moments(x)
        return torch.cat([moments.view(-1), moments.new_full((1,), n)])
    if x.is_cuda:
        # one fused pass (Welford); eps 0 keeps 1/invstd² the variance
        mean, invstd = torch.batch_norm_stats(x, 0.0)
        return torch.cat([mean, invstd.pow_(-2).addcmul_(mean, mean),
                          mean.new_ones(1)]).mul_(n)
    return torch.cat([
        x.sum(dims, dtype=torch.float32),
        torch.linalg.vector_norm(x, 2, dims, dtype=torch.float32).square(),
        x.new_full((1,), n, dtype=torch.float32)])


def _backward_sums(dy, x, mean, invstd, weight):
    """This rank's per-channel Σdy and Σdy·(x - mean), and its weight and
    bias gradients."""
    if x.is_cuda:
        return torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                True, True, True)
    dims, shape = _dims_and_shape(x)
    sum_dy = dy.sum(dims)
    sum_dy_xmu = (dy * (x - mean.view(shape))).sum(dims)
    return sum_dy, sum_dy_xmu, sum_dy_xmu * invstd, sum_dy


def _backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count):
    """dx from the global batch's Σdy and Σdy·(x - mean) over its count."""
    if x.is_cuda:
        return torch.batch_norm_backward_elemt(
            dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
            count.to(torch.int32).view(1))
    _, shape = _dims_and_shape(x)
    mean_dy = (sum_dy / count).view(shape)
    proj = (invstd * invstd * sum_dy_xmu / count).view(shape)
    return ((dy - mean_dy - (x - mean.view(shape)) * proj)
            * (invstd * weight).view(shape))


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of x (N, C, ...) with the statistics of every
    rank's batch: one all-reduce in the forward, one in the backward.

    forward: this rank's per-channel sums of x and x² and its count
    (_local_moments: f64 or f32), packed into one tensor and all-reduced;
    the global mean and flax's variance max(E[x²] - E[x]², 0) and
    1/sqrt(var + eps) in that type, then f32; x normalised with them
    (given the same statistics, the normalisation of the path without a
    mesh to the bit).  backward: this rank's per-channel Σdy and Σdy·(x -
    mean), packed and all-reduced, then dx from the global sums; the
    weight and bias gradients are this rank's (the data-parallel gradient
    all-reduce adds the ranks').  On the card
    these are the f64 sums of ops/batch_norm_act.py (or, for a tensor it
    does not take, the Welford statistics pass of torch's SyncBatchNorm)
    and SyncBatchNorm's fused normalisation and backward reduce and
    elementwise passes, so the device moves what the fused train-mode
    BatchNorm moves; on the CPU, the same formulas written out (and the
    eval-mode BatchNorm).  Saved: x in its own dtype and per-channel
    vectors."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        packed = _local_moments(x)
        dist.all_reduce(packed, group=group)
        count = packed[2 * c]
        moments = packed[:2 * c] / count
        mean = moments[:c]
        var = torch.addcmul(moments[c:], mean, mean, value=-1).clamp_min_(0.0)
        invstd = (var + eps).rsqrt_().float()
        mean, var = mean.float(), var.float()
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        out = (torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
               if x.is_cuda
               else F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps))
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c = x.shape[1]
        dy = dy.contiguous(memory_format=_memory_format(x))
        sum_dy, sum_dy_xmu, dw, db = _backward_sums(dy, x, mean, invstd,
                                                    weight)
        total = torch.cat([sum_dy, sum_dy_xmu]).float()
        dist.all_reduce(total, group=ctx.group)
        dx = _backward_elemt(dy, x, mean, invstd, weight, total[:c],
                             total[c:], count)
        return dx, dw, db, None, None


class _BatchNormAct(torch.autograd.Function):
    """Train-mode BatchNorm of x, then + residual (or None), then the ReLU
    (`relu`), with the running statistics updated as flax does, in the
    kernels of ops/batch_norm_act.py: two passes forward (statistics, then
    the apply), two backward (the sums, then dx and the residual's
    gradient).  Saved: x, the (2, C) statistics, and for a residual under a
    ReLU the output (whose mask the residual's gradient shares; the next
    convolution keeps it anyway); without a residual the mask is recomputed
    from x."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                num_batches_tracked, eps, relu):
        stats = bnk.batch_norm_stats(x, running_mean, running_var,
                                     num_batches_tracked, eps, MOMENTUM)
        out = bnk.batch_norm_apply(x, stats, weight, bias, residual, relu)
        ctx.mask = (bnk.NO_RELU if not relu else
                    bnk.RELU_FROM_Y if residual is not None else
                    bnk.RELU_FROM_X)
        ctx.residual = residual is not None
        ctx.save_for_backward(x, stats, weight, bias,
                              out if ctx.mask == bnk.RELU_FROM_Y else None)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, stats, weight, bias, out = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        sums = bnk.batch_norm_backward_reduce(dy, x, stats, weight, bias,
                                              ctx.mask, out)
        dx, dr = bnk.batch_norm_backward_elemt(dy, x, stats, weight, bias,
                                               sums, ctx.mask, out,
                                               ctx.residual)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                sums[bnk.GRAD_WEIGHT] if need[1] else None,
                sums[bnk.SUM_DY] if need[2] else None, dr,
                None, None, None, None, None)


def _fused(bn, x: torch.Tensor, residual: Optional[torch.Tensor]) -> bool:
    """Whether `bn` (a BatchNorm2d of this module) on x [+ residual] runs as
    the kernels of ops/batch_norm_act.py: train mode, no mesh, an affine
    BatchNorm with f32 parameters and running statistics, x a CUDA tensor
    they take (bnk.takes), the residual laid out as x."""
    return (bn.training and bn.mesh is None and bnk.takes(x)
            and bn.affine and bn.track_running_stats
            and bn.weight.dtype == torch.float32
            and bn.bias.dtype == torch.float32
            and bn.running_mean.dtype == torch.float32
            and bn.running_var.dtype == torch.float32
            and (residual is None
                 or (residual.shape == x.shape and residual.dtype == x.dtype
                     and residual.device == x.device
                     and residual.is_contiguous(
                         memory_format=torch.channels_last))))


def _fused_call(bn, x, residual, relu: bool) -> torch.Tensor:
    return _BatchNormAct.apply(x, bn.weight, bn.bias, residual,
                               bn.running_mean, bn.running_var,
                               bn.num_batches_tracked, bn.eps, relu)


def batch_norm_act(bn: nn.Module, x: torch.Tensor,
                   residual: Optional[torch.Tensor] = None,
                   relu: bool = True) -> torch.Tensor:
    """bn(x), then + residual (when given), then torch.relu (when `relu`):
    the kernels of ops/batch_norm_act.py where `_fused` holds, else those
    three steps as they are."""
    if isinstance(bn, _ReferenceStats) and _fused(bn, x, residual):
        bn._check_input_dim(x)
        return _fused_call(bn, x, residual, relu)
    out = bn(x)
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


class _ReferenceStats:
    #: the mesh whose ranks share the batch statistics (set_mesh), or None
    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if self.mesh is not None:
            return self._forward_across_ranks(x)
        if _fused(self, x, None):
            return _fused_call(self, x, None, False)
        # momentum 1 writes the batch mean and the unbiased batch variance
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, MOMENTUM)
            self.running_var.lerp_(var * ((n - 1) / n), MOMENTUM)
            self.num_batches_tracked.add_(1)
        return out

    def _forward_across_ranks(self, x: torch.Tensor) -> torch.Tensor:
        out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps, self.mesh.group)
        with torch.no_grad():
            torch._foreach_lerp_([self.running_mean, self.running_var],
                                 [mean, var], MOMENTUM)
            self.num_batches_tracked.add_(1)
        return out


def set_mesh(model: nn.Module, mesh) -> int:
    """Let every reference-statistics BatchNorm of `model` take its train
    statistics over `mesh`'s ranks (None: this process's batch alone).
    Returns how many there are."""
    count = 0
    for module in model.modules():
        if isinstance(module, _ReferenceStats):
            module.mesh = mesh
            count += 1
    return count


class BatchNorm1d(_ReferenceStats, nn.BatchNorm1d):
    """nn.BatchNorm1d whose train mode updates running stats as flax does."""


class BatchNorm2d(_ReferenceStats, nn.BatchNorm2d):
    """nn.BatchNorm2d whose train mode updates running stats as flax does."""
