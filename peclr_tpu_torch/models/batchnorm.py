"""BatchNorm with the reference's running statistics.

In train mode flax's BatchNorm normalises with the batch statistics and
updates its running variance with the *biased* batch variance, while
torch.nn.BatchNorm uses the unbiased one (n/(n-1) larger: 0.4% at the
projection head's 256 rows).  These subclasses keep torch's parameters,
buffers, state-dict keys and eval mode, and in train mode take the batch
statistics from the same fused F.batch_norm call (into scratch buffers at
momentum 1), then update the running buffers as flax does: momentum 0.1 in
torch terms, biased variance, eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

#: running-statistics momentum in torch terms (flax's 0.9)
MOMENTUM = 0.1


class _ReferenceStats:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
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


class BatchNorm1d(_ReferenceStats, nn.BatchNorm1d):
    """nn.BatchNorm1d whose train mode updates running stats as flax does."""


class BatchNorm2d(_ReferenceStats, nn.BatchNorm2d):
    """nn.BatchNorm2d whose train mode updates running stats as flax does."""
