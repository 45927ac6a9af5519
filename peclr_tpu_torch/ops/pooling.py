"""The ResNet stem pool (port of peclr_tpu/ops/pooling.py, forward only)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_3x3s2p1(x: torch.Tensor) -> torch.Tensor:
    """max_pool(window 3x3, stride 2, padding 1) over NCHW."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
