"""Image normalisation (port of peclr_tpu/ops/image.py:24-25, :186-189)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images_01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images (..., 3), channels last -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=images_01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=images_01.device)
    return (images_01 - mean) / std
