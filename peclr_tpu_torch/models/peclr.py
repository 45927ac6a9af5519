"""PeCLR / SimCLR pretraining model: ResNet encoder + projection MLP (port
of peclr_tpu/models/peclr.py).

The equivariant transforms and NT-Xent are functions (losses/); the train
step composes them.  Both contrastive views go through the encoder as one
batch, concatenated along the batch axis.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from peclr_tpu_torch.models.heads import ProjectionHead
from peclr_tpu_torch.models.resnet import ResNetEncoder


class PeCLRModel(nn.Module):
    """forward(images (B, H, W, 3) float, channels last as in the
    reference) -> dict(embedding (B, E), projection (B, D)), both float32.

    State-dict keys are the reference checkpoint's: `encoder.features.N.*`
    and `projection_head.{0,1,3}.*` (models/port.py)."""

    def __init__(self, resnet_size: str = "50", projection_hidden_dim: int = 512,
                 projection_dim: int = 128):
        super().__init__()
        self.resnet_size = resnet_size
        self.encoder = ResNetEncoder(resnet_size)
        self.projection_head = ProjectionHead(
            self.encoder.embed_dim, projection_hidden_dim, projection_dim)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        embedding = self.encoder(images.permute(0, 3, 1, 2))
        return {"embedding": embedding,
                "projection": self.projection_head(embedding)}
