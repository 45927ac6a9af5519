"""NT-Xent contrastive loss (port of peclr_tpu/losses/ntxent.py).

For 2N L2-normalized projections the positive similarity is
exp(<z1_i, z2_i>/τ) and the denominator sums all 2N−1 off-diagonal
similarities of a row; loss = −mean log(pos/neg).  Computed in float32.
"""

from __future__ import annotations

import torch


def ntxent_loss(z1: torch.Tensor, z2: torch.Tensor,
                temperature: float = 0.5) -> torch.Tensor:
    """z1, z2 (N, D) L2-normalized projections of the two views -> the
    scalar loss over the 2N batch."""
    z = torch.cat([z1, z2], dim=0).float()
    sim = torch.exp(z @ z.T / temperature)
    # off-diagonal sum per row: subtract the diagonal exactly
    neg = sim.sum(dim=-1) - torch.diagonal(sim)
    pos = torch.exp((z1.float() * z2.float()).sum(dim=-1) / temperature)
    pos = torch.cat([pos, pos], dim=0)
    return -torch.mean(torch.log(pos / neg))
