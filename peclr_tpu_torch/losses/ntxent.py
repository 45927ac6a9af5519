"""NT-Xent contrastive loss (port of peclr_tpu/losses/ntxent.py).

For 2N L2-normalized projections the positive similarity is
exp(<z1_i, z2_i>/τ) and the denominator sums all 2N−1 off-diagonal
similarities of a row; loss = −mean log(pos/neg).  Computed in float32.

Across data-parallel ranks the negatives span the global batch, as in the
reference's global-view step: each rank gathers every rank's projections
(parallel/collectives.py) and computes the same global loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from peclr_tpu_torch.parallel.collectives import all_gather
from peclr_tpu_torch.parallel.mesh import Mesh


def ntxent_loss(z1: torch.Tensor, z2: torch.Tensor,
                temperature: float = 0.5,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """z1, z2 (N, D) L2-normalized projections of the two views -> the
    scalar loss over the 2N batch.  With a mesh, z1 and z2 are this rank's
    rows and the loss is over every rank's, gathered in rank order (the
    global order under parallel/mesh.py:shard_batch)."""
    if mesh is not None:
        d = z1.shape[1]
        z = all_gather(torch.cat([z1, z2], dim=1).float(), mesh)
        z1, z2 = z[:, :d], z[:, d:]
    z = torch.cat([z1, z2], dim=0).float()
    sim = torch.exp(z @ z.T / temperature)
    # off-diagonal sum per row: subtract the diagonal exactly
    neg = sim.sum(dim=-1) - torch.diagonal(sim)
    pos = torch.exp((z1.float() * z2.float()).sum(dim=-1) / temperature)
    pos = torch.cat([pos, pos], dim=0)
    return -torch.mean(torch.log(pos / neg))
