"""Camera-space helpers (port of peclr_tpu/geometry/camera.py)."""

from __future__ import annotations

import torch

from peclr_tpu_torch.geometry.joints import WRIST


def move_palm_to_wrist(joints3d: torch.Tensor,
                       middle_mcp_index: int = 3) -> torch.Tensor:
    """Inverse of palm regression at inference: wrist = 2*palm - middle_mcp
    (index 3 is middle_mcp in ait order).  Returns a new tensor."""
    wrist = (2.0 * joints3d[..., WRIST, :]
             - joints3d[..., middle_mcp_index, :])
    return torch.cat(
        [joints3d[..., :WRIST, :], wrist.unsqueeze(-2),
         joints3d[..., WRIST + 1:, :]],
        dim=-2,
    )
