"""Supervised 2.5D / 3D keypoint losses and EPE metrics (port of
peclr_tpu/losses/supervised.py).

Validity-weighted L1 with the 2D and relative-depth terms separated, a
lifted-3D MAE through the closed-form z-root, and mean/median end-point
error metrics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from peclr_tpu_torch.eval.metrics import median
from peclr_tpu_torch.geometry.camera import convert_2_5d_to_3d


def _weight(joints_valid: Optional[torch.Tensor],
            like: torch.Tensor) -> torch.Tensor:
    if joints_valid is None:
        joints_valid = torch.ones_like(like[..., -1:])
    return joints_valid / joints_valid.sum()


def l1_loss_25d(pred_joints: torch.Tensor, true_joints: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                joints_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validity-weighted L1 between 2.5D predictions and targets.

    pred/true: (B, 21, 3); scale: (B,); joints_valid: (B, 21, 1) or None.
    Returns (loss_2d, loss_z, loss_z_unscaled): the uv loss (averaged over
    its two coordinates), the scale-normalised z loss, and the z loss
    multiplied back to metric units."""
    weight = _weight(joints_valid, true_joints)
    abs_err = (pred_joints - true_joints).abs()
    loss_2d = (abs_err[..., :2] * weight).sum() / 2.0
    loss_z_elem = abs_err[..., 2:] * weight
    if scale is None:
        loss_z_unscaled = loss_z_elem.sum()
    else:
        loss_z_unscaled = (loss_z_elem * scale.reshape(-1, 1, 1)).sum()
    return loss_2d, loss_z_elem.sum(), loss_z_unscaled


def loss_3d(pred_25d: torch.Tensor, joints3d_gt: torch.Tensor,
            scale: torch.Tensor, K: torch.Tensor,
            joints_valid: Optional[torch.Tensor] = None,
            z_root: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Validity-weighted MAE between lifted 3D predictions and ground truth
    (per-coordinate sum / 3)."""
    pred_3d = convert_2_5d_to_3d(pred_25d, scale, K, z_root=z_root)
    weight = _weight(joints_valid, joints3d_gt)
    return ((pred_3d - joints3d_gt).abs() * weight).sum() / 3.0


def epe_metrics(y_pred: torch.Tensor, y_true: torch.Tensor,
                prefix: str = "train") -> Dict[str, torch.Tensor]:
    """Mean/median euclidean end-point error over all joints."""
    dist = torch.sqrt(((y_pred - y_true) ** 2).sum(dim=-1))
    return {f"EPE_mean_{prefix}": dist.mean(),
            f"EPE_median_{prefix}": median(dist)}
