"""Equivariant projection-space transforms, the core of PeCLR (port of
peclr_tpu/losses/equivariance.py:26-93).

The 128-d projection is read as 64 2-D points; the inverse of each sample's
crop translation and rotation is applied to it before the contrastive loss.
Translation is scaled by the detached per-sample x/y extent of the point
cloud; rotation is about the detached centroid, in the OpenCV convention.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from peclr_tpu_torch.geometry.affine import rotation_about_center


def rotate_projections(points: torch.Tensor,
                       angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotate (B, M, 2) point clouds by per-sample angles about their
    (detached) centroids."""
    center = points.mean(dim=1).detach()
    rot = rotation_about_center(angle_deg, center[:, 0], center[:, 1])
    hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.einsum("bij,bnj->bni", rot, hom)[..., :2]


def translate_projections(points: torch.Tensor, tx: torch.Tensor,
                          ty: torch.Tensor) -> torch.Tensor:
    """Shift x/y by the normalized jitter times the detached per-sample
    extent (max - min) of each axis."""
    ext = (points.amax(dim=1) - points.amin(dim=1)).detach()
    offset = torch.stack([tx * ext[:, 0], ty * ext[:, 1]], dim=-1)
    return points + offset[:, None, :]


def translate_projections_exact(points: torch.Tensor, tx: torch.Tensor,
                                ty: torch.Tensor) -> torch.Tensor:
    """Shift x/y by (tx, ty) as they are, not scaled by the extent (the
    reference's translate_encodings2)."""
    return points + torch.stack([tx, ty], dim=-1)[:, None, :]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(dim=-1, keepdim=True),
                                          eps))


def peclr_projections(
    proj1: torch.Tensor, proj2: torch.Tensor,
    params1: Dict[str, torch.Tensor], params2: Dict[str, torch.Tensor],
    image_size: Tuple[int, int] = (128, 128),
    augmentations: Sequence[str] = ("crop", "rotate"),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the inverse geometric transforms in projection space.

    proj1/proj2 (B, D) raw projections of the two views; params* hold
    'jitter_x', 'jitter_y' (pixels) and 'angle' (degrees), each (B,).
    L2-normalize -> (B, D/2, 2) -> translate by -jitter/image_size scaled
    by the extent -> rotate by -angle about the centroid -> flatten ->
    renormalize.  Returns (z1, z2) for NT-Xent."""
    b, d = proj1.shape
    h, w = image_size

    def one_view(proj, params):
        pts = _l2_normalize(proj).reshape(b, d // 2, 2)
        if "crop" in augmentations:
            # reference quirk kept: jitter_x is normalized by the HEIGHT
            # (image_size[0]) and jitter_y by the width
            pts = translate_projections(pts, -params["jitter_x"] / float(h),
                                        -params["jitter_y"] / float(w))
        if "rotate" in augmentations:
            pts = rotate_projections(pts, -params["angle"])
        return _l2_normalize(pts.reshape(b, d))

    return one_view(proj1, params1), one_view(proj2, params2)
