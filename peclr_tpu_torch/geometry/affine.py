"""Batched 2D affine helpers in the OpenCV pixel convention (port of
peclr_tpu/geometry/affine.py).

Points are column vectors [x, y, 1]^T and a matrix maps source pixel
coordinates to destination ones, `dst = A @ src`.
"""

from __future__ import annotations

import torch


def _f32(v, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _stack3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_matrix_2d(angle_deg, scale=1.0) -> torch.Tensor:
    """(..., 2, 2) rotation by `angle_deg` counter-clockwise in the math
    convention (clockwise on y-down image axes, as OpenCV)."""
    rad = torch.deg2rad(_f32(angle_deg))
    c, s = torch.cos(rad) * scale, torch.sin(rad) * scale
    return torch.stack([torch.stack([c, s], dim=-1),
                        torch.stack([-s, c], dim=-1)], dim=-2)


def rotation_about_center(angle_deg, center_x, center_y,
                          scale=1.0) -> torch.Tensor:
    """(..., 3, 3) homogeneous rotation about (center_x, center_y), as
    cv2.getRotationMatrix2D: [[a, b, (1-a)cx - b*cy], [-b, a, b*cx + (1-a)cy]]
    with a = cos·scale, b = sin·scale."""
    rad = torch.deg2rad(_f32(angle_deg))
    a = torch.cos(rad) * scale
    b = torch.sin(rad) * scale
    tx = (1.0 - a) * center_x - b * center_y
    ty = b * center_x + (1.0 - a) * center_y
    zeros = torch.zeros_like(a)
    ones = torch.ones_like(a)
    return _stack3([[a, b, tx], [-b, a, ty], [zeros, zeros, ones]])


def translation(tx, ty) -> torch.Tensor:
    """(..., 3, 3) translation matrix."""
    tx = _f32(tx)
    ty = _f32(ty, tx)
    zeros = torch.zeros_like(tx)
    ones = torch.ones_like(tx)
    return _stack3([[ones, zeros, tx], [zeros, ones, ty],
                    [zeros, zeros, ones]])


def scaling(sx, sy) -> torch.Tensor:
    """(..., 3, 3) anisotropic scaling matrix."""
    sx = _f32(sx)
    sy = _f32(sy, sx)
    zeros = torch.zeros_like(sx)
    ones = torch.ones_like(sx)
    return _stack3([[sx, zeros, zeros], [zeros, sy, zeros],
                    [zeros, zeros, ones]])


def compose(*mats) -> torch.Tensor:
    """compose(A, B, C) applies A first: returns C @ B @ A."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("...ij,...jk->...ik", m, out)
    return out


def invert_affine(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverse.  A singular matrix gives non-finite entries, as
    jnp.linalg.inv does, where torch.linalg.inv would raise; inv_ex checks
    nothing on the host, so the card's queue is not drained."""
    return torch.linalg.inv_ex(mat).inverse


def apply_affine(mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) affine to (..., N, 2) points -> (..., N, 2)."""
    hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.einsum("...ij,...nj->...ni", mat, hom)[..., :2]


def affine_from_bbox(bbox, crop_size, target_dist=0.7) -> torch.Tensor:
    """Affine mapping the bbox (x1, y1, x2, y2) into a crop_size square with
    the box spanning `target_dist` of it.  bbox (..., 4) -> (..., 3, 3)."""
    bbox = _f32(bbox)
    cx = (bbox[..., 0] + bbox[..., 2]) / 2.0
    cy = (bbox[..., 1] + bbox[..., 3]) / 2.0
    length = torch.maximum(bbox[..., 2] - bbox[..., 0],
                           bbox[..., 3] - bbox[..., 1])
    s = target_dist * crop_size / length
    return compose(
        translation(-cx, -cy),
        scaling(s, s),
        translation(torch.full_like(cx, crop_size / 2.0),
                    torch.full_like(cy, crop_size / 2.0)),
    )


def modify_bbox(bbox, scale) -> torch.Tensor:
    """Rescale a bbox about its center and make it square (side = max side
    * scale)."""
    bbox = _f32(bbox)
    cx = (bbox[..., 0] + bbox[..., 2]) / 2.0
    cy = (bbox[..., 1] + bbox[..., 3]) / 2.0
    w = (bbox[..., 2] - bbox[..., 0]) * scale
    h = (bbox[..., 3] - bbox[..., 1]) * scale
    half = torch.maximum(w, h) / 2.0
    return torch.stack([cx - half, cy - half, cx + half, cy + half], dim=-1)
