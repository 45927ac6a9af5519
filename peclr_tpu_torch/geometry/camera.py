"""2.5D <-> 3D camera-space conversions with the closed-form scale-normalized
root depth of Iqbal et al. (arXiv:1804.09534 eqs. 6-7); port of
peclr_tpu/geometry/camera.py.

Batch-first over leading axes, with the reference's numerical guards: the
quadratic's `a` coefficient and discriminant are clamped at 1e-6, and the
larger root is taken in its cancellation-free form where b > 0.

joints3d : (..., 21, 3) metric camera-space coordinates, ait order
joints25d: (..., 21, 3): pixel (u, v) and z_rel = (Z - Z_root) / scale
scale    : (...,) metric length of the wrist -> index_mcp bone
K        : (..., 3, 3) camera intrinsics
"""

from __future__ import annotations

import torch

from peclr_tpu_torch.geometry.joints import INDEX_MCP, MIDDLE_MCP, WRIST

_EPS = 1e-6


def convert_to_2_5d(K: torch.Tensor, joints3d: torch.Tensor):
    """Project 3D joints to 2.5D.  Returns (joints25d (..., 21, 3), scale
    (...,))."""
    bone = joints3d[..., INDEX_MCP, :] - joints3d[..., WRIST, :]
    scale = torch.sqrt(torch.sum(bone * bone, dim=-1))
    z = joints3d[..., :, 2:3]
    uvw = torch.einsum("...ij,...nj->...ni", K, joints3d) / z
    z_rel = ((joints3d[..., :, 2] - joints3d[..., WRIST, 2][..., None])
             / scale[..., None])
    return torch.cat([uvw[..., :2], z_rel[..., None]], dim=-1), scale


def root_depth(joints25d: torch.Tensor, K: torch.Tensor):
    """Closed-form scale-normalized Z_root from the wrist (n) and index-mcp
    (m) joints with unit bone length.  Returns (z_root (...,), K_inv
    (..., 3, 3)); a singular K gives non-finite values, as in the reference,
    where torch.linalg.inv would raise (inv_ex checks nothing on the host,
    so the card's queue is not drained)."""
    K_inv = torch.linalg.inv_ex(K).inverse

    def backproject(joint_uv):
        hom = torch.cat([joint_uv, torch.ones_like(joint_uv[..., :1])], dim=-1)
        return torch.einsum("...ij,...j->...i", K_inv, hom)

    xyz_n = backproject(joints25d[..., WRIST, :2])
    xyz_m = backproject(joints25d[..., INDEX_MCP, :2])
    x_n, y_n = xyz_n[..., 0], xyz_n[..., 1]
    x_m, y_m = xyz_m[..., 0], xyz_m[..., 1]
    z_n = joints25d[..., WRIST, 2]
    z_m = joints25d[..., INDEX_MCP, 2]

    a = (x_n - x_m) ** 2 + (y_n - y_m) ** 2
    b = 2.0 * (
        z_n * (x_n ** 2 + y_n ** 2 - x_n * x_m - y_n * y_m)
        + z_m * (x_m ** 2 + y_m ** 2 - x_n * x_m - y_n * y_m)
    )
    c = ((x_n * z_n - x_m * z_m) ** 2 + (y_n * z_n - y_m * z_m) ** 2
         + (z_n - z_m) ** 2 - 1.0)
    sqrt_disc = torch.sqrt(torch.clamp_min(b * b - 4.0 * a * c, _EPS))
    root_classic = 0.5 * (-b + sqrt_disc) / torch.clamp_min(a, _EPS)
    denom = -b - sqrt_disc
    root_stable = 2.0 * c / torch.where(denom.abs() < _EPS,
                                        torch.full_like(denom, _EPS), denom)
    return torch.where(b > 0, root_stable, root_classic), K_inv


def convert_2_5d_to_3d(joints25d: torch.Tensor, scale: torch.Tensor,
                       K: torch.Tensor, z_root=None) -> torch.Tensor:
    """Lift 2.5D joints back to metric 3D camera space; `z_root`, when
    given, overrides the closed-form estimate."""
    z_root_calc, K_inv = root_depth(joints25d, K)
    if z_root is None:
        z_root = z_root_calc
    scale = torch.as_tensor(scale, dtype=joints25d.dtype,
                            device=joints25d.device)
    z = (joints25d[..., :, 2] + z_root[..., None]) * scale[..., None]
    hom = torch.cat([joints25d[..., :, :2],
                     torch.ones_like(joints25d[..., :, 2:3])], dim=-1)
    rays = torch.einsum("...ij,...nj->...ni", K_inv, hom)
    return rays * z[..., None]


def error_in_conversion(true_joints3d, calc_joints3d) -> torch.Tensor:
    """Max abs error of a 3D -> 2.5D -> 3D round trip."""
    return torch.max(torch.abs(torch.as_tensor(calc_joints3d)
                               - torch.as_tensor(true_joints3d)))


def _with_wrist(joints3d: torch.Tensor, wrist: torch.Tensor) -> torch.Tensor:
    return torch.cat([joints3d[..., :WRIST, :], wrist.unsqueeze(-2),
                      joints3d[..., WRIST + 1:, :]], dim=-2)


def move_wrist_to_palm(joints3d: torch.Tensor) -> torch.Tensor:
    """Replace the wrist joint with the palm midpoint (wrist + index_mcp)/2
    (the `use_palm` option).  Returns a new tensor."""
    palm = (joints3d[..., WRIST, :] + joints3d[..., INDEX_MCP, :]) / 2.0
    return _with_wrist(joints3d, palm)


def move_palm_to_wrist(joints3d: torch.Tensor,
                       middle_mcp_index: int = MIDDLE_MCP) -> torch.Tensor:
    """Inverse of palm regression at inference: wrist = 2*palm - middle_mcp
    (index 3 is middle_mcp in ait order).  Returns a new tensor."""
    wrist = (2.0 * joints3d[..., WRIST, :]
             - joints3d[..., middle_mcp_index, :])
    return _with_wrist(joints3d, wrist)
