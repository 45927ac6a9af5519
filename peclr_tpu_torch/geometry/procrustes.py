"""Batched similarity-Procrustes alignment (port of
peclr_tpu/geometry/procrustes.py).

Finds scale s, rotation R and translation t minimising ||s·Y·R + t − X||_F
per batch element, by the SVD of the normalised cross-covariance.  Used for
the aligned kp3d AUC leaderboard metric.
"""

from __future__ import annotations

import torch


def procrustes_align(X: torch.Tensor, Y: torch.Tensor, eps: float = 1e-12):
    """Align Y to X.  X, Y: (B, N, 3).

    Returns (Y_aligned, R, scale, translation) where
    Y_aligned = normX * trace_ratio * (Y0 @ R) + muX.  The reflection fix
    flips the last singular vector by sign(det(V Uᵀ)), which is 0 (and so
    zeroes that column) where the determinant is 0."""
    muX = X.mean(dim=1, keepdim=True)
    muY = Y.mean(dim=1, keepdim=True)
    X0 = X - muX
    Y0 = Y - muY
    normX = torch.sqrt((X0 * X0).sum(dim=(1, 2), keepdim=True)) + eps
    normY = torch.sqrt((Y0 * Y0).sum(dim=(1, 2), keepdim=True)) + eps
    X0 = X0 / normX
    Y0 = Y0 / normY
    A = torch.einsum("bni,bnj->bij", X0, Y0)
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    V = Vh.transpose(-1, -2)
    det = torch.linalg.det(torch.einsum("bij,bkj->bik", V, U))
    sign = torch.sign(det)[:, None]
    V = torch.cat([V[:, :, :-1], V[:, :, -1:] * sign[:, None]], dim=-1)
    s = torch.cat([s[:, :-1], s[:, -1:] * sign], dim=-1)
    R = torch.einsum("bij,bkj->bik", V, U)
    trace = s.sum(dim=1)[:, None, None]
    scale = trace * normX / normY
    translation = muX - scale * torch.einsum("bni,bij->bnj", muY, R)
    Y_aligned = normX * trace * torch.einsum("bni,bij->bnj", Y0, R) + muX
    return Y_aligned, R, scale, translation
