"""Model heads: the SimCLR projection MLP (port of
peclr_tpu/models/heads.py:19-48), the z-root refinement MLP (:51-106) and
the z-root denoiser (:109-123).

ProjectionHead: Linear(E -> 512, bias) -> BatchNorm1d -> ReLU ->
Linear(512 -> 128, no bias), a Sequential whose indices 0/1/3 are the
reference checkpoint's `projection_head.N` keys; its output is float32.

ZrootRefineMLP:

Closed-form scale-normalized root depth from the middle_mcp (3) <->
middle_pip (8) bone with unit length (Iqbal et al. eq 6-7), clamped to
[4, 50] and detached, then refined by zroot + mlp([zrel(21), xy_unnorm(42),
zroot(1)]).  The MLP is a Sequential whose indices 0/1/3/4/6 are the
released checkpoint's `zroot_ref.zroot_ref.N` keys; its BatchNorms update
their running statistics as flax does (models/batchnorm.py).

Denoiser: (21 zrel + 42 2D + 1 scale logit = 64) -> 128 -> 128 -> 1, a
Sequential of the same indices 0/1/3/4/6 and the same BatchNorm, with ReLU.
"""

from __future__ import annotations

import torch
from torch import nn

from peclr_tpu_torch.models.batchnorm import BatchNorm1d


class ProjectionHead(nn.Sequential):
    def __init__(self, input_dim: int = 2048, hidden_dim: int = 512,
                 output_dim: int = 128):
        super().__init__(
            nn.Linear(input_dim, hidden_dim),
            BatchNorm1d(hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, output_dim, bias=False),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).float()


class ZrootRefineMLP(nn.Module):
    def __init__(self, norm_bone=(3, 8), eps: float = 1e-8):
        super().__init__()
        self.norm_bone = norm_bone
        self.eps = eps
        self.zroot_ref = nn.Sequential(
            nn.Linear(21 + 42 + 1, 128),
            BatchNorm1d(128),
            nn.LeakyReLU(0.01),
            nn.Linear(128, 128),
            BatchNorm1d(128),
            nn.LeakyReLU(0.01),
            nn.Linear(128, 1),
        )

    def forward(self, kp3d_unnorm: torch.Tensor,
                zrel: torch.Tensor) -> torch.Tensor:
        """kp3d_unnorm (B, 21, 3) back-projected rays, zrel (B, 21, 1) ->
        refined z-root (B,)."""
        m, n = self.norm_bone
        X_m, Y_m = kp3d_unnorm[:, m, 0], kp3d_unnorm[:, m, 1]
        X_n, Y_n = kp3d_unnorm[:, n, 0], kp3d_unnorm[:, n, 1]
        z_m = zrel[:, m, 0]
        z_n = zrel[:, n, 0]

        a = (X_n - X_m) ** 2 + (Y_n - Y_m) ** 2
        b = 2.0 * (
            z_n * (X_n**2 + Y_n**2 - X_n * X_m - Y_n * Y_m)
            + z_m * (X_m**2 + Y_m**2 - X_n * X_m - Y_n * Y_m)
        )
        c = (
            (X_n * z_n - X_m * z_m) ** 2
            + (Y_n * z_n - Y_m * z_m) ** 2
            + (z_n - z_m) ** 2
            - 1.0
        )
        a = torch.clamp_min(a, self.eps)
        d = torch.clamp_min(b * b - 4.0 * a * c, self.eps)
        zroot = ((-b + torch.sqrt(d)) / (2.0 * a)).detach()
        zroot = torch.clamp(zroot, 4.0, 50.0)

        mlp_in = torch.cat(
            [zrel.reshape(-1, 21), kp3d_unnorm[..., :2].reshape(-1, 42),
             zroot.reshape(-1, 1)],
            dim=1,
        )
        return zroot + self.zroot_ref(mlp_in)[:, 0]


class Denoiser(nn.Sequential):
    """forward((B, 64)) -> (B, 1) refined z-root; the evaluation takes it
    through `evaluate(..., predict_zroot=...)`."""

    def __init__(self, input_dim: int = 21 + 42 + 1, hidden_dim: int = 128):
        super().__init__(
            nn.Linear(input_dim, hidden_dim),
            BatchNorm1d(hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim),
            BatchNorm1d(hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, 1),
        )
