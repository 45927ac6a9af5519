"""2.5D keypoint pose model with z-root MLP refinement (port of
peclr_tpu/models/rn25d.py, the released RN_25D_wMLPref model).

Module names `backend_model.*` and `zroot_ref.zroot_ref.*` make
`state_dict()` keys equal to the released `.pth` keys.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from peclr_tpu_torch.device import device_constant
from peclr_tpu_torch.models.heads import ZrootRefineMLP
from peclr_tpu_torch.models.resnet import ResNet

#: FreiHAND default intrinsics for 224x224 crops
K_DEFAULT = (
    (388.9018310596544, 0.0, 112.0),
    (0.0, 388.71231836584275, 112.0),
    (0.0, 0.0, 1.0),
)
#: the wrist's root-relative depth, which is 0 by definition
_WRIST_Z = tuple(tuple(j == 0 and c == 2 for c in range(3)) for j in range(21))


class RN25DPose(nn.Module):
    """forward(images (B, H, W, 3) float, channels last as in the reference,
    K (B, 3, 3)) -> dict(kp3d, zrel, kp2d, kp25d).

    kp25d: (B, 21, 3) raw 2.5D prediction (pixel u, v, relative depth).
    kp3d:  (B, 21, 3) scale-normalized 3D = unnormalized rays * (zrel+zroot).
    """

    def __init__(self, size: str = "50"):
        super().__init__()
        self.size = size
        self.backend_model = ResNet(size, num_outputs=21 * 3 + 1)
        self.zroot_ref = ZrootRefineMLP()

    def forward(self, images: torch.Tensor,
                K: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        batch = images.shape[0]
        if K is None:
            K = device_constant(K_DEFAULT, images.device).expand(batch, 3, 3)
        out = self.backend_model(images.permute(0, 3, 1, 2))
        kp25d = out[:, :-1].reshape(batch, 21, 3)
        wrist_z = device_constant(_WRIST_Z, images.device, torch.bool)
        kp25d = torch.where(wrist_z, 0.0, kp25d)
        kp2d = kp25d[..., :2]
        zrel = kp25d[..., 2:3]
        kp2d_h = torch.cat([kp2d, torch.ones_like(zrel)], dim=2)
        # inv_ex: no error check on the host (that would wait for the card);
        # a singular K gives non-finite rows, as jnp.linalg.inv does
        K_inv = torch.linalg.inv_ex(K).inverse
        kp3d_unnorm = torch.einsum("bnj,bij->bni", kp2d_h, K_inv)
        zroot = self.zroot_ref(kp3d_unnorm, zrel)
        kp3d = kp3d_unnorm * (zrel + zroot[:, None, None])
        return {"kp3d": kp3d, "zrel": zrel, "kp2d": kp2d, "kp25d": kp25d}
