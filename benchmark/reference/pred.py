"""The FreiHAND leaderboard's two-pass prediction in plain PyTorch (the
PeCLR repository's testing/pred_fh.py).

Pass 1 warps each 224 x 224 frame by a fixed affine (the frame's box
scaled by 0.33 about its centre, mapped into a 224 crop so that it spans
0.7 of it), predicts 2.5D keypoints with K' = T1 K, and boxes them (the
truncated min and max).  The box mapped back to the frame gives the second
affine T2; pass 2 predicts again on that crop, and the wrist is moved back
from the palm: wrist = 2 palm - middle_mcp.  Warps use the tent taps with
the border value 0.485 (the reference's cv2 quirk: the ImageNet mean in
[0, 1] units given to a uint8 warp).
"""

from __future__ import annotations

import torch

from benchmark.reference import augment, models
from benchmark.reference.warp import two_pass_warp

CROP = 224
MAX_SCALE = 3.0
FILL = 0.485


def affine_from_bbox(box, crop=CROP, target=0.7):
    """(B, 4) boxes (x1, y1, x2, y2) -> (B, 3, 3): translate the centre to
    0, scale so the longer side spans target * crop, translate to the
    crop's centre."""
    cx = (box[:, 0] + box[:, 2]) / 2.0
    cy = (box[:, 1] + box[:, 3]) / 2.0
    side = torch.maximum(box[:, 2] - box[:, 0], box[:, 3] - box[:, 1])
    s = target * crop / side
    m = torch.zeros(box.shape[0], 3, 3, device=box.device)
    m[:, 0, 0] = s
    m[:, 1, 1] = s
    m[:, 0, 2] = -s * cx + crop / 2.0
    m[:, 1, 2] = -s * cy + crop / 2.0
    m[:, 2, 2] = 1.0
    return m


def initial_affine(n, device):
    half = CROP * 0.33 / 2.0
    c = CROP / 2.0
    box = torch.tensor([[c - half, c - half, c + half, c + half]],
                       device=device).expand(n, 4)
    return affine_from_bbox(box)


def preprocess(frames_u8, T, warp_dtype):
    crop = two_pass_warp(frames_u8, T, (CROP, CROP), MAX_SCALE, MAX_SCALE,
                         "linear", warp_dtype, fill=FILL)
    return augment.normalize(crop / 255.0)


def refine(kp2d, T1):
    """The pass-2 affine from pass 1's keypoints (B, 21, 2) in crop
    pixels."""
    lo = torch.trunc(kp2d.amin(dim=1))
    hi = torch.maximum(torch.trunc(kp2d.amax(dim=1)), lo + 1.0)
    corners = torch.stack([lo, hi], dim=1)  # (B, 2, 2)
    inv = torch.linalg.inv(T1)
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], dim=-1)
    back = torch.einsum("bij,bnj->bni", inv, hom)[..., :2]
    return affine_from_bbox(torch.cat([back[:, 0], back[:, 1]], dim=-1))


def palm_to_wrist(kp3d, middle_mcp=3):
    wrist = 2.0 * kp3d[:, 0] - kp3d[:, middle_mcp]
    return torch.cat([wrist[:, None], kp3d[:, 1:]], dim=1)


@torch.no_grad()
def pass1(frames_u8, K, p, size, q, warp_dtype):
    """Pass 1's kp25d (B, 21, 3) and T1."""
    T1 = initial_affine(frames_u8.shape[0], frames_u8.device)
    out = models.rn25d_forward(preprocess(frames_u8, T1, warp_dtype),
                               torch.einsum("bij,bjk->bik", T1, K.float()),
                               p, size, q, train=False)
    return out["kp25d"], T1


@torch.no_grad()
def pass2(frames_u8, K, T2, p, size, q, warp_dtype):
    """Pass 2's final kp3d (B, 21, 3) on the crop of T2."""
    out = models.rn25d_forward(preprocess(frames_u8, T2, warp_dtype),
                               torch.einsum("bij,bjk->bik", T2, K.float()),
                               p, size, q, train=False)
    return palm_to_wrist(out["kp3d"])
