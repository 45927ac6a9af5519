"""Image ops of the augmentation (port of peclr_tpu/ops/image.py:24-99,
:186-189): ImageNet normalisation and the cv2-quirk HSV colour jitter.

Images are batched (B, H, W, 3) float in [0, 255], stored RGB, but the
reference calls BGR-flavoured cv2 conversions on them, so the HSV jitter
works on the channel-reversed image; H follows cv2's uint8 convention
(H/2, in [0, 180)).  Both quirks are kept, so pretraining statistics match.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images_01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images (..., 3), channels last -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=images_01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=images_01.device)
    return (images_01 - mean) / std


def rgb_to_hsv_cv2(images: torch.Tensor):
    """RGB (treated as BGR, the cv2 quirk) float [0, 255] -> (h, s, v) with h
    in [0, 180), s and v in [0, 255]."""
    # channel-reversal quirk: cv2 assumes ch0 = B, so "r" is storage ch2
    b, g, r = images[..., 0], images[..., 1], images[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-6) * 255.0,
                    0.0)
    safe_delta = torch.clamp_min(delta, 1e-6)
    h = torch.where(
        maxc == r,
        60.0 * (g - b) / safe_delta,
        torch.where(maxc == g, 120.0 + 60.0 * (b - r) / safe_delta,
                    240.0 + 60.0 * (r - g) / safe_delta),
    )
    h = torch.where(delta == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0  # cv2 uint8 convention: H/2
    return h, s, v


def hsv_to_rgb_cv2(h: torch.Tensor, s: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_hsv_cv2, channel-reversal quirk included."""
    h = torch.remainder(h * 2.0, 360.0)  # back to degrees
    s = s / 255.0
    c = v * s
    x = c * (1.0 - torch.abs(torch.remainder(h / 60.0, 2.0) - 1.0))
    m = v - c
    zeros = torch.zeros_like(c)
    sector = torch.remainder((h / 60.0).to(torch.int32), 6)

    def select(values, default):
        out = default
        for i in reversed(range(5)):
            out = torch.where(sector == i, values[i], out)
        return out

    r = select([c, x, zeros, zeros, x], c)
    g = select([x, c, c, x, zeros], zeros)
    b = select([zeros, zeros, x, c, c], x)
    # storage order ch0 = B, ch1 = G, ch2 = R (quirk-consistent round trip)
    return torch.stack([b + m, g + m, r + m], dim=-1)


def color_jitter(images: torch.Tensor, h_factor: torch.Tensor,
                 s_factor: torch.Tensor, alpha: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
    """Multiplicative hue/saturation jitter and affine value jitter in HSV
    space, factors per sample (B,), with the reference's uint8 round trip
    (a floor of each channel)."""
    h, s, v = rgb_to_hsv_cv2(images)
    shape = (-1, 1, 1)
    h = torch.clamp(h * h_factor.reshape(shape), 0.0, 255.0)
    s = torch.clamp(s * s_factor.reshape(shape), 0.0, 255.0)
    v = torch.clamp(v * alpha.reshape(shape) + beta.reshape(shape), 0.0, 255.0)
    h, s, v = torch.floor(h), torch.floor(s), torch.floor(v)
    return torch.clamp(hsv_to_rgb_cv2(h, s, v), 0.0, 255.0)
