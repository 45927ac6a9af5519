"""Image ops of the augmentation (port of peclr_tpu/ops/image.py): ImageNet
normalisation, the cv2-quirk HSV colour jitter, grayscale, the Sobel filter,
the Gaussian blur, cut-out and Gaussian noise.

Images are batched (B, H, W, 3) float in [0, 255], stored RGB, but the
reference calls BGR-flavoured cv2 conversions on them, so grayscale weighs
the channels [0.114, 0.587, 0.299] in storage order and the HSV jitter
works on the channel-reversed image; H follows cv2's uint8 convention
(H/2, in [0, 180)).  These quirks are kept, so pretraining statistics match.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from peclr_tpu_torch.device import device_constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: cv2 grayscale weights in *storage* order (the BGR2GRAY-on-RGB quirk)
_GRAY_W = (0.114, 0.587, 0.299)

#: sobel_x + sobel_y: the filter is linear, so one 3x3 kernel applies both
_SOBEL_XY = ((-2.0, -2.0, 0.0), (-2.0, 0.0, 2.0), (0.0, 2.0, 2.0))


def _imagenet_stats(device):
    return (device_constant(IMAGENET_MEAN, device),
            device_constant(IMAGENET_STD, device))


def normalize_imagenet(images_01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images (..., 3), channels last -> ImageNet-normalized."""
    mean, std = _imagenet_stats(images_01.device)
    return (images_01 - mean) / std


def denormalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """Inverse of normalize_imagenet."""
    mean, std = _imagenet_stats(images.device)
    return images * std + mean


def where_flag(flag: torch.Tensor, on: torch.Tensor,
               off: torch.Tensor) -> torch.Tensor:
    """Per sample, `on` where the 0/1 coin flag (B,) is 1, else `off`."""
    return torch.where(flag[:, None, None, None] > 0, on, off)


def _gray(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) with the storage-order cv2 weights."""
    w = device_constant(_GRAY_W, images.device)
    return torch.einsum("bhwc,c->bhw", images, w)


def grayscale(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 3), the gray value in every channel."""
    return _gray(images)[..., None].expand(*images.shape[:3], 3).contiguous()


def sobel_filter(images: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Gray -> sobel_x + sobel_y (3x3, zero padding), clipped to [0, 255]
    and replicated to 3 channels.  `ksize` is taken and ignored, as in the
    reference."""
    del ksize
    kernel = device_constant(_SOBEL_XY, images.device)[None, None]
    out = F.conv2d(_gray(images)[:, None], kernel, padding=1)[:, 0]
    return torch.clamp(out, 0.0, 255.0)[..., None].expand(
        *images.shape[:3], 3).contiguous()


def gaussian_kernel_1d(sigma: torch.Tensor, width: int) -> torch.Tensor:
    """(B, width) normalized Gaussian taps of per-sample sigma (B,)."""
    half = (width - 1) / 2.0
    x = torch.arange(width, dtype=torch.float32, device=sigma.device) - half
    k = torch.exp(-(x[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    return k / k.sum(dim=1, keepdim=True)


def blur_width(h: int, kernel_frac: float = 0.1) -> int:
    """The blur's tap count: int(h * kernel_frac), rounded up to odd, taken
    from the height for both axes (the reference's choice)."""
    kw = int(h * kernel_frac)
    return kw + 1 if kw % 2 == 0 else kw


def gaussian_blur(images: torch.Tensor, sigma: torch.Tensor,
                  kernel_frac: float = 0.1) -> torch.Tensor:
    """Separable Gaussian blur with per-sample sigma (B,), reflect padding
    (cv2's BORDER_REFLECT_101, numpy's and torch's "reflect").

    Each pass is one depthwise convolution over the B*3 planes, each plane
    with its sample's taps; no window of taps is materialised."""
    b, h, w, c = images.shape
    kw = blur_width(h, kernel_frac)
    pad = kw // 2
    taps = gaussian_kernel_1d(sigma.to(torch.float32), kw)  # (B, kw)
    weight = taps.repeat_interleave(c, dim=0)  # (B*C, kw), plane order b, c
    planes = images.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.conv2d(F.pad(planes, (pad, pad, 0, 0), mode="reflect"),
                 weight[:, None, None, :], groups=b * c)
    y = F.conv2d(F.pad(x, (0, 0, pad, pad), mode="reflect"),
                 weight[:, None, :, None], groups=b * c)
    return y.reshape(b, c, h, w).permute(0, 2, 3, 1)


def gaussian_noise(images: torch.Tensor, noise: torch.Tensor,
                   std: float = 25.0) -> torch.Tensor:
    """Additive noise: a standard normal draw of the images' shape, scaled
    by std, saturating at [0, 255]."""
    return torch.clamp(images + noise * std, 0.0, 255.0)


def cutout(images: torch.Tensor, center_xy: torch.Tensor,
           fraction: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """Fill a box of side fraction * dim centred on a per-sample keypoint.

    center_xy (B, 2) pixel coords (x, y); fraction (B,); fill (B,).  The
    reference indexes rows with x and columns with y: the box's rows centre
    on x and its columns on y, a quirk kept here."""
    b, h, w, _ = images.shape
    cut_h = torch.floor(h * fraction)
    cut_w = torch.floor(w * fraction)
    top = torch.floor(center_xy[:, 0] - cut_h / 2.0)
    left = torch.floor(center_xy[:, 1] - cut_w / 2.0)
    rows = torch.arange(h, dtype=torch.float32, device=images.device)
    cols = torch.arange(w, dtype=torch.float32, device=images.device)
    in_rows = ((rows[None, :] >= top[:, None])
               & (rows[None, :] < top[:, None] + cut_h[:, None]))
    in_cols = ((cols[None, :] >= left[:, None])
               & (cols[None, :] < left[:, None] + cut_w[:, None]))
    mask = (in_rows[:, :, None] & in_cols[:, None, :])[..., None]
    return torch.where(mask, fill[:, None, None, None], images)


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
