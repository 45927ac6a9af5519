"""The augmentation of the PeCLR sample in plain PyTorch: the random draws,
the geometric chain (rotation about the keypoints' centroid, the crop box
around them, the resize to the view), the colour jitter and the ImageNet
normalisation.

`draw` is a frozen copy of the draw arithmetic of
peclr_tpu_torch/ops/augment.py:draw at commit 9dfdca3: the program draws
its augmentation from a torch.Generator, so the same generator state gives
the reference the same parameters.  The rest follows the PeCLR
repository's augmentation (cv2's getRotationMatrix2D convention, the crop
box of side 2 * trunc(max radius * margin) about the truncated centroid,
cv2's BGR-on-RGB HSV quirk with its uint8 floors) and the two-pass warp's
arithmetic (warp.py).  Only the flags the benchmark's configurations use
are written here: crop, rotate, color_jitter, resize.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.warp import two_pass_warp

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SUPPORTED = {"crop", "rotate", "color_jitter", "resize"}


def draw(generator: torch.Generator, n: int, flags: dict,
         params: dict) -> Dict[str, torch.Tensor]:
    """The random parameters of n samples, in the program's order of
    draws (recipe draws first; the flags the benchmark uses draw nothing
    more)."""
    extra = {k for k, v in flags.items() if v} - SUPPORTED - {"random_crop"}
    if extra:
        raise ValueError(f"flags outside the reference: {sorted(extra)}")
    device = generator.device

    def uniform(shape, bounds):
        lo, hi = bounds
        u = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    zeros = torch.zeros(n, device=device)
    angle = (torch.floor(uniform(n, (params["min_angle"],
                                     params["max_angle"])))
             if flags.get("rotate") else zeros)
    jitter = (torch.trunc(uniform((n, 2), params["crop_box_jitter"]))
              if flags.get("crop") else torch.zeros(n, 2, device=device))
    margin = (uniform(n, params["crop_margin_range"])
              if flags.get("random_crop")
              else torch.full((n,), params["crop_margin"], device=device))
    return {
        "angle": angle,
        "jitter_x": -jitter[:, 0],
        "jitter_y": -jitter[:, 1],
        "h": uniform(n, params["hue_factor_range"]),
        "s": uniform(n, params["sat_factor_range"]),
        "a": uniform(n, params["value_factor_alpha_range"]),
        "b": uniform(n, params["value_factor_beta_range"]),
        "sigma": uniform(n, (0.1, 2.0)),
        "blur_flag": zeros,
        "crop_margin_scale": margin,
    }


def rotation_about_center(angle_deg, cx, cy):
    """cv2.getRotationMatrix2D as (B, 3, 3)."""
    rad = torch.deg2rad(angle_deg)
    a, b = torch.cos(rad), torch.sin(rad)
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    rows = [[a, b, (1.0 - a) * cx - b * cy], [-b, a, b * cx + (1.0 - a) * cy],
            [zeros, zeros, ones]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def window_bounds(src_hw, out_hw, params, rotate):
    """The warp's slope bounds: the downscale, widened by 1/cos of the
    largest rotation."""
    down_x = max(src_hw[1] / out_hw[1], 1.0)
    down_y = max(src_hw[0] / out_hw[0], 1.0)
    cos = 1.0
    if rotate:
        cos = math.cos(math.radians(max(abs(params["min_angle"]),
                                        abs(params["max_angle"]))))
    return down_x / cos + 0.05, down_y + 0.05


def rgb_to_hsv_cv2(img):
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-6) * 255.0, 0.0)
    sd = torch.clamp_min(delta, 1e-6)
    h = torch.where(maxc == r, 60.0 * (g - b) / sd,
                    torch.where(maxc == g, 120.0 + 60.0 * (b - r) / sd,
                                240.0 + 60.0 * (r - g) / sd))
    h = torch.where(delta == 0, 0.0, h)
    return torch.where(h < 0, h + 360.0, h) / 2.0, s, maxc


def hsv_to_rgb_cv2(h, s, v):
    h = torch.remainder(h * 2.0, 360.0)
    s = s / 255.0
    c = v * s
    x = c * (1.0 - torch.abs(torch.remainder(h / 60.0, 2.0) - 1.0))
    m = v - c
    zero = torch.zeros_like(c)
    sector = torch.remainder((h / 60.0).to(torch.int32), 6)
    table = {0: (c, x, zero), 1: (x, c, zero), 2: (zero, c, x),
             3: (zero, x, c), 4: (x, zero, c), 5: (c, zero, x)}
    r, g, b = table[5]
    for i in range(4, -1, -1):
        ri, gi, bi = table[i]
        on = sector == i
        r, g, b = (torch.where(on, ri, r), torch.where(on, gi, g),
                   torch.where(on, bi, b))
    return torch.stack([b + m, g + m, r + m], dim=-1)


def color_jitter(img, hf, sf, alpha, beta):
    """HSV jitter with the uint8 round trip (a floor of each channel)."""
    h, s, v = rgb_to_hsv_cv2(img)
    shape = (-1, 1, 1)
    h = torch.floor(torch.clamp(h * hf.reshape(shape), 0.0, 255.0))
    s = torch.floor(torch.clamp(s * sf.reshape(shape), 0.0, 255.0))
    v = torch.floor(torch.clamp(v * alpha.reshape(shape) + beta.reshape(shape),
                                0.0, 255.0))
    return torch.clamp(hsv_to_rgb_cv2(h, s, v), 0.0, 255.0)


def normalize(img01):
    mean = torch.tensor(IMAGENET_MEAN, device=img01.device)
    std = torch.tensor(IMAGENET_STD, device=img01.device)
    return (img01 - mean) / std


def apply(images_u8, joints25d, d, flags, params, zero_jitter,
          warp_dtype) -> Dict[str, torch.Tensor]:
    """One view per row: images (B, H, W, 3) uint8, keypoints (B, 21, 3) in
    source pixels, draws `d` -> normalised view (B, h, w, 3), keypoints in
    view pixels, the source -> view matrix and the reported parameters
    (jitter as the crop box's offset, angle)."""
    b, src_h, src_w, _ = images_u8.shape
    out_w, out_h = params["resize_shape"]
    dev = images_u8.device
    joints = joints25d.float()
    angle = d["angle"].float()
    centre = torch.trunc(joints[..., :2].mean(dim=1))
    rot = rotation_about_center(angle, centre[:, 0], centre[:, 1])
    hom = torch.cat([joints[..., :2], torch.ones_like(joints[..., :1])], -1)
    jr = torch.einsum("bij,bnj->bni", rot, hom)[..., :2]
    if flags.get("crop") and not zero_jitter:
        jitter = -torch.stack([d["jitter_x"], d["jitter_y"]], dim=-1).float()
    else:
        jitter = torch.zeros(b, 2, device=dev)
    margin = d["crop_margin_scale"].float()
    c = torch.trunc(jr.mean(dim=1))
    radial = torch.sqrt(((jr - c[:, None, :]) ** 2).sum(dim=-1))
    side = torch.trunc(radial.max(dim=1).values * margin)
    origin = torch.clamp_min(c - side[:, None] + jitter, 0.0)
    reported = c - side[:, None] - origin
    box = 2.0 * side
    crop_w = torch.clamp_max(origin[:, 0] + box, float(src_w)) - origin[:, 0]
    crop_h = torch.clamp_max(origin[:, 1] + box, float(src_h)) - origin[:, 1]
    fw = float(out_w) / torch.clamp_min(crop_w, 1.0)
    fh = float(out_h) / torch.clamp_min(crop_h, 1.0)
    shift = torch.zeros_like(rot)
    shift[:, 0, 2] = -origin[:, 0]
    shift[:, 1, 2] = -origin[:, 1]
    scale = torch.stack([fw, fh, torch.ones_like(fw)], dim=-1)[:, :, None]
    matrix = (rot + shift) * scale
    sx, sy = window_bounds((src_h, src_w), (out_h, out_w), params,
                           bool(flags.get("rotate")))
    x = two_pass_warp(images_u8, matrix, (out_h, out_w), sx, sy,
                      params["interpolation"], warp_dtype)
    joints_xy = torch.stack([(jr[..., 0] - origin[:, None, 0]) * fw[:, None],
                             (jr[..., 1] - origin[:, None, 1]) * fh[:, None]],
                            dim=-1)
    if flags.get("color_jitter"):
        x = color_jitter(x, d["h"].float(), d["s"].float(), d["a"].float(),
                         d["b"].float())
    return {"images": normalize(x / 255.0),
            "joints": torch.cat([joints_xy, joints[..., 2:]], dim=-1),
            "matrix": matrix, "angle": angle,
            "jitter_x": reported[:, 0], "jitter_y": reported[:, 1]}
