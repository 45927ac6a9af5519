"""Batched augmentation of the PeCLR pretrain step (port of
peclr_tpu/ops/augment.py:56-389, the recipe's flags).

The geometric chain rotate ∘ crop ∘ resize collapses into one affine map per
sample, applied by the two-pass warp (ops/warp_mxu.py); then the cv2-quirk
colour jitter.  The per-sample parameters that the equivariant loss inverts
come out beside the views.

torch cannot replay jax.random, so each transform is split in two:
`draw(generator, n, ...)` makes the random parameters, as the dict that the
reference's `AugmentOutput.params` holds, and `apply(images, joints, draws,
...)` is deterministic.  `jitter_x`/`jitter_y` in a draw are the negated
crop-box jitter, -trunc(U[0, 15)): apply places the crop origin at
max(centre - side - jitter, 0), so the reference's reported jitter
(centre - side - origin) handed back to apply reproduces its crop exactly.

Flags outside the recipe (sobel_filter, cut_out, gaussian_blur,
gaussian_noise, color_drop) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from peclr_tpu_torch.config.defaults import AugmentationFlags, AugmentationParams
from peclr_tpu_torch.geometry.affine import rotation_about_center
from peclr_tpu_torch.ops import image as im
from peclr_tpu_torch.ops.warp_mxu import affine_warp_mxu

#: flags whose ops are not ported yet (ROADMAP queue 1 item 5)
UNPORTED_FLAGS = ("sobel_filter", "cut_out", "gaussian_blur",
                  "gaussian_noise", "color_drop")


@dataclasses.dataclass
class AugmentOutput:
    images: torch.Tensor  # (B, out_h, out_w, 3) float32, [0, 1] or normalized
    joints: torch.Tensor  # (B, 21, 3) transformed 2.5D keypoints
    matrix: torch.Tensor  # (B, 3, 3) source -> dest affine
    params: Dict[str, torch.Tensor]  # per-sample augmentation parameters


def _check_flags(flags: AugmentationFlags) -> None:
    unported = [name for name in UNPORTED_FLAGS if getattr(flags, name)]
    if unported:
        raise NotImplementedError(
            f"augmentation flags {unported} are not ported to "
            "peclr_tpu_torch yet (ROADMAP queue 1 item 5)")


def _warp_window_bounds(src_hw, out_hw, params: AugmentationParams,
                        rotate: bool) -> Tuple[float, float]:
    """Slope bounds (max_scale_x, max_scale_y) of the warp's static windows.

    The horizontal slope of the fused map is fw/cos(angle) with fw <=
    src/out (crops are clamped to the source), so a 45° rotation needs a
    window √2 wider than the downscale alone."""
    src_h, src_w = src_hw
    out_h, out_w = out_hw
    down_x = max(float(src_w) / out_w, 1.0)
    down_y = max(float(src_h) / out_h, 1.0)
    if rotate:
        max_abs = max(abs(params.min_angle), abs(params.max_angle))
        if max_abs > 80.0:
            # cos -> 0: the window would explode, and past 90° the two-pass
            # decomposition itself is invalid
            raise ValueError(
                f"the two-pass warp supports |rotation| <= 80 deg (got "
                f"{max_abs})")
        cos_bound = math.cos(math.radians(max_abs))
    else:
        cos_bound = 1.0
    return down_x / cos_bound + 0.05, down_y + 0.05


def _crop_box(joints_xy: torch.Tensor, jitter_xy: torch.Tensor,
              crop_margin: torch.Tensor):
    """Crop-box geometry: joints_xy (B, 21, 2), integer-valued jitter_xy
    (B, 2), crop_margin (B,) -> origin (B, 2), side (B,), reported jitter
    (B, 2)."""
    center = torch.trunc(joints_xy.mean(dim=1))
    radial = torch.sqrt(((joints_xy - center[:, None, :]) ** 2).sum(dim=-1))
    side = torch.trunc(radial.max(dim=1).values * crop_margin)
    origin = torch.clamp_min(center - side[:, None] + jitter_xy, 0.0)
    reported = center - side[:, None] - origin
    return origin, side, reported


def draw(generator: torch.Generator, n: int, flags: AugmentationFlags,
         params: AugmentationParams) -> Dict[str, torch.Tensor]:
    """The random parameters of n samples, on the generator's device."""
    _check_flags(flags)
    device = generator.device

    def uniform(shape, bounds):
        lo, hi = bounds
        u = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    zeros = torch.zeros(n, device=device)
    angle = (torch.floor(uniform(n, (params.min_angle, params.max_angle)))
             if flags.rotate else zeros)
    jitter = (torch.trunc(uniform((n, 2), params.crop_box_jitter))
              if flags.crop else torch.zeros(n, 2, device=device))
    margin = (uniform(n, params.crop_margin_range) if flags.random_crop
              else torch.full((n,), params.crop_margin, device=device))
    return {
        "angle": angle,
        "jitter_x": -jitter[:, 0],
        "jitter_y": -jitter[:, 1],
        "h": uniform(n, params.hue_factor_range),
        "s": uniform(n, params.sat_factor_range),
        "a": uniform(n, params.value_factor_alpha_range),
        "b": uniform(n, params.value_factor_beta_range),
        "sigma": uniform(n, (0.1, 2.0)),
        "blur_flag": zeros,
        "crop_margin_scale": margin,
    }


@torch.no_grad()
def apply(images_u8: torch.Tensor, joints25d: torch.Tensor,
          draws: Dict[str, torch.Tensor], flags: AugmentationFlags,
          params: AugmentationParams, force_crop: bool = False,
          zero_jitter: bool = False, route: str = "grouped",
          compute_dtype: Optional[torch.dtype] = None) -> AugmentOutput:
    """Transform one batch (one contrastive view) with the given draws.

    images_u8 (B, H, W, 3) uint8 canvases; joints25d (B, 21, 3) keypoints
    in source pixels (z untouched).  force_crop / zero_jitter: a crop always
    runs for contrastive samples, with its jitter pinned to 0 when the crop
    flag is off.  Views come out at params.resize_shape, in [0, 1]."""
    _check_flags(flags)
    b, src_h, src_w, _ = images_u8.shape
    out_w, out_h = params.resize_shape
    device = images_u8.device
    d = {k: v.to(device=device, dtype=torch.float32) for k, v in draws.items()}
    joints = joints25d.to(torch.float32)

    # rotation about the truncated keypoint centroid
    angle = d["angle"]
    center0 = torch.trunc(joints[..., :2].mean(dim=1))
    rot = rotation_about_center(angle, center0[:, 0], center0[:, 1])
    hom = torch.cat([joints[..., :2], torch.ones_like(joints[..., :1])], -1)
    joints_rot_xy = torch.einsum("bij,bnj->bni", rot, hom)[..., :2]

    if flags.crop and not zero_jitter:
        jitter = -torch.stack([d["jitter_x"], d["jitter_y"]], dim=-1)
    else:
        jitter = torch.zeros(b, 2, device=device)
    margin = d["crop_margin_scale"]
    if flags.crop or force_crop:
        origin, side, reported = _crop_box(joints_rot_xy, jitter, margin)
        box = 2.0 * side
        crop_w = torch.clamp_max(origin[:, 0] + box, float(src_w)) - origin[:, 0]
        crop_h = torch.clamp_max(origin[:, 1] + box, float(src_h)) - origin[:, 1]
    else:
        origin = torch.zeros(b, 2, device=device)
        reported = torch.zeros(b, 2, device=device)
        crop_w = torch.full((b,), float(src_w), device=device)
        crop_h = torch.full((b,), float(src_h), device=device)
    # degenerate guard (side == 0 when all keypoints coincide)
    fw = float(out_w) / torch.clamp_min(crop_w, 1.0)
    fh = float(out_h) / torch.clamp_min(crop_h, 1.0)

    # source -> dest: scale(fw, fh) @ translate(-origin) @ rot
    shift = torch.zeros_like(rot)
    shift[:, 0, 2] = -origin[:, 0]
    shift[:, 1, 2] = -origin[:, 1]
    scale = torch.stack([fw, fh, torch.ones_like(fw)], dim=-1)[:, :, None]
    matrix = (rot + shift) * scale

    sx, sy = _warp_window_bounds((src_h, src_w), (out_h, out_w), params,
                                 flags.rotate)
    x = affine_warp_mxu(images_u8, matrix, (out_h, out_w),
                        interp=params.interpolation, max_scale_x=sx,
                        max_scale_y=sy, route=route,
                        compute_dtype=compute_dtype)
    joints_xy = torch.stack([
        (joints_rot_xy[..., 0] - origin[:, None, 0]) * fw[:, None],
        (joints_rot_xy[..., 1] - origin[:, None, 1]) * fh[:, None],
    ], dim=-1)
    joints = torch.cat([joints_xy, joints[..., 2:]], dim=-1)

    if flags.color_jitter:
        x = im.color_jitter(x, d["h"], d["s"], d["a"], d["b"])
    out_params = dict(d, angle=angle, jitter_x=reported[:, 0],
                      jitter_y=reported[:, 1], crop_margin_scale=margin)
    return AugmentOutput(images=x / 255.0, joints=joints, matrix=matrix,
                         params=out_params)


def augment_pair(generator: Optional[torch.Generator], images_u8: torch.Tensor,
                 joints25d: torch.Tensor, flags: AugmentationFlags,
                 params: AugmentationParams, normalize: bool = True,
                 draws: Optional[Dict[str, torch.Tensor]] = None,
                 route: str = "grouped",
                 compute_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[AugmentOutput, AugmentOutput]:
    """Two views of the same batch, the PeCLR sample: one `apply` over the
    doubled batch (2B draws, fresh from `generator` unless given), crop
    always on (zero jitter when the crop flag is off), ImageNet
    normalisation when `normalize`."""
    b = images_u8.shape[0]
    if draws is None:
        draws = draw(generator, 2 * b, flags, params)
    both = apply(torch.cat([images_u8, images_u8]),
                 torch.cat([joints25d, joints25d]), draws, flags, params,
                 force_crop=True, zero_jitter=not flags.crop, route=route,
                 compute_dtype=compute_dtype)
    if normalize:
        both = dataclasses.replace(both,
                                   images=im.normalize_imagenet(both.images))

    def half(i):
        sl = slice(i * b, (i + 1) * b)
        return AugmentOutput(images=both.images[sl], joints=both.joints[sl],
                             matrix=both.matrix[sl],
                             params={k: v[sl] for k, v in both.params.items()})

    return half(0), half(1)
