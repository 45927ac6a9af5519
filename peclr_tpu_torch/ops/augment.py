"""Batched augmentation of the PeCLR pretrain step (port of
peclr_tpu/ops/augment.py, all 11 flags).

In the reference's order: sobel -> cut-out -> blur -> the geometric chain
(rotate ∘ crop ∘ resize, one affine map per sample, applied by the warp) ->
colour jitter -> noise -> colour drop -> /255 -> [ImageNet normalisation],
this photometric tail one kernel on the card (ops/photometric.py), inside
a `warp.photometric` span (the warp's kind: it runs inside whatever step
span is open, as `warp.shift` does).  The per-sample parameters that the
equivariant loss inverts come out beside the views.

torch cannot replay jax.random, so each transform is split in two:
`draw(generator, n, ...)` makes the random parameters and `apply(images,
joints, draws, ...)` is deterministic.  A draw holds the ten keys of the
reference's `AugmentOutput.params` (PARAM_KEYS) and, for the flags outside
the recipe that are on, the draws that only `apply` consumes (the
sobel/cut-out/noise/drop coins, the cut-out's joint, fraction and fill, the
noise); `apply` reports the ten keys alone.  `jitter_x`/`jitter_y` in a
draw are the negated crop-box jitter, -trunc(U[0, 15)): apply places the
crop origin at max(centre - side - jitter, 0), so the reference's reported
jitter (centre - side - origin) handed back to apply reproduces its crop
exactly.

The warp's route: "grouped", "matmul" or "nhwc" (ops/warp_mxu.py:ROUTES,
the two-pass warp and its kernels) or "gather" (ops/warp.py, the
reference's WARP_BACKEND = "gather", no kernel).  Under sobel, cut-out or
blur the source turns f32 before the warp, which reads it in its compute
dtype (bf16 on the card); otherwise it stays uint8.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from peclr_tpu_torch.config.defaults import AugmentationFlags, AugmentationParams
from peclr_tpu_torch.geometry.affine import rotation_about_center
from peclr_tpu_torch.ops import image as im
from peclr_tpu_torch.ops.photometric import photometric
from peclr_tpu_torch.ops.warp import affine_warp as affine_warp_gather
from peclr_tpu_torch.ops.warp_mxu import ROUTES as MXU_ROUTES
from peclr_tpu_torch.ops.warp_mxu import affine_warp_mxu
from peclr_tpu_torch.utils.profiler import span

#: the warp routes: the two-pass warp's three, then the gather warp
ROUTES = MXU_ROUTES + ("gather",)

#: the per-sample parameters the reference's AugmentOutput.params holds
PARAM_KEYS = ("angle", "jitter_x", "jitter_y", "h", "s", "a", "b", "sigma",
              "blur_flag", "crop_margin_scale")

#: cut-out anchors on one of joints [0, 20): jax.random.randint's upper end
#: is exclusive, so the reference never picks joint 20
CUT_OUT_JOINTS = 20


@dataclasses.dataclass
class AugmentOutput:
    images: torch.Tensor  # (B, out_h, out_w, 3) float32, [0, 1] or normalized
    joints: torch.Tensor  # (B, 21, 3) transformed 2.5D keypoints
    matrix: torch.Tensor  # (B, 3, 3) source -> dest affine
    params: Dict[str, torch.Tensor]  # per-sample augmentation parameters


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
    """The random parameters of n samples, on the generator's device.

    The recipe's draws come first, in the order they always had, so a
    generator gives the recipe the same tensors whatever else is drawn; the
    draws of the flags outside the recipe follow, only for the flags that
    are on.  Coins are Bernoulli(0.5) as 0/1 floats; the cut-out's joint is
    in [0, 20) and its fill in [0, 255), upper ends exclusive as in
    jax.random.randint; the noise is a standard normal of the views'
    shape, scaled by params.noise_std in `apply`."""
    device = generator.device

    def uniform(shape, bounds):
        lo, hi = bounds
        u = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    def coin():
        return (torch.rand(n, generator=generator, device=device)
                < 0.5).float()

    def randint(hi):
        return torch.randint(0, hi, (n,), generator=generator,
                             device=device).float()

    zeros = torch.zeros(n, device=device)
    angle = (torch.floor(uniform(n, (params.min_angle, params.max_angle)))
             if flags.rotate else zeros)
    jitter = (torch.trunc(uniform((n, 2), params.crop_box_jitter))
              if flags.crop else torch.zeros(n, 2, device=device))
    margin = (uniform(n, params.crop_margin_range) if flags.random_crop
              else torch.full((n,), params.crop_margin, device=device))
    d = {
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
    if flags.sobel_filter:
        d["sobel_flag"] = coin()
    if flags.cut_out:
        d["cut_out_flag"] = coin()
        d["cut_out_joint"] = randint(CUT_OUT_JOINTS)
        d["cut_out_fraction"] = uniform(n, params.cut_out_fraction)
        d["cut_out_fill"] = randint(255)
    if flags.gaussian_blur:
        d["blur_flag"] = coin()
    if flags.gaussian_noise:
        out_w, out_h = params.resize_shape
        d["noise_flag"] = coin()
        d["noise"] = torch.randn((n, out_h, out_w, 3), generator=generator,
                                 device=device)
    if flags.color_drop:
        d["drop_flag"] = coin()
    return d


@torch.no_grad()
def apply(images_u8: torch.Tensor, joints25d: torch.Tensor,
          draws: Dict[str, torch.Tensor], flags: AugmentationFlags,
          params: AugmentationParams, force_crop: bool = False,
          zero_jitter: bool = False, route: str = "grouped",
          compute_dtype: Optional[torch.dtype] = None,
          normalize: bool = False) -> AugmentOutput:
    """Transform one batch (one contrastive view) with the given draws.

    images_u8 (B, H, W, 3) uint8 canvases; joints25d (B, 21, 3) keypoints
    in source pixels (z untouched).  force_crop / zero_jitter: a crop always
    runs for contrastive samples, with its jitter pinned to 0 when the crop
    flag is off.  `route` is one of ROUTES.  Views come out at
    params.resize_shape, in [0, 1], or ImageNet-normalised with
    `normalize`; `params` of the output holds PARAM_KEYS."""
    if route not in ROUTES:
        raise ValueError(f"route={route!r}, want one of {ROUTES}")
    b, src_h, src_w, _ = images_u8.shape
    out_w, out_h = params.resize_shape
    device = images_u8.device
    d = {k: v.to(device=device, dtype=torch.float32) for k, v in draws.items()}
    joints = joints25d.to(torch.float32)
    # stay uint8 until an op before the warp needs floats: the warp's first
    # pass then reads a quarter of the bytes
    x = images_u8
    if flags.sobel_filter or flags.cut_out or flags.gaussian_blur:
        x = images_u8.to(torch.float32)

    if flags.sobel_filter:
        x = im.where_flag(d["sobel_flag"],
                          im.sobel_filter(x, params.sobel_kernel), x)
    if flags.cut_out:
        joint = d["cut_out_joint"].long()
        anchor = joints[torch.arange(b, device=device), joint, :2]
        cut = im.cutout(x, anchor, d["cut_out_fraction"], d["cut_out_fill"])
        x = im.where_flag(d["cut_out_flag"], cut, x)
    if flags.gaussian_blur:
        x = im.where_flag(d["blur_flag"], im.gaussian_blur(x, d["sigma"]), x)

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

    # the windows are sized before the route is picked, as in the reference,
    # so a range beyond 80° raises on the gather route too
    sx, sy = _warp_window_bounds((src_h, src_w), (out_h, out_w), params,
                                 flags.rotate)
    if route == "gather":
        x = affine_warp_gather(x, matrix, (out_h, out_w))
    else:
        x = affine_warp_mxu(x, matrix, (out_h, out_w),
                            interp=params.interpolation, max_scale_x=sx,
                            max_scale_y=sy, route=route,
                            compute_dtype=compute_dtype)
    joints_xy = torch.stack([
        (joints_rot_xy[..., 0] - origin[:, None, 0]) * fw[:, None],
        (joints_rot_xy[..., 1] - origin[:, None, 1]) * fh[:, None],
    ], dim=-1)
    joints = torch.cat([joints_xy, joints[..., 2:]], dim=-1)

    noise = flags.gaussian_noise
    with span("warp.photometric"):
        x = photometric(x, d["h"], d["s"], d["a"], d["b"],
                        noise=d["noise"] if noise else None,
                        noise_flag=d["noise_flag"] if noise else None,
                        drop_flag=d["drop_flag"] if flags.color_drop else None,
                        jitter=flags.color_jitter, normalize=normalize,
                        noise_std=params.noise_std)
    out_params = {k: d[k] for k in PARAM_KEYS}
    out_params.update(angle=angle, jitter_x=reported[:, 0],
                      jitter_y=reported[:, 1], crop_margin_scale=margin)
    return AugmentOutput(images=x, joints=joints, matrix=matrix,
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
                 compute_dtype=compute_dtype, normalize=normalize)

    def half(i):
        sl = slice(i * b, (i + 1) * b)
        return AugmentOutput(images=both.images[sl], joints=both.joints[sl],
                             matrix=both.matrix[sl],
                             params={k: v[sl] for k, v in both.params.items()})

    return half(0), half(1)


def relative_params(params1: Dict[str, torch.Tensor],
                    params2: Dict[str, torch.Tensor],
                    flags: AugmentationFlags) -> Dict[str, torch.Tensor]:
    """The relative transform between two views, the pairwise experiment's
    regression targets: the crop jitter's difference (B, 2), the colour
    factors' differences (B, 4), the blur flags' XOR (B, 1) and the
    rotation's difference mod 360 (B, 1), each where its flag is on."""
    rel: Dict[str, torch.Tensor] = {}
    if flags.crop:
        rel["jitter"] = torch.stack(
            [params1["jitter_x"] - params2["jitter_x"],
             params1["jitter_y"] - params2["jitter_y"]], dim=-1)
    if flags.color_jitter:
        rel["color_jitter"] = torch.stack(
            [params1[k] - params2[k] for k in ("h", "s", "a", "b")], dim=-1)
    if flags.gaussian_blur:
        rel["blur"] = torch.abs(params1["blur_flag"]
                                - params2["blur_flag"])[:, None]
    if flags.rotate:
        rel["rotation"] = torch.remainder(params1["angle"] - params2["angle"],
                                          360.0)[:, None]
    return rel
