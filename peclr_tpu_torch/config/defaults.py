"""Default configuration values (port of peclr_tpu/config/defaults.py).

The augmentation tier of the reference's JSON configs as plain
dataclasses; the model/optimizer tier's values that the pretrain recipe
uses are the defaults of train/recipe.py and train/optimizer.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass
class AugmentationFlags:
    color_drop: bool = False
    color_jitter: bool = False
    crop: bool = False
    cut_out: bool = False
    gaussian_blur: bool = False
    random_crop: bool = False
    resize: bool = False
    rotate: bool = False
    gaussian_noise: bool = False
    sobel_filter: bool = False
    flip: bool = False

    def active(self) -> List[str]:
        return [f.name for f in dataclasses.fields(self) if getattr(self, f.name)]


@dataclasses.dataclass
class AugmentationParams:
    crop_margin: float = 1.25
    crop_margin_range: Tuple[float, float] = (0.9, 1.5)
    cut_out_fraction: Tuple[float, float] = (0.0, 0.16)
    hue_factor_range: Tuple[float, float] = (0.01, 1.0)
    sat_factor_range: Tuple[float, float] = (0.01, 1.0)
    value_factor_alpha_range: Tuple[float, float] = (0.5, 1.0)
    value_factor_beta_range: Tuple[float, float] = (5.0, 20.0)
    max_angle: float = 45.0
    min_angle: float = -45.0
    resize_shape: Tuple[int, int] = (128, 128)
    crop_box_jitter: Tuple[float, float] = (0.0, 15.0)
    sobel_kernel: int = 3
    noise_std: float = 25.0
    #: resample taps for the warp: "area" matches the reference's
    #: cv2.INTER_AREA resize on downscale; "linear" is plain bilinear
    interpolation: str = "area"


def peclr_pretrain_flags() -> AugmentationFlags:
    """The published PeCLR recipe: crop + rotate + color jitter + resize."""
    return AugmentationFlags(
        crop=True, rotate=True, color_jitter=True, resize=True, random_crop=False
    )
