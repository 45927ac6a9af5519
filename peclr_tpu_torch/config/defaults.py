"""Default configuration values (port of peclr_tpu/config/defaults.py).

The reference's two JSON config tiers as plain dataclasses: data and
augmentation (`TrainConfig`, `AugmentationFlags`, `AugmentationParams`)
and model and optimizer (`ModelConfig`), with the same fields and
defaults.  CLI overrides merge on top (cli/train.py:configs_from_args);
derived quantities (steps per epoch) are computed by the training loop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


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


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 128
    accumulate_grad_batches: int = 1
    epochs: int = 50
    train_ratio: float = 0.9999999999
    num_workers: int = 8
    seed: int = 5
    precision: str = "bf16"  # bf16 autocast on the card (train/step.py)
    use_palm: bool = False
    sources: Tuple[str, ...] = ("freihand",)
    augmentation_flags: AugmentationFlags = dataclasses.field(
        default_factory=AugmentationFlags
    )
    augmentation_params: AugmentationParams = dataclasses.field(
        default_factory=AugmentationParams
    )


@dataclasses.dataclass
class ModelConfig:
    """The model/optimizer tier (the reference's hybrid2_config.json)."""

    batch_size: int = 128
    lr: float = 1e-4
    opt_weight_decay: float = 1e-6
    output_dim: int = 128
    projection_head_hidden_dim: int = 512
    projection_head_input_dim: int = 2048
    warmup_epochs: int = 10
    num_of_mini_batch: int = 1  # grad-accumulation factor
    augmentation: Tuple[str, ...] = ()
    optimizer: str = "LARS"
    resnet_size: str = "50"
    lr_max_epochs: Optional[int] = None
    #: "hybrid2" = PeCLR (equivariant inverse transforms); "simclr" =
    #: invariant baseline (no transforms in projection space)
    experiment_type: str = "hybrid2"
    # derived at runtime:
    num_samples: int = 0
    epochs: int = 50


def peclr_pretrain_flags() -> AugmentationFlags:
    """The published PeCLR recipe: crop + rotate + color jitter + resize."""
    return AugmentationFlags(
        crop=True, rotate=True, color_jitter=True, resize=True, random_crop=False
    )
