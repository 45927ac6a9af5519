"""Builders of the pretrain recipe (port of peclr_tpu/train/recipe.py):
the model, its optimizer and state, and synthetic device-resident batches,
pretraining's and fine-tuning's.  All default to the card."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
from peclr_tpu_torch.device import DeviceLike, resolve_device
from peclr_tpu_torch.geometry.camera import convert_to_2_5d
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.port import peclr_variables_to_state_dict
from peclr_tpu_torch.train.optimizer import PretrainOptimizer, build_optimizer
from peclr_tpu_torch.train.state import TrainState


def build_pretrain_state(resnet: str = "50", batch: int = 128, accum: int = 16,
                         seed: int = 0, device: DeviceLike = None,
                         optimizer: str = "LARS"
                         ) -> Tuple[PeCLRModel, TrainState, PretrainOptimizer]:
    """(model, state, optimizer) of the PeCLR pretrain recipe, with weights
    made from `seed` in the reference's layout (seeded_peclr_variables) and
    the reference's schedule (1000 steps an epoch, 100 epochs, 10 of
    warmup) for `optimizer` (LARS, or adam as the reference's ablation)."""
    dev = resolve_device(device)
    model = PeCLRModel(resnet)
    model.load_state_dict(peclr_variables_to_state_dict(
        seeded_peclr_variables(resnet, seed), resnet), strict=True)
    model.to(dev)
    opt, _ = build_optimizer(model, base_lr=1e-4, batch_size=batch,
                             accum=accum, steps_per_epoch=1000, epochs=100,
                             warmup_epochs=10, optimizer=optimizer)
    return model, TrainState(model, opt), opt


def synthetic_pretrain_batch(n: int, canvas: int = 224, seed: int = 0,
                             device: DeviceLike = None
                             ) -> Dict[str, torch.Tensor]:
    """Synthetic uint8 canvases and plausible keypoints on the device, the
    same numbers as the reference's synthetic_pretrain_batch."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, size=(n, canvas, canvas, 3), dtype=np.uint8)
    joints = np.concatenate([
        rng.uniform(0.27 * canvas, 0.71 * canvas, (n, 21, 2)).astype(np.float32),
        rng.normal(size=(n, 21, 1)).astype(np.float32),
    ], axis=-1)
    return {"image": torch.from_numpy(image).to(dev),
            "joints25d": torch.from_numpy(joints).to(dev)}


def synthetic_supervised_batch(n: int, canvas: int = 224, seed: int = 0,
                               device: DeviceLike = None
                               ) -> Dict[str, torch.Tensor]:
    """A synthetic FreiHAND-like supervised batch on the device, the same
    numbers as the reference's synthetic_supervised_batch: uint8 canvases,
    a pinhole K, 3D joints about 0.6 m deep back-projected from in-frame
    pixels, their 2.5D labels and scale (the contract that data/pipeline.py
    feeds the fine-tune step)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fx = rng.uniform(580.0, 620.0, n).astype(np.float32)
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = fx
    K[:, 1, 1] = fx
    K[:, 0, 2] = canvas / 2.0
    K[:, 1, 2] = canvas / 2.0
    K[:, 2, 2] = 1.0
    uv = rng.uniform(0.3 * canvas, 0.7 * canvas, (n, 21, 2)).astype(np.float32)
    z = (0.6 + 0.02 * rng.standard_normal((n, 21))).astype(np.float32)
    joints3d = np.empty((n, 21, 3), np.float32)
    joints3d[..., 0] = (uv[..., 0] - K[:, None, 0, 2]) * z / fx[:, None]
    joints3d[..., 1] = (uv[..., 1] - K[:, None, 1, 2]) * z / fx[:, None]
    joints3d[..., 2] = z
    image = rng.integers(0, 256, size=(n, canvas, canvas, 3), dtype=np.uint8)
    K_t, joints3d_t = torch.from_numpy(K), torch.from_numpy(joints3d)
    joints25d, scale = convert_to_2_5d(K_t, joints3d_t)
    out = {"image": torch.from_numpy(image), "joints25d": joints25d,
           "joints3d": joints3d_t, "K": K_t, "scale": scale,
           "joints_valid": torch.ones((n, 21, 1))}
    return {k: v.to(dev) for k, v in out.items()}
