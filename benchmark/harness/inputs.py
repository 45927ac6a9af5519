"""Inputs and weights made from the run's seed, on the device, in a few
large calls, the same for the program and the reference.

Each kind of draw has a stream of its own (`sub_seed`), so a seed gives
the same weights whatever the traffic, and the same frames whatever the
weights.  Frames are a low-frequency colour field plus noise (the warp's
taps see structure), as uint8.  Weights follow the layouts of
reference/models.py: He-normal convolutions, dense layers at
1/sqrt(fan_in), BatchNorm scale 1 (0.2 on the last BatchNorm of each
residual branch and of each downsample, so that a deep trunk stays in
range in eval mode), small normal BatchNorm biases and running means,
running variances in [0.5, 1.5]; RN25D's fc puts the keypoints inside the
224 crop (uv in [70, 150], relative depth in [-0.1, 0.1]).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import models

STREAMS = {"weights": 1, "images": 2, "draws": 3, "sample": 4}
#: FreiHAND's default intrinsics for 224 x 224 crops
K_FREIHAND = ((388.9018310596544, 0.0, 112.0), (0.0, 388.71231836584275, 112.0),
              (0.0, 0.0, 1.0))


def sub_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one stream of draws of the run's seed."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, STREAMS[stream], index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device, index: int = 0
              ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream,
                                                               index))


def _fan_in(shape) -> int:
    return int(np.prod(shape[1:]))


def make_weights(layout: List[models.Leaf], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """A state dict for `layout`, from one normal and one uniform draw."""
    gen = generator(seed, "weights", device)
    sizes = [int(np.prod(shape)) for _, shape, _ in layout]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(layout, sizes):
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "conv" or kind == "conv_stem":
            t = z * math.sqrt(2.0 / _fan_in(shape))
        elif kind == "dense":
            t = z * math.sqrt(1.0 / shape[1])
        elif kind == "fc_weight":
            t = z * 0.02
        elif kind == "fc_bias":
            t = torch.zeros(shape, device=device)
            kp = torch.cat([70.0 + 80.0 * u[:63].view(21, 3)[:, :2],
                            -0.1 + 0.2 * u[:63].view(21, 3)[:, 2:]], dim=1)
            t[:63] = kp.reshape(-1)
        elif kind == "bn_weight":
            t = torch.ones(shape, device=device)
        elif kind == "bn_weight_damped":
            t = torch.full(shape, 0.2, device=device)
        elif kind == "bn_var":
            t = 0.5 + u
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.long, device=device)
        else:  # BatchNorm bias and running mean, dense bias
            t = z * 0.05
        out[name] = t.contiguous()
    return out


def frames(n: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, size, size, 3) uint8: an 8 x 8 colour field plus N(0, 12) noise."""
    cells = 8
    rep = -(-size // cells)
    coarse = torch.rand((n, cells, cells, 3), generator=gen,
                        device=device) * 255.0
    field = coarse.repeat_interleave(rep, 1).repeat_interleave(rep, 2)
    field = field[:, :size, :size]
    noise = torch.randn((n, size, size, 3), generator=gen, device=device)
    return (field + 12.0 * noise).clamp_(0.0, 255.0).to(torch.uint8)


def pretrain_batch(n: int, canvas: int, gen, device) -> Dict[str, torch.Tensor]:
    """Canvases and keypoints as the recipe's synthetic batch draws them:
    uv uniform in [0.27, 0.71] of the canvas, relative depth N(0, 1)."""
    image = frames(n, canvas, gen, device)
    uv = canvas * (0.27 + 0.44 * torch.rand((n, 21, 2), generator=gen,
                                           device=device))
    z = torch.randn((n, 21, 1), generator=gen, device=device)
    return {"image": image, "joints25d": torch.cat([uv, z], dim=-1)}


def to_25d(K, joints3d):
    """Project 3D joints (ait order: wrist 0, index_mcp 2) to 2.5D: pixel
    uv and depth relative to the wrist over the wrist -> index_mcp bone."""
    bone = joints3d[:, 2] - joints3d[:, 0]
    scale = torch.sqrt((bone * bone).sum(dim=-1))
    uvw = torch.einsum("bij,bnj->bni", K, joints3d) / joints3d[..., 2:3]
    zrel = (joints3d[..., 2] - joints3d[:, :1, 2]) / scale[:, None]
    return torch.cat([uvw[..., :2], zrel[..., None]], dim=-1), scale


def supervised_batch(n: int, canvas: int, gen, device) -> Dict[str, torch.Tensor]:
    """A FreiHAND-like labelled batch: frames, a pinhole K (focal 580-620),
    3D joints about 0.6 m deep back-projected from in-frame pixels, their
    2.5D labels and scale, all joints valid."""
    fx = 580.0 + 40.0 * torch.rand(n, generator=gen, device=device)
    K = torch.zeros(n, 3, 3, device=device)
    K[:, 0, 0] = fx
    K[:, 1, 1] = fx
    K[:, 0, 2] = canvas / 2.0
    K[:, 1, 2] = canvas / 2.0
    K[:, 2, 2] = 1.0
    uv = canvas * (0.3 + 0.4 * torch.rand((n, 21, 2), generator=gen,
                                         device=device))
    z = 0.6 + 0.02 * torch.randn((n, 21), generator=gen, device=device)
    j3 = torch.stack([(uv[..., 0] - canvas / 2.0) * z / fx[:, None],
                      (uv[..., 1] - canvas / 2.0) * z / fx[:, None], z], -1)
    image = frames(n, canvas, gen, device)
    j25, scale = to_25d(K, j3)
    return {"image": image, "joints25d": j25, "joints3d": j3, "K": K,
            "scale": scale, "joints_valid": torch.ones(n, 21, 1,
                                                       device=device)}


def pred_batch(n: int, gen, device) -> Dict[str, torch.Tensor]:
    """Leaderboard frames (224 x 224) with FreiHAND's K, the focal length
    varied by up to 10%."""
    image = frames(n, 224, gen, device)
    K = torch.tensor(K_FREIHAND, device=device).repeat(n, 1, 1)
    f = 0.9 + 0.2 * torch.rand(n, generator=gen, device=device)
    K[:, 0, 0] = K[:, 0, 0] * f
    K[:, 1, 1] = K[:, 0, 0]
    return {"image": image, "K": K}
