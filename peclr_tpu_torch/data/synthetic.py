"""Seeded stand-ins for frames, intrinsics and weights.

The smoke run on the card and the tests drive the port without any data or
weight files: frames, camera intrinsics and RN25DPose weights are made here
from a seed with numpy, so the same inputs can be handed to the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from peclr_tpu_torch.models.rn25d import K_DEFAULT


def seeded_frames(n: int, seed: int, size: int = 224) -> np.ndarray:
    """(n, size, size, 3) uint8 frames: a low-frequency colour field plus
    noise, so the warp's taps see structure."""
    rng = np.random.default_rng(seed)
    cells = 8
    coarse = rng.uniform(0, 255, (n, cells, cells, 3)).astype(np.float32)
    rep = -(-size // cells)
    frames = np.repeat(np.repeat(coarse, rep, axis=1), rep, axis=2)
    frames = frames[:, :size, :size]
    frames += rng.normal(0, 12, frames.shape).astype(np.float32)
    return np.clip(frames, 0, 255).astype(np.uint8)


def seeded_intrinsics(n: int, seed: int) -> np.ndarray:
    """(n, 3, 3) float32 K: FreiHAND's default with the focal length varied
    by up to 10%."""
    rng = np.random.default_rng(seed)
    K = np.broadcast_to(np.asarray(K_DEFAULT, np.float32), (n, 3, 3)).copy()
    K[:, 0, 0] *= rng.uniform(0.9, 1.1, n).astype(np.float32)
    K[:, 1, 1] = K[:, 0, 0]
    return K


def _seeded_variables(shapes, mapping, seed: int, last_bn: str,
                      fill=None) -> Dict[str, dict]:
    """Weights in the reference's flax layout made from a seed: He-normal
    convs, dense layers at 1/sqrt(fan_in), eval-mode BatchNorm statistics,
    a damped last BN in each residual branch.  `fill(torch_name, shape, rng)`
    may give an entry its own value."""
    rng = np.random.default_rng(seed)
    variables: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for torch_name, coll, path, kind in mapping:
        shape = shapes[torch_name]
        field = torch_name.rsplit(".", 1)[-1]
        value = fill(torch_name, shape, rng) if fill else None
        if value is not None:
            pass
        elif kind == "conv":
            fan_in = shape[1] * shape[2] * shape[3]
            value = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
            value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif kind == "dense_w":
            value = rng.normal(0, np.sqrt(1.0 / shape[1]), shape).T
        elif field == "running_var":
            value = rng.uniform(0.5, 1.5, shape)
        elif field == "weight":  # BN scale
            damp = last_bn in torch_name or ".downsample.1." in torch_name
            value = np.full(shape, 0.2 if damp else 1.0)
        else:  # BN bias, running mean, linear bias
            value = rng.normal(0, 0.05, shape)
        node = variables[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(value, np.float32)
    return variables


def _last_bn(size: str) -> str:
    from peclr_tpu_torch.models.resnet import RESNET_SPECS

    return ".bn3." if RESNET_SPECS[size][0] == "bottleneck" else ".bn2."


def seeded_rn25d_variables(size: str, seed: int) -> Dict[str, dict]:
    """RN25DPose weights in the reference's flax layout ({'params',
    'batch_stats'} nested dicts of float32 numpy arrays), made from a seed,
    with an fc whose bias places the keypoints inside the 224 crop.
    `models.port.rn25d_variables_to_state_dict` carries them into the
    port."""
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_mapping

    shapes = {k: tuple(v.shape) for k, v in RN25DPose(size).state_dict().items()}

    def fill(torch_name, shape, rng):
        if torch_name == "backend_model.fc.weight":
            return rng.normal(0, 0.02, shape).T  # (out, in) -> (in, out)
        if torch_name == "backend_model.fc.bias":
            value = np.zeros(shape)
            kp = value[:63].reshape(21, 3)
            kp[:, :2] = rng.uniform(70, 150, (21, 2))
            kp[:, 2] = rng.uniform(-0.1, 0.1, 21)
            return value
        return None

    return _seeded_variables(shapes, rn25d_mapping(size), seed,
                             _last_bn(size), fill)


def seeded_peclr_variables(size: str, seed: int) -> Dict[str, dict]:
    """PeCLRModel weights (encoder + projection head) in the reference's
    flax layout, made from a seed; `models.port.peclr_variables_to_state_dict`
    carries them into the port."""
    from peclr_tpu_torch.models import PeCLRModel
    from peclr_tpu_torch.models.port import peclr_mapping

    shapes = {k: tuple(v.shape) for k, v in PeCLRModel(size).state_dict().items()}
    return _seeded_variables(shapes, peclr_mapping(size), seed, _last_bn(size))
