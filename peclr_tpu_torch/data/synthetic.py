"""Seeded stand-ins for frames, intrinsics, weights and datasets.

The smoke run on the card and the tests drive the port without any
downloaded data or weights: frames, camera intrinsics, RN25DPose and PeCLR
weights, and miniature FreiHAND-layout datasets on disk are made here from
a seed with numpy, so the same inputs can be handed to the reference.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from peclr_tpu_torch.geometry.joints import permutation
from peclr_tpu_torch.models.rn25d import K_DEFAULT
from peclr_tpu_torch.utils.io import save_json


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


# --------------------------------------------------------------------------
# FreiHAND-layout datasets on disk (port of peclr_tpu/data/synthetic.py:
# _random_hand_3d, _render, generate_freihand_like,
# generate_freihand_eval_like; the same numpy streams and files)

_FH_K = [[388.9, 0.0, 112.0], [0.0, 388.7, 112.0], [0.0, 0.0, 1.0]]


def _random_hand_3d(rng) -> np.ndarray:
    """A plausible 21-joint hand in ait order, metric metres."""
    wrist = np.array([0.0, 0.0, 0.0])
    joints = [wrist]
    for finger in range(5):
        ang = (finger - 2) * 0.35 + rng.normal(0, 0.08)
        direction = np.array([np.sin(ang), -np.cos(ang), rng.normal(0, 0.15)])
        direction /= np.linalg.norm(direction)
        base = 0.09 + rng.normal(0, 0.004)
        for dist in (base, base * 1.35, base * 1.6, base * 1.8):
            joints.append(wrist + direction * dist)
    # finger-major (wrist, f0 mcp..tip, f1 ...) -> ring-major (ait)
    ait = np.zeros((21, 3), np.float32)
    ait[0] = wrist
    for finger in range(5):
        for ring in range(4):
            ait[1 + ring * 5 + finger] = joints[1 + finger * 4 + ring]
    center = np.array(
        [rng.uniform(-0.03, 0.03), rng.uniform(-0.03, 0.03), rng.uniform(0.45, 0.6)]
    )
    return (ait + center).astype(np.float32)


def _render(joints3d, K, rng, size=224) -> np.ndarray:
    """Dots at the projected joints on a noisy background (uint8 RGB)."""
    img = rng.integers(30, 90, size=(size, size, 3), dtype=np.uint8)
    uv = (K @ joints3d.T).T
    uv = uv[:, :2] / uv[:, 2:3]
    color = rng.integers(120, 255, size=3)
    for x, y in uv:
        xi, yi = int(x), int(y)
        if 2 <= xi < size - 2 and 2 <= yi < size - 2:
            img[yi - 2: yi + 3, xi - 2: xi + 3] = color
    return img


def _jpeg_writer():
    """JPEG writer: cv2 (its default quality) where installed, else PIL at
    quality 92, as the reference's generator."""
    try:
        import cv2

        def save(path, img):
            cv2.imwrite(path, img[:, :, ::-1])
    except ImportError:
        from PIL import Image

        def save(path, img):
            Image.fromarray(img).save(path, quality=92)
    return save


def generate_freihand_like(root_dir: str, num_unique: int = 32, seed: int = 0,
                           size: int = 224) -> str:
    """A miniature FreiHAND-layout training set under root_dir: num_unique
    frames x 4 'versions' (the same frame written 4 times) in training/rgb/,
    and training_{xyz,K,scale}.json with the joints in FreiHAND order.
    Returns root_dir."""
    rng = np.random.default_rng(seed)
    rgb = os.path.join(root_dir, "training", "rgb")
    os.makedirs(rgb, exist_ok=True)
    ait_to_fh = permutation("ait", "freihand")
    save = _jpeg_writer()

    xyz, Ks, scales, images = [], [], [], []
    for _ in range(num_unique):
        joints_ait = _random_hand_3d(rng)
        K = np.asarray(_FH_K, np.float32)
        images.append(_render(joints_ait, K, rng, size))
        xyz.append(joints_ait[ait_to_fh].tolist())
        Ks.append(K.tolist())
        scales.append(float(np.linalg.norm(joints_ait[2] - joints_ait[0])))
    for version in range(4):
        for i, img in enumerate(images):
            save(os.path.join(rgb, f"{version * num_unique + i:08d}.jpg"), img)
    for name, obj in (("xyz", xyz), ("K", Ks), ("scale", scales)):
        save_json(obj, os.path.join(root_dir, f"training_{name}.json"))
    return root_dir


def generate_freihand_eval_like(root_dir: str, num_images: int = 8,
                                seed: int = 1, size: int = 224) -> str:
    """A miniature FreiHAND evaluation split (images, K and metric scale; no
    joint labels).  Returns root_dir."""
    rng = np.random.default_rng(seed)
    rgb = os.path.join(root_dir, "evaluation", "rgb")
    os.makedirs(rgb, exist_ok=True)
    save = _jpeg_writer()
    Ks, scales = [], []
    for i in range(num_images):
        joints_ait = _random_hand_3d(rng)
        K = np.asarray(_FH_K, np.float32)
        save(os.path.join(rgb, f"{i:08d}.jpg"), _render(joints_ait, K, rng, size))
        Ks.append(K.tolist())
        scales.append(float(np.linalg.norm(joints_ait[2] - joints_ait[0])))
    for name, obj in (("K", Ks), ("scale", scales)):
        save_json(obj, os.path.join(root_dir, f"evaluation_{name}.json"))
    return root_dir
