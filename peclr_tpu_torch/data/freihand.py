"""FreiHAND data source, index and labels only (port of
peclr_tpu/data/freihand.py).

The dataset directory holds training_{xyz,K,scale}.json (one entry per
unique frame) and training/rgb/ with 4 colourisation versions of each
frame, so sample index i maps to its labels through i % n_unique.  The
train/val split is a seeded split of the unique frames, replicated over
the 4 versions.  The evaluation split has no joint labels: a pseudo
bound box (0.33 of the 224 frame) drives the crop machinery instead.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from peclr_tpu_torch.geometry.camera import convert_2_5d_to_3d
from peclr_tpu_torch.geometry.joints import permutation
from peclr_tpu_torch.utils.io import read_json


def seeded_split(n: int, train_ratio: float, seed: int):
    """Seeded split of range(n) -> (train_idx, val_idx), each sorted:
    sklearn's train_test_split(random_state=seed), the reference's split,
    where sklearn is installed, else a RandomState permutation (the same
    contract, other frames)."""
    try:
        from sklearn.model_selection import train_test_split

        tr, va = train_test_split(
            np.arange(n), train_size=train_ratio, random_state=seed
        )
        return np.sort(tr), np.sort(va)
    except ImportError:
        rng = np.random.RandomState(seed)
        perm = rng.permutation(n)
        n_train = int(np.floor(train_ratio * n))
        return np.sort(perm[:n_train]), np.sort(perm[n_train:])


def pseudo_bound_box(scale: float = 0.33, crop_size: float = 224.0) -> np.ndarray:
    """(21, 3) pseudo-2D 'joints' spanning a centred box, homogeneous depth
    1: the evaluation split's stand-in label, used only to crop."""
    c = crop_size / 2.0
    s = c * scale
    corners = (
        [[0.0, 0.0, 0.0]]
        + [[s, s, 1.0]] * 5
        + [[-s, s, 1.0]] * 5
        + [[s, -s, 1.0]] * 5
        + [[-s, -s, 1.0]] * 5
    )
    box = np.asarray(corners, np.float32)
    box[:, 0] += c
    box[:, 1] += c
    return box


@dataclass
class FreihandSource:
    """Indexable FreiHAND metadata: image paths and per-sample labels."""

    root_dir: str
    split: str = "train"
    seed: int = 5
    train_ratio: float = 0.9

    def __post_init__(self):
        train_like = self.split in ("train", "val")
        sub = "training" if train_like else "evaluation"
        self.img_dir = os.path.join(self.root_dir, sub, "rgb")
        self.img_names = sorted(os.listdir(self.img_dir))
        self.K = np.asarray(
            read_json(os.path.join(self.root_dir, f"{sub}_K.json")), np.float32
        )
        self.metric_scale = np.asarray(
            read_json(os.path.join(self.root_dir, f"{sub}_scale.json")),
            np.float32,
        )
        if train_like:
            xyz = np.asarray(
                read_json(os.path.join(self.root_dir, "training_xyz.json")),
                np.float32,
            )
            self.joints3d = xyz[:, permutation("freihand", "ait"), :]
            n_unique = len(self.K)
            tr, va = seeded_split(n_unique, self.train_ratio, self.seed)
            base = tr if self.split == "train" else va
            self.indices = np.concatenate(
                [base + v * n_unique for v in range(4)], axis=0
            )
        else:
            self.joints3d = None
            self.indices = np.arange(len(self.K))

    def __len__(self):
        return len(self.indices)

    @property
    def n_unique(self) -> int:
        return len(self.K)

    @property
    def image_size(self):
        """(H, W) of the frames (FreiHAND's are all one size), from frame 0
        decoded once, by the pipeline's decoder order."""
        if not hasattr(self, "_image_size"):
            from peclr_tpu_torch.data.pipeline import decode_image

            img = decode_image(self.image_path(0))
            self._image_size = (img.shape[0], img.shape[1])
        return self._image_size

    def image_path(self, i: int) -> str:
        return os.path.join(self.img_dir, self.img_names[self.indices[i]])

    def record(self, i: int) -> dict:
        """Label record of sample i (no image bytes)."""
        idx = self.indices[i]
        if self.joints3d is not None:
            uid = idx % self.n_unique
            return {
                "K": self.K[uid],
                "joints3d": self.joints3d[uid],
                "joints_valid": np.ones((21, 1), np.float32),
                "metric_scale": self.metric_scale[uid],
            }
        K = self.K[idx]
        joints3d = convert_2_5d_to_3d(
            torch.from_numpy(pseudo_bound_box()), torch.tensor(1.0),
            torch.from_numpy(K),
        ).numpy()
        return {
            "K": K,
            "joints3d": joints3d,
            "joints_valid": np.ones((21, 1), np.float32),
            "metric_scale": self.metric_scale[idx],
        }
