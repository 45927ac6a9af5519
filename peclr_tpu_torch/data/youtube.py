"""YouTube-3D-Hands data source, host side (port of
peclr_tpu/data/youtube.py; the same cache files under the same names).

The raw COCO-style youtube_{split}.json is condensed on first use into
youtube_{split}_{joints,images}.json (21 joints regressed from each MANO
mesh), an availability scan writes youtube_{split}_invalid_index.csv, and
left hands are mirrored at read time.  The labels are pseudo-2D: K is the
identity, depth is 1, joints_valid is 0 (they only drive cropping);
`joints_raw` keeps the original coordinates.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from peclr_tpu_torch.geometry.joints import permutation
from peclr_tpu_torch.geometry.mano import joints_from_mano_mesh
from peclr_tpu_torch.utils.io import read_json, save_json


def condense_annotations(root_dir: str, split: str):
    """Vertices -> 21 joints, once: returns (joints_list, images_list) and
    writes both caches next to the raw json."""
    joints_path = os.path.join(root_dir, f"youtube_{split}_joints.json")
    images_path = os.path.join(root_dir, f"youtube_{split}_images.json")
    if os.path.exists(joints_path) and os.path.exists(images_path):
        return read_json(joints_path), read_json(images_path)

    data = read_json(os.path.join(root_dir, f"youtube_{split}.json"))
    images = data["images"]
    save_json(images, images_path)
    condensed = []
    for ann in data["annotations"]:
        joints21 = joints_from_mano_mesh(np.asarray(ann["vertices"], np.float32))
        condensed.append({
            **{k: v for k, v in ann.items() if k != "vertices"},
            "joints": joints21.tolist(),
        })
    save_json(condensed, joints_path)
    return condensed, images


def availability_scan(root_dir: str, split: str, joints_list, images_by_id):
    """Write youtube_{split}_invalid_index.csv, marking the annotations whose
    frame JPEG exists; returns the valid annotation indices."""
    csv_path = os.path.join(root_dir, f"youtube_{split}_invalid_index.csv")
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            valid_idx = [int(row["joint_idx"]) for row in csv.DictReader(f)
                         if row["valid"] in ("True", "1", "true")]
        return np.asarray(valid_idx, np.int64)

    rows = []
    valid_idx = []
    for i, ann in enumerate(joints_list):
        name = images_by_id[ann["image_id"]]["name"].replace(".png", ".jpg")
        ok = os.path.isfile(os.path.join(root_dir, name))
        rows.append((i, ok, name))
        if ok:
            valid_idx.append(i)
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["joint_idx", "valid", "image"])
        w.writerows(rows)
    return np.asarray(valid_idx, np.int64)


@dataclass
class YoutubeSource:
    """Indexable YT3DH metadata (weak labels: 2D-only pseudo labels)."""

    root_dir: str
    split: str = "train"

    def __post_init__(self):
        self.joints_list, images = condense_annotations(self.root_dir, self.split)
        self.images_by_id = {img["id"]: img for img in images}
        self.indices = availability_scan(
            self.root_dir, self.split, self.joints_list, self.images_by_id
        )
        self._mano_to_ait = permutation("mano", "ait")

    def __len__(self):
        return len(self.indices)

    def image_path(self, i: int) -> str:
        ann = self.joints_list[self.indices[i]]
        name = self.images_by_id[ann["image_id"]]["name"].replace(".png", ".jpg")
        return os.path.join(self.root_dir, name)

    def record(self, i: int) -> dict:
        ann = self.joints_list[self.indices[i]]
        img_meta = self.images_by_id[ann["image_id"]]
        joints = np.asarray(ann["joints"], np.float32)[self._mano_to_ait]
        flip = bool(ann.get("is_left", 0))
        if flip:
            joints[:, 0] = float(img_meta["width"]) - joints[:, 0]
        joints_raw = joints.copy()
        joints[:, 2] = 1.0  # homogeneous depth for the identity-K crop path
        return {
            "K": np.eye(3, dtype=np.float32),
            "joints3d": joints,
            "joints_valid": np.zeros((21, 1), np.float32),
            "joints_raw": joints_raw,
            "flip": flip,
            "metric_scale": np.float32(1.0),
        }
