"""The augmented-pair figure the trainer logs each epoch (port of
peclr_tpu/utils/visualize.py:plot_peclr_pair and the helpers it calls).

Host-side only: matplotlib is imported inside the functions, and a figure
is written as a PNG under the experiment's directory.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from peclr_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD


def unnormalize_images(images: np.ndarray) -> np.ndarray:
    """ImageNet-normalized (B, H, W, 3) -> displayable [0, 1]."""
    out = (np.asarray(images) * np.asarray(IMAGENET_STD, np.float32)
           + np.asarray(IMAGENET_MEAN, np.float32))
    return np.clip(out, 0.0, 1.0)


def _savefig(fig, out_dir: Optional[str], name: str) -> Optional[str]:
    if out_dir is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


def plot_peclr_pair(img1: np.ndarray, img2: np.ndarray,
                    params: Dict[str, np.ndarray], sample_idx: int = 0,
                    out_dir: Optional[str] = None,
                    name: str = "peclr_pair.png") -> Optional[str]:
    """The two augmented views of a sample, titled with each view's
    equivariance parameters (angle, crop jitter)."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    for view, (ax, img) in enumerate(((axes[0], img1), (axes[1], img2)), 1):
        ax.imshow(unnormalize_images(img[None])[0] if img.max() <= 8.0 else img)
        angle = params.get(f"angle_{view}")
        jx = params.get(f"jitter_x_{view}")
        jy = params.get(f"jitter_y_{view}")
        bits = [f"view {view}"]
        if angle is not None:
            bits.append(f"angle={float(np.asarray(angle).ravel()[sample_idx]):.0f}")
        if jx is not None:
            bits.append(
                f"jitter=({float(np.asarray(jx).ravel()[sample_idx]):.0f},"
                f"{float(np.asarray(jy).ravel()[sample_idx]):.0f})"
            )
        ax.set_title(" ".join(bits))
        ax.axis("off")
    return _savefig(fig, out_dir, name)
