"""Debug and tracking figures (port of peclr_tpu/utils/visualize.py): 21-joint
hand skeletons with a colour per bone (FreiHAND bone topology: each finger
chains mcp -> pip -> dip -> tip from the wrist), truth-against-prediction
overlays, and the augmented pairs the trainer logs each epoch.

Host-side only: matplotlib is imported inside the functions (the card's
host has none), and a figure is written as a PNG under `out_dir`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from peclr_tpu_torch.geometry.joints import permutation
from peclr_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

#: per-finger base colours (thumb .. pinky), 4 shades a finger
_FINGER_BASE = np.array([
    [0.8, 0.1, 0.1],  # thumb: red
    [0.1, 0.7, 0.1],  # index: green
    [0.1, 0.3, 0.9],  # middle: blue
    [0.8, 0.7, 0.1],  # ring: yellow
    [0.7, 0.1, 0.8],  # pinky: magenta
])


def bone_colors() -> np.ndarray:
    """(20, 3) RGB, one a bone."""
    shades = np.linspace(0.5, 1.0, 4)
    return np.concatenate(
        [_FINGER_BASE[f] * s for f in range(5) for s in shades]
    ).reshape(20, 3)


def plot_hand(axis, coords_ait: np.ndarray, plot_3d: bool = False,
              linewidth: float = 1.0, linestyle: str = "-", alpha: float = 1.0,
              ms: float = 2.0) -> None:
    """Draw a 21-joint hand skeleton, (21, 2|3) in ait order, on a
    matplotlib axis (2D or 3D)."""
    coords = np.asarray(coords_ait)[permutation("ait", "freihand")]
    colors = bone_colors()
    for i in range(20):
        parent = 0 if i % 4 == 0 else i
        seg = np.stack([coords[parent], coords[i + 1]])
        axis.plot(*(seg[:, d] for d in range(3 if plot_3d else 2)),
                  color=colors[i], linewidth=linewidth, linestyle=linestyle,
                  alpha=alpha)
    axis.scatter(*(coords[:, d] for d in range(3 if plot_3d else 2)), s=ms)


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


def _show(ax, img: np.ndarray) -> None:
    """An image, unnormalized first if ImageNet-normalized."""
    ax.imshow(unnormalize_images(img[None])[0] if img.max() <= 8.0 else img)


def plot_truth_vs_prediction(pred_ait: np.ndarray, true_ait: np.ndarray,
                             image: np.ndarray, out_dir: Optional[str] = None,
                             name: str = "truth_vs_pred.png") -> Optional[str]:
    """Ground truth and prediction skeletons over the image, side by side."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    for ax, coords, title in ((axes[0], true_ait, "ground truth"),
                              (axes[1], pred_ait, "prediction")):
        _show(ax, image)
        plot_hand(ax, coords)
        ax.set_title(title)
        ax.axis("off")
    return _savefig(fig, out_dir, name)


def plot_simclr_pair(img1: np.ndarray, img2: np.ndarray,
                     out_dir: Optional[str] = None,
                     name: str = "simclr_pair.png") -> Optional[str]:
    """The two augmented views of one sample."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    for ax, img in ((axes[0], img1), (axes[1], img2)):
        _show(ax, img)
        ax.axis("off")
    return _savefig(fig, out_dir, name)


def plot_pairwise_pair(img1: np.ndarray, img2: np.ndarray,
                       joints1: np.ndarray, joints2: np.ndarray,
                       out_dir: Optional[str] = None,
                       name: str = "pairwise_pair.png") -> Optional[str]:
    """An augmented pair with each view's transformed keypoints over it,
    the pairwise experiment's panel."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    for ax, img, joints in ((axes[0], img1, joints1),
                            (axes[1], img2, joints2)):
        _show(ax, img)
        plot_hand(ax, joints)
        ax.axis("off")
    return _savefig(fig, out_dir, name)


def plot_peclr_pair(img1: np.ndarray, img2: np.ndarray,
                    params: Dict[str, np.ndarray], sample_idx: int = 0,
                    out_dir: Optional[str] = None,
                    name: str = "peclr_pair.png") -> Optional[str]:
    """The two augmented views of a sample, titled with each view's
    equivariance parameters (angle, crop jitter)."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    for view, (ax, img) in enumerate(((axes[0], img1), (axes[1], img2)), 1):
        _show(ax, img)
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
