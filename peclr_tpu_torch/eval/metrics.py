"""Evaluation metrics: EPE statistics, PCK curves, per-joint AUC, and the
procrustes-aligned variants (port of peclr_tpu/eval/metrics.py).

PCK thresholds run 0 -> 0.5 m in 5 mm steps; AUC is the trapezoid integral
of the per-joint PCK curve normalised by the threshold span, averaged over
the 21 joints.  The EPE statistics are torch; the curves are numpy, on the
host, as in the reference.  The median averages the two middle values, as
jnp.median does (torch.median would take the lower one).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from peclr_tpu_torch.geometry.procrustes import procrustes_align


def median(x: torch.Tensor) -> torch.Tensor:
    """The median of all elements: the mean of the two middle values for an
    even count."""
    v = x.flatten().sort().values
    n = v.numel()
    return 0.5 * v[(n - 1) // 2] + 0.5 * v[n // 2]


def epe_statistics(predictions, ground_truth, dim: int = 3
                   ) -> Dict[str, torch.Tensor]:
    """Euclidean distance stats.  dim=2 uses only the first two coords."""
    predictions = torch.as_tensor(predictions)
    ground_truth = torch.as_tensor(ground_truth)
    if dim == 2:
        predictions = predictions[..., :2]
        ground_truth = ground_truth[..., :2]
    dist = torch.sqrt(((predictions - ground_truth) ** 2).sum(dim=-1))
    return {
        "euclidean_dist": dist,
        "mean": dist.mean(),
        "median": median(dist),
        "min": dist.min(),
        "max": dist.max(),
    }


def pck_curve(euclidean_dist, threshold_min: float = 0.0,
              threshold_max: float = 0.5, step: float = 0.005,
              per_joint: bool = False):
    """Fraction of keypoints under each threshold.

    euclidean_dist: (N, 21).  Returns (curve, thresholds); curve is (T,)
    or (21, T) when per_joint."""
    dist = np.asarray(euclidean_dist)
    thresholds = np.arange(threshold_min, threshold_max, step)
    if per_joint:
        curve = np.stack([(dist < t).mean(axis=0) for t in thresholds],
                         axis=-1)
    else:
        curve = np.array([(dist < t).mean() for t in thresholds])
    return curve, thresholds


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """np.trapezoid (numpy >= 2) / np.trapz, written out."""
    return float(np.sum(np.diff(x) * (y[1:] + y[:-1]) / 2.0))


def auc_per_joint(euclidean_dist) -> np.ndarray:
    """Normalised trapezoid AUC of the PCK curve for each joint."""
    curve, thresholds = pck_curve(euclidean_dist, per_joint=True)
    norm = _trapezoid(np.ones_like(thresholds), thresholds)
    return np.array([_trapezoid(curve[j], thresholds) / norm
                     for j in range(curve.shape[0])])


def auc(euclidean_dist) -> float:
    return float(np.mean(auc_per_joint(euclidean_dist)))


def procrustes_statistics(predictions_3d, joints_raw) -> Dict[str, float]:
    """Aligned EPE/AUC after per-sample similarity alignment, the
    leaderboard's 'aligned' numbers."""
    target = torch.as_tensor(joints_raw, dtype=torch.float32)
    aligned, _, _, _ = procrustes_align(
        target, torch.as_tensor(predictions_3d, dtype=torch.float32))
    stats = epe_statistics(aligned, target, dim=3)
    return {
        "Mean_EPE_3D_procrustes": float(stats["mean"]),
        "Median_EPE_3D_procrustes": float(stats["median"]),
        "auc_procrustes": auc(stats["euclidean_dist"].numpy()),
    }
