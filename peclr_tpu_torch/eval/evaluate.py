"""Full-dataset evaluation of the supervised / fine-tuned 2.5D models (port
of peclr_tpu/eval/evaluate.py).

Run inference over a dataset, lift the 2.5D predictions to 3D with the
closed-form z-root, and report EPE 2D/3D, AUC, the recreated-3D sanity
metric and the procrustes-aligned statistics.  Samples are made on the
device the batches go to (the warp's kernel on the card); predictions stay
there until the last batch, and the metrics run on the host.

torch cannot replay jax.random: batch i draws its augmentation from a
generator seeded by `stream_seed(seed, i)` (train/loop.py), unless `draws`
hands in the parameters (e.g. those the reference drew).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from peclr_tpu_torch.config.defaults import AugmentationFlags, AugmentationParams
from peclr_tpu_torch.data.pipeline import cuda_copier, device_prefetch
from peclr_tpu_torch.device import DeviceLike, resolve_device
from peclr_tpu_torch.eval.metrics import auc, epe_statistics, procrustes_statistics
from peclr_tpu_torch.geometry.camera import (
    convert_2_5d_to_3d,
    convert_to_2_5d,
    move_wrist_to_palm,
)
from peclr_tpu_torch.ops import augment
from peclr_tpu_torch.train.loop import stream_generator

Draws = Dict[str, torch.Tensor]


def supervised_sample_batch(
    generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
    flags: AugmentationFlags, params: AugmentationParams,
    use_palm: bool = False, draws: Optional[Draws] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """The supervised sample of one batch: one augmented view (fresh draws
    from `generator` unless `draws` gives them), K' = T @ K, the 2.5D labels
    in crop coordinates and the recreated-3D self-check targets.  With
    `use_palm` the wrist is replaced by the palm midpoint, the 2.5D labels
    are re-projected through K', and the procrustes targets move too.
    `compute_dtype` overrides the warp's default compute type (bf16 on the
    card)."""
    images = batch["image"]
    if draws is None:
        draws = augment.draw(generator, images.shape[0], flags, params)
    out = augment.apply(images, batch["joints25d"], draws, flags, params,
                        compute_dtype=compute_dtype, normalize=True)
    K_new = torch.einsum("bij,bjk->bik", out.matrix, batch["K"].float())
    joints3d = batch["joints3d"]
    scale = batch["scale"]
    joints25d = out.joints
    joints_raw = batch.get("joints_raw", joints3d)
    if use_palm:
        joints3d = move_wrist_to_palm(joints3d)
        joints25d, scale = convert_to_2_5d(K_new, joints3d)
        joints_raw = move_wrist_to_palm(joints_raw)
    return {
        "image": out.images,
        "joints": joints25d,
        "joints3D": joints3d,
        "K": K_new,
        "scale": scale,
        "joints3D_recreated": convert_2_5d_to_3d(joints25d, scale, K_new),
        "joints_valid": batch["joints_valid"],
        "joints_raw": joints_raw,
        "T": out.matrix,
    }


#: the sample fields collect_predictions gathers, under their result names
_GATHERED = (("ground_truth", "joints"), ("ground_truth_3d", "joints3D"),
             ("ground_truth_recreated_3d", "joints3D_recreated"),
             ("scale", "scale"), ("camera_param", "K"),
             ("joints_raw", "joints_raw"))


def collect_predictions(
    predict_25d: Callable, pipeline, flags: AugmentationFlags,
    aug_params: AugmentationParams, num_batches: Optional[int] = None,
    seed: int = 0, use_palm: bool = False, device: DeviceLike = None,
    draws: Optional[Sequence[Draws]] = None,
) -> Dict[str, np.ndarray]:
    """Batched inference; returns the stacked predictions and ground truth.

    predict_25d(images, K) -> (B, 21, 3) 2.5D predictions on the batch's
    device.  `draws`, when given, holds one dict of parameters per batch.
    Nothing waits on the card until the last batch is in."""
    dev = resolve_device(device)
    n = num_batches or max(len(pipeline) // pipeline.batch_size, 1)
    if draws is not None and len(draws) != n:
        raise ValueError(f"{len(draws)} draws for {n} batches")
    copier = cuda_copier(dev) if dev.type == "cuda" else None
    gathered = {name: [] for name in ("predictions",) + tuple(
        name for name, _ in _GATHERED)}
    for i, batch in enumerate(device_prefetch(pipeline.batches(n, epoch=0),
                                              dev, copier=copier)):
        sample = supervised_sample_batch(
            None if draws is not None else stream_generator(dev, seed, i),
            batch, flags, aug_params, use_palm=use_palm,
            draws=None if draws is None else draws[i])
        gathered["predictions"].append(predict_25d(sample["image"],
                                                   sample["K"]))
        for name, key in _GATHERED:
            gathered[name].append(sample[key])
    return {name: torch.cat(parts).float().cpu().numpy()
            for name, parts in gathered.items()}


def evaluate(
    predict_25d: Callable, pipeline,
    flags: Optional[AugmentationFlags] = None,
    aug_params: Optional[AugmentationParams] = None,
    use_procrustes: bool = True, num_batches: Optional[int] = None,
    predict_zroot: Optional[Callable] = None, use_palm: bool = False,
    device: DeviceLike = None, draws: Optional[Sequence[Draws]] = None,
) -> Dict[str, float]:
    """EPE/AUC evaluation dict (the reference's keys).

    `predict_zroot(pred_25d, K) -> (N,)`, given host tensors, optionally
    supplies a z-root that overrides the closed-form lift."""
    flags = flags or AugmentationFlags(resize=True, crop=True)
    aug_params = aug_params or AugmentationParams(resize_shape=(128, 128))
    pred = collect_predictions(predict_25d, pipeline, flags, aug_params,
                               num_batches, use_palm=use_palm, device=device,
                               draws=draws)
    p25d = torch.from_numpy(pred["predictions"])
    K = torch.from_numpy(pred["camera_param"])
    z_root = None if predict_zroot is None else predict_zroot(p25d, K)
    predictions_3d = convert_2_5d_to_3d(p25d, torch.from_numpy(pred["scale"]),
                                        K, z_root=z_root)
    epe_2d = epe_statistics(p25d, pred["ground_truth"], dim=2)
    epe_3d = epe_statistics(predictions_3d, pred["ground_truth_3d"], dim=3)
    epe_rec = epe_statistics(pred["ground_truth_3d"],
                             pred["ground_truth_recreated_3d"], dim=3)
    results = {
        "Mean_EPE_2D": float(epe_2d["mean"]),
        "Median_EPE_2D": float(epe_2d["median"]),
        "Mean_EPE_3D": float(epe_3d["mean"]),
        "Median_EPE_3D": float(epe_3d["median"]),
        "Median_EPE_3D_R_V_3D": float(epe_rec["median"]),
        "AUC": auc(epe_3d["euclidean_dist"].numpy()),
    }
    if use_procrustes:
        results.update(procrustes_statistics(predictions_3d.numpy(),
                                             pred["joints_raw"]))
    return results
