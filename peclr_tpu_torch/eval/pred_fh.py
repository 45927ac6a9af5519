"""FreiHAND leaderboard inference (port of peclr_tpu/eval/pred_fh.py).

Two-pass protocol (reference testing/pred_fh.py:80-126):
  1. predict on a fixed center crop (bbox = full frame scaled by 0.33,
     mapped into the crop with target_dist 0.7);
  2. bound-box the predicted 2D keypoints, map the box back to the frame
     through the inverse affine, re-create the affine and predict again;
  3. kp3d -> palm->wrist -> AIT->Zimmermann order -> x metric scale.

Both passes run batched on the card; each warp runs the CUDA shift kernel
twice, so one predict call launches it four times.  Spans
(utils/profiler.py:span, recorded only under torch.profiler): `pred.pass1`,
`pred.refine`, `pred.pass2` in run_two_pass; `pred.h2d` and `pred.fetch`,
a batch's copies to and from the card, in pipelined.  Output is the CodaLab
pred_<name>.json + .zip.
"""

from __future__ import annotations

import json
import os
import zipfile
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from peclr_tpu_torch.data.pipeline import host_prefetch as _host_prefetch
from peclr_tpu_torch.data.pipeline import host_to_device
from peclr_tpu_torch.device import DeviceLike, device_constant, resolve_device
from peclr_tpu_torch.geometry import affine
from peclr_tpu_torch.geometry.camera import move_palm_to_wrist
from peclr_tpu_torch.geometry.joints import permutation
from peclr_tpu_torch.ops.image import normalize_imagenet
from peclr_tpu_torch.ops.warp_mxu import affine_warp_mxu
from peclr_tpu_torch.utils.profiler import span

BBOX_SCALE = 0.33
CROP_SIZE = 224
TARGET_DIST = 0.7
#: cv2 borderValue quirk: the reference passes the ImageNet mean in [0,1]
#: units to a uint8 warp, so the border is effectively ~0.485/255
BORDER_FILL = 0.485


def initial_affine(crop_size: int = CROP_SIZE) -> np.ndarray:
    """The shared pass-1 transform: full-frame bbox scaled by 0.33."""
    bbox = affine.modify_bbox([0.0, 0.0, float(crop_size), float(crop_size)],
                              BBOX_SCALE)
    return affine.affine_from_bbox(bbox, crop_size, TARGET_DIST).numpy()


def _preprocess(images_u8: torch.Tensor, T: torch.Tensor,
                lerp_in_kernel: bool = True) -> torch.Tensor:
    """warp + ImageNet-normalize; T: (B, 3, 3) source->crop.  max_scale 3
    covers refined boxes that span more than the frame."""
    crop = affine_warp_mxu(
        images_u8, T, (CROP_SIZE, CROP_SIZE), fill_value=BORDER_FILL,
        max_scale=3.0, lerp_in_kernel=lerp_in_kernel,
    )
    return normalize_imagenet(crop / 255.0)


def bbox_from_kp2d(kp2d: torch.Tensor) -> torch.Tensor:
    """(B, 21, 2) -> (B, 4) int-truncated min/max box."""
    lo = torch.trunc(kp2d.amin(dim=1))
    hi = torch.trunc(kp2d.amax(dim=1))
    return torch.cat([lo, hi], dim=-1)


def refine_affine(kp2d: torch.Tensor, T1: torch.Tensor) -> torch.Tensor:
    """Pass-2 affine from pass 1's keypoints (B, 21, 2) in crop coords."""
    box = bbox_from_kp2d(kp2d)
    # degenerate-pose guard: a zero-size box (all keypoints in one pixel
    # cell) would blow up the affine scale
    box = torch.cat([box[:, :2], torch.maximum(box[:, 2:], box[:, :2] + 1.0)],
                    dim=-1)
    corners = torch.stack([box[:, :2], box[:, 2:]], dim=1)  # (B, 2, 2)
    corners_orig = affine.apply_affine(affine.invert_affine(T1), corners)
    box_orig = torch.cat([corners_orig[:, 0, :], corners_orig[:, 1, :]],
                         dim=-1)
    return affine.affine_from_bbox(box_orig, CROP_SIZE, TARGET_DIST)


@torch.inference_mode()
def run_two_pass(model: torch.nn.Module, images_u8: torch.Tensor,
                 K: torch.Tensor, lerp_in_kernel: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """Both passes on (B, 224, 224, 3) uint8 frames and (B, 3, 3) K, on
    their device.  Returns pass 1's kp25d, the refined affine T2 and the
    final kp3d (palm moved back to the wrist)."""
    b = images_u8.shape[0]
    with span("pred.pass1"):
        T1 = device_constant(initial_affine().tolist(),
                             images_u8.device).expand(b, 3, 3)
        K = K.to(torch.float32)
        img1 = _preprocess(images_u8, T1, lerp_in_kernel)
        out1 = model(img1, K=torch.einsum("bij,bjk->bik", T1, K))
    with span("pred.refine"):
        T2 = refine_affine(out1["kp25d"][..., :2], T1)
    with span("pred.pass2"):
        img2 = _preprocess(images_u8, T2, lerp_in_kernel)
        out2 = model(img2, K=torch.einsum("bij,bjk->bik", T2, K))
        kp3d = move_palm_to_wrist(out2["kp3d"])
    return {"kp25d_1": out1["kp25d"], "T2": T2, "kp3d": kp3d}


def make_two_pass_predictor(model: torch.nn.Module,
                            lerp_in_kernel: bool = True,
                            device: DeviceLike = None) -> Callable:
    """Moves the model to `device` (the card unless told otherwise) and
    returns predict(images_u8 (B,224,224,3), K (B,3,3)) -> kp3d (B,21,3) on
    that device.  lerp_in_kernel=False takes the kernel's raw mode (the
    reference's PECLR_SHIFT_LERP=xla)."""
    device = resolve_device(device)
    model = model.to(device).eval()

    def predict(images_u8: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
        return run_two_pass(model, images_u8.to(device), K.to(device),
                            lerp_in_kernel)["kp3d"]

    return predict


def padded_batches(load: Callable[[int], np.ndarray], K_list: np.ndarray,
                   n: int, batch_size: int) -> Iterator:
    """Yields (idx, pad, frames, K) over the first n frames; the last batch
    is filled up to batch_size by repeating its last frame, so every batch
    has one shape."""
    for start in range(0, n, batch_size):
        idx = range(start, min(start + batch_size, n))
        imgs = np.stack([load(i) for i in idx])
        K = K_list[list(idx)]
        pad = batch_size - len(imgs)
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
            K = np.concatenate([K, np.repeat(K[-1:], pad, 0)])
        yield idx, pad, imgs, K


def pipelined(predict: Callable, batches: Iterable, depth: int,
              device: torch.device) -> Iterator:
    """Dispatch batches with `depth` in flight: launches are asynchronous,
    so the oldest batch is fetched only after the next one is queued.
    Yields (idx, kp3d numpy without the padding rows) in order."""
    depth = max(int(depth), 1)
    pending: deque = deque()

    def fetch():
        idx, pad, out = pending.popleft()
        with span("pred.fetch"):
            kp3d = out.cpu().numpy()
        return idx, (kp3d[:-pad] if pad else kp3d)

    for idx, pad, imgs, K in batches:
        with span("pred.h2d"):
            imgs, K = host_to_device(imgs, device), host_to_device(K, device)
        pending.append((idx, pad, predict(imgs, K)))
        if len(pending) >= depth:
            yield fetch()
    while pending:
        yield fetch()


def predict_leaderboard(
    model: torch.nn.Module,
    base_path: str,
    out_name: str,
    batch_size: int = 120,
    set_name: str = "evaluation",
    limit: Optional[int] = None,
    out_dir: str = "out",
    depth: int = 2,
    decode_prefetch: bool = True,
    device: DeviceLike = None,
) -> str:
    """Run the eval set, dump CodaLab pred_{out_name}.json(.zip).  Returns
    the json path.  `depth` batches stay in flight (1 = serial); JPEG decode
    runs in a producer thread unless decode_prefetch is False.  Output is
    the same at every depth."""
    from peclr_tpu_torch.data.pipeline import decode_image

    device = resolve_device(device)
    with open(os.path.join(base_path, f"{set_name}_K.json")) as f:
        K_list = np.asarray(json.load(f), np.float32)
    with open(os.path.join(base_path, f"{set_name}_scale.json")) as f:
        scale_list = np.asarray(json.load(f), np.float32)

    n = len(K_list) if limit is None else min(limit, len(K_list))
    predict = make_two_pass_predictor(model, device=device)
    ait_to_zimmermann = permutation("ait", "freihand")
    img_dir = os.path.join(base_path, set_name, "rgb")
    names = sorted(os.listdir(img_dir))

    batches = padded_batches(
        lambda i: decode_image(os.path.join(img_dir, names[i])), K_list, n,
        batch_size,
    )
    if decode_prefetch:
        batches = _host_prefetch(batches, buffer_size=2)

    xyz_out = []
    for idx, kp3d in pipelined(predict, batches, depth, device):
        for j, i in enumerate(idx):
            out = kp3d[j][ait_to_zimmermann] * scale_list[i]
            if np.any(np.isnan(out)):
                raise ValueError(f"NaN in the prediction of image {i}")
            xyz_out.append(out.tolist())

    verts_out = [np.zeros((778, 3)).tolist()] * len(xyz_out)
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, f"pred_{out_name}.json")
    with open(json_path, "w") as f:
        json.dump([xyz_out, verts_out], f)
    with zipfile.ZipFile(json_path.replace(".json", ".zip"), "w",
                         zipfile.ZIP_DEFLATED) as z:
        z.write(json_path, os.path.basename(json_path))
    return json_path
