"""Batched inference session for serving (port of
peclr_tpu/eval/serving.py).

Load a checkpoint once, keep the weights on the card, and serve
variable-sized requests by padding to a fixed batch (larger requests are
chunked), so every call runs one batch shape.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from peclr_tpu_torch.device import DeviceLike, resolve_device
from peclr_tpu_torch.ops.image import normalize_imagenet


class InferenceSession:
    """2.5D/3D hand-pose inference on a fixed batch shape.

    >>> sess = InferenceSession.from_checkpoint("rn50.pth", "50").warmup()
    >>> out = sess.predict(images_u8, K)   # out["kp3d"]: (N, 21, 3)
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 32,
                 image_size: int = 128, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.image_size = image_size

    @classmethod
    def from_checkpoint(cls, path: str, resnet_size: str = "50",
                        batch_size: int = 32, image_size: int = 128,
                        device: DeviceLike = None) -> "InferenceSession":
        from peclr_tpu_torch.models import RN25DPose
        from peclr_tpu_torch.train.checkpoint import load_torch_checkpoint

        model = RN25DPose(size=resnet_size)
        model.load_state_dict(load_torch_checkpoint(path), strict=True)
        return cls(model, batch_size=batch_size, image_size=image_size,
                   device=device)

    @torch.inference_mode()
    def _predict(self, images_u8: np.ndarray, K: np.ndarray):
        x = torch.from_numpy(images_u8).to(self.device)
        x = normalize_imagenet(x.to(torch.float32) / 255.0)
        return self.model(x, K=torch.from_numpy(K).to(self.device))

    def warmup(self) -> "InferenceSession":
        """Run one batch before serving traffic (cuDNN picks its kernels)."""
        z = np.zeros(
            (self.batch_size, self.image_size, self.image_size, 3), np.uint8
        )
        K = np.broadcast_to(np.eye(3, dtype=np.float32) * 100.0,
                            (self.batch_size, 3, 3)).copy()
        K[:, 2, 2] = 1.0
        self._predict(z, K)["kp3d"].cpu()
        return self

    def predict(self, images_u8: np.ndarray,
                K: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """images_u8: (N, image_size, image_size, 3); N below the batch is
        padded, larger N is chunked.  Returns a dict of numpy arrays."""
        n = images_u8.shape[0]
        if K is None:
            from peclr_tpu_torch.models.rn25d import K_DEFAULT

            K = np.broadcast_to(np.asarray(K_DEFAULT, np.float32), (n, 3, 3))
        K = np.asarray(K, np.float32)
        outs = []
        for start in range(0, n, self.batch_size):
            chunk = images_u8[start: start + self.batch_size]
            Kc = K[start: start + self.batch_size]
            pad = self.batch_size - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)]
                )
                Kc = np.concatenate([Kc, np.repeat(Kc[-1:], pad, axis=0)])
            out = self._predict(np.ascontiguousarray(chunk),
                                np.ascontiguousarray(Kc))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if pad:
                out = {k: v[:-pad] for k, v in out.items()}
            outs.append(out)
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
