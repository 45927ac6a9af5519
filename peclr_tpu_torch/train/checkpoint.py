"""Checkpoint reading (port of peclr_tpu/train/checkpoint.py:180-191)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch .pth/.ckpt or an .npz into a flat state dict of CPU
    tensors (a lightning checkpoint's 'state_dict' payload is unwrapped)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    return {k: v.detach().cpu() for k, v in payload.items()}
