"""Device selection for the port's entry points.

Entry points run on the card unless the caller names another device; there
is no silent move to the CPU.  Both TF32 switches are turned off, so float32
convolutions and matmuls run in full float32 like the reference model
(cuDNN would otherwise run f32 convolutions in TF32), and bf16 matmuls
reduce in float32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or the current CUDA card when None.  Raises when a CUDA
    device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
