"""Device selection for the port's entry points.

Entry points run on the card unless the caller names another device; there
is no silent move to the CPU.  `full_float32` turns both TF32 switches off,
so float32 convolutions and matmuls run in full float32 like the reference
model (cuDNN would otherwise run f32 convolutions in TF32), and bf16
matmuls reduce in float32.  `resolve_device` calls it, and so do the step
factories (train/step.py, train/finetune.py) for a model on the card, so a
caller that moves a model to the card itself gets full float32 too.

`device_constant` keeps the small constant tensors of the ops (the ImageNet
statistics, the grey weights, the default intrinsics) on each device: a
tensor built from the host's numbers is a copy from host memory, and on the
card torch makes the host wait for every queued kernel before it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    # a normal tensor even when first asked for under inference mode, so
    # that autograd may save it later
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values: Sequence, device: DeviceLike,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`values` (nested sequences of numbers) as a tensor on `device`,
    built on the first call for each (values, device, dtype) and the same
    tensor on every later one; the caller must not write to it."""
    return _constant(_frozen(values), torch.device(device), dtype)


def full_float32() -> None:
    """Turn off TF32 in cuDNN's convolutions and cuBLAS's matmuls, and the
    reduced-precision reduction of bf16 matmuls (process-wide flags)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def on_cuda(model: torch.nn.Module) -> bool:
    """Whether the model's parameters lie on a CUDA device."""
    return any(p.is_cuda for p in model.parameters())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or the current CUDA card when None, with TF32 off
    (`full_float32`) whatever the device.  Raises when a CUDA device is
    asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    full_float32()
    return dev
