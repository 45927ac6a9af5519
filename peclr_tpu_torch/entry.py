"""The port's entry points, counterpart of the reference repository's
__graft_entry__.py: `entry()` (the flagship forward and an example input)
and `dryrun_multichip(n)` (one data-parallel step, parallel/dryrun.py).

    python -c "from peclr_tpu_torch.entry import entry; \\
               fn, args = entry(); print(fn(*args).shape)"   # the card
    python -c "from peclr_tpu_torch.entry import entry; \\
               fn, args = entry('cpu'); print(fn(*args).shape)"

The reference's fn took flax collections, fn(params, batch_stats, images);
the port's takes the module itself, fn(model, images).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from peclr_tpu_torch.device import DeviceLike, resolve_device
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.init import init_as_reference
from peclr_tpu_torch.parallel.dryrun import dryrun_multichip

__all__ = ["dryrun_multichip", "entry"]

#: the example input of the reference's entry(): a two-view batch of 128²
#: images, channels last
EXAMPLE_SHAPE = (8, 128, 128, 3)


def projection(model: PeCLRModel, images: torch.Tensor) -> torch.Tensor:
    """The encoder and projection head on `images` in inference: (B, 128)
    float32, under bf16 autocast on the card (the reference's
    dtype=jnp.bfloat16), in float32 elsewhere."""
    with torch.inference_mode(), torch.autocast(
            images.device.type, dtype=torch.bfloat16,
            enabled=images.device.type == "cuda"):
        return model(images)["projection"]


def entry(device: DeviceLike = None
          ) -> Tuple[Callable, Tuple[PeCLRModel, torch.Tensor]]:
    """(fn, example_args): fn(*example_args) is the PeCLR ResNet-50's
    projection of zeros of EXAMPLE_SHAPE, the model in eval mode with its
    weights drawn from seed 0 as the reference's `model.init` draws them,
    on `device` (the card unless another is named)."""
    dev = resolve_device(device)
    model = init_as_reference(PeCLRModel("50"), 0).to(dev).eval()
    images = torch.zeros(EXAMPLE_SHAPE, dtype=torch.float32, device=dev)
    return projection, (model, images)
