"""A fresh model's initial weights, drawn as the reference's `model.init`
draws them (flax's default initialisers), the counterpart of the flax
`model.init` calls in peclr_tpu/train/loop.py, peclr_tpu/cli/finetune.py
and __graft_entry__.py.

The distributions are the reference's; the numbers are torch's, not
jax.random's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

#: flax's truncated normal: a unit normal cut at +-2 has this standard
#: deviation, so variance_scaling divides it out
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(weight: torch.Tensor, scale: float, fan: int,
                       generator: torch.Generator) -> None:
    std = math.sqrt(scale / fan) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_as_reference(model: nn.Module, seed: int) -> nn.Module:
    """Re-draw the model's weights from `seed` with the distributions of the
    reference's `model.init` (flax's defaults): convolutions and dense
    layers lecun-normal (truncated, variance 1 / fan_in), the ResNet stem
    He-normal on fan_out (variance 2 / fan_out, peclr_tpu/models/resnet.py
    :141), zero biases, BatchNorm scale 1, bias 0, running mean 0 and
    variance 1.  Returns the model."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            w = module.weight
            o, i, kh, kw = w.shape
            stem = kh == 7  # the 7x7 stem conv of every ResNet
            _variance_scaling_(w, 2.0 if stem else 1.0,
                               o * kh * kw if stem else i * kh * kw, gen)
        elif isinstance(module, nn.Linear):
            _variance_scaling_(module.weight, 1.0, module.in_features, gen)
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            module.reset_parameters()  # scale 1, bias 0, mean 0, var 1
            continue
        else:
            continue
        if module.bias is not None:
            module.bias.zero_()
    return model
