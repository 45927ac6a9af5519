"""Training state (port of peclr_tpu/train/state.py).

The model holds the parameters and the BatchNorm running statistics, the
optimizer its moments; the state ties them to the count of steps taken.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from peclr_tpu_torch.train.optimizer import PretrainOptimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: PretrainOptimizer
    step: int = 0  # data-iteration counter
