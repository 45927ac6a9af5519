"""torchvision-shaped ResNet-18/34/50/101/152 and the pose model on it,
ResNetPose (port of peclr_tpu/models/resnet.py).

Module names follow torchvision (conv1, bn1, layer{i}.{j}.conv{k}/bn{k},
downsample.0/1, fc), so `state_dict()` keys are the torchvision keys and the
released `.pth` weights load as they are.  The stem is a plain 7x7/2 conv:
the reference's space-to-depth StemConv is a TPU layout of the same linear
map.  BatchNorm uses eps 1e-5 and, in eval mode, the running statistics;
in train mode it normalises with the batch statistics and updates the
running ones as the reference's flax BatchNorm does (models/batchnorm.py).
Each BatchNorm with the residual add and the ReLU after it is one call of
`batch_norm_act`, which runs them as hand-written CUDA passes for a
channels-last tensor on the card in train mode.
"""

from __future__ import annotations

import torch
from torch import nn

from peclr_tpu_torch.models.batchnorm import BatchNorm2d, batch_norm_act
from peclr_tpu_torch.ops.pooling import max_pool_3x3s2p1

#: stage template per resnet size: (block kind, blocks-per-stage)
RESNET_SPECS = {
    "18": ("basic", (2, 2, 2, 2)),
    "34": ("basic", (3, 4, 6, 3)),
    "50": ("bottleneck", (3, 4, 6, 3)),
    "101": ("bottleneck", (3, 4, 23, 3)),
    "152": ("bottleneck", (3, 8, 36, 3)),
}

#: pooled embedding width per size
EMBED_DIM = {"18": 512, "34": 512, "50": 2048, "101": 2048, "152": 2048}


def _conv(cin: int, cout: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = BatchNorm2d(features)
        self.downsample = (_downsample(cin, features, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = batch_norm_act(self.bn1, self.conv1(x))
        return batch_norm_act(self.bn2, self.conv2(out), identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = _conv(cin, features, 1, 1)
        self.bn1 = BatchNorm2d(features)
        # torchvision places the stride on the 3x3 conv
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = _conv(features, features * 4, 1, 1)
        self.bn3 = BatchNorm2d(features * 4)
        self.downsample = (_downsample(cin, features * 4, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = batch_norm_act(self.bn1, self.conv1(x))
        out = batch_norm_act(self.bn2, self.conv2(out))
        return batch_norm_act(self.bn3, self.conv3(out), identity)


def resnet_stages(size: str):
    """The four residual stages (layer1..layer4) of a ResNet of this size,
    as nn.Sequentials, and the width of the last one."""
    block_kind, stages = RESNET_SPECS[size]
    block = BasicBlock if block_kind == "basic" else Bottleneck
    cin = 64
    layers = []
    for stage_idx, num_blocks in enumerate(stages):
        features = 64 * 2**stage_idx
        blocks = []
        for block_idx in range(num_blocks):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            needs_down = block_idx == 0 and (
                stride != 1 or cin != features * block.expansion
            )
            blocks.append(block(cin, features, stride, needs_down))
            cin = features * block.expansion
        layers.append(nn.Sequential(*blocks))
    return layers, cin


class ResNet(nn.Module):
    """Backbone plus a final linear layer `fc` (num_outputs wide).

    forward takes NCHW float images and returns (B, num_outputs)."""

    def __init__(self, size: str = "50", num_outputs: int = 1000):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        layers, cin = resnet_stages(size)
        for stage_idx, layer in enumerate(layers):
            self.add_module(f"layer{stage_idx + 1}", layer)
        self.fc = nn.Linear(cin, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = batch_norm_act(self.bn1, self.conv1(x))
        x = max_pool_3x3s2p1(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # global average pool == AdaptiveAvgPool2d((1, 1))
        return self.fc(torch.mean(x, dim=(2, 3)))


class ResNetEncoder(nn.Module):
    """The backbone without fc, as the reference's PeCLR encoder: a
    Sequential `features` (0 conv1, 1 bn1, 2 relu, 3 max pool, 4..7
    layer1..layer4), so the state-dict keys are those of the reference's
    `encoder.features.N.*` checkpoints.  forward applies bn1 and the ReLU as
    one `batch_norm_act`, then the rest in order.

    forward takes NCHW float images and returns the pooled (B, E) embedding
    in float32."""

    def __init__(self, size: str = "50"):
        super().__init__()
        layers, self.embed_dim = resnet_stages(size)
        self.features = nn.Sequential(
            _conv(3, 64, 7, 2), BatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(kernel_size=3, stride=2, padding=1),  # the stem pool
            *layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        x = batch_norm_act(f[1], f[0](x))
        for i in range(3, len(f)):
            x = f[i](x)
        # global average pool == AdaptiveAvgPool2d((1, 1))
        return torch.mean(x, dim=(2, 3)).float()


class ResNetPose(ResNet):
    """The encoder and a final linear `fc` emitting 21*3 keypoints and one
    scale logit (port of peclr_tpu/models/resnet.py:265-280, the
    reference's ResNetModel outside pretraining).

    forward takes (B, H, W, 3) float images, channels last as in the
    reference, and returns (B, num_outputs); state-dict keys are
    torchvision's (models/port.py:resnet_pose_variables_to_state_dict)."""

    def __init__(self, size: str = "50", num_outputs: int = 21 * 3 + 1):
        super().__init__(size, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2))
