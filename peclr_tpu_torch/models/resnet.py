"""torchvision-shaped ResNet-18/34/50/101/152 (port of
peclr_tpu/models/resnet.py).

Module names follow torchvision (conv1, bn1, layer{i}.{j}.conv{k}/bn{k},
downsample.0/1, fc), so `state_dict()` keys are the torchvision keys and the
released `.pth` weights load as they are.  The stem is a plain 7x7/2 conv:
the reference's space-to-depth StemConv is a TPU layout of the same linear
map.  BatchNorm uses eps 1e-5 and, in eval mode, the running statistics.
"""

from __future__ import annotations

import torch
from torch import nn

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
    return nn.Sequential(_conv(cin, cout, 1, stride), nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = nn.BatchNorm2d(features)
        self.downsample = (_downsample(cin, features, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = _conv(cin, features, 1, 1)
        self.bn1 = nn.BatchNorm2d(features)
        # torchvision places the stride on the 3x3 conv
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = nn.BatchNorm2d(features)
        self.conv3 = _conv(features, features * 4, 1, 1)
        self.bn3 = nn.BatchNorm2d(features * 4)
        self.downsample = (_downsample(cin, features * 4, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Backbone plus a final linear layer `fc` (num_outputs wide).

    forward takes NCHW float images and returns (B, num_outputs)."""

    def __init__(self, size: str = "50", num_outputs: int = 1000):
        super().__init__()
        block_kind, stages = RESNET_SPECS[size]
        block = BasicBlock if block_kind == "basic" else Bottleneck
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
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
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3s2p1(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # global average pool == AdaptiveAvgPool2d((1, 1))
        return self.fc(torch.mean(x, dim=(2, 3)))
