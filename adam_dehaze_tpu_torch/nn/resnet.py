"""ResNet backbones for the fog-intensity classifier and the detector
(torch.nn, NCHW).

Counterpart of adam_dehaze_tpu/nn/resnet.py, with torchvision's structure
and state-dict names (conv1, bn1, layer{1..4}.{i}.conv{1,2,3}/bn*/
downsample.{0,1}) so torchvision and reference checkpoints load directly.
The fc layer is absent, as in the reference classifier (it replaces fc with
an identity). The 3x3/2 max-pool pads with -inf, as flax's nn.max_pool does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adam_dehaze_tpu_torch.parallel.spatial import mean_hw


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), _bn(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = _bn(features)
        self.downsample = _downsample(in_channels, features, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 with 4x expansion (torchvision v1.5)."""
    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample = _downsample(in_channels, out, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + identity)


class ResNet(nn.Module):
    """NCHW images -> pooled features (B, feature_dim) in float32; with
    `return_stages`, also the outputs of layer1-layer4 (C2-C5) for a
    detection neck."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "basic"):
        super().__init__()
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for i, (n_blocks, w) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block_cls(cin, w, stride))
                cin = w * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.feature_dim = cin

    def forward(self, x, return_stages: bool = False):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        stages = []
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
            stages.append(x)
        pooled = mean_hw(x).float()
        return (pooled, stages) if return_stages else pooled


def resnet18() -> ResNet:
    return ResNet((2, 2, 2, 2), "basic")


def resnet34() -> ResNet:
    return ResNet((3, 4, 6, 3), "basic")


def resnet50() -> ResNet:
    return ResNet((3, 4, 6, 3), "bottleneck")
