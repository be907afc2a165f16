"""The reference of the `resnet18` classifier backbone
(`classifier.model: resnet18`): pooled features."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.layers import Conv2d, bn


class BasicBlock(nn.Module):
    def __init__(self, cin, c, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, c, 3, stride, 1, bias=False)
        self.bn1 = bn(c)
        self.conv2 = Conv2d(c, c, 3, 1, 1, bias=False)
        self.bn2 = bn(c)
        self.downsample = (nn.Sequential(Conv2d(cin, c, 1, stride, bias=False), bn(c))
                           if stride != 1 or cin != c else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + identity)


class ResNet18(nn.Module):
    """torchvision's resnet18 without its fc: pooled 512 features."""
    feature_dim = 512

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for i, w in enumerate((64, 128, 256, 512)):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, w, 2 if i else 1), BasicBlock(w, w)))
            cin = w

    def forward(self, x):
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3))


BACKBONE = ResNet18
