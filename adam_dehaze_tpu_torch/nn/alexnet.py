"""AlexNet feature extractor for LPIPS (torch.nn).

Counterpart of adam_dehaze_tpu/nn/alexnet.py: torchvision's AlexNet
`features` trunk (convs at `features.{0,3,6,8,10}`), whose five post-ReLU
activations are the LPIPS feature set. NHWC in, a list of NHWC float32 taps
out, as the JAX module; inside, NCHW in channels_last memory.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from adam_dehaze_tpu_torch.nn.vgg import tap_nhwc


class AlexNetFeatures(nn.Module):
    # Indices of the post-ReLU layers in `features`.
    TAPS = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.TAPS:
                taps.append(tap_nhwc(x))
        return taps
