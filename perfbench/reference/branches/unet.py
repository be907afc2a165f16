"""The reference of the `unet` branch (`dehazing.<level>.model_type: unet`)."""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.layers import Conv2d, ConvBlock, ResidualBlock, UpBlock, nchw, nhwc


class LowIntensityUNet(nn.Module):
    """Low, alternative: out = clip(x + 2 (sigmoid(net(x)) - 0.5), 0, 1)."""

    def __init__(self, c=32, n_blocks=3):
        super().__init__()
        self.init_conv = ConvBlock(3, c)
        self.down1 = nn.Sequential(ConvBlock(c, 2 * c, 4, 2, 1), ResidualBlock(2 * c))
        self.bottleneck = nn.Sequential(*[ResidualBlock(2 * c) for _ in range(n_blocks - 1)])
        self.up1 = UpBlock(2 * c, c)
        self.output_conv = nn.Sequential(ConvBlock(2 * c, c), ConvBlock(c, c),
                                         Conv2d(c, 3, 3, padding=1), nn.Sigmoid())

    def forward(self, x):
        xin = nchw(x)
        f0 = self.init_conv(xin)
        up = self.up1(self.bottleneck(self.down1(f0)))
        res = (self.output_conv(torch.cat([up, f0], 1)) - 0.5) * 2.0
        return nhwc(torch.clamp(xin + res, 0.0, 1.0))


MODEL = LowIntensityUNet
