"""The reference of the `standard` branch (`dehazing.<level>.model_type: standard`)."""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.layers import ConvBlock, ResidualBlock, UpBlock, EncDec, nchw, nhwc


class MediumIntensityDehazeModel(EncDec):
    """Medium: out = clip(x + tanh(net(x)), 0, 1)."""

    def __init__(self, c=64, n_blocks=6):
        super().__init__()
        self.init_conv = ConvBlock(3, c, 7)
        self.encoder = nn.Sequential(
            nn.Sequential(ConvBlock(c, 2 * c, 4, 2, 1), ResidualBlock(2 * c),
                          ResidualBlock(2 * c)),
            nn.Sequential(ConvBlock(2 * c, 4 * c, 4, 2, 1), ResidualBlock(4 * c),
                          ResidualBlock(4 * c)))
        self.bottleneck = nn.Sequential(ResidualBlock(4 * c), ResidualBlock(4 * c))
        self.decoder = nn.Sequential(UpBlock(4 * c, 2 * c, ResidualBlock(2 * c)),
                                     UpBlock(4 * c, c, ResidualBlock(c)))
        self.output_conv = self._output_conv(c)

    def forward(self, x):
        xin = nchw(x)
        return nhwc(torch.clamp(xin + self._trunk(xin), 0.0, 1.0))


MODEL = MediumIntensityDehazeModel
