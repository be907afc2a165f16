"""The reference of the `complex` branch (`dehazing.<level>.model_type: complex`)."""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.layers import (Conv2d, ConvBlock, ResidualBlock, AttentionBlock, UpBlock,
                                        EncDec, nchw, nhwc)


class HighIntensityDehazeModel(EncDec):
    """High: out = clip(x + tanh(net(x)) * sigmoid(detail(x)), 0, 1), with
    CBAM after each stage."""

    def __init__(self, c=96, n_blocks=9):
        super().__init__()
        self.detail_branch = nn.Sequential(ConvBlock(3, 16), ConvBlock(16, 16),
                                           Conv2d(16, 1, 1), nn.Sigmoid())
        self.init_conv = ConvBlock(3, c, 7)
        self.encoder = nn.Sequential(
            nn.Sequential(ConvBlock(c, 2 * c, 4, 2, 1), ResidualBlock(2 * c),
                          ResidualBlock(2 * c), AttentionBlock(2 * c)),
            nn.Sequential(ConvBlock(2 * c, 4 * c, 4, 2, 1), ResidualBlock(4 * c),
                          ResidualBlock(4 * c), AttentionBlock(4 * c)))
        self.bottleneck = nn.Sequential(ResidualBlock(4 * c), AttentionBlock(4 * c),
                                        ResidualBlock(4 * c), AttentionBlock(4 * c))
        self.decoder = nn.Sequential(
            UpBlock(4 * c, 2 * c, ResidualBlock(2 * c), AttentionBlock(2 * c)),
            UpBlock(4 * c, c, ResidualBlock(c), AttentionBlock(c)))
        self.output_conv = self._output_conv(c)

    def forward(self, x):
        xin = nchw(x)
        return nhwc(torch.clamp(xin + self._trunk(xin) * self.detail_branch(xin), 0.0, 1.0))


MODEL = HighIntensityDehazeModel
