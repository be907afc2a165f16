"""The reference of the `lightweight` branch (`dehazing.<level>.model_type: lightweight`)."""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.layers import Conv2d, ConvBlock, ResidualBlock, nchw, nhwc


class LightweightDehazeModel(nn.Module):
    """Low: out = (1 - alpha) x + alpha sigmoid(net(x))."""

    def __init__(self, c=32, n_blocks=3):
        super().__init__()
        self.init_conv = ConvBlock(3, c)
        self.residual_blocks = nn.Sequential(*[ResidualBlock(c) for _ in range(n_blocks)])
        self.output_conv = nn.Sequential(ConvBlock(c, c), Conv2d(c, 3, 3, padding=1),
                                         nn.Sigmoid())
        self.skip_alpha = nn.Parameter(torch.tensor(0.1))

    def forward(self, x):
        xin = nchw(x)
        y = self.output_conv(self.residual_blocks(self.init_conv(xin)))
        return nhwc((1.0 - self.skip_alpha) * xin + self.skip_alpha * y)


MODEL = LightweightDehazeModel
