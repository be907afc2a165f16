"""The reference of the `corun` branch (`dehazing.<level>.model_type: corun`)."""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.layers import (Conv2d, ConvBlock, ResidualBlock, UpsampleAlignCorners,
                                        nchw, nhwc)


class COrunInspiredModel(nn.Module):
    """Medium, alternative: scales 1, 1/2, 1/4 (max-pool, ConvBlock,
    align-corners bilinear back), 1x1 fusion, residual stack,
    out = clip(x + tanh(net(x)), 0, 1)."""

    def __init__(self, c=64, n_blocks=6):
        super().__init__()
        self.init_conv = ConvBlock(3, c, 7)
        self.scale1_conv = ConvBlock(c, c)
        self.scale2_conv = nn.Sequential(nn.MaxPool2d(2), ConvBlock(c, 2 * c),
                                         UpsampleAlignCorners())
        self.scale3_conv = nn.Sequential(nn.MaxPool2d(4), ConvBlock(c, 4 * c),
                                         UpsampleAlignCorners())
        self.fusion_conv = ConvBlock(7 * c, 2 * c, 1, padding=0)
        self.residual_blocks = nn.Sequential(*[ResidualBlock(2 * c) for _ in range(n_blocks)])
        self.output_conv = nn.Sequential(ConvBlock(2 * c, c), Conv2d(c, 3, 3, padding=1),
                                         nn.Tanh())

    def forward(self, x):
        xin = nchw(x)
        f0 = self.init_conv(xin)
        scales = [self.scale1_conv(f0)]
        for pool, conv, up in (self.scale2_conv, self.scale3_conv):
            scales.append(up(conv(pool(f0)), f0.shape[2:]))
        h = self.residual_blocks(self.fusion_conv(torch.cat(scales, 1)))
        return nhwc(torch.clamp(xin + self.output_conv(h), 0.0, 1.0))


MODEL = COrunInspiredModel
