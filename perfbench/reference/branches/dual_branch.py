"""The reference of the `dual_branch` branch (`dehazing.<level>.model_type: dual_branch`)."""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.layers import (Conv2d, ConvBlock, ResidualBlock, AttentionBlock,
                                        UpsampleAlignCorners, nchw, nhwc)


class DualBranchAttentionModel(nn.Module):
    """High, alternative: a global branch at 1/2 and 1/4 with CBAM beside a
    full-resolution local branch; out = clip(x + (1 - t) tanh(net(x)), 0, 1)
    with t the transmission map."""

    def __init__(self, c=96, n_blocks=9):
        super().__init__()
        h = c // 2
        self.global_branch = nn.Sequential(
            ConvBlock(3, c, 7), nn.MaxPool2d(2), ResidualBlock(c), AttentionBlock(c),
            nn.MaxPool2d(2), ResidualBlock(c), AttentionBlock(c), ResidualBlock(c),
            UpsampleAlignCorners(), ResidualBlock(c), UpsampleAlignCorners(),
            ConvBlock(c, h))
        self.local_branch = nn.Sequential(ConvBlock(3, h), ResidualBlock(h), ResidualBlock(h),
                                          ConvBlock(h, h))
        self.transmission_branch = nn.Sequential(ConvBlock(2 * h, h), ConvBlock(h, c // 4),
                                                 Conv2d(c // 4, 1, 1), nn.Sigmoid())
        self.fusion_conv = nn.Sequential(ConvBlock(2 * h, h), Conv2d(h, 3, 3, padding=1),
                                         nn.Tanh())

    def forward(self, x):
        xin = nchw(x)
        size = tuple(xin.shape[2:])
        targets = {8: (size[0] // 2, size[1] // 2), 10: size}
        g = xin
        for i, block in enumerate(self.global_branch):
            g = block(g, targets[i]) if i in targets else block(g)
        hcat = torch.cat([g, self.local_branch(xin)], 1)
        t = self.transmission_branch(hcat)
        return nhwc(torch.clamp(xin + (1.0 - t) * self.fusion_conv(hcat), 0.0, 1.0))


MODEL = DualBranchAttentionModel
