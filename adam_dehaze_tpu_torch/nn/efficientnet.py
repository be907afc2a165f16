"""EfficientNet-B0..B3 backbones for the fog-intensity classifier (torch.nn,
NCHW).

Counterpart of adam_dehaze_tpu/nn/efficientnet.py, with timm's structure and
state-dict names (`conv_stem`, `bn1`, `blocks.{stage}.{i}`, `conv_head`,
`bn2`; a block's `conv_dw`, `bn1`, `se.conv_reduce`, `se.conv_expand`,
`conv_pw`, `bn2` when it has no expansion, else `conv_pw`, `bn1`,
`conv_dw`, `bn2`, `se.*`, `conv_pwl`, `bn3`), as the JAX package's
load_torch_efficientnet reads them. MBConv blocks with squeeze-excite and
SiLU; B1-B3 by the paper's compound scaling (round_filters,
round_repeats); `EfficientNetB0()` is B0. BN eps is the paper's 1e-3
(momentum 0.1, flax 0.9), not torch's default. Convs pad k // 2 on every side, as flax's explicit padding
does. forward returns the globally pooled features (B, feature_dim) in
float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from adam_dehaze_tpu_torch.parallel.spatial import mean_hw

# (expansion, channels, repeats, stride, kernel): the EfficientNet-B0 table.
_B0_CONFIG = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

# variant -> (width multiplier, depth multiplier).
SCALING = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4)}


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    """Width scaling with the paper's nearest-multiple-of-8 rule."""
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def efficientnet_feature_dim(variant: str) -> int:
    width, _ = SCALING[variant]
    return round_filters(1280, width)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-3, momentum=0.1)


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False)


class SqueezeExcite(nn.Module):
    """x * sigmoid(conv_expand(silu(conv_reduce(mean_hw(x))))): biased 1x1
    convs, the squeeze width int(in_channels * se_ratio) taken from the
    block's input channels, not its expanded ones."""

    def __init__(self, channels: int, in_channels: int, se_ratio: float = 0.25):
        super().__init__()
        hidden = max(1, int(in_channels * se_ratio))
        self.conv_reduce = nn.Conv2d(channels, hidden, 1)
        self.conv_expand = nn.Conv2d(hidden, channels, 1)

    def forward(self, x):
        s = self.conv_expand(F.silu(self.conv_reduce(mean_hw(x, keepdim=True))))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """1x1 expand (when expand != 1), k x k depthwise, SE, 1x1 project, all
    with BN; SiLU after the first two; the identity skip at stride 1 when
    the widths agree. Submodules are registered in call order, in timm's
    names of the block kind (DepthwiseSeparableConv or InvertedResidual)."""

    def __init__(self, cin: int, features: int, stride: int, expand: int, kernel: int):
        super().__init__()
        hidden = cin * expand
        self.expand = expand
        if expand != 1:
            self.conv_pw = _conv(cin, hidden)
            self.bn1 = _bn(hidden)
            self.conv_dw = _conv(hidden, hidden, kernel, stride, groups=hidden)
            self.bn2 = _bn(hidden)
            self.se = SqueezeExcite(hidden, cin)
            self.conv_pwl = _conv(hidden, features)
            self.bn3 = _bn(features)
        else:
            self.conv_dw = _conv(cin, cin, kernel, stride, groups=cin)
            self.bn1 = _bn(cin)
            self.se = SqueezeExcite(cin, cin)
            self.conv_pw = _conv(cin, features)
            self.bn2 = _bn(features)
        self.skip = stride == 1 and cin == features

    def forward(self, x):
        if self.expand != 1:
            y = F.silu(self.bn1(self.conv_pw(x)))
            y = F.silu(self.bn2(self.conv_dw(y)))
            y = self.bn3(self.conv_pwl(self.se(y)))
        else:
            y = F.silu(self.bn1(self.conv_dw(x)))
            y = self.bn2(self.conv_pw(self.se(y)))
        return y + x if self.skip else y


class EfficientNet(nn.Module):
    """NCHW images -> pooled features (B, feature_dim) float32, variant
    b0..b3."""

    def __init__(self, variant: str = "b0"):
        super().__init__()
        if variant not in SCALING:
            raise ValueError(f"EfficientNet variant {variant!r}: one of {sorted(SCALING)}")
        self.variant = variant
        width, depth = SCALING[variant]
        cin = round_filters(32, width)
        self.conv_stem = _conv(3, cin, 3, 2)
        self.bn1 = _bn(cin)
        stages = []
        for expand, ch, repeats, stride, kernel in _B0_CONFIG:
            ch = round_filters(ch, width)
            blocks = []
            for i in range(round_repeats(repeats, depth)):
                blocks.append(MBConv(cin, ch, stride if i == 0 else 1, expand, kernel))
                cin = ch
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.feature_dim = efficientnet_feature_dim(variant)
        self.conv_head = _conv(cin, self.feature_dim)
        self.bn2 = _bn(self.feature_dim)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        x = F.silu(self.bn2(self.conv_head(self.blocks(x))))
        return mean_hw(x).float()


def EfficientNetB0() -> EfficientNet:
    """EfficientNet-B0 (the JAX package's factory; a serving copy, not the
    module, takes the compute dtype: ops/serving_apply.py)."""
    return EfficientNet(variant="b0")
