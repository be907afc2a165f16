"""MobileNetV2 and MobileNetV3 backbones for the fog-intensity classifier
(torch.nn, NCHW).

Counterpart of adam_dehaze_tpu/nn/mobilenet.py, with torchvision's structure
and state-dict names (`features.0` the stem, `features.i` the inverted
residuals with `conv.*` (V2) or `block.*` (V3), the last `features.N` the
1x1 head conv), as the JAX package's load_torch_mobilenet_v2 and
load_torch_mobilenet_v3 read them. The classifier layers of torchvision are
absent, as in the reference classifier (it replaces them with an identity).

BN is the JAX package's: eps 1e-5, momentum 0.1 (flax 0.9), for V3 too
(torchvision's own V3 takes 1e-3 and 0.01). Convs pad k // 2 on every side,
as flax's explicit ((p, p), (p, p)) does, so stride 2 matches. Activations
are written as the JAX package writes them: relu6, hardswish
x * relu6(x + 3) / 6, hardsigmoid relu6(x + 3) / 6. forward returns the
globally pooled features (B, feature_dim) in float32.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from adam_dehaze_tpu_torch.parallel.spatial import mean_hw

# (expansion t, out channels c, repeats n, first stride s): MobileNetV2.
_V2_CONFIG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]

# (kernel, expanded ch, out ch, use_se, use_hardswish, stride): MobileNetV3.
V3_LARGE_CONFIG = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]

V3_SMALL_CONFIG = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


def hardswish(x):
    return x * F.relu6(x + 3.0) / 6.0


def hardsigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def _make_divisible(v: int, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class Activation(nn.Module):
    """A parameter-free activation function as a module."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def conv_bn(cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1,
            act: Optional[Callable] = None) -> nn.Sequential:
    """torchvision's Conv2dNormActivation: `0` the bias-free conv (pad
    k // 2), `1` its BN, `2` the activation when there is one."""
    layers = [nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False),
              nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)]
    if act is not None:
        layers.append(Activation(act))
    return nn.Sequential(*layers)


class InvertedResidual(nn.Module):
    """MobileNetV2's block: 1x1 expand (when t != 1), 3x3 depthwise, 1x1
    project, all with BN; relu6 after the first two; the identity skip at
    stride 1 when the widths agree. Keys `conv.*` as torchvision's."""

    def __init__(self, cin: int, features: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        layers = [conv_bn(cin, hidden, 1, act=F.relu6)] if expand != 1 else []
        layers += [conv_bn(hidden, hidden, 3, stride, groups=hidden, act=F.relu6),
                   nn.Conv2d(hidden, features, 1, bias=False),
                   nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)]
        self.conv = nn.Sequential(*layers)
        self.skip = stride == 1 and cin == features

    def forward(self, x):
        y = self.conv(x)
        return y + x if self.skip else y


class MobileNetV2(nn.Module):
    """NCHW images -> pooled features (B, 1280) float32."""

    feature_dim = 1280

    def __init__(self):
        super().__init__()
        layers, cin = [conv_bn(3, 32, 3, 2, act=F.relu6)], 32
        for t, c, n, s in _V2_CONFIG:
            for i in range(n):
                layers.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        layers.append(conv_bn(cin, self.feature_dim, 1, act=F.relu6))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return mean_hw(self.features(x)).float()


class SqueezeExcite(nn.Module):
    """MobileNetV3's SE gate (torchvision's SqueezeExcitation): the pooled
    vector through `fc1` (biased 1x1 conv to _make_divisible(channels // 4,
    8)), ReLU, `fc2` back to `channels`, hardsigmoid, times x."""

    def __init__(self, channels: int):
        super().__init__()
        squeeze = _make_divisible(channels // 4, 8)
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x):
        s = self.fc2(torch.relu(self.fc1(mean_hw(x, keepdim=True))))
        return x * hardsigmoid(s)


class InvertedResidualV3(nn.Module):
    """MobileNetV3's block: 1x1 expand (when the widths differ), k x k
    depthwise, the SE gate (when asked), 1x1 project; ReLU or hardswish.
    Keys `block.*` as torchvision's."""

    def __init__(self, cin: int, kernel: int, expanded: int, features: int, use_se: bool,
                 use_hs: bool, stride: int):
        super().__init__()
        act = hardswish if use_hs else F.relu
        layers = [conv_bn(cin, expanded, 1, act=act)] if expanded != cin else []
        layers.append(conv_bn(expanded, expanded, kernel, stride, groups=expanded, act=act))
        if use_se:
            layers.append(SqueezeExcite(expanded))
        layers.append(conv_bn(expanded, features, 1))
        self.block = nn.Sequential(*layers)
        self.skip = stride == 1 and cin == features

    def forward(self, x):
        y = self.block(x)
        return y + x if self.skip else y


class MobileNetV3(nn.Module):
    """NCHW images -> pooled features (B, 576) small, (B, 960) large,
    float32."""

    def __init__(self, variant: str = "small"):
        super().__init__()
        if variant not in ("small", "large"):
            raise ValueError(f"MobileNetV3 variant {variant!r}: small or large")
        self.variant = variant
        cfgs = V3_SMALL_CONFIG if variant == "small" else V3_LARGE_CONFIG
        layers, cin = [conv_bn(3, 16, 3, 2, act=hardswish)], 16
        for k, exp, c, se, hs, s in cfgs:
            layers.append(InvertedResidualV3(cin, k, exp, c, se, hs, s))
            cin = c
        self.feature_dim = 6 * cin
        layers.append(conv_bn(cin, self.feature_dim, 1, act=hardswish))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return mean_hw(self.features(x)).float()
