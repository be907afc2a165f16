"""The reference of the `mobilenet_v3_small` classifier backbone
(`classifier.model: mobilenet_v3_small`): pooled features."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.layers import Conv2d, bn


def hardswish(x):
    return x * F.relu6(x + 3.0) / 6.0


def hardsigmoid(x):
    return F.relu6(x + 3.0) / 6.0


class Act(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def conv_bn(cin, cout, k=1, stride=1, groups=1, act=None):
    layers = [Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False), bn(cout)]
    if act is not None:
        layers.append(Act(act))
    return nn.Sequential(*layers)


def _divisible(v, d=8):
    n = max(d, int(v + d / 2) // d * d)
    return n + d if n < 0.9 * v else n


class SqueezeExcite(nn.Module):
    def __init__(self, c):
        super().__init__()
        s = _divisible(c // 4)
        self.fc1 = Conv2d(c, s, 1)
        self.fc2 = Conv2d(s, c, 1)

    def forward(self, x):
        return x * hardsigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3),
                                                                   keepdim=True)))))


class InvertedResidualV3(nn.Module):
    def __init__(self, cin, k, exp, cout, se, hs, stride):
        super().__init__()
        act = hardswish if hs else F.relu
        layers = [conv_bn(cin, exp, 1, act=act)] if exp != cin else []
        layers.append(conv_bn(exp, exp, k, stride, groups=exp, act=act))
        if se:
            layers.append(SqueezeExcite(exp))
        layers.append(conv_bn(exp, cout, 1))
        self.block = nn.Sequential(*layers)
        self.skip = stride == 1 and cin == cout

    def forward(self, x):
        y = self.block(x)
        return y + x if self.skip else y


# (kernel, expanded, out, squeeze-excite, hardswish, stride): torchvision's
# mobilenet_v3_small.
V3_SMALL = [(3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
            (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
            (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
            (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
            (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
            (5, 576, 96, True, True, 1)]


class MobileNetV3Small(nn.Module):
    """torchvision's mobilenet_v3_small features (BN eps 1e-5), pooled."""
    feature_dim = 576

    def __init__(self):
        super().__init__()
        layers, cin = [conv_bn(3, 16, 3, 2, act=hardswish)], 16
        for cfg in V3_SMALL:
            layers.append(InvertedResidualV3(cin, *cfg))
            cin = cfg[2]
        layers.append(conv_bn(cin, 576, 1, act=hardswish))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return self.features(x).mean(dim=(2, 3))


BACKBONE = MobileNetV3Small
