"""The plain layers that the reference's branches and backbones share.

Every operation is a stock torch operation computed in the dtype of its
input; NCHW inside. `set_rounding(model, dtype)` makes every convolution and
linear layer round its input and its weights to `dtype` first (a per-tensor
scale for the 8-bit floats), so that the same module computes the control
of the comparison: the reference in a precision below the one a
configuration states.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = {torch.float8_e4m3fn: 448.0}


def round_to(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """t rounded to `dtype` and back to t's dtype (None: t as it is). An
    8-bit float is taken with one scale for the whole tensor, its largest
    magnitude mapped to the format's largest finite value. Under autograd
    the rounding is passed straight through: the backward stays in t's
    dtype."""
    if dtype is None:
        return t
    with torch.no_grad():
        if dtype in FP8_MAX:
            scale = t.abs().amax().clamp_min(1e-12) / FP8_MAX[dtype]
            q = (t / scale).to(dtype).to(t.dtype) * scale
        else:
            q = t.to(dtype).to(t.dtype)
    # The rounded value forward; the gradient passes as through the identity.
    return q if not t.requires_grad else t + (q - t).detach()


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose input and weights are rounded to `rounding` first."""
    rounding: Optional[torch.dtype] = None

    def forward(self, x):
        return self._conv_forward(round_to(x, self.rounding),
                                  round_to(self.weight, self.rounding), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    rounding: Optional[torch.dtype] = None

    def forward(self, x):
        return F.conv_transpose2d(round_to(x, self.rounding),
                                  round_to(self.weight, self.rounding), self.bias,
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    rounding: Optional[torch.dtype] = None

    def forward(self, x):
        return F.linear(round_to(x, self.rounding), round_to(self.weight, self.rounding),
                        self.bias)


def set_rounding(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Round the inputs and weights of every conv and linear layer of
    `model` to `dtype` (None: compute in the input's dtype)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.rounding = dtype
    return model


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class ConvBlock(nn.Module):
    """Conv -> BN -> ReLU; the conv has a bias only without BN."""

    def __init__(self, cin, cout, k=3, stride=1, padding=None, use_bn=True, act=True):
        super().__init__()
        p = k // 2 if padding is None else padding
        layers = [Conv2d(cin, cout, k, stride, p, bias=not use_bn)]
        if use_bn:
            layers.append(bn(cout))
        if act:
            layers.append(nn.ReLU())
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return self.block(x)


class ResidualBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = ConvBlock(c, c)
        self.conv2 = ConvBlock(c, c, act=False)

    def forward(self, x):
        return torch.relu(self.conv2(self.conv1(x)) + x)


def cbam_gate(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CBAM's two gates on NCHW x: the channel gate g (N, C), then the
    spatial gate sigmoid(conv7x7([mean_c, max_c])) of the gated tensor."""
    gated = x * g[:, :, None, None]
    stats = torch.cat([gated.mean(dim=1, keepdim=True), gated.amax(dim=1, keepdim=True)], 1)
    return gated * torch.sigmoid(F.conv2d(stats, w, padding=3))


class AttentionBlock(nn.Module):
    """CBAM: channel gate sigmoid(MLP(avg) + MLP(max)) with a bias-free
    two-layer MLP of 1x1 convs (reduction 16), then the 7x7 spatial gate."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        hidden = max(c // reduction, 1)
        self.fc = nn.Sequential(Conv2d(c, hidden, 1, bias=False), nn.ReLU(),
                                Conv2d(hidden, c, 1, bias=False))
        self.conv_spatial = Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x):
        avg = self.fc(x.mean(dim=(2, 3), keepdim=True))
        mx = self.fc(x.amax(dim=(2, 3), keepdim=True))
        g = torch.sigmoid(avg + mx)[:, :, 0, 0]
        w = round_to(self.conv_spatial.weight, self.conv_spatial.rounding)
        return cbam_gate(x, g, w)


class UpBlock(nn.Sequential):
    """ConvTranspose2d(4, stride 2, pad 1) -> BN -> ReLU, then `tail`."""

    def __init__(self, cin, cout, *tail):
        super().__init__(ConvTranspose2d(cin, cout, 4, 2, 1), bn(cout), nn.ReLU(), *tail)


def upsample_align_corners(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def resize_bilinear(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


class UpsampleAlignCorners(nn.Module):
    def forward(self, x, size):
        return upsample_align_corners(x, size)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(y):
    return y.permute(0, 2, 3, 1).contiguous()


class EncDec(nn.Module):
    """The medium and high branches' two-level encoder/decoder."""

    def _trunk(self, xin):
        f0 = self.init_conv(xin)
        e1 = self.encoder[0](f0)
        b = self.bottleneck(self.encoder[1](e1))
        d1 = self.decoder[0](b)
        if d1.shape[2:] != e1.shape[2:]:
            d1 = resize_bilinear(d1, e1.shape[2:])
        d2 = self.decoder[1](torch.cat([d1, e1], 1))
        if d2.shape[2:] != f0.shape[2:]:
            d2 = resize_bilinear(d2, f0.shape[2:])
        return torch.tanh(self.output_conv(torch.cat([d2, f0], 1)))

    def _output_conv(self, c):
        return nn.Sequential(ConvBlock(2 * c, c), ConvBlock(c, c // 2),
                             Conv2d(c // 2, 3, 3, padding=1))
