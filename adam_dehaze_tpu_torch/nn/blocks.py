"""Shared convolutional building blocks (torch.nn, NCHW).

Counterparts of adam_dehaze_tpu/nn/blocks.py. Submodules are registered
under the upstream reference's torch key names (`block.0` conv, `block.1`
BN, `conv1`/`conv2`, `fc.{0,2}`, `conv_spatial`), so that a reference
`.pth` state_dict loads as is and `training/checkpoint.py` round-trips
with the JAX package's converters.

Blocks run in the dtype of their input; parameters stay float32 unless a
serving copy casts its convolution weights (ops/serving_apply.py). BN is
torch's, eps 1e-5, momentum 0.1 (flax 0.9). Branch models feed the blocks
NCHW tensors in channels_last memory, so the NHWC view that kernel K2 takes
is a free permute.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adam_dehaze_tpu_torch.ops.kernels.cbam import (
    channel_spatial_gate,
    channel_spatial_gate_sharded,
)
from adam_dehaze_tpu_torch.parallel import sharding, spatial
from adam_dehaze_tpu_torch.parallel.collectives import AllReduceSum, channel_slice
from adam_dehaze_tpu_torch.parallel.data_parallel import draw_rows


class ConvBlock(nn.Module):
    """Conv -> optional BatchNorm -> optional ReLU. The conv has a bias
    only when there is no BN. Under int8 serving the conv of a serving
    copy's ConvBlock (`block.0`) becomes an Int8Conv2d that also applies
    the block's eval BN and ReLU, which become `nn.Identity`
    (ops/quant.py:quantized_inference, the counterpart of the JAX block's
    `conv_kwargs()` hook)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None, use_bn: bool = True,
                 activation: bool = True):
        super().__init__()
        p = padding if padding is not None else kernel_size // 2
        layers = [nn.Conv2d(in_channels, out_channels, kernel_size, stride, p,
                            bias=not use_bn)]
        if use_bn:
            layers.append(nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1))
        if activation:
            layers.append(nn.ReLU())
        self.use_bn = use_bn
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return self.block(x)


class ResidualBlock(nn.Module):
    """Two ConvBlocks with an identity skip, final ReLU."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = ConvBlock(channels, channels, kernel_size)
        self.conv2 = ConvBlock(channels, channels, kernel_size, activation=False)

    def forward(self, x):
        return torch.relu(self.conv2(self.conv1(x)) + x)


class AttentionBlock(nn.Module):
    """CBAM channel + spatial attention.

    Channel gate: sigmoid(MLP(avgpool(x)) + MLP(maxpool(x))), the MLP being
    two bias-free 1x1 convs. Spatial gate: sigmoid(conv7x7([mean_c, max_c]))
    of the channel-gated tensor. The MLP stays plain torch; both gates are
    applied by `channel_spatial_gate` (kernel K2 on a CUDA tensor, its plain
    version on a CPU one), with the stencil weights rounded to the compute
    dtype first, as the JAX block does.

    On a shard (parallel/spatial.py, parallel/sharding.py) the pools span
    the whole image (`mean_hw`, `amax_hw`); on this process's channels the
    MLP's first linear takes their columns and adds its partial sums over
    the group, the second yields their rows of the gate, and K2 runs on them
    (`channel_spatial_gate_sharded`).
    """

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc = nn.Sequential(
            nn.Conv2d(channels, hidden, 1, bias=False), nn.ReLU(),
            nn.Conv2d(hidden, channels, 1, bias=False))
        self.conv_spatial = nn.Conv2d(2, 1, 7, padding=3, bias=False)
        self._stencil_for = None       # what the cached stencil was made from
        self._stencil = None

    def stencil(self, dtype: torch.dtype) -> torch.Tensor:
        """The spatial conv's weights rounded to `dtype`, as the gate kernel
        reads them: f32, contiguous, the JAX stencil layout (7, 7, 2, 1).
        Made once per weight (its storage, version, device) and dtype, so
        that a serving call enqueues no conversion."""
        w = self.conv_spatial.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(dtype).permute(2, 3, 1, 0)      # training: differentiable
        made_from = (dtype, w.device, w.data_ptr(),
                     None if w.is_inference() else w._version)
        if self._stencil_for != made_from:
            # (1, 2, 7, 7) OIHW -> (7, 7, 2, 1).
            self._stencil = (w.detach().to(dtype).float().permute(2, 3, 1, 0)
                             .contiguous())
            self._stencil_for = made_from
        return self._stencil

    def forward(self, x):
        w0 = self.fc[0].weight[:, :, 0, 0]
        w1 = self.fc[2].weight[:, :, 0, 0]
        channels = sharding.channel_axis(x, w0.shape[1])
        if channels is not None:
            part = channel_slice(w0.shape[1], channels)
            w0, w1 = w0[:, part], w1[part]
            sharding.used(self.fc[0].weight, self.fc[2].weight, self.conv_spatial.weight)

        def mlp(v):
            h = F.linear(v, w0)
            if channels is not None:
                h = AllReduceSum.apply(h, (channels.group,))
            return F.linear(torch.relu(h), w1)

        gate = torch.sigmoid(mlp(spatial.mean_hw(x)) + mlp(spatial.amax_hw(x)))
        # A no-op for the branches' channels_last activations.
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        rows = spatial.axis()
        if rows is None and channels is None:
            y = channel_spatial_gate(x, gate, self.stencil(x.dtype))
        else:
            y = channel_spatial_gate_sharded(x, gate, self.stencil(x.dtype), rows, channels)
        return y.permute(0, 3, 1, 2)


class Dropout(nn.Module):
    """Dropout whose mask is drawn from a `torch.Generator` passed with each
    call, as flax's Dropout draws from the step's dropout key (nn.Dropout
    takes no generator): keep with probability 1 - p, scale the kept values
    by 1 / (1 - p). The identity in eval mode and at p = 0. Inside a
    data-parallel step the mask is drawn for the global batch
    (parallel/data_parallel.py:draw_rows)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        keep = draw_rows(x.shape[0], lambda n: torch.empty(
            (n, *x.shape[1:]), dtype=x.dtype, device=x.device).bernoulli_(
                1.0 - self.p, generator=generator))
        return x * keep / (1.0 - self.p)


class UpBlock(nn.Sequential):
    """ConvTranspose2d(4, stride 2, pad 1, with bias) -> BN -> ReLU: an exact
    2x upsample. Blocks passed as `tail` follow as children 3, 4, ..., the
    reference's decoder stage layout (`decoder.0.3` is its ResidualBlock)."""

    def __init__(self, in_channels: int, out_channels: int, *tail: nn.Module):
        super().__init__(
            nn.ConvTranspose2d(in_channels, out_channels, 4, stride=2,
                               padding=1, bias=True),
            nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1),
            nn.ReLU(), *tail)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (H, W), half-pixel centers
    (align_corners=False), antialiased when shrinking, like
    jax.image.resize(method="bilinear")."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (H, W) on the align-corners grid
    (output i samples input i * (in - 1) / (out - 1)): torch's
    nn.UpsamplingBilinear2d at a given size, the counterpart of the JAX
    package's `resize_bilinear_align_corners`. That one rounds its lerp
    weights to the compute dtype; torch computes them in float32."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class UpsampleAlignCorners(nn.Module):
    """`resize_bilinear_align_corners` as a module: the reference's
    nn.UpsamplingBilinear2d, at the size the caller passes with each call
    (the input's size times a scale where the sizes divide)."""

    def forward(self, x, size):
        return resize_bilinear_align_corners(x, size)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in place, drawn only from `generator`: conv and linear
    weights lecun-normal (flax's default, std 1/sqrt(fan_in)), biases 0, BN
    scale 1 and shift 0 with fresh running stats. Other parameters (the low
    branch's skip_alpha) keep their constructor values."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else w.shape[1]) * w[0, 0].numel()
            w.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
