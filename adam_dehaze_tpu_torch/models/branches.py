"""Intensity-specialised dehazing branches (the default model types).

Counterparts of LightweightDehazeModel, MediumIntensityDehazeModel and
HighIntensityDehazeModel in adam_dehaze_tpu/models/branches.py. forward
takes NHWC float images in [0, 1] and returns NHWC float32 in [0, 1]; inside,
activations are NCHW in channels_last memory, in the dtype of the module's
conv weights (float32, or the compute dtype of a serving copy).

Submodule names are the upstream reference's (`init_conv`,
`residual_blocks.{i}`, `encoder.{0,1}.{k}`, `bottleneck.{k}`,
`decoder.{0,1}.{k}`, `detail_branch.{k}`, `output_conv.{k}`,
`skip_alpha`), as read by adam_dehaze_tpu/training/checkpoint.py:
_branch_layout.

Under `cuda.remat: fullres` the factories checkpoint each branch's
full-resolution blocks (`fullres_blocks`, training/remat.py), as the JAX
package's `_fullres_blocks` builds them as remat twins: the full-resolution
ConvBlocks, ResidualBlocks, AttentionBlocks and the last UpBlock, whose
ResidualBlock and AttentionBlock the port keeps inside it.

The high branch is the canonical forward with all six AttentionBlocks on
kernel K2; the JAX package's space-to-depth rewrite of it was a lane-fill
workaround for the TPU and is not ported. The low branch's eval forward on
a CUDA tensor is kernel K1; `LightweightDehazeModel.module_forward` is the
same branch through its modules on any device.
"""
from __future__ import annotations

import torch
from torch import nn

from adam_dehaze_tpu_torch.nn.blocks import (
    AttentionBlock,
    ConvBlock,
    ResidualBlock,
    UpBlock,
    resize_bilinear,
)
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    chain_supported,
    fold_lightweight,
    lightweight_chain,
)
from adam_dehaze_tpu_torch.training.remat import remat_blocks_, remat_mode


def _nchw(x, dtype):
    return x.to(dtype).permute(0, 3, 1, 2)


def _nhwc_f32(y):
    return y.permute(0, 2, 3, 1).float().contiguous()


class LightweightDehazeModel(nn.Module):
    """Low branch: out = (1 - alpha) * x + alpha * sigmoid(net(x)),
    alpha init 0.1."""

    def __init__(self, base_channels: int = 32, n_blocks: int = 3):
        super().__init__()
        c = base_channels
        self.base_channels = c
        self.n_blocks = n_blocks
        self.init_conv = ConvBlock(3, c, 3)
        self.residual_blocks = nn.Sequential(
            *[ResidualBlock(c) for _ in range(n_blocks)])
        self.output_conv = nn.Sequential(
            ConvBlock(c, c, 3), nn.Conv2d(c, 3, 3, padding=1), nn.Sigmoid())
        self.skip_alpha = nn.Parameter(torch.tensor(0.1))

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.init_conv.block[0].weight.dtype

    def fullres_blocks(self):
        """The blocks that `cuda.remat: fullres` checkpoints: all of them."""
        return (["init_conv"] + [f"residual_blocks.{i}" for i in range(self.n_blocks)]
                + ["output_conv.0"])

    def serving_chain(self, dtype: torch.dtype):
        """Kernel K1's folded weights in `dtype` when the kernel takes this
        width and depth, else None: the one place K1 is chosen, by shape and
        up front. Serving folds once (ops/serving_apply.py)."""
        if not chain_supported(self.base_channels, self.n_blocks, dtype):
            return None
        return fold_lightweight(self, dtype)

    def forward(self, x):
        if not self.training and x.is_cuda:
            # Folds on every call: serving holds a fold-once apply instead.
            chain = self.serving_chain(self.compute_dtype)
            if chain is not None:
                return lightweight_chain(x.float(), chain)
        return self.module_forward(x)

    def module_forward(self, x):
        """The branch through its modules (cuDNN's convs on a CUDA tensor),
        never kernel K1: the training path, and the low branch's
        `canonical` serving candidate."""
        dt = self.compute_dtype
        xin = _nchw(x, dt)
        y = self.output_conv(self.residual_blocks(self.init_conv(xin)))
        alpha = self.skip_alpha.to(dt)
        return _nhwc_f32((1.0 - alpha) * xin + alpha * y)


class MediumIntensityDehazeModel(nn.Module):
    """Medium branch: 2-level encoder/decoder with concat skips,
    out = clip(x + tanh(net(x)), 0, 1)."""

    def __init__(self, base_channels: int = 64, n_blocks: int = 6):
        super().__init__()
        c = base_channels
        self.base_channels = c
        self.n_blocks = n_blocks  # kept for config parity; depth is structural
        self.init_conv = ConvBlock(3, c, 7)
        self.encoder = nn.Sequential(
            nn.Sequential(ConvBlock(c, 2 * c, 4, 2, 1),
                          ResidualBlock(2 * c), ResidualBlock(2 * c)),
            nn.Sequential(ConvBlock(2 * c, 4 * c, 4, 2, 1),
                          ResidualBlock(4 * c), ResidualBlock(4 * c)))
        self.bottleneck = nn.Sequential(ResidualBlock(4 * c), ResidualBlock(4 * c))
        self.decoder = nn.Sequential(
            UpBlock(4 * c, 2 * c, ResidualBlock(2 * c)),
            UpBlock(4 * c, c, ResidualBlock(c)))
        self.output_conv = nn.Sequential(
            ConvBlock(2 * c, c, 3), ConvBlock(c, c // 2, 3),
            nn.Conv2d(c // 2, 3, 3, padding=1))

    def fullres_blocks(self):
        """The full-resolution blocks that `cuda.remat: fullres`
        checkpoints."""
        return ["init_conv", "decoder.1", "output_conv.0", "output_conv.1"]

    def forward(self, x):
        dt = self.init_conv.block[0].weight.dtype
        xin = _nchw(x, dt)
        f0 = self.init_conv(xin)
        e1 = self.encoder[0](f0)
        b = self.bottleneck(self.encoder[1](e1))
        d1 = self.decoder[0](b)
        if d1.shape[2:] != e1.shape[2:]:
            d1 = resize_bilinear(d1, e1.shape[2:])
        d2 = self.decoder[1](torch.cat([d1, e1], dim=1))
        if d2.shape[2:] != f0.shape[2:]:
            d2 = resize_bilinear(d2, f0.shape[2:])
        res = torch.tanh(self.output_conv(torch.cat([d2, f0], dim=1)))
        return _nhwc_f32(torch.clamp(xin + res, 0.0, 1.0))


class HighIntensityDehazeModel(nn.Module):
    """High branch: attention encoder/decoder with a detail-guidance head,
    out = clip(x + tanh(net(x)) * sigmoid(detail(x)), 0, 1)."""

    def __init__(self, base_channels: int = 96, n_blocks: int = 9):
        super().__init__()
        c = base_channels
        self.base_channels = c
        self.n_blocks = n_blocks  # kept for config parity; depth is structural
        self.detail_branch = nn.Sequential(
            ConvBlock(3, 16, 3), ConvBlock(16, 16, 3), nn.Conv2d(16, 1, 1),
            nn.Sigmoid())
        self.init_conv = ConvBlock(3, c, 7)
        self.encoder = nn.Sequential(
            nn.Sequential(ConvBlock(c, 2 * c, 4, 2, 1), ResidualBlock(2 * c),
                          ResidualBlock(2 * c), AttentionBlock(2 * c)),
            nn.Sequential(ConvBlock(2 * c, 4 * c, 4, 2, 1), ResidualBlock(4 * c),
                          ResidualBlock(4 * c), AttentionBlock(4 * c)))
        self.bottleneck = nn.Sequential(
            ResidualBlock(4 * c), AttentionBlock(4 * c),
            ResidualBlock(4 * c), AttentionBlock(4 * c))
        self.decoder = nn.Sequential(
            UpBlock(4 * c, 2 * c, ResidualBlock(2 * c), AttentionBlock(2 * c)),
            UpBlock(4 * c, c, ResidualBlock(c), AttentionBlock(c)))
        self.output_conv = nn.Sequential(
            ConvBlock(2 * c, c, 3), ConvBlock(c, c // 2, 3),
            nn.Conv2d(c // 2, 3, 3, padding=1))

    def fullres_blocks(self):
        """The full-resolution blocks that `cuda.remat: fullres`
        checkpoints."""
        return ["detail_branch.0", "detail_branch.1", "init_conv", "decoder.1",
                "output_conv.0", "output_conv.1"]

    def forward(self, x):
        dt = self.init_conv.block[0].weight.dtype
        xin = _nchw(x, dt)
        guidance = self.detail_branch(xin)
        f0 = self.init_conv(xin)
        e1 = self.encoder[0](f0)
        b = self.bottleneck(self.encoder[1](e1))
        d1 = self.decoder[0](b)
        if d1.shape[2:] != e1.shape[2:]:
            d1 = resize_bilinear(d1, e1.shape[2:])
        d2 = self.decoder[1](torch.cat([d1, e1], dim=1))
        if d2.shape[2:] != f0.shape[2:]:
            d2 = resize_bilinear(d2, f0.shape[2:])
        res = torch.tanh(self.output_conv(torch.cat([d2, f0], dim=1)))
        return _nhwc_f32(torch.clamp(xin + res * guidance, 0.0, 1.0))


def _only(sub, level: str, supported: str):
    if sub["model_type"] != supported:
        raise NotImplementedError(
            f"{level} model_type {sub['model_type']!r} is not ported yet "
            f"(the port has {supported!r})")


def _built(model: nn.Module, config) -> nn.Module:
    if remat_mode(config) == "fullres":
        remat_blocks_(model, model.fullres_blocks())
    return model


def create_low_intensity_model(config) -> nn.Module:
    sub = config["dehazing"]["low"]
    _only(sub, "low", "lightweight")
    return _built(LightweightDehazeModel(sub["channels"], sub["blocks"]), config)


def create_medium_intensity_model(config) -> nn.Module:
    sub = config["dehazing"]["medium"]
    _only(sub, "medium", "standard")
    return _built(MediumIntensityDehazeModel(sub["channels"], sub["blocks"]), config)


def create_high_intensity_model(config) -> nn.Module:
    sub = config["dehazing"]["high"]
    _only(sub, "high", "complex")
    return _built(HighIntensityDehazeModel(sub["channels"], sub["blocks"]), config)


def create_branch_models(config):
    """All three branches keyed by intensity name."""
    return {
        "low": create_low_intensity_model(config),
        "medium": create_medium_intensity_model(config),
        "high": create_high_intensity_model(config),
    }
