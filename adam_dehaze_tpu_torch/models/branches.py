"""Intensity-specialised dehazing branches, every model type of the JAX
package.

Counterparts of adam_dehaze_tpu/models/branches.py: the defaults
LightweightDehazeModel, MediumIntensityDehazeModel and
HighIntensityDehazeModel, and the alternates LowIntensityUNet (low, any
`model_type` but "lightweight"), COrunInspiredModel (medium "corun"),
DualBranchAttentionModel (high "dual_branch") and EncoderDecoder (medium
and high "encoder_decoder"; with attention in the high one). forward
takes NHWC float images in [0, 1] and returns NHWC float32 in [0, 1]; inside,
activations are NCHW in channels_last memory, in the dtype of the module's
conv weights (float32, or the compute dtype of a serving copy).

Submodule names are the upstream reference's (`init_conv`,
`residual_blocks.{i}`, `encoder.{0,1}.{k}`, `bottleneck.{k}`,
`decoder.{0,1}.{k}`, `detail_branch.{k}`, `output_conv.{k}`,
`skip_alpha`; the alternates' in their classes), as read by
adam_dehaze_tpu/training/checkpoint.py:_branch_layout. EncoderDecoder had
no working reference layout and names its submodules itself.

Under `cuda.remat: fullres` the factories checkpoint each branch's
full-resolution blocks (`fullres_blocks`, training/remat.py), as the JAX
package's `_fullres_blocks` builds them as remat twins: the full-resolution
ConvBlocks, ResidualBlocks, AttentionBlocks and UpBlocks (a default
branch's last UpBlock with the ResidualBlock and AttentionBlock the port
keeps inside it).

The medium and high branches call `shard_channels` (parallel/sharding.py)
after their 4c stem and after their bottleneck, as the JAX branches do: a
no-op outside `channel_sharding`.

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
    UpsampleAlignCorners,
    resize_bilinear,
)
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    chain_supported,
    fold_lightweight,
    lightweight_chain,
)
from adam_dehaze_tpu_torch.parallel.sharding import shard_channels
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
        # TP hooks (parallel/sharding.py): the widest stage (4c channels).
        e2 = shard_channels(self.encoder[1][0](e1))
        b = shard_channels(self.bottleneck(self.encoder[1][1:](e2)))
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
        # TP hooks (parallel/sharding.py): the widest stage (4c channels).
        e2 = shard_channels(self.encoder[1][0](e1))
        b = shard_channels(self.bottleneck(self.encoder[1][1:](e2)))
        d1 = self.decoder[0](b)
        if d1.shape[2:] != e1.shape[2:]:
            d1 = resize_bilinear(d1, e1.shape[2:])
        d2 = self.decoder[1](torch.cat([d1, e1], dim=1))
        if d2.shape[2:] != f0.shape[2:]:
            d2 = resize_bilinear(d2, f0.shape[2:])
        res = torch.tanh(self.output_conv(torch.cat([d2, f0], dim=1)))
        return _nhwc_f32(torch.clamp(xin + res * guidance, 0.0, 1.0))


class LowIntensityUNet(nn.Module):
    """Low branch, alternative: a one-level U-Net,
    out = clip(x + (sigmoid(net(x)) - 0.5) * 2, 0, 1). Children:
    `init_conv`, `down1` (the strided ConvBlock and a ResidualBlock),
    `bottleneck` (n_blocks - 1 ResidualBlocks), `up1`, `output_conv`."""

    def __init__(self, base_channels: int = 32, n_blocks: int = 3):
        super().__init__()
        c = base_channels
        self.base_channels = c
        self.n_blocks = n_blocks
        self.init_conv = ConvBlock(3, c, 3)
        self.down1 = nn.Sequential(ConvBlock(c, 2 * c, 4, 2, 1), ResidualBlock(2 * c))
        self.bottleneck = nn.Sequential(*[ResidualBlock(2 * c) for _ in range(n_blocks - 1)])
        self.up1 = UpBlock(2 * c, c)
        self.output_conv = nn.Sequential(
            ConvBlock(2 * c, c, 3), ConvBlock(c, c, 3), nn.Conv2d(c, 3, 3, padding=1),
            nn.Sigmoid())

    def fullres_blocks(self):
        """The full-resolution blocks that `cuda.remat: fullres`
        checkpoints."""
        return ["init_conv", "up1", "output_conv.0", "output_conv.1"]

    def forward(self, x):
        xin = _nchw(x, self.init_conv.block[0].weight.dtype)
        f0 = self.init_conv(xin)
        up = self.up1(self.bottleneck(self.down1(f0)))
        res = (self.output_conv(torch.cat([up, f0], dim=1)) - 0.5) * 2.0
        return _nhwc_f32(torch.clamp(xin + res, 0.0, 1.0))


class COrunInspiredModel(nn.Module):
    """Medium branch, alternative: a three-scale pyramid (full, 1/2, 1/4,
    the coarse ones lifted back by align-corners bilinear), a 1x1 fusion and
    a residual stack, out = clip(x + tanh(net(x)), 0, 1). Children:
    `init_conv`, `scale1_conv`, `scale2_conv` and `scale3_conv` (pool,
    ConvBlock, upsample), `fusion_conv`, `residual_blocks`, `output_conv`."""

    def __init__(self, base_channels: int = 64, n_blocks: int = 6):
        super().__init__()
        c = base_channels
        self.base_channels = c
        self.n_blocks = n_blocks
        self.init_conv = ConvBlock(3, c, 7)
        self.scale1_conv = ConvBlock(c, c, 3)
        self.scale2_conv = nn.Sequential(nn.MaxPool2d(2), ConvBlock(c, 2 * c, 3),
                                         UpsampleAlignCorners())
        self.scale3_conv = nn.Sequential(nn.MaxPool2d(4), ConvBlock(c, 4 * c, 3),
                                         UpsampleAlignCorners())
        self.fusion_conv = ConvBlock(7 * c, 2 * c, 1, padding=0)
        self.residual_blocks = nn.Sequential(
            *[ResidualBlock(2 * c) for _ in range(n_blocks)])
        self.output_conv = nn.Sequential(
            ConvBlock(2 * c, c, 3), nn.Conv2d(c, 3, 3, padding=1), nn.Tanh())

    def fullres_blocks(self):
        """The full-resolution blocks that `cuda.remat: fullres`
        checkpoints."""
        return (["init_conv", "scale1_conv", "fusion_conv"]
                + [f"residual_blocks.{i}" for i in range(self.n_blocks)] + ["output_conv.0"])

    def forward(self, x):
        xin = _nchw(x, self.init_conv.block[0].weight.dtype)
        f0 = self.init_conv(xin)
        scales = [self.scale1_conv(f0)]
        for pool, conv, up in (self.scale2_conv, self.scale3_conv):
            scales.append(up(conv(pool(f0)), f0.shape[2:]))
        h = self.residual_blocks(self.fusion_conv(torch.cat(scales, dim=1)))
        return _nhwc_f32(torch.clamp(xin + self.output_conv(h), 0.0, 1.0))


class DualBranchAttentionModel(nn.Module):
    """High branch, alternative: a global branch (two max-pools, residual
    and CBAM attention blocks at 1/2 and 1/4, align-corners upsampling back)
    beside a full-resolution local branch; a transmission map t scales the
    residual, out = clip(x + (1 - t) * tanh(net(x)), 0, 1). Children:
    `global_branch.{0..11}` (pools at 1 and 4, upsamples at 8 and 10),
    `local_branch`, `transmission_branch`, `fusion_conv`. Both
    AttentionBlocks run kernel K2 on a CUDA tensor."""

    def __init__(self, base_channels: int = 96, n_blocks: int = 9):
        super().__init__()
        c, h = base_channels, base_channels // 2
        self.base_channels = c
        self.n_blocks = n_blocks  # kept for config parity; depth is structural
        self.global_branch = nn.Sequential(
            ConvBlock(3, c, 7), nn.MaxPool2d(2), ResidualBlock(c), AttentionBlock(c),
            nn.MaxPool2d(2), ResidualBlock(c), AttentionBlock(c), ResidualBlock(c),
            UpsampleAlignCorners(), ResidualBlock(c), UpsampleAlignCorners(),
            ConvBlock(c, h, 3))
        self.local_branch = nn.Sequential(
            ConvBlock(3, h, 3), ResidualBlock(h), ResidualBlock(h), ConvBlock(h, h, 3))
        self.transmission_branch = nn.Sequential(
            ConvBlock(2 * h, h, 3), ConvBlock(h, c // 4, 3), nn.Conv2d(c // 4, 1, 1),
            nn.Sigmoid())
        self.fusion_conv = nn.Sequential(
            ConvBlock(2 * h, h, 3), nn.Conv2d(h, 3, 3, padding=1), nn.Tanh())

    def fullres_blocks(self):
        """The full-resolution blocks that `cuda.remat: fullres`
        checkpoints."""
        return (["global_branch.0", "global_branch.11"]
                + [f"local_branch.{i}" for i in range(4)]
                + ["transmission_branch.0", "transmission_branch.1", "fusion_conv.0"])

    def forward(self, x):
        xin = _nchw(x, self.global_branch[0].block[0].weight.dtype)
        size = xin.shape[2:]
        # The upsamples go back to half the input's size, then to its size.
        targets = {8: (size[0] // 2, size[1] // 2), 10: tuple(size)}
        g = xin
        for i, block in enumerate(self.global_branch):
            g = block(g, targets[i]) if i in targets else block(g)
        h = torch.cat([g, self.local_branch(xin)], dim=1)
        t = self.transmission_branch(h)
        return _nhwc_f32(torch.clamp(xin + (1.0 - t) * self.fusion_conv(h), 0.0, 1.0))


class EncoderDecoder(nn.Module):
    """Generic three-level encoder/decoder with concat skips and learned 1x1
    fusions, out = clip(x + tanh(net(x)), 0, 1); with `use_attention` a CBAM
    AttentionBlock (kernel K2 on a CUDA tensor) ends the bottleneck.
    `per` = max(n_blocks // 3, 1) ResidualBlocks a level.

    The upstream reference had no working version of this module (it made
    untrained fusion convs inside forward), so there is no reference key
    layout: the names here are the port's own. Children: `init_conv`;
    `encoder.{l}` (l = 0, 1, 2): the strided ConvBlock, then `per`
    ResidualBlocks; `bottleneck`: two ResidualBlocks, then the
    AttentionBlock; `decoder.{l}`: `per` ResidualBlocks, then the UpBlock
    (`decoder.{l}.{per}`); `fusion.{l}`: the bias 1x1 ConvBlock (no BN, no
    activation) after the skip concat; `output_conv`: a ConvBlock and the
    3-channel conv."""

    def __init__(self, base_channels: int = 64, n_blocks: int = 6,
                 use_attention: bool = False):
        super().__init__()
        c = base_channels
        self.base_channels = c
        self.n_blocks = n_blocks
        self.per = per = max(n_blocks // 3, 1)
        self.use_attention = use_attention
        self.init_conv = ConvBlock(3, c, 7)
        widths = [c, 2 * c, 4 * c, 8 * c]
        self.encoder = nn.Sequential(*[
            nn.Sequential(ConvBlock(w, 2 * w, 4, 2, 1),
                          *[ResidualBlock(2 * w) for _ in range(per)])
            for w in widths[:3]])
        self.bottleneck = nn.Sequential(
            ResidualBlock(8 * c), ResidualBlock(8 * c),
            *([AttentionBlock(8 * c)] if use_attention else []))
        self.decoder = nn.Sequential(*[
            nn.Sequential(*[ResidualBlock(w) for _ in range(per)], UpBlock(w, w // 2))
            for w in widths[:0:-1]])
        self.fusion = nn.Sequential(*[
            ConvBlock(w, w // 2, 1, padding=0, use_bn=False, activation=False)
            for w in widths[:0:-1]])
        self.output_conv = nn.Sequential(
            ConvBlock(c, c, 3), nn.Conv2d(c, 3, 3, padding=1), nn.Tanh())

    def fullres_blocks(self):
        """The full-resolution blocks that `cuda.remat: fullres`
        checkpoints."""
        return ["init_conv", f"decoder.2.{self.per}", "fusion.2", "output_conv.0"]

    def forward(self, x):
        xin = _nchw(x, self.init_conv.block[0].weight.dtype)
        h = self.init_conv(xin)
        skips = [h]
        for stage in self.encoder:
            h = stage(h)
            skips.append(h)
        h = self.bottleneck(h)
        # skips[-1] is the bottleneck's input; decode against skips[2], [1], [0].
        for stage, fusion, skip in zip(self.decoder, self.fusion, skips[2::-1]):
            h = stage(h)
            if h.shape[2:] != skip.shape[2:]:
                h = resize_bilinear(h, skip.shape[2:])
            h = fusion(torch.cat([h, skip], dim=1))
        return _nhwc_f32(torch.clamp(xin + self.output_conv(h), 0.0, 1.0))


def _built(model: nn.Module, config) -> nn.Module:
    if remat_mode(config) == "fullres":
        remat_blocks_(model, model.fullres_blocks())
    return model


def create_low_intensity_model(config) -> nn.Module:
    """"lightweight" is the default; any other low model_type is the U-Net,
    as the JAX factory decides."""
    sub = config["dehazing"]["low"]
    cls = LightweightDehazeModel if sub["model_type"] == "lightweight" else LowIntensityUNet
    return _built(cls(sub["channels"], sub["blocks"]), config)


def create_medium_intensity_model(config) -> nn.Module:
    """"corun", "encoder_decoder" (no attention), else the default."""
    sub = config["dehazing"]["medium"]
    if sub["model_type"] == "encoder_decoder":
        model = EncoderDecoder(sub["channels"], sub["blocks"], use_attention=False)
    else:
        cls = COrunInspiredModel if sub["model_type"] == "corun" else MediumIntensityDehazeModel
        model = cls(sub["channels"], sub["blocks"])
    return _built(model, config)


def create_high_intensity_model(config) -> nn.Module:
    """"dual_branch", "encoder_decoder" (with attention), else the
    default."""
    sub = config["dehazing"]["high"]
    if sub["model_type"] == "encoder_decoder":
        model = EncoderDecoder(sub["channels"], sub["blocks"], use_attention=True)
    else:
        cls = (DualBranchAttentionModel if sub["model_type"] == "dual_branch"
               else HighIntensityDehazeModel)
        model = cls(sub["channels"], sub["blocks"])
    return _built(model, config)


def create_branch_models(config):
    """All three branches keyed by intensity name."""
    return {
        "low": create_low_intensity_model(config),
        "medium": create_medium_intensity_model(config),
        "high": create_high_intensity_model(config),
    }
