"""Eval-mode BatchNorm folding.

The counterpart of adam_dehaze_tpu/ops/s2d.py:_fold_bn and _fold_convblock,
and of the ConvTranspose bias fold of make_high_s2d_apply (s2d.py:489-492).
A conv followed by eval-mode BN is one conv with per-output-channel scaled
weights and a shift:

    bn(conv(x)) = conv(x; w * s) + (beta - s * mean),  s = gamma / sqrt(var + eps)

Weights keep torch's layout (OIHW for Conv2d, (in, out, kH, kW) for
ConvTranspose2d). Everything is computed in float32; callers cast.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def _bn_scale_shift(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - s * bn.running_mean.float()


def fold_bn(weight: torch.Tensor, bn: nn.BatchNorm2d
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN into an OIHW conv weight: returns (weight, shift) in f32."""
    s, shift = _bn_scale_shift(bn)
    return weight.float() * s[:, None, None, None], shift


def fold_convblock(block) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight, shift) of a ConvBlock (nn/blocks.py), BN folded when it has
    one, the conv bias as the shift otherwise."""
    conv = block.block[0]
    if block.use_bn:
        return fold_bn(conv.weight, block.block[1])
    return conv.weight.float(), conv.bias.float()


def fold_upblock(up) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight, shift) of an UpBlock's ConvTranspose2d + BN: the weight is
    scaled along its output dim (dim 1) and the transposed conv's bias folds
    into the shift: shift += s * bias."""
    convt, bn = up[0], up[1]
    s, shift = _bn_scale_shift(bn)
    return (convt.weight.float() * s[None, :, None, None],
            shift + s * convt.bias.float())
