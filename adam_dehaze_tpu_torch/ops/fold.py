"""Eval-mode BatchNorm folding.

The counterpart of adam_dehaze_tpu/ops/s2d.py:_fold_bn and _fold_convblock,
and of the ConvTranspose bias fold of make_high_s2d_apply (s2d.py:489-492).
A conv followed by eval-mode BN is one conv with per-output-channel scaled
weights and a shift:

    bn(conv(x)) = conv(x; w * s) + (beta - s * mean),  s = gamma / sqrt(var + eps)

Weights keep torch's layout (OIHW for Conv2d, (in, out, kH, kW) for
ConvTranspose2d). Everything is computed in float32; callers cast.

The decoder tail's folds (counterparts of adam_dehaze_tpu/ops/pallas/
tail_chain.py:_fold_up4 and _fold_head1_split) are here too: the UpBlock's
stride-2 ConvTranspose as four sub-pixel phase convs of 2x2 taps, and the
head conv that reads cat([d2, f0]) as one conv per half.
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


def fold_upblock_phases(up) -> Tuple[torch.Tensor, torch.Tensor]:
    """The UpBlock's ConvTranspose2d(4, stride 2, pad 1) + BN as four
    sub-pixel phase convs (the JAX package's s2d_up4 and
    _SubpixelConvTranspose4x4, in torch's tap order). Output pixel
    (2m + a, 2n + b) of phase (a, b) is a 2x2-tap conv of the input:

        out[2m + a, 2n + b] = sum_{u, v} x[m - 1 + a + u, n - 1 + b + v]
                                         @ w[:, :, 3 - a - 2u, 3 - b - 2v]

    (from oy = 2 * iy - 1 + ky; x is zero outside the image). Returns
    (phases, shift): phases (2, 2, 2, 2, Cin, Cout) indexed [a, b, u, v]
    with the BN scale folded in, and the shift of fold_upblock."""
    w, shift = fold_upblock(up)                      # (Cin, Cout, 4, 4)
    phases = torch.stack([
        torch.stack([
            torch.stack([
                torch.stack([w[:, :, 3 - a - 2 * u, 3 - b - 2 * v]
                             for v in (0, 1)])
                for u in (0, 1)])
            for b in (0, 1)])
        for a in (0, 1)])
    return phases, shift


def fold_head_split(block, c_first: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A ConvBlock that reads cat([a, b], dim=1), a with `c_first` channels,
    as two convs summed: returns (weight on a, weight on b, shift), OIHW,
    so that the concat is never written."""
    w, shift = fold_convblock(block)
    return w[:, :c_first], w[:, c_first:], shift
