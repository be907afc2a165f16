"""LPIPS perceptual distance (torch.nn, NHWC).

Counterpart of adam_dehaze_tpu/losses/lpips.py: AlexNet feature taps,
channel-unit-normalised, squared differences weighted by per-channel linear
heads (relu'd, as lpips keeps them >= 0), spatially averaged, summed over
the five layers. Without calibrated head weights the heads are uniform 1/C:
a monotone surrogate, not the published LPIPS scale.
"""
from __future__ import annotations

import torch
from torch import nn

from adam_dehaze_tpu_torch.nn.alexnet import AlexNetFeatures

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_WIDTHS = (64, 192, 384, 256, 256)


class LPIPS(nn.Module):
    """forward(x, y) with inputs in [-1, 1] NHWC -> per-sample distance (N,)."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, c in enumerate(_WIDTHS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((c,), 1.0 / c)))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        # One trunk pass over the concatenated pair.
        feats = self.net((torch.cat([x, y], dim=0) - self.shift) / self.scale)
        total = x.new_zeros((n,), dtype=torch.float32)
        for i, f in enumerate(feats):
            a, b = f[:n], f[n:]
            an = a * torch.rsqrt((a * a).sum(dim=-1, keepdim=True) + 1e-10)
            bn = b * torch.rsqrt((b * b).sum(dim=-1, keepdim=True) + 1e-10)
            w = torch.relu(getattr(self, f"lin{i}"))
            total = total + (((an - bn) ** 2) * w).sum(dim=-1).mean(dim=(1, 2))
        return total


def lpips_from_unit_range(lpips_module: LPIPS, pred: torch.Tensor,
                          target: torch.Tensor) -> torch.Tensor:
    """LPIPS of [0, 1] images (mapped to [-1, 1] first)."""
    return lpips_module(2.0 * pred - 1.0, 2.0 * target - 1.0)
