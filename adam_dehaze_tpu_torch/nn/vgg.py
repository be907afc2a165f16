"""VGG16 feature extractor for the content loss (torch.nn).

Counterpart of adam_dehaze_tpu/nn/vgg.py: one forward pass collects every
requested activation tap (relu{stage}_{idx}). The trunk is torchvision's
`features` layout, `features.N` for the N-th layer, built up to the stage
of the deepest tap, so that the convs of a torchvision VGG16 `.pth` load by
their own keys. Takes NHWC images in [0, 1] and returns NHWC float32 taps,
as the JAX module does (float64 ones from a float64 net); inside, NCHW in
channels_last memory. Under torch.autocast the convs run in the compute
dtype.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

# (width, convs) per VGG16 stage.
_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

def tap_nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW activation as the NHWC tap the loss reads: float32 from a
    reduced compute dtype (as the JAX modules cast their taps), float64
    kept."""
    return x.permute(0, 2, 3, 1).to(torch.promote_types(x.dtype, torch.float32))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """forward(x) -> {tap_name: activation} for the requested taps."""

    def __init__(self, taps: Sequence[str] = ("relu2_2", "relu3_3", "relu4_3")):
        super().__init__()
        self.taps = tuple(taps)
        deepest = max(int(t[4]) for t in self.taps)
        layers, self._tap_at = [], {}
        cin = 3
        for si, (width, n_convs) in enumerate(_STAGES[:deepest], start=1):
            for ci in range(1, n_convs + 1):
                layers += [nn.Conv2d(cin, width, 3, padding=1), nn.ReLU()]
                cin = width
                name = f"relu{si}_{ci}"
                if name in self.taps:
                    self._tap_at[len(layers) - 1] = name
            if si < deepest:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        out = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._tap_at:
                out[self._tap_at[i]] = tap_nhwc(x)
        return out
