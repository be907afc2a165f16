"""Serving at reduced resolution: run a branch at 1/scale of the image size
and lift its correction back to full resolution with a guided-filter joint
upsample (He et al., "Fast Guided Filter", 2015).

Counterpart of adam_dehaze_tpu/ops/resolution.py. Haze is mostly a
low-frequency effect: the additive correction `branch(x) - x` carries far
less high-frequency content than the image, so it is computed at half
resolution (a quarter of the branch's work) while the full-resolution hazy
image supplies the edges through the guided upsample.

This is a quality dial, not an equivalent serving path: the outputs differ
from the branch's own. It is opt-in (`AdaptiveDehazer.route_hard(...,
lowres=("high",))`, or the tuned policy of resolution_autotune.py) and never
a serving_autotune candidate.

Images are NHWC, as the engine hands them to a branch apply; the box
filters and the resizes work on NCHW (`data/synthetic.py:_box_filter`,
`nn/blocks.py:resize_bilinear`, antialiased when shrinking as
jax.image.resize is). Everything is plain PyTorch: the JAX package computes
the filter in XLA, with no Pallas kernel.
"""
from __future__ import annotations

from typing import Callable

import torch

from adam_dehaze_tpu_torch.data.synthetic import _box_filter
from adam_dehaze_tpu_torch.nn.blocks import resize_bilinear

MODES = ("guided", "bilinear")


def _gray(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W): the mean over channels."""
    return x.mean(dim=-1)


def _resize_nhwc(x: torch.Tensor, size) -> torch.Tensor:
    return resize_bilinear(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1).contiguous()


def guided_upsample(guide_hi: torch.Tensor, guide_lo: torch.Tensor, src_lo: torch.Tensor,
                    radius: int = 4, eps: float = 1e-4) -> torch.Tensor:
    """Joint upsampling of a low-resolution map with a full-resolution
    grayscale guide: the local linear model `src ~ a * guide + b` is solved
    at low resolution (box filters over (2r+1)^2 windows), the smoothed
    coefficient planes are upsampled bilinearly and applied to the
    full-resolution guide.

    guide_hi (N, H, W); guide_lo (N, h, w), the same guide at src_lo's
    size; src_lo (N, h, w, C). Returns (N, H, W, C)."""
    g = guide_lo[:, None]                       # (N, 1, h, w)
    s = src_lo.permute(0, 3, 1, 2)              # (N, C, h, w)
    mean_g = _box_filter(g, radius)
    mean_s = _box_filter(s, radius)
    corr_gs = _box_filter(g * s, radius)
    corr_gg = _box_filter(g * g, radius)
    var_g = corr_gg - mean_g * mean_g
    cov_gs = corr_gs - mean_g * mean_s
    a = cov_gs / (var_g + eps)
    b = mean_s - a * mean_g
    hi = tuple(guide_hi.shape[-2:])
    a = resize_bilinear(_box_filter(a, radius), hi).permute(0, 2, 3, 1)
    b = resize_bilinear(_box_filter(b, radius), hi).permute(0, 2, 3, 1)
    return a * guide_hi[..., None] + b


def make_lowres_apply(apply_fn: Callable[[torch.Tensor], torch.Tensor], scale: int = 2,
                      mode: str = "guided", radius: int = 4, eps: float = 1e-4
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A full-resolution branch apply served at reduced resolution:

    x -> shrink by `scale` -> apply_fn -> correction (out_lo - x_lo)
      -> lift to full resolution (`guided` joint upsample, or `bilinear`)
      -> clip(x + correction, 0, 1).

    The residual correction is lifted, not the output, so a branch that
    returns its input stays exactly the identity. x (N, H, W, 3) float32 ->
    (N, H, W, 3) float32; apply_fn's output is taken in float32."""
    if mode not in MODES:
        raise ValueError(f"mode must be guided|bilinear, got {mode!r}")

    def apply(x: torch.Tensor) -> torch.Tensor:
        _, hh, ww, _ = x.shape
        x_lo = _resize_nhwc(x, (hh // scale, ww // scale))
        corr_lo = apply_fn(x_lo).float() - x_lo
        if mode == "guided":
            corr = guided_upsample(_gray(x), _gray(x_lo), corr_lo, radius=radius, eps=eps)
        else:
            corr = _resize_nhwc(corr_lo, (hh, ww))
        return torch.clamp(x + corr, 0.0, 1.0)

    return apply
