"""Synthetic fog and fog-density estimation of the port, batched on device.

Counterpart of adam_dehaze_tpu/data/synthetic.py, function by function:

- the atmospheric scattering model I = J*t + A*(1-t) with
  t = exp(-beta * depth) and the radial depth map
  0.3 + 0.7*sqrt((x-.5)^2 + (y-.2)^2);
- per-intensity (beta, A) ranges, and the boundary-weighted draw that the
  classifier's re-fogging uses;
- the dark-channel-prior transmission estimate (15x15 erosion, atmospheric
  light from the dark channel, omega 0.95) refined by a box-filter guided
  filter; `fog_density_map` feeds the density-weighted loss.

Random draws come from an explicit `torch.Generator` on the images' device,
so a batch of fog variants is a few tensor ops. The draws differ from
jax.random's; the tests hand both packages the same parameters. Images are
NHWC in [0, 1]; maps are (..., H, W).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (beta_range, A_range) per intensity class.
INTENSITY_RANGES: Dict[str, Tuple[Tuple[float, float], Tuple[float, float]]] = {
    "low": ((0.1, 0.4), (0.5, 0.7)),
    "medium": ((0.4, 0.7), (0.7, 0.9)),
    "high": ((0.7, 1.0), (0.8, 1.0)),
    "random": ((0.1, 1.0), (0.5, 1.0)),
}

INTENSITY_NAMES = ("low", "medium", "high")


def _depth_map(h: int, w: int, device=None) -> torch.Tensor:
    """Radial depth approximation, (H, W) f32."""
    x = torch.linspace(0.0, 1.0, w, device=device)
    y = torch.linspace(0.0, 1.0, h, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return 0.3 + 0.7 * torch.sqrt((xx - 0.5) ** 2 + (yy - 0.2) ** 2)


def _per_image(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar, or a (batch,) vector broadcast over (H, W, C)."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.reshape(-1, 1, 1, 1) if v.dim() > 0 else v


def apply_fog(clear: torch.Tensor, beta, A) -> torch.Tensor:
    """Apply the atmospheric scattering model to NHWC images in [0, 1].

    beta, A: scalars or (batch,) vectors."""
    h, w = clear.shape[-3], clear.shape[-2]
    t = torch.exp(-_per_image(beta, clear)
                  * _depth_map(h, w, clear.device).to(clear.dtype)[..., None])
    hazy = clear * t + _per_image(A, clear) * (1.0 - t)
    return hazy.clamp(0.0, 1.0)


def _range_tables(device):
    lows_b, highs_b, lows_a, highs_a = (
        torch.tensor([INTENSITY_RANGES[n][i][j] for n in INTENSITY_NAMES], device=device)
        for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    return lows_b, highs_b, lows_a, highs_a


def random_fog_params(generator: torch.Generator, intensity: torch.Tensor,
                      batch: int):
    """Per-image (beta, A), uniform in the ranges of the integer intensity
    labels (0/1/2); drawn on the generator's device."""
    dev = generator.device
    intensity = torch.as_tensor(intensity, device=dev).long()
    lows_b, highs_b, lows_a, highs_a = _range_tables(dev)
    ub = torch.rand(batch, generator=generator, device=dev)
    ua = torch.rand(batch, generator=generator, device=dev)
    beta = lows_b[intensity] + ub * (highs_b[intensity] - lows_b[intensity])
    A = lows_a[intensity] + ua * (highs_a[intensity] - lows_a[intensity])
    return beta, A


def apply_random_fog(generator: torch.Generator, clear: torch.Tensor,
                     intensity: torch.Tensor) -> torch.Tensor:
    """Batched random fog: NHWC clear images + integer labels -> hazy."""
    beta, A = random_fog_params(generator, intensity, clear.shape[0])
    return apply_fog(clear, beta, A)


def boundary_fog_params(generator: torch.Generator, intensity: torch.Tensor,
                        batch: int, boundary_frac: float = 0.5,
                        margin: float = 0.08):
    """Class-conditional (beta, A) with extra mass at the class edges.

    With probability `boundary_frac` a sample's beta is drawn uniformly from
    the `margin`-wide strip inside its own class next to a class edge
    (medium picks one of its two edges at random); otherwise uniformly from
    the full class range. A is uniform in the class range. Labels stay
    exact: the strip never crosses the edge."""
    dev = generator.device
    intensity = torch.as_tensor(intensity, device=dev).long()
    lows_b, highs_b, lows_a, highs_a = _range_tables(dev)
    # Per class, [lo, lo + margin) at each of its (up to two) edges; a
    # class's missing second strip repeats its real one.
    strip_lo = torch.stack([
        torch.stack([highs_b[0] - margin, highs_b[0] - margin]),
        torch.stack([lows_b[1], highs_b[1] - margin]),
        torch.stack([lows_b[2], lows_b[2]]),
    ])
    ub = torch.rand(batch, generator=generator, device=dev)
    ua = torch.rand(batch, generator=generator, device=dev)
    use_strip = torch.rand(batch, generator=generator, device=dev) < boundary_frac
    edge = (torch.rand(batch, generator=generator, device=dev) < 0.5).long()
    beta_full = lows_b[intensity] + ub * (highs_b[intensity] - lows_b[intensity])
    beta_strip = strip_lo[intensity, edge] + ub * margin
    beta = torch.where(use_strip, beta_strip, beta_full)
    A = lows_a[intensity] + ua * (highs_a[intensity] - lows_a[intensity])
    return beta, A


def refog_batch(generator: torch.Generator, batch, prob: float = 0.5,
                boundary_frac: float = 0.5, margin: float = 0.08):
    """Replace a random subset of a triplet batch's hazy images with fresh
    fog rendered from the clear images (boundary-weighted beta). Labels are
    unchanged; returns the batch dict with only "hazy" replaced."""
    n = batch["hazy"].shape[0]
    beta, A = boundary_fog_params(generator, batch["intensity"], n,
                                  boundary_frac=boundary_frac, margin=margin)
    fresh = apply_fog(batch["clear"], beta, A)
    take = torch.rand(n, generator=generator, device=generator.device) < prob
    out = dict(batch)
    out["hazy"] = torch.where(take.to(fresh.device)[:, None, None, None], fresh,
                              batch["hazy"])
    return out


def _as_maps(x: torch.Tensor):
    """(..., H, W) -> (M, 1, H, W) and the leading shape."""
    lead = x.shape[:-2]
    return x.reshape(-1, 1, *x.shape[-2:]), lead


def _min_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Sliding-window minimum (erosion) with SAME padding, (..., H, W)."""
    maps, lead = _as_maps(x)
    out = -F.max_pool2d(-maps, size, stride=1, padding=size // 2)
    return out.reshape(*lead, *x.shape[-2:])


def _box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over a (2r+1)^2 window clipped to the image, (..., H, W): an
    integral image, O(1) work a pixel whatever the radius."""
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device
    r_hi = (torch.arange(h, device=dev) + radius + 1).clamp(0, h)
    r_lo = (torch.arange(h, device=dev) - radius).clamp(0, h)
    c_hi = (torch.arange(w, device=dev) + radius + 1).clamp(0, w)
    c_lo = (torch.arange(w, device=dev) - radius).clamp(0, w)

    def windowed_sum(v):
        ii = F.pad(v.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
        rows_hi, rows_lo = ii[..., r_hi, :], ii[..., r_lo, :]
        return (rows_hi[..., c_hi] - rows_hi[..., c_lo]
                - rows_lo[..., c_hi] + rows_lo[..., c_lo])

    counts = windowed_sum(torch.ones((h, w), dtype=x.dtype, device=dev))
    return windowed_sum(x) / counts


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 40,
                  eps: float = 1e-3) -> torch.Tensor:
    """He et al. guided filter on (..., H, W) grayscale maps."""
    mean_g = _box_filter(guide, radius)
    mean_s = _box_filter(src, radius)
    corr_gs = _box_filter(guide * src, radius)
    corr_gg = _box_filter(guide * guide, radius)
    var_g = corr_gg - mean_g * mean_g
    cov_gs = corr_gs - mean_g * mean_s
    a = cov_gs / (var_g + eps)
    b = mean_s - a * mean_g
    return _box_filter(a, radius) * guide + _box_filter(b, radius)


def estimate_transmission_dcp(hazy: torch.Tensor, patch_size: int = 15,
                              radius: int = 40, omega: float = 0.95) -> torch.Tensor:
    """Dark-channel-prior transmission estimate, NHWC -> (N, H, W):
    grayscale, erosion, atmospheric light = max of the dark channel,
    t = 1 - omega * dark / max(A, 0.1), guided-filter refinement."""
    gray = hazy.mean(dim=-1)
    dark = _min_filter(gray, patch_size)
    A = dark.amax(dim=(-2, -1), keepdim=True)
    t = 1.0 - omega * dark / A.clamp_min(0.1)
    return guided_filter(gray, t, radius=radius)


def fog_density_map(hazy: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Per-pixel fog-density proxy exp(-beta * transmission), (N, H, W)."""
    return torch.exp(-beta * estimate_transmission_dcp(hazy))


def progressive_fog_levels(n_levels: int = 5):
    """(beta, A) schedule for a progressive test set."""
    out = []
    for i in range(n_levels):
        f = (i + 1) / n_levels
        out.append((0.1 + 0.9 * f, 0.5 + 0.5 * f))
    return out


def create_progressive_test_set(clear_imgs_dir: str, output_dir: str,
                                fog_levels: int = 5) -> int:
    """Write `<stem>_fog{i}.png`, i = 1..fog_levels, for every .jpg/.png in
    clear_imgs_dir: the image under apply_fog at progressive_fog_levels'
    (beta, A), truncated to 8 bits. Returns the number of images written."""
    import cv2
    os.makedirs(output_dir, exist_ok=True)
    paths = sorted(list(Path(clear_imgs_dir).glob("*.jpg"))
                   + list(Path(clear_imgs_dir).glob("*.png")))
    levels = progressive_fog_levels(fog_levels)
    written = 0
    for img_path in paths:
        bgr = cv2.imread(str(img_path))
        if bgr is None:
            continue
        clear = torch.from_numpy(
            cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0)[None]
        for i, (beta, A) in enumerate(levels):
            hazy = apply_fog(clear, beta, A)[0].numpy()
            out = cv2.cvtColor((hazy * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
            cv2.imwrite(os.path.join(output_dir, f"{img_path.stem}_fog{i + 1}.png"), out)
            written += 1
    return written
