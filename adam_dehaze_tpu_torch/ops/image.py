"""Batched image-quality metrics (PSNR, SSIM) of the port.

Counterpart of adam_dehaze_tpu/ops/image.py, with its numerical targets:

- `psnr`: skimage.metrics.peak_signal_noise_ratio with data_range
  (10*log10(dr^2 / mse));
- `ssim_gray`: skimage.metrics.structural_similarity defaults on the
  channel-mean grayscale image: uniform 7x7 filter, K1=0.01, K2=0.03,
  sample covariance (N/(N-1)), averaged over the valid region.

Everything is computed in float32. The variance term cov_norm*(uxx - ux*ux)
cancels catastrophically at reduced precision (the JAX package pins its
filter convolution to HIGHEST for that reason); here the mean filter is an
average pool, which sums in f32 on every device and never takes TF32.
Images are NHWC, as in the JAX package. On an H shard (parallel/spatial.py)
both are the whole image's: PSNR's mean and SSIM's mean over its valid
region are summed over the spatial group and divided by the unsharded
counts, and SSIM's window reads the 6 rows below the shard (the average
pool's rule in parallel/sharded_ops.py).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.parallel import spatial


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR in dB. pred/target: (N, H, W, C) or (N, H, W)."""
    dims = tuple(range(1, pred.dim()))
    mse = spatial.image_mean((pred.float() - target.float()) ** 2, dims)
    return 10.0 * torch.log10((data_range ** 2) / mse.clamp_min(1e-12))


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """VALID-mode mean filter over the last two axes of (N, H, W), in f32."""
    return F.avg_pool2d(x.float()[:, None], size, stride=1)[:, 0]


def ssim_gray(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
              win_size: int = 7) -> torch.Tensor:
    """Per-image SSIM on channel-mean grayscale, skimage-default algorithm.

    pred/target: (N, H, W, C) in [0, data_range]; returns (N,).
    """
    if pred.dim() == 4:
        pred = pred.float().mean(dim=-1)
        target = target.float().mean(dim=-1)
    x = pred.float()
    y = target.float()

    n_px = win_size ** 2
    cov_norm = n_px / (n_px - 1)   # sample covariance, skimage default
    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)
    # The VALID filter already left skimage's cropped region.
    valid = (spatial.rows_total(x.shape[1]) - win_size + 1) * (x.shape[2] - win_size + 1)
    return spatial.image_mean(num / den, (1, 2), count=valid)


def batch_quality(pred: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Both metrics: dict of (N,) tensors."""
    return {"psnr": psnr(pred, target), "ssim": ssim_gray(pred, target)}
