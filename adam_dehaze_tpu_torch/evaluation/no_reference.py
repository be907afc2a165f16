"""No-reference image quality of the port: the BRISQUE-analog and the
NIMA-analog proxies.

Counterpart of adam_dehaze_tpu/evaluation/no_reference.py, function by
function. Both are in-corpus stand-ins, labelled `_proxy` by the evaluator
next to `fade_proxy`, not the published models:

- `brisque_proxy`: an opinion-unaware naturalness score in the NIQE family.
  MSCN coefficients are fit with a generalised Gaussian, their four
  orientation products with asymmetric GGDs, at two scales (36 features);
  the score is the Mahalanobis distance of an image's features from a
  pristine Gaussian fit on the corpus's clear split. Lower is better, not
  on the published 0-100 scale.
- `nima_proxy`: a small convnet in NIMA's shape (a 10-bin score
  distribution, the mean opinion score read out on 1-10), trained on the
  corpus's clear frames and synthetic distortions (fog ladder, blur,
  noise) towards SSIM-to-clear targets. Higher is better; the scale is the
  corpus's.

Features are batched tensor ops on the images' device. The GGD shape comes
from a moment-ratio table held in float32, as the JAX package holds it,
and is read by linear interpolation with the rule of `jnp.interp`. The
half scale is a bilinear resize that antialiases when it downsamples, as
`jax.image.resize` does. The Mahalanobis solve stays in numpy, as in the
JAX package. The quality head's cache is a `.pth` file.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# MSCN / natural scene statistics (BRISQUE-analog)
# ---------------------------------------------------------------------------

_C = 1e-3  # MSCN stabiliser (images in [0, 1])

# GGD shape by moment matching: rho = E|x|^2 / (E|x|)^2 is a decreasing
# function of alpha, inverted through a dense table (float32).
_ALPHA_GRID = np.arange(0.2, 10.001, 0.001)
_G1 = np.array([math.gamma(1.0 / a) for a in _ALPHA_GRID])
_G2 = np.array([math.gamma(2.0 / a) for a in _ALPHA_GRID])
_G3 = np.array([math.gamma(3.0 / a) for a in _ALPHA_GRID])
_RHO_GGD = _G1 * _G3 / (_G2 ** 2)
_TABLES = {
    "rho_rev": _RHO_GGD[::-1].astype(np.float32),
    "alpha_rev": _ALPHA_GRID[::-1].astype(np.float32),
    "alpha": _ALPHA_GRID.astype(np.float32),
    "g1": _G1.astype(np.float32),
    "g2": _G2.astype(np.float32),
}


def _table(name: str, device) -> torch.Tensor:
    return torch.from_numpy(_TABLES[name]).to(device)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of (xp, fp) at x, constant outside
    [xp[0], xp[-1]]: jnp.interp's rule (the right-side search, and a step
    of at most float32's spacing at eps read as no step)."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.numel() - 1)
    lo_x, hi_x, lo_f, hi_f = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = hi_x - lo_x
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, lo_f, lo_f + ((x - lo_x) / torch.where(dx0, torch.ones_like(dx), dx))
                    * (hi_f - lo_f))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _gaussian_kernel(size: int = 7, sigma: float = 7.0 / 6.0, device=None) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (ax / sigma) ** 2)
    k2 = torch.outer(k, k)
    return k2 / k2.sum()


def _local_moments(gray: torch.Tensor, kernel: torch.Tensor):
    """Gaussian-weighted local mean and std of (B, H, W) images (zero
    padding, output the input's size)."""
    k = kernel[None, None]
    pad = kernel.shape[-1] // 2
    x = gray[:, None]
    mu = F.conv2d(x, k, padding=pad)[:, 0]
    mu2 = F.conv2d(x * x, k, padding=pad)[:, 0]
    return mu, torch.sqrt(torch.clamp(mu2 - mu * mu, min=0.0))


def mscn(gray: torch.Tensor, kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-subtracted contrast-normalised coefficients of (B, H, W)."""
    if kernel is None:
        kernel = _gaussian_kernel(device=gray.device)
    mu, sigma = _local_moments(gray, kernel)
    return (gray - mu) / (sigma + _C)


def _ggd_params(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, sigma^2) of a zero-mean GGD fit over `dims`."""
    e_abs = x.abs().mean(dim=dims)
    e_sq = (x * x).mean(dim=dims)
    rho = e_sq / torch.clamp(e_abs * e_abs, min=1e-12)
    alpha = interp(rho, _table("rho_rev", x.device), _table("alpha_rev", x.device))
    return alpha, e_sq


def _aggd_params(x: torch.Tensor, dims):
    """(alpha, eta, sigma_l^2, sigma_r^2) of an asymmetric GGD fit over
    `dims` (BRISQUE's estimator, Mittal et al. 2012, eqs. 5-8)."""
    neg = torch.where(x < 0, x, torch.zeros_like(x))
    pos = torch.where(x > 0, x, torch.zeros_like(x))
    n_neg = torch.clamp((x < 0).to(x.dtype).sum(dim=dims), min=1.0)
    n_pos = torch.clamp((x > 0).to(x.dtype).sum(dim=dims), min=1.0)
    sig_l = (neg * neg).sum(dim=dims) / n_neg
    sig_r = (pos * pos).sum(dim=dims) / n_pos
    gamma_hat = torch.sqrt(sig_l) / torch.sqrt(torch.clamp(sig_r, min=1e-12))
    e_abs = x.abs().mean(dim=dims)
    e_sq = (x * x).mean(dim=dims)
    rho = e_sq / torch.clamp(e_abs * e_abs, min=1e-12)
    rho_hat = rho * (gamma_hat ** 3 + 1.0) * (gamma_hat + 1.0) / \
        torch.clamp((gamma_hat ** 2 + 1.0) ** 2, min=1e-12)
    dev = x.device
    alpha = interp(rho_hat, _table("rho_rev", dev), _table("alpha_rev", dev))
    g1 = interp(alpha, _table("alpha", dev), _table("g1", dev))
    g2 = interp(alpha, _table("alpha", dev), _table("g2", dev))
    eta = (torch.sqrt(sig_r) - torch.sqrt(sig_l)) * g2 / g1
    return alpha, eta, sig_l, sig_r


def _scale_features(gray: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """18 NSS features of (B, H, W) at one scale: GGD(mscn) 2 + AGGD of
    the four orientation products 4 x 4."""
    m = mscn(gray, kernel)
    feats = list(_ggd_params(m, dims=(1, 2)))
    pairs = (m[:, :, :-1] * m[:, :, 1:],      # horizontal
             m[:, :-1, :] * m[:, 1:, :],      # vertical
             m[:, :-1, :-1] * m[:, 1:, 1:],   # main diagonal
             m[:, :-1, 1:] * m[:, 1:, :-1])   # secondary diagonal
    for p in pairs:
        feats.extend(_aggd_params(p, dims=(1, 2)))
    return torch.stack(feats, dim=-1)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) or NHWC resized to (h, w), bilinear with half-pixel
    centres, antialiased when it downsamples (jax.image.resize's
    "bilinear")."""
    maps = x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)
    down = h < maps.shape[-2] or w < maps.shape[-1]
    out = F.interpolate(maps, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=down)
    return out[:, 0] if x.dim() == 3 else out.permute(0, 2, 3, 1)


@torch.no_grad()
def nss_features(images: torch.Tensor) -> torch.Tensor:
    """(B, 36) natural-scene-statistics features of NHWC [0, 1] images:
    18 at full scale and 18 at half scale, BRISQUE's two scales."""
    images = images.float()
    gray = images @ torch.tensor([0.299, 0.587, 0.114], device=images.device)
    kernel = _gaussian_kernel(device=images.device)
    f1 = _scale_features(gray, kernel)
    half = resize_bilinear(gray, gray.shape[1] // 2, gray.shape[2] // 2)
    f2 = _scale_features(half, kernel)
    return torch.cat([f1, f2], dim=-1)


def fit_pristine(clear_images, batch_size: int = 16, device="cuda") -> Dict[str, np.ndarray]:
    """The pristine Gaussian {mu (36,), cov (36, 36)} of the NSS features
    of `clear_images`, an iterable of NHWC [0, 1] batches (numpy or
    tensors), computed on `device`."""
    rows = []
    for batch in clear_images:
        b = torch.as_tensor(np.asarray(batch, np.float32)).to(device)
        for i in range(0, b.shape[0], batch_size):
            rows.append(nss_features(b[i:i + batch_size]).cpu().numpy())
    return pristine_from_features(np.concatenate(rows, axis=0))


def pristine_from_features(feats: np.ndarray) -> Dict[str, np.ndarray]:
    """The pristine Gaussian of an already computed (N, 36) feature
    matrix."""
    return {"mu": feats.mean(axis=0), "cov": np.cov(feats, rowvar=False)}


def mahalanobis_scores(feats: np.ndarray, pristine: Dict[str, np.ndarray]) -> np.ndarray:
    """NIQE-style distance of (N, 36) features from the pristine Gaussian
    (covariance regularised by 1e-6 of its mean diagonal; lower = more
    natural), in numpy."""
    mu = pristine["mu"]
    cov = np.asarray(pristine["cov"])
    cov = cov + np.eye(cov.shape[0]) * (1e-6 * np.trace(cov) / cov.shape[0])
    d = feats - mu[None, :]
    sol = np.linalg.solve(cov, d.T).T
    return np.sqrt(np.maximum(np.sum(d * sol, axis=1), 0.0))


def brisque_proxy_scores(images: torch.Tensor, pristine: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-image naturalness distance (lower = more natural)."""
    return mahalanobis_scores(nss_features(torch.as_tensor(images)).cpu().numpy(), pristine)


def save_pristine(path: str, model: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **model)


def load_pristine(path: str) -> Optional[Dict[str, np.ndarray]]:
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return {"mu": z["mu"], "cov": z["cov"]}


# ---------------------------------------------------------------------------
# Learned quality head (NIMA-analog)
# ---------------------------------------------------------------------------


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's SAME padding (low, high) along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class QualityHead(nn.Module):
    """A NIMA-shaped scorer: four 3x3 stride-2 convs (features x 1, 2, 4,
    8) with tanh-approximated GELU, a global mean, a linear layer to 10
    bins. NHWC [0, 1] images in, (N, 10) logits out."""

    def __init__(self, features: int = 24):
        super().__init__()
        chans = [3] + [features * 2 ** i for i in range(4)]
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2)
                                   for i in range(4))
        self.dense = nn.Linear(chans[-1], 10)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            (t, b), (lft, r) = _same_pad(x.shape[-2], 3, 2), _same_pad(x.shape[-1], 3, 2)
            x = F.gelu(conv(F.pad(x, (lft, r, t, b))), approximate="tanh")
        return self.dense(x.mean(dim=(2, 3)))

    @staticmethod
    def mos(logits: torch.Tensor) -> torch.Tensor:
        """The distribution's mean on the 1-10 scale."""
        p = torch.softmax(logits, dim=-1)
        return (p * torch.arange(1, 11, dtype=p.dtype, device=p.device)).sum(dim=-1)


def _distort_batch(clear: torch.Tensor, generator: Optional[torch.Generator] = None,
                   a: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
    """(images, target MOS) training pairs from one NHWC clear batch:
    identity, fog at beta 0.3 / 0.6 / 0.9 (one airlight draw `a` per image
    in [0.6, 0.95) for all three), a 4x4 box blur (zero padding, SAME),
    Gaussian noise of std 0.1 (`noise`, standard normal draws). The draws
    come from `generator` unless given. Targets: SSIM to clear mapped
    affinely to MOS (1.0 -> 9.5, 0.2 -> 2.0), clipped to [1, 10]."""
    from adam_dehaze_tpu_torch.data.synthetic import apply_fog
    from adam_dehaze_tpu_torch.ops.image import ssim_gray

    n = clear.shape[0]
    dev = clear.device
    if a is None:
        a = 0.6 + 0.35 * torch.rand(n, generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(clear.shape, generator=generator, device=dev)
    variants = [clear]
    for beta in (0.3, 0.6, 0.9):
        variants.append(apply_fog(clear, torch.full((n,), beta, device=dev), a))
    padded = F.pad(clear.permute(0, 3, 1, 2), (1, 2, 1, 2))
    variants.append(F.avg_pool2d(padded, 4, stride=1).permute(0, 2, 3, 1))
    variants.append(torch.clamp(clear + 0.1 * noise, 0.0, 1.0))
    imgs = torch.cat(variants, dim=0)
    ref = torch.cat([clear] * len(variants), dim=0)
    mos = torch.clamp(2.0 + (ssim_gray(imgs, ref) - 0.2) * (9.5 - 2.0) / 0.8, 1.0, 10.0)
    return imgs, mos


def quality_loss(model: QualityHead, imgs: torch.Tensor, mos: torch.Tensor):
    """(soft cross-entropy, MOS mean absolute error): the target is a
    discretised Gaussian of 0.7 bins around the target MOS."""
    bins = torch.arange(1, 11, dtype=torch.float32, device=imgs.device)
    logits = model(imgs)
    target = torch.softmax(-((bins[None, :] - mos[:, None]) ** 2) / (2 * 0.7 ** 2), dim=-1)
    ce = -(target * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    return ce.mean(), (QualityHead.mos(logits) - mos).abs().mean()


def train_quality_head(config, steps: int = 300, lr: float = 1e-3, img_size: int = 128,
                       seed: int = 0, log_every: int = 50, device="cuda") -> QualityHead:
    """Train the NIMA-analog head on the train split's clear frames and
    their synthetic distortions: Adam (lr, eps 1e-8), one batch a step,
    the draws from a generator seeded with `seed` on `device`. Returns the
    head in eval mode."""
    from adam_dehaze_tpu_torch.data.dataset import get_dataloader
    from adam_dehaze_tpu_torch.nn.blocks import init_params_

    device = torch.device(device)
    model = init_params_(QualityHead(), torch.Generator().manual_seed(seed)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    gen = torch.Generator(device).manual_seed(seed)
    loader = get_dataloader(config, "train")
    done = 0
    while done < steps:
        for batch in loader:
            if done >= steps:
                break
            clear = torch.from_numpy(batch["clear"]).to(device)
            if clear.shape[1] != img_size:
                clear = resize_bilinear(clear, img_size, img_size)
            imgs, mos = _distort_batch(clear, gen)
            loss, mae = quality_loss(model, imgs, mos)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            done += 1
            if log_every and done % log_every == 0:
                print(f"  quality head step {done}/{steps}: ce {float(loss):.4f} "
                      f"mae {float(mae):.3f}")
    return model.eval()


def save_quality_head(path: str, model: QualityHead) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(model.state_dict(), path)


def load_quality_head(path: str, device="cuda") -> Optional[QualityHead]:
    """The head saved at `path` in eval mode on `device`, or None when it
    was never trained."""
    if not os.path.exists(path):
        return None
    model = QualityHead()
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model.to(device).eval()


@torch.no_grad()
def nima_proxy_scores(images: torch.Tensor, model: QualityHead,
                      img_size: int = 128) -> np.ndarray:
    """Per-image MOS on the 1-10 proxy scale (higher = better)."""
    x = torch.as_tensor(images).float()
    if x.shape[1] != img_size:
        x = resize_bilinear(x, img_size, img_size)
    return QualityHead.mos(model(x)).cpu().numpy()
