"""On-device batched augmentation of the port.

Counterpart of adam_dehaze_tpu/data/augment.py: per-sample flip bits and
brightness/contrast factors are drawn once and applied identically to the
hazy, clear and dehazed images of a triplet, inside the train step. The
draws come from an explicit `torch.Generator` on the batch's device
(they differ from jax.random's; the tests hold `_flip` and
`_color_jitter` against the JAX package at given parameters). Inside a
data-parallel step they are drawn for the global batch
(parallel/data_parallel.py:draw_rows). On an H shard (parallel/spatial.py)
the vertical flip takes the mirrored shard's rows (`flip_h`) and the
contrast's gray mean is the whole image's (`image_mean`).
"""
from __future__ import annotations

from typing import Dict

import torch

from adam_dehaze_tpu_torch.parallel import spatial
from adam_dehaze_tpu_torch.parallel.data_parallel import rand_rows

_GRAY = (0.299, 0.587, 0.114)


def _flip(imgs: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor) -> torch.Tensor:
    """imgs: (N, H, W, C); hflip/vflip: (N,) bool."""
    imgs = torch.where(hflip[:, None, None, None], imgs.flip(2), imgs)
    return torch.where(vflip[:, None, None, None], spatial.flip_h(imgs), imgs)


def _color_jitter(imgs: torch.Tensor, brightness: torch.Tensor,
                  contrast: torch.Tensor) -> torch.Tensor:
    """Per-sample brightness/contrast factors, torch ColorJitter semantics
    (multiplicative brightness; contrast blends with the mean gray level)."""
    imgs = imgs * brightness[:, None, None, None]
    gray = imgs @ torch.tensor(_GRAY, dtype=imgs.dtype, device=imgs.device)
    gray_mean = spatial.image_mean(gray, (1, 2))[:, None, None, None]
    c = contrast[:, None, None, None]
    return ((imgs - gray_mean) * c + gray_mean).clamp(0.0, 1.0)


def augment_triplet(generator: torch.Generator, batch: Dict[str, torch.Tensor],
                    brightness: float = 0.1, contrast: float = 0.1
                    ) -> Dict[str, torch.Tensor]:
    """Augment {hazy, clear, dehazed} identically per sample."""
    n = batch["hazy"].shape[0]
    dev = batch["hazy"].device

    def uniform(lo, hi):
        return lo + (hi - lo) * rand_rows(n, generator, dev)

    hflip = rand_rows(n, generator, dev) < 0.5
    vflip = rand_rows(n, generator, dev) < 0.5
    bf = uniform(1 - brightness, 1 + brightness)
    cf = uniform(1 - contrast, 1 + contrast)
    out = dict(batch)
    for name in ("hazy", "clear", "dehazed"):
        if name in batch:
            out[name] = _color_jitter(_flip(batch[name], hflip, vflip), bf, cf)
    return out
