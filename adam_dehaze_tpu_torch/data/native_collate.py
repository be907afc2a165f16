"""The u8 -> float32 normalise stage of the data pipeline.

Counterpart of adam_dehaze_tpu/data/native_collate.py, numpy path only:
dst = u8 * scale[c] + shift[c] through a float32 lookup table of the 256
byte values, the same numerics as the JAX package's native pass
(native/collate.cpp) and its numpy fallback.
"""
from __future__ import annotations

import numpy as np


def normalize_u8(images: np.ndarray, mean=None, std=None) -> np.ndarray:
    """uint8 (..., H, W, C) -> float32 ((x/255) - mean) / std.

    mean/std: per-channel (default: plain [0, 1] conversion)."""
    if images.dtype != np.uint8:
        raise ValueError(f"normalize_u8 takes uint8 images, got {images.dtype}")
    c = images.shape[-1]
    mean = np.zeros(c, np.float32) if mean is None else np.asarray(mean, np.float32)
    std = np.ones(c, np.float32) if std is None else np.asarray(std, np.float32)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    shift = (-mean / std).astype(np.float32)
    lut = (np.arange(256, dtype=np.float32)[None, :] * scale[:, None]
           + shift[:, None])  # (C, 256)
    out = np.empty(images.shape, np.float32)
    for ch in range(c):
        out[..., ch] = lut[ch][images[..., ch]]
    return out
