"""The u8 -> float32 normalise stage of the data pipeline.

Counterpart of adam_dehaze_tpu/data/native_collate.py: dst = u8 * scale[c]
+ shift[c] through a float32 lookup table of the 256 byte values, in one
multithreaded native pass (native/collate.cpp through ctypes) or in numpy.
The native library is compiled with g++ on first use into
build/native/<hash>/ at the repository root (listed in .gitignore), keyed
by the source and flags, as the COCO matcher is (evaluation/coco_eval.py).
Where the JAX module falls back to numpy, this one does too: when the
library does not build or load, and for input of fewer than three
dimensions. Both passes give the same bits.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
NATIVE_SOURCE = _REPO / "native" / "collate.cpp"
BUILD_ROOT = _REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread")


@functools.lru_cache(maxsize=1)
def native_library() -> Optional[ctypes.CDLL]:
    """The native pass, compiled on first use (once per source hash and
    flags); None when it does not build or load, as in the JAX module."""
    src = NATIVE_SOURCE.read_bytes()
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src).hexdigest()[:16]
    lib_path = BUILD_ROOT / digest / "libcollate.so"
    try:
        if not lib_path.exists():
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.parent / f".libcollate.{os.getpid()}.tmp"
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, subprocess.SubprocessError):
        return None
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.normalize_u8_batch.argtypes = [ctypes.POINTER(ctypes.c_uint8), f32, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int32, f32, f32, ctypes.c_int32]
    lib.normalize_u8_batch.restype = None
    return lib


def normalize_u8(images: np.ndarray, mean=None, std=None, n_threads: int = 4) -> np.ndarray:
    """uint8 (..., H, W, C) -> float32 ((x/255) - mean) / std.

    mean/std: per-channel (default: plain [0, 1] conversion). The native
    pass with `n_threads` threads when the library builds, else numpy."""
    if images.dtype != np.uint8:
        raise ValueError(f"normalize_u8 takes uint8 images, got {images.dtype}")
    c = images.shape[-1]
    mean = np.zeros(c, np.float32) if mean is None else np.asarray(mean, np.float32)
    std = np.ones(c, np.float32) if std is None else np.asarray(std, np.float32)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    shift = (-mean / std).astype(np.float32)
    flat = np.ascontiguousarray(images)
    lib = native_library() if flat.ndim >= 3 else None
    if lib is not None:
        f32 = ctypes.POINTER(ctypes.c_float)
        dst = np.empty(flat.shape, np.float32)
        lib.normalize_u8_batch(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dst.ctypes.data_as(f32),
            int(np.prod(flat.shape[:-3], dtype=np.int64)), int(np.prod(flat.shape[-3:-1])), c,
            scale.ctypes.data_as(f32), shift.ctypes.data_as(f32), n_threads)
        return dst
    return normalize_u8_numpy(flat, scale, shift)


def normalize_u8_numpy(images: np.ndarray, scale: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """The numpy pass: the same float32 table of the 256 byte values."""
    lut = (np.arange(256, dtype=np.float32)[None, :] * scale[:, None]
           + shift[:, None])  # (C, 256)
    out = np.empty(images.shape, np.float32)
    for ch in range(images.shape[-1]):
        out[..., ch] = lut[ch][images[..., ch]]
    return out
