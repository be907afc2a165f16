"""Utility helpers of the port: seeding, timing, model introspection.

Counterpart of adam_dehaze_tpu/utils/helpers.py. Parameter counts and
sizes read a module's parameters (and, for the size, its buffers), where
the JAX package reads a params tree; times are CUDA events on a CUDA
device and the host clock only when the caller asked for the CPU.
"""
from __future__ import annotations

import os
import random
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python's, numpy's and torch's global generators; returns a
    torch.Generator seeded with `seed` (the JAX package returns its root
    PRNG key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)


def count_params(module: torch.nn.Module) -> int:
    """Total number of parameter scalars of `module`."""
    return sum(p.numel() for p in module.parameters())


def calculate_model_size(module: torch.nn.Module) -> float:
    """Size of the parameters in MB (the BN statistics left out, as the
    JAX package's params tree leaves them out)."""
    return sum(p.numel() * p.element_size() for p in module.parameters()) / 1024 ** 2


def model_info(module: torch.nn.Module) -> Dict[str, Any]:
    """Model type, parameter counts and size, and the width attributes
    the module has."""
    info = {
        "model_type": type(module).__name__,
        "params": count_params(module),
        "trainable_params": sum(p.numel() for p in module.parameters() if p.requires_grad),
        "size_mb": calculate_model_size(module),
    }
    for attr in ("base_channels", "n_blocks", "model_name", "num_classes"):
        if hasattr(module, attr):
            info[attr] = getattr(module, attr)
    return info


def calculate_inference_time(fn, *args, n_warmup: int = 10, n_samples: int = 100,
                             device="cuda") -> float:
    """Mean seconds per call of `fn(*args)`: CUDA events around the
    `n_samples` calls on a CUDA device, the host clock only on the CPU."""
    device = torch.device(device)
    for _ in range(n_warmup):
        fn(*args)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(n_samples):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n_samples
    t0 = time.perf_counter()
    for _ in range(n_samples):
        fn(*args)
    return (time.perf_counter() - t0) / n_samples


def get_device_memory_usage() -> Optional[Dict[str, Dict[str, float]]]:
    """Per CUDA device, the allocator's bytes in use and its peak, in MB
    (torch.cuda.memory_stats), and the card's total; None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "allocated_mb": s.get("allocated_bytes.all.current", 0) / 1024 ** 2,
            "peak_mb": s.get("allocated_bytes.all.peak", 0) / 1024 ** 2,
            "limit_mb": torch.cuda.get_device_properties(i).total_memory / 1024 ** 2,
        }
    return stats


def to_nhwc(x: np.ndarray) -> np.ndarray:
    """A NCHW/CHW array as NHWC/HWC."""
    if x.ndim == 4:
        return np.transpose(x, (0, 2, 3, 1))
    if x.ndim == 3 and x.shape[0] in (1, 3):
        return np.transpose(x, (1, 2, 0))
    return x


def module_cast(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast the floating parameters and buffers of `module` to `dtype`, in
    place (the JAX package's tree_cast); returns it."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return module
