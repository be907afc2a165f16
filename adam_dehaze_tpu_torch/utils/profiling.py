"""Tracing, timing and debug utilities of the port.

Counterpart of adam_dehaze_tpu/utils/profiling.py:
- `trace(log_dir)`: a torch.profiler trace of the enclosed block (CPU and,
  with a card, CUDA activity), written as a Chrome trace into `log_dir`;
- `benchmark(fn, *args)`: host clock around calls, with a synchronize
  before each read of the clock;
- `enable_debug_checks()`: autograd's anomaly detection (NaN/inf in a
  backward pass) and CUDA's sync debug mode;
- `model_flops`: FLOPs of one call, counted by FlopCounterMode;
- `device_flops_estimate`: the card's published dense bf16 peak.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch

# Published dense bf16 tensor-core peak of the cards the port knows, by a
# part of the name torch.cuda.get_device_name gives: the H100 SXM's data
# sheet, at its full 700 W power limit.
_BF16_PEAK = {"H100": 989e12}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; the Chrome trace lands in
    `log_dir/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, n_warmup: int = 5, n_iters: int = 20,
              batch_dim: int = 0) -> Dict[str, float]:
    """Seconds per call of `fn(*args)` and items per second (items: the
    first argument's size along `batch_dim`)."""
    for _ in range(n_warmup):
        fn(*args)
    _sync()
    start = time.perf_counter()
    for _ in range(n_iters):
        fn(*args)
    _sync()
    per_call = (time.perf_counter() - start) / n_iters
    items = args[0].shape[batch_dim] if args and hasattr(args[0], "shape") else 1
    return {"sec_per_call": per_call, "ms_per_item": per_call / items * 1000.0,
            "items_per_sec": items / per_call}


def enable_debug_checks(nans: bool = True, sync: str = "warn"):
    """Anomaly detection in autograd (a NaN or inf from a backward op
    raises) and CUDA's sync debug mode ("warn" or "error" on a
    synchronizing call; "default" turns it off)."""
    torch.autograd.set_detect_anomaly(nans)
    if torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode(sync)


def model_flops(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call of `fn(*args)` (FlopCounterMode: matmuls and
    convolutions, 2 per multiply-add); None when it counts none."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops()) or None


def device_flops_estimate(device=None) -> float:
    """The card's published dense bf16 peak in FLOP/s; raises for a card
    the table does not hold, or without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_flops_estimate: no CUDA card")
    name = torch.cuda.get_device_name(device)
    for part, peak in _BF16_PEAK.items():
        if part in name:
            return peak
    raise ValueError(f"device_flops_estimate: no peak known for {name!r}")
