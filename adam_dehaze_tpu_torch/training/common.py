"""Shared trainer plumbing: state (de)serialisation and batch transfer.

Counterpart of adam_dehaze_tpu/training/common.py. A train state becomes a
plain dict of state dicts for `save_checkpoint`; host batches (numpy)
become device tensors, through pinned memory and non-blocking copies on a
CUDA device, so the next batch's upload overlaps the current step.
"""
from __future__ import annotations

import collections
from typing import Any, Dict

import numpy as np
import torch

from adam_dehaze_tpu_torch.training.state import TrainState


def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """TrainState -> {"step", "model", "optimizer"} for save_checkpoint."""
    return {"step": state.step, "model": state.module.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def tree_to_state(state: TrainState, tree: Dict[str, Any]) -> TrainState:
    """Load a saved tree into `state`'s module and optimiser, in place;
    returns the state."""
    state.module.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    return state


def autocast(device: torch.device, dtype: torch.dtype):
    """Autocast to the compute dtype on `device`; off for float32."""
    return torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32)


def device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The array fields of a host batch as tensors on `device` (non-array
    fields, the names, are dropped). On a CUDA device the copies go
    through pinned memory and do not block the host."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)
    return out


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid rows of a padded batch."""
    m = mask.to(values.dtype)
    return (values * m).sum() / m.sum().clamp_min(1.0)


def device_prefetch(loader, device, depth: int = 2):
    """Iterate a host DataLoader with `depth` device batches in flight."""
    pending = collections.deque()
    it = iter(loader)
    for batch in it:
        pending.append(device_batch(batch, device))
        if len(pending) >= depth:
            break
    while pending:
        batch = pending.popleft()
        nxt = next(it, None)
        if nxt is not None:
            pending.append(device_batch(nxt, device))
        yield batch
