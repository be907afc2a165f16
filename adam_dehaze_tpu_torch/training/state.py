"""Train state, optimiser construction, and plateau LR scheduling.

Counterpart of adam_dehaze_tpu/training/state.py. The optimiser is
torch.optim.Adam: weight decay is added to the gradient before the moments,
which is the JAX package's `add_decayed_weights` -> `adam` chain (and the
reference trainer's torch Adam). The plateau scheduler is the JAX
package's own rule (mode min, relative eps 1e-4, a reduction once more
than `patience` epochs failed to improve), not torch's scheduler; it
lowers the learning rate in the optimiser's param_groups, keeping Adam's
moments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch


@dataclass
class TrainState:
    """The module being trained, its optimiser, and the step count."""
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with L2-in-gradient weight decay (torch-Adam semantics)."""
    return torch.optim.Adam(params, lr=learning_rate, weight_decay=weight_decay)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = lr


class ReduceLROnPlateau:
    """Host-side plateau scheduler (mode min or max, factor, patience;
    relative eps 1e-4, no cooldown)."""

    def __init__(self, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 0.0, mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.best: Optional[float] = None
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - 1e-4)
        return metric > self.best * (1 + 1e-4)

    def step(self, metric: float, optimizer: torch.optim.Optimizer) -> bool:
        """Record one epoch's metric; returns whether the rate was lowered."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
            return False
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            set_learning_rate(optimizer, max(get_learning_rate(optimizer) * self.factor,
                                             self.min_lr))
            return True
        return False
