"""Expert parallelism for the three dehazing branches.

Counterpart of adam_dehaze_tpu/parallel/expert_parallel.py. The router and
its three branches are a 3-expert mixture whose experts differ in width and
depth, so each branch goes to its own group of devices instead of being
sharded along an expert axis. The host enqueues the low, medium and high
branches back to back (CUDA launches return at once), the groups compute
concurrently, and the blend gathers the results on group 0's first device.

One process drives every device here: the groups are lists of devices, as
the JAX version's submeshes are, and no process group is involved.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import torch

from adam_dehaze_tpu_torch.ops.kernels.blend import blend3

INTENSITY_ORDER = ("low", "medium", "high")


def split_devices(devices: Optional[Sequence] = None, n_groups: int = 3) -> List[List]:
    """Partition devices into n contiguous groups (sizes as equal as
    possible); with fewer devices than groups, the groups share devices
    round-robin. `devices` defaults to every visible CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("no device to split: no CUDA device is visible")
    if len(devices) < n_groups:
        # Fewer devices than experts: experts share devices round-robin.
        return [[devices[i % len(devices)]] for i in range(n_groups)]
    sizes = [len(devices) // n_groups] * n_groups
    for i in range(len(devices) % n_groups):
        sizes[i] += 1
    out, pos = [], 0
    for s in sizes:
        out.append(devices[pos:pos + s])
        pos += s
    return out


class ExpertParallelRouter:
    """Soft routing with each branch on its own group of devices.

    Args:
      branch_modules: {level: branch module}; each device of the level's
        group gets an eval-mode copy.
      classifier_apply: x -> (logits, features), run on group 0's first
        device (the caller places its weights there).
      temperature: soft-routing temperature.
      devices: the devices to split (default: every visible CUDA device;
        the CPU only when it is passed).
    """

    def __init__(self, branch_modules: Dict[str, torch.nn.Module],
                 classifier_apply: Callable, temperature: float = 0.5,
                 devices: Optional[Sequence] = None):
        self.temperature = temperature
        groups = split_devices(devices, len(INTENSITY_ORDER))
        self.groups = {level: [torch.device(d) for d in group]
                       for level, group in zip(INTENSITY_ORDER, groups)}
        self.replicas = {level: [copy.deepcopy(branch_modules[level]).eval().to(d)
                                 for d in self.groups[level]]
                         for level in INTENSITY_ORDER}
        self._cls = classifier_apply
        self.home = self.groups[INTENSITY_ORDER[0]][0]

    def _run_branch(self, level: str, x: torch.Tensor) -> torch.Tensor:
        """The level's branch on its group: the batch split over the
        group's devices when it divides, else whole on the first; the
        result on the group's first device."""
        group, replicas = self.groups[level], self.replicas[level]
        if x.shape[0] % len(group):
            return replicas[0](x.to(group[0], non_blocking=True))
        shards = torch.split(x, x.shape[0] // len(group))
        outs = [m(s.to(d, non_blocking=True)) for m, s, d in zip(replicas, shards, group)]
        return torch.cat([o.to(group[0], non_blocking=True) for o in outs])

    @torch.no_grad()
    def __call__(self, x: torch.Tensor):
        """Soft-routed dehaze: (N, H, W, 3) -> (dehazed on group 0's first
        device, info)."""
        logits, _ = self._cls(x.to(self.home, non_blocking=True))
        weights = torch.softmax(logits / self.temperature, dim=1)
        # Enqueue all three branches; their groups compute concurrently.
        outs = {level: self._run_branch(level, x) for level in INTENSITY_ORDER}
        ys = [outs[level].to(self.home, non_blocking=True) for level in INTENSITY_ORDER]
        return blend3(weights, *ys), {"weights": weights, "individual_outputs": outs}
