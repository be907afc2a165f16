"""Multi-process support: process groups, per-host loading and metric means.

Counterpart of adam_dehaze_tpu/parallel/multihost.py, on torch.distributed:

- `initialize` starts the process group (`jax.distributed.initialize`
  there); one process stays without a group, as in the JAX package;
- `host_data_slice`, `HostShardedDataset` and `shard_loader_for_host` give
  each process its own part of the data, with the JAX package's arithmetic
  and seeds;
- `all_hosts_mean(_tree)` average host-local metrics across processes with
  one `all_reduce` (`process_allgather` and `np.mean` there).

One process drives one device. The backend is NCCL for a CUDA device and
gloo only when the caller asks for the CPU: a failed rendezvous or
collective raises, never falling back to one process or another backend.
`process_index` and `process_count` are the group's rank and size (0 and 1
without a group); the tests patch them where the JAX tests patch
`jax.process_index` and `jax.process_count`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the default group, 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """Processes of the default group, 1 without a group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def group_device() -> torch.device:
    """The device a collective of the default group reduces on: this
    process's CUDA device under NCCL, the CPU under gloo (and without a
    group)."""
    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> Dict[str, int]:
    """Join the process group of `num_processes` processes at
    `coordinator_address` ("host:port") as rank `process_id`; nothing for a
    single process. Returns {process_index, process_count, local_devices,
    global_devices}.

    `device` is the device this process drives: a CUDA device takes the
    NCCL backend and is bound (`torch.cuda.set_device`) before the first
    collective; the CPU takes gloo. With one device per process, `local_devices` is 1 and
    `global_devices` the number of processes. Without a group they count
    the devices this process can drive: the CUDA devices it sees for a
    CUDA `device`, 1 for the CPU."""
    device = torch.device(device)
    if num_processes and num_processes > 1:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
        return {"process_index": process_index(), "process_count": process_count(),
                "local_devices": 1, "global_devices": process_count()}
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    return {"process_index": 0, "process_count": 1, "local_devices": local,
            "global_devices": local}


def host_data_slice(global_batch: int) -> slice:
    """The contiguous slice of a global batch this process loads."""
    per_host = global_batch // process_count()
    start = process_index() * per_host
    return slice(start, start + per_host)


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, values):
    """`tree` with its leaves replaced, in order, from the iterator `values`."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def all_hosts_mean_tree(tree):
    """Average a tree (dicts, lists, tuples) of host-local scalar metrics
    across processes: one all_reduce of every leaf stacked in float64, on
    the group's device, divided by the number of processes. In one process
    the identity, with `float` applied to each leaf."""
    leaves = [float(v) for v in _leaves(tree)]
    if process_count() > 1:
        stacked = torch.tensor(leaves, dtype=torch.float64, device=group_device())
        dist.all_reduce(stacked)
        leaves = (stacked / process_count()).tolist()
    return _rebuild(tree, iter(leaves))


def all_hosts_mean(value: float) -> float:
    """Average a host-local scalar metric across processes; `float(value)`
    in one process."""
    return all_hosts_mean_tree([value])[0]


def process_zero_value(value: float) -> float:
    """Process 0's `value` on every process (a broadcast over the group);
    `float(value)` in one process. A decision that every process must take
    alike, such as whether a validation is the best yet (save_checkpoint is
    collective), is taken on this value: in one process it is the process's
    own, as in the JAX package."""
    if process_count() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=group_device())
    dist.broadcast(t, src=0)
    return float(t[0])


class HostShardedDataset:
    """View of a dataset restricted to this process's strided shard, so no
    process reads the whole corpus. Strided (not contiguous) so every
    process sees every intensity class even in class-grouped listings.
    Composes with any dataset exposing __len__/load (HazyImageDataset,
    DetectionDataset)."""

    def __init__(self, base, index: Optional[int] = None, count: Optional[int] = None):
        self.base = base
        self.index = process_index() if index is None else index
        self.count = process_count() if count is None else count
        self.indices = list(range(self.index, len(base), self.count))

    def __len__(self):
        return len(self.indices)

    def load(self, idx: int):
        return self.base.load(self.indices[idx])


def shard_loader_for_host(loader):
    """Rewrap a DataLoader's dataset with this process's shard (the
    identity for a single process). The loader keeps its batch size: each
    process contributes `batch` samples to a global batch of
    `batch * process_count`."""
    if process_count() == 1:
        return loader
    from adam_dehaze_tpu_torch.data.dataset import DataLoader
    ds = HostShardedDataset(loader.dataset)
    # Derive the per-host seed from the loader's configured seed so the
    # multi-host shuffle order stays reproducible from config['seed'].
    base_seed = getattr(loader, "seed", 0) or 0
    return DataLoader(ds, batch_size=loader.batch_size,
                      shuffle=loader.shuffle, num_workers=loader.num_workers,
                      drop_remainder=loader.drop_remainder,
                      seed=base_seed + 1000 * process_index())
