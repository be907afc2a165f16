"""The device mesh and the sharding of batches over it.

Counterpart of adam_dehaze_tpu/parallel/mesh.py. Axes:

- `data`    — batch dimension (data parallelism: the data-parallel step
              averages gradients over this axis's process group);
- `spatial` — image H dimension (spatial partitioning: the halo
              exchanges of spatial.py);
- `model`   — channel parallelism of the widest stages (sharding.py).

One process drives one device, so a mesh spans the processes of the group:
under a torch.distributed group its shape multiplies to the world size,
and it holds a `DeviceMesh` with one process group per axis. In one
process without a group the mesh is the shape over `devices` alone, with no
process group: every collective over it is the identity.

`cuda.mesh.data: 0` in the config means "all remaining devices".
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from adam_dehaze_tpu_torch.parallel.multihost import group_device, process_count, process_index

AXES = ("data", "spatial", "model")


def mesh_shape(sizes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """{axis: size} over `n` devices by the JAX package's rules: missing
    axes are 1, but `data`, which is 0; at most one axis may be 0 ("all
    remaining devices"); the sizes must multiply to `n`."""
    sizes = dict(sizes or {})
    for ax in AXES:
        sizes.setdefault(ax, 1 if ax != "data" else 0)
    fixed = math.prod(s for s in sizes.values() if s > 0)
    free_axes = [ax for ax, s in sizes.items() if s == 0]
    if len(free_axes) > 1:
        raise ValueError("At most one mesh axis may be 0 (auto)")
    if free_axes:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {sizes}")
        sizes[free_axes[0]] = n // fixed
    total = math.prod(sizes[ax] for ax in AXES)
    if total != n:
        raise ValueError(f"Mesh {sizes} needs {total} devices, have {n}")
    return {ax: sizes[ax] for ax in AXES}


class Axis(NamedTuple):
    """One mesh axis as this process sees it: its process group, this
    process's index along it and the axis's size."""
    name: str
    group: object
    index: int
    size: int


class Mesh:
    """A mesh over the group's processes: `shape` {axis: size} as JAX's
    `Mesh.shape`; `device` the device this process drives; `device_mesh`
    the torch DeviceMesh (None without a group)."""

    axis_names = AXES

    def __init__(self, shape: Dict[str, int], device: torch.device, device_mesh=None):
        self.shape = shape
        self.device = device
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group along `axis` that holds this process; None
        without a group."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This process's index along `axis`."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    def axis(self, name: str) -> Optional[Axis]:
        """`name` as an `Axis`; None when the mesh lacks it or it has size
        1. An axis of more than one needs a process group."""
        size = self.shape.get(name, 1)
        if size <= 1:
            return None
        if self.device_mesh is None:
            raise ValueError(f"a {name} axis of {size} needs a process group "
                             "(parallel/multihost.py:initialize)")
        return Axis(name, self.group(name), self.coordinate(name), size)


def make_mesh(sizes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh with the requested axis sizes (one axis may be 0 =
    "all remaining devices"; by default pure data parallelism).

    Under a process group: over its processes, `devices` (when given) one
    per rank, this process driving `devices[rank]`; by default the group's
    device (this process's CUDA device under NCCL, the CPU under gloo).
    Without a group: over `devices`, by default the current CUDA device."""
    if dist.is_available() and dist.is_initialized():
        n = process_count()
        if devices is not None and len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a group of {n} processes")
        device = torch.device(devices[process_index()]) if devices else group_device()
        shape = mesh_shape(sizes, n)
        from torch.distributed.device_mesh import DeviceMesh
        mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        layout = torch.arange(n).reshape([shape[ax] for ax in AXES])
        return Mesh(shape, device, DeviceMesh(mesh_type, layout, mesh_dim_names=AXES))
    devices = [torch.device(d) for d in (devices if devices is not None else ["cuda"])]
    return Mesh(mesh_shape(sizes, len(devices)), devices[0])


def mesh_from_config(config, devices=None) -> Mesh:
    """The mesh of the config's `cuda.mesh`."""
    return make_mesh(config.get("cuda", {}).get("mesh"), devices)


def batch_spec() -> Tuple:
    """The mesh axis of each dimension of an image batch: batch over data,
    H over spatial. The port's batches and routers hold images as NHWC, as
    the JAX package's do (its modules compute in NCHW channels_last
    inside), so the spec is the JAX one: (N, H, W, C)."""
    return ("data", "spatial", None, None)


class NamedSharding(NamedTuple):
    """A spec over a mesh: `spec[i]` names the axis that splits dimension
    i of a tensor (None: not split)."""
    mesh: Mesh
    spec: Tuple

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This process's part of the whole tensor `t`, on its device."""
        for dim, axis in enumerate(self.spec):
            n = self.mesh.shape[axis] if axis else 1
            if n > 1:
                if t.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split "
                                     f"into {n} along {axis!r}")
                size = t.shape[dim] // n
                t = t.narrow(dim, self.mesh.coordinate(axis) * size, size)
        return t.to(self.mesh.device)


def batch_sharding(mesh: Mesh) -> Dict[str, NamedSharding]:
    return {
        "images": NamedSharding(mesh, batch_spec()),
        "labels": NamedSharding(mesh, ("data",)),
        "replicated": NamedSharding(mesh, ()),
    }


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This process's part of a whole host batch, on its device: images
    (4-d) by `batch_spec`, other arrays by their rows on `data`; scalars
    and non-array fields as they are."""
    sh = batch_sharding(mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor) and v.dim() == 4:
            out[k] = sh["images"].local(v)
        elif isinstance(v, torch.Tensor) and v.dim() >= 1:
            out[k] = sh["labels"].local(v)
        else:
            out[k] = v
    return out


def _tensors(tree):
    """The tensors of a module, an optimizer, a train state (`module`,
    `optimizer`) or a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, torch.optim.Optimizer):
        return _tensors(list(tree.state.values()))
    if hasattr(tree, "module") and hasattr(tree, "optimizer"):
        return _tensors(tree.module) + _tensors(tree.optimizer)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(mesh: Mesh, tree):
    """Give every process rank 0's values of every tensor of `tree` (a
    module, an optimizer, a train state or a tree of tensors), in place, by
    a broadcast over the group; returns `tree`. The identity without a
    group. NCCL broadcasts CUDA tensors only: a CPU tensor goes through the
    group's device."""
    if mesh.device_mesh is None:
        return tree
    staging = group_device()
    for t in _tensors(tree):
        if staging.type == "cuda" and not t.is_cuda:
            on_device = t.to(staging)
            dist.broadcast(on_device, src=0)
            t.copy_(on_device)
        else:
            dist.broadcast(t, src=0)
    return tree
