"""Spatially-sharded inference for large images: H split over the mesh's
`spatial` axis.

Counterpart of adam_dehaze_tpu/parallel/spatial.py, where XLA's sharding
propagation inserts the halo exchanges. Here they are written out, and the
model code stays mesh-agnostic: `spatial_sharding(mesh)` names the axis, and
while it is open each process's tensors hold its rows of every image.

- Convolutions, transposed convolutions and max-pools take the rows they
  read across the shard's edges from the neighbouring shards
  (parallel/sharded_ops.py intercepts them; collectives.Halo exchanges the
  rows). At the image's true edges the halo is the unsharded padding: zeros,
  -inf for a max-pool. A shard's height must divide by every stride on the
  path; other heights are refused.
- The global reductions over H·W that the port's layers take go through
  `mean_hw` and `amax_hw`: a sum (a max) over the spatial group, so that
  every process of a spatial group sees the same channel gates and logits.
- Kernel K2 (ops/kernels/cbam.py:channel_spatial_gate_sharded) fills the
  halo rows of its statistics maps between its two launches; kernel K1
  (ops/kernels/lightweight_chain.py) runs on a shard made taller by the
  branch's receptive radius and crops the result.
- Ops whose rows mix across H in another way (resizes, pads of H, adaptive
  pools) and the tuned serving kernels (K3, K4, K6, K2' alone, int8's Q1
  and Q2) raise under the context.

`make_spatial_infer` wraps an apply (a bound model, or a route such as
`AdaptiveDehazer.route_hard`) so that it runs on this process's part of a
batch split by `shard_image_batch`: rows over `data`, H over `spatial`.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch

from adam_dehaze_tpu_torch.parallel.collectives import AllReduceMax, AllReduceSum, Halo
from adam_dehaze_tpu_torch.parallel.mesh import Axis, Mesh, NamedSharding

# The spatial axis of the open spatial_sharding context.
_ROWS: contextvars.ContextVar[Optional[Axis]] = contextvars.ContextVar("rows", default=None)


def axis() -> Optional[Axis]:
    """The spatial axis that splits H in this context, or None."""
    return _ROWS.get()


@contextlib.contextmanager
def spatial_sharding(mesh: Mesh, axis: str = "spatial"):
    """Within this context, image batches (NHWC) and activations (NCHW)
    hold this process's rows of H split over `axis`. A no-op when the mesh
    lacks the axis or it has size 1."""
    rows = mesh.axis(axis)
    if rows is None:
        yield
        return
    from adam_dehaze_tpu_torch.parallel.sharded_ops import intercepting
    token = _ROWS.set(rows)
    try:
        with intercepting():
            yield
    finally:
        _ROWS.reset(token)


def refuse(what: str) -> None:
    """Raise when H is split: `what` does not take an H shard."""
    rows = _ROWS.get()
    if rows is not None:
        raise NotImplementedError(
            f"{what} under a spatial mesh ({rows.name} = {rows.size}) is not ported: serve "
            "the default dispatch (K1, K2 and the modules), or run without the spatial axis")


def halo(x: torch.Tensor, dim: int, top: int, bottom: int,
         fill: Optional[float] = 0.0) -> torch.Tensor:
    """`x` with `top` rows of the previous shard above and `bottom` of the
    next below along `dim` (collectives.Halo); `x` outside the context."""
    rows = _ROWS.get()
    if rows is None or (top == 0 and bottom == 0):
        return x
    return Halo.apply(x, dim, top, bottom, fill, rows)


def mean_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """`x.mean(dim=(2, 3))` of an NCHW tensor over the whole image: the
    shards' float32 (float64) sums added over the spatial group."""
    rows = _ROWS.get()
    if rows is None:
        return x.mean(dim=(2, 3), keepdim=keepdim)
    dt = torch.promote_types(x.dtype, torch.float32)
    total = AllReduceSum.apply(x.sum(dim=(2, 3), keepdim=keepdim, dtype=dt), (rows.group,))
    return (total / (x.shape[2] * rows.size * x.shape[3])).to(x.dtype)


def amax_hw(x: torch.Tensor) -> torch.Tensor:
    """`x.amax(dim=(2, 3))` of an NCHW tensor over the whole image."""
    rows = _ROWS.get()
    local = x.amax(dim=(2, 3))
    return local if rows is None else AllReduceMax.apply(local, rows)


def make_spatial_infer(apply_fn: Callable, mesh: Mesh, spatial_axis: str = "spatial",
                       data_axis: str = "data") -> Callable:
    """Wrap an apply of (N, H, W, 3) images (a bound model, or a route
    returning the dehazed batch and its labels) so that it runs on this
    process's part of a batch split as `shard_image_batch` splits it: rows
    over `data_axis`, H over `spatial_axis`. The wrapped function takes that
    part and returns the apply's output on it: its part of the (N, H, W, 3)
    result, as JAX's out_shardings gives it, and what the route returns per
    row (labels) for its rows.

    H must be divisible by the spatial axis size times every stride of the
    path (the classifier's 32 on a route; pad the image otherwise)."""
    def infer(images):
        with spatial_sharding(mesh, spatial_axis):
            return apply_fn(images)

    return infer


def shard_image_batch(mesh: Mesh, images, spatial_axis: str = "spatial",
                      data_axis: str = "data") -> torch.Tensor:
    """This process's part of an (N, H, W, C) batch, on its device: rows
    over `data_axis`, H over `spatial_axis`."""
    if not isinstance(images, torch.Tensor):
        images = torch.as_tensor(images)
    return NamedSharding(mesh, (data_axis, spatial_axis, None, None)).local(images)
