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
  `mean_hw` and `amax_hw` (NCHW), and those of the losses, metrics and
  augmentation through `image_mean` and `image_amax` (any image dims): a
  sum (a max) over the spatial group, divided by the whole image's count,
  so that every process of a spatial group sees the same channel gates,
  logits and per-image values.
- `flip_h` reverses the image along H across the shards (the
  augmentation's vertical flip); `gather_h` joins the shards into the whole
  image on every process, for work whose rows do not split evenly (LPIPS's
  AlexNet, whose strided layers give 63 rows of 256), run inside
  `whole_image()`; `halo` takes rows from the neighbours, from further
  away when a halo is taller than a shard; `taller` is a shard with a
  radius of rows around it where the image has them.
- A VALID average pool (stride 1, no padding along H: SSIM's window) reads
  the rows below the shard; the last shard keeps only the rows the
  unsharded output has, and `image_mean` divides by the unsharded count.
- Kernel K2 (ops/kernels/cbam.py:channel_spatial_gate_sharded), K2' alone
  and inside K4, and the attention blocks of K6 fill the halo rows of their
  statistics maps between their launches, and K4 and K6 reduce their
  per-image channel statistics over the group; kernel K1
  (ops/kernels/lightweight_chain.py), K3, K4's convolution runs and K6's
  runs of residual blocks run on a shard made taller by their receptive
  radius and crop the result (ops/kernels/tail_chain.py, res_chain.py).
- Int8 serving's layers (ops/quant.py:Int8Conv2d) reduce Q1's per-image
  abs-max over the group and run Q2 on a shard made taller by the int8
  rows its windows read.
- Resizes (F.interpolate: bilinear with half-pixel centres or
  align-corners, with or without antialias, and nearest-exact) take their
  H pass from the unsharded op's own weights over the band of source rows
  that the shard's output rows read (`halo` fetches it), then resize W on
  the shard; a `size` is the shard's (the models read it off their
  shards), a `scale_factor` the whole image's. Adaptive pools to 1 x 1 are
  `mean_hw` and `image_amax`; to the whole image's H they pool W on the
  shard (parallel/sharded_ops.py).
- What raises under the context: other resize modes, resizes and layers
  whose output rows do not split evenly over the shards, other adaptive
  pool sizes, pads of H and average pools other than a VALID stride-1
  window. No model forward of the package pads H or takes a strided
  average pool (the one pad of H, data/synthetic.py's integral image, runs
  on a taller shard under `local_ops()`), so those have no rule.

`make_spatial_infer` wraps an apply (a bound model, or a route such as
`AdaptiveDehazer.route_hard`) so that it runs on this process's part of a
batch split by `shard_image_batch`: rows over `data`, H over `spatial`.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from adam_dehaze_tpu_torch.parallel.collectives import (
    AllReduceMax,
    AllReduceSum,
    FlipRows,
    GatherRows,
    Halo,
)
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


@contextlib.contextmanager
def whole_image():
    """Within this context the layers see no H split: for work on an image
    that every process holds whole (`gather_h`)."""
    token = _ROWS.set(None)
    try:
        yield
    finally:
        _ROWS.reset(token)


def rows_total(n: int) -> int:
    """The image's rows when this process holds an H shard of `n` rows
    (`n` outside the context)."""
    rows = _ROWS.get()
    return n if rows is None else n * rows.size


def halo(x: torch.Tensor, dim: int, top: int, bottom: int,
         fill: Optional[float] = 0.0) -> torch.Tensor:
    """`x` with `top` rows of the image above it and `bottom` below along
    `dim`; beyond the image's true edges `fill`, or no rows where `fill` is
    None; `x` outside the context. A halo that fits in one shard comes from
    the neighbours (collectives.Halo), a taller one from the whole image
    (collectives.GatherRows)."""
    rows = _ROWS.get()
    if rows is None or (top == 0 and bottom == 0):
        return x
    n = x.shape[dim]
    if top <= n and bottom <= n:
        return Halo.apply(x, dim, top, bottom, fill, rows)
    whole = GatherRows.apply(x, dim, rows)
    total = whole.shape[dim]
    lo, hi = rows.index * n - top, rows.index * n + n + bottom
    piece = whole.narrow(dim, max(lo, 0), min(hi, total) - max(lo, 0))
    if fill is None or (lo >= 0 and hi <= total):
        return piece
    shape = list(x.shape)
    pieces = []
    for count in (-lo, None, hi - total):
        if count is None:
            pieces.append(piece)
        elif count > 0:
            shape[dim] = count
            pieces.append(x.new_full(shape, fill))
    return torch.cat(pieces, dim)


def taller(x: torch.Tensor, dim: int, radius: int) -> Tuple[torch.Tensor, int]:
    """(`x` with `radius` rows of the image above and below it along `dim`
    where the image has them, the number of rows added above): the shard a
    chain of layers runs on so that its own rows come out as the unsharded
    chain's, which are then the rows from that number on. `(x, 0)` outside
    the context."""
    rows = _ROWS.get()
    if rows is None or radius == 0:
        return x, 0
    return halo(x, dim, radius, radius, fill=None), min(radius, rows.index * x.shape[dim])


def gather_h(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole image on every process, from the H shards along `dim`
    (collectives.GatherRows); `x` outside the context."""
    rows = _ROWS.get()
    return x if rows is None else GatherRows.apply(x, dim, rows)


def flip_h(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """`x.flip(dim)` of the whole image: this process's shard of the image
    reversed along H (collectives.FlipRows)."""
    rows = _ROWS.get()
    return x.flip(dim) if rows is None else FlipRows.apply(x, dim, rows)


def image_mean(x: torch.Tensor, dims: Sequence[int], keepdim: bool = False,
               count: Optional[int] = None) -> torch.Tensor:
    """`x.mean(dims)` over the whole image, with H among `dims`: the
    shards' float32 (float64) sums added over the spatial group, divided by
    `count`, the unsharded tensor's number of values over `dims` (by
    default the shard's times the group's size: equal shards)."""
    rows = _ROWS.get()
    if rows is None:
        return x.mean(dim=tuple(dims), keepdim=keepdim)
    dt = torch.promote_types(x.dtype, torch.float32)
    total = AllReduceSum.apply(x.sum(dim=tuple(dims), keepdim=keepdim, dtype=dt),
                               (rows.group,))
    if count is None:
        count = math.prod(x.shape[d] for d in dims) * rows.size
    return (total / count).to(x.dtype)


def image_amax(x: torch.Tensor, dims: Sequence[int], keepdim: bool = False) -> torch.Tensor:
    """`x.amax(dims)` over the whole image, with H among `dims`."""
    rows = _ROWS.get()
    local = x.amax(dim=tuple(dims), keepdim=keepdim)
    return local if rows is None else AllReduceMax.apply(local, rows)


def mean_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """`x.mean(dim=(2, 3))` of an NCHW tensor over the whole image."""
    return image_mean(x, (2, 3), keepdim)


def amax_hw(x: torch.Tensor) -> torch.Tensor:
    """`x.amax(dim=(2, 3))` of an NCHW tensor over the whole image."""
    return image_amax(x, (2, 3))


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
