"""Tensor (channel) parallelism of the branch bottlenecks over the mesh's
`model` axis.

Counterpart of adam_dehaze_tpu/parallel/sharding.py. Model definitions stay
mesh-agnostic: `channel_sharding(mesh)` names the axis, and the branches
call `shard_channels` on their widest activations, after the 4c stem and
after the bottleneck (models/branches.py), as the JAX branches do. There XLA
propagates the weight sharding and inserts the collectives; here they are
written out (parallel/collectives.py):

- The first hook cuts the stem's output to this process's C / model
  channels (`ShardChannels`): the channel-parallel region opens. The second
  hook finds its input already cut and leaves it so.
- Inside the region each convolution gathers its input's channels from the
  group and computes only this process's output channels, from a slice of
  the weights (all-gather-then-column, parallel/sharded_ops.py); BN, ReLU
  and the residual adds work on the local channels. An AttentionBlock
  (nn/blocks.py) splits its channel MLP: the first linear's partial sums
  are added over the group, the second yields this process's slice of the
  gate; kernel K2 runs on the local channels with its (mean, max) maps
  reduced over the group between its two launches.
- The decoder's transposed conv contracts over the split channels: a
  partial sum of the local channels' products, added over the group into
  the whole output (`SumToReplicated`), which closes the region.

The weights stay replicated, as the JAX step keeps the params replicated.
In a train step (parallel/data_parallel.py) the parameters used inside the
region have partial gradients on each process (a slice, or a partial sum
for the gate's stencil), which the step adds over the group; `used` records
them.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from adam_dehaze_tpu_torch.parallel.collectives import ShardChannels
from adam_dehaze_tpu_torch.parallel.mesh import Axis, Mesh


class _Channels:
    """The open context: the model axis, and the full width of the open
    channel-parallel region (None outside one)."""

    def __init__(self, axis: Axis):
        self.axis = axis
        self.region: Optional[int] = None


_ACTIVE: contextvars.ContextVar[Optional[_Channels]] = contextvars.ContextVar(
    "channels", default=None)
# The parameters used inside a region while a train step records them.
_USED: contextvars.ContextVar[Optional[set]] = contextvars.ContextVar("used", default=None)


@contextlib.contextmanager
def channel_sharding(mesh: Mesh, axis: str = "model"):
    """Within this context, `shard_channels` splits an NCHW activation's
    channels over `axis`, and the layers after it work on this process's
    channels until the decoder joins them. A no-op when the mesh lacks the
    axis or it has size 1. It composes with `spatial_sharding` (H over
    `spatial`) and with the data-parallel step (rows over `data`)."""
    ax = mesh.axis(axis)
    if ax is None:
        yield
        return
    from adam_dehaze_tpu_torch.parallel.sharded_ops import intercepting
    token = _ACTIVE.set(_Channels(ax))
    try:
        with intercepting():
            yield
    finally:
        _ACTIVE.reset(token)


def shard_channels(x: torch.Tensor) -> torch.Tensor:
    """This process's channels of an NCHW activation inside the
    channel_sharding context (`x` itself outside it, or when it already
    holds them)."""
    tp = _ACTIVE.get()
    if tp is None:
        return x
    if tp.region is not None and x.shape[1] * tp.axis.size == tp.region:
        return x
    tp.region = x.shape[1]
    return ShardChannels.apply(x, tp.axis)


def channel_axis(x: torch.Tensor, channels: int) -> Optional[Axis]:
    """The model axis when `x` (dim 1) holds this process's part of a layer
    of `channels` channels; None when it holds them all."""
    tp = _ACTIVE.get()
    if tp is None or x.shape[1] == channels:
        return None
    if x.shape[1] * tp.axis.size != channels:
        raise ValueError(f"{x.shape[1]} channels feed a layer of {channels}, split "
                         f"{tp.axis.size} ways along {tp.axis.name!r}")
    return tp.axis


def close_region() -> None:
    """The region's channels were joined into a whole tensor."""
    tp = _ACTIVE.get()
    if tp is not None:
        tp.region = None


def used(*params) -> None:
    """Record parameters used inside the region (while a step records)."""
    record = _USED.get()
    if record is not None:
        record.update(p for p in params if isinstance(p, torch.nn.Parameter))


@contextlib.contextmanager
def recording_used():
    """Yield the set that `used` fills while the context is open."""
    token = _USED.set(set())
    try:
        yield _USED.get()
    finally:
        _USED.reset(token)
