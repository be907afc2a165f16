"""The exchanges between the processes of a mesh axis, one
`torch.autograd.Function` per kind, each with its backward.

Where the JAX package lets XLA's sharding propagation insert collectives
(adam_dehaze_tpu/parallel/spatial.py, sharding.py), the port writes them out:

- `AllReduceSum`: a sum over one or more groups whose result feeds work
  that differs per process (the spatial pools, the channel-split MLP's
  first linear, BN's statistics); its gradient is summed over them too;
- `SumToReplicated`: a sum of partial results into a tensor that every
  process then uses the same way (the row-parallel transposed conv that
  leaves the channel-parallel stages); its gradient passes as it is;
- `AllReduceMax`: a max whose gradient goes to the process that holds it;
- `Halo`: an H shard with the rows its neighbours hold above and below;
  the backward adds the halo's gradient into the sender's boundary rows;
- `ShardChannels` and `GatherChannels`: a replicated tensor cut to this
  process's channels (the gradient is gathered back) and the channels of
  the group gathered (the gradient is summed, then cut);
- `GatherRows`: the H shards of the group joined into the whole image on
  every process (the gradient is summed, then each process keeps its own
  rows: a reduce-scatter);
- `FlipRows`: the image reversed along H, shard by shard: process r takes
  process S-1-r's rows in reverse order (its own inverse, and so is its
  backward).

Collectives go through the axis's process group as they are: gloo takes
CUDA tensors for all_reduce and all_gather, NCCL takes them for all.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from adam_dehaze_tpu_torch.parallel.mesh import Axis


def all_gather(t: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every process's `t` along `axis`, in index order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return parts


def _all_reduce(t: torch.Tensor, groups: Sequence, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of a copy of `t` over each group in turn, in `t`'s
    memory format (the collectives take contiguous tensors)."""
    out = t.clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(out, op=op, group=group)
    return out.contiguous(memory_format=_memory_format(t))


class AllReduceSum(torch.autograd.Function):
    """Sum over each group of `groups` in turn; the gradient is summed over
    them too."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _all_reduce(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class SumToReplicated(torch.autograd.Function):
    """Sum of partial results over `axis`, used the same way on every
    process after it: each process's gradient is already the whole one."""

    @staticmethod
    def forward(ctx, t, axis: Axis):
        return _all_reduce(t, [axis.group])

    @staticmethod
    def backward(ctx, g):
        return g, None


class AllReduceMax(torch.autograd.Function):
    """Max over `axis`; the gradient (summed over the axis, as the result
    feeds work that differs per process) goes to the entries that equal
    the max, split evenly where several processes hold it."""

    @staticmethod
    def forward(ctx, t, axis: Axis):
        out = _all_reduce(t, [axis.group], dist.ReduceOp.MAX)
        ctx.axis = axis
        ctx.save_for_backward(t, out)
        return out

    @staticmethod
    def backward(ctx, g):
        t, out = ctx.saved_tensors
        holds = (t == out).to(g.dtype)
        count = _all_reduce(holds, [ctx.axis.group])
        return _all_reduce(g, [ctx.axis.group]) * holds / count.clamp_min(1), None


def _rows(shape, dim: int, n: int):
    shape = list(shape)
    shape[dim] = n
    return shape


class Halo(torch.autograd.Function):
    """`x`, an H shard along `dim`, with `top` rows of the previous
    process's shard above it and `bottom` rows of the next one's below. At
    the image's true edges (the first and last process along `axis`) the
    missing rows are `fill`, or left out where `fill` is None. Both halos
    must fit in one shard. The backward adds the halo rows' gradient into
    the boundary rows of the shard they came from."""

    @staticmethod
    def forward(ctx, x, dim: int, top: int, bottom: int, fill: Optional[float], axis: Axis):
        n, r, s = x.shape[dim], axis.index, axis.size
        if top > n or bottom > n:
            raise ValueError(f"a halo of {top} and {bottom} rows does not fit in an H shard "
                             f"of {n}: give each of the {s} spatial shards more rows")
        parts = all_gather(torch.cat([x.narrow(dim, 0, bottom), x.narrow(dim, n - top, top)],
                                     dim), axis)
        pieces = []
        has_top = top > 0 and (r > 0 or fill is not None)
        has_bottom = bottom > 0 and (r < s - 1 or fill is not None)
        if has_top:
            pieces.append(parts[r - 1].narrow(dim, bottom, top) if r > 0
                          else x.new_full(_rows(x.shape, dim, top), fill))
        pieces.append(x)
        if has_bottom:
            pieces.append(parts[r + 1].narrow(dim, 0, bottom) if r < s - 1
                          else x.new_full(_rows(x.shape, dim, bottom), fill))
        ctx.meta = (dim, top, bottom, n, has_top, has_bottom, axis)
        return torch.cat(pieces, dim).contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        dim, top, bottom, n, has_top, has_bottom, axis = ctx.meta
        r, s = axis.index, axis.size
        t = top if has_top else 0
        g_top = g.narrow(dim, 0, top) if has_top else g.new_zeros(_rows(g.shape, dim, top))
        g_bottom = (g.narrow(dim, t + n, bottom) if has_bottom
                    else g.new_zeros(_rows(g.shape, dim, bottom)))
        parts = all_gather(torch.cat([g_top, g_bottom], dim), axis)
        gx = g.narrow(dim, t, n).clone()
        if top and r < s - 1:       # the next shard's top halo is my last rows
            gx.narrow(dim, n - top, top).add_(parts[r + 1].narrow(dim, 0, top))
        if bottom and r > 0:        # the previous shard's bottom halo is my first rows
            gx.narrow(dim, 0, bottom).add_(parts[r - 1].narrow(dim, top, bottom))
        return gx, None, None, None, None, None


class GatherRows(torch.autograd.Function):
    """Every process's H shard along `dim`, joined in index order: the whole
    image on every process. What follows may differ per process, so the
    gradient of the whole is summed over the axis and each process keeps
    the rows it holds."""

    @staticmethod
    def forward(ctx, x, dim: int, axis: Axis):
        ctx.meta = (dim, x.shape[dim], axis)
        return torch.cat(all_gather(x, axis), dim).contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        dim, n, axis = ctx.meta
        whole = _all_reduce(g, [axis.group])
        return whole.narrow(dim, axis.index * n, n).contiguous(), None, None


def _flip_rows(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    part = all_gather(x, axis)[axis.size - 1 - axis.index]
    return part.flip(dim).contiguous(memory_format=_memory_format(x))


class FlipRows(torch.autograd.Function):
    """The shard, along `dim`, of the image reversed along H: process r
    takes the rows of process S-1-r in reverse order. The gradient goes
    back the same way."""

    @staticmethod
    def forward(ctx, x, dim: int, axis: Axis):
        ctx.meta = (dim, axis)
        return _flip_rows(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        dim, axis = ctx.meta
        return _flip_rows(g, dim, axis), None, None


def channel_slice(channels: int, axis: Axis) -> slice:
    """This process's channels of `channels` split evenly over `axis`."""
    if channels % axis.size:
        raise ValueError(f"{channels} channels do not split into {axis.size} equal shards "
                         f"along {axis.name!r}")
    n = channels // axis.size
    return slice(axis.index * n, (axis.index + 1) * n)


class ShardChannels(torch.autograd.Function):
    """A tensor that every process holds whole, cut to this process's
    channels (dim 1); the gradient of the whole is gathered from every
    process's part."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return x[:, channel_slice(x.shape[1], axis)].contiguous(
            memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g, ctx.axis), 1), None


class GatherChannels(torch.autograd.Function):
    """Every process's channels (dim 1) side by side. What follows differs
    per process, so the gradient of the whole is summed over the axis and
    cut to this process's channels."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return torch.cat(all_gather(x, axis), 1).contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        whole = _all_reduce(g, [ctx.axis.group])
        return whole[:, channel_slice(whole.shape[1], ctx.axis)], None


def _memory_format(x: torch.Tensor):
    """channels_last for a 4-d tensor held so (the branches' activations)."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format
