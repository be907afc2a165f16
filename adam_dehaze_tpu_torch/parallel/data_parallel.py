"""Data-parallel training and evaluation over a device mesh, with the
spatial and model axes.

Counterpart of adam_dehaze_tpu/parallel/data_parallel.py. There, jit
compiles the step over the global batch sharded on `data` (and H on
`spatial`), so it computes what the unsharded step computes on that batch.
Here each process runs the port's step on its own rows (and its rows of H),
inside `spatial_sharding` and `channel_sharding` (spatial.py, sharding.py),
and these things make the result the same:

- BatchNorm in train mode normalises by the statistics of the global
  batch: for the duration of the step every BatchNorm of `state.module`
  takes its per-channel sum and count, then its sum of squared deviations
  from the global mean, through all_reduces over the `data` and `spatial`
  groups that autograd follows (torch's SyncBatchNorm runs on CUDA only).
  The running variance takes torch's unbiased update with the global count.
  A BN inside the channel-parallel region normalises this process's
  channels and updates their slice of its running statistics, which the
  step gathers back over the `model` group afterwards; every other BN's
  statistics are averaged over that group, equal bit for bit across it.
- The gradients are summed over the `data` and `spatial` groups and
  divided by the number of shards between the step's backward and its
  optimizer step (an optimizer step pre-hook), so the steps run
  `zero_grad`, `backward` and `step` as they are. What the processes
  minimise together is the mean of their losses, and every term of a
  process's loss is one of two kinds. A mean over its own rows and pixels
  (the L1 and VGG-content terms, the cross-entropy over its rows) is its
  share: the shards are equal, so the mean of the shares is the global
  mean. A term reduced over the group in the forward (LPIPS on the image
  gathered whole, the density-weighted L1's ratio of `batch_sum`s, the
  cross-entropy of logits pooled over the spatial group) is the global
  value on every process, so the mean over processes is that value; the
  reduction's backward (collectives.py) adds every process's gradient of
  it, and the average's division by the number of shards leaves each
  term's gradient counted once. Under `model` a parameter used inside the
  channel-parallel region holds only its part of the gradient (its slice,
  or a partial sum) and is first summed over the `model` group; every
  other gradient is the same across that group in exact arithmetic and is
  averaged over it, so that the replicas stay equal bit for bit where the
  card's convolution gradients are not deterministic (cuDNN's weight
  gradients sum in no fixed order).
- Random draws (the augmentation's flips and jitter, the classifier's
  re-fogging, the dropouts) are drawn for the global batch from the step's
  generator, and each process keeps its rows (`draw_rows`): every process
  passes the same generator seed, as the unsharded step draws.
- The metrics come back as the global batch's: float scalars are averaged
  over the `data` and `spatial` groups, integer scalars (counts) summed
  over `data`, and tensors with the batch's rows gathered in order (image
  batches, (N, H, W, C), along H as well). The eval step's PSNR and SSIM
  are per image over the whole image already (ops/image.py), its
  classifier accuracy per row of logits that every process of a spatial
  group holds alike, so their means over the valid rows are the global
  batch's when every process holds as many valid rows.

The joint steps (training/train_joint.py) run under all three axes with
their loss nets and augmentation, under `cuda.remat` too: its recompute
re-enters the step's contexts (training/remat.py).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.nn.modules.batchnorm import _BatchNorm

from adam_dehaze_tpu_torch.parallel import sharding
from adam_dehaze_tpu_torch.parallel.collectives import AllReduceSum, all_gather, channel_slice
from adam_dehaze_tpu_torch.parallel.mesh import Axis, Mesh, shard_batch
from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
from adam_dehaze_tpu_torch.parallel.spatial import spatial_sharding


class _Rows(NamedTuple):
    total: int
    start: int
    stop: int


# The global rows of the data-parallel step running in this context.
_ROWS: contextvars.ContextVar[Optional[_Rows]] = contextvars.ContextVar("rows", default=None)
# The process groups over which that step's batch is split (rows, H).
_GROUPS: contextvars.ContextVar[tuple] = contextvars.ContextVar("groups", default=())


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the processes that split the batch of the running
    data-parallel step, its rows over `data` and its H over `spatial`
    (collectives.AllReduceSum); `t` outside one. For a ratio of sums over
    the batch, which the mean of the processes' own ratios is not."""
    groups = _GROUPS.get()
    return AllReduceSum.apply(t, groups) if groups else t


def draw_rows(n: int, draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """`draw(n)`: a random draw with one leading row per image of a batch
    of `n`. Inside a data-parallel step, whose batch holds this process's
    rows of the global batch, `draw` is called for the global batch and
    this process's rows of it are returned."""
    rows = _ROWS.get()
    if rows is None:
        return draw(n)
    if n != rows.stop - rows.start:
        raise ValueError(f"a draw for {n} rows inside a data-parallel step of "
                         f"{rows.stop - rows.start} rows a process")
    return draw(rows.total)[rows.start:rows.stop]


def rand_rows(n: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """`torch.rand(n)` on `device` from `generator`, by `draw_rows`."""
    return draw_rows(n, lambda m: torch.rand(m, generator=generator, device=device))


def _sync_batch_norm(bn: _BatchNorm, groups, split: dict, x: torch.Tensor) -> torch.Tensor:
    """`bn`'s forward with the statistics of the batch across `groups` in
    train mode (its own forward in eval mode). Computes in float32, or
    float64 for a float64 input, and returns the input's dtype. On this
    process's channels of a channel-split layer it takes their slice of the
    parameters and statistics and adds `bn` to `split` (a dict, so that
    every process walks it in the same order: the forward's)."""
    if not bn.training:
        return type(bn).forward(bn, x)
    part = slice(None)
    channels = sharding.channel_axis(x, bn.num_features)
    if channels is not None:
        part = channel_slice(bn.num_features, channels)
        sharding.used(bn.weight, bn.bias)
        split[bn] = None
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    sums = AllReduceSum.apply(torch.cat([xf.sum(dims), xf.new_tensor([x.numel() // x.shape[1]])]),
                              groups)
    n = sums[-1]
    mean = sums[:-1] / n
    centred = xf - mean.view(shape)
    var = AllReduceSum.apply((centred * centred).sum(dims), groups) / n
    y = centred * torch.rsqrt(var + bn.eps).view(shape)
    if bn.affine:
        y = y * bn.weight[part].view(shape) + bn.bias[part].view(shape)
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            f = bn.momentum if bn.momentum is not None else 1.0 / float(bn.num_batches_tracked)
            bn.running_mean[part].mul_(1 - f).add_(mean.to(bn.running_mean.dtype), alpha=f)
            unbiased = var * n / (n - 1)
            bn.running_var[part].mul_(1 - f).add_(unbiased.to(bn.running_var.dtype), alpha=f)
    return y.to(x.dtype)


@contextlib.contextmanager
def _synchronized_batch_norms(module: torch.nn.Module, groups):
    """Every BatchNorm of `module` takes the statistics over `groups` while
    the context is open. Yields those that ran on split channels, as the
    keys of a dict."""
    bns = [m for m in module.modules() if isinstance(m, _BatchNorm)]
    split = {}
    for bn in bns:
        bn.forward = functools.partial(_sync_batch_norm, bn, groups, split)
    try:
        yield split
    finally:
        for bn in bns:
            del bn.forward


def _gather_split_statistics(bns, model) -> None:
    """Each process updated its channels' slice of these BNs' running
    statistics: every process gets every slice back."""
    for bn in bns:
        part = channel_slice(bn.num_features, model)
        for buf in (bn.running_mean, bn.running_var):
            buf.copy_(torch.cat(all_gather(buf[part], model)))


def _average_replicated_statistics(module, split, model) -> None:
    """The running statistics of the BNs that ran on every channel,
    averaged over the `model` group: equal in exact arithmetic, they stay
    equal bit for bit where the card's convolutions are not deterministic."""
    bufs = [b for m in module.modules() if isinstance(m, _BatchNorm) and m not in split
            and m.track_running_stats for b in (m.running_mean, m.running_var)]
    _sum_flat(bufs, model.group)
    for b in bufs:
        b /= model.size


def _sum_flat(grads, group) -> None:
    """Sum `grads` over `group` in place, one all_reduce per dtype, in the
    order the dtypes first occur (the same on every process)."""
    for dtype in dict.fromkeys(g.dtype for g in grads):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))


def _average_gradients(groups, size: int, model=None, used=()):
    """An optimizer step pre-hook: the gradients of the parameters in
    `used` summed over the `model` axis (when there is one) and the others
    averaged over it, then every gradient summed over `groups` and divided
    by `size`."""
    def hook(optimizer, args, kwargs):
        params = [p for g in optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        if model is not None:
            _sum_flat([p.grad for p in params if p in used], model.group)
            same = [p.grad for p in params if p not in used]
            _sum_flat(same, model.group)
            for g in same:
                g /= model.size
        grads = [p.grad for p in params]
        for group in groups:
            _sum_flat(grads, group)
        for g in grads:
            g /= size
    return hook


def _replicated(out, rows: _Rows, data, spatial):
    """A step's outputs as the global batch's (see the module docstring)."""
    if isinstance(out, dict):
        return {k: _replicated(v, rows, data, spatial) for k, v in out.items()}
    if not isinstance(out, torch.Tensor):
        return out
    split = [a for a in (data, spatial) if a is not None]
    if out.dim() == 0:
        if out.is_floating_point():
            total = out.detach().double().reshape(1)
            for a in split:
                dist.all_reduce(total, group=a.group)
            return (total[0] / math.prod(a.size for a in split)).to(out.dtype)
        total = out.detach().reshape(1).clone()
        dist.all_reduce(total, group=data.group)
        return total[0]
    if out.shape[0] == rows.stop - rows.start:
        out = out.detach()
        if spatial is not None and out.dim() == 4:
            out = torch.cat(all_gather(out, spatial), 1)
        return torch.cat(all_gather(out, data))
    return out


def _wrap(step_fn: Callable, mesh: Mesh, batch_template: Dict, train: bool) -> Callable:
    rows_axis, model = mesh.axis("spatial"), mesh.axis("model")
    if mesh.group("data") is None:
        if mesh.shape["data"] > 1:
            raise ValueError(f"a data axis of {mesh.shape['data']} needs a process group "
                             "(parallel/multihost.py:initialize)")
        return step_fn
    data = Axis("data", mesh.group("data"), mesh.coordinate("data"), mesh.shape["data"])
    total = next(v.shape[0] for v in batch_template.values() if getattr(v, "ndim", 0) >= 1)
    if total % data.size:
        raise ValueError(f"a batch of {total} does not split into {data.size} equal shards")
    local = total // data.size
    rows = _Rows(total, data.index * local, (data.index + 1) * local)
    # The groups over which the batch is split: its rows and its H.
    split = [a for a in (data, rows_axis) if a is not None]
    groups = tuple(a.group for a in split)
    shards = math.prod(a.size for a in split)

    def step(state, batch, *args):
        n = next(v.shape[0] for v in batch.values() if getattr(v, "ndim", 0) >= 1)
        if n == total:
            batch = shard_batch(mesh, batch)
        elif n != local:
            raise ValueError(f"a batch of {n} rows: the step takes the global batch of "
                             f"{total} or this process's {local} rows of it")
        token, groups_token = _ROWS.set(rows), _GROUPS.set(groups)
        try:
            with contextlib.ExitStack() as stack:
                used = stack.enter_context(sharding.recording_used())
                split_bns = stack.enter_context(_synchronized_batch_norms(state.module, groups))
                if train:
                    hook = state.optimizer.register_step_pre_hook(
                        _average_gradients(groups, shards, model, used))
                    stack.callback(hook.remove)
                stack.enter_context(spatial_sharding(mesh))
                stack.enter_context(channel_sharding(mesh))
                out = step_fn(state, batch, *args)
        finally:
            _ROWS.reset(token)
            _GROUPS.reset(groups_token)
        if model is not None:
            with torch.no_grad():
                _gather_split_statistics(split_bns, model)
                _average_replicated_statistics(state.module, split_bns, model)
        return _replicated(out, rows, data, rows_axis)

    return step


def shard_train_step(step_fn: Callable, mesh: Mesh, batch_template: Dict) -> Callable:
    """Wrap a port train step, step(state, batch, generator) -> metrics
    with `state` a TrainState, so that the processes of the mesh together
    take the step on the global batch: rows over `data`, H over `spatial`,
    the branches' widest stages over `model`.

    `batch_template` is the global batch (or arrays of its shapes): its
    rows split over `data`. The wrapped step takes the global batch, or
    this process's part of it (its rows, and its rows of H), and the same
    generator seed on every process. Without a process group every axis
    must be 1, and the step is returned as it is."""
    return _wrap(step_fn, mesh, batch_template, train=True)


def shard_eval_step(step_fn: Callable, mesh: Mesh, batch_template: Dict) -> Callable:
    """`shard_train_step`'s rules for an eval step, step(state, batch) ->
    outputs, with no gradient to average. A float scalar output is the
    global batch's where it is a mean over rows and every process holds
    as many valid rows."""
    return _wrap(step_fn, mesh, batch_template, train=False)
