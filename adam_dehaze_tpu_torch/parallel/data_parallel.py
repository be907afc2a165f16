"""Data-parallel training and evaluation over a device mesh.

Counterpart of adam_dehaze_tpu/parallel/data_parallel.py. There, jit
compiles the step over the global batch sharded on `data`, so it computes
what the unsharded step computes on that batch. Here each process runs the
port's step on its own rows, and four things make the result the same:

- BatchNorm in train mode normalises by the statistics of the global
  batch: for the duration of the step every BatchNorm of `state.module`
  takes its per-channel sum and count, then its sum of squared deviations
  from the global mean, through an all_reduce that autograd follows
  (torch's SyncBatchNorm runs on CUDA only). The running variance takes
  torch's unbiased update with the global count.
- The gradients are summed over the `data` group and divided by its size
  between the step's backward and its optimizer step (an optimizer step
  pre-hook), so the steps run `zero_grad`, `backward` and `step` as they
  are.
- Random draws (the augmentation's flips and jitter, the classifier's
  re-fogging, the dropouts) are drawn for the global batch from the step's
  generator, and each process keeps its rows (`draw_rows`): every process
  passes the same generator seed, as the unsharded step draws.
- The metrics come back as the global batch's: float scalars are averaged
  over the `data` group, integer scalars (counts) summed, and tensors with
  the batch's rows gathered in order.

Only the `data` axis is ported; a mesh with `spatial` or `model` above 1
raises NotImplementedError (spatial.py and sharding.py, not ported yet).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.nn.modules.batchnorm import _BatchNorm

from adam_dehaze_tpu_torch.parallel.mesh import Mesh, shard_batch


class _Rows(NamedTuple):
    total: int
    start: int
    stop: int


# The global rows of the data-parallel step running in this context.
_ROWS: contextvars.ContextVar[Optional[_Rows]] = contextvars.ContextVar("rows", default=None)


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


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the gradient is summed over it too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _sync_batch_norm(bn: _BatchNorm, group, x: torch.Tensor) -> torch.Tensor:
    """`bn`'s forward with the statistics of the batch across `group` in
    train mode (its own forward in eval mode). Computes in float32, or
    float64 for a float64 input, and returns the input's dtype."""
    if not bn.training:
        return type(bn).forward(bn, x)
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    sums = _AllReduceSum.apply(torch.cat([xf.sum(dims), xf.new_tensor([x.numel() // x.shape[1]])]),
                               group)
    n = sums[-1]
    mean = sums[:-1] / n
    centred = xf - mean.view(shape)
    var = _AllReduceSum.apply((centred * centred).sum(dims), group) / n
    y = centred * torch.rsqrt(var + bn.eps).view(shape)
    if bn.affine:
        y = y * bn.weight.view(shape) + bn.bias.view(shape)
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            f = bn.momentum if bn.momentum is not None else 1.0 / float(bn.num_batches_tracked)
            bn.running_mean.mul_(1 - f).add_(mean.to(bn.running_mean.dtype), alpha=f)
            unbiased = var * n / (n - 1)
            bn.running_var.mul_(1 - f).add_(unbiased.to(bn.running_var.dtype), alpha=f)
    return y.to(x.dtype)


@contextlib.contextmanager
def _synchronized_batch_norms(module: torch.nn.Module, group):
    """Every BatchNorm of `module` takes the group's statistics while the
    context is open."""
    bns = [m for m in module.modules() if isinstance(m, _BatchNorm)]
    for bn in bns:
        bn.forward = functools.partial(_sync_batch_norm, bn, group)
    try:
        yield
    finally:
        for bn in bns:
            del bn.forward


def _average_gradients(group, size: int):
    """An optimizer step pre-hook: each gradient summed over `group` and
    divided by `size`, one all_reduce per dtype."""
    def hook(optimizer, args, kwargs):
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        for dtype in {g.dtype for g in grads}:
            same = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in same])
            dist.all_reduce(flat, group=group)
            flat /= size
            for g, part in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(part.view_as(g))
    return hook


def _replicated(out, rows: _Rows, group, size: int):
    """A step's outputs as the global batch's (see the module docstring)."""
    if isinstance(out, dict):
        return {k: _replicated(v, rows, group, size) for k, v in out.items()}
    if not isinstance(out, torch.Tensor):
        return out
    if out.dim() == 0:
        if out.is_floating_point():
            total = out.detach().double().reshape(1)
            dist.all_reduce(total, group=group)
            return (total[0] / size).to(out.dtype)
        total = out.detach().reshape(1).clone()
        dist.all_reduce(total, group=group)
        return total[0]
    if out.shape[0] == rows.stop - rows.start:
        parts = [torch.empty_like(out) for _ in range(size)]
        dist.all_gather(parts, out.detach().contiguous(), group=group)
        return torch.cat(parts)
    return out


def _wrap(step_fn: Callable, mesh: Mesh, batch_template: Dict, train: bool) -> Callable:
    for axis in ("spatial", "model"):
        if mesh.shape[axis] > 1:
            raise NotImplementedError(
                f"a mesh with {axis} = {mesh.shape[axis]}: the spatial and model axes "
                "need the halo exchanges of spatial.py and the channel-parallel "
                "convolutions of sharding.py, which the port does not have yet")
    data = mesh.shape["data"]
    group = mesh.group("data")
    if group is None:
        if data > 1:
            raise ValueError(f"a data axis of {data} needs a process group "
                             "(parallel/multihost.py:initialize)")
        return step_fn
    total = next(v.shape[0] for v in batch_template.values() if getattr(v, "ndim", 0) >= 1)
    if total % data:
        raise ValueError(f"a batch of {total} does not split into {data} equal shards")
    local = total // data
    rows = _Rows(total, mesh.coordinate("data") * local, (mesh.coordinate("data") + 1) * local)

    def step(state, batch, *args):
        n = next(v.shape[0] for v in batch.values() if getattr(v, "ndim", 0) >= 1)
        if n == total:
            batch = shard_batch(mesh, batch)
        elif n != local:
            raise ValueError(f"a batch of {n} rows: the step takes the global batch of "
                             f"{total} or this process's {local} rows of it")
        token = _ROWS.set(rows)
        hook = (state.optimizer.register_step_pre_hook(_average_gradients(group, data))
                if train else None)
        try:
            with _synchronized_batch_norms(state.module, group):
                out = step_fn(state, batch, *args)
        finally:
            _ROWS.reset(token)
            if hook is not None:
                hook.remove()
        return _replicated(out, rows, group, data)

    return step


def shard_train_step(step_fn: Callable, mesh: Mesh, batch_template: Dict) -> Callable:
    """Wrap a port train step, step(state, batch, generator) -> metrics
    with `state` a TrainState, so that the processes of the mesh's `data`
    axis together take the step on the global batch.

    `batch_template` is the global batch (or arrays of its shapes): its
    rows split over `data`. The wrapped step takes the global batch, or
    this process's rows of it, and the same generator seed on every
    process. Without a process group the mesh must have data = 1, and the
    step is returned as it is."""
    return _wrap(step_fn, mesh, batch_template, train=True)


def shard_eval_step(step_fn: Callable, mesh: Mesh, batch_template: Dict) -> Callable:
    """`shard_train_step`'s rules for an eval step, step(state, batch) ->
    outputs, with no gradient to average. A float scalar output is the
    global batch's where it is a mean over rows and every process holds
    as many valid rows."""
    return _wrap(step_fn, mesh, batch_template, train=False)
