"""Rematerialisation for the training forwards (config `cuda.remat`).

Counterpart of adam_dehaze_tpu/training/remat.py (`tpu.remat`), on
`torch.utils.checkpoint` (non-reentrant):

- ``false``: autograd keeps every activation the backward needs.
- ``true`` / ``"full"``: `apply_remat` checkpoints the whole router
  forward of the joint train step; the backward recomputes it.
- ``"fullres"``: structural, as the JAX package's remat twins
  (models/branches.py:_fullres_blocks, nn/blocks.py:remat_twin): the branch
  factories checkpoint the full-resolution blocks of the three default
  branches (`remat_blocks_`), leaving their parameter names as they are. At
  the step this mode is the identity.

Two things differ from `jax.checkpoint`, which recomputes a pure function:

- A recompute runs the forward again in train mode, so every BatchNorm
  would update its running statistics a second time. During the recompute
  the BNs of the region take momentum 0 (running = running * 1 + batch *
  0, the same values) and get their `num_batches_tracked` back after it,
  so the statistics are updated once, as in JAX. (Not tracking statistics
  during the recompute would change the tensors batch norm saves, which
  the checkpoint refuses.)
- `preserve_rng_state` restores the default generators only. The dropout
  masks of the classifier and the gate come from the step's own
  `torch.Generator`: its state at the region's start is saved and set
  again for the recompute (and restored after it), so the recompute draws
  the same masks.
- The sharding contexts of parallel/ (an H shard, split channels, the
  data-parallel step's rows) are context variables, which the thread that
  the card's autograd engine recomputes on does not see. The region's
  start captures them (parallel/sharded_ops.py:captured) and the recompute
  re-enters them, so it runs the forward's exchanges again, in the same
  order on every process. The data-parallel step's synchronized BNs take
  the frozen momentum like any other.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterable, Optional

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.utils.checkpoint import checkpoint

from adam_dehaze_tpu_torch.parallel.sharded_ops import captured

MODES = (False, True, "full", "fullres")


def remat_mode(config):
    """`cuda.remat` of the config, checked: False, True, "full" or
    "fullres"."""
    mode = config.get("cuda", {}).get("remat", False)
    if mode not in MODES:
        raise ValueError(f"unsupported cuda.remat: {mode!r} (one of {MODES})")
    return mode


def _contexts(module: nn.Module, generator: Optional[torch.Generator]):
    """context_fn of `checkpoint`: the forward saves the generator's state
    and the sharding state; the recompute replays both and freezes the
    region's BN statistics."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        if generator is not None:
            saved["state"] = generator.get_state()
        saved["sharding"] = captured()
        yield

    @contextlib.contextmanager
    def recompute():
        bns = [(m, m.momentum, m.num_batches_tracked.clone()) for m in module.modules()
               if isinstance(m, _BatchNorm) and m.training and m.track_running_stats]
        now = None
        if generator is not None:
            now = generator.get_state()
            generator.set_state(saved["state"])
        for m, _, _ in bns:
            m.momentum = 0.0
        try:
            with saved["sharding"]():
                yield
        finally:
            for m, momentum, tracked in bns:
                m.momentum = momentum
                m.num_batches_tracked.copy_(tracked)
            if generator is not None:
                generator.set_state(now)

    return lambda: (forward(), recompute())


def checkpoint_call(fn: Callable, *args, module: nn.Module,
                    generator: Optional[torch.Generator] = None, **kwargs):
    """fn(*args, **kwargs) under non-reentrant `torch.utils.checkpoint`,
    with `module`'s BN statistics updated once and `generator` replayed in
    the recompute."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_contexts(module, generator), **kwargs)


def apply_remat(fwd: Callable, remat, module: nn.Module,
                generator: Optional[torch.Generator] = None) -> Callable:
    """Wrap a train step's forward per the remat mode: under True/"full"
    the whole of `fwd` is checkpointed (`module` holds its BNs, `generator`
    its dropout draws); falsy and "fullres" (structural, see
    `remat_blocks_`) leave it as it is."""
    if not remat or remat == "fullres":
        return fwd
    return functools.partial(checkpoint_call, fwd, module=module, generator=generator)


def _remat_forward(module: nn.Module, forward: Callable, *args):
    if module.training and torch.is_grad_enabled():
        return checkpoint_call(functools.partial(forward, module), *args, module=module)
    return forward(module, *args)


def remat_blocks_(model: nn.Module, names: Iterable[str]) -> nn.Module:
    """Checkpoint the named submodules of `model` in train mode, in place:
    each one's forward becomes `checkpoint_call` of its class's forward.
    Parameter names and eval forwards do not change."""
    for name in names:
        block = model.get_submodule(name)
        block.forward = functools.partial(_remat_forward, block, type(block).forward)
    return model
