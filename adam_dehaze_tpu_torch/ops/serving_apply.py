"""Eval-mode serving applies of the branches and the classifier.

Counterparts of adam_dehaze_tpu/ops/s2d.py:make_serving_apply and
make_classifier_serving_apply. The module carries its weights, so each
function takes the module and the compute dtype:

- the low branch (LightweightDehazeModel) gets kernel K1 whenever its shape
  allows (`LightweightDehazeModel.serving_chain`, decided up front from the
  width, depth and dtype): BN is folded once, from the float32 parameters,
  and each call runs the chain (the kernels on a CUDA tensor, their plain
  version on a CPU one);
- every other branch, the high one with kernel K2 inside its
  AttentionBlocks, and the classifier run their canonical eval forward on
  a copy whose convolution and linear weights are cast to the compute
  dtype. BatchNorm parameters and statistics stay float32.

`BranchChainApply` runs a medium or high branch with parts of it on the
chain kernels, folded once, and the rest on the serving copy's canonical
modules: any of the same-shape segments `e1`, `e2b`, `d1` on kernel K6
(ops/kernels/res_chain.py), and everything after the d1 concat on kernel K3
or K4. Its makers are the counterparts of the JAX package's applies:
`make_medium_tail_apply` and `make_high_tail_apply`
(`make_medium_s2d_apply(..., tail_chain=True)`,
`make_high_s2d_apply(..., tail_chain=True)`), `make_medium_chain_apply`
(`make_medium_chain_apply`: all three segments on K6) and
`make_high_chain_apply` (`make_high_s2d_apply(..., res_chain=...,
tail_chain=...)`). The serving autotune (serving_autotune.py) offers them as
the `tail_chain`, `chain_hybrid`, `res_chain_e2b` and `res_e2b_tail_chain`
candidates; the default dispatch does not use them.

`make_router_serving_apply` builds one serving copy of a whole router from
the same applies; soft routing calls it and the hard-routing engine takes
its classifier and branches, so both paths share one fold and one cast.

Under `make_spatial_infer` (parallel/spatial.py) a `BranchChainApply`
gets this process's H shard of the batch: it judges
`chain_apply_supported` (and through it `tail_supported` and
`res_chain_supported`) at the shard's shape, the one its kernels take
(they run on it, or on it made taller by their halos), and a dehazer
serves the applies it chose from its tuned cache at construction, keyed
by the whole image's shape (`AdaptiveDehazer(autotune=True)`).

The JAX package's space-to-depth rewrites are not ported: they fill the
TPU's 128-wide lanes and have no purpose on the H100.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
from torch import nn

from adam_dehaze_tpu_torch.models.branches import (
    HighIntensityDehazeModel,
    LightweightDehazeModel,
    MediumIntensityDehazeModel,
)
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    LightweightChainWeights,
    lightweight_chain,
)
from adam_dehaze_tpu_torch.ops.kernels.res_chain import (
    SEGMENTS,
    fold_res_attn_chain,
    res_attn_chain,
    res_chain_supported,
    segment_blocks,
)
from adam_dehaze_tpu_torch.ops.kernels.tail_chain import (
    fold_high_tail,
    fold_medium_tail,
    high_tail_chain,
    medium_tail_chain,
    tail_supported,
)

_CAST = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


class LightweightChainApply(nn.Module):
    """The low branch's serving apply: K1 on weights folded once.
    x (N, H, W, 3) float -> (N, H, W, 3) float32."""

    def __init__(self, chain: LightweightChainWeights):
        super().__init__()
        self.chain = chain

    def forward(self, x):
        return lightweight_chain(x.float(), self.chain)


class ModulePathApply(nn.Module):
    """The low branch's `canonical` serving candidate: a serving copy (as
    `cast_for_serving` makes it) run through its modules, never kernel K1,
    as the JAX package's `canonical` is the plain `model.apply`.
    x (N, H, W, 3) float -> (N, H, W, 3) float32."""

    def __init__(self, model: LightweightDehazeModel, dtype: torch.dtype):
        super().__init__()
        self.model = cast_for_serving(model, dtype)

    def forward(self, x):
        return self.model.module_forward(x)


def cast_for_serving(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """An eval-mode copy of `module` whose conv and linear weights are in
    `dtype`; BN and other parameters (skip_alpha) stay float32. The
    original module is left as it is."""
    m = copy.deepcopy(module).eval().requires_grad_(False)
    for sub in m.modules():
        if isinstance(sub, _CAST):
            sub.to(dtype)
    return m


# kind -> (the branch's class, the tail kernel's wrapper, its fold).
_TAILS = {
    "medium": (MediumIntensityDehazeModel, medium_tail_chain, fold_medium_tail),
    "high": (HighIntensityDehazeModel, high_tail_chain, fold_high_tail),
}
# Channels (in units of the base width) and downscale of each segment.
_SEGMENT_SHAPES = {"e1": (2, 2), "e2b": (4, 4), "d1": (2, 2)}


def chain_apply_supported(base_channels: int, height: int, width: int,
                          dtype: torch.dtype, segments=(), tail: bool = False) -> bool:
    """Whether `BranchChainApply` takes a branch of this width at this image
    size: sides that are multiples of 4 (the decoder's stages are then exact
    halves and the canonical forward's resize steps never run), and every
    chosen kernel takes its shape."""
    if height % 4 or width % 4 or height < 4 or width < 4:
        return False
    if tail and not tail_supported(base_channels, height, width, dtype):
        return False
    return all(res_chain_supported(mult * base_channels, height // down, width // down,
                                   dtype)
               for mult, down in (_SEGMENT_SHAPES[s] for s in segments))


class _ResChainSegment(nn.Module):
    """A segment's blocks on kernel K6, folded once. NCHW (channels_last
    memory) in and out, like the blocks it stands for."""

    def __init__(self, blocks, dtype: torch.dtype):
        super().__init__()
        self.weights = fold_res_attn_chain(blocks, dtype)

    def forward(self, v):
        # A no-op for the branches' channels_last activations: the NHWC
        # view is free.
        v = v.contiguous(memory_format=torch.channels_last)
        return res_attn_chain(v.permute(0, 2, 3, 1), self.weights).permute(0, 3, 1, 2)


class BranchChainApply(nn.Module):
    """A medium or high branch (`kind`) with the segments named in
    `segments` (drawn from "e1", "e2b", "d1") on kernel K6 and, with `tail`,
    everything after the d1 concat on kernel K3 or K4; all else is the
    serving copy's canonical modules (K2 inside the high branch's
    AttentionBlocks that stay canonical). Kernel weights are folded once
    from the float32 parameters. x (N, H, W, 3) float -> (N, H, W, 3)
    float32, or this process's H shard of them under spatial_sharding.
    Raises on a shape a chosen kernel does not take, and on a size the
    canonical forward would resize (`chain_apply_supported`, at the shape
    of x)."""

    def __init__(self, model: nn.Module, dtype: torch.dtype, kind: str,
                 segments=(), tail: bool = False):
        super().__init__()
        cls, tail_fn, fold_tail = _TAILS[kind]
        if not isinstance(model, cls):
            raise TypeError(f"expected a {cls.__name__}, got {type(model).__name__}")
        unknown = set(segments) - set(SEGMENTS)
        if unknown:
            raise ValueError(f"unknown segments {sorted(unknown)}: drawn from {SEGMENTS}")
        self.segments = tuple(s for s in SEGMENTS if s in set(segments))
        self.dtype = dtype
        self.base_channels = model.base_channels
        copy_ = cast_for_serving(model, dtype)
        self.init_conv = copy_.init_conv
        self.down1, self.down2 = copy_.encoder[0][0], copy_.encoder[1][0]
        self.up0 = nn.Sequential(*list(copy_.decoder[0])[:3])   # convT, BN, ReLU
        for seg in SEGMENTS:
            body = (_ResChainSegment(segment_blocks(model, seg), dtype)
                    if seg in self.segments
                    else nn.Sequential(*segment_blocks(copy_, seg)))
            setattr(self, seg, body)
        self.tail = tail_fn if tail else None
        if tail:
            self.tail_weights = fold_tail(model, dtype)
        else:
            self.up1 = copy_.decoder[1]
            self.output_conv = copy_.output_conv
            self.detail_branch = copy_.detail_branch if kind == "high" else None

    def forward(self, x):
        _, h, w, _ = x.shape
        if not chain_apply_supported(self.base_channels, h, w, self.dtype,
                                     self.segments, self.tail is not None):
            raise ValueError(
                f"the chain apply (segments {self.segments}, tail "
                f"{self.tail is not None}) does not take width {self.base_channels} "
                f"at {h}x{w} in {self.dtype}: see chain_apply_supported, "
                f"tail_supported and res_chain_supported")
        xin = x.to(self.dtype).permute(0, 3, 1, 2)
        f0 = self.init_conv(xin)
        e1 = self.e1(self.down1(f0))
        d1 = self.d1(self.up0(self.e2b(self.down2(e1))))
        d1 = torch.cat([d1, e1], dim=1)
        if self.tail is not None:
            # NCHW in channels_last memory: the NHWC views are free.
            return self.tail(d1.permute(0, 2, 3, 1), f0.permute(0, 2, 3, 1),
                             x.float(), self.tail_weights)
        res = torch.tanh(self.output_conv(torch.cat([self.up1(d1), f0], dim=1)))
        if self.detail_branch is not None:
            res = res * self.detail_branch(xin)
        return torch.clamp(xin + res, 0.0, 1.0).permute(0, 2, 3, 1).float().contiguous()


def make_medium_tail_apply(model: nn.Module, dtype: torch.dtype = torch.bfloat16
                           ) -> nn.Module:
    """The medium branch with everything after the d1 concat on kernel K3."""
    return BranchChainApply(model, dtype, "medium", tail=True)


def make_high_tail_apply(model: nn.Module, dtype: torch.dtype = torch.bfloat16
                         ) -> nn.Module:
    """The high branch with everything after the d1 concat on kernel K4
    (its spatial step on K2')."""
    return BranchChainApply(model, dtype, "high", tail=True)


def make_medium_chain_apply(model: nn.Module, dtype: torch.dtype = torch.bfloat16
                            ) -> nn.Module:
    """The medium branch with its three residual segments on kernel K6 and
    everything else canonical."""
    return BranchChainApply(model, dtype, "medium", segments=SEGMENTS)


def make_high_chain_apply(model: nn.Module, dtype: torch.dtype = torch.bfloat16,
                          res_chain=("e2b",), tail_chain: bool = False) -> nn.Module:
    """The high branch with the segments in `res_chain` (True: all three;
    None or False: none; else a collection drawn from "e1", "e2b", "d1") on
    kernel K6 and, with `tail_chain`, everything after the d1 concat on K4.
    The JAX package's space-to-depth prefix is not carried."""
    if res_chain is True:
        res_chain = SEGMENTS
    return BranchChainApply(model, dtype, "high", segments=tuple(res_chain or ()),
                            tail=tail_chain)


def _chain_apply(model: nn.Module, dtype: torch.dtype) -> Optional[nn.Module]:
    if not isinstance(model, LightweightDehazeModel):
        return None
    chain = model.serving_chain(dtype)
    return None if chain is None else LightweightChainApply(chain)


def make_serving_apply(model: nn.Module, dtype: torch.dtype = torch.bfloat16
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fastest exact eval-mode apply of a branch: x (N, H, W, 3) float ->
    dehazed (N, H, W, 3) float32."""
    apply = _chain_apply(model, dtype)
    return apply if apply is not None else cast_for_serving(model, dtype)


def make_classifier_serving_apply(classifier: nn.Module,
                                  dtype: torch.dtype = torch.bfloat16
                                  ) -> Callable[[torch.Tensor], tuple]:
    """Eval-mode apply of the fog classifier in the compute dtype:
    x -> (logits f32, features f32)."""
    return cast_for_serving(classifier, dtype)


def make_router_serving_apply(router: nn.Module,
                              dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """One serving copy of a router (soft or hard): its classifier and
    branches as make_classifier_serving_apply and make_serving_apply give
    them, under the router's own forward."""
    serving = cast_for_serving(router, dtype)
    for name, model in router.models.items():
        apply = _chain_apply(model, dtype)
        if apply is not None:
            serving.models[name] = apply
    return serving
