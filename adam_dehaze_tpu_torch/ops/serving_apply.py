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

`make_medium_tail_apply` and `make_high_tail_apply` (counterparts of
`make_medium_s2d_apply(..., tail_chain=True)` and
`make_high_s2d_apply(..., tail_chain=True)`) run a branch's prefix
(`init_conv`, `encoder`, `bottleneck`, `decoder[0]`, the concat with e1) on
the serving copy's canonical modules and everything after it on kernel K3
or K4, folded once. The serving autotune (serving_autotune.py) offers them
as the `tail_chain` candidates; the default dispatch does not use them.

`make_router_serving_apply` builds one serving copy of a whole router from
the same applies; soft routing calls it and the hard-routing engine takes
its classifier and branches, so both paths share one fold and one cast.

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


def cast_for_serving(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """An eval-mode copy of `module` whose conv and linear weights are in
    `dtype`; BN and other parameters (skip_alpha) stay float32. The
    original module is left as it is."""
    m = copy.deepcopy(module).eval().requires_grad_(False)
    for sub in m.modules():
        if isinstance(sub, _CAST):
            sub.to(dtype)
    return m


# kind -> (the branch's class, the kernel's wrapper, its fold).
_TAILS = {
    "medium": (MediumIntensityDehazeModel, medium_tail_chain, fold_medium_tail),
    "high": (HighIntensityDehazeModel, high_tail_chain, fold_high_tail),
}


class TailChainApply(nn.Module):
    """A medium or high branch (`kind`) with its tail on kernel K3 or K4:
    the prefix is the serving copy's canonical modules (K2 inside the high
    branch's AttentionBlocks), the tail the kernel on weights folded once
    from the float32 parameters. x (N, H, W, 3) float -> (N, H, W, 3)
    float32. Raises on a size the tail does not take (the canonical forward
    resizes there; the tail has no such step)."""

    def __init__(self, model: nn.Module, dtype: torch.dtype, kind: str):
        super().__init__()
        cls, self.tail, fold_tail = _TAILS[kind]
        if not isinstance(model, cls):
            raise TypeError(f"expected a {cls.__name__}, got {type(model).__name__}")
        self.weights = fold_tail(model, dtype)
        self.dtype = dtype
        self.base_channels = model.base_channels
        copy_ = cast_for_serving(model, dtype)
        self.init_conv = copy_.init_conv
        self.encoder = copy_.encoder
        self.bottleneck = copy_.bottleneck
        self.up0 = copy_.decoder[0]

    def forward(self, x):
        _, h, w, _ = x.shape
        if not tail_supported(self.base_channels, h, w, self.dtype):
            raise ValueError(
                f"the tail chain does not take width {self.base_channels} at "
                f"{h}x{w} in {self.dtype}: see tail_supported")
        xin = x.to(self.dtype).permute(0, 3, 1, 2)
        f0 = self.init_conv(xin)
        e1 = self.encoder[0](f0)
        d1 = self.up0(self.bottleneck(self.encoder[1](e1)))
        d1 = torch.cat([d1, e1], dim=1)
        # NCHW in channels_last memory: the NHWC views are free.
        return self.tail(d1.permute(0, 2, 3, 1), f0.permute(0, 2, 3, 1),
                         x.float(), self.weights)


def make_medium_tail_apply(model: nn.Module, dtype: torch.dtype = torch.bfloat16
                           ) -> nn.Module:
    """The medium branch with everything after the d1 concat on kernel K3."""
    return TailChainApply(model, dtype, "medium")


def make_high_tail_apply(model: nn.Module, dtype: torch.dtype = torch.bfloat16
                         ) -> nn.Module:
    """The high branch with everything after the d1 concat on kernel K4
    (its spatial step on K2')."""
    return TailChainApply(model, dtype, "high")


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
