"""K2 and K2': the fused CBAM gate of AttentionBlock.

Counterpart of adam_dehaze_tpu/ops/pallas/cbam.py: `channel_spatial_gate`
computes

    out = (x * g) * sigmoid(conv7x7([mean_c, max_c](x * g)))   zero pad 3

for x (B, H, W, C) NHWC, the channel gate g (B, C) and the stencil
w (7, 7, 2, 1) in the JAX layout (HWIO). On a CUDA tensor a call is two
launches of csrc/cbam_gate.cu and no PyTorch reduction: the statistics pass
(`gated_maps`) reads x once and writes the zero-padded f32 (mean, max) maps
of the gated tensor, which XLA reduced on the TPU; the gate kernel
(replacing the TPU kernel `_kernel_cgate`) then reads x once, applies both
gates, and writes once. `padded_stats` is the plain version of the
statistics pass. The JAX wrapper gave way to XLA when VMEM was too small;
that limit was the TPU's and has no counterpart here. Memory bound: see the
source note in csrc/cbam_gate.cu.

`spatial_gate` (K2', replacing the TPU kernel `_kernel` of
`spatial_gate_pallas`) is the same with the channel gate fixed at 1:

    out = x * sigmoid(conv7x7([mean_c, max_c](x)))

through its own entry point of the C library, which never reads a gate. The
high branch's tail chain (ops/kernels/tail_chain.py) launches it for its
spatial step through `launch_spatial_gate`.

`channel_spatial_gate` is differentiable (a torch.autograd.Function whose
backward is the VJP of the plain version), so the high branch trains
through K2. `spatial_gate` is forward-only: its gradient comes with the
joint trainer.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.ops.kernels import _build

_HALO = 3


def channel_spatial_gate_reference(x: torch.Tensor, g: torch.Tensor,
                                   w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the JAX package's
    `channel_spatial_gate_reference` (gate, stats and stencil in x.dtype)."""
    gated = x * g.to(x.dtype)[:, None, None, :]
    stats = torch.stack([gated.mean(dim=-1), gated.amax(dim=-1)], dim=1)
    gate = F.conv2d(stats, w.to(x.dtype).permute(3, 2, 0, 1), padding=_HALO)
    return gated * torch.sigmoid(gate).permute(0, 2, 3, 1)


def spatial_gate_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2': the JAX package's
    `spatial_gate_reference` (stats and stencil in x.dtype)."""
    stats = torch.stack([x.mean(dim=-1), x.amax(dim=-1)], dim=1)
    gate = F.conv2d(stats, w.to(x.dtype).permute(3, 2, 0, 1), padding=_HALO)
    return x * torch.sigmoid(gate).permute(0, 2, 3, 1)


def padded_stats(x: torch.Tensor, g: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the statistics pass: the f32 (mean, max)
    maps of x * g (of x when g is None) over channels, zero-padded by the
    stencil's halo on every side: (B, H+6, W+6) each."""
    gated = x.float()
    if g is not None:
        gated = gated * g.float()[:, None, None, :]
    pad = (_HALO, _HALO, _HALO, _HALO)
    return (F.pad(gated.mean(dim=-1), pad).contiguous(),
            F.pad(gated.amax(dim=-1), pad).contiguous())


def gated_maps(x: torch.Tensor, g: Optional[torch.Tensor] = None):
    """The statistics pass of K2 (of K2' when g is None): what
    `padded_stats` computes. A CPU tensor takes that plain version; a CUDA
    tensor (contiguous NHWC, C a multiple of 8, g f32 contiguous) launches
    the kernel, which reads x once and writes only the maps."""
    if x.device.type == "cpu":
        return padded_stats(x, g)
    b, h, wd, c = x.shape
    maps = torch.empty((2, b, h + 2 * _HALO, wd + 2 * _HALO), dtype=torch.float32,
                       device=x.device)
    err = _build.library().cbam_gated_maps(
        x.data_ptr(), g.data_ptr() if g is not None else None, maps[0].data_ptr(),
        maps[1].data_ptr(), b, h, wd, c, int(x.dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(err, "cbam_gated_maps")
    return maps[0], maps[1]


def launch_cbam_gate(x, g, mean_p, max_p, w, out) -> None:
    """Enqueue the kernel on prepared inputs (see `channel_spatial_gate`)."""
    b, h, wd, c = x.shape
    err = _build.library().cbam_gate(
        x.data_ptr(), g.data_ptr(), mean_p.data_ptr(), max_p.data_ptr(),
        w.data_ptr(), out.data_ptr(), b, h, wd, c,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, "cbam_gate")
    channel_spatial_gate.launches += 1


def launch_spatial_gate(x, mean_p, max_p, w, out) -> None:
    """Enqueue K2' on prepared inputs: x (B, H, W, C) contiguous, the f32
    maps of x padded by 3, w (7, 7, 2) f32 contiguous, out like x."""
    b, h, wd, c = x.shape
    err = _build.library().spatial_gate(
        x.data_ptr(), mean_p.data_ptr(), max_p.data_ptr(), w.data_ptr(),
        out.data_ptr(), b, h, wd, c, int(x.dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(err, "spatial_gate")
    spatial_gate.launches += 1


def _require_gate_input(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    _build.require(x.dim() == 4, name, f"x must be (B, H, W, C), got {tuple(x.shape)}")
    _build.require(x.dtype in (torch.float32, torch.bfloat16), name,
                   f"x dtype {x.dtype} not float32/bfloat16")
    _build.require(x.is_contiguous(), name, "x must be contiguous NHWC")
    _build.require(x.data_ptr() % 16 == 0, name, "x must be 16-byte aligned")
    _build.require(x.shape[3] % 8 == 0, name,
                   f"C={x.shape[3]} is not a multiple of 8")
    _build.require(tuple(w.shape) == (7, 7, 2, 1), name,
                   f"w must be (7, 7, 2, 1), got {tuple(w.shape)}")


def spatial_gate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The spatial CBAM gate alone. x: (B, H, W, C) NHWC; w: (7, 7, 2, 1).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, which takes what `channel_spatial_gate` takes."""
    if x.device.type == "cpu":
        return spatial_gate_reference(x, w)
    name = "spatial_gate"
    _build.require_cuda_inputs(name, x, w)
    _require_gate_input(name, x, w)
    mean_p, max_p = gated_maps(x)
    out = torch.empty_like(x)
    launch_spatial_gate(x, mean_p, max_p, w.float().contiguous(), out)
    return out


spatial_gate.launches = 0


def _cbam_gate_cuda(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The two launches of K2 on CUDA tensors (raises on inputs the kernel
    does not take)."""
    name = "channel_spatial_gate"
    _build.require_cuda_inputs(name, x, g, w)
    _require_gate_input(name, x, w)
    b, _, _, c = x.shape
    _build.require(tuple(g.shape) == (b, c), name,
                   f"g must be {(b, c)}, got {tuple(g.shape)}")
    g = g.float().contiguous()
    mean_p, max_p = gated_maps(x, g)
    out = torch.empty_like(x)
    launch_cbam_gate(x, g, mean_p, max_p, w.float().contiguous(), out)
    return out


def _gate_forward(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K2's forward: the kernel on a CUDA tensor, the plain version (outside
    autocast) on a CPU tensor."""
    if x.device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            return channel_spatial_gate_reference(x, g, w)
    return _cbam_gate_cuda(x, g, w)


class _ChannelSpatialGate(torch.autograd.Function):
    """K2 with a gradient, as the JAX package's `jax.custom_vjp` of
    `channel_spatial_gate`: the forward is the kernel on a CUDA tensor (the
    plain version on a CPU tensor); the backward is the VJP of the plain
    version at the saved (x, g, w), by autograd, recomputing its forward as
    `_cs_gate_bwd` does with `jax.vjp`. The JAX package has no backward
    kernel. Both run outside autocast, in the dtypes the inputs came in (under
    autocast x and g arrive in the compute dtype, w already rounded to it)."""

    @staticmethod
    def forward(ctx, x, g, w):
        ctx.save_for_backward(x, g, w)
        return _gate_forward(x, g, w)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        with torch.enable_grad(), torch.autocast(dy.device.type, enabled=False):
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(
                channel_spatial_gate_reference(*inputs), wanted, dy))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def channel_spatial_gate(x: torch.Tensor, g: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """Both CBAM gates in one pass, differentiable. x: (B, H, W, C) NHWC;
    g: (B, C); w: (7, 7, 2, 1). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (never the plain version), which takes
    float32 or bfloat16 x, contiguous, with C a multiple of 8. The backward
    differentiates the plain version (see `_ChannelSpatialGate`). With no
    gradient to record (inference, or inputs that need none) the same
    forward runs without the Function, whose dispatch costs host time on
    every serving call."""
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad or w.requires_grad):
        return _ChannelSpatialGate.apply(x, g, w)
    return _gate_forward(x, g, w)


channel_spatial_gate.launches = 0
