"""K5: the soft router's three-way blend, in Triton.

Counterpart of adam_dehaze_tpu/ops/pallas/blend.py (`blend3_pallas`, kernel
`_kernel`):

    out[n] = w[n, 0] * low[n] + w[n, 1] * med[n] + w[n, 2] * high[n]

What bounds it on an H100: memory only, three tensors read and one written
with three FMAs per element and no reuse, so Triton serves as well as CUDA
C++ here. Design: one program per (image, chunk of BLOCK elements of that
image's H*W*C), the image's three weights loaded once per program, a masked
tail. The TPU version viewed images as (B, H, W*C) to fill 128-lane vregs;
a flat chunk already gives coalesced 16-byte accesses.

`blend3` is differentiable, as the JAX package's `jax.custom_vjp` of
`blend3`: with a gradient to record it runs as `_Blend3`, whose forward is
the kernel (the plain version on a CPU tensor) and whose backward is the
analytic formula of `_blend3_bwd` in plain PyTorch (the JAX package's
backward is XLA, not a kernel):

    d w[n, i] = sum(g[n] * y_i[n])      (in f32, returned in w's dtype)
    d y_i[n]  = w[n, i] * g[n]          (w cast to g's dtype)

`triton` is imported only when a CUDA tensor launches the kernel.
"""
from __future__ import annotations

import functools
import os

import torch

from adam_dehaze_tpu_torch.ops.kernels import _build

_BLOCK = 4096


def blend3_reference(weights: torch.Tensor, low: torch.Tensor,
                     med: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version; weights are cast to the images' dtype first,
    as the JAX kernel does."""
    w = weights[:, :, None, None, None].to(low.dtype)
    return w[:, 0] * low + w[:, 1] * med + w[:, 2] * high


@functools.lru_cache(maxsize=1)
def _kernel():
    # Triton's JIT cache goes beside the CUDA build, inside the checkout.
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_ROOT.parent / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def blend3_kernel(w_ptr, a_ptr, b_ptr, c_ptr, out_ptr, per_image,
                      BLOCK: tl.constexpr):
        n = tl.program_id(0)
        chunk = tl.program_id(1)
        w0 = tl.load(w_ptr + n * 3)
        w1 = tl.load(w_ptr + n * 3 + 1)
        w2 = tl.load(w_ptr + n * 3 + 2)
        offs = chunk * BLOCK + tl.arange(0, BLOCK)
        mask = offs < per_image
        base = n.to(tl.int64) * per_image
        a = tl.load(a_ptr + base + offs, mask=mask).to(tl.float32)
        b = tl.load(b_ptr + base + offs, mask=mask).to(tl.float32)
        c = tl.load(c_ptr + base + offs, mask=mask).to(tl.float32)
        y = a * w0 + b * w1 + c * w2
        tl.store(out_ptr + base + offs, y.to(out_ptr.dtype.element_ty),
                 mask=mask)

    return triton, blend3_kernel


def _blend3_cuda(weights: torch.Tensor, low: torch.Tensor, med: torch.Tensor,
                 high: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors of one dtype (raises on
    inputs the kernel does not take)."""
    name = "blend3"
    _build.require_cuda_inputs(name, weights, low, med, high)
    _build.require(low.shape == med.shape == high.shape, name,
                   "low/med/high shapes differ")
    _build.require(low.dtype in (torch.float32, torch.bfloat16), name,
                   f"dtype {low.dtype} not float32/bfloat16")
    _build.require(all(t.is_contiguous() for t in (low, med, high)), name,
                   "images must be contiguous")
    _build.require(tuple(weights.shape) == (low.shape[0], 3), name,
                   f"weights must be {(low.shape[0], 3)}, got {tuple(weights.shape)}")
    triton, kernel = _kernel()
    w = weights.to(low.dtype).float().contiguous()
    out = torch.empty_like(low)
    per_image = low[0].numel()
    grid = (low.shape[0], triton.cdiv(per_image, _BLOCK))
    kernel[grid](w, low, med, high, out, per_image, BLOCK=_BLOCK)
    blend3.launches += 1
    return out


def _blend3_forward(weights, low, med, high):
    """K5's forward: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if low.device.type == "cpu":
        return blend3_reference(weights, low, med, high)
    return _blend3_cuda(weights, low, med, high)


class _Blend3(torch.autograd.Function):
    """K5 with a gradient: the forward of `_blend3_forward`, the backward
    `_blend3_bwd`'s analytic formula (see the module docstring)."""

    @staticmethod
    def forward(ctx, weights, low, med, high):
        ctx.save_for_backward(weights, low, med, high)
        return _blend3_forward(weights, low, med, high)

    @staticmethod
    def backward(ctx, g):
        weights, *ys = ctx.saved_tensors
        gw = None
        if ctx.needs_input_grad[0]:
            gf = g.float()
            gw = torch.stack([(gf * y.float()).flatten(1).sum(1) for y in ys],
                             dim=1).to(weights.dtype)
        wb = weights.to(g.dtype).reshape(*weights.shape, *(1,) * (g.dim() - 1))
        dys = [(wb[:, i] * g).to(y.dtype) if ctx.needs_input_grad[i + 1] else None
               for i, y in enumerate(ys)]
        return (gw, *dys)


def blend3(weights: torch.Tensor, low: torch.Tensor, med: torch.Tensor,
           high: torch.Tensor) -> torch.Tensor:
    """weights: (B, 3); low/med/high: (B, ...) of one shape; they are
    promoted to one dtype first (under autocast the branches may return
    different ones). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (float32 or bfloat16, contiguous), never the plain
    version. Differentiable (`_Blend3`); with no gradient to record the
    same forward runs without the Function, whose dispatch costs host time
    on every serving call."""
    dtype = torch.promote_types(torch.promote_types(low.dtype, med.dtype), high.dtype)
    low, med, high = (t.to(dtype) for t in (low, med, high))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (weights, low, med, high)):
        return _Blend3.apply(weights, low, med, high)
    return _blend3_forward(weights, low, med, high)


blend3.launches = 0
