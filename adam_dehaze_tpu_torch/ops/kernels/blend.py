"""K5: the soft router's three-way blend, in Triton.

Counterpart of adam_dehaze_tpu/ops/pallas/blend.py (`blend3_pallas`, kernel
`_kernel`):

    out[n] = w[n, 0] * low[n] + w[n, 1] * med[n] + w[n, 2] * high[n]

What bounds it on an H100: memory only, three tensors read and one written
with three FMAs per element and no reuse, so Triton serves as well as CUDA
C++ here. Design: one program per (image, chunk of BLOCK elements of that
image's H*W*C), the image's three weights loaded once per program, a masked
tail. The TPU version viewed images as (B, H, W*C) to fill 128-lane vregs;
a flat chunk already gives coalesced 16-byte accesses. Forward only: the
analytic backward (`_blend3_bwd`) comes with training.

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


def blend3(weights: torch.Tensor, low: torch.Tensor, med: torch.Tensor,
           high: torch.Tensor) -> torch.Tensor:
    """weights: (B, 3); low/med/high: (B, ...) of one shape and dtype. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (float32 or bfloat16, contiguous)."""
    if low.device.type == "cpu":
        return blend3_reference(weights, low, med, high)
    name = "blend3"
    _build.require_cuda_inputs(name, weights, low, med, high)
    _build.require(low.shape == med.shape == high.shape, name,
                   "low/med/high shapes differ")
    _build.require(low.dtype == med.dtype == high.dtype, name,
                   "low/med/high dtypes differ")
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


blend3.launches = 0
