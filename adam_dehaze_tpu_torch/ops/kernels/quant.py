"""Q1 and Q2: the int8 serving path's kernels (csrc/int8_conv.cu).

They replace AQT's int8 conv, which the JAX package swaps into every
ConvBlock (adam_dehaze_tpu/ops/quant.py:34 `_make_int8_conv`); that conv is
XLA's, not a Pallas kernel. The arithmetic is ops/quant.py's.

`quantize_images` (Q1) takes x (N, H, W, C) NHWC in the compute dtype and
writes q (N, H, W, cin_pad) int8, its channels zero-padded to the conv's
K step, with one scale per image (N,) float32 (holding a value of x's
dtype). On a CUDA tensor that is two launches: the per-image abs-max (block
partials, then an atomic max on the float's bits) and the quantizing pass.

`int8_conv` (Q2) is an implicit-GEMM convolution: rows are output pixels,
columns output channels, K runs over (ky, kx, ci) with ci padded to
`cin_pad`. The weights are packed once, OHWI, as (cout_pad, k_pad) int8:
K-major, as the int8 tensor-core operands must be (the transpose bits of
wgmma exist only for 16-bit types). Products are summed in int32 by
`mma.sync.m16n8k32.s32.s8.s8.s32`; the epilogue casts the sum to the
compute dtype and multiplies by the image's and the channel's scale in
AQT's order, adds the bias, and writes NHWC in the compute dtype.

On a CPU tensor each wrapper is its plain version; on a CUDA tensor it
launches its kernel or raises. Both count their calls on the card
(`quantize_images.launches`, `int8_conv.launches`). `ConvGeometry.cin_pad`
and `k_pad` mirror the kernel's loader: channels padded to 4 when there are
at most 4 (one 4-byte copy a tap), else to a multiple of 16 (16-byte copies
that never straddle a tap); K to a multiple of the MMA's 32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.quant import int8_conv_reference, quantize_per_image

# Mirror of csrc/int8_conv.cu: the output-channel tile that the packed
# weights are padded to, and the K step.
TILE_N = 64
K_STEP = 32


class ConvGeometry(NamedTuple):
    """One ConvBlock conv as Q2 takes it."""
    cin: int
    cin_pad: int
    cout: int
    cout_pad: int
    kh: int
    kw: int
    stride: int
    padding: int
    k_pad: int

    @classmethod
    def of(cls, cin: int, cout: int, kh: int, kw: int, stride: int,
           padding: int) -> "ConvGeometry":
        cin_pad = 4 if cin <= 4 else -(-cin // 16) * 16
        return cls(cin, cin_pad, cout, -(-cout // TILE_N) * TILE_N, kh, kw, stride,
                   padding, -(-(kh * kw * cin_pad) // K_STEP) * K_STEP)

    def out_size(self, h: int, w: int):
        return ((h + 2 * self.padding - self.kh) // self.stride + 1,
                (w + 2 * self.padding - self.kw) // self.stride + 1)


def pack_int8_weights(qw: torch.Tensor, g: ConvGeometry) -> torch.Tensor:
    """qw (Cout, Cin, kh, kw) int8 -> (cout_pad, k_pad) int8: OHWI with Cin
    zero-padded to cin_pad, the rows and K zero-padded to the tiles."""
    ohwi = F.pad(qw.permute(0, 2, 3, 1), (0, g.cin_pad - g.cin))
    flat = ohwi.reshape(g.cout, g.kh * g.kw * g.cin_pad)
    return F.pad(flat, (0, g.k_pad - flat.shape[1], 0, g.cout_pad - g.cout)).contiguous()


def unpack_int8_weights(packed: torch.Tensor, g: ConvGeometry) -> torch.Tensor:
    """The inverse of `pack_int8_weights` over the padded input channels:
    (Cout, cin_pad, kh, kw) int8."""
    k = g.kh * g.kw * g.cin_pad
    return packed[:g.cout, :k].reshape(g.cout, g.kh, g.kw, g.cin_pad).permute(0, 3, 1, 2)


def quantize_images_reference(x: torch.Tensor, cin_pad: int):
    """Plain version of Q1: `quantize_per_image`, the channels zero-padded
    to `cin_pad`, the scales as float32."""
    q, scale = quantize_per_image(x)
    return F.pad(q, (0, cin_pad - x.shape[-1])).contiguous(), scale.float()


def quantize_images(x: torch.Tensor, cin_pad: int):
    """Q1: x (N, H, W, C) NHWC float32 or bfloat16 -> (q (N, H, W, cin_pad)
    int8, scale (N,) float32). A CPU tensor takes the plain version; a CUDA
    tensor (contiguous, 16-byte aligned) launches the kernel."""
    if x.device.type == "cpu":
        return quantize_images_reference(x, cin_pad)
    name = "quantize_images"
    _build.require_cuda_inputs(name, x)
    _build.require(x.dim() == 4, name, f"x must be (N, H, W, C), got {tuple(x.shape)}")
    _build.require(x.dtype in (torch.float32, torch.bfloat16), name,
                   f"x dtype {x.dtype} not float32/bfloat16")
    _build.require(x.is_contiguous(), name, "x must be contiguous NHWC")
    _build.require(x.data_ptr() % 16 == 0, name, "x must be 16-byte aligned")
    n, h, w, c = x.shape
    _build.require(cin_pad >= c and cin_pad % 4 == 0, name,
                   f"cin_pad {cin_pad} must be a multiple of 4 and at least C={c}")
    q = torch.empty((n, h, w, cin_pad), dtype=torch.int8, device=x.device)
    scale = torch.empty((n,), dtype=torch.float32, device=x.device)
    amax = torch.empty((n,), dtype=torch.int32, device=x.device)
    err = _build.library().int8_quantize(
        x.data_ptr(), amax.data_ptr(), q.data_ptr(), scale.data_ptr(), n, h * w, c,
        cin_pad, int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, name)
    quantize_images.launches += 1
    return q, scale


quantize_images.launches = 0


def int8_conv_packed_reference(q: torch.Tensor, sx: torch.Tensor, qweight: torch.Tensor,
                               wscale: torch.Tensor, bias: Optional[torch.Tensor],
                               g: ConvGeometry, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of Q2 on the kernel's operands (the padded channels
    hold zeros on both sides)."""
    return int8_conv_reference(q, sx, unpack_int8_weights(qweight, g), wscale[:g.cout],
                               g.stride, g.padding, bias, out_dtype)


def int8_conv(q: torch.Tensor, sx: torch.Tensor, qweight: torch.Tensor,
              wscale: torch.Tensor, bias: Optional[torch.Tensor], g: ConvGeometry,
              out_dtype: torch.dtype) -> torch.Tensor:
    """Q2: q (N, H, W, cin_pad) int8 and sx (N,) float32 from Q1, the packed
    weights (cout_pad, k_pad) int8, their scales (cout,) float32 and the bias
    (cout,) float32 or None -> (N, Ho, Wo, cout) NHWC in `out_dtype`
    (float32 or bfloat16). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if q.device.type == "cpu":
        return int8_conv_packed_reference(q, sx, qweight, wscale, bias, g, out_dtype)
    name = "int8_conv"
    extra = (bias,) if bias is not None else ()
    _build.require_cuda_inputs(name, q, sx, qweight, wscale, *extra)
    _build.require(out_dtype in (torch.float32, torch.bfloat16), name,
                   f"out_dtype {out_dtype} not float32/bfloat16")
    _build.require(q.dtype == torch.int8 and qweight.dtype == torch.int8, name,
                   "q and the weights must be int8")
    _build.require(q.dim() == 4 and q.shape[3] == g.cin_pad and q.is_contiguous(), name,
                   f"q must be contiguous (N, H, W, {g.cin_pad}), got {tuple(q.shape)}")
    _build.require(q.data_ptr() % 16 == 0 and qweight.data_ptr() % 16 == 0, name,
                   "q and the weights must be 16-byte aligned")
    _build.require(tuple(qweight.shape) == (g.cout_pad, g.k_pad) and qweight.is_contiguous(),
                   name, f"weights must be packed ({g.cout_pad}, {g.k_pad})")
    for t, what in ((sx, "sx"), (wscale, "wscale"), *((b, "bias") for b in extra)):
        _build.require(t.dtype == torch.float32 and t.is_contiguous(), name,
                       f"{what} must be contiguous float32")
    n, h, w, _ = q.shape
    ho, wo = g.out_size(h, w)
    out = torch.empty((n, ho, wo, g.cout), dtype=out_dtype, device=q.device)
    err = _build.library().int8_conv(
        q.data_ptr(), qweight.data_ptr(), sx.data_ptr(), wscale.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(), n, h, w, g.cin_pad,
        ho, wo, g.cout, g.cout_pad, g.k_pad, g.kh, g.kw, g.stride, g.padding,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(err, name)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
