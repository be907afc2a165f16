"""Q1 and Q2: the int8 serving path's kernels (csrc/int8_conv.cu).

They replace AQT's int8 conv, which the JAX package swaps into every
ConvBlock (adam_dehaze_tpu/ops/quant.py:34 `_make_int8_conv`); that conv is
XLA's, not a Pallas kernel. The arithmetic is ops/quant.py's.

`quantize_images` (Q1) takes x (N, H, W, C) NHWC in the compute dtype and
writes q (N, H, W, cin_pad) int8, its channels zero-padded to the conv's
K step, with one scale per image (N,) float32 (holding a value of x's
dtype). On a CUDA tensor that is one cooperative launch: the abs-max of
every image, a wait over the grid, then the quantizing pass in reverse,
the bytes read last (still in L2) first. Where a group of processes holds
each image's rows (an H shard, parallel/spatial.py), Q1 runs as its two
passes: `image_absmax` (this process's abs-max of each image), a max over
the group (the caller's), then `quantize_images_at` at the group's
abs-max, which gives the one launch's scale and int8 values bit for bit.

`int8_conv` (Q2) is a convolution on int8 tensor cores with int32 sums and
an epilogue that dequantises in AQT's order (the sum cast to the compute
dtype, times the image's scale, times the channel's scale, plus the bias),
then applies the ConvBlock's eval BN and its ReLU, and writes NHWC in the
compute dtype. Both int8 operands are K-major (the transpose bits of wgmma
exist only for 16-bit types). `ConvGeometry.of` names the body a layer
takes, by its shape alone:

- "tile": 3x3 stride 1 pad 1 and 4x4 stride 2 pad 1 convs with at least
  TILE_MIN_CIN input channels and a multiple of 16 output channels.
  `wgmma` m64nNk32 s8, N the widest of TILE_CHUNKS that divides Cout (96
  at 3x3 only), two blocks an SM; input channels padded to 32 (one k32
  step a tap and stage); the weights packed as one contiguous slab per
  (output chunk, stage) in the slot's layout (`pack_int8_weights`).
- "gather": every other conv (the RGB inputs of the stems and first
  convs, other kernel sizes). `mma.sync` m16n8k32 on 128 x 64 tiles of a
  gathered im2col; channels padded to 4 when there are at most 4 (one
  4-byte copy a tap), else to a multiple of 16; the weights OHWI as
  (cout_pad, k_pad), Cout padded to 64 and K to 32.

On a CPU tensor each wrapper is its plain version (run under
`sharded_ops.local_ops()`: the layer prepared its shard itself); on a CUDA
tensor it launches its kernel or raises (no body stands in for the other).
Each counts its launches on the card (`quantize_images.launches`,
`image_absmax.launches`, `quantize_images_at.launches`,
`int8_conv.launches`, and `int8_conv.body_launches` by body).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.quant import (
    _quantize,
    absmax_scale,
    int8_conv_reference,
    quantize_per_image,
)
from adam_dehaze_tpu_torch.parallel.sharded_ops import local_ops

# Mirror of csrc/int8_conv.cu. The gather body: the output-channel tile the
# packed weights are padded to, and the K step.
TILE_N = 64
K_STEP = 32
# The tile body: its (kernel, stride, padding) shapes, its output-channel
# chunks, the input channels of a stage, and the fewest input channels it
# takes (narrower inputs are padded to STAGE_C).
TILE_SHAPES = ((3, 1, 1), (4, 2, 1))
TILE_CHUNKS = (96, 64, 48, 32, 16)
STAGE_C = 32
TILE_MIN_CIN = 16
BODIES = ("tile", "gather")


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


class ConvGeometry(NamedTuple):
    """One ConvBlock conv as Q2 takes it: the body, the padded widths and,
    for the tile body, the output-channel chunk of a block."""
    cin: int
    cin_pad: int
    cout: int
    cout_pad: int
    kh: int
    kw: int
    stride: int
    padding: int
    k_pad: int
    body: str = "gather"
    n_chunk: int = TILE_N

    @classmethod
    def of(cls, cin: int, cout: int, kh: int, kw: int, stride: int,
           padding: int) -> "ConvGeometry":
        """The geometry of a conv on the body its shape takes: the tile body
        for its shapes with at least TILE_MIN_CIN input channels and a
        multiple of 16 outputs, the gather body for every other."""
        tile = (kh == kw and (kh, stride, padding) in TILE_SHAPES and cout % 16 == 0
                and cin >= TILE_MIN_CIN)
        if tile:
            cin_pad = _up(cin, STAGE_C)
            # 96 only at 3x3: at 4x4 stride 2 it would not fit two blocks an SM.
            n = next(c for c in TILE_CHUNKS if cout % c == 0 and (c != 96 or kh == 3))
            return cls(cin, cin_pad, cout, cout, kh, kw, stride, padding, kh * kw * cin_pad,
                       "tile", n)
        cin_pad = 4 if cin <= 4 else _up(cin, 16)
        return cls(cin, cin_pad, cout, _up(cout, TILE_N), kh, kw, stride, padding,
                   _up(kh * kw * cin_pad, K_STEP))

    @property
    def stages(self) -> int:
        """The tile body's K walk: 32-channel groups, times the two row
        parities of a 4x4 stride-2 conv."""
        return self.cin_pad // STAGE_C * (2 if self.kh == 4 else 1)

    @property
    def packed_shape(self):
        """The shape of `pack_int8_weights`' output."""
        if self.body == "tile":
            return (self.cout // self.n_chunk, self.stages,
                    self.kh * self.kw * self.cin_pad * self.n_chunk // self.stages)
        return (self.cout_pad, self.k_pad)

    def out_size(self, h: int, w: int):
        return ((h + 2 * self.padding - self.kh) // self.stride + 1,
                (w + 2 * self.padding - self.kw) // self.stride + 1)


def _tile_view(qw: torch.Tensor, g: ConvGeometry) -> torch.Tensor:
    """(Cout, cin_pad, kh, kw) as the tile body's slabs before flattening:
    (chunk, 32-channel group, row parity, tap, 16-channel group, output
    octet, output, channel). A 3x3 tap is 3 ky + kx; a 4x4 stride-2 tap of
    row parity py is 4 a + kx with ky = 2 a + py."""
    n, cg = g.n_chunk, g.cin_pad // STAGE_C
    w = qw.reshape(g.cout // n, n // 8, 8, cg, 2, 16, g.kh, g.kw)
    if g.kh == 3:          # (c, o, r, cg, h, k, ky, kx) -> (c, cg, ky, kx, h, o, r, k)
        return w.permute(0, 3, 6, 7, 4, 1, 2, 5).unsqueeze(2)
    w = w.reshape(g.cout // n, n // 8, 8, cg, 2, 16, 2, 2, 4)
    # (c, o, r, cg, h, k, a, py, kx) -> (c, cg, py, a, kx, h, o, r, k)
    return w.permute(0, 3, 7, 6, 8, 4, 1, 2, 5)


def pack_int8_weights(qw: torch.Tensor, g: ConvGeometry) -> torch.Tensor:
    """qw (Cout, Cin, kh, kw) int8 -> the weights as `g.body` reads them,
    Cin zero-padded to cin_pad. Tile body: (cout / n_chunk, stages, slab)
    int8, each slab one stage of one output chunk in the slot's layout
    [tap][16-channel group][n_chunk / 8][8 outputs][16 channels]. Gather
    body: (cout_pad, k_pad) int8, OHWI with the rows and K zero-padded."""
    if g.body == "tile":
        w = F.pad(qw, (0, 0, 0, 0, 0, g.cin_pad - g.cin))
        return _tile_view(w, g).reshape(g.packed_shape).contiguous()
    ohwi = F.pad(qw.permute(0, 2, 3, 1), (0, g.cin_pad - g.cin))
    flat = ohwi.reshape(g.cout, g.kh * g.kw * g.cin_pad)
    return F.pad(flat, (0, g.k_pad - flat.shape[1], 0, g.cout_pad - g.cout)).contiguous()


def unpack_int8_weights(packed: torch.Tensor, g: ConvGeometry) -> torch.Tensor:
    """The inverse of `pack_int8_weights` over the padded input channels:
    (Cout, cin_pad, kh, kw) int8."""
    if g.body == "tile":
        # Where each element of the slabs came from, by packing the indices.
        index = torch.arange(g.cout * g.cin_pad * g.kh * g.kw, device=packed.device)
        src = _tile_view(index.reshape(g.cout, g.cin_pad, g.kh, g.kw), g).reshape(-1)
        out = torch.empty(index.numel(), dtype=packed.dtype, device=packed.device)
        out[src] = packed.reshape(-1)
        return out.reshape(g.cout, g.cin_pad, g.kh, g.kw)
    k = g.kh * g.kw * g.cin_pad
    return packed[:g.cout, :k].reshape(g.cout, g.kh, g.kw, g.cin_pad).permute(0, 3, 1, 2)


def eval_bn_stats(bn: torch.nn.BatchNorm2d) -> torch.Tensor:
    """A float32 BatchNorm2d's eval parameters as Q2's epilogue reads them:
    (4, Cout) float32 rows weight, bias, running mean and running variance
    + eps (the sum rounded to float32, as PyTorch's BN kernels take it)."""
    mean, var = bn.running_mean, bn.running_var
    if mean.dtype != torch.float32 or var.dtype != torch.float32:
        raise ValueError(f"Q2 takes a float32 BatchNorm2d, got {mean.dtype} statistics")
    weight = bn.weight.detach() if bn.weight is not None else torch.ones_like(mean)
    bias = bn.bias.detach() if bn.bias is not None else torch.zeros_like(mean)
    eps = torch.tensor(bn.eps, dtype=torch.float32, device=var.device)
    return torch.stack([weight.float(), bias.float(), mean, var + eps]).contiguous()


def quantize_images_reference(x: torch.Tensor, cin_pad: int):
    """Plain version of Q1: `quantize_per_image`, the channels zero-padded
    to `cin_pad`, the scales as float32."""
    q, scale = quantize_per_image(x)
    return F.pad(q, (0, cin_pad - x.shape[-1])).contiguous(), scale.float()


def _require_images(name: str, x: torch.Tensor, cin_pad: Optional[int] = None) -> None:
    """Q1's checks of x (N, H, W, C) on the card and of the padded width
    (where there is one)."""
    _build.require_cuda_inputs(name, x)
    _build.require(x.dim() == 4, name, f"x must be (N, H, W, C), got {tuple(x.shape)}")
    _build.require(x.dtype in (torch.float32, torch.bfloat16), name,
                   f"x dtype {x.dtype} not float32/bfloat16")
    _build.require(x.is_contiguous(), name, "x must be contiguous NHWC")
    _build.require(x.data_ptr() % 16 == 0, name, "x must be 16-byte aligned")
    c = x.shape[3]
    _build.require(cin_pad is None or (cin_pad >= c and cin_pad % 4 == 0), name,
                   f"cin_pad {cin_pad} must be a multiple of 4 and at least C={c}")


def quantize_images(x: torch.Tensor, cin_pad: int):
    """Q1: x (N, H, W, C) NHWC float32 or bfloat16 -> (q (N, H, W, cin_pad)
    int8, scale (N,) float32). A CPU tensor takes the plain version; a CUDA
    tensor (contiguous, 16-byte aligned) launches the kernel."""
    if x.device.type == "cpu":
        with local_ops():
            return quantize_images_reference(x, cin_pad)
    name = "quantize_images"
    _require_images(name, x, cin_pad)
    n, h, w, c = x.shape
    q = torch.empty((n, h, w, cin_pad), dtype=torch.int8, device=x.device)
    scale = torch.empty((n,), dtype=torch.float32, device=x.device)
    scratch = torch.empty((2 * n,), dtype=torch.int32, device=x.device)
    err = _build.library().int8_quantize(
        x.data_ptr(), scratch.data_ptr(), q.data_ptr(), scale.data_ptr(), n, h * w, c,
        cin_pad, int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, name)
    quantize_images.launches += 1
    return q, scale


quantize_images.launches = 0


def image_absmax_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of Q1's first pass: the abs-max of each image of x
    (N, ...) over its other axes, (N,) float32."""
    return x.abs().amax(dim=tuple(range(1, x.dim()))).float()


def image_absmax(x: torch.Tensor) -> torch.Tensor:
    """Q1's first pass alone: x (N, H, W, C) NHWC float32 or bfloat16 ->
    the abs-max of each image's values in x, (N,) float32 (0 for an
    all-zero image). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if x.device.type == "cpu":
        with local_ops():
            return image_absmax_reference(x)
    name = "image_absmax"
    _require_images(name, x)
    n, h, w, c = x.shape
    amax = torch.empty((n,), dtype=torch.float32, device=x.device)
    err = _build.library().int8_absmax(x.data_ptr(), amax.data_ptr(), n, h * w, c,
                                       int(x.dtype == torch.bfloat16),
                                       _build.stream_ptr(x.device))
    _build.check(err, name)
    image_absmax.launches += 1
    return amax


image_absmax.launches = 0


def quantize_images_at_reference(x: torch.Tensor, amax: torch.Tensor, cin_pad: int):
    """Plain version of Q1's second pass: `quantize_images_reference` of
    images whose abs-max is `amax` (N,) float32."""
    scale = absmax_scale(amax, x.dtype)
    q = _quantize(x, scale.view((-1,) + (1,) * (x.dim() - 1)))
    return F.pad(q, (0, cin_pad - x.shape[-1])).contiguous(), scale.float()


def quantize_images_at(x: torch.Tensor, amax: torch.Tensor, cin_pad: int):
    """Q1's second pass alone: x (N, H, W, C) NHWC float32 or bfloat16 and
    the abs-max of each whole image `amax` (N,) float32 (`image_absmax`
    reduced over the processes that hold the image) -> (q (N, H, W,
    cin_pad) int8, scale (N,) float32), as `quantize_images` gives them for
    images of that abs-max. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if x.device.type == "cpu":
        with local_ops():
            return quantize_images_at_reference(x, amax, cin_pad)
    name = "quantize_images_at"
    _require_images(name, x, cin_pad)
    _build.require_cuda_inputs(name, amax)
    n, h, w, c = x.shape
    _build.require(tuple(amax.shape) == (n,) and amax.dtype == torch.float32
                   and amax.is_contiguous(), name, f"amax must be contiguous ({n},) float32")
    q = torch.empty((n, h, w, cin_pad), dtype=torch.int8, device=x.device)
    scale = torch.empty((n,), dtype=torch.float32, device=x.device)
    err = _build.library().int8_quantize_at(
        x.data_ptr(), amax.data_ptr(), q.data_ptr(), scale.data_ptr(), n, h * w, c, cin_pad,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, name)
    quantize_images_at.launches += 1
    return q, scale


quantize_images_at.launches = 0


def int8_conv_packed_reference(q: torch.Tensor, sx: torch.Tensor, qweight: torch.Tensor,
                               wscale: torch.Tensor, bias: Optional[torch.Tensor],
                               g: ConvGeometry, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of Q2's dequant on the kernel's operands (the padded
    channels hold zeros on both sides)."""
    return int8_conv_reference(q, sx, unpack_int8_weights(qweight, g), wscale[:g.cout],
                               g.stride, g.padding, bias, out_dtype)


def int8_conv_fused_reference(q: torch.Tensor, sx: torch.Tensor, qweight: torch.Tensor,
                              wscale: torch.Tensor, bias: Optional[torch.Tensor],
                              g: ConvGeometry, out_dtype: torch.dtype,
                              bn: Optional[torch.nn.BatchNorm2d] = None,
                              relu: bool = False) -> torch.Tensor:
    """Plain version of Q2: `int8_conv_packed_reference`, then the eval BN
    (`F.batch_norm` in `out_dtype` with float32 statistics), then ReLU: the
    ops of an unfused Int8Conv2d -> BatchNorm2d -> ReLU, so on the CPU the
    result is theirs bit for bit. The BN takes a contiguous NCHW copy, so
    that on the card PyTorch runs its own BN kernel, whose rounding the
    kernel's epilogue follows, and not cuDNN's (which it takes for float32
    in channels_last; on the CPU the layout changes nothing). NHWC out."""
    y = int8_conv_packed_reference(q, sx, qweight, wscale, bias, g, out_dtype)
    if bn is None and not relu:
        return y
    y = y.permute(0, 3, 1, 2).contiguous()
    if bn is not None:
        y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                         bn.eps)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1)


def int8_conv(q: torch.Tensor, sx: torch.Tensor, qweight: torch.Tensor,
              wscale: torch.Tensor, bias: Optional[torch.Tensor], g: ConvGeometry,
              out_dtype: torch.dtype, bn: Optional[torch.nn.BatchNorm2d] = None,
              bn_stats: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """Q2: q (N, H, W, cin_pad) int8 and sx (N,) float32 from Q1, the packed
    weights (`g.packed_shape` int8), their scales (cout,) float32 and the
    bias (cout,) float32 or None -> (N, Ho, Wo, cout) NHWC in `out_dtype`
    (float32 or bfloat16), after the eval BN `bn` (its `eval_bn_stats` in
    `bn_stats`, which the kernel reads) and a ReLU where `relu`. A CPU
    tensor takes the plain version; a CUDA tensor launches `g.body`."""
    if q.device.type == "cpu":
        with local_ops():
            return int8_conv_fused_reference(q, sx, qweight, wscale, bias, g, out_dtype, bn,
                                             relu)
    name = "int8_conv"
    extra = tuple(t for t in (bias, bn_stats) if t is not None)
    _build.require_cuda_inputs(name, q, sx, qweight, wscale, *extra)
    _build.require(out_dtype in (torch.float32, torch.bfloat16), name,
                   f"out_dtype {out_dtype} not float32/bfloat16")
    _build.require(q.dtype == torch.int8 and qweight.dtype == torch.int8, name,
                   "q and the weights must be int8")
    _build.require(q.dim() == 4 and q.shape[3] == g.cin_pad and q.is_contiguous(), name,
                   f"q must be contiguous (N, H, W, {g.cin_pad}), got {tuple(q.shape)}")
    _build.require(q.data_ptr() % 16 == 0 and qweight.data_ptr() % 16 == 0, name,
                   "q and the weights must be 16-byte aligned")
    _build.require(tuple(qweight.shape) == g.packed_shape and qweight.is_contiguous(),
                   name, f"weights must be packed {g.packed_shape} for the {g.body} body")
    _build.require((bn is None) == (bn_stats is None), name,
                   "bn and bn_stats (eval_bn_stats) go together")
    _build.require(bn_stats is None or (
        tuple(bn_stats.shape) == (4, g.cout) and bn_stats.dtype == torch.float32
        and bn_stats.is_contiguous()), name, f"bn_stats must be contiguous (4, {g.cout}) float32")
    for t, what in ((sx, "sx"), (wscale, "wscale"), *((bias, "bias"),) * (bias is not None)):
        _build.require(t.dtype == torch.float32 and t.is_contiguous(), name,
                       f"{what} must be contiguous float32")
    n, h, w, _ = q.shape
    ho, wo = g.out_size(h, w)
    out = torch.empty((n, ho, wo, g.cout), dtype=out_dtype, device=q.device)
    err = _build.library().int8_conv(
        q.data_ptr(), qweight.data_ptr(), sx.data_ptr(), wscale.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        bn_stats.data_ptr() if bn_stats is not None else None, int(relu), out.data_ptr(),
        n, h, w, g.cin_pad, ho, wo, g.cout, g.cout_pad, g.k_pad, g.kh, g.kw, g.stride,
        g.padding, int(g.body == "tile"), g.n_chunk, int(out_dtype == torch.bfloat16),
        _build.stream_ptr(q.device))
    _build.check(err, name)
    int8_conv.launches += 1
    int8_conv.body_launches[g.body] += 1
    return out


int8_conv.launches = 0
int8_conv.body_launches = dict.fromkeys(BODIES, 0)
