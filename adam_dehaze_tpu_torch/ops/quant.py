"""Int8 serving of the dehazing branches.

Counterpart of adam_dehaze_tpu/ops/quant.py, which swaps AQT's int8 conv
(`conv_general_dilated_make(2, lhs_bits=8, rhs_bits=8)`) into every
ConvBlock while a branch traces. Only ConvBlock convolutions run in int8;
the output heads, the UpBlock ConvTransposes, the attention MLPs, K2's
gate, BatchNorm and the classifier stay in the compute dtype.

The scales are dynamic and, as AQT's conv config shares them:

- activations: ONE SCALE PER IMAGE, the abs-max over (H, W, C) of that
  image. An image's int8 output never depends on its bucket mates or on
  bucket padding;
- weights: ONE SCALE PER OUTPUT CHANNEL, the abs-max over (Cin, kh, kw) of
  the weights AS CAST TO THE COMPUTE DTYPE (flax promotes them before the
  conv).

Both follow AQT's AbsMaxCalibration and integer numerics, every step in the
dtype of the quantized tensor: an abs-max of 0 becomes 1, scale = abs-max /
127.5, q = round_half_even(clip(x * (1 / scale), -127, 127)). The JAX
package serves under jit, where XLA rewrites the division by the constant
127.5 into a float32 product with its reciprocal: the scale is
dtype(float32(abs-max) * float32(1 / 127.5)), which differs from the true
quotient in the last bit of about 7 float32 scales in 10. The int8 x
int8 products are summed exactly (int32 on the card, float64 here), the sum
is cast to the compute dtype, then multiplied by the image's scale, then by
the channel's scale (AQT's dequant order), then the conv's bias is added
where the ConvBlock has no BN.

`quantize_per_image`, `quantize_weight_per_channel` and
`int8_conv_reference` are the plain versions of that arithmetic. The
kernels (ops/kernels/quant.py: Q1 quantizes activations into the conv's
layout, Q2 is the int8 tensor-core conv whose epilogue dequantises and
applies the ConvBlock's eval BN and ReLU) take them, followed by the BN and
ReLU ops the unfused block runs, for CPU tensors.

The JAX package quantizes the weights on every trace; the port does it
once, when the int8 serving copy is built (`quantize_apply`), from the same
values. The float32 parameters of the model it is given are left untouched.

On a mesh (parallel/spatial.py, parallel/sharding.py) an Int8Conv2d gives
each process the unsharded layer's values bit for bit, as the JAX package's
int8 apply under `make_spatial_infer` or `channel_sharding` does:

- on an H shard, Q1's abs-max of this process's rows is reduced over the
  spatial group before Q1 quantizes (`image_absmax`, a max over the group,
  `quantize_images_at`); the int8 rows above and below that Q2's windows
  read come from the neighbours (a quarter of the float rows' bytes, and
  the same values: the scale is the image's); Q2 runs with its own padding
  on that taller shard and the shard's rows are cropped out. The rows
  above are the padding rounded up to the stride, so that the taller
  shard's first row keeps the stride's grid (at 4x4 stride 2 padding 1 one
  row above would shift every window by a row);
- on split channels, the input's channels are gathered from the group (as
  parallel/sharded_ops.py runs a float conv), so Q1 sees the whole tensor
  and every process takes the same scales, and Q2 computes this process's
  output channels from their slice of the weights, scales, bias and BN,
  quantized and packed once per slice.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adam_dehaze_tpu_torch.parallel import sharding, spatial
from adam_dehaze_tpu_torch.parallel.collectives import (
    AllReduceMax,
    GatherChannels,
    channel_slice,
)

# AQT's int8 numerics (preserve_zero, no preserve_max_val): the scale maps
# the abs-max onto 127.5, and values are clipped to 127 before rounding.
QUANT_BOUND = 127.5
CLIP = 127.0
# float32(1 / 127.5), the factor XLA's jit puts in place of the division.
RECIP_BOUND = float(np.float32(1.0 / QUANT_BOUND))


def absmax_scale(amax: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """AbsMaxCalibration under jit of an abs-max that holds values of
    `dtype`: 0 -> 1, times float32(1 / 127.5) in float32, rounded to
    `dtype`."""
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    return (amax.float() * RECIP_BOUND).to(dtype)


def _abs_max_scale(a: torch.Tensor, dims) -> torch.Tensor:
    """`absmax_scale` of a's abs-max over `dims` (kept)."""
    return absmax_scale(a.abs().amax(dim=dims, keepdim=True), a.dtype)


def _quantize(a: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q = round_half_even(clip(a * (1 / scale), +-127)) as int8, the product
    taken in a's dtype (QTensor.quant, IntSymmetric)."""
    inv = torch.reciprocal(scale)
    inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
    return torch.clamp(a * inv, -CLIP, CLIP).round().to(torch.int8)


def quantize_per_image(x: torch.Tensor):
    """Plain version of Q1: x (N, ...) -> (q int8 of x's shape, scale (N,)
    in x's dtype), one scale per image over all its other axes."""
    dims = tuple(range(1, x.dim()))
    scale = _abs_max_scale(x, dims)
    return _quantize(x, scale), scale.reshape(-1)


def quantize_weight_per_channel(w: torch.Tensor):
    """A conv's weights (Cout, Cin, kh, kw), already in the compute dtype ->
    (q int8 of the same shape, scale (Cout,) in w's dtype), one scale per
    output channel."""
    scale = _abs_max_scale(w, (1, 2, 3))
    return _quantize(w, scale), scale.reshape(-1)


def int8_conv_reference(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                        sw: torch.Tensor, stride: int, padding: int,
                        bias: Optional[torch.Tensor], out_dtype: torch.dtype
                        ) -> torch.Tensor:
    """Plain version of Q2. qx (N, H, W, Cin) int8 NHWC with its per-image
    scales sx (N,); qw (Cout, Cin, kh, kw) int8 with its per-channel scales
    sw (Cout,). The products are summed exactly in float64 (int8 sums reach
    9 * 384 * 127^2, beyond float32's 2^24), the sum cast to float32 and to
    `out_dtype` (as the kernel's int32 -> float -> dtype), then times sx,
    then times sw, then plus `bias`, each step rounded to `out_dtype`.
    Returns (N, Ho, Wo, Cout) NHWC in `out_dtype`."""
    acc = F.conv2d(qx.permute(0, 3, 1, 2).double(), qw.double(), stride=stride,
                   padding=padding)
    y = acc.float().to(out_dtype).permute(0, 2, 3, 1)
    y = y * sx.to(out_dtype)[:, None, None, None]
    y = y * sw.to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.contiguous()


class _Operands(NamedTuple):
    """Q2's operands for some output channels of an Int8Conv2d."""
    geometry: "ConvGeometry"  # noqa: F821  (ops/kernels/quant.py)
    qweight: torch.Tensor
    wscale: torch.Tensor
    bias: Optional[torch.Tensor]
    bn: Optional[nn.BatchNorm2d]
    bn_stats: Optional[torch.Tensor]


class Int8Conv2d(nn.Module):
    """A ConvBlock's nn.Conv2d (weights in the compute dtype) served in int8,
    with the block's eval BatchNorm2d `bn` and its ReLU after it: the
    weights quantized once, per output channel, and packed for Q2's body
    (ConvGeometry); each call quantizes its input per image (Q1) and runs
    Q2, whose epilogue dequantises, applies the BN (`bn_stats`, taken from
    `bn`'s parameters and running statistics) and the ReLU, and writes the
    input's dtype. NCHW in channels_last memory in and out, like the block
    it stands for. On an H shard and on split channels it takes the shard
    (see the module's docstring); a shard whose rows do not split as the
    unsharded layer's output raises.
    `weight` keeps the compute-dtype weights: the branches read their
    compute dtype from it."""

    def __init__(self, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d] = None,
                 relu: bool = False):
        super().__init__()
        from adam_dehaze_tpu_torch.ops.kernels.quant import (
            ConvGeometry,
            eval_bn_stats,
            pack_int8_weights,
        )
        if conv.groups != 1 or conv.dilation != (1, 1) or conv.padding_mode != "zeros":
            raise ValueError(f"Int8Conv2d takes a plain conv, got {conv}")
        kh, kw = conv.kernel_size
        if conv.stride[0] != conv.stride[1] or conv.padding[0] != conv.padding[1]:
            raise ValueError(f"Int8Conv2d takes equal strides and paddings, got {conv}")
        if bn is not None and (bn.training or not bn.track_running_stats):
            raise ValueError("Int8Conv2d folds an eval-mode BatchNorm2d with running statistics")
        w = conv.weight.detach()
        qw, sw = quantize_weight_per_channel(w)
        self.geometry = ConvGeometry.of(w.shape[1], w.shape[0], kh, kw,
                                        conv.stride[0], conv.padding[0])
        self.register_buffer("weight", w)
        self.register_buffer("qweight", pack_int8_weights(qw, self.geometry))
        self.register_buffer("wscale", sw.float())
        bias = conv.bias
        self.register_buffer("bias", None if bias is None else bias.detach().to(w.dtype).float())
        self.bn = bn
        self.register_buffer("bn_stats", None if bn is None else eval_bn_stats(bn))
        self.relu = relu
        # Q2's operands of this process's output channels on split
        # channels, by (index, group size, device).
        self._slices = {}

    def _operands(self, channels) -> _Operands:
        """Q2's operands: the whole layer's, or on split channels (the model
        axis `channels`) this process's slice of them."""
        if channels is None:
            return _Operands(self.geometry, self.qweight, self.wscale, self.bias, self.bn,
                             self.bn_stats)
        key = (channels.index, channels.size, self.weight.device)
        if key not in self._slices:
            self._slices[key] = self._slice(channel_slice(self.geometry.cout, channels))
        return self._slices[key]

    def _slice(self, part: slice) -> _Operands:
        """The operands of output channels `part`: their weights quantized
        (the scales are per channel, so these are the whole layer's) and
        packed for the body their shape takes, their bias and BN."""
        from adam_dehaze_tpu_torch.ops.kernels.quant import (
            ConvGeometry,
            eval_bn_stats,
            pack_int8_weights,
        )
        from adam_dehaze_tpu_torch.parallel.sharded_ops import local_ops
        g = self.geometry
        with local_ops(), torch.no_grad():
            w = self.weight[part]
            qw, sw = quantize_weight_per_channel(w)
            geometry = ConvGeometry.of(g.cin, w.shape[0], g.kh, g.kw, g.stride, g.padding)
            bn = None
            if self.bn is not None:
                bn = copy.deepcopy(self.bn)
                bn.num_features = w.shape[0]
                bn.weight = nn.Parameter(self.bn.weight[part].clone())
                bn.bias = nn.Parameter(self.bn.bias[part].clone())
                bn.running_mean = self.bn.running_mean[part].clone()
                bn.running_var = self.bn.running_var[part].clone()
            return _Operands(geometry, pack_int8_weights(qw, geometry), sw.float(),
                             None if self.bias is None else self.bias[part].contiguous(), bn,
                             None if bn is None else eval_bn_stats(bn))

    def _halo(self, x: torch.Tensor):
        """(rows above, rows below) the H shard `x` (NCHW) that Q2's windows
        read: the rows above the padding rounded up to the stride, the rows
        below what the last window reaches past the shard. Raises where the
        layer's output rows do not split as the shards'."""
        from adam_dehaze_tpu_torch.parallel.sharded_ops import _shard_height
        g = self.geometry
        total = x.shape[2] * spatial.axis().size
        _shard_height(x, "int8 convolution", g.kh, g.stride, g.padding,
                      (total + 2 * g.padding - g.kh) // g.stride + 1)
        top = -(-g.padding // g.stride) * g.stride
        bottom = max(g.kh - g.stride - g.padding, 0)
        return top, bottom

    def forward(self, x):
        from adam_dehaze_tpu_torch.ops.kernels.quant import (
            image_absmax,
            int8_conv,
            quantize_images,
            quantize_images_at,
        )
        channels = sharding.channel_axis(x, self.geometry.cin)
        if channels is not None:
            x = GatherChannels.apply(x, channels)
            if self.bn is not None:
                sharding.used(self.bn.weight, self.bn.bias)
        ops = self._operands(channels)
        # A no-op for the branches' channels_last activations: the NHWC view is free.
        xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        rows = spatial.axis()
        if rows is None:
            q, sx = quantize_images(xh, self.geometry.cin_pad)
        else:
            top, bottom = self._halo(x)
            # The image's abs-max: this shard's, then the max over the group.
            amax = AllReduceMax.apply(image_absmax(xh), rows)
            q, sx = quantize_images_at(xh, amax, self.geometry.cin_pad)
            q = spatial.halo(q, 1, top, bottom).contiguous()
        y = int8_conv(q, sx, ops.qweight, ops.wscale, ops.bias, ops.geometry, x.dtype, ops.bn,
                      ops.bn_stats, self.relu)
        if rows is not None:
            first = top // self.geometry.stride
            y = y[:, first:first + x.shape[2] // self.geometry.stride].contiguous()
        return y.permute(0, 3, 1, 2)


def quantized_inference(module: nn.Module, bits: int = 8) -> nn.Module:
    """Route every ConvBlock convolution of `module` through int8, in place:
    each ConvBlock's conv becomes an Int8Conv2d that also applies the
    block's BN and ReLU (Q2's epilogue), and `nn.Identity` takes their
    places in `block` (the counterpart of the JAX package's
    `quantized_inference` context, which swaps AQT's conv into every
    ConvBlock while tracing). Give it a serving copy in eval mode; its conv
    weights must already be in the compute dtype. Returns `module`."""
    from adam_dehaze_tpu_torch.nn.blocks import ConvBlock
    if bits not in (8,):
        raise ValueError(f"Unsupported quantization bits: {bits}")
    for m in module.modules():
        if isinstance(m, ConvBlock) and isinstance(m.block[0], nn.Conv2d):
            layers = list(m.block)
            bn = layers[1] if m.use_bn else None
            relu = isinstance(layers[-1], nn.ReLU)
            m.block[0] = Int8Conv2d(layers[0], bn, relu)
            for i in range(1, len(layers)):
                m.block[i] = nn.Identity()
    return module


def quantize_apply(model: nn.Module, dtype: torch.dtype = torch.bfloat16,
                   bits: int = 8) -> nn.Module:
    """The int8 serving apply of a branch: a serving copy (conv weights cast
    to `dtype`, eval mode) with its ConvBlocks in int8, run through its
    modules. The low branch runs `module_forward`, never kernel K1, as the
    JAX package serves int8 through the plain `model.apply`. x (N, H, W, 3)
    float -> (N, H, W, 3) float32."""
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel
    from adam_dehaze_tpu_torch.ops.serving_apply import ModulePathApply, cast_for_serving
    if isinstance(model, LightweightDehazeModel):
        apply = ModulePathApply(model, dtype)
        quantized_inference(apply.model, bits)
        return apply
    return quantized_inference(cast_for_serving(model, dtype), bits)
