"""K1: the eval-mode low branch (LightweightDehazeModel) as hand-written
convolution kernels.

Counterpart of adam_dehaze_tpu/ops/pallas/s2d_chain.py
(`make_lightweight_chain_apply`, whose kernel `_lightweight_kernel` runs the
whole branch as one program per image). What it computes carries over:
BatchNorm folded into every conv (ops/fold.py), the residual adds, ReLUs,
the output sigmoid and the `(1 - alpha) * x + alpha * y` skip blend, with
activations stored in the compute dtype between layers and f32
accumulation. Its TPU layout (space-to-depth packing, zero-ring flat
buffers, 8-aligned strides, roll/regroup tricks) does not: here each layer
is one launch of a fused 3x3 conv kernel (csrc/lightweight_chain.cu), whose
source note says what bounds it and why.

`fold_lightweight` builds the folded weights once; `lightweight_chain`
runs them: on a CPU tensor through the plain version
(`lightweight_chain_reference`), on a CUDA tensor through the kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.ops import fold
from adam_dehaze_tpu_torch.ops.kernels import _build

# Mirror of csrc/lightweight_chain.cu:conv3x3_smem_bytes, so that K1 is
# chosen by shape on any device; tests/test_torch_cuda.py holds the two
# against each other. A block stages an 8x16 output tile's input with a
# 1-pixel halo and the weights of 32 output channels.
_TILE_PIX = (8 + 2) * (16 + 2)
_CO_CHUNK = 32
_MAX_SMEM = 232448          # 227 KB, Hopper's per-block limit


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def layer_smem_bytes(cin: int, cout: int, bf16: bool) -> int:
    """Shared memory per block of the body a layer runs, or -1 beyond the
    limit. bf16 with Cin, Cout multiples of 16 runs the tensor-core body
    (bf16 tile at pixel stride Cin+16, bf16 weights, f32 accumulators);
    every other layer the FMA body (f32 tile at stride Cin+1, f32
    weights)."""
    if bf16 and cin % 16 == 0 and cout % 16 == 0:
        smem = (_align128(_TILE_PIX * (cin + 16) * 2)
                + _align128(9 * cin * _CO_CHUNK * 2) + 8 * 16 * _CO_CHUNK * 4)
    else:
        smem = ((_TILE_PIX * (cin + 1) + 3) // 4 * 4 + 9 * cin * _CO_CHUNK) * 4
    return -1 if smem > _MAX_SMEM else smem


class LightweightChainWeights(NamedTuple):
    """Folded layers of the branch, in order: the input ConvBlock, two per
    ResidualBlock, the mid ConvBlock and the output conv. Each is
    (weight HWIO in the compute dtype, shift f32)."""
    layers: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    alpha: float
    n_blocks: int

    @property
    def dtype(self) -> torch.dtype:
        return self.layers[0][0].dtype

    @property
    def channels(self) -> int:
        return self.layers[0][0].shape[3]


def chain_supported(channels: int, n_blocks: int, dtype: torch.dtype) -> bool:
    """Shapes the kernels take in `dtype`: any width that is a multiple of 8
    whose every layer (3 -> c, c -> c, c -> 3) fits one block's shared
    memory, and at least one residual block (the TPU kernel's own floor)."""
    bf16 = dtype == torch.bfloat16
    layers = ((3, channels), (channels, channels), (channels, 3))
    return (channels % 8 == 0 and n_blocks >= 1
            and all(layer_smem_bytes(ci, co, bf16) > 0 for ci, co in layers))


@torch.no_grad()
def fold_lightweight(model, dtype: torch.dtype) -> LightweightChainWeights:
    """Fold a LightweightDehazeModel's eval-mode BNs into its convs (in f32
    from the module's parameters), cast the weights to `dtype`."""
    def hwio(w, t):
        # Fresh tensors: a float32 conv bias would otherwise alias its
        # parameter.
        w = w.detach().permute(2, 3, 1, 0).to(
            dtype, memory_format=torch.contiguous_format, copy=True)
        return w, t.detach().float().clone()

    layers = [hwio(*fold.fold_convblock(model.init_conv))]
    for rb in model.residual_blocks:
        layers.append(hwio(*fold.fold_convblock(rb.conv1)))
        layers.append(hwio(*fold.fold_convblock(rb.conv2)))
    layers.append(hwio(*fold.fold_convblock(model.output_conv[0])))
    out_conv = model.output_conv[1]
    layers.append(hwio(out_conv.weight.float(), out_conv.bias.float()))
    # The JAX forward casts alpha to the compute dtype before the blend.
    alpha = float(model.skip_alpha.detach().to(dtype).float())
    return LightweightChainWeights(tuple(layers), alpha,
                                   len(model.residual_blocks))


def lightweight_chain_reference(x: torch.Tensor,
                                chain: LightweightChainWeights) -> torch.Tensor:
    """Plain PyTorch version: x (N, H, W, 3) f32 -> (N, H, W, 3) f32, with
    the kernel's rounding points: activations and weights in the compute
    dtype, each conv summed in f32 (its products are exact) and the shift,
    residual, activation and blend applied in f32 before one rounding."""
    dt = chain.dtype
    xin = x.to(dt).permute(0, 3, 1, 2)

    def conv(h, layer):
        w, t = layer
        return (F.conv2d(h.float(), w.float().permute(3, 2, 0, 1), padding=1)
                + t[None, :, None, None])

    layers = iter(chain.layers)
    h = torch.relu(conv(xin, next(layers))).to(dt)
    for _ in range(chain.n_blocks):
        y = torch.relu(conv(h, next(layers))).to(dt)
        h = torch.relu(conv(y, next(layers)) + h.float()).to(dt)
    h = torch.relu(conv(h, next(layers))).to(dt)
    y = torch.sigmoid(conv(h, next(layers)))
    out = (1.0 - chain.alpha) * xin.float() + chain.alpha * y
    return out.permute(0, 2, 3, 1).contiguous()


def lightweight_chain(x: torch.Tensor,
                      chain: LightweightChainWeights) -> torch.Tensor:
    """Run the low branch: x (N, H, W, 3) f32 NHWC in [0, 1] -> same shape
    f32. A CPU tensor takes the plain version; a CUDA tensor launches one
    kernel per layer (2 * n_blocks + 3 launches)."""
    if x.device.type == "cpu":
        return lightweight_chain_reference(x, chain)
    name = "lightweight_chain"
    tensors = [t for layer in chain.layers for t in layer]
    _build.require_cuda_inputs(name, x, *tensors)
    _build.require(x.dim() == 4 and x.shape[3] == 3, name,
                   f"x must be (N, H, W, 3), got {tuple(x.shape)}")
    _build.require(x.dtype == torch.float32, name, f"x dtype {x.dtype} is not float32")
    dt = chain.dtype
    _build.require(dt in (torch.float32, torch.bfloat16), name,
                   f"weights dtype {dt} not float32/bfloat16")
    c = chain.channels
    _build.require(chain_supported(c, chain.n_blocks, dt), name,
                   f"width {c} with {chain.n_blocks} blocks is not supported")
    for w, t in chain.layers:
        _build.require(w.dtype == dt and w.is_contiguous(), name,
                       "weights must be contiguous and of one dtype")
        _build.require(t.dtype == torch.float32 and t.is_contiguous(), name,
                       "shifts must be contiguous float32")
    n, h, wd, _ = x.shape
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    bf16 = int(dt == torch.bfloat16)
    xin = x.to(dt).contiguous()
    a = torch.empty((n, h, wd, c), dtype=dt, device=x.device)
    b = torch.empty_like(a)
    out = torch.empty((n, h, wd, 3), dtype=torch.float32, device=x.device)

    def conv(src, layer, dst, residual, cin):
        w, t = layer
        err = lib.conv3x3_bn_act(
            src.data_ptr(), w.data_ptr(), t.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            dst.data_ptr(), n, h, wd, cin, w.shape[3], 1, bf16, stream)
        _build.check(err, "conv3x3_bn_act")
        lightweight_chain.launches += 1

    layers = iter(chain.layers)
    conv(xin, next(layers), b, None, 3)
    for _ in range(chain.n_blocks):
        conv(b, next(layers), a, None, c)
        conv(a, next(layers), b, b, c)    # residual add in place
    conv(b, next(layers), a, None, c)
    w, t = next(layers)
    err = lib.conv3x3_sigmoid_blend(
        a.data_ptr(), w.data_ptr(), t.data_ptr(), xin.data_ptr(),
        out.data_ptr(), chain.alpha, n, h, wd, c, 3, bf16, stream)
    _build.check(err, "conv3x3_sigmoid_blend")
    lightweight_chain.launches += 1
    return out


lightweight_chain.launches = 0
