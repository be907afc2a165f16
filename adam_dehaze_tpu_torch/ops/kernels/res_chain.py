"""K6: a same-shape segment of ResidualBlocks and CBAM AttentionBlocks as a
chain of hand-written kernels.

Counterpart of adam_dehaze_tpu/ops/pallas/res_chain.py
(`make_res_attn_chain`, whose kernel `_chain_kernel` runs a whole segment as
one program per image with the activation resident on chip). What it
computes carries over, with its rounding points:

- `res`: a = relu(conv3x3(b; k0) + t0) rounded to the compute dtype;
  b = relu(conv3x3(a; k1) + t1 + b) rounded once. BN folded in f32 before
  the cast, sums and shifts f32.
- `attn`: the channel mean and max over the image in f32, the two-layer MLP
  in f32 (weights never cast), zp = b * gate kept in f32, the per-pixel mean
  and max over channels of that zp, the 7x7 stencil with f32 unrounded
  weights, and one rounding at the end: b = (zp * spatial gate).

(K4's attention step rounds zp before the spatial gate, and the canonical
AttentionBlock rounds the stencil to the compute dtype: neither is this.)

Its TPU layout (flat zero-ring buffer, 8-aligned stride, matmul-first rolls,
128-lane padding of the MLP and the maps) does not. What bounds a segment on
an H100 is operations: a res block is 36 c^2 FLOP per pixel, the high
branch's 64^2 x 384 segment 87 GFLOP per image against 3 MiB of activation.
The TPU kernel keeps the activation of a whole image resident in VMEM across
the segment; 3 MiB does not fit 227 KB of shared memory, so here every conv
and every attention pass is one launch on plain NHWC tensors and the
activation makes a round trip through device memory, mostly through the 50
MB L2, between them (keeping it on chip across layers is later work). The
segment has no device code of its own: the convs are `conv_tile`
(csrc/conv_tile.cu: bf16 on wgmma, the skip add in the epilogue, in place);
an attention block is four launches: the two-stage channel reduction and the
MLP are the tail chains' (`tail_channel_stats`, `tail_channel_gate` in
csrc/tail_chain.cu), K2's statistics pass (`cbam_gated_maps` in
csrc/cbam_gate.cu) writes the padded f32 maps of b * gate without writing
b * gate, and K2 (`cbam_gate`) computes b * gate * spatial gate in f32 with
the unrounded stencil and rounds once. The TPU kernel's channel max reads
its zero ring, exact only for non-negative input, so it refuses a segment
that starts with `attn` or has no `res`; this kernel takes the true max but
keeps both refusals, so that both packages accept the same segments.

`fold_res_attn_chain` builds the folded weights once from the port's
blocks (`segment_blocks` picks a branch's); `res_attn_chain` runs them: on a
CPU tensor through the plain version (`res_attn_chain_reference`), on a CUDA
tensor through the kernels. An attention block's last pass is kernel K2
(`cbam.launch_cbam_gate`, counted there).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adam_dehaze_tpu_torch.nn.blocks import AttentionBlock, ResidualBlock
from adam_dehaze_tpu_torch.ops import fold
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.kernels.cbam import launch_cbam_gate
from adam_dehaze_tpu_torch.ops.kernels.conv_tile import (
    _conv_ref,
    conv_tile,
    packed_for_kernel,
)
from adam_dehaze_tpu_torch.ops.kernels.tail_chain import (
    _MAX_SLABS,
    _SLAB_MIN_PIXELS,
    Layer,
    _hwio,
    _sh,
    _shift,
    weight_tensors,
)

SEGMENTS = ("e1", "e2b", "d1")

# Kernel launches on a CUDA tensor: per res block (two convs), and per attn
# block counted on K6 (channel reduction, MLP, gated maps) and on K2 (the
# gates' pass).
RES_LAUNCHES = 2
ATTN_LAUNCHES = 3
ATTN_GATE_LAUNCHES = 1

# Widest stencil row the gates' pass stages in shared memory, and the widest
# channel vector the reduction's block holds.
_MAX_WIDTH = 2048
_MAX_CHANNELS = 2048


class AttnWeights(NamedTuple):
    fc0: torch.Tensor       # (hidden, c) f32
    fc1: torch.Tensor       # (c, hidden) f32
    stencil: torch.Tensor   # (7, 7, 2) f32, unrounded


class ResChainWeights(NamedTuple):
    """Folded layers of a segment: two convs per `res` (weights HWIO in the
    compute dtype, shifts f32), one AttnWeights per `attn`, the layer kinds
    in order, and per conv `pack_conv_weights` of its weights for the wgmma
    conv body (None where the conv runs the FMA body)."""
    convs: Tuple[Layer, ...]
    attns: Tuple[AttnWeights, ...]
    kinds: Tuple[str, ...]
    packed: Tuple[Optional[torch.Tensor], ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.convs[0][0].dtype

    @property
    def channels(self) -> int:
        return self.convs[0][0].shape[3]


def res_chain_supported(channels: int, height: int, width: int,
                        dtype: torch.dtype) -> bool:
    """Shapes the kernels take, decided up front: float32 or bfloat16 and a
    width that is a multiple of 16 (16-byte vectors in both dtypes, whole
    tensor-core fragments in bf16)."""
    return (dtype in (torch.float32, torch.bfloat16)
            and 16 <= channels <= _MAX_CHANNELS and channels % 16 == 0
            and height >= 1 and 1 <= width <= _MAX_WIDTH)


def launches_of(kinds: Sequence[str]) -> Tuple[int, int]:
    """(launches counted on K6, launches counted on K2) of one call."""
    n_res = sum(k == "res" for k in kinds)
    n_attn = len(kinds) - n_res
    return (RES_LAUNCHES * n_res + ATTN_LAUNCHES * n_attn,
            ATTN_GATE_LAUNCHES * n_attn)


def segment_blocks(model: nn.Module, segment: str) -> List[nn.Module]:
    """The blocks of a medium or high branch's same-shape segment, in
    order: `e1` follows the first down conv, `e2b` the second (the rest of
    the encoder and the whole bottleneck), `d1` the first up conv. The
    counterpart of the JAX package's `segment_specs` name lists."""
    if segment == "e1":
        return list(model.encoder[0])[1:]
    if segment == "e2b":
        return list(model.encoder[1])[1:] + list(model.bottleneck)
    if segment == "d1":
        return list(model.decoder[0])[3:]
    raise ValueError(f"unknown segment {segment!r}: one of {SEGMENTS}")


@torch.no_grad()
def fold_res_attn_chain(blocks: Sequence[nn.Module], dtype: torch.dtype
                        ) -> ResChainWeights:
    """Fold a sequence of ResidualBlocks and AttentionBlocks of one width in
    f32 from their parameters; conv weights are cast to `dtype`, everything
    else stays f32. Raises ValueError for a segment the TPU kernel refuses:
    one without a `res`, or one that starts with an `attn`."""
    convs: List[Layer] = []
    attns: List[AttnWeights] = []
    kinds: List[str] = []
    for block in blocks:
        if isinstance(block, ResidualBlock):
            for cb in (block.conv1, block.conv2):
                w, t = fold.fold_convblock(cb)
                convs.append((_hwio(w, dtype), _shift(t)))
            kinds.append("res")
        elif isinstance(block, AttentionBlock):
            attns.append(AttnWeights(
                fc0=block.fc[0].weight.detach()[:, :, 0, 0].float().contiguous().clone(),
                fc1=block.fc[2].weight.detach()[:, :, 0, 0].float().contiguous().clone(),
                stencil=block.conv_spatial.weight.detach()[0].permute(1, 2, 0)
                .float().contiguous().clone()))
            kinds.append("attn")
        else:
            raise ValueError(f"unknown layer kind {type(block).__name__}")
    if not convs:
        raise ValueError("chain needs at least one res block")
    if kinds[0] == "attn":
        raise ValueError("chain segments must start with a res block: the TPU "
                         "kernel's channel max assumes post-ReLU (>= 0) input")
    widths = ({c for w, _ in convs for c in w.shape[2:]}
              | {a.fc1.shape[0] for a in attns})
    if len(widths) != 1:
        raise ValueError(f"a segment has one width, got blocks of {sorted(widths)}")
    return ResChainWeights(tuple(convs), tuple(attns), tuple(kinds),
                           tuple(packed_for_kernel(w) for w, _ in convs))


# ---------------------------------------------------------------------------
# Plain version.
# ---------------------------------------------------------------------------

def res_attn_chain_reference(x: torch.Tensor, weights: ResChainWeights) -> torch.Tensor:
    """Plain PyTorch version of K6 with the kernels' rounding points (see
    the module docstring). x (N, H, W, C) NHWC -> the same shape in the
    compute dtype."""
    dt = weights.dtype
    b = x.to(dt).permute(0, 3, 1, 2)
    convs, attns = iter(weights.convs), iter(weights.attns)
    for kind in weights.kinds:
        if kind == "res":
            (w0, t0), (w1, t1) = next(convs), next(convs)
            a = torch.relu(_conv_ref(b, w0) + _sh(t0)).to(dt)
            b = torch.relu(_conv_ref(a, w1) + _sh(t1) + b.float()).to(dt)
        else:
            at = next(attns)
            bf = b.float()

            def mlp(v, at=at):
                return F.linear(torch.relu(F.linear(v, at.fc0)), at.fc1)

            g = torch.sigmoid(mlp(bf.mean(dim=(2, 3))) + mlp(bf.amax(dim=(2, 3))))
            zp = bf * g[:, :, None, None]
            stats = torch.stack([zp.mean(dim=1), zp.amax(dim=1)], dim=1)
            gate = torch.sigmoid(F.conv2d(stats, at.stencil.permute(2, 0, 1)[None], padding=3))
            b = (zp * gate).to(dt)
    return b.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------

def res_attn_chain(x: torch.Tensor, weights: ResChainWeights) -> torch.Tensor:
    """One segment. x (N, H, W, C) NHWC float -> (N, H, W, C) in the
    weights' compute dtype; x is left as it is. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels (`launches_of(weights.kinds)`
    launches, the second number counted on K2) or raises."""
    if x.device.type == "cpu":
        return res_attn_chain_reference(x, weights)
    name = "res_attn_chain"
    tensors = weight_tensors(weights)
    _build.require_cuda_inputs(name, x, *tensors)
    dt = weights.dtype
    c = weights.channels
    _build.require(x.dim() == 4 and x.shape[3] == c, name,
                   f"x must be (N, H, W, {c}), got {tuple(x.shape)}")
    n, h, wd, _ = x.shape
    _build.require(res_chain_supported(c, h, wd, dt), name,
                   f"width {c} at {h}x{wd} in {dt} is not supported")
    for t in tensors:
        _build.require(t.is_contiguous(), name, "weights must be contiguous")
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    bf16 = int(dt == torch.bfloat16)

    def done(err: int, what: str) -> None:
        _build.check(err, what)
        res_attn_chain.launches += 1

    def conv(src, layer, dst, residual=None) -> None:
        (w, shift), packed = layer
        conv_tile(src, w, shift, residual=residual, out=dst, packed=packed)
        res_attn_chain.launches += 1

    _build.require(weights.kinds[0] == "res", name, "a segment starts with a res block")
    # The caller's x is only read: the first res block writes into `b`, which
    # holds the activation from then on; `a` is the other buffer.
    src = x.to(dt).contiguous()
    a, b = torch.empty_like(src), torch.empty_like(src)
    if any(k == "attn" for k in weights.kinds):
        pixels = h * wd
        slabs = max(1, min(_MAX_SLABS, pixels // _SLAB_MIN_PIXELS))
        dev = x.device
        partial = torch.empty((n, slabs, 2, c), dtype=torch.float32, device=dev)
        gate = torch.empty((n, c), dtype=torch.float32, device=dev)
        mean_p = torch.empty((n, h + 6, wd + 6), dtype=torch.float32, device=dev)
        max_p = torch.empty_like(mean_p)
    convs, attns = iter(zip(weights.convs, weights.packed)), iter(weights.attns)
    for kind in weights.kinds:
        if kind == "res":
            conv(src, next(convs), a)
            conv(a, next(convs), b, residual=src)     # in place after the first
            src = b
        else:
            at = next(attns)
            done(lib.tail_channel_stats(
                b.data_ptr(), partial.data_ptr(), n, pixels, c, slabs, bf16, stream),
                "tail_channel_stats")
            done(lib.tail_channel_gate(
                partial.data_ptr(), at.fc0.data_ptr(), at.fc1.data_ptr(), gate.data_ptr(),
                n, slabs, pixels, c, at.fc0.shape[0], stream), "tail_channel_gate")
            done(lib.cbam_gated_maps(
                b.data_ptr(), gate.data_ptr(), mean_p.data_ptr(), max_p.data_ptr(),
                n, h, wd, c, bf16, stream), "cbam_gated_maps")
            launch_cbam_gate(b, gate, mean_p, max_p, at.stencil, a)
            a, b = b, a
            src = b
    return b


res_attn_chain.launches = 0
