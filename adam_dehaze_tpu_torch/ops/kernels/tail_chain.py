"""K3 and K4: the decoder tails of the medium and the high branch as
hand-written kernels.

Counterparts of adam_dehaze_tpu/ops/pallas/tail_chain.py
(`make_medium_tail_chain` and `make_high_tail_chain`, whose kernels
`_medium_tail_kernel` and `_tail_kernel` run everything after the d1 concat
as one program per image). What they compute carries over: the UpBlock's
ConvTranspose as four sub-pixel phase convs with BN folded, the residual
block, for the high branch the CBAM attention block, the two head convs on
`[d2, f0]` without the concat, the output conv with tanh, the high
branch's guidance head, and the residual blend with the input image and
the clip; activations between stages in the compute dtype, f32 sums. Their
TPU layout (space-to-depth packing, zero ring, 8-aligned strides,
matmul-first rolls, 0/1-selection matmuls, 128-lane padding) does not: here
every stage is one launch (csrc/tail_chain.cu, whose source note says what
bounds it; the conv kernel is csrc/conv_tile.cu through
`conv_tile`, shared with K6), and
tensors are plain NHWC. In bf16 at c = 32 or 64 K3's last two layers
(c -> c/2, c/2 -> 3 with tanh, x + res and the clip) are one launch instead:
the head group of the fused body that K1 runs
(csrc/lightweight_chain.cu), the c/2-wide activation held in shared memory
per tile; `medium_tail_plan` decides that by shape, before any launch.

`fold_medium_tail` / `fold_high_tail` build the folded weights once from a
port branch; `medium_tail_chain` / `high_tail_chain` run them: on CPU
tensors through the plain versions (`*_reference`), on CUDA tensors through
the kernels. K4's spatial step is kernel K2' (`cbam.launch_spatial_gate`,
counted there). `medium_tail_chain_tiled_reference` is K3 with the head
group's tile, halo and zeroed ring in plain PyTorch, for the CPU tests.

On an H shard (parallel/spatial.py) the layers read rows across the
shard's edges, and the stages cannot exchange rows inside a launch. So each
run of convolutions between two global reductions runs on the shard made
taller by the run's receptive radius (`spatial.taller`: none beyond the
image's true edges, where the kernels' own zero padding is the image's),
and its own rows are cropped back: the rows the kernels pad at the taller
shard's inner edges reach only rows cropped away. The sub-pixel up
conv's output rows 2m and 2m+1 read d1 rows m-1..m+1, so it and every 3x3
conv after it spoil one full-resolution row at an inner edge: K3 (the up
conv and five 3x3 convs) takes `MEDIUM_TAIL_RADIUS` = 3 rows of d1 (six
of f0 and x); K4 runs its trunk front (up conv, residual block: 3 rows) on
`HIGH_FRONT_RADIUS` = 2 rows of d1, the attention block on the shard's own
rows, with the per-image channel partials reduced over the group before
the MLP and the spatial maps' 3 padded rows filled from the neighbours
before K2', and its heads and guidance (three 3x3 convs, two for the
guidance) on `HIGH_HEAD_RADIUS` = 3 rows. The plain versions take the same
route on CPU tensors, so only the launches differ.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.ops import fold
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.kernels.cbam import fill_map_halo, launch_spatial_gate
from adam_dehaze_tpu_torch.ops.kernels.conv_tile import (
    _conv_ref,
    conv_tile,
    packed_for_kernel,
    subpixel_up_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    group_smem_bytes,
    head_tile,
    pack_group,
    window,
    zero_outside,
)
from adam_dehaze_tpu_torch.parallel import spatial
from adam_dehaze_tpu_torch.parallel.collectives import AllReduceMax, AllReduceSum
from adam_dehaze_tpu_torch.parallel.mesh import Axis
from adam_dehaze_tpu_torch.parallel.sharded_ops import local_ops

Layer = Tuple[torch.Tensor, torch.Tensor]   # (weight HWIO compute dtype, shift f32)

# Slabs of the per-image channel reduction's first stage.
_MAX_SLABS = 64
_SLAB_MIN_PIXELS = 64
# Rows an H shard takes from each neighbour before a run of layers (see
# the module docstring): d1 rows for K3 and K4's trunk front, full-
# resolution rows for K4's heads.
MEDIUM_TAIL_RADIUS = 3
HIGH_FRONT_RADIUS = 2
HIGH_HEAD_RADIUS = 3


class TrunkPacked(NamedTuple):
    """`pack_conv_weights` of the trunk's conv weights, which the wgmma conv
    body reads; None where a layer runs the FMA body."""
    up: Optional[torch.Tensor]
    res_a: Optional[torch.Tensor]
    res_b: Optional[torch.Tensor]
    head1_d2: Optional[torch.Tensor]
    head1_f0: Optional[torch.Tensor]
    head2: Optional[torch.Tensor]


class MediumTailWeights(NamedTuple):
    """Folded layers of a tail's conv trunk (the whole medium tail).
    Weights are in the compute dtype, shifts f32. `head_group` holds head2
    and out again as K3's head group reads them (`pack_group`), None where
    `medium_tail_plan` runs them as two launches."""
    up: torch.Tensor          # (4 phases, 4 taps, 4c, c), phase a*2+b, tap u*2+v
    up_shift: torch.Tensor    # (c,)
    res_a: Layer              # (3, 3, c, c)
    res_b: Layer
    head1_d2: torch.Tensor    # (3, 3, c, c): the half of the head conv on d2
    head1_f0: torch.Tensor    # (3, 3, c, c): the half on f0
    head1_shift: torch.Tensor
    head2: Layer              # (3, 3, c, c/2)
    out: Layer                # (3, 3, c/2, 3), bias as the shift
    packed: TrunkPacked
    head_group: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.up.dtype

    @property
    def channels(self) -> int:
        return self.up.shape[3]


class HighTailWeights(NamedTuple):
    """The high tail: the conv trunk, the attention block's MLP (f32, as in
    the TPU kernel) and 7x7 stencil (values rounded to the compute dtype,
    held f32), and the guidance head."""
    trunk: MediumTailWeights
    attn_fc0: torch.Tensor      # (hidden, c) f32
    attn_fc1: torch.Tensor      # (c, hidden) f32
    attn_stencil: torch.Tensor  # (7, 7, 2) f32
    guidance1: Layer               # (3, 3, 3, 16)
    guidance2: Layer               # (3, 3, 16, 16)
    guidance_out_w: torch.Tensor   # (16,) f32
    guidance_out_b: float
    guidance2_packed: Optional[torch.Tensor]

    @property
    def dtype(self) -> torch.dtype:
        return self.trunk.dtype

    @property
    def channels(self) -> int:
        return self.trunk.channels


def _kernel_takes(channels: int, height: int, width: int, dtype: torch.dtype) -> bool:
    """What the launches themselves take: float32 or bfloat16, a width
    that is a multiple of 16 (so that c/2 moves in 16-byte vectors), and
    even sides (d1 has half of them)."""
    return (dtype in (torch.float32, torch.bfloat16) and channels >= 16
            and channels % 16 == 0 and height % 2 == 0 and width % 2 == 0
            and height >= 2 and width >= 2)


def tail_supported(channels: int, height: int, width: int,
                   dtype: torch.dtype) -> bool:
    """Shapes the tail kernels take, decided up front: float32 or bfloat16,
    a width that is a multiple of 16 (so that c/2 moves in 16-byte
    vectors), and an image whose sides are multiples of 4, so that the
    decoder's stages are exact halves and the canonical forward's resize
    steps never run. On an H shard, the shard's height: the taller shard
    the launches get (see the module docstring) needs only even sides."""
    return (_kernel_takes(channels, height, width, dtype) and height % 4 == 0
            and width % 4 == 0 and height >= 4 and width >= 4)


class MediumTailPlan(NamedTuple):
    """What one call of K3 launches."""
    head: str          # "group": head2 and out as one fused launch; "layers": two launches
    tile: int          # the head group's output tile side, 0 for "layers"
    launches: int
    smem_bytes: int    # the head group's dynamic shared memory a block, 0 for "layers"


def medium_tail_plan(channels: int, dtype: torch.dtype) -> MediumTailPlan:
    """K3's launches at this width and dtype, decided before any launch:
    bf16 at a width the head group serves (`head_tile`: c = 32 or 64) runs
    the trunk's four conv launches and the group (5); fp32 and the other
    widths run head2 on the shared conv body and the last layer on its FMA
    body (6)."""
    tile = head_tile(channels) if dtype == torch.bfloat16 else 0
    if tile:
        return MediumTailPlan("group", tile, 5, group_smem_bytes(channels, "tail_head", tile))
    return MediumTailPlan("layers", 0, 6, 0)


def _hwio(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW -> a fresh contiguous HWIO tensor in `dtype`."""
    return w.detach().permute(2, 3, 1, 0).to(
        dtype, memory_format=torch.contiguous_format, copy=True)


def _shift(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().clone()


@torch.no_grad()
def fold_medium_tail(model, dtype: torch.dtype) -> MediumTailWeights:
    """Fold the tail of a MediumIntensityDehazeModel (or the conv trunk of
    a HighIntensityDehazeModel: both name it `decoder[1]`, `output_conv`)
    in f32 from the module's parameters, cast the weights to `dtype`."""
    c = model.base_channels
    up = model.decoder[1]
    phases, t_up = fold.fold_upblock_phases(up)      # (2, 2, 2, 2, 4c, c)

    def layer(block) -> Layer:
        w, t = fold.fold_convblock(block)
        return _hwio(w, dtype), _shift(t)

    res = up[3]
    wa, wb, t1 = fold.fold_head_split(model.output_conv[0], c)
    out_conv = model.output_conv[2]
    up_w = phases.detach().reshape(4, 4, 4 * c, c).to(dtype).contiguous()
    res_a, res_b, head2 = layer(res.conv1), layer(res.conv2), layer(model.output_conv[1])
    head1_d2, head1_f0 = _hwio(wa, dtype), _hwio(wb, dtype)
    out = (_hwio(out_conv.weight.float(), dtype), _shift(out_conv.bias))
    group = medium_tail_plan(c, dtype).head == "group"
    return MediumTailWeights(
        up=up_w, up_shift=_shift(t_up), res_a=res_a, res_b=res_b,
        head1_d2=head1_d2, head1_f0=head1_f0, head1_shift=_shift(t1), head2=head2,
        out=out,
        packed=TrunkPacked(
            packed_for_kernel(up_w, 2),
            *(packed_for_kernel(w) for w in (res_a[0], res_b[0], head1_d2, head1_f0, head2[0]))),
        head_group=pack_group([head2, out]) if group else None)


@torch.no_grad()
def fold_high_tail(model, dtype: torch.dtype) -> HighTailWeights:
    """Fold the tail of a HighIntensityDehazeModel: the trunk, the last
    AttentionBlock (`decoder[1][4]`) and the guidance head
    (`detail_branch`)."""
    attn = model.decoder[1][4]
    guidance = model.detail_branch

    def layer(block) -> Layer:
        w, t = fold.fold_convblock(block)
        return _hwio(w, dtype), _shift(t)

    stencil = attn.conv_spatial.weight.detach()[0].permute(1, 2, 0)   # (7, 7, 2)
    attn_kwargs = dict(
        attn_fc0=attn.fc[0].weight.detach()[:, :, 0, 0].float().contiguous().clone(),
        attn_fc1=attn.fc[2].weight.detach()[:, :, 0, 0].float().contiguous().clone(),
        attn_stencil=stencil.to(dtype).float().contiguous())
    guidance2 = layer(guidance[1])
    return HighTailWeights(
        # K4 runs its own last layer (the guidance epilogue): no head group.
        trunk=fold_medium_tail(model, dtype)._replace(head_group=None),
        guidance1=layer(guidance[0]),
        guidance2=guidance2, guidance2_packed=packed_for_kernel(guidance2[0]),
        guidance_out_w=guidance[2].weight.detach().float().reshape(-1).clone(),
        guidance_out_b=float(guidance[2].bias.detach().float()), **attn_kwargs)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def _sh(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


def _trunk_front_reference(d1, wt: MediumTailWeights):
    dt = wt.dtype
    d2 = torch.relu(subpixel_up_reference(d1, wt.up) + _sh(wt.up_shift)).to(dt)
    y = torch.relu(_conv_ref(d2, wt.res_a[0]) + _sh(wt.res_a[1])).to(dt)
    return torch.relu(_conv_ref(y, wt.res_b[0]) + _sh(wt.res_b[1]) + d2.float()).to(dt)


def _head1_reference(d2, f0, wt: MediumTailWeights):
    """The first head conv on [d2, f0], rounded to the compute dtype."""
    return torch.relu(_conv_ref(d2, wt.head1_d2) + _conv_ref(f0, wt.head1_f0)
                      + _sh(wt.head1_shift)).to(wt.dtype)


def _trunk_heads_reference(d2, f0, wt: MediumTailWeights):
    """tanh(output_conv([d2, f0])) in f32."""
    h = _head1_reference(d2, f0, wt)
    h = torch.relu(_conv_ref(h, wt.head2[0]) + _sh(wt.head2[1])).to(wt.dtype)
    return torch.tanh(_conv_ref(h, wt.out[0]) + _sh(wt.out[1]))


def _nchw(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t.to(dt).permute(0, 3, 1, 2)


def medium_tail_chain_reference(d1, f0, x, wt: MediumTailWeights) -> torch.Tensor:
    """Plain PyTorch version of K3, with the kernels' rounding points:
    inputs, weights and the activations between stages in the compute
    dtype, every conv summed in f32 and its epilogue applied in f32 before
    one rounding. d1 (N, H/2, W/2, 4c), f0 (N, H, W, c), x (N, H, W, 3)
    -> (N, H, W, 3) f32."""
    dt = wt.dtype
    d2 = _trunk_front_reference(_nchw(d1, dt), wt)
    res = _trunk_heads_reference(d2, _nchw(f0, dt), wt)
    out = torch.clamp(_nchw(x, dt).float() + res, 0.0, 1.0)
    return out.permute(0, 2, 3, 1).contiguous()


def _valid(a: torch.Tensor, layer: Layer) -> torch.Tensor:
    """3x3 conv without padding + shift, summed in f32. a NCHW."""
    w, t = layer
    return F.conv2d(a.float(), w.float().permute(3, 2, 0, 1)) + _sh(t)


def medium_tail_chain_tiled_reference(d1, f0, x, wt: MediumTailWeights,
                                      tile: int) -> torch.Tensor:
    """K3 with its head group's geometry in plain PyTorch, in the weights'
    dtype: the trunk and the first head conv as `medium_tail_chain_reference`
    runs them, then head2 and the output conv over `tile` x `tile` output
    tiles as the group runs them. A tile stages h1 with a halo of 2 (zero
    outside the image), computes head2 without padding on the (tile + 2)^2
    ring, rounds it to the compute dtype and stores 0 at the ring's
    positions outside the image (the output conv pads with zeros there, not
    with relu(shift)), then the output conv, tanh, x + res and the clip, and
    writes only its own positions. Equal to `medium_tail_chain_reference` up
    to the order of the f32 sums: a recomputed ring position sees the same
    operands as its owner's."""
    dt = wt.dtype
    h1 = _head1_reference(_trunk_front_reference(_nchw(d1, dt), wt), _nchw(f0, dt), wt)
    xin = _nchw(x, dt)
    n, _, h, w = h1.shape
    out = torch.empty((n, 3, h, w), dtype=torch.float32, device=h1.device)
    for ty0 in range(0, h, tile):
        for tx0 in range(0, w, tile):
            mid = torch.relu(_valid(window(h1, ty0 - 2, tx0 - 2, tile + 4), wt.head2)).to(dt)
            mid = zero_outside(mid, ty0 - 1, tx0 - 1, h, w)
            res = torch.tanh(_valid(mid, wt.out))
            o = torch.clamp(window(xin, ty0, tx0, tile).float() + res, 0.0, 1.0)
            out[:, :, ty0:ty0 + tile, tx0:tx0 + tile] = o[:, :, :h - ty0, :w - tx0]
    return out.permute(0, 2, 3, 1).contiguous()


def stencil_gate_reference(stats: torch.Tensor, stencil: torch.Tensor) -> torch.Tensor:
    """sigmoid of the 7x7 stencil (7, 7, 2) over the (mean, max) maps
    (N, 2, H, W), zero-padded by 3; on an H shard the 3 rows above and
    below come from the neighbours (spatial.halo)."""
    k = stencil.permute(2, 0, 1)[None]                    # (1, 2, 7, 7)
    if spatial.axis() is None:
        return torch.sigmoid(F.conv2d(stats, k, padding=3))
    return torch.sigmoid(F.conv2d(spatial.halo(stats, 2, 3, 3), k, padding=(0, 3)))


def attention_reference(d2: torch.Tensor, wt: HighTailWeights) -> torch.Tensor:
    """K4's attention block on d2 NCHW in the compute dtype: the channel
    gate from f32 statistics and the f32 MLP; the gated activation rounded
    to the compute dtype; its (mean, max) maps over channels taken from the
    unrounded products and kept f32; the 7x7 stencil and the spatial gate
    in f32, one rounding at the end. On an H shard the statistics are the
    whole image's and the stencil reads the neighbours' map rows."""
    dt = wt.dtype
    xf = d2.float()

    def mlp(v):
        return F.linear(torch.relu(F.linear(v, wt.attn_fc0)), wt.attn_fc1)

    g = torch.sigmoid(mlp(spatial.mean_hw(xf)) + mlp(spatial.amax_hw(xf)))
    zf = xf * g[:, :, None, None]
    stats = torch.stack([zf.mean(dim=1), zf.amax(dim=1)], dim=1)
    gate = stencil_gate_reference(stats, wt.attn_stencil)
    return (zf.to(dt).float() * gate).to(dt)


def high_tail_chain_reference(d1, f0, x, wt: HighTailWeights) -> torch.Tensor:
    """Plain PyTorch version of K4 (see `medium_tail_chain_reference` for
    the rounding points and `attention_reference` for the attention
    block's)."""
    dt = wt.dtype
    d2 = attention_reference(_trunk_front_reference(_nchw(d1, dt), wt.trunk), wt)
    return _high_heads_reference(d2, _nchw(f0, dt), _nchw(x, dt), wt)


def _high_heads_reference(d2, f0, xin, wt: HighTailWeights) -> torch.Tensor:
    """K4 after its attention block: the heads on [d2, f0], the guidance on
    xin (all NCHW in the compute dtype) and the blend; NHWC f32."""
    dt = wt.dtype
    res = _trunk_heads_reference(d2, f0, wt.trunk)
    g = torch.relu(_conv_ref(xin, wt.guidance1[0]) + _sh(wt.guidance1[1])).to(dt)
    g = torch.relu(_conv_ref(g, wt.guidance2[0]) + _sh(wt.guidance2[1])).to(dt)
    guidance = torch.sigmoid(
        torch.einsum("nchw,c->nhw", g.float(), wt.guidance_out_w) + wt.guidance_out_b)
    out = torch.clamp(xin.float() + res * guidance[:, None], 0.0, 1.0)
    return out.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------

class _Launcher:
    """The tail's launches on one device and stream; every launch adds one
    to `counter.launches`."""

    def __init__(self, counter, device, bf16: bool):
        self.lib = _build.library()
        self.stream = _build.stream_ptr(device)
        self.bf16 = int(bf16)
        self.counter = counter

    def done(self, err: int, name: str) -> None:
        _build.check(err, name)
        self.counter.launches += 1

    def conv(self, src, w, shift, dst, *, ksize=3, residual=None, src2=None,
             w2=None, packed=None, packed2=None) -> None:
        conv_tile(src, w, shift, ksize=ksize, residual=residual, x2=src2, w2=w2, out=dst,
                  packed=packed, packed2=packed2)
        self.counter.launches += 1

    def final(self, h, layer, image, out, guidance=None, guidance_w=None,
              guidance_b=0.0) -> None:
        n, hh, wd, cin = h.shape
        w, bias = layer
        self.done(self.lib.tail_conv_final(
            h.data_ptr(), w.data_ptr(), cin, bias.data_ptr(), image.data_ptr(),
            guidance.data_ptr() if guidance is not None else None,
            guidance.shape[3] if guidance is not None else 0,
            guidance_w.data_ptr() if guidance_w is not None else None,
            guidance_b, out.data_ptr(), n, hh, wd, self.bf16, self.stream),
            "tail_conv_final")

    def head_group(self, h1, group, x, out) -> None:
        """K3's head group: h1 -> out through head2, the output conv, tanh,
        x + res and the clip; x f32."""
        n, hh, wd, c = h1.shape
        wp, shifts = group
        self.done(self.lib.tail_head_group(
            x.data_ptr(), h1.data_ptr(), wp.data_ptr(), shifts.data_ptr(), out.data_ptr(),
            n, hh, wd, c, self.stream), "tail_head_group")


def weight_tensors(weights) -> List[torch.Tensor]:
    """Every tensor of a (nested) tuple of folded weights."""
    if isinstance(weights, torch.Tensor):
        return [weights]
    if isinstance(weights, tuple):
        return [t for item in weights for t in weight_tensors(item)]
    return []


def _require_tail_inputs(name, d1, f0, x, wt) -> Tuple[int, int, int, int]:
    """Check the inputs of one call's launches (x maybe a taller shard):
    their device, shapes and the weights' layout."""
    tensors = weight_tensors(wt)
    _build.require_cuda_inputs(name, d1, f0, x, *tensors)
    c = wt.channels
    _build.require(x.dim() == 4 and x.shape[3] == 3, name,
                   f"x must be (N, H, W, 3), got {tuple(x.shape)}")
    n, h, wd, _ = x.shape
    _build.require(_kernel_takes(c, h, wd, wt.dtype), name,
                   f"width {c} at {h}x{wd} in {wt.dtype} is not supported")
    _build.require(tuple(d1.shape) == (n, h // 2, wd // 2, 4 * c), name,
                   f"d1 must be {(n, h // 2, wd // 2, 4 * c)}, got {tuple(d1.shape)}")
    _build.require(tuple(f0.shape) == (n, h, wd, c), name,
                   f"f0 must be {(n, h, wd, c)}, got {tuple(f0.shape)}")
    for t in tensors:
        _build.require(t.is_contiguous(), name, "weights must be contiguous")
    return n, h, wd, c


def _require_supported(name, x, wt) -> None:
    """The call's own image (its H shard on a spatial mesh) is a shape the
    tail takes (`tail_supported`)."""
    _, h, wd, _ = x.shape
    _build.require(tail_supported(wt.channels, h, wd, wt.dtype), name,
                   f"width {wt.channels} at {h}x{wd} in {wt.dtype} is not supported "
                   "(tail_supported)")


def _rows(t: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Rows start .. start + n of an NHWC tensor, contiguous (`t` itself
    when that is all of it)."""
    if start == 0 and t.shape[1] == n:
        return t
    return t[:, start:start + n].contiguous()


def _trunk_front(run: _Launcher, d1, wt: MediumTailWeights, d2, tmp) -> None:
    """UpBlock and ResidualBlock: d1 -> d2 (tmp is scratch of d2's shape)."""
    run.conv(d1, wt.up, wt.up_shift, d2, ksize=2, packed=wt.packed.up)
    run.conv(d2, wt.res_a[0], wt.res_a[1], tmp, packed=wt.packed.res_a)
    run.conv(tmp, wt.res_b[0], wt.res_b[1], d2, residual=d2,      # in place
             packed=wt.packed.res_b)


def _head1(run: _Launcher, d2, f0, wt: MediumTailWeights, out) -> None:
    """The first head conv on [d2, f0] -> out (N, H, W, c)."""
    run.conv(d2, wt.head1_d2, wt.head1_shift, out, src2=f0, w2=wt.head1_f0,
             packed=wt.packed.head1_d2, packed2=wt.packed.head1_f0)


def _trunk_heads(run: _Launcher, d2, f0, wt: MediumTailWeights, tmp):
    """The two head convs; returns the (N, H, W, c/2) activation."""
    _head1(run, d2, f0, wt, tmp)
    n, h, wd, c = d2.shape
    h2 = torch.empty((n, h, wd, c // 2), dtype=d2.dtype, device=d2.device)
    run.conv(tmp, wt.head2[0], wt.head2[1], h2, packed=wt.packed.head2)
    return h2


def medium_tail_chain(d1: torch.Tensor, f0: torch.Tensor, x: torch.Tensor,
                      weights: MediumTailWeights) -> torch.Tensor:
    """The medium branch after the d1 concat. d1 (N, H/2, W/2, 4c) is
    cat([decoder[0] output, e1]), f0 (N, H, W, c) the stem features, x
    (N, H, W, 3) the input image, all NHWC; returns (N, H, W, 3) f32. CPU
    tensors take the plain version; CUDA tensors launch the kernels
    (`medium_tail_plan`: 5 launches with the head group, 6 without) or
    raise. On an H shard the chain runs on the shard made taller by
    `MEDIUM_TAIL_RADIUS` rows of d1 (see the module docstring)."""
    cuda = x.device.type != "cpu"
    if cuda:
        _require_supported("medium_tail_chain", x, weights)
    if spatial.axis() is None:
        return (_medium_tail_kernels if cuda else medium_tail_chain_reference)(
            d1, f0, x, weights)
    with local_ops():
        d1, top = spatial.taller(d1, 1, MEDIUM_TAIL_RADIUS)
        f0, _ = spatial.taller(f0, 1, 2 * MEDIUM_TAIL_RADIUS)
        xt, _ = spatial.taller(x, 1, 2 * MEDIUM_TAIL_RADIUS)
        out = (_medium_tail_kernels if cuda else medium_tail_chain_reference)(
            d1, f0, xt, weights)
        return _rows(out, 2 * top, x.shape[1])


def _medium_tail_kernels(d1, f0, x, weights: MediumTailWeights) -> torch.Tensor:
    name = "medium_tail_chain"
    n, h, wd, c = _require_tail_inputs(name, d1, f0, x, weights)
    dt = weights.dtype
    plan = medium_tail_plan(c, dt)
    run = _Launcher(medium_tail_chain, x.device, dt == torch.bfloat16)
    d1, f0 = (t.to(dt).contiguous() for t in (d1, f0))
    d2 = torch.empty((n, h, wd, c), dtype=dt, device=x.device)
    tmp = torch.empty_like(d2)
    out = torch.empty((n, h, wd, 3), dtype=torch.float32, device=x.device)
    _trunk_front(run, d1, weights, d2, tmp)
    if plan.head == "group":
        _build.require(weights.head_group is not None
                       and weights.head_group[0].data_ptr() % 16 == 0, name,
                       "the head group needs the packed weights of fold_medium_tail")
        _head1(run, d2, f0, weights, tmp)
        run.head_group(tmp, weights.head_group, x.float().contiguous(), out)
    else:
        h2 = _trunk_heads(run, d2, f0, weights, tmp)
        run.final(h2, weights.out, x.to(dt).contiguous(), out)
    return out


medium_tail_chain.launches = 0


def reduce_partials(partial: torch.Tensor, rows: Axis) -> torch.Tensor:
    """The per-slab channel (sum, max) partials (N, slabs, 2, C) of every H
    shard of the spatial group: the sums added, the maxima maxed, so that
    the MLP's pass over the slabs reads the whole image's."""
    sums = AllReduceSum.apply(partial[:, :, 0], (rows.group,))
    maxima = AllReduceMax.apply(partial[:, :, 1], rows)
    return torch.stack([sums, maxima], 2).contiguous()


def _attention(run: _Launcher, d2, wt: HighTailWeights, tmp, out,
               rows: Optional[Axis] = None) -> None:
    """The attention block: d2 -> out (tmp holds the channel-gated
    activation). Three launches counted here, the spatial step on K2'. On
    an H shard (`rows`) the channel partials are reduced over the group
    before the MLP, which divides by the whole image's pixels, and the
    maps' padded rows are filled from the neighbours before K2'."""
    n, h, wd, c = d2.shape
    pixels = h * wd
    slabs = max(1, min(_MAX_SLABS, pixels // _SLAB_MIN_PIXELS))
    dev = d2.device
    partial = torch.empty((n, slabs, 2, c), dtype=torch.float32, device=dev)
    gate = torch.empty((n, c), dtype=torch.float32, device=dev)
    maps = torch.empty((2, n, h + 6, wd + 6), dtype=torch.float32, device=dev)
    run.done(run.lib.tail_channel_stats(
        d2.data_ptr(), partial.data_ptr(), n, pixels, c, slabs, run.bf16,
        run.stream), "tail_channel_stats")
    if rows is not None:
        partial = reduce_partials(partial, rows)
        pixels *= rows.size
    run.done(run.lib.tail_channel_gate(
        partial.data_ptr(), wt.attn_fc0.data_ptr(), wt.attn_fc1.data_ptr(),
        gate.data_ptr(), n, slabs, pixels, c, wt.attn_fc0.shape[0],
        run.stream), "tail_channel_gate")
    run.done(run.lib.tail_gated_stats(
        d2.data_ptr(), gate.data_ptr(), tmp.data_ptr(), maps[0].data_ptr(),
        maps[1].data_ptr(), n, h, wd, c, run.bf16, run.stream), "tail_gated_stats")
    if rows is not None:
        maps = fill_map_halo(maps, rows)
    launch_spatial_gate(tmp, maps[0], maps[1], wt.attn_stencil, out)


class _HighPlain:
    """K4's three runs as plain versions: NHWC in and out."""

    def __init__(self, wt: HighTailWeights):
        self.wt = wt

    def front(self, d1):
        return _trunk_front_reference(_nchw(d1, self.wt.dtype), self.wt.trunk).permute(0, 2, 3, 1)

    def attention(self, d2, rows):
        return attention_reference(d2.permute(0, 3, 1, 2), self.wt).permute(0, 2, 3, 1)

    def heads(self, d2, f0, x):
        dt = self.wt.dtype
        return _high_heads_reference(d2.permute(0, 3, 1, 2), _nchw(f0, dt), _nchw(x, dt),
                                     self.wt)


class _HighKernels:
    """K4's three runs as launches on CUDA tensors: NHWC in and out."""

    def __init__(self, wt: HighTailWeights, device):
        self.wt = wt
        self.run = _Launcher(high_tail_chain, device, wt.dtype == torch.bfloat16)

    def front(self, d1):
        d1 = d1.to(self.wt.dtype).contiguous()
        n, h, wd, _ = d1.shape
        d2 = torch.empty((n, 2 * h, 2 * wd, self.wt.channels), dtype=d1.dtype, device=d1.device)
        _trunk_front(self.run, d1, self.wt.trunk, d2, torch.empty_like(d2))
        return d2

    def attention(self, d2, rows):
        out = torch.empty_like(d2)
        _attention(self.run, d2, self.wt, torch.empty_like(d2), out, rows)
        return out

    def heads(self, d2, f0, x):
        wt, run = self.wt, self.run
        f0, xin = (t.to(wt.dtype).contiguous() for t in (f0, x))
        n, h, wd, _ = d2.shape
        h2 = _trunk_heads(run, d2, f0, wt.trunk, torch.empty_like(d2))
        gc = wt.guidance1[0].shape[3]
        g1 = torch.empty((n, h, wd, gc), dtype=wt.dtype, device=d2.device)
        g2 = torch.empty_like(g1)
        run.conv(xin, wt.guidance1[0], wt.guidance1[1], g1)
        run.conv(g1, wt.guidance2[0], wt.guidance2[1], g2, packed=wt.guidance2_packed)
        out = torch.empty((n, h, wd, 3), dtype=torch.float32, device=d2.device)
        run.final(h2, wt.trunk.out, xin, out, guidance=g2, guidance_w=wt.guidance_out_w,
                  guidance_b=wt.guidance_out_b)
        return out


def high_tail_chain(d1: torch.Tensor, f0: torch.Tensor, x: torch.Tensor,
                    weights: HighTailWeights) -> torch.Tensor:
    """The high branch after the d1 concat; arguments as
    `medium_tail_chain`. CUDA tensors launch the kernels: 11 launches
    counted here and one of K2' (`spatial_gate.launches`). On an H shard
    the trunk front and the heads run on taller shards and the attention
    block reduces over the group (see the module docstring)."""
    cuda = x.device.type != "cpu"
    rows = spatial.axis()
    if cuda:
        _require_supported("high_tail_chain", x, weights)
        _require_tail_inputs("high_tail_chain", d1, f0, x, weights)
    elif rows is None:
        return high_tail_chain_reference(d1, f0, x, weights)
    stages = _HighKernels(weights, x.device) if cuda else _HighPlain(weights)
    n = x.shape[1]
    with local_ops():
        d1, top = spatial.taller(d1, 1, HIGH_FRONT_RADIUS)
        d2 = _rows(stages.front(d1), 2 * top, n)
        d2, top = spatial.taller(stages.attention(d2, rows), 1, HIGH_HEAD_RADIUS)
        f0, _ = spatial.taller(f0, 1, HIGH_HEAD_RADIUS)
        xt, _ = spatial.taller(x, 1, HIGH_HEAD_RADIUS)
        return _rows(stages.heads(d2, f0, xt), top, n)


high_tail_chain.launches = 0

# K4's kernel launches per call on a CUDA tensor (its twelfth is K2'); K3's
# are `medium_tail_plan(c, dtype).launches`.
HIGH_TAIL_LAUNCHES = 11
