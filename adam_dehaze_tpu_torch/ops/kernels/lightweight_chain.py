"""K1: the eval-mode low branch (LightweightDehazeModel) as hand-written
convolution kernels.

Counterpart of adam_dehaze_tpu/ops/pallas/s2d_chain.py
(`make_lightweight_chain_apply`, whose kernel `_lightweight_kernel` runs the
whole branch as one program per image). What it computes carries over:
BatchNorm folded into every conv (ops/fold.py), the residual adds, ReLUs,
the output sigmoid and the `(1 - alpha) * x + alpha * y` skip blend, with
activations stored in the compute dtype between layers and f32
accumulation. Its TPU layout (space-to-depth packing, zero-ring flat
buffers, 8-aligned strides, roll/regroup tricks) does not. What the TPU
kernel kept out of device memory, the activation between layers, is kept out
here per tile: csrc/lightweight_chain.cu runs bf16 at c = 16, 32, 48 or 64
as fused groups of layers on `wgmma` (`n_blocks + 1` launches, the
activation of a tile in shared memory across a group, halo recompute), and
fp32 and every other width as one FMA launch per layer; its source note
says what bounds it and why. `chain_plan` mirrors the choice. The same
fused body runs K3's head group (ops/kernels/tail_chain.py), whose tile
`head_tile` mirrors.

`fold_lightweight` builds the folded weights once (and packs them per group
where the fused body serves); `lightweight_chain` runs them: on a CPU tensor
through the plain version (`lightweight_chain_reference`), on a CUDA tensor
through the kernels. `lightweight_chain_tiled_reference` is the fused body's
tile, group and halo geometry in plain PyTorch, for the CPU tests.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.ops import fold
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.parallel import spatial
from adam_dehaze_tpu_torch.parallel.sharded_ops import local_ops

# Mirror of csrc/lightweight_chain.cu, so that K1's body is chosen by shape
# on any device; tests/test_torch_cuda.py holds the two against each other.
_MAX_SMEM = 232448          # 227 KB, Hopper's per-block limit
# The per-layer FMA body: a block stages an 8x16 output tile's input with a
# 1-pixel halo as f32 and the weights of 32 output channels.
_TILE_PIX = (8 + 2) * (16 + 2)
_CO_CHUNK = 32
# The fused bf16 body: widths it is instantiated for, output tile sides
# (widest first), and the kinds of its groups (K1's three, then K3's head
# group, which takes the widths HEAD_WIDTHS).
FUSED_WIDTHS = (16, 32, 48, 64)
FUSED_TILES = (32, 28, 24, 20, 16, 12, 8)
GROUP_KINDS = ("first", "res", "last", "tail_head")
HEAD_WIDTHS = (32, 64)


def layer_smem_bytes(cin: int) -> int:
    """Shared memory per block of the per-layer FMA body for a layer of
    `cin` input channels (f32 tile at stride cin + 1, f32 weights of 32
    output channels), or -1 beyond the limit."""
    smem = ((_TILE_PIX * (cin + 1) + 3) // 4 * 4 + 9 * cin * _CO_CHUNK) * 4
    return -1 if smem > _MAX_SMEM else smem


def _plane(rows: int, pitch: int) -> int:
    """Positions of one channel-octet plane of a staged buffer: the rows,
    the 66 positions the last product's taps reach beyond them, rounded to
    2 mod 8."""
    return (rows * pitch + 66 + 7) // 8 * 8 + 2


def group_smem_bytes(c: int, kind: str, tile: int) -> int:
    """Shared memory per block of one fused group at width c and output
    tile side `tile`: packed weights, shifts, the buffer of tile + 4 rows,
    the buffer of tile + 2 rows (c/2 wide for "tail_head"; for "first" at
    least the K = 32 rows of the 3 -> c layer: 4 octets of tile + 4 rows)
    and, for "first", the 3-channel f32 tile of tile + 6 rows. Every buffer
    has the pitch tile + 4."""
    pitch, octets = tile + 4, c // 8
    weights = {"first": 64 * c + 36 * c * c, "res": 36 * c * c,
               "last": 18 * c * c + 144 * c, "tail_head": 9 * c * c + 72 * c}[kind]
    shifts = 4 * {"first": 3 * c, "res": 2 * c, "last": c + 8,
                  "tail_head": c // 2 + 8}[kind]
    buf1 = octets * _plane(tile + 4, pitch) * 16
    mid_octets = octets // 2 if kind == "tail_head" else octets
    buf2 = 16 * max(mid_octets * _plane(tile + 2, pitch),
                    4 * _plane(tile + 4, pitch) if kind == "first" else 0)
    xs = ((tile + 6) ** 2 * 12 + 15) // 16 * 16 if kind == "first" else 0
    return weights + shifts + buf1 + buf2 + xs


def fused_tile(c: int) -> int:
    """The fused body's output tile side at width c: the widest whose
    largest group ("first") fits a block; 0 where the body does not serve
    the width."""
    if c not in FUSED_WIDTHS:
        return 0
    return next((t for t in FUSED_TILES
                 if group_smem_bytes(c, "first", t) <= _MAX_SMEM), 0)


def head_tile(c: int) -> int:
    """The output tile side of K3's head group at width c: the widest whose
    group fits a block; 0 where the group does not serve the width (c/2
    must be a multiple of 16)."""
    if c not in HEAD_WIDTHS:
        return 0
    return next((t for t in FUSED_TILES
                 if group_smem_bytes(c, "tail_head", t) <= _MAX_SMEM), 0)


class ChainPlan(NamedTuple):
    """What one call of K1 launches."""
    body: str                     # "fused" (wgmma groups) or "layer" (FMA, one launch a layer)
    tile: Tuple[int, int]         # output positions per block and tile (rows, columns)
    groups: Tuple[str, ...]       # fused: the kind of each launch
    launches: int
    smem_bytes: Tuple[int, ...]   # dynamic shared memory per block of each launch


def chain_plan(channels: int, n_blocks: int, dtype: torch.dtype) -> Optional[ChainPlan]:
    """The body K1 takes for this width, depth and dtype, decided before any
    launch, or None where it takes none: bf16 at a width the fused body
    serves runs `n_blocks + 1` fused groups; fp32 and the other widths that
    are multiples of 8 run `2 * n_blocks + 3` FMA launches if every layer
    (3 -> c, c -> c, c -> 3) fits a block's shared memory. At least one
    residual block (the TPU kernel's own floor)."""
    if channels % 8 or n_blocks < 1 or dtype not in (torch.float32, torch.bfloat16):
        return None
    tile = fused_tile(channels) if dtype == torch.bfloat16 else 0
    if tile:
        groups = ("first",) + ("res",) * (n_blocks - 1) + ("last",)
        return ChainPlan("fused", (tile, tile), groups, len(groups),
                         tuple(group_smem_bytes(channels, k, tile) for k in groups))
    smem = (layer_smem_bytes(3),) + (layer_smem_bytes(channels),) * (2 * n_blocks + 2)
    if min(smem) < 0:
        return None
    return ChainPlan("layer", (8, 16), (), len(smem), smem)


def chain_supported(channels: int, n_blocks: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this shape in `dtype` (see `chain_plan`)."""
    return chain_plan(channels, n_blocks, dtype) is not None


def pack_layer(w: torch.Tensor) -> torch.Tensor:
    """One conv's weights as the fused body's wgmma reads them from shared
    memory: w (taps, K, N) with K a multiple of 16 and N of 8 -> (taps,
    K / 16, 2 k octets, N / 8, 8 k rows, 8 n), the no-swizzle N-major B layout
    (8x8 core matrices of 128 bytes), one contiguous slab per (tap, k16
    step)."""
    taps, k, n = w.shape
    if k % 16 or n % 8:
        raise ValueError(f"packing needs K a multiple of 16 and N of 8, got {k} x {n}")
    return w.reshape(taps, k // 16, 2, 8, n // 8, 8).permute(0, 1, 2, 4, 3, 5).contiguous()


def unpack_layer(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of `pack_layer`: -> (taps, K, N)."""
    taps, steps, _, n_octets, _, _ = packed.shape
    return packed.permute(0, 1, 2, 4, 3, 5).reshape(taps, steps * 16, n_octets * 8)


def _pack_conv(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, cin, cout) -> the flat packed layer. The 3 -> c layer
    becomes one tap of K = 27 rows (k = (ky * 3 + kx) * 3 + ci) padded to
    32; the c -> 3 layer is padded to 8 output channels."""
    _, _, cin, cout = w.shape
    if cin == 3:
        w = F.pad(w.reshape(1, 27, cout), (0, 0, 0, 5))
    else:
        w = F.pad(w.reshape(9, cin, cout), (0, -cout % 8))
    return pack_layer(w).flatten()


def pack_group(layers) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the fused body: (packed weights, shifts) of its layers
    (w HWIO, shift) after one another, the c -> 3 bias padded to 8."""
    shifts = [F.pad(t, (0, -t.numel() % 8)) for _, t in layers]
    return (torch.cat([_pack_conv(w) for w, _ in layers]), torch.cat(shifts).contiguous())


def pack_groups(layers, n_blocks: int):
    """K1's launches on the fused body: one `pack_group` per group."""
    groups, first = [], 0
    for size in (3,) + (2,) * (n_blocks - 1) + (2,):
        groups.append(pack_group(layers[first:first + size]))
        first += size
    return tuple(groups)


class LightweightChainWeights(NamedTuple):
    """Folded layers of the branch, in order: the input ConvBlock, two per
    ResidualBlock, the mid ConvBlock and the output conv. Each is
    (weight HWIO in the compute dtype, shift f32). `groups` holds the same
    values again as the fused body reads them (`pack_groups`), empty where
    the per-layer body serves."""
    layers: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    alpha: float
    n_blocks: int
    groups: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = ()

    @property
    def dtype(self) -> torch.dtype:
        return self.layers[0][0].dtype

    @property
    def channels(self) -> int:
        return self.layers[0][0].shape[3]


@torch.no_grad()
def fold_lightweight(model, dtype: torch.dtype) -> LightweightChainWeights:
    """Fold a LightweightDehazeModel's eval-mode BNs into its convs (in f32
    from the module's parameters), cast the weights to `dtype`, and pack
    them per group where `chain_plan` takes the fused body."""
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
    n_blocks = len(model.residual_blocks)
    plan = chain_plan(layers[0][0].shape[3], n_blocks, dtype)
    groups = pack_groups(layers, n_blocks) if plan and plan.body == "fused" else ()
    return LightweightChainWeights(tuple(layers), alpha, n_blocks, groups)


def _conv(h: torch.Tensor, layer, padding: int) -> torch.Tensor:
    """conv3x3 + shift, summed in f32 over values held in the compute dtype
    (the products are exact). h NCHW."""
    w, t = layer
    return (F.conv2d(h.float(), w.float().permute(3, 2, 0, 1), padding=padding)
            + t[None, :, None, None])


def window(src: torch.Tensor, y0: int, x0: int, side: int) -> torch.Tensor:
    """Rows y0 .. y0 + side and columns x0 .. x0 + side of src (NCHW), zero
    outside the image: a tile staged with its halo."""
    n, c, h, w = src.shape
    out = src.new_zeros((n, c, side, side))
    ys, xs, ye, xe = max(y0, 0), max(x0, 0), min(y0 + side, h), min(x0 + side, w)
    if ye > ys and xe > xs:
        out[:, :, ys - y0:ye - y0, xs - x0:xe - x0] = src[:, :, ys:ye, xs:xe]
    return out


def zero_outside(v: torch.Tensor, y0: int, x0: int, h: int, w: int) -> torch.Tensor:
    """v covers image rows y0.. and columns x0.. of an h x w image: 0 at
    its positions outside the image, where the next conv pads with zeros."""
    ys = torch.arange(y0, y0 + v.shape[2])
    xs = torch.arange(x0, x0 + v.shape[3])
    inside = (((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :])
    return v * inside.to(v.device, v.dtype)


def lightweight_chain_reference(x: torch.Tensor,
                                chain: LightweightChainWeights) -> torch.Tensor:
    """Plain PyTorch version: x (N, H, W, 3) f32 -> (N, H, W, 3) f32, with
    the kernel's rounding points: activations and weights in the compute
    dtype, each conv summed in f32 (its products are exact) and the shift,
    residual, activation and blend applied in f32 before one rounding."""
    dt = chain.dtype
    xin = x.to(dt).permute(0, 3, 1, 2)
    layers = iter(chain.layers)
    h = torch.relu(_conv(xin, next(layers), 1)).to(dt)
    for _ in range(chain.n_blocks):
        y = torch.relu(_conv(h, next(layers), 1)).to(dt)
        h = torch.relu(_conv(y, next(layers), 1) + h.float()).to(dt)
    h = torch.relu(_conv(h, next(layers), 1)).to(dt)
    y = torch.sigmoid(_conv(h, next(layers), 1))
    out = (1.0 - chain.alpha) * xin.float() + chain.alpha * y
    return out.permute(0, 2, 3, 1).contiguous()


def lightweight_chain_tiled_reference(x: torch.Tensor, chain: LightweightChainWeights,
                                      tile: int) -> torch.Tensor:
    """The fused body's geometry in plain PyTorch, in the chain's dtype:
    the groups [3 -> c, rb_a, rb_b], [rb_a, rb_b] ..., [c -> c, c -> 3 +
    blend], each over `tile` x `tile` output tiles. A tile stages its input
    with the group's halo (zero outside the image), computes every layer
    without padding on a ring one position smaller, stores 0 at the ring's
    positions outside the image (the next conv pads with zeros there, not
    with relu(shift)), adds the skip from the staged input's centre, and
    writes only its own positions. Equal to `lightweight_chain_reference`
    up to the order of the f32 sums: a recomputed halo position sees the
    same operands as its owner's."""
    dt = chain.dtype
    n, h, w, _ = x.shape
    xin = x.to(dt).permute(0, 3, 1, 2)

    def run_group(src, layers, first, last):
        out = torch.empty((n, 3 if last else chain.channels, h, w),
                          dtype=torch.float32 if last else dt, device=x.device)
        halo = len(layers)
        for ty0 in range(0, h, tile):
            for tx0 in range(0, w, tile):
                a = window(src, ty0 - halo, tx0 - halo, tile + 2 * halo)
                if first:
                    a = torch.relu(_conv(a, layers[0], 0)).to(dt)
                    a = zero_outside(a, ty0 - 2, tx0 - 2, h, w)
                y = torch.relu(_conv(a, layers[-2], 0)).to(dt)
                y = zero_outside(y, ty0 - 1, tx0 - 1, h, w)
                if last:
                    res = ((1.0 - chain.alpha) * window(xin, ty0, tx0, tile).float()
                           + chain.alpha * torch.sigmoid(_conv(y, layers[-1], 0)))
                else:
                    res = torch.relu(_conv(y, layers[-1], 0)
                                     + a[:, :, 2:-2, 2:-2].float()).to(dt)
                out[:, :, ty0:ty0 + tile, tx0:tx0 + tile] = res[:, :, :h - ty0, :w - tx0]
        return out

    layers = chain.layers
    act = run_group(xin, layers[:3], True, False)
    for b in range(1, chain.n_blocks):
        act = run_group(act, layers[1 + 2 * b:3 + 2 * b], False, False)
    out = run_group(act, layers[-2:], False, True)
    return out.permute(0, 2, 3, 1).contiguous()


def lightweight_chain(x: torch.Tensor,
                      chain: LightweightChainWeights) -> torch.Tensor:
    """Run the low branch: x (N, H, W, 3) f32 NHWC in [0, 1] -> same shape
    f32. A CPU tensor takes the plain version; a CUDA tensor launches the
    body `chain_plan` names: `n_blocks + 1` fused groups, or one kernel per
    layer (`2 * n_blocks + 3`).

    On an H shard (parallel/spatial.py) the chain cannot exchange rows
    between its fused layers, so the shard first takes as many rows from
    each neighbour as the branch's receptive radius (one row for each of its
    `2 * n_blocks + 3` 3x3 layers; none at the image's true edges, where
    the kernel's own zero padding is the image's), the chain runs on that
    taller shard, and its rows are cropped back: the rows the kernel pads at
    the taller shard's inner edges reach only the rows cropped away."""
    rows = spatial.axis()
    with local_ops():
        if rows is None:
            return _chain(x, chain)
        radius = len(chain.layers)
        taller = spatial.halo(x, 1, radius, radius, fill=None)
        top = radius if rows.index > 0 else 0
        return _chain(taller, chain)[:, top:top + x.shape[1]].contiguous()


def _chain(x: torch.Tensor, chain: LightweightChainWeights) -> torch.Tensor:
    if x.device.type == "cpu":
        return lightweight_chain_reference(x, chain)
    name = "lightweight_chain"
    tensors = [t for pair in chain.layers + chain.groups for t in pair]
    _build.require_cuda_inputs(name, x, *tensors)
    _build.require(x.dim() == 4 and x.shape[3] == 3, name,
                   f"x must be (N, H, W, 3), got {tuple(x.shape)}")
    _build.require(x.dtype == torch.float32, name, f"x dtype {x.dtype} is not float32")
    dt = chain.dtype
    c = chain.channels
    plan = chain_plan(c, chain.n_blocks, dt)
    _build.require(plan is not None, name,
                   f"width {c} with {chain.n_blocks} blocks in {dt} is not supported")
    for w, t in chain.layers:
        _build.require(w.dtype == dt and w.is_contiguous(), name,
                       "weights must be contiguous and of one dtype")
        _build.require(t.dtype == torch.float32 and t.is_contiguous(), name,
                       "shifts must be contiguous float32")
    n, h, wd, _ = x.shape
    lib = _build.library()
    stream = _build.stream_ptr(x.device)
    a = torch.empty((n, h, wd, c), dtype=dt, device=x.device)
    b = torch.empty_like(a)
    out = torch.empty((n, h, wd, 3), dtype=torch.float32, device=x.device)

    if plan.body == "fused":
        _build.require(len(chain.groups) == plan.launches, name,
                       "the fused body needs the packed groups of fold_lightweight")
        x = x.contiguous()
        src, dst = b, a
        for i, (kind, (wp, shifts)) in enumerate(zip(plan.groups, chain.groups)):
            _build.require(wp.dtype == dt and wp.is_contiguous() and wp.data_ptr() % 16 == 0
                           and shifts.dtype == torch.float32 and shifts.is_contiguous(),
                           name, "packed weights must be contiguous and 16-byte aligned")
            last = i == plan.launches - 1
            err = lib.lightweight_group(
                GROUP_KINDS.index(kind), x.data_ptr(), src.data_ptr(), wp.data_ptr(),
                shifts.data_ptr(), (out if last else dst).data_ptr(), chain.alpha,
                n, h, wd, c, stream)
            _build.check(err, "lightweight_group")
            lightweight_chain.launches += 1
            src, dst = dst, src
        return out

    bf16 = int(dt == torch.bfloat16)
    xin = x.to(dt).contiguous()

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
