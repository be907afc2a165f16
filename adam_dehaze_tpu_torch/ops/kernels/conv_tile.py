"""The convolution that the chain kernels K3, K4 and K6 share, one launch
per layer (csrc/conv_tile.cu, whose source note says what bounds it).

`conv_tile` computes, on NHWC tensors in the compute dtype (float32 or
bfloat16),

    out = act(conv(x; w) [+ conv(x2; w2)] + shift [+ residual])

summed in f32 and rounded once. `ksize=3` is a 3x3 conv with padding 1 and
weights HWIO (3, 3, cin, cout). `ksize=2` is ConvTranspose2d(4, stride 2,
pad 1) as its four sub-pixel phases of 2x2 taps, weights (4 phases, 4 taps,
cin, cout) as `fold.fold_upblock_phases` gives them, the output twice as
high and wide: phase (a, b) lands on pixels (2m + a, 2n + b). A second
input is walked as more input channels, so a concat is never written.
`residual` may be `out`.

On a CPU tensor `conv_tile` is `conv_tile_reference`, the plain version; on
a CUDA tensor it launches the kernel or raises. `conv_tile_plan` is the
Python mirror of the library's choice of body: bf16 with every width a
multiple of 16 runs on `wgmma` (16x16 output positions by a chunk of output
channels per block, input channels in stages of 16 through a ring of
shared-memory slots), anything else on f32 FMAs. A wgmma block of at most 64
output channels is planned for two blocks an SM (three slots where four
would not leave it under half the SM's shared memory: 64 channels, 3x3), a
wider one for one block of four slots. On an NVIDIA H100 the 64-wide 3x3
trunk layers of K3 ran faster so (PERF.md, `chip_conv_steps.py k3`); the
other widths of at most 64 already fit two blocks with four slots.

The wgmma body copies a stage's weights into its slot with one bulk copy,
so it reads them from a packed copy that holds every (phase, output chunk,
stage) slab contiguously in the slot's order: `pack_conv_weights`, made
once where the weights are folded (`packed_for_kernel`) and handed to
`conv_tile` as `packed` / `packed2`; without them `conv_tile` packs on every
call. The plain versions read HWIO only.

The launches are counted by the chain that calls (K3, K4 or K6), not here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.ops.kernels import _build

# Mirror of csrc/conv_tile.cu: the wgmma body's tile, stage depth, ring,
# instantiated output-channel chunks and the widest chunk planned for two
# blocks an SM (with the shared memory a block may then take); the FMA
# body's fixed request.
WGMMA_TILE = 16
WGMMA_KC = 16
WGMMA_STAGES = 4
WGMMA_BARRIER_BYTES = 128
WGMMA_COUT_CHUNKS = (128, 96, 64, 48, 32, 16)
WGMMA_TWO_BLOCK_MAX_CHUNK = 64
WGMMA_TWO_BLOCK_SMEM = (233472 - 2 * 1024) // 2   # an SM's 228 KB, 1 KB reserved a block
FMA_TILE = (8, 16)
FMA_COUT_CHUNK = 32
FMA_KC = 32
FMA_SMEM_BYTES = ((10 * 18 * 33 + 3) // 4 * 4 + 9 * 32 * 32) * 4
MAX_SMEM_BYTES = 232448      # a block's limit on Hopper


class ConvPlan(NamedTuple):
    """What one conv launch runs."""
    body: str                 # "wgmma" or "fma"
    cout_chunk: int           # output channels per block
    tile: Tuple[int, int]     # output positions per block (rows, columns)
    kc: int                   # input channels per staged step
    stages: int               # shared-memory slots of the ring
    smem_bytes: int           # dynamic shared memory per block
    blocks_per_sm: int        # blocks an SM the plan's shared memory is built for


def conv_tile_plan(c0: int, c1: int, cout: int, ksize: int,
                   dtype: torch.dtype) -> ConvPlan:
    """The body, tiling and shared memory `conv_tile` takes for an input of
    c0 (+ c1, 0 for none) channels and `cout` output channels."""
    if ksize not in (2, 3):
        raise ValueError(f"ksize must be 2 or 3, got {ksize}")
    if dtype == torch.bfloat16 and c0 % 16 == 0 and c1 % 16 == 0 and cout % 16 == 0:
        chunk = next(n for n in WGMMA_COUT_CHUNKS if cout % n == 0)
        pixels = (WGMMA_TILE + ksize - 1) ** 2
        plane = (pixels + 5) // 8 * 8 + 2          # 16-byte units, 2 mod 8
        stage = 2 * plane * 16 + ksize * ksize * WGMMA_KC * chunk * 2
        two = chunk <= WGMMA_TWO_BLOCK_MAX_CHUNK
        stages = WGMMA_STAGES
        if two and WGMMA_BARRIER_BYTES + stages * stage > WGMMA_TWO_BLOCK_SMEM:
            stages -= 1
        return ConvPlan("wgmma", chunk, (WGMMA_TILE, WGMMA_TILE), WGMMA_KC, stages,
                        WGMMA_BARRIER_BYTES + stages * stage, 2 if two else 1)
    return ConvPlan("fma", FMA_COUT_CHUNK, FMA_TILE, FMA_KC, 1, FMA_SMEM_BYTES, 1)


def _packed_dims(w: torch.Tensor, ksize: int) -> Tuple[int, ...]:
    """(phases, taps, stages, 2 k octets, 8 k rows, chunks, n octets, 8 n)."""
    cin, cout = w.shape[-2:]
    if cin % WGMMA_KC or cout % 16:
        raise ValueError(f"packing needs widths that are multiples of 16, got {cin} -> {cout}")
    chunk = next(n for n in WGMMA_COUT_CHUNKS if cout % n == 0)
    phases, taps = (1, 9) if ksize == 3 else (4, 4)
    return phases, taps, cin // WGMMA_KC, 2, 8, cout // chunk, chunk // 8, 8


def _packed_shape(w: torch.Tensor, ksize: int) -> Tuple[int, ...]:
    phases, taps, stages, _, _, chunks, n_octets, _ = _packed_dims(w, ksize)
    return phases, chunks, stages, taps, 2, n_octets, 8, 8


def pack_conv_weights(w: torch.Tensor, ksize: int) -> torch.Tensor:
    """The weights of one input as the wgmma body stages them: for every
    (phase, output-channel chunk, stage of 16 input channels) one contiguous
    slab [tap][k octet][n octet][8 k rows][8 n], which is a slot's no-swizzle
    N-major B layout (8x8 core matrices of 128 bytes). w (3, 3, cin, cout)
    or (4 phases, 4 taps, cin, cout) -> (phases, chunks, stages, taps, 2,
    chunk / 8, 8, 8), contiguous, in w's dtype."""
    dims = _packed_dims(w, ksize)
    return w.reshape(dims).permute(0, 5, 2, 1, 3, 6, 4, 7).contiguous()


def unpack_conv_weights(packed: torch.Tensor, ksize: int) -> torch.Tensor:
    """The inverse of `pack_conv_weights`."""
    phases, chunks, stages, taps, _, n_octets, _, _ = packed.shape
    w = packed.permute(0, 3, 2, 4, 6, 1, 5, 7).reshape(
        phases, taps, stages * WGMMA_KC, chunks * n_octets * 8)
    return (w.reshape(3, 3, *w.shape[2:]) if ksize == 3 else w).contiguous()


def packed_for_kernel(w: torch.Tensor, ksize: int = 3) -> Optional[torch.Tensor]:
    """`pack_conv_weights(w)` where a layer with these weights can take the
    wgmma body (bf16, widths multiples of 16), else None."""
    cin, cout = w.shape[-2:]
    if conv_tile_plan(cin, 0, cout, ksize, w.dtype).body != "wgmma":
        return None
    return pack_conv_weights(w, ksize)


# ---------------------------------------------------------------------------
# Plain version.
# ---------------------------------------------------------------------------

def _conv_ref(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv, pad 1, summed in f32 over values held in the compute
    dtype. h NCHW, w HWIO."""
    return F.conv2d(h.float(), w.float().permute(3, 2, 0, 1), padding=1)


def subpixel_up_reference(x: torch.Tensor, phases: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(4, stride 2, pad 1) without bias from its sub-pixel
    phases (fold.fold_upblock_phases, reshaped (4, 4, Cin, Cout)): x NCHW
    (N, Cin, H, W) -> f32 (N, Cout, 2H, 2W)."""
    n, _, h, w = x.shape
    cout = phases.shape[3]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    out = x.new_empty((n, cout, 2 * h, 2 * w), dtype=torch.float32)
    for a in (0, 1):
        for b in (0, 1):
            k = phases[a * 2 + b].float().reshape(2, 2, -1, cout).permute(3, 2, 0, 1)
            out[:, :, a::2, b::2] = F.conv2d(xp[:, :, a:a + h + 1, b:b + w + 1], k)
    return out


def conv_tile_reference(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor, *,
                        ksize: int = 3, relu: bool = True,
                        residual: Optional[torch.Tensor] = None,
                        x2: Optional[torch.Tensor] = None,
                        w2: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `conv_tile` with its rounding points: f32
    sums over the values as held in the compute dtype, the epilogue in f32,
    one rounding to x's dtype."""
    conv = _conv_ref if ksize == 3 else subpixel_up_reference
    acc = conv(x.permute(0, 3, 1, 2), w)
    if x2 is not None:
        acc = acc + conv(x2.permute(0, 3, 1, 2), w2)
    acc = acc + shift.float()[None, :, None, None]
    if residual is not None:
        acc = acc + residual.permute(0, 3, 1, 2).float()
    if relu:
        acc = torch.relu(acc)
    res = acc.permute(0, 2, 3, 1).to(x.dtype)
    if out is None:
        return res.contiguous()
    out.copy_(res)
    return out


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------

def conv_tile(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor, *,
              ksize: int = 3, relu: bool = True,
              residual: Optional[torch.Tensor] = None,
              x2: Optional[torch.Tensor] = None,
              w2: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None,
              packed: Optional[torch.Tensor] = None,
              packed2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One convolution layer (see the module docstring). x (N, H, W, cin)
    and the optional x2 NHWC, w and w2 in x's dtype, shift (cout,) f32;
    returns (N, up*H, up*W, cout) in x's dtype, written into `out` when one
    is given. `packed` and `packed2` are `pack_conv_weights` of w and w2.
    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch) or raise."""
    if x.device.type == "cpu":
        return conv_tile_reference(x, w, shift, ksize=ksize, relu=relu, residual=residual,
                                   x2=x2, w2=w2, out=out)
    name = "conv_tile"
    optional = [t for t in (residual, x2, w2, out) if t is not None]
    _build.require_cuda_inputs(name, x, w, shift, *optional)
    _build.require(ksize in (2, 3), name, f"ksize must be 2 or 3, got {ksize}")
    _build.require(x.dtype in (torch.float32, torch.bfloat16), name,
                   f"expects float32 or bfloat16, got {x.dtype}")
    _build.require(x.dim() == 4, name, f"x must be (N, H, W, C), got {tuple(x.shape)}")
    n, h, wd, c0 = x.shape
    cout = w.shape[-1]
    wshape = (3, 3) if ksize == 3 else (4, 4)
    _build.require(tuple(w.shape) == (*wshape, c0, cout), name,
                   f"w must be {(*wshape, c0, cout)}, got {tuple(w.shape)}")
    _build.require((x2 is None) == (w2 is None), name, "x2 and w2 come together")
    c1 = 0
    if x2 is not None:
        c1 = x2.shape[3]
        _build.require(tuple(x2.shape) == (n, h, wd, c1), name,
                       f"x2 must be {(n, h, wd, c1)}, got {tuple(x2.shape)}")
        _build.require(tuple(w2.shape) == (*wshape, c1, cout), name,
                       f"w2 must be {(*wshape, c1, cout)}, got {tuple(w2.shape)}")
    _build.require(shift.dtype == torch.float32 and tuple(shift.shape) == (cout,), name,
                   f"shift must be ({cout},) float32")
    up = 1 if ksize == 3 else 2
    oshape = (n, up * h, up * wd, cout)
    if out is None:
        out = torch.empty(oshape, dtype=x.dtype, device=x.device)
    for t, what in ((out, "out"), (residual, "residual")):
        _build.require(t is None or tuple(t.shape) == oshape, name,
                       f"{what} must be {oshape}")
    if conv_tile_plan(c0, c1, cout, ksize, x.dtype).body == "wgmma":
        packed = pack_conv_weights(w, ksize) if packed is None else packed
        if x2 is not None:
            packed2 = pack_conv_weights(w2, ksize) if packed2 is None else packed2
        for t, src in ((packed, w), (packed2, w2)):
            _build.require(t is None or (
                t.device == x.device and t.dtype == x.dtype and t.is_contiguous()
                and t.data_ptr() % 16 == 0 and t.shape == _packed_shape(src, ksize)), name,
                "packed weights must be pack_conv_weights of the weights")
    else:
        packed = packed2 = None
    for t in (x, w, shift, *optional, out):
        # Rows of a multiple of 8 elements move as 16-byte vectors.
        _build.require(t.is_contiguous()
                       and (t.shape[-1] % 8 != 0 or t.data_ptr() % 16 == 0), name,
                       "tensors must be contiguous and 16-byte aligned")
    for t in (w, *optional, out):
        _build.require(t.dtype == x.dtype, name, f"tensors of {x.dtype} and {t.dtype}")
    _build.check(_build.library().conv_tile(
        x.data_ptr(), w.data_ptr(), packed.data_ptr() if packed is not None else None, c0,
        x2.data_ptr() if x2 is not None else None,
        w2.data_ptr() if w2 is not None else None,
        packed2.data_ptr() if packed2 is not None else None, c1,
        shift.data_ptr(), residual.data_ptr() if residual is not None else None,
        out.data_ptr(), n, h, wd, cout, ksize, int(relu),
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device)), name)
    return out
