"""Q2's two bodies as the CPU reaches them (ops/kernels/quant.py): the body
and chunk plan of every int8 ConvBlock shape of the default branches, the
packing of each body against its inverse and against the tile body's slot
layout written out index by index, and the int8 ConvBlock whose Int8Conv2d
applies the block's BN and ReLU (the kernel's epilogue) against the unfused
Int8Conv2d -> BatchNorm2d -> ReLU, bit for bit, on the CPU (where the
wrapper is its plain version). Q1's two passes (the per-image abs-max of a
part of each image, then the quantizing at a given abs-max), on the whole
image and on row shards whose abs-max is the max of theirs, against the one
launch, bit for bit, an all-zero image included."""
import numpy as np
import pytest
import torch
from torch import nn

from adam_dehaze_tpu_torch.nn.blocks import ConvBlock, ResidualBlock
from adam_dehaze_tpu_torch.ops.kernels.quant import (
    ConvGeometry,
    image_absmax,
    pack_int8_weights,
    quantize_images,
    quantize_images_at,
    unpack_int8_weights,
)
from adam_dehaze_tpu_torch.ops.quant import Int8Conv2d, quantized_inference
from adam_dehaze_tpu_torch.ops.serving_apply import cast_for_serving
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (cin, cout, kernel, stride) of the 20 int8 ConvBlock shapes of the default
# branches (low c=32, medium c=64, high c=96; padding kernel // 2, 1 at 4x4)
# -> (body, output-channel chunk).
DEFAULT_SHAPES = {
    (3, 32, 3, 1): ("gather", 64), (32, 32, 3, 1): ("tile", 32),
    (3, 64, 7, 1): ("gather", 64), (64, 32, 3, 1): ("tile", 32),
    (64, 64, 3, 1): ("tile", 64), (128, 64, 3, 1): ("tile", 64),
    (64, 128, 4, 2): ("tile", 64), (128, 128, 3, 1): ("tile", 64),
    (128, 256, 4, 2): ("tile", 64), (256, 256, 3, 1): ("tile", 64),
    (3, 16, 3, 1): ("gather", 64), (16, 16, 3, 1): ("tile", 16),
    (3, 96, 7, 1): ("gather", 64), (96, 48, 3, 1): ("tile", 48),
    (96, 96, 3, 1): ("tile", 96), (192, 96, 3, 1): ("tile", 96),
    (96, 192, 4, 2): ("tile", 64), (192, 192, 3, 1): ("tile", 96),
    (192, 384, 4, 2): ("tile", 64), (384, 384, 3, 1): ("tile", 96),
}


def _geometry(cin, cout, k, s):
    return ConvGeometry.of(cin, cout, k, k, s, 1 if k == 4 else k // 2)


def _qweight(cout, cin, k, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8))


@pytest.mark.parametrize("shape", list(DEFAULT_SHAPES), ids=lambda s: "x".join(map(str, s)))
def test_plan_and_packing_round_trip(shape):
    """The body and chunk each default shape takes, the padded widths, and
    pack -> unpack gives the weights back with zeros in the padded
    channels."""
    cin, cout, k, s = shape
    g = _geometry(*shape)
    assert (g.body, g.n_chunk) == DEFAULT_SHAPES[shape]
    qw = _qweight(cout, cin, k, cin + cout)
    packed = pack_int8_weights(qw, g)
    assert tuple(packed.shape) == g.packed_shape and packed.dtype == torch.int8
    back = unpack_int8_weights(packed, g)
    assert back.shape == (cout, g.cin_pad, k, k)
    assert torch.equal(back[:, :cin], qw) and not back[:, cin:].any()
    if g.body == "tile":
        assert g.cin_pad % 32 == 0 and g.cout_pad == cout and cout % g.n_chunk == 0
        assert g.k_pad == k * k * g.cin_pad and packed.numel() == cout * g.k_pad
    else:
        assert g.cin_pad == 4 and g.cout_pad % 64 == 0 and g.k_pad % 32 == 0


@pytest.mark.parametrize("shape", [(32, 32, 3, 1), (48, 96, 3, 1), (64, 128, 4, 2),
                                   (40, 48, 4, 2)], ids=lambda s: "x".join(map(str, s)))
def test_tile_packing_is_the_slot_layout(shape):
    """Every byte of the tile body's slabs, found the way the kernel reads
    it: slab (chunk, stage j) holds channel group j // P and row parity
    j % P (P = 2 at 4x4 stride 2, else 1); byte (tap i, 16-channel group h,
    output octet o, output r, channel k) is weight (chunk * N + 8 o + r,
    32 (j // P) + 16 h + k) at tap (ky, kx): (i // 3, i % 3) at 3x3, (2 (i // 4)
    + j % 2, i % 4) at 4x4."""
    cin, cout, k, s = shape
    g = _geometry(*shape)
    assert g.body == "tile"
    qw = _qweight(cout, cin, k, 3)
    wp = torch.nn.functional.pad(qw, (0, 0, 0, 0, 0, g.cin_pad - cin)).numpy()
    packed = pack_int8_weights(qw, g).numpy()
    n, parities = g.n_chunk, 2 if k == 4 else 1
    taps = k * k // parities
    slab = packed.reshape(cout // n, g.stages, taps, 2, n // 8, 8, 16)
    for chunk, j, i, h, o, r, c in np.ndindex(slab.shape):
        ky, kx = (i // 3, i % 3) if k == 3 else (2 * (i // 4) + j % 2, i % 4)
        want = wp[chunk * n + 8 * o + r, 32 * (j // parities) + 16 * h + c, ky, kx]
        assert slab[chunk, j, i, h, o, r, c] == want


def test_body_choice_is_by_shape():
    """The body is a function of the shape alone: the tile body for its
    shapes with at least 16 input channels and a multiple of 16 outputs,
    the gather body for everything else."""
    assert _geometry(16, 24, 3, 1).body == "gather"          # Cout not a multiple of 16
    assert _geometry(16, 16, 3, 1).body == "tile" and _geometry(16, 16, 3, 1).cin_pad == 32
    for args in ((3, 32, 3, 3, 1, 1), (8, 32, 3, 3, 1, 1), (64, 32, 1, 1, 1, 0),
                 (64, 24, 3, 3, 1, 1), (64, 64, 4, 4, 2, 2), (64, 32, 5, 5, 1, 2)):
        assert ConvGeometry.of(*args).body == "gather", args


def _seeded_block(block, seed):
    """Random weights, BN statistics and affine parameters, eval mode."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        for m in block.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.2)
    return block.eval()


# (cin, cout, kernel, stride, padding, use_bn, relu): BN + ReLU, BN only
# (ResidualBlock's conv2), the bias only, each on the tile and the gather body.
FUSED_BLOCKS = {
    "tile_bn_relu": (32, 32, 3, 1, 1, True, True),
    "tile_4x4_bn_relu": (32, 64, 4, 2, 1, True, True),
    "tile_bn": (48, 48, 3, 1, 1, True, False),
    "tile_bias": (32, 16, 3, 1, 1, False, False),
    "gather_bn_relu": (3, 32, 7, 1, 3, True, True),
    "gather_bn": (3, 16, 3, 1, 1, True, False),
    "gather_bias_relu": (24, 24, 3, 1, 1, False, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(FUSED_BLOCKS))
def test_fused_block_matches_unfused(name, dtype):
    """quantized_inference moves the block's BN and ReLU into its
    Int8Conv2d (Identity in their places): on the CPU the block gives what
    the unfused Int8Conv2d -> BatchNorm2d -> ReLU gives, bit for bit."""
    cin, cout, k, s, p, bn, relu = FUSED_BLOCKS[name]
    block = _seeded_block(ConvBlock(cin, cout, k, s, p, use_bn=bn, activation=relu), 11)
    serving = cast_for_serving(block, dtype)
    unfused = nn.Sequential(Int8Conv2d(serving.block[0]), *list(serving.block)[1:])
    fused = quantized_inference(cast_for_serving(block, dtype))
    conv = fused.block[0]
    assert isinstance(conv, Int8Conv2d) and conv.relu == relu and (conv.bn is not None) == bn
    assert all(isinstance(m, nn.Identity) for m in list(fused.block)[1:])
    x = torch.relu(torch.randn(3, cin, 18, 20, generator=torch.Generator().manual_seed(5)))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        want, got = unfused(x), fused(x)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if relu:
        assert (got >= 0).all()


def test_residual_block_conv2_has_no_relu():
    """A ResidualBlock's second conv folds its BN but no ReLU; the first
    both."""
    block = quantized_inference(cast_for_serving(_seeded_block(ResidualBlock(32), 2),
                                                 torch.float32))
    assert block.conv1.block[0].relu and not block.conv2.block[0].relu
    assert block.conv2.block[0].bn is not None
    assert block.conv2.block[0].bn_stats.shape == (4, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("c,cin_pad", [(3, 4), (24, 32), (32, 32)])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_q1_two_passes_equal_the_one_launch_bit_for_bit(dtype, c, cin_pad, shards):
    """Q1 as its two passes over `shards` row shards of each image (each
    shard's abs-max, their max, each shard quantized at it) gives the one
    launch's int8 rows and scales bit for bit; images of very different
    ranges, one of them all zero (scale 1/127.5, q = 0)."""
    gen = torch.Generator().manual_seed(c + shards)
    x = torch.randn(3, 8, 6, c, generator=gen) * torch.tensor([3.0, 0.0, 1e-3]).view(3, 1, 1, 1)
    x = x.to(dtype)
    q, scale = quantize_images(x, cin_pad)
    parts = [p.contiguous() for p in x.chunk(shards, 1)]
    amax = torch.stack([image_absmax(p) for p in parts]).amax(0)
    got = [quantize_images_at(p, amax, cin_pad) for p in parts]
    assert torch.equal(torch.cat([g[0] for g in got], 1), q)
    for _, s in got:
        assert torch.equal(s, scale)
    assert float(scale[1]) == float(torch.tensor(1 / 127.5, dtype=torch.float32).to(dtype))
    assert not q[1].any()
