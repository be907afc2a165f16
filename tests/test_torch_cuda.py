"""Kernels K1 to K6 and K2' of the PyTorch port and its operation probes
against their plain versions on a CUDA card (marker `cuda`; every test skips without a card),
and the serving engines on the card: the device-binned, switch and sharded
routes against the host-binned engine, the binning under the sync debug
mode, the stream routes against their per-batch counterparts; and
training: the autograd Functions of K2, K2' and K5 against plain autograd,
one bf16 train step of each default branch, a bf16 soft joint step, and the
serving kernels' refusal of a gradient; and detection: the default detector
in fp32 on the card against the CPU (level outputs, top-k candidates,
detections), in bf16 against fp32, and the launches of K2 and K5 per batch
of `evaluate_object_detection`; and precompiled serving: a bundle's CUDA
graphs against the eager dehazer (exactly), and the launch counters across
replays; and parallel/: a world of one over NCCL through the data-parallel
step, the expert-parallel router and the two-stage pipeline on one card
against the soft router.

This file imports neither JAX nor the JAX package, so that it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest keeps tests/conftest.py, which configures JAX, out.)
Tolerances: fp32 kernel vs fp32 plain at 1e-4 with TF32 off (sums in
another order); bf16 kernel vs fp32 plain at 3e-2, the bf16 bound of the
JAX tail-chain tests. The blend has one rounding per element: 1e-6 in fp32.
K1's fused tensor-core body is also held against the bf16 plain version, which
rounds at the same points, at K1_BF16_ATOL (see there), and so are the tail
chains K3 (its fused head group included) and K4 at TAIL_BF16_ATOL and the
segment chain K6 at RES_BF16_RTOL.
K6's errors are in units of the plain result's largest magnitude: a segment
ends in a ReLU or a gate, not in a clip to [0, 1]. The conv layer those
three share (`conv_tile`) is held against its plain version alone: one
rounding on both sides, so one bf16 step at most.
"""
import copy

import numpy as np
import pytest
import torch

from adam_dehaze_tpu_torch.ops.kernels.blend import blend3, blend3_reference
from adam_dehaze_tpu_torch.ops.kernels.cbam import (
    _gate_on_maps_kernel,
    _maps_kernel,
    channel_spatial_gate,
    channel_spatial_gate_reference,
    gated_maps,
    padded_stats,
    spatial_gate,
    spatial_gate_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.conv_tile import (
    WGMMA_COUT_CHUNKS,
    conv_tile,
    conv_tile_plan,
    conv_tile_reference,
    pack_conv_weights,
)
from adam_dehaze_tpu_torch.ops.kernels import lightweight_chain as k1_module
from adam_dehaze_tpu_torch.ops.kernels.res_chain import (
    fold_res_attn_chain,
    launches_of,
    res_attn_chain,
    res_attn_chain_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.tail_chain import (
    HIGH_TAIL_LAUNCHES,
    fold_high_tail,
    fold_medium_tail,
    high_tail_chain,
    high_tail_chain_reference,
    medium_tail_chain,
    medium_tail_chain_reference,
    medium_tail_chain_tiled_reference,
    medium_tail_plan,
)
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    FUSED_TILES,
    FUSED_WIDTHS,
    GROUP_KINDS,
    chain_plan,
    fold_lightweight,
    fused_tile,
    group_smem_bytes,
    head_tile,
    layer_smem_bytes,
    lightweight_chain,
    lightweight_chain_reference,
)

pytestmark = pytest.mark.cuda

FP32_ATOL = 1e-4
BF16_ATOL = 3e-2
# bf16 K1 vs bf16 plain, alpha 1: both sum each conv in f32 over the same
# bf16 values and round at the same points, so they differ only where the
# two sum orders put a value on either side of a bf16 rounding boundary.
K1_BF16_ATOL = 4e-3
# bf16 K3/K4 vs their bf16 plain versions: the same argument; the output is
# x + tanh(.) [* guidance], clipped, so a flipped bf16 rounding upstream
# (one part in 256 of an activation) reaches it at a few 1e-3.
TAIL_BF16_ATOL = 1e-2
# bf16 K6 vs its bf16 plain version, in units of the plain result's largest
# magnitude: a flipped rounding is one bf16 step, 2^-8 of the value it
# hits, and the convs after it carry it on (4.3e-3 to 6.5e-3 on the main
# path's segments on an NVIDIA H100 80GB HBM3; chip_smoke.py has more).
RES_BF16_RTOL = 2e-2


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at
    import (every xdist worker must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _seeded(module, seed):
    from adam_dehaze_tpu_torch.nn.blocks import init_params_
    gen = torch.Generator().manual_seed(seed)
    init_params_(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return module.eval()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, FP32_ATOL),
                                        (torch.bfloat16, BF16_ATOL)])
@pytest.mark.parametrize("c,n_blocks", [(32, 3), (8, 1), (48, 2)])
def test_k1_kernel_matches_plain(cuda_device, dtype, atol, c, n_blocks):
    """Odd sizes exercise the tile edges. bf16 at c=32 and c=48 runs the
    fused groups (n_blocks + 1 launches), c=8 and fp32 one FMA launch per
    layer."""
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel
    low = _seeded(LightweightDehazeModel(c, n_blocks), 1)
    x = torch.rand(2, 37, 70, 3, generator=torch.Generator().manual_seed(5))
    want = lightweight_chain_reference(x, fold_lightweight(low, torch.float32))
    chain = fold_lightweight(low.to(cuda_device), dtype)
    before = lightweight_chain.launches
    with torch.inference_mode():
        got = lightweight_chain(x.to(cuda_device), chain)
    torch.cuda.synchronize()
    plan = chain_plan(c, n_blocks, dtype)
    fused = dtype == torch.bfloat16 and c != 8
    assert plan.body == ("fused" if fused else "layer")
    assert plan.launches == (n_blocks + 1 if fused else 2 * n_blocks + 3)
    assert lightweight_chain.launches - before == plan.launches
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)


# Image sizes around the fused body's tile (side t): odd sides over several
# tiles, exactly one tile, one position more than a tile each way (the
# second tile row and column hold one position and a ring that lies outside
# the image on three sides), and an image smaller than a tile.
K1_SIDES = {"37x70": lambda t: (37, 70), "one_tile": lambda t: (t, t),
            "tile_plus_1": lambda t: (t + 1, t + 1), "5x7": lambda t: (5, 7)}


@pytest.mark.parametrize("sides", sorted(K1_SIDES))
@pytest.mark.parametrize("c,n_blocks", [(32, 3), (48, 2), (16, 1), (64, 1)])
def test_k1_tensor_core_body_matches_bf16_plain(cuda_device, c, n_blocks, sides):
    """Every bf16 layer at these widths runs the fused wgmma body. Against
    the bf16 plain version with alpha 1 (the conv stack not scaled down by
    the skip blend) a dropped tap, K step, skip add or a ring position
    outside the image that is not stored as 0 shows."""
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel
    low = _seeded(LightweightDehazeModel(c, n_blocks), 4).to(cuda_device)
    chain = fold_lightweight(low, torch.bfloat16)._replace(alpha=1.0)
    h, w = K1_SIDES[sides](fused_tile(c))
    x = torch.rand(2, h, w, 3, generator=torch.Generator().manual_seed(8))
    x = x.to(cuda_device)
    with torch.inference_mode():
        want = lightweight_chain_reference(x, chain)
        got = lightweight_chain(x, chain)
    torch.testing.assert_close(got, want, rtol=0, atol=K1_BF16_ATOL)


def test_k1_plan_mirror_matches_library(cuda_device):
    """The selector's mirror is the kernel library's own count: the FMA
    body's shared memory per layer for every width up to 264, the fused
    body's tile for every width, and its shared memory per group and tile."""
    lib = _build.library()
    for cin in range(1, 265):
        assert lib.conv3x3_smem_bytes(cin) == layer_smem_bytes(cin), cin
    for c in range(8, 136, 8):
        assert lib.lightweight_fused_tile(c) == fused_tile(c), c
        assert lib.tail_head_tile(c) == head_tile(c), c
    for c in FUSED_WIDTHS:
        for kind, name in enumerate(GROUP_KINDS):
            for tile in FUSED_TILES:
                assert (lib.lightweight_group_smem_bytes(c, kind, tile)
                        == group_smem_bytes(c, name, tile)), (c, name, tile)


def test_k1_takes_a_strided_input(cuda_device):
    """A non-contiguous image batch (a transposed view) gives the same
    contiguous result as its contiguous copy."""
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel
    low = _seeded(LightweightDehazeModel(32, 1), 3).to(cuda_device)
    chain = fold_lightweight(low, torch.bfloat16)
    x = torch.rand(2, 24, 40, 3, device=cuda_device)
    view = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    with torch.inference_mode():
        want = lightweight_chain(x, chain)
        got = lightweight_chain(view, chain)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, FP32_ATOL),
                                        (torch.bfloat16, BF16_ATOL)])
@pytest.mark.parametrize("shape", [(2, 13, 24, 96), (1, 5, 300, 8),
                                   # the alternate high branches at 256^2:
                                   # dual_branch's two blocks, encoder_decoder's
                                   (16, 128, 128, 96), (16, 64, 64, 96),
                                   (16, 32, 32, 768)])
def test_k2_kernel_matches_plain(cuda_device, dtype, atol, shape):
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(shape, generator=gen)
    g = torch.rand(shape[0], shape[3], generator=gen)
    w = torch.randn(7, 7, 2, 1, generator=gen) * 0.1
    want = channel_spatial_gate_reference(x, g, w)
    before = channel_spatial_gate.launches
    with torch.inference_mode():
        got = channel_spatial_gate(x.to(cuda_device, dtype), g.to(cuda_device),
                                   w.to(cuda_device))
    torch.cuda.synchronize()
    assert channel_spatial_gate.launches - before == 1
    torch.testing.assert_close(got.float().cpu(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, FP32_ATOL),
                                        (torch.bfloat16, BF16_ATOL)])
@pytest.mark.parametrize("shape", [(2, 13, 24, 96), (1, 5, 300, 8)])
def test_k2prime_kernel_matches_plain(cuda_device, dtype, atol, shape):
    gen = torch.Generator().manual_seed(9)
    x = torch.rand(shape, generator=gen)
    w = torch.randn(7, 7, 2, 1, generator=gen) * 0.1
    want = spatial_gate_reference(x, w)
    before = spatial_gate.launches
    with torch.inference_mode():
        got = spatial_gate(x.to(cuda_device, dtype), w.to(cuda_device))
    torch.cuda.synchronize()
    assert spatial_gate.launches - before == 1
    torch.testing.assert_close(got.float().cpu(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("gated", [True, False], ids=["k2", "k2prime"])
@pytest.mark.parametrize("shape", [(2, 13, 24, 96), (2, 9, 11, 192), (1, 7, 5, 384),
                                   (1, 5, 300, 8), (2, 6, 10, 40), (2, 9, 11, 768)])
def test_gated_maps_match_padded_stats(cuda_device, dtype, gated, shape):
    """The statistics pass against its plain version on the same input (a
    bf16 input is reduced in f32 on both sides): f32 sums in another order,
    1e-5. The channel counts give sub-groups of 4, 8, 16, 1 and 32 lanes a
    pixel, and 5 vectors a lane at C = 40, 3 at C = 768."""
    gen = torch.Generator().manual_seed(12)
    x = (torch.randn(shape, generator=gen)).to(cuda_device, dtype)
    g = torch.rand(shape[0], shape[3], generator=gen).to(cuda_device) if gated else None
    with torch.inference_mode():
        want = padded_stats(x, g)
        got = gated_maps(x, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _gate_inputs(shape, seed, dev, dtype):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=gen)
    g = torch.rand(shape[0], shape[3], generator=gen)
    w = torch.randn(7, 7, 2, 1, generator=gen) * 0.1
    return x, g, w, x.to(dev, dtype), g.to(dev), w.to(dev)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, FP32_ATOL),
                                        (torch.bfloat16, BF16_ATOL)])
def test_k2_on_h_shards_with_filled_map_halos(cuda_device, dtype, atol):
    """K2 as it runs on an H shard (ops/kernels/cbam.py:
    channel_spatial_gate_sharded): the statistics pass on each of two row
    shards, the 3 padded map rows at the inner edges overwritten by the
    neighbour's map rows (zeros left at the image's edges), then the gate
    kernel: the whole image's kernel output exactly, and its plain version;
    the unfilled maps give other rows at the inner edge."""
    x, g, w, xd, gd, wd = _gate_inputs((2, 24, 20, 96), 21, cuda_device, dtype)
    with torch.inference_mode():
        whole = channel_spatial_gate(xd, gd, wd)
        shards = [xd[:, :12].contiguous(), xd[:, 12:].contiguous()]
        maps = [_maps_kernel(s, gd) for s in shards]
        filled = [torch.cat([maps[0][:, :, :15], maps[1][:, :, 3:6]], 2),
                  torch.cat([maps[0][:, :, 12:15], maps[1][:, :, 3:]], 2)]
        before = channel_spatial_gate.launches
        got = torch.cat([_gate_on_maps_kernel(s, gd, m, wd) for s, m in zip(shards, filled)], 1)
        unfilled = _gate_on_maps_kernel(shards[0], gd, maps[0], wd)
    torch.cuda.synchronize()
    assert channel_spatial_gate.launches - before == 3
    assert torch.equal(got, whole)
    assert not torch.equal(unfilled, whole[:, :12])
    torch.testing.assert_close(got.float().cpu(), channel_spatial_gate_reference(x, g, w),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, FP32_ATOL),
                                        (torch.bfloat16, BF16_ATOL)])
def test_k2_on_channel_shards_with_reduced_maps(cuda_device, dtype, atol):
    """K2 as it runs on a channel shard (parallel/sharding.py): the
    statistics pass on each half of 384 channels (192, as the high branch's
    4c blocks under model = 2), the means averaged and the maxima maxed,
    then the gate kernel on each half: the whole tensor's maps at 1e-5 and
    the plain version of K2 on the whole."""
    x, g, w, xd, gd, wd = _gate_inputs((2, 16, 20, 384), 22, cuda_device, dtype)
    halves = [slice(0, 192), slice(192, 384)]
    with torch.inference_mode():
        maps = [_maps_kernel(xd[..., h].contiguous(), gd[:, h].contiguous()) for h in halves]
        reduced = torch.cat([(maps[0][:1] + maps[1][:1]) / 2,
                             torch.maximum(maps[0][1:], maps[1][1:])])
        whole_maps = _maps_kernel(xd, gd)
        got = torch.cat([_gate_on_maps_kernel(xd[..., h].contiguous(), gd[:, h].contiguous(),
                                              reduced, wd) for h in halves], 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(reduced, whole_maps, rtol=0, atol=1e-5)
    torch.testing.assert_close(reduced, torch.stack(padded_stats(xd, gd)), rtol=0, atol=1e-5)
    torch.testing.assert_close(got.float().cpu(), channel_spatial_gate_reference(x, g, w),
                               rtol=0, atol=atol)


def _conv_case(sides, c0, c1, cout, ksize, dtype, seed, residual):
    """Seeded inputs of one conv layer, drawn non-negative like an
    activation after a ReLU; weights scaled so that the sums stay O(1)."""
    gen = torch.Generator().manual_seed(seed)
    n, h, w = sides
    taps = (3, 3) if ksize == 3 else (4, 4)
    scale = (9 * (c0 + c1)) ** -0.5

    def draw(*shape):
        return torch.randn(*shape, generator=gen)

    case = dict(x=torch.relu(draw(n, h, w, c0)).to(dtype),
                w=(draw(*taps, c0, cout) * scale).to(dtype), shift=draw(cout) * 0.1)
    if c1:
        case.update(x2=torch.relu(draw(n, h, w, c1)).to(dtype),
                    w2=(draw(*taps, c1, cout) * scale).to(dtype))
    if residual:
        up = 1 if ksize == 3 else 2
        case["residual"] = torch.relu(draw(n, up * h, up * w, cout)).to(dtype)
    return case


# (sides, c0, c1, cout, ksize, residual): ragged sides around the 16x16
# tile, batch 1, every output-channel chunk the plan can choose (and two
# or three of them in one launch), 16-channel stages that end a width (48,
# 16), two inputs, the sub-pixel phases, the skip add.
CONV_CASES = {
    "n128_13x21": ((2, 13, 21), 128, 0, 128, 3, True),
    "n96x2_9x40": ((1, 9, 40), 192, 0, 192, 3, True),
    "n128x3_1x300": ((1, 1, 300), 384, 0, 384, 3, False),
    "n64_two_inputs": ((2, 13, 21), 64, 64, 64, 3, False),
    "n96_two_inputs": ((1, 9, 40), 96, 96, 96, 3, False),
    "n48_c48": ((2, 13, 21), 48, 0, 48, 3, True),
    "n32_c64": ((1, 9, 40), 64, 0, 32, 3, False),
    "n16_c16": ((1, 1, 300), 16, 0, 16, 3, False),
    "n16x5_c80": ((1, 9, 40), 48, 32, 80, 3, False),
    "up_n96_c384": ((1, 9, 40), 384, 0, 96, 2, False),
    "up_n64_c256": ((2, 13, 21), 256, 0, 64, 2, False),
    "up_n48_1x300": ((1, 1, 300), 192, 0, 48, 2, False),
    "up_n128": ((1, 5, 7), 64, 0, 128, 2, False),
    "fma_c24": ((2, 13, 21), 24, 0, 24, 3, True),
    "fma_c3": ((1, 9, 40), 3, 0, 16, 3, False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_tile_matches_reference(cuda_device, dtype, case):
    """One conv layer against its plain version. In bf16 both sum in f32
    over the same bf16 values and round once: they differ by one bf16 step
    (2^-8 of the value) where the sum orders straddle a rounding boundary,
    and by the f32 reordering (1e-3 absolute bounds it) near zero."""
    sides, c0, c1, cout, ksize, residual = CONV_CASES[case]
    args = _conv_case(sides, c0, c1, cout, ksize, dtype, 53, residual)
    shift = args.pop("shift")
    w = args.pop("w")
    x = args.pop("x")
    want = conv_tile_reference(x, w, shift, ksize=ksize, **args)
    on_card = {k: v.to(cuda_device) for k, v in args.items()}
    got = conv_tile(x.to(cuda_device), w.to(cuda_device), shift.to(cuda_device), ksize=ksize,
                    **on_card)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2 ** -7, atol=1e-3)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=FP32_ATOL)
    if conv_tile_plan(c0, c1, cout, ksize, dtype).body == "wgmma":
        # Weights packed once by the caller give the same bits.
        packs = dict(packed=pack_conv_weights(w, ksize).to(cuda_device))
        if c1:
            packs["packed2"] = pack_conv_weights(args["w2"], ksize).to(cuda_device)
        again = conv_tile(x.to(cuda_device), w.to(cuda_device), shift.to(cuda_device),
                          ksize=ksize, **on_card, **packs)
        torch.testing.assert_close(again, got, rtol=0, atol=0)
        with pytest.raises(ValueError):
            conv_tile(x.to(cuda_device), w.to(cuda_device), shift.to(cuda_device),
                      ksize=ksize, **on_card, packed=packs["packed"].flatten())
    if residual:
        # The skip add in place: residual is out.
        out = on_card["residual"].clone()
        on_card["residual"] = out
        again = conv_tile(x.to(cuda_device), w.to(cuda_device), shift.to(cuda_device),
                          ksize=ksize, out=out, **on_card)
        assert again is out
        torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_conv_tile_without_relu_and_reproducible(cuda_device):
    args = _conv_case((2, 13, 21), 48, 0, 96, 3, torch.bfloat16, 59, False)
    args = {k: v.to(cuda_device) for k, v in args.items()}
    want = conv_tile_reference(relu=False, **args)
    a, b = conv_tile(relu=False, **args), conv_tile(relu=False, **args)
    assert float(a.min()) < 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a.float(), want.float(), rtol=2 ** -7, atol=1e-3)


def test_conv_tile_plan_mirrors_library(cuda_device):
    """The Python plan's shared memory is the kernel library's own, for both
    bodies, both tap counts and every width that chooses another chunk."""
    lib = _build.library()
    widths = sorted({3, 8, 24, *WGMMA_COUT_CHUNKS, 80, 144, 160, 192, 256, 320, 384})
    for c0 in widths:
        for c1 in (0, 16, 24):
            for cout in widths:
                for ksize in (2, 3):
                    for dtype in (torch.float32, torch.bfloat16):
                        plan = conv_tile_plan(c0, c1, cout, ksize, dtype)
                        assert lib.conv_tile_smem_bytes(
                            c0, c1, cout, ksize, int(dtype == torch.bfloat16)
                        ) == plan.smem_bytes, (c0, c1, cout, ksize, dtype)


# K3's 64-wide trunk layers and K4's two layers that fall under the same
# plan: (sides, c0, c1, cout, ksize), ragged sides around the 16x16 tile.
TWO_BLOCK_CASES = {
    "k3_64_64": ((2, 13, 21), 64, 0, 64, 3),
    "k3_head1": ((1, 9, 40), 64, 64, 64, 3),
    "k3_up": ((2, 13, 21), 256, 0, 64, 2),
    "k4_96_48": ((1, 9, 40), 96, 0, 48, 3),
    "k4_16_16": ((2, 13, 21), 16, 0, 16, 3),
}


@pytest.mark.parametrize("case", sorted(TWO_BLOCK_CASES))
def test_two_block_plan_matches_reference(cuda_device, case):
    """Layers of 64 output channels or fewer are planned for two blocks an
    SM (three ring slots at 64 wide, 3x3): the occupancy API gives their
    kernel at least two, and each agrees with its plain version within one
    bf16 step of the result's largest magnitude (2^-7)."""
    sides, c0, c1, cout, ksize = TWO_BLOCK_CASES[case]
    plan = conv_tile_plan(c0, c1, cout, ksize, torch.bfloat16)
    assert plan.blocks_per_sm == 2
    assert plan.stages == (3 if (cout, ksize) == (64, 3) else 4)
    assert _build.library().conv_tile_blocks_per_sm(cout, ksize) >= 2
    args = _conv_case(sides, c0, c1, cout, ksize, torch.bfloat16, 67, False)
    args = {k: v.to(cuda_device) for k, v in args.items()}
    with torch.inference_mode():
        want = conv_tile_reference(**args, ksize=ksize)
        got = conv_tile(**args, ksize=ksize)
    assert _scaled_err(got, want) <= 2 ** -7


def test_conv_tile_refuses_what_it_does_not_take(cuda_device):
    args = _conv_case((1, 8, 8), 16, 0, 16, 3, torch.bfloat16, 61, False)
    args = {k: v.to(cuda_device) for k, v in args.items()}
    with pytest.raises(ValueError):
        conv_tile(**{**args, "w": args["w"][..., :8].contiguous()})     # shift of another width
    with pytest.raises(ValueError):
        conv_tile(**{**args, "x": args["x"].half(), "w": args["w"].half()})
    with pytest.raises(ValueError):
        conv_tile(x2=args["x"], **args)                                 # x2 without w2
    with pytest.raises(ValueError):
        conv_tile(**{**args, "x": args["x"].transpose(1, 2)})           # not contiguous


def _tail_case(kind, c, seed, size=(36, 72)):
    """A seeded branch of width c, tail inputs drawn non-negative like the
    real decoder state, and the tail's functions."""
    from adam_dehaze_tpu_torch.models.branches import (
        HighIntensityDehazeModel,
        MediumIntensityDehazeModel,
    )
    if kind == "medium":
        model = _seeded(MediumIntensityDehazeModel(c), seed)
        fns = (fold_medium_tail, medium_tail_chain, medium_tail_chain_reference,
               lambda dtype: medium_tail_plan(c, dtype).launches)
    else:
        model = _seeded(HighIntensityDehazeModel(c), seed)
        fns = (fold_high_tail, high_tail_chain, high_tail_chain_reference,
               lambda dtype: HIGH_TAIL_LAUNCHES)
    gen = torch.Generator().manual_seed(seed + 1)
    h, w = size
    d1 = torch.relu(torch.randn(2, h // 2, w // 2, 4 * c, generator=gen))
    f0 = torch.relu(torch.randn(2, h, w, c, generator=gen))
    x = torch.rand(2, h, w, 3, generator=gen)
    return model, (d1, f0, x), fns


@pytest.mark.parametrize("dtype,atol", [(torch.float32, FP32_ATOL),
                                        (torch.bfloat16, BF16_ATOL)])
@pytest.mark.parametrize("kind,c", [("medium", 64), ("medium", 16), ("high", 96),
                                    ("high", 16), ("high", 48)])
def test_tail_kernels_match_fp32_plain(cuda_device, dtype, atol, kind, c):
    """Sizes that are no multiple of the 8x16 tile exercise its edges;
    c=16 takes the FMA body for the c/2-wide layers in bf16 too, c=48 and
    96 a 16-channel last input chunk or output chunk; medium c=64 in bf16
    the head group (5 launches, 6 otherwise)."""
    model, inputs, (fold_fn, tail, reference, launches) = _tail_case(kind, c, 11)
    want = reference(*inputs, fold_fn(model, torch.float32))
    weights = fold_fn(model.to(cuda_device), dtype)
    before = tail.launches, spatial_gate.launches
    with torch.inference_mode():
        got = tail(*[t.to(cuda_device) for t in inputs], weights)
    torch.cuda.synchronize()
    assert tail.launches - before[0] == launches(dtype)
    assert spatial_gate.launches - before[1] == (1 if kind == "high" else 0)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("kind,c", [("medium", 64), ("high", 96), ("high", 48)])
def test_tail_kernels_match_bf16_plain(cuda_device, kind, c):
    """bf16 kernels against the bf16 plain version, which rounds at the
    same points: a dropped tap, phase, input half or residual add shows
    here, where the 3e-2 bound against the fp32 plain version is blind."""
    model, inputs, (fold_fn, tail, reference, _) = _tail_case(kind, c, 13)
    weights = fold_fn(model.to(cuda_device), torch.bfloat16)
    inputs = [t.to(cuda_device) for t in inputs]
    with torch.inference_mode():
        want = reference(*inputs, weights)
        got = tail(*inputs, weights)
    torch.testing.assert_close(got, want, rtol=0, atol=TAIL_BF16_ATOL)


# (c, image sides): the head group's tile is 24 at c = 64 and 32 at c = 32;
# sides that end in a part of a tile, exactly one tile, a tile and 4 more
# positions each way, and a non-square image.
HEAD_CASES = {"c64_36x72": (64, (36, 72)), "c64_one_tile": (64, (24, 24)),
              "c64_tile_plus_4": (64, (28, 28)), "c32_68x44": (32, (68, 44)),
              "c32_one_tile": (32, (32, 32))}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_k3_head_group_matches_bf16_plain(cuda_device, case):
    """bf16 K3 at c = 64 and 32 runs its last two layers as the fused head
    group (5 launches): against the bf16 plain version and the tiled plain
    version at TAIL_BF16_ATOL. A dropped tap, a ring position outside the
    image that is not stored as 0, or the image read off by a pixel shows."""
    c, size = HEAD_CASES[case]
    model, inputs, (fold_fn, tail, reference, _) = _tail_case("medium", c, 71, size=size)
    weights = fold_fn(model.to(cuda_device), torch.bfloat16)
    plan = medium_tail_plan(c, torch.bfloat16)
    assert plan.head == "group" and plan.launches == 5 and plan.tile == head_tile(c)
    inputs = [t.to(cuda_device) for t in inputs]
    before = tail.launches
    with torch.inference_mode():
        want = reference(*inputs, weights)
        tiled = medium_tail_chain_tiled_reference(*inputs, weights, plan.tile)
        got = tail(*inputs, weights)
    torch.cuda.synchronize()
    assert tail.launches - before == 5
    torch.testing.assert_close(got, want, rtol=0, atol=TAIL_BF16_ATOL)
    torch.testing.assert_close(got, tiled, rtol=0, atol=TAIL_BF16_ATOL)


def test_tail_kernels_are_reproducible(cuda_device):
    """The channel reduction is two-stage, without atomics: two runs give
    the same bits."""
    model, inputs, (fold_fn, tail, _, _) = _tail_case("high", 32, 17)
    weights = fold_fn(model.to(cuda_device), torch.float32)
    inputs = [t.to(cuda_device) for t in inputs]
    with torch.inference_mode():
        a, b = tail(*inputs, weights), tail(*inputs, weights)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tail_kernels_refuse_what_they_do_not_take(cuda_device):
    from adam_dehaze_tpu_torch.ops.serving_apply import make_medium_tail_apply
    model, (d1, f0, x), (fold_fn, tail, _, _) = _tail_case("medium", 16, 19)
    weights = fold_fn(model.to(cuda_device), torch.float32)
    d1, f0, x = (t.to(cuda_device) for t in (d1, f0, x))
    with pytest.raises(ValueError):
        tail(d1[:, :, :-1], f0, x, weights)                  # d1 not half of x
    with pytest.raises(ValueError):
        tail(d1, f0[..., :8], x, weights)                    # f0 of another width
    apply = make_medium_tail_apply(model, torch.float32)
    with pytest.raises(ValueError):
        apply(torch.rand(1, 30, 32, 3, device=cuda_device))  # 30 is no multiple of 4


@pytest.mark.parametrize("level", ["medium", "high"])
def test_tail_apply_matches_canonical_on_card(cuda_device, level):
    """The tail applies against the canonical forward of the same serving
    dtype, fp32, on the card."""
    from adam_dehaze_tpu_torch.ops.serving_apply import (
        cast_for_serving,
        make_high_tail_apply,
        make_medium_tail_apply,
    )
    model, (_, _, x), _ = _tail_case(level, 32, 23, size=(40, 64))
    model = model.to(cuda_device)
    make = make_medium_tail_apply if level == "medium" else make_high_tail_apply
    x = x.to(cuda_device)
    with torch.inference_mode():
        want = cast_for_serving(model, torch.float32)(x)
        got = make(model, torch.float32)(x)
    torch.testing.assert_close(got, want, rtol=0, atol=FP32_ATOL)


def _res_case(kinds, c, shape, seed):
    """Seeded blocks of width c and an input drawn non-negative like the
    activation after a ConvBlock."""
    from adam_dehaze_tpu_torch.nn.blocks import AttentionBlock, ResidualBlock
    blocks = _seeded(torch.nn.Sequential(
        *[ResidualBlock(c) if k == "res" else AttentionBlock(c) for k in kinds]), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    return blocks, torch.relu(torch.randn(*shape, c, generator=gen))


def _scaled_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        1.0, float(want.float().abs().max()))


RES_CASES = {
    # Odd sides exercise the tile edges; c=48 a 16-channel last chunk.
    "c48_13x21": (("res", "attn", "res"), 48, (2, 13, 21)),
    "c128_9x40": (("res", "res", "attn", "res", "attn"), 128, (1, 9, 40)),
    # The high branch's e2b segment at its main-path shape, two images.
    "high_e2b": (("res", "res", "attn", "res", "attn", "res", "attn"), 384, (2, 64, 64)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(RES_CASES))
def test_k6_kernels_match_plain(cuda_device, dtype, case):
    """fp32 against the fp32 plain version; bf16 against it too, and
    against the bf16 plain version, which rounds at the same points."""
    kinds, c, shape = RES_CASES[case]
    blocks, x = _res_case(kinds, c, shape, 31)
    blocks, x = blocks.to(cuda_device), x.to(cuda_device)
    weights = fold_res_attn_chain(blocks, dtype)
    before = res_attn_chain.launches, channel_spatial_gate.launches
    with torch.inference_mode():
        want = res_attn_chain_reference(x, fold_res_attn_chain(blocks, torch.float32))
        kept = x.clone()
        got = res_attn_chain(x, weights)
        torch.cuda.synchronize()
        assert (res_attn_chain.launches - before[0],
                channel_spatial_gate.launches - before[1]) == launches_of(kinds)
        torch.testing.assert_close(x, kept, rtol=0, atol=0)     # x is only read
        assert got.dtype == dtype and got.shape == x.shape
        assert _scaled_err(got, want) <= (FP32_ATOL if dtype == torch.float32 else BF16_ATOL)
        if dtype == torch.bfloat16:
            assert _scaled_err(got, res_attn_chain_reference(x, weights)) <= RES_BF16_RTOL
            # A bf16 input is used where it lies, and still only read.
            xb = x.bfloat16()
            kept = xb.clone()
            again = res_attn_chain(xb, weights)
            torch.testing.assert_close(xb, kept, rtol=0, atol=0)
            torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_k6_kernels_are_reproducible(cuda_device):
    """No atomics anywhere in the chain: two runs give the same bits."""
    kinds, c, shape = RES_CASES["c128_9x40"]
    blocks, x = _res_case(kinds, c, shape, 37)
    weights = fold_res_attn_chain(blocks.to(cuda_device), torch.bfloat16)
    x = x.to(cuda_device)
    with torch.inference_mode():
        a, b = res_attn_chain(x, weights), res_attn_chain(x, weights)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k6_refuses_what_it_does_not_take(cuda_device):
    blocks, x = _res_case(("res", "attn"), 32, (1, 8, 8), 41)
    weights = fold_res_attn_chain(blocks.to(cuda_device), torch.float32)
    x = x.to(cuda_device)
    with pytest.raises(ValueError):
        res_attn_chain(x[..., :16], weights)                  # another width
    with pytest.raises(ValueError):
        res_attn_chain(x, weights._replace(kinds=("attn", "res")))
    narrow, x24 = _res_case(("res",), 24, (1, 8, 8), 43)     # 24 is no multiple of 16
    with pytest.raises(ValueError):
        res_attn_chain(x24.to(cuda_device),
                       fold_res_attn_chain(narrow.to(cuda_device), torch.float32))


@pytest.mark.parametrize("level,kwargs", [
    ("medium", dict(segments=("e1", "e2b", "d1"))),
    ("high", dict(segments=("e1", "e2b", "d1"))),
    ("high", dict(segments=("e2b",), tail=True))],
    ids=["chain_hybrid", "high_all", "res_e2b_tail_chain"])
def test_chain_apply_matches_canonical_on_card(cuda_device, level, kwargs):
    """The chain applies against the canonical forward of the same serving
    dtype, fp32, on the card."""
    from adam_dehaze_tpu_torch.ops.serving_apply import BranchChainApply, cast_for_serving
    model, (_, _, x), _ = _tail_case(level, 32, 47, size=(40, 64))
    model, x = model.to(cuda_device), x.to(cuda_device)
    before = res_attn_chain.launches
    with torch.inference_mode():
        want = cast_for_serving(model, torch.float32)(x)
        got = BranchChainApply(model, torch.float32, level, **kwargs)(x)
    assert res_attn_chain.launches > before
    torch.testing.assert_close(got, want, rtol=0, atol=FP32_ATOL)


def test_low_canonical_candidate_launches_no_k1(cuda_device):
    """The low branch's `canonical` serving candidate is the module path
    (cuDNN), never K1; `chain` is K1. In fp32 with TF32 off both give the
    canonical result within 1e-4."""
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel
    from adam_dehaze_tpu_torch.serving_autotune import candidate_builders
    low = _seeded(LightweightDehazeModel(32, 3), 5).to(cuda_device)
    cands = candidate_builders(low, torch.float32, (2, 32, 32, 3))
    assert set(cands) == {"canonical", "chain"}
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    before = k1_module.lightweight_chain.launches
    with torch.inference_mode():
        canonical = cands["canonical"]()(x)
        torch.cuda.synchronize()
        assert k1_module.lightweight_chain.launches == before
        chain = cands["chain"]()(x)
    assert k1_module.lightweight_chain.launches > before
    torch.testing.assert_close(chain, canonical, rtol=0, atol=FP32_ATOL)


def test_probes_on_card(cuda_device):
    from adam_dehaze_tpu_torch.tools import probe_ops
    before = probe_ops.probe_op.launches
    lines = []
    assert probe_ops.run_probes(cuda_device, log=lines.append) == [], lines
    assert probe_ops.probe_op.launches - before == len(probe_ops.PROBES) == 10
    x, w, wrep = probe_ops.probe_inputs(cuda_device)
    with pytest.raises(ValueError):
        probe_ops.probe_op("A_row_reduce_384", x.float(), w, wrep)    # not bf16
    with pytest.raises(ValueError):
        probe_ops.probe_op("B_dot_1row_K384", x, wrep, w)             # weights swapped


def _probe_inputs(flat, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(flat, 384, generator=gen).bfloat16().to(device)
    return x, torch.randn(384, 128, generator=gen).to(device), \
        torch.randn(128, 384, generator=gen).to(device)


def _probe_out(name, device):
    """A NaN-filled result buffer: a pattern that writes nothing shows."""
    from adam_dehaze_tpu_torch.tools import probe_ops
    return torch.full((probe_ops.ROWS, probe_ops.PROBES[name][2]), float("nan"), device=device)


# 8 and 9: one band, most row lanes empty; 1088 the tool's height and 1089 one
# row over; 65536 more bands (64 rows or more each) than the card has SMs.
@pytest.mark.parametrize("flat", [8, 9, 1088, 1089, 65536])
def test_probe_kernels_match_plain_at_any_height(cuda_device, flat):
    from adam_dehaze_tpu_torch.tools import probe_ops
    if flat == 65536:
        assert flat // 64 > torch.cuda.get_device_properties(cuda_device).multi_processor_count
    x, w, wrep = _probe_inputs(flat, cuda_device, flat)
    before = probe_ops.probe_op.launches
    for name in probe_ops.PROBES:
        got = probe_ops.probe_op(name, x, w, wrep, _probe_out(name, cuda_device))
        want = probe_ops.probe_reference(name, x, w, wrep)
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=probe_ops.PROBE_RTOL * scale,
                                   msg=lambda m, name=name: f"{name} at flat {flat}: {m}")
    assert probe_ops.probe_op.launches - before == len(probe_ops.PROBES)


@pytest.mark.parametrize("flat", [1088, 65536])
def test_probe_kernels_repeat_bit_for_bit(cuda_device, flat):
    """The ticket is ready again after each launch and the bands are summed
    in a fixed order: two rounds of the ten give the same bits."""
    from adam_dehaze_tpu_torch.tools import probe_ops
    x, w, wrep = _probe_inputs(flat, cuda_device, 1)
    rounds = [{name: probe_ops.probe_op(name, x, w, wrep, _probe_out(name, cuda_device))
               for name in probe_ops.PROBES} for _ in range(2)]
    for name in probe_ops.PROBES:
        assert torch.isfinite(rounds[0][name]).all(), name
        assert torch.equal(rounds[0][name], rounds[1][name]), name


def test_probe_kernels_on_a_side_stream(cuda_device):
    from adam_dehaze_tpu_torch.tools import probe_ops
    x, w, wrep = _probe_inputs(1088, cuda_device, 2)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = {name: probe_ops.probe_op(name, x, w, wrep, _probe_out(name, cuda_device))
               for name in probe_ops.PROBES}
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    assert ("probe_op", x.device.index, side.cuda_stream) in _build._SCRATCH
    for name, out in got.items():
        want = probe_ops.probe_reference(name, x, w, wrep)
        torch.testing.assert_close(out, want, rtol=0, atol=probe_ops.PROBE_RTOL * max(
            1.0, float(want.abs().max())), msg=lambda m, name=name: f"{name}: {m}")


def test_autotune_on_card_offers_and_times_the_kernels(cuda_device, tmp_path):
    from adam_dehaze_tpu_torch.serving_autotune import candidate_builders, load_or_tune
    cache = str(tmp_path / "tune.json")
    for level, want in (("medium", {"tail_chain", "chain_hybrid"}),
                        ("high", {"tail_chain", "res_chain_e2b", "res_e2b_tail_chain"})):
        model, _, _ = _tail_case(level, 16, 29)
        model = model.to(cuda_device)
        assert set(candidate_builders(model, torch.bfloat16)) == {"canonical"} | want
        _, report = load_or_tune(model, torch.bfloat16, (2, 32, 32, 3), cache_path=cache)
        assert all(report["table"][k] is not None for k in {"canonical"} | want), report
        _, again = load_or_tune(model, torch.bfloat16, (2, 32, 32, 3), cache_path=cache)
        assert again["cached"] is True and again["best"] == report["best"]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6),
                                        (torch.bfloat16, BF16_ATOL)])
def test_k5_kernel_matches_plain(cuda_device, dtype, atol):
    gen = torch.Generator().manual_seed(7)
    ys = [torch.rand(3, 17, 19, 3, generator=gen) for _ in range(3)]
    w = torch.softmax(torch.randn(3, 3, generator=gen), dim=1)
    want = blend3_reference(w, *ys)
    before = blend3.launches
    got = blend3(w.to(cuda_device), *[y.to(cuda_device, dtype) for y in ys])
    torch.cuda.synchronize()
    assert blend3.launches - before == 1
    torch.testing.assert_close(got.float().cpu(), want, rtol=0, atol=atol)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    """On a CUDA tensor a wrapper launches its kernel or raises; it never
    gives way to the plain version."""
    x = torch.rand(1, 4, 4, 12, device=cuda_device)   # C not a multiple of 8
    with pytest.raises(ValueError):
        channel_spatial_gate(x, torch.rand(1, 12, device=cuda_device),
                             torch.rand(7, 7, 2, 1, device=cuda_device))
    y = torch.rand(1, 4, 4, 3, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        blend3(torch.rand(1, 3, device=cuda_device), y, y, y)
    # With a gradient to record, K5 runs its autograd Function, whose forward
    # is the kernel: it still raises on what the kernel does not take.
    wq = torch.rand(1, 3, device=cuda_device, requires_grad=True)
    z = torch.rand(1, 4, 3, 4, device=cuda_device).transpose(2, 3)     # not contiguous
    with pytest.raises(ValueError):
        blend3(wq, z, z, z)


def test_small_slice_on_card_matches_cpu(cuda_device):
    """The serving slice at small widths: forced labels over every class,
    fp32, on the card (kernels) and on the CPU (plain versions)."""
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for level, ch in (("low", 8), ("medium", 8), ("high", 16)):
        cfg["dehazing"][level]["channels"] = ch
    router = _seeded(create_router(create_branch_models(cfg),
                                   create_classifier(cfg), cfg), 2)
    x = np.random.default_rng(3).random((5, 32, 32, 3), dtype=np.float32)
    labels = np.arange(5) % 3
    outs = []
    for dev in ("cpu", cuda_device):
        d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev)
        with torch.inference_mode():
            y, _ = d.engine(torch.from_numpy(x).to(dev), intensity=labels)
        outs.append(y.cpu())
        soft = d(x)
        assert np.isfinite(soft).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-4)


def _small_dehazer(device, seed=2, quant=None, **kwargs):
    """The serving slice at small widths, fp32, seeded (as
    test_small_slice_on_card_matches_cpu), served in `quant`
    (cuda.serving_quant); kwargs go to AdaptiveDehazer."""
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32", "serving_quant": quant}})
    for level, ch in (("low", 8), ("medium", 8), ("high", 16)):
        cfg["dehazing"][level]["channels"] = ch
    router = _seeded(create_router(create_branch_models(cfg), create_classifier(cfg), cfg), seed)
    return AdaptiveDehazer(router, None, cfg, device=device, **kwargs)


@pytest.mark.parametrize("spill", [False, True], ids=["fidelity", "spill"])
def test_device_binned_matches_forced_engine_on_card(cuda_device, spill):
    """Forced labels over every class: the device-binned engine (one read of
    the chunk classes) serves each image as the host-binned engine does.
    With spill and balanced labels the capacity plan moves nothing."""
    d = _small_dehazer(cuda_device)
    x = torch.from_numpy(np.random.default_rng(3).random((9, 32, 32, 3), dtype=np.float32))
    labels = np.arange(9) % 3
    fn = d._device_binned_fn(4, spill)
    with torch.inference_mode():
        want, _ = d.engine(x.to(cuda_device), intensity=labels)
        got, intensity, logits = fn(x.to(cuda_device), labels)
    assert got.device.type == "cuda" and tuple(logits.shape) == (9, 3)
    np.testing.assert_array_equal(intensity.cpu().numpy(), labels)
    torch.testing.assert_close(got, want, rtol=0, atol=FP32_ATOL)


def test_switch_and_sharded_match_route_hard_on_card(cuda_device):
    d = _small_dehazer(cuda_device)
    x = np.random.default_rng(4).random((5, 32, 32, 3), dtype=np.float32)
    want, want_i = d.route_hard(x)
    for got, got_i in (d.route_switch(x), d.route_sharded(x), d.route_device_binned(x)):
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def test_device_binning_does_not_sync(cuda_device):
    """The classifier and the binning, up to the one event-guarded read,
    under set_sync_debug_mode("error"): no op of theirs synchronizes."""
    from adam_dehaze_tpu_torch.models.routing import _device_capacity_labels

    d = _small_dehazer(cuda_device)
    x = torch.from_numpy(np.random.default_rng(5).random((9, 32, 32, 3), dtype=np.float32))
    xd = x.to(cuda_device)
    labels = np.arange(9) % 3
    with torch.inference_mode():
        for spill in (False, True):
            fn = d._device_binned_fn(4, spill)
            want = fn(xd, labels)[0]          # warm: allocations, lazy folds
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                binned = [fn.bin(xd), fn.bin(xd, labels)]
                _device_capacity_labels(torch.zeros(9, dtype=torch.long, device=cuda_device),
                                        torch.rand(9, 3, device=cuda_device), 3, 3)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.testing.assert_close(fn.serve(binned[1])[0], want, rtol=0, atol=FP32_ATOL)


def test_route_device_binned_stream_on_card(cuda_device):
    """Ragged batches, padded with their last image and staged through the
    pinned ring, against route_device_binned batch by batch."""
    d = _small_dehazer(cuda_device)
    x = np.random.default_rng(6).random((20, 32, 32, 3), dtype=np.float32)
    batches = [x[:8], x[8:11], x[11:19], x[19:], x[:5], x[5:8]]
    for depth in (1, 2):
        got = list(d.route_device_binned_stream(batches, chunk=4, depth=depth))
        assert len(got) == len(batches)
        for (y, i), b in zip(got, batches):
            want, want_i = d.route_device_binned(b, chunk=4)
            np.testing.assert_array_equal(i, want_i)
            np.testing.assert_allclose(y, want, rtol=0, atol=FP32_ATOL)


def test_route_hard_stream_and_queued_on_card(cuda_device):
    d = _small_dehazer(cuda_device)
    x = np.random.default_rng(7).random((12, 32, 32, 3), dtype=np.float32)
    batches = [x[:5], x[5:9], x[9:]]
    for (y, i), b in zip(d.route_hard_stream(batches), batches, strict=True):
        want, want_i = d.route_hard(b)
        np.testing.assert_array_equal(i, want_i)
        np.testing.assert_allclose(y, want, rtol=0, atol=FP32_ATOL)
    want, want_i = d.route_hard(x)
    seen = np.zeros(12, np.int32)
    for y, gidx, cls in d.route_hard_queued(batches, queue_bucket=4):
        assert y.device.type == "cuda" and (want_i[gidx] == cls).all()
        np.testing.assert_allclose(y.cpu().numpy(), want[gidx], rtol=0, atol=FP32_ATOL)
        seen[gidx] += 1
    np.testing.assert_array_equal(seen, 1)


def test_soft_adaptive_infer_launches_k5_once(cuda_device):
    from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER, make_adaptive_infer

    d = _small_dehazer(cuda_device)
    x = np.random.default_rng(8).random((3, 32, 32, 3), dtype=np.float32)
    fn = make_adaptive_infer(d._serving.classifier,
                             [d._serving.models[lvl] for lvl in INTENSITY_ORDER], "soft",
                             temperature=d.router.temperature)
    before = blend3.launches
    with torch.inference_mode():
        y, _ = fn(torch.from_numpy(x).to(cuda_device))
    assert blend3.launches == before + 1
    np.testing.assert_allclose(y.cpu().numpy(), d(x), rtol=0, atol=FP32_ATOL)


# ---------------------------------------------------------------- training ---
# K2 is an autograd Function: its forward is the kernel, its backward the VJP
# of the plain version (as the JAX package's custom_vjp). The K2 gradient
# bounds are in units of each gradient's largest magnitude, against plain
# autograd of the plain version on the same inputs in the same dtype.
K2_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 128, 128, 192), (16, 64, 64, 384),
                                   (16, 256, 256, 96)], ids=["e1_d1", "e2_b", "d2"])
def test_k2_function_gradients_match_plain_autograd(cuda_device, dtype, shape):
    """At the high branch's AttentionBlock shapes (c = 96, 256^2, batch 16):
    the forward launches the kernel once and matches the plain version (at
    1e-4 in fp32, 3e-2 in bf16, of its largest magnitude); the gradients
    match plain autograd of the plain version; the backward launches
    nothing."""
    gen = torch.Generator().manual_seed(shape[-1])
    base = (torch.randn(shape, generator=gen), torch.rand(shape[0], shape[-1], generator=gen),
            torch.randn(7, 7, 2, 1, generator=gen) * 0.1)
    dy = torch.randn(shape, generator=gen).to(cuda_device, dtype)
    ref = [t.to(cuda_device, dtype).requires_grad_(True) for t in base]
    y_ref = channel_spatial_gate_reference(*ref)
    want = torch.autograd.grad(y_ref, ref, dy)
    ours = [t.to(cuda_device, dtype).requires_grad_(True) for t in base]
    before = channel_spatial_gate.launches
    y = channel_spatial_gate(*ours)
    assert channel_spatial_gate.launches - before == 1
    got = torch.autograd.grad(y, ours, dy)
    torch.cuda.synchronize()
    assert channel_spatial_gate.launches - before == 1
    # x is drawn from N(0, 1), so |y| reaches 4: the bounds are in units of
    # the largest magnitude (one bf16 step at 3.7 is 0.031).
    bound = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    assert float((y.float() - y_ref.float()).abs().max()) <= bound * float(
        y_ref.float().abs().max())
    for a, b in zip(got, want):
        assert a.dtype == dtype
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= K2_GRAD_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k5_function_forward_and_gradients(cuda_device, dtype):
    """K5 with a gradient, at the soft joint step's shapes (16 images at
    256^2): the forward launches the kernel once and matches the plain
    version (fp32 1e-4, bf16 3e-2 of its largest magnitude); every gradient
    matches plain autograd of the plain version in the same dtype (the
    backward is that formula, so 1e-4 / 3e-2 of each gradient's largest
    magnitude bound sums taken in another order); the backward launches
    nothing."""
    gen = torch.Generator().manual_seed(5)
    w = torch.softmax(torch.randn(16, 3, generator=gen), dim=1)
    ys = [torch.rand(16, 256, 256, 3, generator=gen) for _ in range(3)]
    g = torch.randn(16, 256, 256, 3, generator=gen).to(cuda_device, dtype)
    ref = [w.to(cuda_device).requires_grad_(True)] + [
        y.to(cuda_device, dtype).requires_grad_(True) for y in ys]
    y_ref = blend3_reference(*ref)
    want = torch.autograd.grad(y_ref, ref, g)
    ours = [t.detach().clone().requires_grad_(True) for t in ref]
    before = blend3.launches
    y = blend3(*ours)
    assert blend3.launches - before == 1
    got = torch.autograd.grad(y, ours, g)
    torch.cuda.synchronize()
    assert blend3.launches - before == 1
    tol = K2_GRAD_TOL[dtype]
    with torch.no_grad():
        y32 = blend3_reference(w.to(cuda_device), *[t.float() for t in ours[1:]])
    assert float((y.float() - y32).abs().max()) <= tol * float(y32.abs().max())
    for a, b, t in zip(got, want, ours):
        assert a.dtype == t.dtype
        assert float((a.float() - b.float()).abs().max()) <= tol * float(b.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k2_prime_function_forward_and_gradients(cuda_device, dtype):
    """K2' with a gradient, at the high tail's shape (16, 256^2, 96): the
    forward launches the kernel once and matches the fp32 plain version; the
    gradients match plain autograd of the plain version in the same dtype
    (its backward recomputes it); the backward launches nothing."""
    shape = (16, 256, 256, 96)
    gen = torch.Generator().manual_seed(9)
    base = (torch.randn(shape, generator=gen), torch.randn(7, 7, 2, 1, generator=gen) * 0.1)
    dy = torch.randn(shape, generator=gen).to(cuda_device, dtype)
    ref = [t.to(cuda_device, dtype).requires_grad_(True) for t in base]
    want = torch.autograd.grad(spatial_gate_reference(*ref), ref, dy)
    ours = [t.to(cuda_device, dtype).requires_grad_(True) for t in base]
    before = spatial_gate.launches
    y = spatial_gate(*ours)
    assert spatial_gate.launches - before == 1
    got = torch.autograd.grad(y, ours, dy)
    torch.cuda.synchronize()
    assert spatial_gate.launches - before == 1
    with torch.no_grad():
        y32 = spatial_gate_reference(*(t.float() for t in ours))
    tol = K2_GRAD_TOL[dtype]
    assert float((y.float() - y32).abs().max()) <= tol * float(y32.abs().max())
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert float((a.float() - b.float()).abs().max()) <= tol * float(b.float().abs().max())


def test_bf16_soft_joint_step(cuda_device):
    """One bf16 soft joint step at the default widths (16 images at 256^2)
    through the joint trainer's step: finite components, a finite gradient
    on every trainable parameter, none on the frozen classifier, whose
    parameters do not move; K5 launched once, K2 six times."""
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.losses.dehazing import get_joint_loss
    from adam_dehaze_tpu_torch.training.train_joint import build_router_state, make_train_step

    cfg = load_config()
    cfg["classifier"]["checkpoint_dir"] = cfg["dehazing"]["checkpoint_dir"] = "absent"
    router, state = build_router_state(cfg, cuda_device)
    router.train()
    frozen = {k: v.clone() for k, v in router.classifier.named_parameters()}
    loss = get_joint_loss(cfg)
    nets = loss.init(torch.Generator().manual_seed(0), cuda_device)
    gen = torch.Generator().manual_seed(7)
    batch = {k: torch.rand(16, 256, 256, 3, generator=gen).to(cuda_device)
             for k in ("hazy", "clear", "dehazed")}
    batch["intensity"] = (torch.arange(16) % 3).to(cuda_device)
    before = blend3.launches, channel_spatial_gate.launches
    comps = make_train_step(loss, nets, dtype=torch.bfloat16)(
        state, batch, torch.Generator(cuda_device).manual_seed(1))
    torch.cuda.synchronize()
    assert (blend3.launches - before[0], channel_spatial_gate.launches - before[1]) == (1, 6)
    assert all(bool(torch.isfinite(v)) for v in comps.values())
    for name, p in router.named_parameters():
        if name.startswith("classifier."):
            assert p.grad is None and torch.equal(p, frozen[name[len("classifier."):]]), name
        else:
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


@pytest.mark.parametrize("level", ["low", "medium", "high"])
def test_bf16_train_step_of_each_default_branch(cuda_device, level):
    """One bf16 train step at the default width, 256^2, batch 16, through
    the trainer's step: finite loss components, a finite gradient on every
    parameter; the high branch launches K2 six times (forward only)."""
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.losses.dehazing import get_dehazing_loss
    from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
    from adam_dehaze_tpu_torch.training.train_dehazing import init_branch, make_train_step

    cfg = load_config()                      # default widths, bf16
    model = init_branch(level, cfg, cuda_device).train()
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4))
    loss = get_dehazing_loss(cfg)
    nets = loss.init(torch.Generator().manual_seed(0), cuda_device)
    gen = torch.Generator().manual_seed(7)
    batch = {k: torch.rand(16, 256, 256, 3, generator=gen).to(cuda_device)
             for k in ("hazy", "clear", "dehazed")}
    before = channel_spatial_gate.launches
    comps = make_train_step(loss, nets, dtype=torch.bfloat16)(
        state, batch, torch.Generator(cuda_device).manual_seed(1))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v)) for v in comps.values())
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert channel_spatial_gate.launches - before == (6 if level == "high" else 0)


def test_serving_kernels_still_refuse_a_gradient(cuda_device):
    """K1, K3, K4 and K6 take BN-folded eval weights and have no gradient:
    on an input that needs one they raise; K2 does not."""
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel
    low = _seeded(LightweightDehazeModel(32, 3), 3).to(cuda_device)
    x = torch.rand(1, 16, 16, 3, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        lightweight_chain(x, fold_lightweight(low, torch.float32))
    for kind, c in (("medium", 16), ("high", 16)):
        model, (d1, f0, xt), (fold_fn, tail, _, _) = _tail_case(kind, c, 23)
        weights = fold_fn(model.to(cuda_device), torch.float32)
        d1, f0 = d1.to(cuda_device), f0.to(cuda_device)
        with pytest.raises(RuntimeError, match="forward-only"):
            tail(d1.requires_grad_(True), f0, xt.to(cuda_device), weights)
    blocks, xr = _res_case(("res", "attn"), 32, (1, 8, 8), 41)
    weights = fold_res_attn_chain(blocks.to(cuda_device), torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        res_attn_chain(xr.to(cuda_device).requires_grad_(True), weights)
    g = torch.rand(1, 32, device=cuda_device, requires_grad=True)
    w = torch.rand(7, 7, 2, 1, device=cuda_device, requires_grad=True)
    xg = xr.to(cuda_device).contiguous().requires_grad_(True)
    channel_spatial_gate(xg, g, w).sum().backward()
    assert xg.grad is not None and g.grad is not None and w.grad is not None


def _detector(device, dtype=torch.float32, seed=5, **kw):
    """The default detector (fcos_resnet18_fpn, 91 classes), seeded."""
    from adam_dehaze_tpu_torch.models.detection import DetectionModel
    det = DetectionModel(dtype=dtype, device=device, **kw)
    det.init(seed)
    return det


def test_detector_fp32_on_card_matches_cpu(cuda_device):
    """The default detector at 256^2 (batch 2), fp32, TF32 off: each level's
    logits, offsets and centerness on the card within 1e-4 of the tensor's
    largest magnitude of the CPU's; the same top-k candidates (locations
    and labels equal, boxes within 1e-3 px, scores within 1e-5, the order
    the same up to scores tied within 1e-5) and the same detections after
    NMS."""
    from adam_dehaze_tpu_torch.models.detection import (
        _device_topk,
        candidates_agree,
        detections_agree,
        imagenet_normalize,
    )
    cpu, card = _detector("cpu", score_threshold=0.005), _detector(cuda_device,
                                                                  score_threshold=0.005)
    x = imagenet_normalize(torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(1)))
    with torch.no_grad():
        want = cpu.module(x)
        got = card.module(x.to(cuda_device))
    for g, w in zip(got, want):
        for key in ("logits", "offsets", "centerness"):
            err = float((g[key].cpu() - w[key]).abs().max())
            assert err <= FP32_ATOL * float(w[key].abs().max()), (key, g["stride"], err)
    agree, _ = candidates_agree(_device_topk(got, 300), _device_topk(want, 300), 1e-3, 1e-5)
    assert agree
    a, b = card(x.to(cuda_device)), cpu(x)
    assert sum(len(r["boxes"]) for r in b) > 0
    assert detections_agree(a, b, 1e-3, 1e-5)


def test_detector_bf16_on_card_close_to_fp32(cuda_device):
    """The same weights under bf16 autocast: every level output within 3e-2
    of the fp32 one's largest magnitude."""
    fp32, bf16 = _detector(cuda_device), _detector(cuda_device, torch.bfloat16)
    x = torch.randn(2, 256, 256, 3, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    with torch.no_grad():
        want = fp32.module(x)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = bf16.module(x)
    for g, w in zip(got, want):
        for key in ("logits", "offsets", "centerness"):
            assert g[key].dtype == torch.float32
            err = float((g[key] - w[key]).abs().max())
            assert err <= BF16_ATOL * float(w[key].abs().max()), (key, g["stride"], err)


def test_detection_evaluation_launches_k2_and_k5_per_batch(cuda_device, tmp_path):
    """evaluate_object_detection on the card with a soft router at small
    widths (fp32): every test batch's dehazing launches K5 once and K2 six
    times (the high branch's AttentionBlocks)."""
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.data.dataset import get_dataloader
    from adam_dehaze_tpu_torch.evaluation.evaluate import evaluate_object_detection
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus

    root = str(tmp_path / "corpus")
    make_corpus(root, size=32, train=0, val=0, test=3, seed=2)
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for level, ch in (("low", 8), ("medium", 8), ("high", 16)):
        cfg["dehazing"][level]["channels"] = ch
    cfg["dataset"].update(test_path=root, img_size=32, batch_size=4, num_workers=2)
    cfg["detection"]["checkpoint_dir"] = str(tmp_path / "none")
    cfg["evaluation"]["annotation_paths"] = {
        lvl: f"{root}/annotations/coco_{lvl}.json" for lvl in ("low", "medium", "high")}
    router = _seeded(create_router(create_branch_models(cfg), create_classifier(cfg), cfg),
                     2).to(cuda_device)
    n_batches = len(get_dataloader(cfg, "test"))
    before = blend3.launches, channel_spatial_gate.launches
    out = evaluate_object_detection(cfg, router, device=cuda_device)
    torch.cuda.synchronize()
    assert (blend3.launches - before[0], channel_spatial_gate.launches - before[1]) == (
        n_batches, 6 * n_batches)
    for side in ("hazy", "dehazed"):
        assert set(out[side]) == {"overall", "low_intensity", "medium_intensity",
                                  "high_intensity"}


# --- the half-resolution dial (ops/resolution.py) on the card -------------

# The tuned winners and the other kernel candidates, by branch, at the
# widths of the default config: the dial serves them at 128^2 (a 256^2
# image halved), a shape the serving autotune never timed.
# (level, candidate) -> the kernels it must launch.
LOWRES_CANDIDATES = {
    ("low", "chain"): ("lightweight_chain",),
    ("medium", "tail_chain"): ("medium_tail_chain",),
    ("medium", "chain_hybrid"): ("res_attn_chain",),
    ("high", "tail_chain"): ("high_tail_chain", "spatial_gate"),
    ("high", "res_chain_e2b"): ("res_attn_chain", "cbam_gate"),
    ("high", "res_e2b_tail_chain"): ("res_attn_chain", "high_tail_chain", "spatial_gate")}
# The guided lift divides differences of box means by var + 1e-4, which
# can scale a difference of the branch outputs up: the lifted outputs are
# held at the fp32 slice's 1e-3, the branch outputs themselves at 1e-4.
LOWRES_LIFT_ATOL = 1e-3


@pytest.mark.parametrize("level,name", sorted(LOWRES_CANDIDATES),
                         ids=[f"{lvl}-{n}" for lvl, n in sorted(LOWRES_CANDIDATES)])
def test_lowres_apply_of_each_kernel_candidate_matches_plain_branch(cuda_device, level, name):
    """make_lowres_apply over a kernel candidate, on 256^2 images (the branch
    at 128^2), against the same dial over the canonical branch, fp32 on the
    card with TF32 off; the candidate's kernels launch inside the dial."""
    from adam_dehaze_tpu_torch.models.branches import (
        HighIntensityDehazeModel,
        LightweightDehazeModel,
        MediumIntensityDehazeModel,
    )
    from adam_dehaze_tpu_torch.ops import resolution
    from adam_dehaze_tpu_torch.ops.kernels import launch_counters
    from adam_dehaze_tpu_torch.serving_autotune import candidate_builders
    model = {"low": lambda: LightweightDehazeModel(32, 3),
             "medium": lambda: MediumIntensityDehazeModel(64),
             "high": lambda: HighIntensityDehazeModel(96)}[level]()
    model = _seeded(model, 61).to(cuda_device)
    cands = candidate_builders(model, torch.float32, (2, 256, 256, 3))
    fast, plain = cands[name](), cands["canonical"]()
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(62)).to(cuda_device)
    x_lo = resolution._resize_nhwc(x, (128, 128))
    counters = launch_counters()
    with torch.inference_mode():
        got_lo, want_lo = fast(x_lo), plain(x_lo)
        before = {k: counters[k].launches for k in LOWRES_CANDIDATES[(level, name)]}
        got = resolution.make_lowres_apply(fast)(x)
        want = resolution.make_lowres_apply(plain)(x)
    torch.cuda.synchronize()
    for kernel, n in before.items():
        assert counters[kernel].launches > n, (name, kernel)
    torch.testing.assert_close(got_lo, want_lo, rtol=0, atol=FP32_ATOL)
    torch.testing.assert_close(got, want, rtol=0, atol=LOWRES_LIFT_ATOL)
    assert tuple(got.shape) == (2, 256, 256, 3)


@pytest.mark.parametrize("radius", [2, 4])
def test_guided_upsample_on_card_matches_cpu(cuda_device, radius):
    """The guided lift from 128^2 to 256^2 on the card and on the CPU, each
    in fp32 against float64 on the CPU: the card within 1e-4 or 4 times the
    CPU's own fp32 error (the integral images sum in another order there)."""
    from adam_dehaze_tpu_torch.ops.resolution import guided_upsample
    gen = torch.Generator().manual_seed(63 + radius)
    g_hi = torch.rand(2, 256, 256, generator=gen)
    g_lo = torch.nn.functional.avg_pool2d(g_hi[:, None], 2)[:, 0]
    src = torch.rand(2, 128, 128, 3, generator=gen) * 0.2 - 0.1
    ref = guided_upsample(g_hi.double(), g_lo.double(), src.double(), radius=radius)
    cpu = guided_upsample(g_hi, g_lo, src, radius=radius)
    card = guided_upsample(g_hi.to(cuda_device), g_lo.to(cuda_device), src.to(cuda_device),
                           radius=radius).cpu()
    cpu_err = float((cpu.double() - ref).abs().max())
    card_err = float((card.double() - ref).abs().max())
    assert card_err <= max(FP32_ATOL, 4 * cpu_err), (card_err, cpu_err)


# The alternate branches (model_type -> level) and the new backbones.
ALT_BRANCHES = {"unet": "low", "corun": "medium", "dual_branch": "high",
                "encoder_decoder": "high"}
NEW_BACKBONES = ("mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large", "efficientnet_b0")


@pytest.mark.parametrize("model_type", sorted(ALT_BRANCHES))
def test_alternate_branch_on_card_matches_cpu(cuda_device, model_type):
    """An alternate branch at small widths, eval, fp32 (TF32 off) on the
    card against the CPU at 1e-4; the high ones run K2 once an
    AttentionBlock (dual_branch two, encoder_decoder one at 8c)."""
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.models import branches
    level = ALT_BRANCHES[model_type]
    cfg = load_config()
    cfg["dehazing"][level].update(model_type=model_type, channels=16, blocks=3)
    model = _seeded(getattr(branches, f"create_{level}_intensity_model")(cfg), 71)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(72))
    want = model(x)
    before = channel_spatial_gate.launches
    with torch.inference_mode():
        got = copy.deepcopy(model).to(cuda_device)(x.to(cuda_device)).cpu()
    attention = sum(isinstance(m, branches.AttentionBlock) for m in model.modules())
    assert channel_spatial_gate.launches - before == attention
    assert attention == {"dual_branch": 2, "encoder_decoder": 1}.get(model_type, 0)
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("name", NEW_BACKBONES)
def test_new_backbone_on_card_matches_cpu(cuda_device, name):
    """A MobileNet or EfficientNet classifier, eval, fp32 (TF32 off): logits
    and features on the card against the CPU at 1e-4."""
    from adam_dehaze_tpu_torch.models.classifier import FogIntensityClassifier
    model = _seeded(FogIntensityClassifier(name), 73)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(74))
    with torch.inference_mode():
        want = model(x)
        got = copy.deepcopy(model).to(cuda_device)(x.to(cuda_device))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=FP32_ATOL)


# --- precompiled serving: CUDA graphs ----------------------------------------

def _bundle_pair(device, tmp_path, **export):
    """(an eager dehazer, one served through its bundle) on the same seeded
    weights, the bundle exported at 32^2."""
    ref = _small_dehazer(device)
    ref.config["dataset"]["img_size"] = 32
    path = str(tmp_path / "precompiled")
    ref.export_precompiled(path, **export)
    return ref, _small_dehazer(device, precompiled=path)


# Graph against eager, fp32: the same kernels on the same data. On an
# NVIDIA H100 80GB HBM3 the small slice reads up to 6e-8 (a last bit), the
# default slice in bf16 0 (chip_smoke.py phase 18).
GRAPH_FP32_ATOL = 1e-6


def test_graph_replay_matches_eager(cuda_device, tmp_path):
    """The bundle's graphs replay the eager programs' kernels: forced labels
    through the bucket steps, route_hard, the queued branch graphs and the
    device-binned binning give the eager dehazer's labels and, within
    GRAPH_FP32_ATOL, its output; every exported shape hits, and the bundle
    carries the kernel library."""
    from adam_dehaze_tpu_torch.serving_export import GraphProgram, read_manifest
    x = np.random.default_rng(7).random((9, 32, 32, 3), dtype=np.float32)
    labels = np.arange(9) % 3
    ref, d = _bundle_pair(cuda_device, tmp_path, batch_sizes=(9,), queue_buckets=(3,),
                          device_buckets=(9,), device_chunk=4)
    assert read_manifest(str(tmp_path / "precompiled"))["library"]
    with torch.inference_mode():
        xd = torch.from_numpy(x).to(cuda_device)
        for _ in range(2):   # a replay does not disturb the next one
            got = d.engine(xd, intensity=labels)[0]
            torch.testing.assert_close(got, ref.engine(xd, intensity=labels)[0], rtol=0,
                                       atol=GRAPH_FP32_ATOL)
    for got, want in ((d.route_hard(x), ref.route_hard(x)),
                      (d.route_device_binned(x, chunk=4), ref.route_device_binned(x, chunk=4))):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=GRAPH_FP32_ATOL)
    queued = [(o.cpu(), g) for o, g, _ in d.route_hard_queued([x[:3], x[3:6], x[6:]],
                                                              queue_bucket=3)]
    for (o, g), (w, wg, _) in zip(queued, ref.route_hard_queued([x[:3], x[3:6], x[6:]],
                                                                  queue_bucket=3)):
        np.testing.assert_array_equal(g, wg)
        torch.testing.assert_close(o, w.cpu(), rtol=0, atol=GRAPH_FP32_ATOL)
    for name in ("classify", "step0", "step1", "step2", "device4_0"):
        p = d._dispatches[name]
        assert p.hits > 0 and all(isinstance(g, GraphProgram) for g in p._programs.values()), name
    assert all(d._dispatches[n].misses == 0 for n in ("step0", "step1", "step2", "device4_0"))


def test_launch_counts_survive_replay(cuda_device, tmp_path):
    """A replay passes through no wrapper: the launches a capture enqueued
    are added on every replay, so a graph-backed route counts as the eager
    one does, call for call."""
    from adam_dehaze_tpu_torch.ops.kernels import launch_counters, reset_launch_counts

    def counts():
        return {k: fn.launches for k, fn in launch_counters().items() if fn.launches}

    x = torch.from_numpy(np.random.default_rng(8).random((9, 32, 32, 3), dtype=np.float32))
    labels = np.arange(9) % 3
    ref, d = _bundle_pair(cuda_device, tmp_path, batch_sizes=(9,), queue_buckets=(),
                          device_buckets=())
    with torch.inference_mode():
        xd = x.to(cuda_device)
        d.engine(xd, intensity=labels)      # attach: warm-ups and captures
        ref.engine(xd, intensity=labels)
        torch.cuda.synchronize()
        reset_launch_counts()
        ref.engine(xd, intensity=labels)
        torch.cuda.synchronize()
        eager = counts()
        assert eager.get("cbam_gate", 0) > 0
        for replays in (1, 3):
            reset_launch_counts()
            for _ in range(replays):
                d.engine(xd, intensity=labels)
            torch.cuda.synchronize()
            assert counts() == {k: v * replays for k, v in eager.items()}


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance, in units in the last place of their type,
    between two float32 or bfloat16 tensors (the bit patterns mapped to
    integers in the order of the values, so that -0 and +0 coincide)."""
    as_int, low = ((torch.int16, -(1 << 15)) if got.dtype == torch.bfloat16
                   else (torch.int32, -(1 << 31)))

    def ordered(t):
        i = t.view(as_int).long()
        return torch.where(i < 0, low - i, i)
    return int((ordered(got) - ordered(want)).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 64, 64, 3), (2, 37, 30, 96), (3, 16, 16, 12),
                                   (2, 32, 32, 384), (2, 20, 20, 40), (3, 256, 192, 96)])
def test_int8_quantize_matches_plain(cuda_device, dtype, shape):
    """Q1 against its plain version: the int8 values, their zero padding and
    the per-image scales equal, bit for bit; an all-zero image included;
    40 channels padded to the tile body's 64; the last shape at a serving
    size (9.4 MB an image in bf16)."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        ConvGeometry, quantize_images, quantize_images_reference)
    g = torch.Generator().manual_seed(shape[-1])
    x = (torch.randn(shape, generator=g) * torch.rand((shape[0], 1, 1, 1), generator=g) * 8)
    x[-1] = 0.0
    x = x.to(dtype).to(cuda_device)
    pad = ConvGeometry.of(shape[-1], 16, 3, 3, 1, 1).cin_pad
    q, s = quantize_images(x, pad)
    q0, s0 = quantize_images_reference(x, pad)
    assert torch.equal(q, q0) and torch.equal(s, s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(65, 8, 8, 16), (130, 6, 10, 3)])
def test_int8_quantize_groups_of_images_match_plain(cuda_device, dtype, shape):
    """Q1 on batches of more than 64 images, which it walks in groups of at
    most 64 (one counter and one wait over the grid a group): bit for bit
    with its plain version, all-zero images at the groups' ends and starts
    and last."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        ConvGeometry, quantize_images, quantize_images_reference)
    g = torch.Generator().manual_seed(shape[0])
    x = (torch.randn(shape, generator=g) * torch.rand((shape[0], 1, 1, 1), generator=g) * 8)
    x[[0, 63, 64, -1]] = 0.0
    x = x.to(dtype).to(cuda_device)
    pad = ConvGeometry.of(shape[-1], 16, 3, 3, 1, 1).cin_pad
    q, s = quantize_images(x, pad)
    q0, s0 = quantize_images_reference(x, pad)
    assert torch.equal(q, q0) and torch.equal(s, s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 64, 64, 3), (2, 37, 30, 96), (3, 16, 16, 12),
                                   (130, 6, 10, 3), (3, 128, 192, 96)])
def test_int8_two_passes_on_row_shards_match_the_one_launch(cuda_device, dtype, shape):
    """Q1's two passes on two row shards of each image (`image_absmax` of
    each, their max, `quantize_images_at` on each at it) against the one
    launch on the whole image and against their plain versions: bit for
    bit, all-zero images included (batches of more than 64 images too)."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        ConvGeometry, image_absmax, image_absmax_reference, quantize_images,
        quantize_images_at, quantize_images_at_reference)
    g = torch.Generator().manual_seed(shape[0] + shape[-1])
    x = (torch.randn(shape, generator=g) * torch.rand((shape[0], 1, 1, 1), generator=g) * 8)
    x[[0, -1]] = 0.0
    x = x.to(dtype).to(cuda_device)
    pad = ConvGeometry.of(shape[-1], 16, 3, 3, 1, 1).cin_pad
    q, s = quantize_images(x, pad)
    parts = [p.contiguous() for p in x.chunk(2, 1)]
    partial = [image_absmax(p) for p in parts]
    for p, a in zip(parts, partial):
        assert torch.equal(a, image_absmax_reference(p))
    amax = torch.maximum(*partial)
    for p, (lo, hi) in zip(parts, ((0, parts[0].shape[1]), (parts[0].shape[1], shape[1]))):
        qp, sp = quantize_images_at(p, amax, pad)
        q0, s0 = quantize_images_at_reference(p, amax, pad)
        assert torch.equal(qp, q0) and torch.equal(sp, s0)
        assert torch.equal(qp, q[:, lo:hi]) and torch.equal(sp, s)


# The distinct input shapes (H, W, C, cin_pad) of the 52 Int8Conv2d calls of
# one 16-image bucket of each int8 branch at 256^2 and the default widths
# (chip_smoke.py phase 19's `int8_layers`), as one of 2 H shards sees them.
Q1_SHARD_LAYERS = [(128, 256, 3, 4), (128, 256, 16, 32), (128, 256, 32, 32), (128, 256, 64, 64),
                   (128, 256, 96, 96), (128, 256, 128, 128), (128, 256, 192, 192),
                   (64, 128, 128, 128), (64, 128, 192, 192), (32, 64, 256, 256),
                   (32, 64, 384, 384)]
# Whole images (N, H, W, C, cin_pad) split over 2 and 4 row shards: each
# layer shape above at 16 images (2 shards of it), then an image whose bytes
# are not a multiple of 16 on 2 shards ((3, 5, 7, 3)), one image, more images
# than the one launch's group of 64, C = 12 and 24 (the pixels and octets
# paths of the quantizing pass), and a batch of all-zero images.
Q1_PASS_CASES = ([(16, 2 * h, w, c, pad) for h, w, c, pad in Q1_SHARD_LAYERS]
                 + [(3, 10, 7, 3, 4), (1, 16, 24, 32, 32), (130, 16, 8, 32, 32),
                    (130, 12, 10, 3, 4), (3, 16, 16, 12, 16), (5, 6, 10, 24, 32), "zeros"])


def _spread_images(shape, gen):
    """Images whose ranges spread over 2^-10 to 2^10 in a seeded order (RGB
    inputs in [0, 1) scaled, the rest ReLU'd normals), one all-zero image
    where there are more than two: a block that reads another image's values
    or scale, or misses part of its own, changes a scale or an int8 value."""
    n = shape[0]
    x = torch.rand(shape, generator=gen) if shape[-1] == 3 else torch.relu(
        torch.randn(shape, generator=gen))
    exps = torch.linspace(-10.0, 10.0, n)[torch.randperm(n, generator=gen)] if n > 1 else \
        torch.zeros(1)
    x = x * torch.exp2(exps + torch.rand(n, generator=gen)).view(n, 1, 1, 1)
    if n > 2:
        x[n // 2] = 0.0
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", Q1_PASS_CASES, ids=lambda c: c if isinstance(c, str)
                         else "x".join(map(str, c[:4])))
def test_int8_two_passes_at_the_layer_shapes_bit_for_bit(cuda_device, dtype, case):
    """Q1's two passes on 2 and 4 row shards of each image, with per-image
    ranges spread over 2^-10 to 2^10: each shard's `image_absmax` and
    `quantize_images_at` (at the max over the shards) against their plain
    versions, and the shards' int8 rows and scales joined against the one
    launch (`quantize_images`) on the whole image, bit for bit. All-zero
    images: amax 0, scale T(1/127.5), q 0."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        image_absmax, image_absmax_reference, quantize_images, quantize_images_at,
        quantize_images_at_reference)
    gen = torch.Generator().manual_seed(len(Q1_PASS_CASES) + Q1_PASS_CASES.index(case))
    n, h, w, c, pad = (4, 8, 8, 16, 32) if case == "zeros" else case
    x = torch.zeros((n, h, w, c)) if case == "zeros" else _spread_images((n, h, w, c), gen)
    x = x.to(dtype).to(cuda_device)
    q, s = quantize_images(x, pad)
    for shards in (2, 4):
        parts = [p.contiguous() for p in x.chunk(shards, 1)]
        partial = [image_absmax(p) for p in parts]
        for p, a in zip(parts, partial):
            assert torch.equal(a, image_absmax_reference(p)), (shards, tuple(p.shape))
        amax = torch.stack(partial).amax(0)
        row = 0
        for p in parts:
            qp, sp = quantize_images_at(p, amax, pad)
            q0, s0 = quantize_images_at_reference(p, amax, pad)
            assert torch.equal(qp, q0) and torch.equal(sp, s0), (shards, tuple(p.shape))
            assert torch.equal(qp, q[:, row:row + p.shape[1]]) and torch.equal(sp, s)
            row += p.shape[1]
    if case == "zeros":
        assert not amax.any() and not q.any()
        assert torch.equal(s, torch.full_like(s, float(torch.tensor(1 / 127.5).to(dtype))))


def test_int8_two_passes_refuse_what_they_do_not_take(cuda_device):
    """The two passes on the card raise, naming what they refuse: more
    images than their grid takes, a misaligned x, a cin_pad under C."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        MAX_PASS_IMAGES, image_absmax, quantize_images_at)
    many = torch.zeros((MAX_PASS_IMAGES + 1, 1, 1, 8), device=cuda_device)
    with pytest.raises(ValueError, match="at most 65535"):
        image_absmax(many)
    with pytest.raises(ValueError, match="at most 65535"):
        quantize_images_at(many, torch.zeros(MAX_PASS_IMAGES + 1, device=cuda_device), 8)
    flat = torch.zeros(2 * 4 * 4 * 3 + 1, device=cuda_device)
    odd = flat[1:].view(2, 4, 4, 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        image_absmax(odd)
    x = torch.zeros((2, 4, 4, 8), device=cuda_device)
    with pytest.raises(ValueError, match="cin_pad 4"):
        quantize_images_at(x, torch.zeros(2, device=cuda_device), 4)


# (cin, cout, kernel, stride, padding, bias): K = 147 (7x7 on RGB), 27,
# stride 2, 1x1 with a bias, the widest 3x3 and ragged M and Cout tiles; the
# tile body at 3x3 and 4x4 stride 2 (chunks 96, 64, 48, 16 and channels
# padded to 32), the gather body on the rest.
INT8_CONVS = [(3, 96, 7, 1, 3, False), (3, 16, 3, 1, 1, False), (64, 128, 4, 2, 1, False),
              (56, 24, 1, 1, 0, True), (384, 384, 3, 1, 1, False), (16, 48, 3, 1, 1, True),
              (96, 192, 4, 2, 1, True), (40, 16, 3, 1, 1, False), (16, 16, 3, 1, 1, False)]


def _gather_geometry(cin, cout, k, stride, pad):
    """The gather body's geometry of a conv whose shape takes the tile body,
    padded as ConvGeometry.of pads the gather body's layers."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import K_STEP, TILE_N, ConvGeometry
    cin_pad = -(-cin // 16) * 16
    return ConvGeometry(cin, cin_pad, cout, -(-cout // TILE_N) * TILE_N, k, k, stride, pad,
                        -(-k * k * cin_pad // K_STEP) * K_STEP)


def _int8_operands(cuda_device, dtype, conv, geo=None):
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        ConvGeometry, pack_int8_weights, quantize_images)
    from adam_dehaze_tpu_torch.ops.quant import quantize_weight_per_channel
    cin, cout, k, stride, pad, has_bias = conv
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.relu(torch.randn((3, 19, 23, cin), generator=g)).to(dtype).to(cuda_device)
    w = (torch.randn((cout, cin, k, k), generator=g) * 0.1).to(dtype).to(cuda_device)
    bias = (torch.randn((cout,), generator=g).to(dtype).float().to(cuda_device)
            if has_bias else None)
    geo = geo or ConvGeometry.of(cin, cout, k, k, stride, pad)
    qw, sw = quantize_weight_per_channel(w)
    q, sx = quantize_images(x, geo.cin_pad)
    return q, sx, pack_int8_weights(qw, geo), sw.float(), bias, geo


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("conv", INT8_CONVS, ids=lambda c: "x".join(map(str, c[:4])))
def test_int8_conv_matches_plain(cuda_device, dtype, conv):
    """Q2 against its plain version (the same int8 operands), on the body
    its shape takes (and the 16 -> 16 layer also on the gather body): the
    int32 sums are exact and the dequant rounds at the same points, bit for
    bit; each launch counted once for its body."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import int8_conv, int8_conv_packed_reference
    geos = (None, _gather_geometry(*conv[:5])) if conv[:2] == (16, 16) else (None,)
    for geo in geos:
        q, sx, packed, sw, bias, geo = _int8_operands(cuda_device, dtype, conv, geo)
        before = dict(int8_conv.body_launches)
        got = int8_conv(q, sx, packed, sw, bias, geo, dtype)
        want = int8_conv_packed_reference(q, sx, packed, sw, bias, geo, dtype)
        assert got.shape == want.shape == (3, *geo.out_size(19, 23), conv[1])
        assert torch.equal(got, want), (geo.body, _ulps(got, want))
        assert int8_conv.body_launches[geo.body] == before[geo.body] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("relu", [True, False], ids=["bn_relu", "bn"])
@pytest.mark.parametrize("conv", [INT8_CONVS[0], INT8_CONVS[2], INT8_CONVS[4], INT8_CONVS[5]],
                         ids=lambda c: "x".join(map(str, c[:4])))
def test_int8_conv_fused_epilogue_matches_plain(cuda_device, dtype, relu, conv):
    """Q2 with the ConvBlock's eval BN (+ ReLU) in its epilogue, on both
    bodies: bit for bit its plain version, the plain dequant then
    F.batch_norm in the compute dtype (PyTorch's CUDA BN kernel, whose f32
    rounding the epilogue follows) then ReLU."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        eval_bn_stats, int8_conv, int8_conv_fused_reference)
    q, sx, packed, sw, _, geo = _int8_operands(cuda_device, dtype, conv[:5] + (False,))
    g = torch.Generator().manual_seed(7)
    bn = torch.nn.BatchNorm2d(geo.cout).eval().requires_grad_(False)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(geo.cout, generator=g))
        bn.bias.copy_(torch.randn(geo.cout, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(geo.cout, generator=g) * 0.2)
        bn.running_var.copy_(torch.rand(geo.cout, generator=g) + 0.1)
    bn = bn.to(cuda_device)
    with torch.inference_mode():
        got = int8_conv(q, sx, packed, sw, None, geo, dtype, bn, eval_bn_stats(bn), relu)
        plain = int8_conv_fused_reference(q, sx, packed, sw, None, geo, dtype, bn, relu)
    assert torch.equal(got, plain), _ulps(got, plain)
    if relu:
        assert float(got.float().min()) >= 0.0


def test_int8_route_hard_launches_q1_q2_and_k2(cuda_device):
    """An int8 route_hard over forced labels 0, 1, 2: Q1 and Q2 once per
    ConvBlock of every branch that ran, K2 in the high bucket (its six
    AttentionBlocks), and neither K1 nor the tail or segment chains."""
    from adam_dehaze_tpu_torch.ops.kernels import launch_counters, reset_launch_counts
    from adam_dehaze_tpu_torch.ops.quant import Int8Conv2d
    d = _small_dehazer(cuda_device, quant="int8")
    x = torch.from_numpy(np.random.default_rng(9).random((6, 32, 32, 3), dtype=np.float32))
    n_convs = sum(isinstance(m, Int8Conv2d) for lvl in ("low", "medium", "high")
                  for m in d._hard.models[lvl].modules())
    with torch.inference_mode():
        d.engine(x.to(cuda_device), intensity=np.arange(6) % 3)   # first call: the build
        torch.cuda.synchronize()
        reset_launch_counts()
        d.engine(x.to(cuda_device), intensity=np.arange(6) % 3)
        torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    assert counts["int8_quantize"] == counts["int8_conv"] == n_convs
    assert counts["cbam_gate"] == 6
    for name in ("lightweight_chain", "medium_tail_chain", "high_tail_chain",
                 "res_attn_chain", "spatial_gate"):
        assert counts[name] == 0, name


def test_int8_slice_on_card_matches_cpu(cuda_device):
    """The fp32 int8 slice, forced labels 0, 1, 2: the card against the
    CPU's plain versions. The heads, the ConvTransposes and the attention
    MLPs are cuDNN's and cuBLAS's sums in another order, which moves some
    values across an int8 rounding boundary of the next quantizer, and the
    layers after it flip more: the two outputs are two draws of the
    quantization noise around the fp32 output. So the card-vs-CPU error's
    mean within 1.5 times that noise's mean (int8 against fp32 on the CPU)
    and its max within twice the noise's max (chip_smoke.py's INT8_DRAWS)."""
    x = np.random.default_rng(10).random((6, 32, 32, 3), dtype=np.float32)
    labels = np.arange(6) % 3
    card = _small_dehazer(cuda_device, quant="int8")
    cpu = _small_dehazer("cpu", quant="int8")
    fp32 = _small_dehazer("cpu")
    with torch.inference_mode():
        got = card.engine(torch.from_numpy(x).to(cuda_device), intensity=labels)[0].cpu()
        want = cpu.engine(torch.from_numpy(x), intensity=labels)[0]
        ref = fp32.engine(torch.from_numpy(x), intensity=labels)[0]
    err, noise = (got - want).abs(), (want - ref).abs()
    assert float(noise.max()) > 0
    assert float(err.mean()) <= 1.5 * float(noise.mean())
    assert float(err.max()) <= 2 * float(noise.max())


# --- parallel/ on one card -------------------------------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_world_of_one_nccl_data_parallel_step(cuda_device):
    """A process group of one over NCCL: the mesh holds NCCL groups, the
    data-parallel step runs its collectives (BN statistics, gradients,
    metrics) through them and gives the plain step's result; the metric
    mean of one process is `float` of its values."""
    import torch.distributed as dist
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel
    from adam_dehaze_tpu_torch.parallel import multihost
    from adam_dehaze_tpu_torch.parallel.data_parallel import shard_train_step
    from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
    from adam_dehaze_tpu_torch.training.state import TrainState

    def step(state, batch, generator=None):
        loss = ((state.module(batch["x"]) - batch["y"]) ** 2).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return {"loss": loss.detach()}

    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.random((4, 32, 32, 3), dtype=np.float32)).to(cuda_device)
             for k in ("x", "y")}
    models = [_seeded(LightweightDehazeModel(8, 1), 3).to(cuda_device).train() for _ in range(2)]
    states = [TrainState(m, torch.optim.SGD(m.parameters(), lr=0.1)) for m in models]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh()
        assert mesh.shape == {"data": 1, "spatial": 1, "model": 1}
        assert dist.get_backend(mesh.group("data")) == "nccl"
        got = shard_train_step(step, mesh, batch)(states[0], batch)
        assert multihost.all_hosts_mean_tree({"loss": got["loss"]}) == {
            "loss": float(got["loss"])}
    finally:
        dist.destroy_process_group()
    want = step(states[1], batch)
    torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-5, atol=0)
    for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def test_expert_parallel_and_pipeline_on_card_match_soft_router(cuda_device):
    """ExpertParallelRouter and TwoStagePipeline on [cuda:0], on the serving
    copy of a small soft router (fp32): the soft router's output, through
    K1 (low branch), K2 (high branch) and K5 (the blend)."""
    from adam_dehaze_tpu_torch.ops.kernels import launch_counters, reset_launch_counts
    from adam_dehaze_tpu_torch.parallel.expert_parallel import ExpertParallelRouter
    from adam_dehaze_tpu_torch.parallel.pipeline import TwoStagePipeline

    serving = _small_dehazer(cuda_device)._serving
    levels = ("low", "medium", "high")
    xs = [torch.from_numpy(np.random.default_rng(i).random((3, 32, 32, 3), dtype=np.float32))
          .to(cuda_device) for i in range(3)]
    with torch.inference_mode():
        want = [serving(x)[0] for x in xs]
    ep = ExpertParallelRouter({lvl: serving.models[lvl] for lvl in levels}, serving.classifier,
                              serving.temperature, devices=[cuda_device])
    pipe = TwoStagePipeline(serving.classifier, [serving.models[lvl] for lvl in levels],
                            serving.temperature, devices=[cuda_device])
    reset_launch_counts()
    got = [ep(x)[0] for x in xs] + list(pipe.run(xs))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in launch_counters().items()}
    for g, w in zip(got, want + want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    assert launches["blend3"] == 6 and launches["lightweight_chain"] > 0
    assert launches["cbam_gate"] > 0
