"""K1's fused body and K2's statistics pass of the PyTorch port, as far as
the CPU reaches them.

The fused wgmma groups of csrc/lightweight_chain.cu run only on a card
(tests/test_torch_cuda.py). Here: their tile, group and halo geometry
written in plain PyTorch (`lightweight_chain_tiled_reference`) against the
plain version and against the JAX Pallas chain in interpret mode; the plan
mirror (`chain_plan`, `group_smem_bytes`, `fused_tile`) hand-counted; the
weight packing's round trip; and `padded_stats`, the plain version of K2's
statistics pass, against the JAX wrapper's own expressions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu_torch.ops.kernels.cbam import padded_stats
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    chain_plan,
    fold_lightweight,
    fused_tile,
    group_smem_bytes,
    layer_smem_bytes,
    lightweight_chain_reference,
    lightweight_chain_tiled_reference,
    pack_groups,
    pack_layer,
    unpack_layer,
)
from torch_port_util import ATOL, images, init_flax, port_of


def _low_pair(c=32, n_blocks=3, seed=0):
    from adam_dehaze_tpu.models.branches import LightweightDehazeModel as JLow
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel

    vs = init_flax(JLow(base_channels=c, n_blocks=n_blocks, dtype=jnp.float32),
                   images((1, 16, 16, 3)), seed=seed)
    return vs, port_of(LightweightDehazeModel(c, n_blocks), vs)


# (image shape, tile side): odd sides over several tiles whose last row and
# column of tiles hold 5 and 6 positions; a non-square image at the c = 48
# tile; an image smaller than one tile; exactly one tile; one position more
# than a tile each way.
TILED_CASES = {
    "37x70_t32": ((2, 37, 70, 3), 32),
    "48x80_t20": ((1, 48, 80, 3), 20),
    "5x7_t32": ((1, 5, 7, 3), 32),
    "one_tile_t8": ((2, 8, 8, 3), 8),
    "tile_plus_1_t8": ((1, 9, 9, 3), 8),
}


@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_k1_tiled_matches_plain(case):
    """The fused groups' geometry gives the plain version's values in fp32
    (1e-6: the same operands, f32 sums in the window's order), with alpha 1
    so that the conv stack is not scaled down. A ring position outside the
    image that kept relu(shift) instead of 0 would show at every border
    tile."""
    shape, tile = TILED_CASES[case]
    _, port = _low_pair(c=16, n_blocks=2)
    chain = fold_lightweight(port, torch.float32)._replace(alpha=1.0)
    x = torch.from_numpy(images(shape, seed=2))
    want = lightweight_chain_reference(x, chain)
    got = lightweight_chain_tiled_reference(x, chain, tile)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,tile", [((2, 32, 32, 3), 12), ((1, 48, 80, 3), 32)],
                         ids=["32x32_t12", "48x80_t32"])
def test_k1_tiled_matches_pallas_chain(shape, tile):
    """The same geometry against the TPU chain kernel in interpret mode."""
    from adam_dehaze_tpu.ops.pallas.s2d_chain import make_lightweight_chain_apply

    vs, port = _low_pair()
    x = images(shape, seed=1)
    want = np.asarray(make_lightweight_chain_apply(
        vs, dtype=jnp.float32, interpret=True)(jnp.asarray(x)))
    chain = fold_lightweight(port, torch.float32)
    got = lightweight_chain_tiled_reference(torch.from_numpy(x), chain, tile).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_k1_tiled_bf16_rounds_where_plain_rounds():
    """In bf16 the tiled version rounds at the plain version's points: they
    differ only by flipped roundings (f32 sums in another order)."""
    _, port = _low_pair(c=16, n_blocks=1)
    chain = fold_lightweight(port, torch.bfloat16)._replace(alpha=1.0)
    x = torch.from_numpy(images((1, 21, 26, 3), seed=3))
    torch.testing.assert_close(lightweight_chain_tiled_reference(x, chain, 8),
                               lightweight_chain_reference(x, chain), rtol=0, atol=4e-3)


# Hand-counted, c = 32 at tile 32 (pitch 36): a plane of t + 4 = 36 rows is
# 36 * 36 + 66 = 1362 -> 1370 positions, of 34 rows 34 * 36 + 66 = 1290 ->
# 1298. Buffer 1 is 4 octets * 1370 * 16 = 87,680 B; buffer 2 4 * 1298 * 16 =
# 83,072 B ("first": the K = 32 rows, 4 * 1370 * 16 = 87,680 B). Weights: a
# c -> c layer 9 * 32 * 32 * 2 = 18,432 B, 3 -> c 32 * 32 * 2 = 2,048 B, c -> 3
# 9 * 32 * 8 * 2 = 4,608 B. Shifts 4 B a channel. The f32 3-channel tile
# 38 * 38 * 12 = 17,328 B.
@pytest.mark.parametrize("c,kind,tile,want", [
    (32, "first", 32, 2048 + 2 * 18432 + 384 + 87680 + 87680 + 17328),
    (32, "res", 32, 2 * 18432 + 256 + 87680 + 83072),
    (32, "last", 32, 18432 + 4608 + 160 + 87680 + 83072),
    # c = 48 at tile 20 (pitch 24): planes 24 * 24 + 66 = 642 -> 650 and
    # 22 * 24 + 66 = 594 -> 602; 6 octets.
    (48, "res", 20, 2 * 41472 + 384 + 6 * 650 * 16 + 6 * 602 * 16),
    # c = 64 at tile 8 (pitch 12): planes 144 + 66 = 210 -> 218 and 120 + 66 =
    # 186 -> 194; 8 octets; the f32 tile 14 * 14 * 12 = 2,352 B.
    (64, "first", 8, 4096 + 2 * 73728 + 768 + 8 * 218 * 16 + 8 * 194 * 16 + 2352),
])
def test_k1_group_shared_memory(c, kind, tile, want):
    assert group_smem_bytes(c, kind, tile) == want


@pytest.mark.parametrize("c,n_blocks,dtype,want", [
    (32, 3, torch.bfloat16, ("fused", (32, 32), ("first", "res", "res", "last"), 4)),
    (48, 2, torch.bfloat16, ("fused", (20, 20), ("first", "res", "last"), 3)),
    (64, 1, torch.bfloat16, ("fused", (8, 8), ("first", "last"), 2)),
    # The widths and dtypes the fused body does not serve: one FMA launch a layer.
    (80, 2, torch.bfloat16, ("layer", (8, 16), (), 7)),
    (24, 1, torch.bfloat16, ("layer", (8, 16), (), 5)),
    (32, 3, torch.float32, ("layer", (8, 16), (), 9)),
    # Refused before any launch: the c -> 3 layer's f32 tile and weights
    # are beyond a block's shared memory; not a multiple of 8; no block.
    (128, 3, torch.bfloat16, None),
    (12, 3, torch.bfloat16, None),
    (32, 0, torch.bfloat16, None),
    (32, 3, torch.float16, None),
])
def test_k1_plan(c, n_blocks, dtype, want):
    plan = chain_plan(c, n_blocks, dtype)
    if want is None:
        assert plan is None
        return
    assert (plan.body, plan.tile, plan.groups, plan.launches) == want
    assert len(plan.smem_bytes) == plan.launches and max(plan.smem_bytes) <= 232448
    if plan.body == "fused":
        assert plan.tile[0] == fused_tile(c)
        assert plan.smem_bytes == tuple(group_smem_bytes(c, k, plan.tile[0])
                                        for k in plan.groups)
        # The next wider tile's first group does not fit a block.
        assert plan.tile[0] == 32 or group_smem_bytes(c, "first", plan.tile[0] + 4) > 232448
    else:
        assert plan.smem_bytes == (layer_smem_bytes(3),) + (layer_smem_bytes(c),) * (
            plan.launches - 1)


def test_k1_pack_round_trip_and_layout():
    """`pack_layer` is a permutation whose slab (tap, k16 step) is the
    N-major core-matrix layout: element (k octet, n octet, k row, n)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((9, 32, 48)).astype(np.float32))
    packed = pack_layer(w)
    assert packed.shape == (9, 2, 2, 6, 8, 8) and packed.is_contiguous()
    assert torch.equal(unpack_layer(packed), w)
    tap, step, ko, no, kr, n = 4, 1, 1, 5, 3, 7
    assert packed[tap, step, ko, no, kr, n] == w[tap, step * 16 + ko * 8 + kr, no * 8 + n]
    with pytest.raises(ValueError):
        pack_layer(w[:, :24])


def test_k1_groups_hold_every_layer():
    """The packed groups are the folded layers again: 3 -> c as one tap of
    K = 27 rows padded to 32, c -> 3 padded to 8 columns, shifts after one
    another with the bias padded to 8."""
    _, port = _low_pair(c=16, n_blocks=2)
    chain = fold_lightweight(port, torch.bfloat16)
    assert len(chain.groups) == chain_plan(16, 2, torch.bfloat16).launches == 3
    assert fold_lightweight(port, torch.float32).groups == ()
    c = 16
    sizes = [32 * c + 2 * 9 * c * c, 2 * 9 * c * c, 9 * c * c + 9 * c * 8]
    assert [g[0].numel() for g in chain.groups] == sizes
    assert [g[1].numel() for g in chain.groups] == [3 * c, 2 * c, c + 8]
    assert all(g[0].dtype == torch.bfloat16 and g[1].dtype == torch.float32
               for g in chain.groups)
    w0 = unpack_layer(chain.groups[0][0][:32 * c].reshape(1, 2, 2, c // 8, 8, 8))
    assert torch.equal(w0[0, :27], chain.layers[0][0].reshape(27, c))
    assert not w0[0, 27:].any()
    last = unpack_layer(chain.groups[-1][0][9 * c * c:].reshape(9, c // 16, 2, 1, 8, 8))
    assert torch.equal(last[:, :, :3], chain.layers[-1][0].reshape(9, c, 3))
    assert not last[:, :, 3:].any()
    assert torch.equal(chain.groups[-1][1][c:c + 3], chain.layers[-1][1])
    assert torch.equal(pack_groups(chain.layers, 2)[1][0], chain.groups[1][0])


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("shape", [(2, 6, 16, 8), (1, 9, 13, 96), (2, 5, 11, 24)],
                         ids=["c8", "c96_w13", "c24_w11"])
def test_k2_padded_stats_match_jax_expressions(shape, gated):
    """`padded_stats` against the expressions of the JAX wrappers
    (channel_spatial_gate_pallas, spatial_gate_pallas): the mean as an
    einsum over c, the max of the product, the zero pad of 3."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape).astype(np.float32)
    xf = jnp.asarray(x)
    if gated:
        g = rng.random((shape[0], shape[3]), dtype=np.float32)
        gf = jnp.asarray(g)
        mean = jnp.einsum("nhwc,nc->nhw", xf, gf) / shape[3]
        mx = jnp.max(xf * gf[:, None, None, :], axis=-1)
    else:
        g = None
        mean, mx = jnp.mean(xf, axis=-1), jnp.max(xf, axis=-1)
    pad = ((0, 0), (3, 3), (3, 3))
    got = padded_stats(torch.from_numpy(x), None if g is None else torch.from_numpy(g))
    for a, b in zip(got, (jnp.pad(mean, pad), jnp.pad(mx, pad))):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_k2_padded_stats_reduce_bf16_in_f32():
    x = torch.from_numpy(images((1, 4, 5, 16), seed=7)).bfloat16()
    g = torch.rand(1, 16)
    for a, b in zip(padded_stats(x, g), padded_stats(x.float(), g)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
