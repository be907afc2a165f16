"""K3's fused head group of the PyTorch port as far as the CPU reaches it,
and the two serving repairs that go with it.

The head group (csrc/lightweight_chain.cu: tail_head_group) runs the medium
tail's last two layers, c -> c/2 and c/2 -> 3 with tanh, x + res and the
clip, as one launch on a card (tests/test_torch_cuda.py). Here: its tile,
halo and zeroed ring written in plain PyTorch
(`medium_tail_chain_tiled_reference`) against the plain version at 1e-6 in
fp32 and in bf16 (the same operands and rounding points; f32 sums in the
window's order) and against the JAX package's XLA medium tail at 1e-4 in
fp32; the plan (`medium_tail_plan`, `head_tile`, the group's shared memory
hand-counted); the packing's round trip. Then the serving repairs: the
autotune cache key knows the kernels' sources, and the low branch's
`canonical` candidate is its module path, never K1.
"""
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    group_smem_bytes,
    head_tile,
    unpack_layer,
)
from adam_dehaze_tpu_torch.ops.kernels.tail_chain import (
    fold_high_tail,
    fold_medium_tail,
    medium_tail_chain_reference,
    medium_tail_chain_tiled_reference,
    medium_tail_plan,
)
from adam_dehaze_tpu_torch.serving_autotune import (
    _cache_key,
    candidate_builders,
    load_cached,
)
from test_torch_tail_chain import C as JAX_C
from test_torch_tail_chain import _jax_xla_tail, _tail_inputs
from torch_port_util import ATOL, images, init_flax, port_of

BF16 = torch.bfloat16
F32 = torch.float32


def _medium(c, seed):
    """A seeded medium branch of width c with BN stats away from 0/1."""
    gen = torch.Generator().manual_seed(seed)
    model = init_params_(PB.MediumIntensityDehazeModel(c), gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return model.eval()


def _inputs(c, h, w, seed):
    """d1, f0 non-negative like the real decoder state, x in [0, 1]; NHWC."""
    rng = np.random.default_rng(seed)
    d1 = np.maximum(rng.standard_normal((2, h // 2, w // 2, 4 * c)), 0).astype(np.float32)
    f0 = np.maximum(rng.standard_normal((2, h, w, c)), 0).astype(np.float32)
    return [torch.from_numpy(a) for a in (d1, f0, images((2, h, w, 3), seed=seed + 1))]


# (width, image sides, tile side): sides that end in a part of a tile, an
# image smaller than a tile, exactly one tile, a tile and 4 more positions
# each way, at the tiles the group takes (24 at c = 64, 32 at c = 32) and at
# smaller ones that cut a 36 x 44 image into many tiles.
TILED_CASES = {
    "c64_36x44_t24": (64, (36, 44), 24),
    "c64_20x12_t24": (64, (20, 12), 24),
    "c64_24x24_t24": (64, (24, 24), 24),
    "c64_28x28_t24": (64, (28, 28), 24),
    "c32_36x44_t32": (32, (36, 44), 32),
    "c32_36x44_t8": (32, (36, 44), 8),
}


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_head_group_tiled_matches_plain(case, dtype):
    """The head group's geometry gives the plain version's values (1e-6:
    the same operands and rounding points, f32 sums in the window's order).
    A ring position outside the image that kept relu(shift) instead of 0
    would show at every border tile."""
    c, (h, w), tile = TILED_CASES[case]
    wt = fold_medium_tail(_medium(c, 3), dtype)
    args = _inputs(c, h, w, 5)
    want = medium_tail_chain_reference(*args, wt)
    got = medium_tail_chain_tiled_reference(*args, wt, tile)
    assert got.shape == want.shape == (2, h, w, 3) and got.dtype == F32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tile", [8, 12, 32])
def test_head_group_tiled_matches_jax_xla_tail(tile):
    """The same geometry against the JAX package's medium tail (the XLA tail
    of make_medium_s2d_apply, as tests/test_torch_tail_chain.py runs it) on
    the same weights, fp32, at c = 16 and 32^2."""
    from adam_dehaze_tpu.models.branches import MediumIntensityDehazeModel as JMedium
    vs = init_flax(JMedium(base_channels=JAX_C, use_pallas=False, dtype=jnp.float32),
                   images((1, 32, 32, 3)), seed=3)
    port = port_of(PB.MediumIntensityDehazeModel(JAX_C), vs)
    d1, f0, x = _tail_inputs()
    want = _jax_xla_tail("medium", vs)(d1, f0, x)
    got = medium_tail_chain_tiled_reference(*map(torch.from_numpy, (d1, f0, x)),
                                            fold_medium_tail(port, F32), tile)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# Hand-counted shared memory of the group, c = 64 at tile 24 (pitch 28): a
# plane of 28 rows is 28 * 28 + 66 = 850 -> 858 positions, of 26 rows 26 * 28
# + 66 = 794 -> 802. Buffer 1 is 8 octets * 858 * 16 = 109,824 B, buffer 2
# (c/2 = 32 wide) 4 * 802 * 16 = 51,328 B. Weights: 64 -> 32 9 * 64 * 32 * 2 =
# 36,864 B, 32 -> 3 padded to 8 9 * 32 * 8 * 2 = 4,608 B; shifts 4 * (32 +
# 8). Tile 28 would take 248,352 B, beyond a block's 232,448.
@pytest.mark.parametrize("c,tile,want", [
    (64, 24, 36864 + 4608 + 160 + 109824 + 51328),
    (64, 28, 41472 + 160 + 8 * 1098 * 16 + 4 * 1034 * 16),
    # c = 32 at tile 32 (pitch 36): planes 1362 -> 1370 and 1290 -> 1298.
    (32, 32, 9216 + 2304 + 96 + 4 * 1370 * 16 + 2 * 1298 * 16),
])
def test_head_group_shared_memory(c, tile, want):
    assert group_smem_bytes(c, "tail_head", tile) == want


@pytest.mark.parametrize("c,dtype,want", [
    (64, BF16, ("group", 24, 5, 202784)),
    (32, BF16, ("group", 32, 5, 140832)),
    # Two launches, decided up front: c/2 no multiple of 16 (16, 48), a
    # width the group is not built for (96); fp32 keeps its FMA body.
    (16, BF16, ("layers", 0, 6, 0)),
    (48, BF16, ("layers", 0, 6, 0)),
    (96, BF16, ("layers", 0, 6, 0)),
    (64, F32, ("layers", 0, 6, 0)),
])
def test_medium_tail_plan(c, dtype, want):
    plan = medium_tail_plan(c, dtype)
    assert tuple(plan) == want
    if dtype == BF16:
        assert head_tile(c) == plan.tile
    if plan.head == "group":
        assert plan.smem_bytes == group_smem_bytes(c, "tail_head", plan.tile) <= 232448
        # The next wider tile does not fit a block.
        assert plan.tile == 32 or group_smem_bytes(c, "tail_head", plan.tile + 4) > 232448


@pytest.mark.parametrize("c", [32, 64])
def test_head_group_packing_round_trip(c):
    """The packed group holds head2 and the output conv again: head2 as
    (9 taps, c / 16 k16 steps) slabs of c/2 columns, the output conv padded
    from 3 to 8 columns, the shifts after one another with the bias padded
    to 8. fp32 and K4's trunk hold no group."""
    model = _medium(c, 7)
    wt = fold_medium_tail(model, BF16)
    wp, shifts = wt.head_group
    split = 9 * c * (c // 2)
    assert wp.numel() == split + 9 * (c // 2) * 8 and wp.dtype == BF16
    head2 = unpack_layer(wp[:split].reshape(9, c // 16, 2, c // 16, 8, 8))
    assert torch.equal(head2, wt.head2[0].reshape(9, c, c // 2))
    out = unpack_layer(wp[split:].reshape(9, c // 32, 2, 1, 8, 8))
    assert torch.equal(out[:, :, :3], wt.out[0].reshape(9, c // 2, 3))
    assert not out[:, :, 3:].any()
    assert shifts.dtype == F32 and shifts.numel() == c // 2 + 8
    assert torch.equal(shifts[:c // 2], wt.head2[1])
    assert torch.equal(shifts[c // 2:c // 2 + 3], wt.out[1]) and not shifts[c // 2 + 3:].any()
    assert fold_medium_tail(model, F32).head_group is None
    high = init_params_(PB.HighIntensityDehazeModel(c), torch.Generator().manual_seed(8))
    assert fold_high_tail(high.eval(), BF16).trunk.head_group is None


# ---- the serving repairs ------------------------------------------------------

SHAPE = (2, 32, 32, 3)


def _on_cuda(monkeypatch):
    """Make serving_autotune see a model on a CUDA device named "Some GPU"."""
    from adam_dehaze_tpu_torch import serving_autotune
    monkeypatch.setattr(serving_autotune, "_device_of",
                        lambda m: types.SimpleNamespace(type="cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some GPU")


def test_cache_key_misses_when_the_kernels_change(monkeypatch, tmp_path):
    """On a CUDA device the key holds the hash of the kernels' sources: a
    winner cached before the kernels changed is a miss, and is tuned again."""
    _on_cuda(monkeypatch)
    port = PB.LightweightDehazeModel(8, 1)
    key = _cache_key(port, F32, SHAPE)
    assert key.startswith("cuda:Some_GPU:") and key.endswith(f":kernels{_build._source_hash()}")
    cache = tmp_path / "autotune.json"
    cache.write_text(json.dumps({key: {"best": "canonical", "table": {"canonical": 1.0}}}))
    _, hit = load_cached(port, F32, SHAPE, str(cache))
    assert hit["cached"] is True and hit["best"] == "canonical"
    monkeypatch.setattr(_build, "_source_hash", lambda: "0" * 16)
    assert _cache_key(port, F32, SHAPE) != key
    assert load_cached(port, F32, SHAPE, str(cache)) == (None, None)


def test_low_canonical_candidate_is_the_module_path(monkeypatch):
    """The low branch's `canonical` candidate runs the branch's modules,
    never its forward (whose eval path on a CUDA tensor is K1), and gives
    the JAX package's `model.apply` at 1e-4 in fp32."""
    from adam_dehaze_tpu.models.branches import LightweightDehazeModel as JLow
    _on_cuda(monkeypatch)
    vs = init_flax(JLow(base_channels=8, n_blocks=2, dtype=jnp.float32),
                   images((1, 16, 16, 3)), seed=4)
    jmodel = JLow(base_channels=8, n_blocks=2, dtype=jnp.float32)
    port = port_of(PB.LightweightDehazeModel(8, 2), vs)
    cands = candidate_builders(port, F32, SHAPE)
    assert list(cands) == ["canonical", "chain"]
    x = images(SHAPE, seed=5)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(x), train=False))

    def k1_path(self, x):
        raise AssertionError("the canonical candidate entered the branch's forward")

    apply = cands["canonical"]()
    monkeypatch.setattr(PB.LightweightDehazeModel, "forward", k1_path)
    with torch.inference_mode():
        got = apply(torch.from_numpy(x))
        torch.testing.assert_close(got, port.module_forward(torch.from_numpy(x)),
                                   rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
