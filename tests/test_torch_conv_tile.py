"""The conv layer that the chain kernels K3, K4 and K6 share
(adam_dehaze_tpu_torch/ops/kernels/conv_tile.py), on the CPU, fp32.

`conv_tile_reference`, the plain version the kernel is held against on the
card, is held here against the flax blocks on the same seeded numpy inputs,
with weights moved by `load_flax_variables` and folded by ops/fold.py: a 3x3
ConvBlock with eval-mode BN, a two-input conv against the ConvBlock on the
concat, and the four sub-pixel phases against both flax formulations of the
UpBlock. Tolerance ATOL = 1e-4 (fp32 vs fp32, reordered sums, precision
"highest" on the JAX side). On CPU tensors `conv_tile` is the plain version
bit for bit. `conv_tile_plan`, the Python mirror of the library's choice of
body, is checked over every conv layer that `chip_smoke.py` tabulates; the
card test holds it against the library itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.nn import blocks as J
from adam_dehaze_tpu_torch.nn import blocks as P
from adam_dehaze_tpu_torch.ops import fold
from adam_dehaze_tpu_torch.ops.kernels.conv_tile import (
    FMA_SMEM_BYTES,
    MAX_SMEM_BYTES,
    WGMMA_COUT_CHUNKS,
    conv_tile,
    conv_tile_plan,
    conv_tile_reference,
    pack_conv_weights,
    packed_for_kernel,
    unpack_conv_weights,
)
from torch_port_util import ATOL, images, init_flax, port_of


def _hwio(w):
    return w.permute(2, 3, 1, 0).contiguous()


def _activation(shape, seed):
    """Non-negative like the activation after a ReLU, NHWC."""
    rng = np.random.default_rng(seed)
    return np.maximum(rng.standard_normal(shape), 0).astype(np.float32)


@pytest.mark.parametrize("cin,cout,sides", [(8, 16, (2, 16, 16)), (16, 16, (1, 13, 21)),
                                            (12, 6, (2, 9, 40)), (3, 16, (1, 5, 7))])
def test_reference_matches_flax_convblock(cin, cout, sides):
    """conv + eval BN + ReLU of the flax ConvBlock == the plain version on
    the folded weight and shift."""
    x = _activation((*sides, cin), 1)
    jmod = J.ConvBlock(features=cout, kernel_size=3, dtype=jnp.float32)
    vs = init_flax(jmod, x, seed=2)
    want = np.asarray(jmod.apply(vs, jnp.asarray(x), False))
    w, shift = fold.fold_convblock(port_of(P.ConvBlock(cin, cout, 3), vs))
    got = conv_tile_reference(torch.from_numpy(x), _hwio(w.detach()), shift.detach())
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_reference_without_relu_matches_flax_convblock():
    x = _activation((2, 8, 8, 8), 3)
    jmod = J.ConvBlock(features=16, kernel_size=3, activation=None, dtype=jnp.float32)
    vs = init_flax(jmod, x, seed=4)
    want = np.asarray(jmod.apply(vs, jnp.asarray(x), False))
    assert want.min() < 0
    w, shift = fold.fold_convblock(port_of(P.ConvBlock(8, 16, 3, activation=False), vs))
    got = conv_tile_reference(torch.from_numpy(x), _hwio(w.detach()), shift.detach(),
                              relu=False)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("c0,c1,cout", [(8, 8, 8), (16, 4, 12)])
def test_two_inputs_match_flax_conv_of_the_concat(c0, c1, cout):
    """conv(cat([a, b])) of the flax ConvBlock == the plain version walking
    a and b as two inputs: the concat is never written."""
    a, b = _activation((2, 11, 14, c0), 5), _activation((2, 11, 14, c1), 6)
    cat = np.concatenate([a, b], axis=-1)
    jmod = J.ConvBlock(features=cout, kernel_size=3, dtype=jnp.float32)
    vs = init_flax(jmod, cat, seed=7)
    want = np.asarray(jmod.apply(vs, jnp.asarray(cat), False))
    wa, wb, shift = fold.fold_head_split(port_of(P.ConvBlock(c0 + c1, cout, 3), vs), c0)
    got = conv_tile_reference(torch.from_numpy(a), _hwio(wa.detach()), shift.detach(),
                              x2=torch.from_numpy(b), w2=_hwio(wb.detach()))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("subpixel", [True, False], ids=["subpixel", "literal"])
@pytest.mark.parametrize("cin,cout,sides", [(12, 8, (2, 6, 7)), (16, 4, (1, 5, 9))])
def test_phases_match_flax_upblock(subpixel, cin, cout, sides):
    """ksize 2: the four sub-pixel phases with BN folded == the flax UpBlock
    (its sub-pixel formulation and the literal ConvTranspose), ReLU included."""
    x = _activation((*sides, cin), 8)
    jmod = J.UpBlock(cout, dtype=jnp.float32, subpixel=subpixel)
    vs = init_flax(jmod, x, seed=9)
    want = np.asarray(jmod.apply(vs, jnp.asarray(x), False))
    phases, shift = fold.fold_upblock_phases(port_of(P.UpBlock(cin, cout), vs))
    got = conv_tile_reference(torch.from_numpy(x),
                              phases.detach().reshape(4, 4, cin, cout).contiguous(),
                              shift.detach(), ksize=2)
    assert got.shape == (sides[0], 2 * sides[1], 2 * sides[2], cout)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_residual_matches_flax_residualblock():
    """Two layers, the second with the skip add in its epilogue, are the
    flax ResidualBlock."""
    x = _activation((2, 12, 10, 12), 10)
    jmod = J.ResidualBlock(12, dtype=jnp.float32)
    vs = init_flax(jmod, x, seed=11)
    want = np.asarray(jmod.apply(vs, jnp.asarray(x), False))
    port = port_of(P.ResidualBlock(12), vs)
    (w0, t0), (w1, t1) = (fold.fold_convblock(cb) for cb in (port.conv1, port.conv2))
    xt = torch.from_numpy(x)
    a = conv_tile_reference(xt, _hwio(w0.detach()), t0.detach())
    got = conv_tile_reference(a, _hwio(w1.detach()), t1.detach(), residual=xt)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _random_case(ksize, c0, c1, cout, dtype, seed, residual):
    gen = torch.Generator().manual_seed(seed)
    taps = (3, 3) if ksize == 3 else (4, 4)
    up = 1 if ksize == 3 else 2
    case = dict(x=torch.rand(2, 6, 9, c0, generator=gen).to(dtype),
                w=(torch.randn(*taps, c0, cout, generator=gen) * 0.2).to(dtype),
                shift=torch.randn(cout, generator=gen), ksize=ksize)
    if c1:
        case.update(x2=torch.rand(2, 6, 9, c1, generator=gen).to(dtype),
                    w2=(torch.randn(*taps, c1, cout, generator=gen) * 0.2).to(dtype))
    if residual:
        case["residual"] = torch.rand(2, up * 6, up * 9, cout, generator=gen).to(dtype)
    return case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("ksize,c0,c1,residual", [(3, 16, 0, False), (3, 8, 8, True),
                                                  (2, 16, 0, False)])
def test_conv_tile_on_cpu_is_the_reference(dtype, ksize, c0, c1, residual):
    """A CPU tensor takes the plain version, bit for bit; `out` is filled
    and returned, and may be the residual."""
    case = _random_case(ksize, c0, c1, 16, dtype, 13, residual)
    want = conv_tile_reference(**case)
    got = conv_tile(**case)
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    out = case["residual"].clone() if residual else torch.empty_like(want)
    if residual:
        case["residual"] = out
    again = conv_tile(out=out, **case)
    assert again is out
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_bf16_reference_rounds_once():
    """bf16: the sum and the epilogue are f32 over the bf16 values, and the
    result is the f32 result rounded once."""
    case = _random_case(3, 16, 16, 16, torch.bfloat16, 17, True)
    as_f32 = {k: v.float() if torch.is_tensor(v) else v for k, v in case.items()}
    want = conv_tile_reference(**as_f32).bfloat16()
    torch.testing.assert_close(conv_tile_reference(**case), want, rtol=0, atol=0)


# Every conv layer of the three forced paths at their main-path widths
# (chip_smoke.py:CONV_LAYERS), then the 16-channel ends (48, 16): name ->
# (c0, c1, cout, ksize, output-channel chunk of the wgmma body).
PLAN_LAYERS = {
    "K6 128->128": (128, 0, 128, 3, 128),
    "K6 256->256": (256, 0, 256, 3, 128),
    "K6 192->192": (192, 0, 192, 3, 96),
    "K6 384->384": (384, 0, 384, 3, 128),
    "K4 up 384->96": (384, 0, 96, 2, 96),
    "K4 96->96": (96, 0, 96, 3, 96),
    "K4 [96+96]->96": (96, 96, 96, 3, 96),
    "K4 96->48": (96, 0, 48, 3, 48),
    "K4 16->16": (16, 0, 16, 3, 16),
    "K3 up 256->64": (256, 0, 64, 2, 64),
    "K3 64->64": (64, 0, 64, 3, 64),
    "K3 [64+64]->64": (64, 64, 64, 3, 64),
    "K3 64->32": (64, 0, 32, 3, 32),
    "c48 48->48": (48, 0, 48, 3, 48),
    "c48 up 192->48": (192, 0, 48, 2, 48),
    "c16 up 64->16": (64, 0, 16, 2, 16),
    "c80 [48+32]->80": (48, 32, 80, 3, 16),
}


@pytest.mark.parametrize("layer", sorted(PLAN_LAYERS))
def test_plan_takes_wgmma_for_bf16_multiples_of_16(layer):
    c0, c1, cout, ksize, chunk = PLAN_LAYERS[layer]
    plan = conv_tile_plan(c0, c1, cout, ksize, torch.bfloat16)
    assert plan.body == "wgmma" and plan.cout_chunk == chunk
    assert chunk in WGMMA_COUT_CHUNKS and cout % chunk == 0      # chunks cover Cout exactly
    assert plan.tile == (16, 16) and plan.kc == 16 and c0 % plan.kc == 0 and c1 % plan.kc == 0
    # A slot holds the haloed tile as two octet planes and every tap's slab.
    side = 16 + ksize - 1
    assert plan.smem_bytes >= plan.stages * (8 + side * side * 16 * 2
                                              + ksize * ksize * 16 * chunk * 2)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    # fp32 on the same widths runs the FMA body.
    assert conv_tile_plan(c0, c1, cout, ksize, torch.float32).body == "fma"


PACK_CASES = {"n128": (32, 128, 3), "n96x2": (48, 192, 3), "n16x5": (16, 80, 3),
              "up_n64": (64, 64, 2), "up_n48": (32, 48, 2)}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_then_unpack_is_the_identity(case):
    """The packed copy holds every (phase, chunk, stage) slab as the slot
    wants it, [tap][k octet][n octet][8 k rows][8 n], and nothing is lost."""
    cin, cout, ksize = PACK_CASES[case]
    taps = (3, 3) if ksize == 3 else (4, 4)
    w = torch.randn(*taps, cin, cout, generator=torch.Generator().manual_seed(19))
    packed = pack_conv_weights(w, ksize)
    chunk = conv_tile_plan(cin, 0, cout, ksize, torch.bfloat16).cout_chunk
    phases, n_taps = (1, 9) if ksize == 3 else (4, 4)
    assert packed.is_contiguous()
    assert tuple(packed.shape) == (phases, cout // chunk, cin // 16, n_taps, 2, chunk // 8, 8, 8)
    torch.testing.assert_close(unpack_conv_weights(packed, ksize), w, rtol=0, atol=0)
    flat = w.reshape(phases, n_taps, cin, cout)
    for p, q, s, t, ko, no, kr, n in ((0, 0, 0, 0, 0, 0, 0, 0), (phases - 1, 0, min(1, cin // 16 - 1), 3, 1, 1, 5, 7),
                                      (0, cout // chunk - 1, cin // 16 - 1, n_taps - 1, 1,
                                       chunk // 8 - 1, 7, 3)):
        assert packed[p, q, s, t, ko, no, kr, n] == flat[
            p, t, s * 16 + ko * 8 + kr, q * chunk + no * 8 + n]


@pytest.mark.parametrize("ksize", [3, 2])
def test_reference_on_unpacked_weights_is_the_reference(ksize):
    case = _random_case(ksize, 32, 0, 48, torch.bfloat16, 23, False)
    again = dict(case, w=unpack_conv_weights(pack_conv_weights(case["w"], ksize), ksize))
    torch.testing.assert_close(conv_tile_reference(**again), conv_tile_reference(**case),
                               rtol=0, atol=0)


def test_packed_for_kernel_follows_the_plan():
    gen = torch.Generator().manual_seed(29)
    w = torch.randn(3, 3, 32, 32, generator=gen)
    assert packed_for_kernel(w) is None                        # fp32: the FMA body
    assert packed_for_kernel(w.bfloat16()).dtype == torch.bfloat16
    assert packed_for_kernel(w[:, :, :24].bfloat16()) is None  # 24 is no multiple of 16
    with pytest.raises(ValueError):
        pack_conv_weights(w[..., :24], 3)


@pytest.mark.parametrize("c0,c1,cout", [(3, 0, 16), (48, 0, 3), (24, 0, 24), (16, 8, 16),
                                        (16, 0, 24), (8, 0, 8)])
def test_plan_takes_fma_for_other_widths(c0, c1, cout):
    for dtype in (torch.bfloat16, torch.float32):
        plan = conv_tile_plan(c0, c1, cout, 3, dtype)
        assert plan.body == "fma" and plan.smem_bytes == FMA_SMEM_BYTES <= MAX_SMEM_BYTES
    with pytest.raises(ValueError):
        conv_tile_plan(c0, c1, cout, 5, torch.bfloat16)


def test_plan_covers_every_multiple_of_16():
    for cout in range(16, 1025, 16):
        for ksize in (2, 3):
            plan = conv_tile_plan(16, 0, cout, ksize, torch.bfloat16)
            assert plan.body == "wgmma" and cout % plan.cout_chunk == 0
            assert plan.smem_bytes <= MAX_SMEM_BYTES
