"""The tail chains K3 and K4, the spatial gate K2' and their serving applies
of the PyTorch port, on the CPU at small widths (c=16, 32^2, batch 2), fp32.

The folds are held against torch's own modules at 1e-5. The plain versions
of the tails are held against the JAX package's plain reference of its tail
kernels: the XLA tail of ops/s2d.py, composed as tests/test_tail_chain.py
composes it (this file does the space-to-depth of f0 and x that the JAX
tail wants), at ATOL 1e-4 (fp32 vs fp32 after some ten layers of reordered
sums). The tail applies are held against the JAX canonical forward and the
port's own. The kernels themselves are held against these plain versions on
the card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.ops import s2d as JS
from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.ops import fold
from adam_dehaze_tpu_torch.ops.kernels.cbam import (
    spatial_gate,
    spatial_gate_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.tail_chain import (
    fold_high_tail,
    fold_medium_tail,
    high_tail_chain,
    high_tail_chain_reference,
    medium_tail_chain,
    medium_tail_chain_reference,
    subpixel_up_reference,
    tail_supported,
)
from adam_dehaze_tpu_torch.ops.serving_apply import (
    BranchChainApply,
    make_high_tail_apply,
    make_medium_tail_apply,
)
from torch_port_util import ATOL, images, init_flax, port_of

C, SIZE, BATCH = 16, 32, 2
FOLD_ATOL = 1e-5

_KINDS = {
    "medium": (JB.MediumIntensityDehazeModel, PB.MediumIntensityDehazeModel,
               fold_medium_tail, medium_tail_chain, medium_tail_chain_reference,
               make_medium_tail_apply, ("ConvBlock_3", "ConvBlock_4", "Conv_0")),
    "high": (JB.HighIntensityDehazeModel, PB.HighIntensityDehazeModel,
             fold_high_tail, high_tail_chain, high_tail_chain_reference,
             make_high_tail_apply, ("ConvBlock_5", "ConvBlock_6", "Conv_1")),
}


@pytest.fixture(scope="module", params=["medium", "high"])
def branch(request):
    """(kind, JAX model, flax variables, the port's model on them)."""
    jcls, pcls = _KINDS[request.param][:2]
    jmodel = jcls(base_channels=C, use_pallas=False, dtype=jnp.float32)
    vs = init_flax(jmodel, images((1, SIZE, SIZE, 3)), seed=3)
    return request.param, jmodel, vs, port_of(pcls(C), vs)


def _tail_inputs(seed=5):
    """d1, f0 non-negative like the real decoder state, x in [0, 1]; NHWC."""
    rng = np.random.default_rng(seed)
    h2 = SIZE // 2
    d1 = np.maximum(rng.standard_normal((BATCH, h2, h2, 4 * C)), 0).astype(np.float32)
    f0 = np.maximum(rng.standard_normal((BATCH, SIZE, SIZE, C)), 0).astype(np.float32)
    return d1, f0, images((BATCH, SIZE, SIZE, 3), seed=seed + 1)


def _jax_xla_tail(kind, vs, dtype=jnp.float32):
    """The XLA tail of make_medium_s2d_apply / make_high_s2d_apply
    (ops/s2d.py:590-608, :693-703): d1 plain, f0 and x in the s2d layout,
    the result back in the plain layout."""
    p, bs = vs["params"], vs["batch_stats"]
    h1, h2, out = _KINDS[kind][6]
    up = p["UpBlock_1"]
    kup, tup_ = JS._fold_bn(up["ConvTranspose_0"]["kernel"], up["BatchNorm_0"]["scale"],
                            up["BatchNorm_0"]["bias"], bs["UpBlock_1"]["BatchNorm_0"]["mean"],
                            bs["UpBlock_1"]["BatchNorm_0"]["var"])
    s_up = up["BatchNorm_0"]["scale"] / jnp.sqrt(bs["UpBlock_1"]["BatchNorm_0"]["var"] + 1e-5)
    tup = tup_ + s_up * up["ConvTranspose_0"]["bias"]
    kh1, th1 = JS._fold_convblock(p, bs, h1)
    kh2, th2 = JS._fold_convblock(p, bs, h2)
    kh1s, kh2s = (JS.s2d_conv_kernel(k).astype(dtype) for k in (kh1, kh2))
    kouts, tout = JS.s2d_conv_kernel(p[out]["kernel"]).astype(dtype), p[out]["bias"]
    if kind == "high":
        kg1, tg1 = JS._fold_convblock(p, bs, "ConvBlock_0")
        kg2, tg2 = JS._fold_convblock(p, bs, "ConvBlock_1")
        kg1s, kg2s = (JS.s2d_conv_kernel(k).astype(dtype) for k in (kg1, kg2))
        kgos, tgo = JS.s2d_conv_kernel(p["Conv_0"]["kernel"]).astype(dtype), p["Conv_0"]["bias"]

    def tail(d1, f0, x):
        d1 = jnp.asarray(d1, dtype)
        f0s = JS.space_to_depth(jnp.asarray(f0, dtype))
        x2 = JS.space_to_depth(jnp.asarray(x, dtype))
        d2 = JS.s2d_up4(d1, kup.astype(dtype), shift=tup, relu=True)
        d2 = JS._s2d_residual(d2, p, bs, "ResidualBlock_7", C, dtype)
        if kind == "high":
            d2 = JS.s2d_attention(d2, p["AttentionBlock_5"], C, dtype=dtype)
        d2 = JS.s2d_concat(d2, f0s, C, C)
        h = JS.s2d_conv(d2, kh1s, C, k=3, shift=th1, relu=True)
        h = JS.s2d_conv(h, kh2s, C // 2, k=3, shift=th2, relu=True)
        res = jnp.tanh(JS.s2d_conv(h, kouts, 3, k=3, shift=tout))
        n, hh, ww, _ = res.shape
        if kind == "high":
            g = JS.s2d_conv(x2, kg1s, 16, k=3, shift=tg1, relu=True)
            g = JS.s2d_conv(g, kg2s, 16, k=3, shift=tg2, relu=True)
            guidance = jax.nn.sigmoid(JS.s2d_conv(g, kgos, 1, k=1, shift=tgo))
            res = (res.reshape(n, hh, ww, 4, 3)
                   * guidance.reshape(n, hh, ww, 4, 1)).reshape(n, hh, ww, 12)
        return np.asarray(JS.depth_to_space(jnp.clip(x2 + res, 0.0, 1.0)), np.float32)

    return tail


# ---- the folds against torch's own modules ---------------------------------

def _randomized(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return module.eval()


@pytest.mark.parametrize("cin,cout,h,w", [(8, 4, 5, 7), (64, 16, 16, 16)])
def test_upblock_phases_match_conv_transpose(cin, cout, h, w):
    """The four 2x2-tap phase convs are nn.ConvTranspose2d(4, 2, 1) + BN,
    bias included: pins the phase and tap map."""
    from adam_dehaze_tpu_torch.nn.blocks import UpBlock
    up = _randomized(UpBlock(cin, cout), 1)
    x = torch.randn(2, cin, h, w, generator=torch.Generator().manual_seed(2))
    phases, shift = fold.fold_upblock_phases(up)
    assert tuple(phases.shape) == (2, 2, 2, 2, cin, cout)
    with torch.no_grad():
        want = up[1](up[0](x))
        got = (subpixel_up_reference(x, phases.reshape(4, 4, cin, cout))
               + shift[None, :, None, None])
    torch.testing.assert_close(got, want, rtol=0, atol=FOLD_ATOL)


def test_upblock_phase_taps_are_the_transposed_kernel():
    """Phase (a, b), tap (u, v) is the ConvTranspose tap
    (3 - a - 2u, 3 - b - 2v): every one of the 16 taps lands once."""
    from adam_dehaze_tpu_torch.nn.blocks import UpBlock
    up = UpBlock(1, 1).eval()
    with torch.no_grad():
        up[0].weight.copy_(torch.arange(16.0).reshape(1, 1, 4, 4))
    phases, _ = fold.fold_upblock_phases(up)
    s = float(up[1].weight[0].detach() / torch.sqrt(up[1].running_var[0] + up[1].eps))
    got = (phases[..., 0, 0] / s).round().long()
    for a in (0, 1):
        for b in (0, 1):
            for u in (0, 1):
                for v in (0, 1):
                    assert got[a, b, u, v] == (3 - a - 2 * u) * 4 + (3 - b - 2 * v)
    assert sorted(got.flatten().tolist()) == list(range(16))


def test_head_split_matches_conv_on_the_concat():
    """conv(cat([d2, f0])) == conv_a(d2) + conv_b(f0): d2 owns the first
    input channels, as torch.cat([d2, f0], dim=1) orders them."""
    from adam_dehaze_tpu_torch.nn.blocks import ConvBlock
    block = _randomized(ConvBlock(12, 6, 3), 4)
    gen = torch.Generator().manual_seed(5)
    d2, f0 = torch.randn(2, 5, 9, 8, generator=gen), torch.randn(2, 7, 9, 8, generator=gen)
    wa, wb, shift = fold.fold_head_split(block, 5)
    assert wa.shape[1] == 5 and wb.shape[1] == 7
    with torch.no_grad():
        want = block(torch.cat([d2, f0], dim=1))
        got = torch.relu(nn.functional.conv2d(d2, wa, padding=1)
                         + nn.functional.conv2d(f0, wb, padding=1)
                         + shift[None, :, None, None])
    torch.testing.assert_close(got, want, rtol=0, atol=FOLD_ATOL)


def test_tail_folds_round_weights_to_compute_dtype(branch):
    kind, _, _, port = branch
    wt = _KINDS[kind][2](port, torch.bfloat16)
    trunk = wt.trunk if kind == "high" else wt
    assert wt.dtype == torch.bfloat16 and wt.channels == C
    assert tuple(trunk.up.shape) == (4, 4, 4 * C, C)
    assert tuple(trunk.head1_d2.shape) == tuple(trunk.head1_f0.shape) == (3, 3, C, C)
    assert tuple(trunk.head2[0].shape) == (3, 3, C, C // 2)
    assert tuple(trunk.out[0].shape) == (3, 3, C // 2, 3)
    for t in (trunk.up_shift, trunk.head1_shift, trunk.res_a[1], trunk.out[1]):
        assert t.dtype == torch.float32
    if kind == "high":
        assert wt.attn_fc0.dtype == wt.attn_stencil.dtype == torch.float32
        assert tuple(wt.attn_stencil.shape) == (7, 7, 2)
        # The stencil's values are bf16 values held in f32.
        torch.testing.assert_close(wt.attn_stencil.bfloat16().float(), wt.attn_stencil,
                                   rtol=0, atol=0)
        assert tuple(wt.guidance1[0].shape) == (3, 3, 3, 16)


# ---- the plain tails against the JAX package's plain tails -----------------

def test_plain_tail_matches_jax_xla_tail(branch):
    kind, _, vs, port = branch
    fold_fn, tail = _KINDS[kind][2], _KINDS[kind][3]
    d1, f0, x = _tail_inputs()
    want = _jax_xla_tail(kind, vs)(d1, f0, x)
    before = tail.launches
    got = tail(*map(torch.from_numpy, (d1, f0, x)), fold_fn(port, torch.float32))
    assert tail.launches == before           # a CPU tensor launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cpu_wrapper_is_the_plain_version(branch):
    kind, _, _, port = branch
    fold_fn, tail, reference = _KINDS[kind][2:5]
    wt = fold_fn(port, torch.float32)
    args = list(map(torch.from_numpy, _tail_inputs(seed=9)))
    torch.testing.assert_close(tail(*args, wt), reference(*args, wt), rtol=0, atol=0)


def test_bf16_plain_tail_is_close_to_fp32(branch):
    """The bf16 plain version (the kernels' rounding points) stays within
    the bf16 bound of the JAX tail-chain tests, 3e-2, of the fp32 one."""
    kind, _, _, port = branch
    fold_fn, _, reference = _KINDS[kind][2:5]
    args = list(map(torch.from_numpy, _tail_inputs(seed=10)))
    want = reference(*args, fold_fn(port, torch.float32))
    got = reference(*args, fold_fn(port, torch.bfloat16))
    assert 0 < float((got - want).abs().max()) <= 3e-2


# ---- the serving applies ----------------------------------------------------

def test_tail_apply_matches_jax_and_canonical(branch):
    kind, jmodel, vs, port = branch
    x = images((BATCH, SIZE, SIZE, 3), seed=7)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(x), train=False))
    apply = _KINDS[kind][5](port, torch.float32)
    assert isinstance(apply, BranchChainApply) and apply.segments == ()
    with torch.inference_mode():
        got = apply(torch.from_numpy(x))
        canonical = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), canonical.numpy(), atol=ATOL)


def test_tail_apply_takes_a_non_square_image(branch):
    kind, jmodel, vs, port = branch
    x = images((1, 24, 40, 3), seed=8)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = _KINDS[kind][5](port, torch.float32)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_tail_apply_refuses_sizes_the_canonical_forward_resizes(branch):
    kind, _, _, port = branch
    apply = _KINDS[kind][5](port, torch.float32)
    with pytest.raises(ValueError, match="tail_supported"):
        apply(torch.rand(1, 30, 32, 3))
    with pytest.raises(TypeError):
        (make_high_tail_apply if kind == "medium" else make_medium_tail_apply)(
            port, torch.float32)


@pytest.mark.parametrize("c,h,w,dtype,ok", [
    (64, 256, 256, torch.bfloat16, True), (96, 256, 256, torch.float32, True),
    (16, 32, 48, torch.float32, True), (8, 32, 32, torch.float32, False),
    (24, 32, 32, torch.bfloat16, False), (64, 30, 32, torch.bfloat16, False),
    (64, 32, 34, torch.bfloat16, False), (64, 32, 32, torch.float16, False)])
def test_tail_shape_selector(c, h, w, dtype, ok):
    assert tail_supported(c, h, w, dtype) is ok


# ---- K2' ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 24, 32), (1, 10, 8, 16)],
                         ids=["16x24c32", "10x8c16"])
def test_k2prime_plain_matches_jax_reference(shape):
    from adam_dehaze_tpu.ops.pallas.cbam import spatial_gate_reference as jax_reference
    rng = np.random.default_rng(3)
    x = rng.random(shape, dtype=np.float32)
    w = (rng.standard_normal((7, 7, 2, 1)) * 0.1).astype(np.float32)
    want = np.asarray(jax_reference(jnp.asarray(x), jnp.asarray(w)))
    before = spatial_gate.launches
    got = spatial_gate(torch.from_numpy(x), torch.from_numpy(w))
    assert spatial_gate.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    torch.testing.assert_close(
        got, spatial_gate_reference(torch.from_numpy(x), torch.from_numpy(w)),
        rtol=0, atol=0)


def test_k2prime_is_k2_with_a_gate_of_ones():
    from adam_dehaze_tpu_torch.ops.kernels.cbam import channel_spatial_gate_reference
    gen = torch.Generator().manual_seed(6)
    x, w = torch.rand(2, 9, 11, 8, generator=gen), torch.randn(7, 7, 2, 1, generator=gen)
    torch.testing.assert_close(
        spatial_gate_reference(x, w),
        channel_spatial_gate_reference(x, torch.ones(2, 8), w), rtol=0, atol=0)
