"""The port's building blocks (adam_dehaze_tpu_torch/nn/blocks.py) against
the flax blocks, eval mode, fp32, on the same seeded numpy inputs, with
weights moved by `load_flax_variables`. Tolerance ATOL = 1e-4 (fp32 vs
fp32, reordered sums)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.nn import blocks as J
from adam_dehaze_tpu_torch.nn import blocks as P
from torch_port_util import ATOL, images, init_flax, nchw, nhwc, port_of

CONV_CASES = {
    "k3": (dict(features=16, kernel_size=3), dict(kernel_size=3)),
    "k7": (dict(features=16, kernel_size=7), dict(kernel_size=7)),
    "k4s2": (dict(features=16, kernel_size=4, stride=2, padding=1),
             dict(kernel_size=4, stride=2, padding=1)),
    "no_bn": (dict(features=16, kernel_size=3, use_bn=False, activation=None),
              dict(kernel_size=3, use_bn=False, activation=False)),
}


def _compare(jmod, pmod, x):
    vs = init_flax(jmod, x)
    port = port_of(pmod, vs)
    want = np.asarray(jmod.apply(vs, jnp.asarray(x), False))
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convblock_matches_flax(case):
    jkw, pkw = CONV_CASES[case]
    _compare(J.ConvBlock(dtype=jnp.float32, **jkw), P.ConvBlock(8, 16, **pkw),
             images((2, 16, 16, 8)))


def test_residualblock_matches_flax():
    _compare(J.ResidualBlock(12, dtype=jnp.float32), P.ResidualBlock(12),
             images((2, 12, 10, 12)))


@pytest.mark.parametrize("c", [16, 48])
def test_attentionblock_matches_flax(c):
    """The channel MLP and both gates (K2's plain version on the CPU)."""
    _compare(J.AttentionBlock(c, dtype=jnp.float32), P.AttentionBlock(c),
             images((2, 12, 16, c), seed=c))


@pytest.mark.parametrize("subpixel", [True, False], ids=["subpixel", "literal"])
def test_upblock_matches_flax(subpixel):
    """torch ConvTranspose2d(4, 2, 1) + bias == both flax formulations, with
    the converter's spatial flip inverted."""
    _compare(J.UpBlock(8, dtype=jnp.float32, subpixel=subpixel),
             P.UpBlock(12, 8), images((2, 6, 7, 12)))


@pytest.mark.parametrize("size", [(16, 20), (5, 7)], ids=["up", "down"])
def test_resize_bilinear_matches_jax(size):
    x = images((2, 10, 12, 3))
    want = np.asarray(J.resize_bilinear(jnp.asarray(x), size))
    got = nhwc(P.resize_bilinear(nchw(x), size))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_seeded_init_draws_only_from_its_generator():
    """Two modules initialised from equal seeds are equal, whatever the
    global RNG did in between; BN statistics are reset."""
    a, b = P.AttentionBlock(32), P.UpBlock(8, 4)
    P.init_params_(a, torch.Generator().manual_seed(1))
    torch.manual_seed(123)
    a2 = P.init_params_(P.AttentionBlock(32), torch.Generator().manual_seed(1))
    for (k, v), (_, v2) in zip(a.state_dict().items(), a2.state_dict().items()):
        torch.testing.assert_close(v, v2, rtol=0, atol=0, msg=k)
    b[1].running_mean.fill_(3.0)
    P.init_params_(b, torch.Generator().manual_seed(2))
    assert float(b[1].running_mean.abs().max()) == 0.0
    assert float(b[0].bias.detach().abs().max()) == 0.0
    # lecun-normal: std 1/sqrt(fan_in), here 1/sqrt(64 * 9), within 5%.
    cb = P.init_params_(P.ConvBlock(64, 64), torch.Generator().manual_seed(3))
    std = float(cb.block[0].weight.detach().std())
    assert abs(std * 24.0 - 1.0) < 0.05


def test_load_rejects_shape_mismatch():
    vs = init_flax(J.ConvBlock(16, 3, dtype=jnp.float32), images((1, 8, 8, 8)))
    with pytest.raises(ValueError, match="Shape mismatch"):
        port_of(P.ConvBlock(4, 16, 3), vs)


def test_bn_folds_match_the_blocks():
    """ops/fold.py: a ConvBlock's conv + eval BN, and an UpBlock's
    ConvTranspose (with its bias) + eval BN, equal one conv with the folded
    weight and shift (before the ReLU)."""
    import torch.nn.functional as F

    from adam_dehaze_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(4)
    cb = P.init_params_(P.ConvBlock(6, 10, activation=False), gen).eval()
    up = P.init_params_(P.UpBlock(6, 10), gen).eval()
    with torch.no_grad():
        for bn in (cb.block[1], up[1]):
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(generator=gen)
            bn.running_mean.normal_(generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
        up[0].bias.normal_(generator=gen)
        x = torch.rand(2, 6, 9, 7, generator=gen)
        w, t = fold.fold_convblock(cb)
        torch.testing.assert_close(F.conv2d(x, w, t, padding=1), cb(x),
                                   rtol=0, atol=ATOL)
        w, t = fold.fold_upblock(up)
        torch.testing.assert_close(
            F.conv_transpose2d(x, w, t, stride=2, padding=1), up[1](up[0](x)),
            rtol=0, atol=ATOL)
