"""The half-resolution dial of the port (adam_dehaze_tpu_torch/ops/
resolution.py, data/synthetic.py:_box_filter) against the JAX package's
(adam_dehaze_tpu/ops/resolution.py) on the same seeded inputs, on the CPU.

Every case of tests/test_resolution.py, run on both packages, plus odd sides
(17x23) and radius 0, 2 and 4.

Tolerances. The box filter is a float32 integral image: its corner sums
reach H*W, so float32 carries about 1e-7 * H*W of absolute error there, and
the guided filter divides differences of such means by var + eps, which is
small in flat regions (radius 0: var is 0 in exact arithmetic). The two
packages sum in other orders, so they can differ more than 1e-4 where
either is that far from exact. Each case is therefore held twice against
the JAX function in float64 (under jax.enable_x64): the port in float64
within 1e-10 (the same arithmetic), and the port in float32 within 1e-4 or
4 times the JAX package's own float32 error, whichever is larger.
Outputs that involve no box filter (the bilinear lift, the engines) are
held at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.data.synthetic import _box_filter as jax_box_filter
from adam_dehaze_tpu.models.routing import BinnedAdaptiveEngine as JaxEngine
from adam_dehaze_tpu.nn.blocks import resize_bilinear as jax_resize
from adam_dehaze_tpu.ops import resolution as JR
from adam_dehaze_tpu_torch.data.synthetic import _box_filter
from adam_dehaze_tpu_torch.models.routing import BinnedAdaptiveEngine
from adam_dehaze_tpu_torch.nn.blocks import resize_bilinear
from adam_dehaze_tpu_torch.ops import resolution as PR
from torch_port_util import ATOL, images, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The port in float32 within this many times the JAX package's float32
# error (both against JAX in float64), or within ATOL where that is larger.
F32_K = 4.0
SHAPES = [(17, 23), (32, 32)]
RADII = [0, 2, 4]


def _jax64(fn, *arrays):
    with jax.enable_x64(True):
        return np.asarray(jax.jit(fn)(*[jnp.asarray(np.asarray(a, np.float64))
                                        for a in arrays]))


def _jax32(fn, *arrays):
    # jit: one compile a case, where op by op compiles every primitive.
    return np.asarray(jax.jit(fn)(*[jnp.asarray(a) for a in arrays]))


def _port(fn, *arrays, dtype=torch.float32):
    return fn(*[torch.from_numpy(np.asarray(a)).to(dtype) for a in arrays]).numpy()


def assert_matches_jax(port_fn, jax_fn, *arrays):
    """port_fn and jax_fn on the same inputs: the float64 port equals JAX's
    float64 result, and the float32 port is within F32_K times JAX's own
    float32 error of it (or ATOL)."""
    ref = _jax64(jax_fn, *arrays)
    np.testing.assert_allclose(_port(port_fn, *arrays, dtype=torch.float64), ref,
                               rtol=0, atol=1e-10)
    jax_err = float(np.abs(_jax32(jax_fn, *arrays) - ref).max())
    port_err = float(np.abs(_port(port_fn, *arrays) - ref).max())
    assert port_err <= max(ATOL, F32_K * jax_err), (port_err, jax_err)


def _nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("hw", SHAPES)
def test_box_filter_matches_jax(hw, radius):
    x = images((2, 3) + hw, seed=radius)
    assert_matches_jax(lambda v: _box_filter(v, radius), lambda v: jax_box_filter(v, radius), x)


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("hw", SHAPES)
def test_guided_upsample_matches_jax(hw, radius):
    h, w = hw
    g_hi = images((2, h, w), seed=1)
    g_lo = images((2, h // 2, w // 2), seed=2)
    s = images((2, h // 2, w // 2, 3), seed=3)
    assert_matches_jax(lambda a, b, c: PR.guided_upsample(a, b, c, radius=radius),
                       lambda a, b, c: JR.guided_upsample(a, b, c, radius=radius),
                       g_hi, g_lo, s)


def _branch(v, xp):
    """A nonlinear stand-in for a branch: a per-channel curve and a
    cross-channel term, in [0, 1]."""
    return xp.clip(0.8 * v + 0.3 * v * v[..., ::-1] - 0.05, 0.0, 1.0)


def _torch_branch(v):
    return torch.clamp(0.8 * v + 0.3 * v * v.flip(-1) - 0.05, 0.0, 1.0)


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("hw", SHAPES)
def test_lowres_apply_guided_matches_jax(hw, radius):
    x = images((3,) + hw + (3,), seed=4)
    assert_matches_jax(
        PR.make_lowres_apply(_torch_branch, scale=2, mode="guided", radius=radius),
        JR.make_lowres_apply(lambda v: _branch(v, jnp), scale=2, mode="guided",
                             radius=radius), x)


@pytest.mark.parametrize("hw", SHAPES)
def test_lowres_apply_bilinear_matches_jax(hw):
    x = images((3,) + hw + (3,), seed=5)
    got = _port(PR.make_lowres_apply(_torch_branch, mode="bilinear"), x)
    want = _jax32(JR.make_lowres_apply(lambda v: _branch(v, jnp), mode="bilinear"), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resize_pair_matches_jax():
    """The shrink (antialiased) and the lift that the dial runs, at odd
    sides, NHWC through the port's NCHW resize."""
    x = images((2, 17, 23, 3), seed=6)
    for size in ((8, 11), (17, 23), (34, 46)):
        got = resize_bilinear(torch.from_numpy(_nchw(x)), size).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_resize(jnp.asarray(x), size)),
                                   rtol=0, atol=1e-6)


# --- the cases of tests/test_resolution.py, on both packages ---------------

def test_guided_upsample_same_res_radius0_is_identity():
    g = images((2, 16, 16), seed=7)
    s = images((2, 16, 16, 3), seed=8)
    got = PR.guided_upsample(torch.from_numpy(g), torch.from_numpy(g), torch.from_numpy(s),
                             radius=0, eps=1e-6).numpy()
    want = _jax32(lambda a, b: JR.guided_upsample(a, a, b, radius=0, eps=1e-6), g, s)
    # radius-0 boxes are per pixel: var_g = 0 -> a = 0, b = s (up to the
    # cancellation in cov/(0 + eps), hence JAX's own 2e-3).
    np.testing.assert_allclose(got, s, atol=2e-3)
    np.testing.assert_allclose(want, s, atol=2e-3)


def test_guided_upsample_constant_src():
    g_hi = images((2, 32, 32), seed=9)
    g_lo = resize_bilinear(torch.from_numpy(g_hi)[:, None], (16, 16))[:, 0]
    s = torch.full((2, 16, 16, 3), 0.37)
    got = PR.guided_upsample(torch.from_numpy(g_hi), g_lo, s, radius=2).numpy()
    want = _jax32(lambda a, b, c: JR.guided_upsample(a, b, c, radius=2),
                  g_hi, g_lo.numpy(), s.numpy())
    np.testing.assert_allclose(got, 0.37, atol=1e-3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_guided_upsample_shapes():
    got = PR.guided_upsample(torch.rand(3, 64, 64), torch.rand(3, 16, 16),
                             torch.rand(3, 16, 16, 5))
    want = jax.eval_shape(JR.guided_upsample, jnp.zeros((3, 64, 64)), jnp.zeros((3, 16, 16)),
                          jnp.zeros((3, 16, 16, 5)))
    assert tuple(got.shape) == want.shape == (3, 64, 64, 5)


@pytest.mark.parametrize("mode", ["guided", "bilinear"])
def test_lowres_identity_branch_is_exact(mode):
    """A branch that returns its input: zero correction, so the wrapper
    returns x, in both packages."""
    x = images((4, 32, 32, 3), seed=10)
    got = PR.make_lowres_apply(lambda v: v, scale=2, mode=mode)(torch.from_numpy(x)).numpy()
    want = _jax32(JR.make_lowres_apply(lambda v: v, scale=2, mode=mode), x)
    np.testing.assert_allclose(got, x, atol=1e-6)
    np.testing.assert_allclose(want, x, atol=1e-6)


@pytest.mark.parametrize("mode", ["guided", "bilinear"])
def test_lowres_constant_correction(mode):
    x = images((4, 32, 32, 3), seed=11)
    got = PR.make_lowres_apply(lambda v: torch.clamp(v + 0.1, 0, 1), scale=2,
                               mode=mode)(torch.from_numpy(x)).numpy()
    want = _jax32(JR.make_lowres_apply(lambda v: jnp.clip(v + 0.1, 0, 1), scale=2, mode=mode),
                  x)
    ref = np.clip(x + 0.1, 0, 1)
    # The interior follows the constant; the edges move under the box filters.
    np.testing.assert_allclose(got[:, 4:-4, 4:-4], ref[:, 4:-4, 4:-4], atol=2e-2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_lowres_mode_validation():
    with pytest.raises(ValueError) as port_err:
        PR.make_lowres_apply(lambda v: v, mode="nearest")
    with pytest.raises(ValueError) as jax_err:
        JR.make_lowres_apply(lambda v: v, mode="nearest")
    assert str(port_err.value) == str(jax_err.value)


def test_lowres_apply_runs_at_reduced_resolution():
    seen = []

    def probe(v):
        seen.append(tuple(v.shape))
        return v

    PR.make_lowres_apply(probe, scale=2)(torch.rand(4, 32, 32, 3))
    jax.eval_shape(JR.make_lowres_apply(probe, scale=2), jnp.zeros((4, 32, 32, 3)))
    assert seen == [(4, 16, 16, 3)] * 2


def test_lowres_composes_with_spill():
    """Capacity spill and the dial are independent engine options: identity
    branches make the composed output exactly checkable, and the port's
    plan and labels follow the JAX engine's."""
    x = images((4, 32, 32, 3), seed=12)

    def jax_classifier(img):
        cls = jnp.where(jnp.arange(img.shape[0]) == 0, 0, 2)
        return jax.nn.one_hot(cls, 3) * 10.0, {}

    def port_classifier(img):
        cls = torch.where(torch.arange(img.shape[0]) == 0, 0, 2)
        return torch.nn.functional.one_hot(cls, 3).float() * 10.0, {}

    ident = lambda v: v  # noqa: E731
    port = BinnedAdaptiveEngine(port_classifier,
                                [ident, ident, PR.make_lowres_apply(ident)], buckets=(2,))
    jeng = JaxEngine(jax_classifier, [ident, ident, JR.make_lowres_apply(ident)], buckets=(2,))
    got, got_i = port(torch.from_numpy(x), spill=True)
    want, want_i = jeng(jnp.asarray(x), spill=True)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(want_i))


def test_binned_engine_with_lowres_branch():
    """A half-resolution branch routes and reassembles like a full one
    (identity branches make it checkable)."""
    x = images((4, 32, 32, 3), seed=13)

    def classifier(img):
        return torch.nn.functional.one_hot(torch.arange(img.shape[0]) % 3, 3).float() * 10, {}

    mul = lambda v: torch.clamp(v * 1.0, 0.0, 1.0)  # noqa: E731
    full = BinnedAdaptiveEngine(classifier, [mul, mul, mul])
    wrapped = BinnedAdaptiveEngine(classifier, [mul, mul, PR.make_lowres_apply(mul)])
    out_full, i_full = full(torch.from_numpy(x))
    out_lo, i_lo = wrapped(torch.from_numpy(x))
    np.testing.assert_array_equal(i_full, i_lo)
    np.testing.assert_allclose(out_lo.numpy(), out_full.numpy(), atol=1e-6)


def test_tuned_apply_refuses_a_half_size_it_does_not_take():
    """A kernel apply that refuses the half-resolution shape raises its
    ValueError through the dial, at call time, with nothing retried on
    another apply: 36^2 is served at 18^2, and 18 is no multiple of 4."""
    from adam_dehaze_tpu_torch.models.branches import HighIntensityDehazeModel
    from adam_dehaze_tpu_torch.ops.serving_apply import BranchChainApply

    apply = BranchChainApply(HighIntensityDehazeModel(16).eval(), torch.float32, "high",
                             tail=True)
    lowres = PR.make_lowres_apply(apply)
    with torch.inference_mode():
        assert tuple(lowres(torch.rand(1, 32, 32, 3)).shape) == (1, 32, 32, 3)
        with pytest.raises(ValueError, match="does not take width 16 at 18x18"):
            lowres(torch.rand(1, 36, 36, 3))
