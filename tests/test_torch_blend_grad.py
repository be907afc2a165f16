"""The gradients of K5 and K2': the port's `blend3` and `spatial_gate` are
autograd Functions, as the JAX package's `blend3` (analytic backward,
`_blend3_bwd`) and `spatial_gate` (the VJP of `spatial_gate_reference`)
are `jax.custom_vjp`s. On the CPU the forward and every gradient are held
against `jax.vjp` of the JAX op, its Pallas forward run as the JAX tests run
it (`blend3_reference` in its place, or interpret mode), at 1e-4 of each
result's largest magnitude (fp32, matmul precision "highest"); the
float64 gradients against finite differences; the dispatch (the Function
only when a gradient is recorded) and the dtype promotion. The kernel side
runs on the card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.ops.pallas import blend as jblend
from adam_dehaze_tpu.ops.pallas import cbam as jcbam
from adam_dehaze_tpu_torch.ops.kernels import blend, cbam
from torch_port_util import ATOL


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _blend_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(shape[0], 3)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ys = [rng.random(shape, dtype=np.float32) for _ in range(3)]
    g = rng.normal(size=shape).astype(np.float32)
    return [w.astype(np.float32), *ys], g


@pytest.fixture
def jax_blend3_on_cpu(monkeypatch):
    """The JAX package's differentiable blend3 with its Pallas forward
    replaced by the plain version, as tests/test_pallas_vjp.py runs it."""
    monkeypatch.setattr(jblend, "blend3_pallas",
                        lambda w, a, b, c: jblend.blend3_reference(w, a, b, c))
    return jblend.blend3


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (3, 5, 7, 3), (1, 16, 4, 6)])
def test_blend3_function_matches_jax_vjp(shape, jax_blend3_on_cpu):
    args, g = _blend_inputs(shape, sum(shape))
    y_j, vjp = jax.vjp(jax_blend3_on_cpu, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = blend.blend3(*ts)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "_Blend3Backward"
    y.backward(torch.from_numpy(g))
    assert _scaled_err(y.detach(), y_j) <= ATOL
    for t, wg, name in zip(ts, want, ("dw", "dlow", "dmed", "dhigh")):
        assert t.grad.shape == wg.shape and t.grad.dtype == t.dtype
        assert _scaled_err(t.grad, wg) <= ATOL, name


def test_blend3_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    w = torch.rand(2, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    ys = [torch.rand(2, 4, 5, 3, generator=gen, dtype=torch.float64, requires_grad=True)
          for _ in range(3)]
    assert torch.autograd.gradcheck(blend.blend3, (w, *ys))


def test_blend3_only_the_inputs_that_need_it_get_a_gradient():
    """The soft joint step's case: the weights need no gradient (the
    classifier is frozen), the branch outputs do."""
    args, g = _blend_inputs((2, 6, 6, 3), 1)
    w = torch.from_numpy(args[0])
    ys = [torch.from_numpy(a).requires_grad_(True) for a in args[1:]]
    blend.blend3(w, *ys).backward(torch.from_numpy(g))
    assert w.grad is None
    for i, y in enumerate(ys):
        torch.testing.assert_close(y.grad, w[:, i, None, None, None] * torch.from_numpy(g),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_needs_grad"])
def test_blend3_without_a_gradient_skips_the_function(mode):
    args, _ = _blend_inputs((2, 4, 4, 3), 2)
    ts = [torch.from_numpy(a) for a in args]
    want = blend.blend3_reference(*ts)
    if mode == "no_grad":
        with torch.no_grad():
            got = blend.blend3(*(t.clone().requires_grad_(True) for t in ts))
    elif mode == "inference_mode":
        with torch.inference_mode():
            got = blend.blend3(*ts)
    else:
        got = blend.blend3(*ts)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_blend3_promotes_mixed_dtypes():
    """Branch outputs in different dtypes (as autocast may leave them) are
    promoted to one dtype; the gradients come back in each input's own
    dtype."""
    args, g = _blend_inputs((2, 4, 4, 3), 3)
    w = torch.from_numpy(args[0])
    low = torch.from_numpy(args[1]).to(torch.bfloat16).requires_grad_(True)
    med, high = (torch.from_numpy(a).requires_grad_(True) for a in args[2:])
    y = blend.blend3(w, low, med, high)
    assert y.dtype == torch.float32
    torch.testing.assert_close(
        y, blend.blend3_reference(w, low.detach().float(), med.detach(), high.detach()),
        rtol=0, atol=0)
    y.backward(torch.from_numpy(g))
    assert low.grad.dtype == torch.bfloat16 and med.grad.dtype == torch.float32


def test_blend3_on_the_cpu_launches_no_kernel():
    args, g = _blend_inputs((2, 4, 4, 3), 4)
    before = blend.blend3.launches
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    blend.blend3(*ts).backward(torch.from_numpy(g))
    assert blend.blend3.launches == before


# ------------------------------------------------------------------ K2' ---

def _gate_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(7, 7, 2, 1)) * 0.3).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("shape", [(2, 16, 12, 16), (1, 9, 23, 8), (3, 8, 8, 24)])
def test_spatial_gate_function_matches_jax_vjp(shape):
    x, w, dy = _gate_inputs(shape, sum(shape))
    y_j, vjp = jax.vjp(jcbam.spatial_gate_reference, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w)]
    y = cbam.spatial_gate(*ts)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy))
    assert _scaled_err(y.detach(), y_j) <= ATOL
    for t, wg, name in zip(ts, want, ("dx", "dw")):
        assert t.grad.shape == wg.shape
        assert _scaled_err(t.grad, wg) <= ATOL, name


def test_spatial_gate_matches_jax_custom_vjp_through_pallas_interpret(monkeypatch):
    """The JAX package's own differentiable op, its forward the Pallas
    kernel in interpret mode, gives the same forward and gradients."""
    original = jcbam.spatial_gate_pallas
    monkeypatch.setattr(jcbam, "spatial_gate_pallas",
                        lambda x, w: original(x, w, interpret=True))
    x, w, dy = _gate_inputs((1, 16, 16, 8), 3)
    y_j, vjp = jax.vjp(jcbam.spatial_gate, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w)]
    y = cbam.spatial_gate(*ts)
    y.backward(torch.from_numpy(dy))
    assert _scaled_err(y.detach(), y_j) <= ATOL
    for t, wg in zip(ts, want):
        assert _scaled_err(t.grad, wg) <= ATOL


def test_spatial_gate_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 6, 8, generator=gen, dtype=torch.float64, requires_grad=True)
    w = (torch.randn(7, 7, 2, 1, generator=gen, dtype=torch.float64) * 0.3).requires_grad_()
    assert torch.autograd.gradcheck(cbam.spatial_gate, (x, w))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_needs_grad"])
def test_spatial_gate_without_a_gradient_skips_the_function(mode):
    x, w, _ = _gate_inputs((2, 8, 8, 16), 6)
    ts = [torch.from_numpy(a) for a in (x, w)]
    want = cbam.spatial_gate(*(t.clone().requires_grad_(True) for t in ts))
    if mode == "no_grad":
        with torch.no_grad():
            got = cbam.spatial_gate(*(t.requires_grad_(True) for t in ts))
    elif mode == "inference_mode":
        with torch.inference_mode():
            got = cbam.spatial_gate(*ts)
    else:
        got = cbam.spatial_gate(*ts)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)


def test_spatial_gate_bf16_under_autocast_is_the_plain_version_in_bf16():
    x, w, dy = _gate_inputs((2, 8, 8, 16), 5)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, w)]
    ours = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    dyb = torch.from_numpy(dy).to(torch.bfloat16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = cbam.spatial_gate(*ours)
    y.backward(dyb)
    y_ref = cbam.spatial_gate_reference(*ref)
    y_ref.backward(dyb)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
