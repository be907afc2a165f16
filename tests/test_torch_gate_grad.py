"""K2's gradient: the port's `channel_spatial_gate` is an autograd Function
whose backward is the VJP of the plain version, as the JAX package's
custom_vjp differentiates `channel_spatial_gate_reference` with jax.vjp.
On the CPU its (dx, dg, dw) are held against jax.vjp at 1e-4 of each
gradient's largest magnitude (fp32, matmul precision "highest"), its
float64 gradient against finite differences, and the AttentionBlock's
parameter gradients against flax's. The kernel side runs on the card
(tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.nn import blocks as J
from adam_dehaze_tpu.ops.pallas import cbam as jcbam
from adam_dehaze_tpu_torch.nn import blocks as P
from adam_dehaze_tpu_torch.ops.kernels import cbam
from torch_port_util import ATOL, images, init_flax, nchw, port_of


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.random((shape[0], shape[3]), dtype=np.float32)
    w = (rng.normal(size=(7, 7, 2, 1)) * 0.3).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, g, w, dy


@pytest.mark.parametrize("shape", [(2, 16, 12, 16), (1, 9, 23, 8), (3, 8, 8, 24)])
def test_function_vjp_matches_jax(shape):
    x, g, w, dy = _inputs(shape, sum(shape))
    y_j, vjp = jax.vjp(jcbam.channel_spatial_gate_reference,
                       jnp.asarray(x), jnp.asarray(g), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, w)]
    y = cbam.channel_spatial_gate(*ts)
    y.backward(torch.from_numpy(dy))
    assert _scaled_err(y.detach(), y_j) <= ATOL
    for t, wg, name in zip(ts, want, ("dx", "dg", "dw")):
        assert t.grad.shape == wg.shape
        assert _scaled_err(t.grad, wg) <= ATOL, name


def test_function_matches_jax_custom_vjp_through_pallas_interpret(monkeypatch):
    """The JAX package's own differentiable op, its forward the Pallas
    kernel in interpret mode, gives the same gradients."""
    original = jcbam.channel_spatial_gate_pallas
    monkeypatch.setattr(jcbam, "channel_spatial_gate_pallas",
                        lambda x, g, w: original(x, g, w, interpret=True))
    x, g, w, dy = _inputs((1, 16, 16, 8), 3)

    def f(x, g, w):
        return jnp.sum(jcbam.channel_spatial_gate(x, g, w) * dy)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(w))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, w)]
    (cbam.channel_spatial_gate(*ts) * torch.from_numpy(dy)).sum().backward()
    for t, wg in zip(ts, want):
        assert _scaled_err(t.grad, wg) <= ATOL


def test_function_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 6, 8, generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.rand(1, 8, generator=gen, dtype=torch.float64, requires_grad=True)
    w = (torch.randn(7, 7, 2, 1, generator=gen, dtype=torch.float64) * 0.3).requires_grad_()
    assert torch.autograd.gradcheck(cbam.channel_spatial_gate, (x, g, w))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_needs_grad"])
def test_forward_without_a_gradient_skips_the_function(mode):
    """With no gradient to record the forward runs without the Function,
    and gives what the Function's forward gives."""
    x, g, w, _ = _inputs((2, 8, 8, 16), 6)
    ts = [torch.from_numpy(a) for a in (x, g, w)]
    want = cbam.channel_spatial_gate(*(t.clone().requires_grad_(True) for t in ts))
    assert want.grad_fn is not None
    if mode == "no_grad":
        with torch.no_grad():
            got = cbam.channel_spatial_gate(*(t.requires_grad_(True) for t in ts))
    elif mode == "inference_mode":
        with torch.inference_mode():
            got = cbam.channel_spatial_gate(*ts)
    else:
        got = cbam.channel_spatial_gate(*ts)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)


def test_only_the_inputs_that_need_it_get_a_gradient():
    x, g, w, dy = _inputs((1, 8, 8, 8), 4)
    xt = torch.from_numpy(x).requires_grad_(True)
    gt, wt = torch.from_numpy(g), torch.from_numpy(w)
    cbam.channel_spatial_gate(xt, gt, wt).backward(torch.from_numpy(dy))
    assert xt.grad is not None and gt.grad is None and wt.grad is None
    ref = torch.from_numpy(x).requires_grad_(True)
    cbam.channel_spatial_gate_reference(ref, gt, wt).backward(torch.from_numpy(dy))
    torch.testing.assert_close(xt.grad, ref.grad, rtol=0, atol=0)


def test_bf16_under_autocast_is_the_plain_version_in_bf16():
    """Under autocast the Function computes in the dtypes it was given, as
    the plain version does outside autocast: bf16 x and g, w rounded to
    bf16; the gradients come back in those dtypes and equal plain autograd."""
    x, g, w, dy = _inputs((2, 8, 8, 16), 5)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, g, w)]
    ours = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    dyb = torch.from_numpy(dy).to(torch.bfloat16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = cbam.channel_spatial_gate(*ours)
    y.backward(dyb)
    y_ref = cbam.channel_spatial_gate_reference(*ref)
    y_ref.backward(dyb)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    for a, b in zip(ours, ref):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_cpu_function_launches_no_kernel():
    x, g, w, _ = _inputs((1, 8, 8, 8), 6)
    before = cbam.channel_spatial_gate.launches
    with torch.inference_mode():
        y = cbam.channel_spatial_gate(*(torch.from_numpy(a) for a in (x, g, w)))
    torch.testing.assert_close(y, cbam.channel_spatial_gate_reference(
        *(torch.from_numpy(a) for a in (x, g, w))), rtol=0, atol=0)
    assert cbam.channel_spatial_gate.launches == before


@pytest.mark.parametrize("c", [16, 32])
def test_attention_block_gradients_match_flax(c):
    """The AttentionBlock in training: input and parameter gradients of
    sum(out * dy) through the Function equal flax's (use_pallas off: the
    same reference math)."""
    x = images((2, 12, 12, c), seed=c)
    dy = np.random.default_rng(c + 1).normal(size=x.shape).astype(np.float32)
    jblock = J.AttentionBlock(c)
    vs = init_flax(jblock, x)

    def f(params, x):
        return jnp.sum(jblock.apply({"params": params}, x, True) * dy)

    jg_params, jg_x = jax.grad(f, argnums=(0, 1))(vs["params"], jnp.asarray(x))
    block = port_of(P.AttentionBlock(c), vs).train()
    xt = nchw(x).requires_grad_(True)
    out = block(xt)
    (out * nchw(dy)).sum().backward()
    assert _scaled_err(xt.grad.permute(0, 2, 3, 1), jg_x) <= ATOL
    want = port_of(P.AttentionBlock(c), {"params": jax.tree_util.tree_map(np.asarray,
                                                                          jg_params)})
    for (name, p), q in zip(block.named_parameters(), want.parameters()):
        assert _scaled_err(p.grad, q.detach()) <= ATOL, name
