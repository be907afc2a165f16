"""Kernels K1 (low-branch chain), K2 (CBAM gate) and K5 (three-way blend)
of the PyTorch port.

Each plain version against the JAX Pallas kernel run in interpret mode on
the same numpy inputs, at fp32 (ATOL 1e-4, fp32 vs fp32), and the CPU
dispatch of the wrappers. The kernels themselves are held against these
plain versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu_torch.ops.kernels.blend import blend3, blend3_reference
from adam_dehaze_tpu_torch.ops.kernels.cbam import (
    channel_spatial_gate,
    channel_spatial_gate_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    chain_supported,
    fold_lightweight,
    group_smem_bytes,
    layer_smem_bytes,
    lightweight_chain,
    lightweight_chain_reference,
)
from torch_port_util import ATOL, images, init_flax, port_of


def _low_pair(c=32, n_blocks=3, seed=0):
    from adam_dehaze_tpu.models.branches import LightweightDehazeModel as JLow
    from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel

    vs = init_flax(JLow(base_channels=c, n_blocks=n_blocks, dtype=jnp.float32),
                   images((1, 16, 16, 3)), seed=seed)
    return vs, port_of(LightweightDehazeModel(c, n_blocks), vs)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 48, 80, 3)],
                         ids=["32x32", "48x80"])
def test_k1_plain_matches_pallas_chain(shape):
    """K1's plain version == the TPU chain kernel (interpret mode), including
    the non-square size whose strips and strides the TPU kernel pads."""
    from adam_dehaze_tpu.ops.pallas.s2d_chain import make_lightweight_chain_apply

    vs, port = _low_pair()
    x = images(shape, seed=1)
    want = np.asarray(make_lightweight_chain_apply(
        vs, dtype=jnp.float32, interpret=True)(jnp.asarray(x)))
    chain = fold_lightweight(port, torch.float32)
    got = lightweight_chain(torch.from_numpy(x), chain).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 16, 128, 32), (1, 10, 8, 16)],
                         ids=["16x128c32", "10x8c16"])
def test_k2_plain_matches_pallas_cgate(shape):
    from adam_dehaze_tpu.ops.pallas.cbam import channel_spatial_gate_pallas

    rng = np.random.default_rng(3)
    x = rng.random(shape, dtype=np.float32)
    g = (1.0 / (1.0 + np.exp(-rng.standard_normal((shape[0], shape[3]))))).astype(np.float32)
    w = (rng.standard_normal((7, 7, 2, 1)) * 0.1).astype(np.float32)
    want = np.asarray(channel_spatial_gate_pallas(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(w), interpret=True))
    got = channel_spatial_gate(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_k5_plain_matches_pallas_blend():
    from adam_dehaze_tpu.ops.pallas.blend import blend3_pallas

    rng = np.random.default_rng(4)
    ys = [rng.random((3, 8, 8, 3), dtype=np.float32) for _ in range(3)]
    logits = rng.standard_normal((3, 3)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    want = np.asarray(blend3_pallas(jnp.asarray(w), *map(jnp.asarray, ys),
                                    interpret=True))
    got = blend3(torch.from_numpy(w), *map(torch.from_numpy, ys)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_cpu_tensors_take_plain_versions_without_launching():
    """A CPU tensor never reaches a kernel: the counters stay put and the
    result is the plain version's, exactly."""
    _, port = _low_pair(c=8, n_blocks=1)
    chain = fold_lightweight(port, torch.float32)
    x = torch.from_numpy(images((1, 8, 8, 3)))
    before = (lightweight_chain.launches, channel_spatial_gate.launches,
              blend3.launches)
    torch.testing.assert_close(lightweight_chain(x, chain),
                               lightweight_chain_reference(x, chain), rtol=0, atol=0)
    xa, g, w = torch.rand(1, 4, 4, 8), torch.rand(1, 8), torch.rand(7, 7, 2, 1)
    torch.testing.assert_close(channel_spatial_gate(xa, g, w),
                               channel_spatial_gate_reference(xa, g, w),
                               rtol=0, atol=0)
    wb = torch.softmax(torch.rand(1, 3), dim=1)
    torch.testing.assert_close(blend3(wb, x, x, x), blend3_reference(wb, x, x, x),
                               rtol=0, atol=0)
    assert (lightweight_chain.launches, channel_spatial_gate.launches,
            blend3.launches) == before


@pytest.mark.parametrize("c,n_blocks,ok", [
    (32, 3, True), (8, 1, True), (64, 2, True), (12, 3, False), (32, 0, False),
    (256, 3, False)])
def test_k1_shape_selector(c, n_blocks, ok):
    """The selector decides by width, depth and dtype up front: widths that
    are multiples of 8 whose every launch fits in shared memory (bf16 at
    c = 64 takes the fused groups, fp32 the per-layer FMA body; at 256 the
    FMA body's tile and weights are beyond a block in both dtypes), at least
    one residual block."""
    for dtype in (torch.float32, torch.bfloat16):
        assert chain_supported(c, n_blocks, dtype) is ok, dtype


@pytest.mark.parametrize("what,args,want", [
    # The per-layer FMA body: f32 tile 180 x (cin + 1) + f32 weights of 32
    # output channels, whatever the dtype in device memory.
    ("layer", (3,), 6336),
    ("layer", (32,), 60624),
    ("layer", (120,), 225360),
    ("layer", (128,), -1),       # beyond 227 KB
    # The fused wgmma body (bf16): a residual group at c = 32, tile 32 (bf16
    # buffers of 36 and 34 rows at pitch 36, two packed layers), and the
    # widest tile of c = 64 (tests/test_torch_low_chain.py counts them by hand).
    ("group", (32, "res", 32), 207872),
    ("group", (64, "first", 8), 207408),
])
def test_k1_layer_shared_memory(what, args, want):
    """Hand-counted bytes of each body's shared memory (the CUDA tests hold
    the same functions against the kernel library's own count)."""
    fn = layer_smem_bytes if what == "layer" else group_smem_bytes
    assert fn(*args) == want


def test_k1_fold_rounds_weights_to_compute_dtype():
    _, port = _low_pair(c=8, n_blocks=1)
    chain = fold_lightweight(port, torch.bfloat16)
    assert chain.dtype == torch.bfloat16 and chain.channels == 8
    assert len(chain.layers) == 2 * 1 + 3
    assert all(t.dtype == torch.float32 for _, t in chain.layers)
    assert chain.alpha == float(torch.tensor(0.1).to(torch.bfloat16).float())
