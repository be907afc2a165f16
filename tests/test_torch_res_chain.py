"""Kernel K6 (the residual/attention segment chain) of the PyTorch port, its
serving applies and the operation probes, on the CPU.

The port runs its plain versions; the JAX side runs as its own tests run it
(tests/test_res_chain.py): the Pallas kernel in interpret mode, fp32. The
same seeded numpy inputs go through both, with the flax variables carried
into the port's blocks by `load_flax_variables` and the BN statistics
perturbed so that the fold is exercised. Tolerances: fp32 against fp32 at
ATOL 1e-4 (reordered sums); the bf16 case is stated where it stands. The
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.nn import blocks as JN
from adam_dehaze_tpu.ops import s2d as JS
from adam_dehaze_tpu.ops.pallas.res_chain import make_res_attn_chain
from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.nn import blocks as PN
from adam_dehaze_tpu_torch.ops.kernels.res_chain import (
    ATTN_GATE_LAUNCHES,
    ATTN_LAUNCHES,
    RES_LAUNCHES,
    fold_res_attn_chain,
    launches_of,
    res_attn_chain,
    res_attn_chain_reference,
    res_chain_supported,
    segment_blocks,
)
from adam_dehaze_tpu_torch.ops.serving_apply import (
    BranchChainApply,
    chain_apply_supported,
    make_high_chain_apply,
    make_medium_chain_apply,
)
from adam_dehaze_tpu_torch.tools import probe_ops
from torch_port_util import ATOL, images, init_flax, port_of


def _segment(kinds, c, h=16, w=16, n=2, seed=0):
    """A [kind, ...] stack initialised in flax and carried into the port:
    (x uniform in [0, 1), the kernel's post-ReLU contract; the JAX layer
    specs; the port's blocks)."""
    x = images((n, h, w, c), seed=seed)
    specs, blocks = [], []
    for i, kind in enumerate(kinds):
        jmod, pmod = ((JN.ResidualBlock(c, dtype=jnp.float32), PN.ResidualBlock(c))
                      if kind == "res" else
                      (JN.AttentionBlock(c, dtype=jnp.float32), PN.AttentionBlock(c)))
        vs = init_flax(jmod, x[:1], seed=seed + 10 * i)
        specs.append((kind, vs["params"], vs.get("batch_stats")))
        blocks.append(port_of(pmod, vs))
    return x, specs, blocks


CASES = {
    "res": (("res",), 128, 16, 16, 2),
    "res_res": (("res", "res"), 128, 16, 16, 2),
    "res_attn": (("res", "attn"), 128, 16, 16, 2),
    "res_res_attn_res_attn": (("res", "res", "attn", "res", "attn"), 128, 16, 16, 2),
    "non_square_24x40": (("res", "attn"), 128, 24, 40, 1),
    "c256_8x8": (("res", "attn"), 256, 8, 8, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_chain_matches_jax_kernel(case):
    kinds, c, h, w, n = CASES[case]
    x, specs, blocks = _segment(kinds, c, h, w, n, seed=len(case))
    want = np.asarray(make_res_attn_chain(specs, c=c, dtype=jnp.float32,
                                          interpret=True)(jnp.asarray(x)))
    weights = fold_res_attn_chain(blocks, torch.float32)
    assert weights.kinds == kinds and weights.channels == c
    before = res_attn_chain.launches
    got = res_attn_chain(torch.from_numpy(x), weights)
    assert res_attn_chain.launches == before          # a CPU tensor launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    torch.testing.assert_close(got, res_attn_chain_reference(torch.from_numpy(x), weights),
                               rtol=0, atol=0)


def test_plain_chain_matches_the_canonical_blocks():
    """The segment is the port's own blocks in sequence (whose stencil is
    rounded to the compute dtype: the same thing in fp32)."""
    x, _, blocks = _segment(("res", "attn", "res"), 32, 12, 20, 2, seed=4)
    got = res_attn_chain(torch.from_numpy(x), fold_res_attn_chain(blocks, torch.float32))
    with torch.no_grad():
        want = torch.nn.Sequential(*blocks)(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0, atol=ATOL)


def test_bf16_plain_chain_matches_jax_kernel_in_bf16():
    """Both round at the same points (conv outputs, the attention block's
    end) and sum in f32, in another order: they differ where a sum lands on
    either side of a bf16 rounding boundary, one step of 2^-8 of the value,
    which the next layers carry on. Four such steps of the largest
    activation bound it; a wrong rounding point (the activation rounded
    before the spatial gate, the stencil rounded) would still pass, and is
    what the fp32 cases and the card's checks pin."""
    kinds, c = ("res", "attn"), 128
    x, specs, blocks = _segment(kinds, c, seed=7)
    want = np.asarray(make_res_attn_chain(specs, c=c, dtype=jnp.bfloat16, interpret=True)(
        jnp.asarray(x)).astype(jnp.float32))
    weights = fold_res_attn_chain(blocks, torch.bfloat16)
    assert weights.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for _, t in weights.convs)
    assert all(t.dtype == torch.float32 for a in weights.attns for t in a)
    got = res_attn_chain(torch.from_numpy(x), weights)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert 0 < err <= 4 * 2.0 ** -8 * np.abs(want).max()
    # ... and stays within the bf16 bound of the fp32 chain, in units of it.
    f32 = res_attn_chain(torch.from_numpy(x), fold_res_attn_chain(blocks, torch.float32))
    assert float((got.float() - f32).abs().max()) <= 3e-2 * max(1.0, float(f32.abs().max()))


@pytest.mark.parametrize("kinds", [("attn", "res"), ("attn",)],
                         ids=["starts_with_attn", "no_res"])
def test_both_packages_refuse_the_same_segments(kinds):
    _, specs, blocks = _segment(kinds, 32, 8, 8, 1)
    with pytest.raises(ValueError):
        make_res_attn_chain(specs, c=32, dtype=jnp.float32, interpret=True)
    with pytest.raises(ValueError):
        fold_res_attn_chain(blocks, torch.float32)


def test_fold_refuses_other_layers_and_mixed_widths():
    with pytest.raises(ValueError, match="unknown layer kind"):
        fold_res_attn_chain([PN.ResidualBlock(16), PN.ConvBlock(16, 16)], torch.float32)
    with pytest.raises(ValueError, match="one width"):
        fold_res_attn_chain([PN.ResidualBlock(16), PN.AttentionBlock(32)], torch.float32)
    with pytest.raises(ValueError):
        fold_res_attn_chain([], torch.float32)


@pytest.mark.parametrize("c,h,w,dtype,ok", [
    (384, 64, 64, torch.bfloat16, True), (192, 128, 128, torch.float32, True),
    (16, 1, 1, torch.float32, True), (8, 16, 16, torch.float32, False),
    (24, 16, 16, torch.bfloat16, False), (128, 16, 16, torch.float16, False),
    (128, 16, 4096, torch.bfloat16, False)])
def test_res_chain_shape_selector(c, h, w, dtype, ok):
    assert res_chain_supported(c, h, w, dtype) is ok


def test_launch_constants():
    assert (RES_LAUNCHES, ATTN_LAUNCHES, ATTN_GATE_LAUNCHES) == (2, 3, 1)
    assert launches_of(("res", "res", "attn", "res", "attn", "res", "attn")) == (17, 3)
    assert launches_of(("res",) * 4) == (8, 0)


# ---- the branches' segments ---------------------------------------------------

def test_segment_blocks_pick_the_branch_modules():
    high, medium = PB.HighIntensityDehazeModel(8), PB.MediumIntensityDehazeModel(8)
    want = {
        (high, "e1"): [high.encoder[0][i] for i in (1, 2, 3)],
        (high, "e2b"): [high.encoder[1][i] for i in (1, 2, 3)] + list(high.bottleneck),
        (high, "d1"): [high.decoder[0][3], high.decoder[0][4]],
        (medium, "e1"): [medium.encoder[0][1], medium.encoder[0][2]],
        (medium, "e2b"): [medium.encoder[1][1], medium.encoder[1][2],
                          medium.bottleneck[0], medium.bottleneck[1]],
        (medium, "d1"): [medium.decoder[0][3]],
    }
    for (model, seg), blocks in want.items():
        got = segment_blocks(model, seg)
        assert len(got) == len(blocks) and all(a is b for a, b in zip(got, blocks))
    kinds = [type(b).__name__[:3] for b in segment_blocks(high, "e2b")]
    assert kinds == ["Res", "Res", "Att", "Res", "Att", "Res", "Att"]
    with pytest.raises(ValueError, match="unknown segment"):
        segment_blocks(high, "e2")


# ---- the serving applies ------------------------------------------------------

@pytest.fixture(scope="module")
def high8():
    """(JAX model, flax variables, the port's model, x) at base width 8."""
    x = images((1, 16, 16, 3), seed=3)
    jmodel = JB.HighIntensityDehazeModel(base_channels=8, use_pallas=False,
                                         dtype=jnp.float32)
    vs = init_flax(jmodel, x, seed=4)
    return jmodel, vs, port_of(PB.HighIntensityDehazeModel(8), vs), x


@pytest.mark.parametrize("res_chain", [True, ("e2b",)], ids=["all", "e2b"])
def test_high_chain_apply_matches_jax_and_canonical(high8, res_chain):
    jmodel, vs, port, x = high8
    want = np.asarray(JS.make_high_s2d_apply(jmodel, vs, dtype=jnp.float32,
                                             res_chain=res_chain, interpret=True)(
        jnp.asarray(x)))
    apply = make_high_chain_apply(port, torch.float32, res_chain=res_chain)
    assert isinstance(apply, BranchChainApply)
    assert apply.segments == (("e1", "e2b", "d1") if res_chain is True else ("e2b",))
    with torch.inference_mode():
        got = apply(torch.from_numpy(x))
        canonical = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), canonical.numpy(), atol=ATOL)


def test_medium_chain_apply_matches_jax_and_canonical():
    x = images((1, 16, 16, 3), seed=5)
    jmodel = JB.MediumIntensityDehazeModel(base_channels=8, dtype=jnp.float32)
    vs = init_flax(jmodel, x, seed=6)
    port = port_of(PB.MediumIntensityDehazeModel(8), vs)
    want = np.asarray(JS.make_medium_chain_apply(jmodel, vs, dtype=jnp.float32,
                                                 interpret=True)(jnp.asarray(x)))
    apply = make_medium_chain_apply(port, torch.float32)
    assert apply.segments == ("e1", "e2b", "d1") and apply.tail is None
    with torch.inference_mode():
        got = apply(torch.from_numpy(x))
        canonical = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), canonical.numpy(), atol=ATOL)


def test_res_e2b_tail_chain_apply_matches_jax_and_canonical():
    """The e2b segment on K6 and the tail on K4, at a width the tail takes
    (16). The JAX tail kernel does not take that width, so the JAX side is
    the canonical forward."""
    x = images((2, 24, 40, 3), seed=8)
    jmodel = JB.HighIntensityDehazeModel(base_channels=16, use_pallas=False,
                                         dtype=jnp.float32)
    vs = init_flax(jmodel, x[:1], seed=9)
    port = port_of(PB.HighIntensityDehazeModel(16), vs)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(x), train=False))
    apply = make_high_chain_apply(port, torch.float32, tail_chain=True)
    assert apply.segments == ("e2b",) and apply.tail is not None
    with torch.inference_mode():
        got = apply(torch.from_numpy(x))
        canonical = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), canonical.numpy(), atol=ATOL)


def test_chain_apply_refusals(high8):
    _, _, port, _ = high8
    with pytest.raises(ValueError, match="unknown segments"):
        make_high_chain_apply(port, torch.float32, res_chain=("e2",))
    with pytest.raises(TypeError):
        make_medium_chain_apply(port, torch.float32)
    apply = make_high_chain_apply(port, torch.float32)
    with pytest.raises(ValueError, match="chain_apply_supported"):
        apply(torch.rand(1, 30, 32, 3))          # the canonical forward resizes
    none = make_high_chain_apply(port, torch.float32, res_chain=None)
    assert none.segments == () and none.tail is None


@pytest.mark.parametrize("c,h,w,dtype,segments,tail,ok", [
    (96, 256, 256, torch.bfloat16, ("e2b",), True, True),
    (64, 256, 256, torch.bfloat16, ("e1", "e2b", "d1"), False, True),
    (8, 16, 16, torch.float32, ("e1",), False, True),      # 2c = 16
    (8, 16, 16, torch.float32, ("e1",), True, False),      # the tail wants c >= 16
    (4, 16, 16, torch.float32, ("e1",), False, False),     # 2c = 8
    (4, 16, 16, torch.float32, ("e2b",), False, True),     # 4c = 16
    (64, 30, 32, torch.bfloat16, (), False, False),
    (64, 32, 32, torch.float16, ("d1",), False, False)])
def test_chain_apply_shape_selector(c, h, w, dtype, segments, tail, ok):
    assert chain_apply_supported(c, h, w, dtype, segments, tail) is ok


# ---- the probes -----------------------------------------------------------------

def _numpy_probes(x, w, wrep):
    """The ten patterns of tools/probe_mosaic_ops.py as numpy expressions."""
    z = x.astype(np.float32)
    s, m = z.sum(0, keepdims=True), z.max(0, keepdims=True)
    c = probe_ops.C
    m96 = np.maximum(np.maximum(m[:, :c], m[:, c:2 * c]),
                     np.maximum(m[:, 2 * c:3 * c], m[:, 3 * c:]))
    lane = np.arange(probe_ops.C4)[None, :]
    g = sum(np.where(lane // c == p, z[:8, p:p + 1], 0.0) for p in range(4))
    rows = lambda v: np.broadcast_to(v, (8, v.shape[1]))   # noqa: E731
    return {
        "A_row_reduce_384": rows(s + m),
        "B_dot_1row_K384": rows(s @ w),
        "B8_dot_8row_K384": np.broadcast_to(s, (8, s.shape[1])) @ w,
        "C_lane_slice_96": rows(np.pad(m96, ((0, 0), (0, 32)))),
        "D_lane_concat_96x4": rows(np.concatenate([m[:, :c]] * 4, axis=1)),
        "E_dot_1row_N384": rows(m[:, :128] @ wrep),
        "F_bcast_mul_384": (z * s)[:8],
        "G_lane1_slice_select": g,
        "H_iota_selection_matmul": rows(np.pad(np.maximum(m96, 0.0), ((0, 0), (0, 32)))),
        "I_scratch_partial_lanes": rows(s[:, :128]),
    }


@pytest.mark.parametrize("name", sorted(probe_ops.PROBES))
def test_probe_plain_versions_match_numpy(name):
    rng = np.random.default_rng(2)
    x32 = rng.standard_normal((probe_ops.FLAT, probe_ops.C4)).astype(np.float32)
    x = torch.from_numpy(x32).bfloat16()
    w = rng.standard_normal((probe_ops.C4, 128)).astype(np.float32)
    wrep = rng.standard_normal((128, probe_ops.C4)).astype(np.float32)
    want = _numpy_probes(x.float().numpy(), w, wrep)[name]
    before = probe_ops.probe_op.launches
    got = probe_ops.probe_op(name, x, torch.from_numpy(w), torch.from_numpy(wrep))
    assert probe_ops.probe_op.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=probe_ops.PROBE_RTOL * max(1.0, np.abs(want).max()))


def test_run_probes_reports_pass_and_fail(monkeypatch):
    lines = []
    assert probe_ops.run_probes("cpu", log=lines.append) == []
    assert len(lines) == len(probe_ops.PROBES) == 10
    assert all(line.startswith("PASS ") for line in lines)
    # A pattern whose kernel disagrees, and one that raises, are named.
    real = probe_ops.probe_op

    def broken(name, x, w, wrep):
        if name.startswith("C_"):
            raise RuntimeError("launch failed")
        out = real(name, x, w, wrep)
        return out + 1.0 if name.startswith("F_") else out

    monkeypatch.setattr(probe_ops, "probe_op", broken)
    lines.clear()
    assert probe_ops.run_probes("cpu", log=lines.append) == ["C_lane_slice_96",
                                                             "F_bcast_mul_384"]
    assert sum(line.startswith("FAIL ") for line in lines) == 2
    with pytest.raises(ValueError, match="unknown probe"):
        real("Z", None, None, None)
