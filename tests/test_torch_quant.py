"""The port's int8 serving (ops/quant.py, ops/kernels/quant.py and
AdaptiveDehazer under `cuda.serving_quant: int8`) against the JAX package's
(ops/quant.py through AQT), on the CPU, where the wrappers of Q1 and Q2 take
their plain versions. JAX runs every int8 reference under jit, as its
serving does: XLA's jit turns AQT's division by 127.5 into a product with
float32(1 / 127.5), which the port reproduces (eager AQT differs in the last
bit of some float32 scales). Matmul precision "highest" (tests/conftest.py).

- Q1's plain version against AQT's activation quantizer, and the weights'
  per-channel quantizer against AQT's, fp32 and bf16: scales and int8
  values equal (0 values differ); an all-zero image;
- one ConvBlock of each shape the branches serve in int8 against the flax
  ConvBlock under quantize_apply, fp32, within 1e-5 of max|out|;
- the low, medium and high branches and the unet / corun alternates at
  small widths against the JAX int8 apply (`_assert_int8_close`, below), and the
  port's int8 against its own f32 (> 35 dB, tests/test_quant.py's bar);
- the per-image scale: an image's int8 route_hard output alone equals its
  output in a mixed, padded batch;
- route_hard of the int8 dehazer against the JAX dehazer's int8 route_hard,
  and every other hard route of the port against its route_hard;
- the soft call unquantized, autotune ignored, export_precompiled refused,
  a bundle of another quant refused, lowres over int8, another quant value
  served unquantized with a warning, the CLI's `serve` of an int8 config.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.nn.blocks import ConvBlock as JConvBlock
from adam_dehaze_tpu.ops.image import psnr
from adam_dehaze_tpu.ops.quant import quantize_apply as jax_quantize_apply
from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.nn.blocks import ConvBlock
from adam_dehaze_tpu_torch.ops.kernels.quant import (
    ConvGeometry,
    int8_conv,
    pack_int8_weights,
    quantize_images,
    unpack_int8_weights,
)
from adam_dehaze_tpu_torch.ops.quant import (
    Int8Conv2d,
    quantize_apply,
    quantize_per_image,
    quantize_weight_per_channel,
    quantized_inference,
)
from adam_dehaze_tpu_torch.ops.serving_apply import cast_for_serving
from torch_port_util import images, port_of, seeded_variables, serving_configs
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# A branch or a route is held against the JAX int8 apply by
# `_assert_int8_close`. Each int8 layer alone agrees to 2e-7 of its max|out|
# (float32 rounding of BN and of XLA's conv); most branches agree so end to
# end. But a difference of that size upstream can move a value across a
# rounding boundary of the next quantizer (about once in 1e5 values): its
# int8 level moves by 1, which moves that layer's outputs at one pixel by
# the input's scale (max|x| / 127.5) times a weight, 5.5e-3 at the corun
# branch's 1x1 fusion conv at these widths (max|x| 2.9, |w| up to 0.25),
# and the 3x3 layers after it spread that over a patch. So: every element
# within FLIP_TOL (two such flips), and at least MATCH_SHARE of them within
# 1e-5 (a flip is local; a quantized head, a missed ConvBlock or a scale
# shared across images moves nearly every element).
FLIP_TOL = 1e-2
MATCH_SHARE = 0.75


def _assert_int8_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert float(err.max()) <= FLIP_TOL, float(err.max())
    assert float((err <= 1e-5).mean()) >= MATCH_SHARE, float((err <= 1e-5).mean())


def _aqt_quantizers():
    from aqt.jax.v2 import aqt_conv_general as aqt_conv
    cfg = aqt_conv.conv_general_dilated_make(2, lhs_bits=8, rhs_bits=8)
    return cfg.dg_quantizer.lhs, cfg.dg_quantizer.rhs


def _aqt_quant(quantizer, x):
    qt, _ = jax.jit(lambda a: quantizer.quant(a, calibration_axes=None))(x)
    return (np.asarray(qt.qvalue).astype(np.int32),
            np.asarray(qt.scale[0].astype(jnp.float32)).reshape(-1))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_per_image_matches_aqt(dtype):
    """Q1's plain version against AQT's activation quantizer (one scale per
    image): equal scales, equal int8 values (0 of them differ). Images of
    very different ranges, and one all zero: scale 1/127.5, q = 0."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 12, 12, 16)) * rng.uniform(0.01, 50, (8, 1, 1, 1))
         ).astype(np.float32)
    x[3] = 0.0
    xt = torch.from_numpy(x).to(tdt)
    want_q, want_s = _aqt_quant(_aqt_quantizers()[0], jnp.asarray(x).astype(jdt))
    q, s = quantize_per_image(xt)
    assert q.dtype == torch.int8 and s.dtype == tdt and s.shape == (8,)
    assert int((q.numpy().astype(np.int32) != want_q).sum()) == 0
    np.testing.assert_array_equal(s.float().numpy(), want_s)
    assert float(s[3]) == float(torch.tensor(1 / 127.5, dtype=tdt))
    assert not q[3].any()
    # The wrapper's padded layout: the same values, zeros in the pad.
    qp, sp = quantize_images(xt, 32)
    assert qp.shape == (8, 12, 12, 32) and sp.dtype == torch.float32
    assert torch.equal(qp[..., :16], q) and not qp[..., 16:].any()
    np.testing.assert_array_equal(sp.numpy(), want_s)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_weight_quantize_matches_aqt(dtype):
    """The weights' quantizer against AQT's (one scale per output channel,
    from the weights as cast to the compute dtype), and the packing round
    trip."""
    jdt, tdt = DTYPES[dtype]
    w = (np.random.default_rng(1).standard_normal((3, 3, 20, 24)) * 0.1).astype(np.float32)
    want_q, want_s = _aqt_quant(_aqt_quantizers()[1], jnp.asarray(w).astype(jdt))
    q, s = quantize_weight_per_channel(torch.from_numpy(w).permute(3, 2, 0, 1).to(tdt))
    assert int((q.permute(2, 3, 1, 0).numpy().astype(np.int32) != want_q).sum()) == 0
    np.testing.assert_array_equal(s.float().numpy(), want_s)
    g = ConvGeometry.of(20, 24, 3, 3, 1, 1)
    assert (g.cin_pad, g.cout_pad, g.k_pad) == (32, 64, 288)
    packed = pack_int8_weights(q, g)
    assert packed.shape == (64, 288) and not packed[24:].any()
    assert torch.equal(unpack_int8_weights(packed, g)[:, :20], q)


# (cin, cout, kernel, stride, padding, use_bn): every kind of ConvBlock the
# branches serve in int8.
CONV_BLOCKS = {
    "3x3": (16, 24, 3, 1, 1, True),
    "7x7_rgb": (3, 16, 7, 1, 3, True),
    "4x4_s2": (16, 32, 4, 2, 1, True),
    "1x1": (56, 16, 1, 1, 0, True),
    "1x1_bias_no_bn": (32, 16, 1, 1, 0, False),
    "3x3_rgb": (3, 16, 3, 1, 1, True),
}


@pytest.mark.parametrize("name", sorted(CONV_BLOCKS))
def test_conv_block_matches_flax_int8(name):
    """An int8 ConvBlock of the port against the flax ConvBlock under the
    JAX package's quantize_apply, fp32, within 1e-5 of max|out|."""
    cin, cout, k, s, p, bn = CONV_BLOCKS[name]
    jm = JConvBlock(cout, k, stride=s, padding=p, use_bn=bn, activation=None)
    vs = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 16, 16, cin)), False), 3)
    x = np.random.default_rng(4).uniform(-1, 2, (3, 16, 16, cin)).astype(np.float32)
    x[1] *= 0.05                    # images of other ranges: their own scales
    want = np.asarray(jax.jit(jax_quantize_apply(lambda a: jm.apply(vs, a)))(jnp.asarray(x)))
    port = quantized_inference(cast_for_serving(
        port_of(ConvBlock(cin, cout, k, s, p, use_bn=bn, activation=False), vs), torch.float32))
    assert isinstance(port.block[0], Int8Conv2d)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_int8_conv_of_plain_version():
    """Q2's wrapper on the CPU is the plain version on the padded operands:
    the same as the conv of the unpadded ones, dequantised in AQT's order."""
    from adam_dehaze_tpu_torch.ops.quant import int8_conv_reference
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 9, 9, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 5, 3, 3)).astype(np.float32))
    g = ConvGeometry.of(5, 7, 3, 3, 2, 1)
    qx, sx = quantize_images(x, g.cin_pad)
    qw, sw = quantize_weight_per_channel(w)
    bias = torch.linspace(-1, 1, 7)
    got = int8_conv(qx, sx, pack_int8_weights(qw, g), sw, bias, g, torch.float32)
    want = int8_conv_reference(qx[..., :5], sx, qw, sw, 2, 1, bias, torch.float32)
    assert got.shape == (2, 5, 5, 7)
    assert torch.equal(got, want)
    acc = torch.nn.functional.conv2d(qx[..., :5].permute(0, 3, 1, 2).double(), qw.double(),
                                     stride=2, padding=1).permute(0, 2, 3, 1)
    assert torch.equal(got, (acc.float() * sx[:, None, None, None] * sw + bias))


# name -> (JAX class, port class, kwargs).
INT8_BRANCHES = {
    "low": (JB.LightweightDehazeModel, PB.LightweightDehazeModel,
            dict(base_channels=8, n_blocks=2)),
    "medium": (JB.MediumIntensityDehazeModel, PB.MediumIntensityDehazeModel,
               dict(base_channels=8, n_blocks=6)),
    "high": (JB.HighIntensityDehazeModel, PB.HighIntensityDehazeModel,
             dict(base_channels=16, n_blocks=9)),
    "low_unet": (JB.LowIntensityUNet, PB.LowIntensityUNet, dict(base_channels=8, n_blocks=3)),
    "corun": (JB.COrunInspiredModel, PB.COrunInspiredModel, dict(base_channels=8, n_blocks=2)),
}


@pytest.mark.parametrize("name", sorted(INT8_BRANCHES))
def test_branch_int8_matches_jax(name):
    """A branch's int8 serving apply against the JAX package's int8 apply
    (quantize_apply over m.apply, jitted), fp32, 32^2
    (`_assert_int8_close`); and > 35 dB against the port's own f32 output. The
    port's f32 parameters are left as they were."""
    jcls, pcls, kw = INT8_BRANCHES[name]
    jm = jcls(**kw)
    vs = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                          False), 6)
    x = images((2, 32, 32, 3), seed=7)
    want = np.asarray(jax.jit(jax_quantize_apply(lambda a: jm.apply(vs, a)))(jnp.asarray(x)))
    port = port_of(pcls(**kw), vs)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    apply = quantize_apply(port, torch.float32)
    assert sum(isinstance(m, Int8Conv2d) for m in apply.modules()) > 0
    with torch.inference_mode():
        got = apply(torch.from_numpy(x)).numpy()
        f32 = port(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    _assert_int8_close(got, want)
    assert float(np.asarray(psnr(jnp.asarray(got), jnp.asarray(f32))).min()) > 35.0
    assert np.abs(got - f32).max() > 0                       # really quantized
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.fixture(scope="module")
def pair():
    """(the port's dehazer, and the JAX and port int8 dehazers) on the same
    seeded weights: dehazer_pair's configs (fp32, low c=8, medium c=8, high c=16,
    32^2), the variables drawn by seeded_variables (flax's own init of the
    router runs op by op for most of a minute)."""
    from adam_dehaze_tpu.models import routing as JR
    from adam_dehaze_tpu.models.branches import create_branch_models
    from adam_dehaze_tpu.models.classifier import create_classifier
    from adam_dehaze_tpu.serving import AdaptiveDehazer as JDehazer
    from adam_dehaze_tpu_torch.models import routing as TR
    from adam_dehaze_tpu_torch.models.branches import create_branch_models as p_branches
    from adam_dehaze_tpu_torch.models.classifier import create_classifier as p_classifier
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
    jcfg, pcfg = serving_configs()
    jr = JR.create_router(create_branch_models(jcfg), create_classifier(jcfg), jcfg)
    vs = seeded_variables(lambda: jr.init({"params": jax.random.PRNGKey(0),
                                           "dropout": jax.random.PRNGKey(1)},
                                          jnp.zeros((1, 32, 32, 3))), 16)
    state = type("State", (), {"params": vs["params"], "batch_stats": vs["batch_stats"]})
    jq_cfg = dict(jcfg, tpu=dict(jcfg["tpu"], serving_quant="int8"))
    router = TR.create_router(p_branches(pcfg), p_classifier(pcfg), pcfg)
    pd = AdaptiveDehazer(router, vs, pcfg, device="cpu")
    return (pd, JDehazer(jr, state, jq_cfg),
            AdaptiveDehazer(router, None, _int8_config(pcfg), device="cpu"))


def _int8_config(config, quant="int8"):
    return dict(config, cuda=dict(config["cuda"], serving_quant=quant))


def test_route_hard_int8_matches_jax(pair):
    """route_hard of the int8 dehazers, with and without the spill plan,
    and their binned engines on forced labels cycling 0, 1, 2 (the seeded
    classifier picks low for every image), by `_assert_int8_close`."""
    _, jq, pq = pair
    x = images((6, 32, 32, 3), seed=8)
    for spill in (False, True):
        want, want_cls = jq.route_hard(x, spill=spill)
        got, cls = pq.route_hard(x, spill=spill)
        np.testing.assert_array_equal(cls, np.asarray(want_cls))
        _assert_int8_close(got, want)
    forced = np.arange(6) % 3
    want, _ = jq._binned_engine()(jnp.asarray(x), intensity=jnp.asarray(forced))
    got, _ = pq.engine(torch.from_numpy(x), intensity=forced)
    _assert_int8_close(got.numpy(), want)


def test_per_image_scale(pair):
    """An image's int8 output does not depend on its bucket mates or on the
    bucket's padding: served alone and in a batch of 5 (bucket 8) whose
    other images span a ten times wider range, through each branch."""
    _, _, pq = pair
    x = images((5, 32, 32, 3), seed=9)
    x[2] *= 0.1
    for label in range(3):
        batch, _ = pq.engine(torch.from_numpy(x), intensity=np.full(5, label))
        alone, _ = pq.engine(torch.from_numpy(x[2:3]), intensity=np.full(1, label))
        torch.testing.assert_close(batch[2:3], alone, rtol=0, atol=1e-6)


def test_every_hard_route_serves_int8(pair):
    """route_hard_stream, route_hard_queued, the device-binned routes,
    route_switch and route_sharded (two CPU replicas) serve the int8 copies:
    each image as route_hard serves it (per-image scales: the batching does
    not matter), and not as the unquantized dehazer does."""
    pd, _, pq = pair
    x = images((6, 32, 32, 3), seed=11)
    want, want_cls = pq.route_hard(x)
    assert np.abs(want - pd.route_hard(x)[0]).max() > 1e-4
    got = {
        "stream": np.concatenate([o for o, _ in pq.route_hard_stream([x[:4], x[4:]])]),
        "device_binned": pq.route_device_binned(x)[0],
        "device_binned_stream": np.concatenate(
            [o for o, _ in pq.route_device_binned_stream([x[:4], x[4:]])]),
        "switch": pq.route_switch(x)[0],
        "sharded": pq.route_sharded(x, devices=["cpu", "cpu"])[0],
    }
    queued = np.zeros_like(x)
    for out, gidx, _ in pq.route_hard_queued([x[:4], x[4:]], queue_bucket=2):
        queued[np.asarray(gidx)] = out.numpy()
    got["queued"] = queued
    for name, out in got.items():
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-6, err_msg=name)
    # A replica for another device (route_sharded's) carries int8 copies too.
    replica = pq._replica(torch.device("cpu"))
    with torch.inference_mode():
        for lvl, model in replica.models.items():
            assert any(isinstance(m, Int8Conv2d) for m in model.modules()), lvl
            torch.testing.assert_close(model(torch.from_numpy(x)),
                                       pq._hard.models[lvl](torch.from_numpy(x)),
                                       rtol=0, atol=0)


def test_soft_unquantized_autotune_ignored(pair):
    """The soft call of an int8 dehazer is the unquantized one, exactly; the
    classifier is the unquantized copy; autotune is skipped for the
    branches (no tables, no chunk costs); the hard routes are int8."""
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
    pd, _, pq = pair
    x = images((3, 32, 32, 3), seed=10)
    np.testing.assert_array_equal(pq(x), pd(x))
    assert pq._hard.classifier is pq._serving.classifier
    assert not any(isinstance(m, Int8Conv2d) for m in pq._serving.modules())
    tuned = AdaptiveDehazer(pd.router, None, _int8_config(pd.config), device="cpu",
                            autotune=True, autotune_cache=None)
    assert tuned.autotune_report == {} and tuned._chunk_costs() is None
    assert np.abs(pq.route_hard(x)[0] - pd.route_hard(x)[0]).max() > 0


def test_lowres_over_int8(pair):
    """The half-resolution dial wraps the int8 branch: route_hard with
    lowres equals make_lowres_apply over the int8 copy."""
    from adam_dehaze_tpu_torch.ops.resolution import make_lowres_apply
    _, _, pq = pair
    x = images((2, 32, 32, 3), seed=12)
    engine = pq._binned_engine(pq._norm_lowres(("low",)))
    got, _ = engine(torch.from_numpy(x), intensity=np.zeros(2, np.int64))
    with torch.inference_mode():
        want = make_lowres_apply(pq._hard.models["low"])(torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_export_refused_and_bundle_quant_checked(pair, tmp_path):
    """export_precompiled raises under int8; an int8 dehazer refuses a
    default bundle (quant None) with a warning and serves on eagerly."""
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
    pd, _, pq = pair
    with pytest.raises(ValueError, match="serving_quant"):
        pq.export_precompiled(str(tmp_path / "int8"))
    bundle = str(tmp_path / "default")
    pd.export_precompiled(bundle, batch_sizes=(2,), buckets=(2,), queue_buckets=(2,),
                          device_buckets=(2,), device_chunk=2)
    with pytest.warns(UserWarning, match="bundle quant=None != config quant='int8'"):
        d = AdaptiveDehazer(pd.router, None, _int8_config(pd.config), device="cpu",
                            precompiled=bundle)
    assert d._bundle_table is None
    x = images((2, 32, 32, 3), seed=13)
    np.testing.assert_array_equal(d.route_hard(x)[0], pq.route_hard(x)[0])


def test_other_quant_value_served_unquantized(pair):
    """A serving_quant other than int8 is served unquantized, as in the JAX
    package, with a warning naming it."""
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
    pd, _, _ = pair
    with pytest.warns(UserWarning, match="serving_quant='int4'"):
        d = AdaptiveDehazer(pd.router, None, _int8_config(pd.config, "int4"), device="cpu")
    assert d._hard is d._serving
    x = images((3, 32, 32, 3), seed=14)
    np.testing.assert_array_equal(d.route_hard(x)[0], pd.route_hard(x)[0])


def test_quantized_inference_bits():
    with pytest.raises(ValueError, match="Unsupported quantization bits: 4"):
        quantized_inference(ConvBlock(3, 8), bits=4)


def test_cli_serve_int8(pair, tmp_path):
    """`main_torch.py --mode serve` of an experiment whose config asks for
    int8 serves through the int8 copies (the same images as route_hard of
    an int8 dehazer on its weights)."""
    import json

    import yaml

    from adam_dehaze_tpu_torch import cli as PCLI
    from adam_dehaze_tpu_torch.config import update_checkpoint_paths
    from adam_dehaze_tpu_torch.data.dataset import _imread_rgb
    from adam_dehaze_tpu_torch.data.preprocessing import _write_rgb
    from adam_dehaze_tpu_torch.training.checkpoint import save_checkpoint
    _, _, pq = pair
    exp = str(tmp_path / "exp")
    cfg = update_checkpoint_paths(_int8_config(pq.config), exp)
    save_checkpoint(cfg["joint_training"]["checkpoint_dir"], "best_model",
                    {"step": 1, "model": pq.router.state_dict()})
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.dump({k: v for k, v in cfg.items() if not k.startswith("_")}, f)
    x = images((3, 32, 32, 3), seed=15)
    inputs = tmp_path / "inputs"
    for i in range(3):
        _write_rgb(str(inputs / f"img{i}.png"), x[i])
    out = str(tmp_path / "served")
    PCLI.main(["--mode", "serve", "--experiment_dir", exp, "--data_dir", str(inputs),
               "--out", out, "--serve_mode", "hard", "--device", "cpu"])
    with open(os.path.join(out, "routing.json")) as f:
        served = json.load(f)
    assert len(served["images"]) == 3
    read = np.stack([_imread_rgb(str(inputs / f"img{i}.png")) for i in range(3)])
    want, _ = pq.route_hard(read)
    for i, name in enumerate(sorted(served["images"])):
        # The CLI writes 8 bits, truncated, of the output clipped to [0, 1].
        u8 = (np.clip(want[i], 0, 1) * 255).astype(np.uint8)
        np.testing.assert_allclose(_imread_rgb(os.path.join(out, name)),
                                   u8.astype(np.float32) / 255, rtol=0, atol=1e-7)
