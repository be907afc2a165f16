"""The port's alternate branches (LowIntensityUNet, COrunInspiredModel,
DualBranchAttentionModel, EncoderDecoder) against the JAX package's, on the
CPU, fp32, small widths (c = 8-16, 32^2 and 30^2, batch 2):

- eval mode on seeded flax variables carried over by load_flax_variables
  (1e-4); 30^2 makes the pools floor, the align-corners upsamples and the
  EncoderDecoder's resize take sizes that no scale factor gives;
- train mode against the JAX module in float64 (flax's float32 train-mode
  BN takes E[x^2] - E[x]^2), output at 1e-4 and the BN statistics by
  assert_bn_stats_match_flax;
- full-width parameter counts (tests/test_branches.py's golden values; the
  EncoderDecoder, which has none, against the JAX module's shapes);
- the reference layout: a seeded port branch's state_dict through the JAX
  package's load_torch_branch gives the JAX module the port's forward;
- the factories' model_type mapping, fall-through included;
- `cuda.remat: fullres` equal to no remat (1e-6), each full-resolution
  block recomputed;
- a soft router over low_unet / corun / dual_branch with a
  mobilenet_v3_small classifier against the JAX router.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.config import default_config
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.training.checkpoint import load_torch_branch
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from test_branches import REF_PARAM_COUNTS
from torch_port_util import (
    ATOL,
    as64,
    assert_bn_stats_match_flax,
    images,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    port_of,
    seeded_variables,
    zeros_like_variables,
)

# The port's ops run on one thread in this module (see one_torch_thread).
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# name -> (JAX class, port class, kwargs of both, the converter's kind or None).
BRANCHES = {
    "low_unet": (JB.LowIntensityUNet, PB.LowIntensityUNet,
                 dict(base_channels=8, n_blocks=3), "low_unet"),
    "corun": (JB.COrunInspiredModel, PB.COrunInspiredModel,
              dict(base_channels=8, n_blocks=2), "corun"),
    "dual_branch": (JB.DualBranchAttentionModel, PB.DualBranchAttentionModel,
                    dict(base_channels=16, n_blocks=9), "dual_branch"),
    "encoder_decoder": (JB.EncoderDecoder, PB.EncoderDecoder,
                        dict(base_channels=8, n_blocks=3, use_attention=False), None),
    "encoder_decoder_attention": (JB.EncoderDecoder, PB.EncoderDecoder,
                                  dict(base_channels=8, n_blocks=6, use_attention=True), None),
}


def _jax_module(name, dtype=jnp.float32):
    jcls, _, kw, _ = BRANCHES[name]
    return jcls(**kw, dtype=dtype)


def _init(jm):
    return lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), False)


def _pair(name, seed=0):
    """The JAX module, seeded variables, and the port module filled from
    them (eval mode)."""
    _, pcls, kw, _ = BRANCHES[name]
    jm = _jax_module(name)
    vs = seeded_variables(_init(jm), seed)
    return jm, vs, port_of(pcls(**kw), vs)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 30, 30, 3)], ids=["32x32", "30x30"])
@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_branch_matches_flax(name, shape):
    jm, vs, port = _pair(name)
    x = images(shape, seed=2)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(vs, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_branch_train_mode_matches_flax(name):
    """One train-mode forward: the output, and the BN running statistics
    after it, against the JAX module in float64."""
    jm, vs, port = _pair(name, seed=1)
    x = images((2, 32, 32, 3), seed=3)
    with jax.enable_x64(True):
        j64 = _jax_module(name, jnp.float64)
        y, mut = jax.jit(lambda v, x: j64.apply(v, x, True, mutable=["batch_stats"]))(
            as64(vs), jnp.asarray(x, jnp.float64))
        want = np.asarray(y)
        stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       dict(mut)["batch_stats"])
    trained = copy.deepcopy(port).train()
    with torch.no_grad():
        got = trained(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    after = port_of(copy.deepcopy(port), {"params": vs["params"], "batch_stats": stats})
    assert_bn_stats_match_flax(trained, port, after, torch.from_numpy(x))


def _param_count(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))


# name -> (the port branch at the default config's widths, its golden count
# in tests/test_branches.py or the JAX module).
FULL_WIDTH = {
    "low_unet": (lambda: PB.LowIntensityUNet(32, 3), "low_unet"),
    "corun": (lambda: PB.COrunInspiredModel(64, 6), "corun"),
    "dual_branch": (lambda: PB.DualBranchAttentionModel(96, 9), "dual"),
    "encoder_decoder_medium": (lambda: PB.EncoderDecoder(64, 6, False),
                               lambda: JB.EncoderDecoder(64, 6, use_attention=False)),
    "encoder_decoder_high": (lambda: PB.EncoderDecoder(96, 9, True),
                             lambda: JB.EncoderDecoder(96, 9, use_attention=True)),
}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_param_counts(name):
    """The default config's widths: tests/test_branches.py's golden counts;
    the EncoderDecoders (no golden count) against the JAX module's
    parameter shapes (jax.eval_shape: no compile)."""
    make, ref = FULL_WIDTH[name]
    port = make()
    got = sum(p.numel() for p in port.parameters())
    if isinstance(ref, str):
        assert got == REF_PARAM_COUNTS[ref]
    else:
        vs = zeros_like_variables(_init(ref()))
        assert got == _param_count(vs["params"])
        port_of(port, vs)   # every tensor's shape, and none left unset


@pytest.mark.parametrize("name", [n for n, b in BRANCHES.items() if b[3]])
def test_reference_layout_through_jax_converter(name):
    """A seeded port branch's state_dict (the upstream reference's key
    names) through the JAX package's load_torch_branch: the JAX module then
    computes the port's forward."""
    _, pcls, kw, kind = BRANCHES[name]
    gen = torch.Generator().manual_seed(4)
    port = init_params_(pcls(**kw), gen).eval()
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.8, 1.3, generator=gen)
    jm = _jax_module(name)
    zeros = zeros_like_variables(_init(jm))
    sd = {k: v.numpy() for k, v in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = load_torch_branch(sd, kind, zeros["params"], zeros["batch_stats"])
    x = images((2, 32, 32, 3), seed=5)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# (level, model_type): the JAX factories' fall-through included.
FACTORY_CASES = [
    ("low", "lightweight"), ("low", "unet"), ("low", "anything_else"),
    ("medium", "standard"), ("medium", "corun"), ("medium", "encoder_decoder"),
    ("medium", "unknown"),
    ("high", "complex"), ("high", "dual_branch"), ("high", "encoder_decoder"),
    ("high", "unknown"),
]


@pytest.mark.parametrize("level,model_type", FACTORY_CASES)
def test_factory_builds_the_jax_class(level, model_type):
    jcfg, pcfg = default_config(), load_config()
    for cfg in (jcfg, pcfg):
        cfg["dehazing"][level].update(model_type=model_type, channels=8, blocks=3)
    jm = getattr(JB, f"create_{level}_intensity_model")(jcfg)
    pm = getattr(PB, f"create_{level}_intensity_model")(pcfg)
    assert type(pm).__name__ == type(jm).__name__
    assert getattr(pm, "use_attention", None) == getattr(jm, "use_attention", None)
    assert (pm.base_channels, pm.n_blocks) == (8, 3)
    assert set(PB.create_branch_models(pcfg)) == {"low", "medium", "high"}


@pytest.mark.parametrize("model_type", ["unet", "corun", "dual_branch", "encoder_decoder"])
def test_fullres_remat_matches_no_remat(model_type):
    """`cuda.remat: fullres` checkpoints the branch's full-resolution blocks
    (the JAX package's remat twins): one train-mode forward and backward
    equal the plain one (output, gradients, BN buffers at 1e-6), the
    state_dict keys are the same, and a full-resolution block ran its
    forward twice."""
    level = {"unet": "low", "corun": "medium"}.get(model_type, "high")
    runs = []
    for mode in (False, "fullres"):
        cfg = load_config(overrides={"cuda": {"remat": mode}})
        cfg["dehazing"][level].update(model_type=model_type, channels=16, blocks=3)
        model = getattr(PB, f"create_{level}_intensity_model")(cfg)
        if runs:
            model.load_state_dict(runs[0][0])
        else:
            init_params_(model, torch.Generator().manual_seed(6))
        first = model.fullres_blocks()[0]
        conv = next(m for m in model.get_submodule(first).modules()
                    if isinstance(m, torch.nn.Conv2d))
        calls = []
        conv.register_forward_hook(lambda *_: calls.append(1))
        state = copy.deepcopy(model.state_dict())
        x = torch.from_numpy(images((2, 32, 32, 3), seed=7))
        y = model.train()(x)
        (y * torch.linspace(0, 1, y.numel()).reshape(y.shape)).sum().backward()
        runs.append((state, y.detach(), {n: p.grad for n, p in model.named_parameters()},
                     dict(model.named_buffers()), len(calls)))
    (s0, y0, g0, b0, n0), (s1, y1, g1, b1, n1) = runs
    assert list(s0) == list(s1)
    assert (n0, n1) == (1, 2)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-6, atol=1e-6)
    assert set(g0) == set(g1)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    for n in b0:
        np.testing.assert_allclose(b1[n].numpy(), b0[n].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)


def test_soft_router_over_alternates_matches_jax():
    """The soft router over low_unet, corun and dual_branch with a
    mobilenet_v3_small classifier, on the same seeded variables (filled by
    load_flax_variables: the router's subtrees and the classifier's call-
    order names): blend, weights and each branch's output."""
    from adam_dehaze_tpu.models import routing as JR
    from adam_dehaze_tpu.models.classifier import create_classifier as jclf
    from adam_dehaze_tpu_torch.models.classifier import create_classifier as pclf
    from adam_dehaze_tpu_torch.models.routing import create_router

    jcfg, pcfg = default_config(), load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for cfg in (jcfg, pcfg):
        for level, mt, c in (("low", "unet", 8), ("medium", "corun", 8),
                             ("high", "dual_branch", 16)):
            cfg["dehazing"][level].update(model_type=mt, channels=c, blocks=2)
        cfg["classifier"]["model"] = "mobilenet_v3_small"
        cfg["routing"]["type"] = "soft"
    jcfg["tpu"].update(compute_dtype="float32", use_pallas=False)
    jr = JR.create_router(JB.create_branch_models(jcfg), jclf(jcfg), jcfg)
    key = jax.random.PRNGKey(0)
    vs = seeded_variables(lambda: jr.init({"params": key, "dropout": key},
                                          jnp.zeros((1, 32, 32, 3))), 8)
    port = port_of(create_router(PB.create_branch_models(pcfg), pclf(pcfg), pcfg), vs)
    x = images((2, 32, 32, 3), seed=9)
    want, info = jax.jit(lambda v, x: jr.apply(v, x))(vs, jnp.asarray(x))
    with torch.no_grad():
        got, got_info = port(torch.from_numpy(x))
    np.testing.assert_allclose(got_info["weights"].numpy(), np.asarray(info["weights"]),
                               atol=ATOL)
    for lvl in ("low", "medium", "high"):
        np.testing.assert_allclose(got_info["individual_outputs"][lvl].numpy(),
                                   np.asarray(info["individual_outputs"][lvl]), atol=ATOL,
                                   err_msg=lvl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
