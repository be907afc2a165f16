"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded flax variables, their transfer into port modules, layout
conversion, and the pair of serving objects on the same weights."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

# fp32 port vs fp32 JAX (matmul precision "highest", tests/conftest.py).
ATOL = 1e-4


def init_flax(module, x, seed=0, perturb_bn=True):
    """Seeded flax variables as nested numpy dicts, with BN running stats
    moved away from 0/1 so that folding and conversion are exercised."""
    vs = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), False)
    vs = jax.tree_util.tree_map(np.asarray, dict(vs))
    if perturb_bn and "batch_stats" in vs:
        rng = np.random.default_rng(seed + 1)
        vs["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (a + rng.uniform(0.0, 0.3, a.shape)).astype(np.float32),
            vs["batch_stats"])
    return vs


def port_of(port_module, variables):
    """The port module filled from flax variables, in eval mode."""
    from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables
    return load_flax_variables(port_module, variables).eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def images(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def serving_configs():
    """(JAX config, port config) of the small fp32 serving slice: low c=8,
    medium c=8, high c=16 at 32^2."""
    from adam_dehaze_tpu.config import default_config
    from adam_dehaze_tpu_torch.config import load_config
    jcfg = default_config()
    pcfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for cfg in (jcfg, pcfg):
        for level, ch, blocks in (("low", 8, 2), ("medium", 8, 6), ("high", 16, 9)):
            cfg["dehazing"][level].update(channels=ch, blocks=blocks)
        cfg["dataset"]["img_size"] = 32
    jcfg["tpu"].update(compute_dtype="float32", use_pallas=False)
    return jcfg, pcfg


def dehazer_pair(**port_kwargs):
    """The JAX package's AdaptiveDehazer and the port's (on the CPU, with
    `port_kwargs`) on the same seeded variables."""
    from adam_dehaze_tpu.models import routing as JR
    from adam_dehaze_tpu.models.branches import create_branch_models
    from adam_dehaze_tpu.models.classifier import create_classifier
    from adam_dehaze_tpu.serving import AdaptiveDehazer as JDehazer
    from adam_dehaze_tpu_torch.models import routing as TR
    from adam_dehaze_tpu_torch.models.branches import (
        create_branch_models as p_branches,
    )
    from adam_dehaze_tpu_torch.models.classifier import (
        create_classifier as p_classifier,
    )
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

    jcfg, pcfg = serving_configs()
    jr = JR.create_router(create_branch_models(jcfg), create_classifier(jcfg), jcfg)
    vs = jr.init({"params": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)},
                 jnp.asarray(images((1, 32, 32, 3))))
    vs = jax.tree_util.tree_map(np.asarray, dict(vs))
    rng = np.random.default_rng(11)
    vs["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0, 0.3, a.shape)).astype(np.float32),
        vs["batch_stats"])
    state = types.SimpleNamespace(params=vs["params"],
                                  batch_stats=vs["batch_stats"])
    jd = JDehazer(jr, state, jcfg)
    port_router = TR.create_router(p_branches(pcfg), p_classifier(pcfg), pcfg)
    pd = AdaptiveDehazer(port_router, vs, pcfg, device="cpu", **port_kwargs)
    return jd, pd


def port_loss_params(jax_loss_params):
    """The port's frozen loss nets filled from the JAX DehazingLoss's
    `init` tree ({"content": VGG16 params, "lpips": LPIPS params})."""
    from adam_dehaze_tpu_torch.losses.dehazing import CONTENT_TAPS
    from adam_dehaze_tpu_torch.losses.lpips import LPIPS
    from adam_dehaze_tpu_torch.nn.vgg import VGG16Features
    nets = {"content": port_of(VGG16Features(CONTENT_TAPS), jax_loss_params["content"]),
            "lpips": port_of(LPIPS(), jax_loss_params["lpips"])}
    for net in nets.values():
        net.requires_grad_(False)
    return nets
