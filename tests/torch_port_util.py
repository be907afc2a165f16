"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded flax variables, their transfer into port modules, layout
conversion, and the pair of serving objects on the same weights."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
    # Drawn with numpy on the init's shapes: flax's init of the router runs
    # op by op for over a minute (jitted, half of one).
    vs = seeded_variables(lambda: jr.init({"params": jax.random.PRNGKey(0),
                                           "dropout": jax.random.PRNGKey(1)},
                                          jnp.asarray(images((1, 32, 32, 3)))), 0)
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


def _bn_counts(module, *inputs):
    """Elements per channel that each BatchNorm2d of `module` normalises
    when it is called on `inputs` (eval mode, no gradient)."""
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: counts.__setitem__(
            name, inp[0].numel() // inp[0].shape[1]))
        for name, m in module.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    was_training = module.training
    with torch.no_grad():
        module.eval()(*inputs)
    for h in hooks:
        h.remove()
    module.train(was_training)
    return counts


def assert_bn_stats_match_flax(model, before, after, *inputs, steps=1, rtol=1e-5, atol=1e-6):
    """`model`'s BN running statistics after `steps` train-mode forwards on
    `inputs` against flax's: `before` and `after` are port modules holding
    flax's statistics before and after those forwards (momentum 0.9). Torch
    updates the running variance with the unbiased batch variance, flax with
    the biased one: the batch variance read from flax's update is scaled by
    n / (n - 1) (one forward: steps=1) before the comparison."""
    counts = _bn_counts(model, *inputs)
    for name, m in model.named_modules():
        if not isinstance(m, torch.nn.BatchNorm2d):
            continue
        old, new, n = before.get_submodule(name), after.get_submodule(name), counts[name]
        batch_var = (new.running_var.double() - 0.9 * old.running_var.double()) / 0.1
        want_var = 0.9 * old.running_var.double() + 0.1 * batch_var * n / (n - 1)
        np.testing.assert_allclose(m.running_mean.numpy(), new.running_mean.numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
        np.testing.assert_allclose(m.running_var.numpy(), want_var.numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
        assert int(m.num_batches_tracked) == int(old.num_batches_tracked) + steps, name


def joint_configs(routing="soft"):
    """(JAX config, port config) of the joint trainer's tests: branches
    low 4 x 1, medium 4, high 8, resnet18, 32^2, batch 2, fp32,
    augmentation off."""
    from adam_dehaze_tpu.config import default_config
    from adam_dehaze_tpu_torch.config import load_config
    jcfg = default_config()
    pcfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for cfg in (jcfg, pcfg):
        for level, (c, b) in {"low": (4, 1), "medium": (4, 2), "high": (8, 2)}.items():
            cfg["dehazing"][level].update(channels=c, blocks=b)
        cfg["dataset"].update(img_size=32, batch_size=2, num_workers=2, augmentation=False)
        cfg["routing"]["type"] = routing
    jcfg["tpu"].update(compute_dtype="float32", use_pallas=False)
    return jcfg, pcfg


def f64(jax_config):
    """The JAX config computing in float64 (under jax.enable_x64)."""
    return {**jax_config, "tpu": {**jax_config["tpu"], "compute_dtype": "float64"}}


def as64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def no_dropout_(module):
    """p = 0 on every dropout of a port module (the frameworks draw
    different masks)."""
    from adam_dehaze_tpu_torch.nn.blocks import Dropout
    for m in module.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return module


def flax_dropout_off(monkeypatch):
    """flax's Dropout as the identity, for the rest of the test (the two
    frameworks draw different masks)."""
    import flax.linen
    monkeypatch.setattr(flax.linen, "Dropout", lambda *a, **k: (lambda x, *aa, **kk: x))


def recording(module, name, key, records, starts=None):
    """`module.<name>` (a step maker) wrapped so that every step's
    metric `key` lands in `records` and, with `starts`, the state's step
    count before it."""
    original = getattr(module, name)

    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def recorded(*a):
            if starts is not None:
                starts.append(a[0].step)
            out = step(*a)
            m = out[1] if isinstance(out, tuple) else out
            records.append(float(m[key]))
            return out
        return recorded
    return make


def jax_router_variables(routing, seed=0):
    """Seeded variables of the JAX router of `joint_configs(routing)`, BN
    statistics moved away from 0/1: drawn by the port's init (flax's init,
    run op by op, takes over a minute on the CPU, jitted half of one) and
    carried over by the JAX package's own converter of reference
    checkpoints, load_torch_joint."""
    from adam_dehaze_tpu.models import branches as JB
    from adam_dehaze_tpu.models import classifier as JC
    from adam_dehaze_tpu.models import routing as JR
    from adam_dehaze_tpu.training.checkpoint import load_torch_joint
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from adam_dehaze_tpu_torch.nn.blocks import init_params_
    jcfg, pcfg = joint_configs(routing)
    gen = torch.Generator().manual_seed(seed)
    port = init_params_(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg),
                        gen)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(1.0, 1.3, generator=gen)

    def sd(module):
        return {k: v.numpy() for k, v in module.state_dict().items()}

    router = JR.create_router(JB.create_branch_models(jcfg), JC.create_classifier(jcfg), jcfg)
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(router.init, {"params": key, "dropout": key},
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    ckpt = {"classifier_state_dict": sd(port.classifier), "router_state_dict": sd(port),
            **{f"{lvl}_model_state_dict": sd(port.models[lvl]) for lvl in ("low", "medium", "high")}}
    return as_np(load_torch_joint(ckpt, template, jcfg))


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the port's ops for the rest of the module,
    restored after it: on tiny tensors the ops gain nothing from threads,
    and with several test workers sharing the CPU's cores each worker's
    full thread pool makes a train step tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_variables(init, seed):
    """flax variables on the shapes of `init()` (a flax init, traced by
    jax.eval_shape and never compiled: flax's own init runs op by op for
    seconds), drawn with numpy from `seed`: kernels lecun-normal, BN scales
    and variances in [0.8, 1.3], every other leaf (biases, BN shifts and
    means, the CBAM stencil) in [-0.1, 0.1]."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.3, leaf.shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, dict(t)) for c, t in shapes.items()}


def zeros_like_variables(init):
    """flax variables of the shapes of `init()`, all zero (a converter's
    template)."""
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  dict(jax.eval_shape(init)))
