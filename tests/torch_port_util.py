"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded flax variables, their transfer into port modules, layout
conversion."""
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
