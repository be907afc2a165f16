"""The joint trainer's steps on a spatial and model mesh, and the port's
`dryrun_multichip`.

One gloo group of four processes (tests/torch_joint_sharded_worker.py) is
spawned once for the module, on a data 1 x spatial 2 x model 2 mesh, in
the JAX dryrun's config (mobilenet_v2, branch widths 4 / 4 / 8, 1 block) at
64^2 (the port splits H into equal shards: 32 rows a shard for the
classifier's 32-fold downsampling), batch 2:

- `make_train_step` (soft routing, augmentation and dropout on),
  `make_hard_branch_step` (the high branch) and `make_eval_step` through
  `shard_train_step` / `shard_eval_step`, float64, against the same steps
  unsharded in one process: the metrics, every parameter and BN statistic
  (and the eval step's images) within 1e-10;
- one joint step (augmentation and dropout off, SGD so that the update is
  the gradient) against the JAX package's `shard_train_step` of its joint
  `make_train_step` under `channel_sharding` on the virtual data 2 x
  spatial 4 mesh, computed in float64 (BN dominates; ROADMAP's hazards).
  The port's sharded step in float64: the loss components and the BN
  statistics within 1e-6, every gradient within 1e-5 of the largest (the
  classifiers pool into float32 features, so the routing weights carry
  float32's precision). In float32: the loss components within 1e-4, the
  BN statistics as flax's (torch's unbiased batch variance mapped to
  flax's biased one) within 1e-4 (the classifier's last stages normalise
  8 values a channel), and the gradients within 1e-2 of the largest, the
  bound the repo's notes give the JAX package's own float32 steps against
  float64: this config's width-4 and width-8 branches normalise
  near-constant channels in train mode, and float32 moves some of their
  gradients by more than 1e-4 of the largest in the port's unsharded step
  as well (the high branch's), so they are held to 1e-4 in float64. The JAX
  mesh has no model axis: with one (the dryrun's 2 x 2 x 2, or 1 x 2 x 2)
  JAX's sharded joint step returned the same losses as its unsharded step
  but other gradients for the branches, where the port's equal its
  unsharded step's;
- `dryrun_multichip(4, (1, 2, 2))` runs to its end on every rank.

This process computes the JAX reference (about a minute to compile) while
the ranks run.
"""
import contextlib
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adam_dehaze_tpu.config import default_config
from adam_dehaze_tpu.losses.dehazing import get_joint_loss as jget_joint_loss
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu.parallel.data_parallel import shard_train_step as jshard_train_step
from adam_dehaze_tpu.parallel.mesh import make_mesh as jmake_mesh
from adam_dehaze_tpu.parallel.sharding import channel_sharding as jchannel_sharding
from adam_dehaze_tpu.training.checkpoint import load_torch_joint
from adam_dehaze_tpu.training.state import TrainState as JTrainState
from adam_dehaze_tpu.training.train_joint import make_train_step as jmake_train_step
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.parallel.dryrun import dryrun_config
from torch_joint_sharded_worker import LR, STEPS
from torch_port_util import (
    ATOL,
    as64,
    as_np,
    assert_bn_stats_match_flax,
    images,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    port_loss_params,
    port_of,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240
SIZE = 64
# The sharded steps against the unsharded ones, float64. The metrics the
# port computes in float32 whatever the input (PSNR and SSIM, as
# ops/image.py does; the cross-entropy) within float32's relative
# precision.
STEP_ATOL = 1e-10
F32_RTOL = 2e-6
# The port's sharded step against JAX's in float64 (see the docstring).
JAX_TOL = {"float32": {"loss": ATOL, "grad": 1e-2, "bn": ATOL},
           "float64": {"loss": 1e-6, "grad": 1e-5, "bn": 1e-6}}


def _jax_config():
    cfg = default_config()
    cfg["tpu"].update(use_pallas=False, compute_dtype="float64")
    cfg["classifier"]["model"] = "mobilenet_v2"
    for level, channels in (("low", 4), ("medium", 4), ("high", 8)):
        cfg["dehazing"][level].update(channels=channels, blocks=1)
    return cfg


def _port_router():
    cfg = dryrun_config()
    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    gen = torch.Generator().manual_seed(10)
    init_params_(router, gen)
    with torch.no_grad():
        for m in router.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(1.0, 1.3, generator=gen)
    return router


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The four ranks, started with the module's first test, and what the
    JAX reference needs: the router's weights, the JAX loss nets, the
    float32 batch."""
    tmp = tmp_path_factory.mktemp("joint_sharded")
    jcfg = _jax_config()
    jl = jget_joint_loss(jcfg)
    jlp = as_np(jax.jit(lambda k: jl.init(k, (1, SIZE, SIZE, 3)))(jax.random.PRNGKey(1)))
    nets = port_loss_params(jlp)
    router = _port_router()
    f64 = {"hazy": torch.from_numpy(images((2, SIZE, SIZE, 3), seed=30).astype(np.float64)),
           "clear": torch.from_numpy(images((2, SIZE, SIZE, 3), seed=31).astype(np.float64)),
           "intensity": torch.tensor([2, 0])}
    f32 = {"hazy": torch.from_numpy(images((2, SIZE, SIZE, 3), seed=32)),
           "clear": torch.from_numpy(images((2, SIZE, SIZE, 3), seed=33)),
           "intensity": torch.tensor([0, 2])}
    inputs = {"router": router.state_dict(), "nets": {k: v.state_dict() for k, v in nets.items()},
              "batch": f64, "jax_batch": f32}
    torch.save(inputs, tmp / "inputs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                           "torch_joint_sharded_worker.py"),
                               str(rank), str(port), str(tmp / "inputs.pt"), str(tmp)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(4)]
    yield procs, tmp, inputs, jlp
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(spawned):
    """What each rank wrote, after all ended (each within the timeout)."""
    procs, tmp, _, _ = spawned
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a joint-step worker ran over {WORKER_TIMEOUT_S} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(4)]


@pytest.fixture(scope="module")
def jax_step(spawned):
    """JAX's shard_train_step of its joint make_train_step under
    channel_sharding (data 2 x spatial 4), float64, flax's
    dropout the identity, SGD at LR, augmentation off: (metrics, the
    variables after the step as a port router's state dict)."""
    _, _, inputs, jlp = spawned
    jcfg = _jax_config()
    port = _port_router()

    def sd(module):
        return {k: v.numpy() for k, v in module.state_dict().items()}

    import flax.linen
    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        mp.setattr(flax.linen, "Dropout", lambda *a, **k: (lambda x, *aa, **kk: x))
        stack.enter_context(jax.enable_x64(True))
        router = JR.create_router(JB.create_branch_models(jcfg), JC.create_classifier(jcfg), jcfg)
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(router.init, {"params": key, "dropout": key},
                                jnp.zeros((1, SIZE, SIZE, 3), jnp.float64))
        template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
        ckpt = {"classifier_state_dict": sd(port.classifier), "router_state_dict": sd(port),
                **{f"{lvl}_model_state_dict": sd(port.models[lvl])
                   for lvl in ("low", "medium", "high")}}
        variables = as64(as_np(load_torch_joint(ckpt, template, jcfg)))
        tx = optax.sgd(LR)
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
        jl = jget_joint_loss(jcfg)
        batch = {k: v.numpy().astype(np.float64) if v.is_floating_point()
                 else v.numpy().astype(np.int32) for k, v in inputs["jax_batch"].items()}
        mesh = jmake_mesh({"data": 2, "spatial": 4, "model": 1})
        with jchannel_sharding(mesh):
            step = jmake_train_step(router, tx, jl, as64(jlp), augmentation=False)
            new, metrics = jshard_train_step(step, mesh, batch)(state, batch,
                                                                 jax.random.PRNGKey(5))
        new = as_np({"params": new.params, "batch_stats": new.batch_stats})
        metrics = {k: float(v) for k, v in metrics.items()}
    after = port_of(_port_router(), jax.tree_util.tree_map(np.float32, new))
    return metrics, after


def _err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


@pytest.mark.parametrize("kind", STEPS)
def test_sharded_joint_steps_equal_the_unsharded_ones(ranks, kind):
    """Float64: every rank's metrics, and every parameter and BN statistic
    it trained (all of it replicated), equal the unsharded step's within
    1e-10 (the eval step's images joined from the ranks' H shards); the
    float32 metrics within F32_RTOL."""
    want_metrics, want_state = next(out["global"][kind] for out in ranks
                                    if kind in out.get("global", {}))
    for rank, out in enumerate(ranks):
        metrics, state = out["sharded"][kind]
        assert set(metrics) == set(want_metrics)
        for k, v in want_metrics.items():
            got = metrics[k]
            assert got.shape == v.shape and got.dtype == v.dtype, (kind, k)
            bound = STEP_ATOL if v.dtype != torch.float32 else F32_RTOL * max(
                1.0, float(v.abs().max()))
            assert _err(got, v) <= bound, f"{kind} rank {rank} {k}: {_err(got, v):.3e}"
        assert set(state) == set(want_state)
        for k, v in want_state.items():
            if v.is_floating_point():
                assert _err(state[k], v) <= STEP_ATOL, \
                    f"{kind} rank {rank} {k}: {_err(state[k], v):.3e}"
            else:
                assert torch.equal(state[k], v), (kind, k)
    if kind == "eval":
        assert int(metrics["n"]) == 2 and want_metrics["dehazed"].shape == (2, SIZE, SIZE, 3)


def _grads(before, after):
    return {k: (before[k].double() - after[k].double()) / LR for k, v in before.items()
            if v.is_floating_point() and "running" not in k}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_joint_step_matches_jax(ranks, jax_step, spawned, dtype):
    """The port's sharded step against JAX's sharded step in float64 (see
    the module docstring for the bounds)."""
    want_metrics, jax_after = jax_step
    before = spawned[2]["router"]
    hazy = spawned[2]["jax_batch"]["hazy"]
    grads_want = _grads(before, jax_after.state_dict())
    g_max = max(float(g.abs().max()) for g in grads_want.values())
    tol = JAX_TOL[dtype]
    for rank, out in enumerate(ranks):
        got = out["jax_step"][dtype]
        for k in ("dehazing", "classification", "total", "psnr"):
            np.testing.assert_allclose(got["metrics"][k], want_metrics[k], rtol=tol["loss"],
                                       atol=tol["loss"], err_msg=f"rank {rank} {k}")
        grads = _grads(before, got["state"])
        for k, g in grads_want.items():
            err = _err(grads[k], g)
            assert err <= tol["grad"] * g_max, f"rank {rank} {k}: {err / g_max:.3e} of the largest"
        model, start = _port_router(), _port_router()
        model.load_state_dict(got["state"])
        start.load_state_dict(before)
        assert_bn_stats_match_flax(model, start, jax_after, hazy, rtol=tol["bn"],
                                   atol=tol["bn"])


def test_dryrun_multichip_runs_to_its_end(ranks):
    for out in ranks:
        run = out["dryrun"]
        assert run["mesh"] == (1, 2, 2)
        assert np.isfinite(run["metrics"]["total"])
        assert run["serving_err"] <= 2e-5 and run["expert_err"] <= 5e-5
    assert len({out["dryrun"]["metrics"]["total"] for out in ranks}) == 1
