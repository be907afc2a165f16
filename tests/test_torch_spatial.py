"""The port's parallel/spatial.py and parallel/sharding.py against the JAX
package's, and the step wrapper's spatial and model axes.

One gloo group of two processes (tests/torch_spatial_worker.py) is spawned
once for the module, at its start, and runs every case that needs a group,
on a `{"spatial": 2}` and a `{"model": 2}` mesh. While it runs, this
process computes the JAX references on its 8 virtual devices:

- `make_spatial_infer` of the low (K1's plain version on the taller shard),
  medium and high (K2's plain version with the maps' halo filled) branches
  at c = 8, 64^2, on JAX's data 2 x spatial 4 mesh, as
  tests/test_spatial_inference.py: the port's shards within 1e-4 of it and
  within 1e-5 of the port's unsharded forward;
- the medium and high branches under JAX's `channel_sharding` (data 2 x
  model 4), as tests/test_tensor_parallel.py: within 1e-4, and the port's
  channel-sharded forward within 1e-5 of its unsharded one;
- tests/test_parallel.py's two-conv DP x SP train step (data 4 x spatial 2,
  rtol 1e-5, atol 1e-6), against the port's step on the spatial mesh.

The group also holds `route_hard` over the spatial mesh against the
unsharded route (labels equal, outputs within 1e-5), the low branch's BN
step (spatial) and the medium branch's step (model) in float64 against the
single-process step within 1e-6, each exchange Function's gradient against
autograd of the unsharded computation it stands for, the refusals that are
left (int8 serving and the joint step under cuda.remat on an H shard), and,
on 2 H shards against the
unsharded calls: the tuned kernels' plain versions (K3, K6 on the medium
and high segments with K4 and K2' after them, K2' alone) within 1e-6, the
loss pieces (LPIPS, psnr, ssim_gray; fog_density_map in float64 within
1e-10), the augmentation's flip and jitter, and AlexNet's strided layers,
which raise rather than return rows the unsharded layer lacks. The joint
steps on a sharded mesh: tests/test_torch_joint_sharded.py.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from adam_dehaze_tpu.models import branches as jb
from adam_dehaze_tpu.parallel import data_parallel as jdp
from adam_dehaze_tpu.parallel import mesh as jmesh
from adam_dehaze_tpu.parallel import sharding as jsharding
from adam_dehaze_tpu.parallel import spatial as jspatial
from adam_dehaze_tpu_torch.parallel import mesh as pmesh
from adam_dehaze_tpu_torch.parallel import sharding as psharding
from adam_dehaze_tpu_torch.parallel import spatial as pspatial
from test_torch_parallel import _conv_init, _conv_torch, _jax_sgd_step, _tensors
from torch_port_util import (
    ATOL,
    images,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    seeded_variables,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120
# The port's sharded forwards and steps against its own unsharded ones.
SHARDED_ATOL = 1e-5
STEP_ATOL = 1e-6
JBRANCHES = {"low": lambda: jb.LightweightDehazeModel(8, 3, dtype=jnp.float32),
             "medium": lambda: jb.MediumIntensityDehazeModel(8, dtype=jnp.float32),
             "high": lambda: jb.HighIntensityDehazeModel(8, dtype=jnp.float32)}


def _branch_vars():
    return {lvl: seeded_variables(lambda m=make(): m.init(jax.random.PRNGKey(0),
                                                          jnp.zeros((1, 16, 16, 3)), False), i)
            for i, (lvl, make) in enumerate(JBRANCHES.items())}


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The two ranks, started with the module's first test, and their
    inputs."""
    tmp = tmp_path_factory.mktemp("spatial")
    _, conv_vars = _conv_init()
    inputs = {"branch_vars": _tensors(_branch_vars()),
              "x": torch.from_numpy(images((2, 64, 64, 3), seed=11)),
              "tp_x": torch.from_numpy(images((2, 32, 32, 3), seed=12)),
              "route_x": torch.from_numpy(images((4, 64, 64, 3), seed=13)),
              "conv_params": _conv_torch(conv_vars["params"]),
              "conv_x": torch.from_numpy(images((8, 16, 16, 3), seed=3)),
              "conv_y": torch.from_numpy(images((8, 16, 16, 3), seed=4)),
              "step_x": torch.from_numpy(images((4, 16, 16, 3), seed=14).astype(np.float64)),
              "step_y": torch.from_numpy(images((4, 16, 16, 3), seed=15).astype(np.float64)),
              "tuned_x": torch.from_numpy(images((2, 32, 32, 3), seed=16)),
              "gate_x": torch.from_numpy(images((2, 16, 8, 16), seed=17)),
              "gate_w": torch.from_numpy(np.random.default_rng(18).normal(
                  size=(7, 7, 2, 1)).astype(np.float32)),
              "loss_a": torch.from_numpy(images((2, 32, 32, 3), seed=19)),
              "loss_b": torch.from_numpy(images((2, 32, 32, 3), seed=20)),
              "hazy64": torch.from_numpy(images((2, 64, 64, 3), seed=21).astype(np.float64)),
              "aug_x": torch.from_numpy(images((4, 16, 8, 3), seed=22)),
              "aug_params": (torch.tensor([True, False, True, False]),
                             torch.tensor([True, True, False, False]),
                             torch.tensor([0.9, 1.05, 1.1, 0.95]),
                             torch.tensor([1.08, 0.92, 1.0, 1.1]))}
    torch.save(inputs, tmp / "inputs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                           "torch_spatial_worker.py"),
                               str(rank), str(port), str(tmp / "inputs.pt"), str(tmp)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    yield procs, tmp, inputs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(spawned):
    """What each rank wrote, after both ended (each within the timeout)."""
    procs, tmp, _ = spawned
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a spatial worker ran over {WORKER_TIMEOUT_S} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


def _joined(ranks, key, level):
    """The two ranks' H shards of `level`'s output, joined along H."""
    return torch.cat([out[key][level]["sharded"] for out in ranks], 1).numpy()


# ------------------------------------------------------------ one process ---

def test_shard_channels_noop_outside_context():
    x = torch.rand(1, 4, 8, 8)
    assert psharding.shard_channels(x) is x


def test_channel_sharding_degrades_without_model_axis():
    mesh = pmesh.make_mesh({"data": 8, "spatial": 1, "model": 1}, ["cpu"] * 8)
    with psharding.channel_sharding(mesh):
        x = torch.rand(1, 4, 8, 8)
        assert psharding.shard_channels(x) is x


def test_spatial_infer_without_a_spatial_axis_is_the_apply():
    """No spatial axis: the context is a no-op and the batch is whole (the
    image spec is JAX's)."""
    mesh = pmesh.make_mesh({"data": 1}, ["cpu"])
    x = torch.rand(2, 8, 8, 3)
    assert torch.equal(pspatial.shard_image_batch(mesh, x.numpy()), x)
    assert pspatial.make_spatial_infer(lambda t: t * 2, mesh)(x).equal(x * 2)
    assert pspatial.axis() is None


# ------------------------------------------------------ the JAX references ---

@pytest.fixture(scope="module")
def jax_spatial(spawned):
    """JAX's make_spatial_infer of each branch on the data 2 x spatial 4
    mesh."""
    variables = _branch_vars()
    mesh = jmesh.make_mesh({"data": 2, "spatial": 4, "model": 1})
    x = jspatial.shard_image_batch(mesh, jnp.asarray(spawned[2]["x"].numpy()))
    out = {}
    for level, make in JBRANCHES.items():
        model = make()
        infer = jspatial.make_spatial_infer(
            lambda img, m=model, v=variables[level]: m.apply(v, img), mesh)
        out[level] = np.asarray(infer(x))
    return out


@pytest.fixture(scope="module")
def jax_channels(spawned):
    """The medium and high branches under JAX's channel_sharding (data 2 x
    model 4), jitted as tests/test_tensor_parallel.py does."""
    variables = _branch_vars()
    mesh = jmesh.make_mesh({"data": 2, "spatial": 1, "model": 4})
    x = jnp.asarray(spawned[2]["tp_x"].numpy())
    out = {}
    for level in ("medium", "high"):
        model = JBRANCHES[level]()
        with jsharding.channel_sharding(mesh):
            f = jax.jit(lambda v, img, m=model: m.apply(v, img),
                        in_shardings=(NamedSharding(mesh, P()),
                                      NamedSharding(mesh, P("data", None, None, None))),
                        out_shardings=NamedSharding(mesh, P()))
            out[level] = np.asarray(f(variables[level], x))
    return out


@pytest.fixture(scope="module")
def jax_dp_sp_conv_step(spawned):
    """tests/test_parallel.py's DP x SP step (data 4 x spatial 2)."""
    model, variables = _conv_init()
    inputs = spawned[2]
    batch = {"x": jnp.asarray(inputs["conv_x"].numpy()), "y": jnp.asarray(inputs["conv_y"].numpy())}
    mesh = jmesh.make_mesh({"data": 4, "spatial": 2, "model": 1})
    step = jdp.shard_train_step(_jax_sgd_step(model, False), mesh, batch)
    new = step(variables, batch, jax.random.PRNGKey(0))[0]
    return _conv_torch(jax.tree_util.tree_map(np.asarray, new["params"]))


# ------------------------------------------------------- the two-rank group ---

@pytest.mark.parametrize("level", sorted(JBRANCHES))
def test_spatial_forward_matches_jax_and_the_unsharded_forward(ranks, jax_spatial, level):
    got = _joined(ranks, "spatial", level)
    np.testing.assert_allclose(got, jax_spatial[level], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ranks[0]["spatial"][level]["whole"].numpy(), rtol=0,
                               atol=SHARDED_ATOL)


def test_hard_route_over_a_spatial_mesh(ranks):
    """route_hard through make_spatial_infer: every rank routes the images
    as the unsharded route does (every branch serves one at least), and
    the shards join into its output."""
    for out in ranks:
        route = out["route"]
        assert route["labels"] == [0, 1, 2, 0]
        assert route["sharded_labels"] == route["labels"]
    whole = ranks[0]["route"]["whole"].numpy()
    got = torch.cat([out["route"]["sharded"] for out in ranks], 1).numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=SHARDED_ATOL)


@pytest.mark.parametrize("level", ["medium", "high"])
def test_channel_sharded_forward_matches_jax_and_the_unsharded_forward(ranks, jax_channels,
                                                                       level):
    for out in ranks:
        got = out["channels"][level]["sharded"].numpy()
        np.testing.assert_allclose(got, jax_channels[level], rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, out["channels"][level]["whole"].numpy(), rtol=0,
                                   atol=SHARDED_ATOL)


def test_dp_sp_conv_step_matches_jax(ranks, jax_dp_sp_conv_step):
    for out in ranks:
        for k, want in jax_dp_sp_conv_step.items():
            np.testing.assert_allclose(out["steps"]["conv"][k].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("level", ["low", "medium"])
def test_sharded_step_matches_the_global_step(ranks, level):
    """The low branch's train-mode BN step on the spatial mesh, the medium
    branch's on the model mesh (its 4c stages split, their BN statistics
    gathered back): every parameter and BN statistic within 1e-6 of the
    single-process step, float64."""
    want = ranks[0]["steps"][f"{level}_global"]
    for out in ranks:
        got = out["steps"][f"{level}_sharded"]
        assert set(got) == set(want)
        for k, v in want.items():
            err = float((got[k].double() - v.double()).abs().max())
            assert err <= STEP_ATOL, f"{level} {k}: {err:.3e}"


_EXCHANGES = ["halo", "halo_at_edges_left_out", "all_reduce_sum", "all_reduce_max",
              "sum_to_replicated", "shard_channels", "gather_channels"]


@pytest.mark.parametrize("name", _EXCHANGES)
def test_exchange_gradient_matches_autograd_of_the_unsharded_computation(ranks, name):
    for out in ranks:
        got, want = out["grads"][name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def test_refusals_under_a_sharded_mesh(ranks):
    for out in ranks:
        refused = out["refusals"]
        assert refused["int8"] and "Q1 and Q2" in refused["int8"]
        assert refused["remat"] and "cuda.remat" in refused["remat"]


# The plain versions on 2 H shards against the unsharded ones, fp32.
TUNED_ATOL = 1e-6


@pytest.mark.parametrize("name", ["k3", "k6_medium", "k6_k4_high", "k2_prime"])
def test_tuned_kernels_on_h_shards_equal_the_unsharded_plain_versions(ranks, name):
    whole = ranks[0]["tuned"][name]["whole"]
    got = torch.cat([out["tuned"][name]["sharded"] for out in ranks], 1)
    assert got.shape == whole.shape
    err = float((got - whole).abs().max())
    assert err <= TUNED_ATOL, f"{name}: {err:.3e}"


@pytest.mark.parametrize("name,atol", [("lpips", 1e-6), ("psnr", 1e-5), ("ssim", 1e-6),
                                       ("density", 1e-10)])
def test_loss_pieces_on_h_shards_equal_the_unsharded_ones(ranks, name, atol):
    """Per-image values (LPIPS, PSNR in dB, SSIM) on every rank as the
    whole batch's; the fog-density maps (float64) joined along H."""
    whole = ranks[0]["losses"][name]["whole"]
    parts = [out["losses"][name]["sharded"] for out in ranks]
    got = torch.cat(parts, 1) if name == "density" else parts
    for g in (got,) if name == "density" else got:
        assert g.shape == whole.shape
        np.testing.assert_allclose(g.numpy(), whole.numpy(), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("name", ["flip", "jitter"])
def test_augmentation_on_h_shards_equals_the_unsharded_one(ranks, name):
    whole = ranks[0]["augment"][name]["whole"]
    got = torch.cat([out["augment"][name]["sharded"] for out in ranks], 1)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("layer", ["conv1", "pool"])
def test_alexnet_layers_on_h_shards_never_return_rows_the_unsharded_layer_lacks(ranks, layer):
    """AlexNet's 11x11/4 conv (15 rows of a 64^2 image) and its 3x3/2
    max-pool (7 of 16) do not split over 2 shards: they raise, naming the
    layer, rather than return 8 + 8 rows."""
    for out in ranks:
        want, got = out["alexnet"][layer]
        assert want in (15, 7)
        assert isinstance(got, str) and "does not split" in got and "stride" in got, got
