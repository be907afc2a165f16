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

Int8 serving (ops/quant.py) on the two meshes: the medium and high
branches' int8 applies at c = 8, 64^2, fp32, against JAX's int8 apply
(`quantize_apply`) through `make_spatial_infer` on a data 1 x spatial 8
mesh and under `channel_sharding` on a data 1 x model 8 mesh, and against
the port's unsharded int8 apply, by tests/test_torch_quant.py's
`_assert_int8_close` (on one split axis JAX's partitioned int8 equals its
unsharded int8 element for element; on two or more it does not, see
tests/test_torch_joint_sharded.py); and one Int8Conv2d of each body and
shape on 2 H shards and on 2 channel shards, bit for bit the unsharded
layer's.

The joint train step under `cuda.remat` true and "fullres" on the spatial
mesh (the dryrun's router, float64) equals the same sharded step without
remat within 1e-10; a checkpointed forward on an H shard whose backward
runs on another thread, outside the sharding context, gives the gradients
and BN statistics of the same backward without the checkpoint.

The group also holds `route_hard` over the spatial mesh against the
unsharded route (labels equal, outputs within 1e-5), the low branch's BN
step (spatial) and the medium branch's step (model) in float64 against the
single-process step within 1e-6, each exchange Function's gradient against
autograd of the unsharded computation it stands for, and, on 2 H shards
against the
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
from adam_dehaze_tpu.ops.quant import quantize_apply as jquantize_apply
from adam_dehaze_tpu.parallel import data_parallel as jdp
from adam_dehaze_tpu.parallel import mesh as jmesh
from adam_dehaze_tpu.parallel import sharding as jsharding
from adam_dehaze_tpu.parallel import spatial as jspatial
from adam_dehaze_tpu_torch.parallel import mesh as pmesh
from adam_dehaze_tpu_torch.parallel import sharding as psharding
from adam_dehaze_tpu_torch.parallel import spatial as pspatial
from test_torch_parallel import _conv_init, _conv_torch, _jax_sgd_step, _tensors
from test_torch_quant import _assert_int8_close
from torch_spatial_worker import INT8_LAYERS
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
                             torch.tensor([1.08, 0.92, 1.0, 1.1])),
              "remat_batch": {
                  "hazy": torch.from_numpy(images((2, 64, 64, 3), seed=23).astype(np.float64)),
                  "clear": torch.from_numpy(images((2, 64, 64, 3), seed=24).astype(np.float64)),
                  "intensity": torch.tensor([1, 2])}}
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
def jax_int8(spawned):
    """JAX's int8 apply (quantize_apply, jitted) of the medium and high
    branches through make_spatial_infer on a data 1 x spatial 8 mesh, and
    under channel_sharding on a data 1 x model 8 mesh: one split axis each,
    where JAX's partitioned int8 equals its unsharded int8."""
    variables = _branch_vars()
    x = jnp.asarray(spawned[2]["x"].numpy())
    spatial_mesh = jmesh.make_mesh({"data": 1, "spatial": 8, "model": 1})
    model_mesh = jmesh.make_mesh({"data": 1, "spatial": 1, "model": 8})
    out = {"spatial": {}, "channels": {}}
    for level in ("medium", "high"):
        model = JBRANCHES[level]()
        apply = jquantize_apply(lambda img, m=model, v=variables[level]: m.apply(v, img))
        infer = jspatial.make_spatial_infer(apply, spatial_mesh)
        out["spatial"][level] = np.asarray(infer(jspatial.shard_image_batch(spatial_mesh, x)))
        with jsharding.channel_sharding(model_mesh):
            f = jax.jit(jquantize_apply(lambda v, img, m=model: m.apply(v, img)),
                        in_shardings=(NamedSharding(model_mesh, P()),
                                      NamedSharding(model_mesh, P("data", None, None, None))),
                        out_shardings=NamedSharding(model_mesh, P()))
            out["channels"][level] = np.asarray(f(variables[level], x))
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


def test_int8_hard_route_over_a_spatial_mesh(ranks):
    """route_hard of the int8 dehazer through make_spatial_infer: the
    unsharded int8 route's labels (every branch serves one image at least)
    on every rank, and its output by `_assert_int8_close`."""
    for out in ranks:
        assert out["route_int8"]["labels"] == [0, 1, 2, 0]
        assert out["route_int8"]["sharded_labels"] == out["route_int8"]["labels"]
    got = torch.cat([out["route_int8"]["sharded"] for out in ranks], 1).numpy()
    _assert_int8_close(got, ranks[0]["route_int8"]["whole"].numpy())
    assert np.abs(got - ranks[0]["route"]["whole"].numpy()).max() > 0     # really int8


@pytest.mark.parametrize("level", ["medium", "high"])
@pytest.mark.parametrize("axis", ["spatial", "channels"])
def test_int8_on_shards_matches_jax_and_the_unsharded_int8(jax_int8, ranks, axis, level):
    """The int8 branch on 2 H shards (joined along H) and on 2 channel
    shards (every rank's whole output) against JAX's int8 apply on a mesh of
    that one axis and against the port's unsharded int8."""
    outs = [out["int8"][level][axis] for out in ranks]
    got = [torch.cat(outs, 1)] if axis == "spatial" else outs
    for g in got:
        assert g.shape == ranks[0]["int8"][level]["whole"].shape
        _assert_int8_close(g.numpy(), jax_int8[axis][level])
        _assert_int8_close(g.numpy(), ranks[0]["int8"][level]["whole"].numpy())


@pytest.mark.parametrize("name", sorted(INT8_LAYERS))
def test_int8_layer_on_h_shards_is_the_unsharded_layer_bit_for_bit(ranks, name):
    """Q1's abs-max reduced over the group, the int8 halo (two rows above at
    4x4 stride 2), Q2 on the taller shard and the crop: the shards' rows
    joined along H are the unsharded layer's, bit for bit."""
    whole = ranks[0]["int8_layers"][name]["whole"]
    got = torch.cat([out["int8_layers"][name]["spatial"] for out in ranks], 2)
    assert got.shape == whole.shape and torch.equal(got, whole), name


@pytest.mark.parametrize("name", sorted(n for n, spec in INT8_LAYERS.items() if spec[0] > 3))
def test_int8_layer_on_channel_shards_is_the_unsharded_layer_bit_for_bit(ranks, name):
    """The input's channels gathered, Q1 on the whole, Q2 on this rank's
    output channels (their packed slice, scales, bias and BN): the ranks'
    channels side by side are the unsharded layer's, bit for bit."""
    whole = ranks[0]["int8_layers"][name]["whole"]
    got = torch.cat([out["int8_layers"][name]["channels"] for out in ranks], 1)
    assert got.shape == whole.shape and torch.equal(got, whole), name


# The sharded steps under remat against the same steps without it, float64.
REMAT_ATOL = 1e-10


def _assert_states_close(got, want, atol, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if v.is_floating_point():
            err = float((got[k].double() - v.double()).abs().max()) if v.numel() else 0.0
            assert err <= atol, f"{what} {k}: {err:.3e}"
        else:
            assert torch.equal(got[k], v), f"{what} {k}"


@pytest.mark.parametrize("mode", ["True", "fullres"])
def test_remat_joint_step_on_h_shards_equals_no_remat(ranks, mode):
    """The joint step on 2 H shards under cuda.remat `mode` (its recompute
    re-enters the shard, the synchronized BNs frozen) against the same
    sharded step without remat: the metrics, every parameter and BN
    statistic within 1e-10."""
    for rank, out in enumerate(ranks):
        metrics, state = out["remat"][mode]
        want_metrics, want_state = out["remat"]["False"]
        _assert_states_close(metrics, want_metrics, REMAT_ATOL, f"rank {rank} {mode} metrics")
        _assert_states_close(state, want_state, REMAT_ATOL, f"rank {rank} {mode}")


@pytest.mark.parametrize("thread", ["bare_thread", "mode_thread"])
def test_remat_recompute_on_another_thread_reenters_the_shard(ranks, thread):
    """The backward of a checkpointed forward on an H shard, run on a thread
    that has none of the sharding context, or only its function mode (as
    the card's autograd thread), gives the gradients and BN statistics of
    the same backward without the checkpoint."""
    for rank, out in enumerate(ranks):
        _assert_states_close(out["remat_thread"][thread], out["remat_thread"]["plain"],
                             REMAT_ATOL, f"rank {rank} {thread}")


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
