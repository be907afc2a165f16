"""Resizes and adaptive pools on an H shard (parallel/sharded_ops.py) against
the JAX package's `make_spatial_infer` and the port's unsharded calls.

One gloo group of two processes (tests/torch_spatial_resize_worker.py) is
spawned once for the module, at its start, on a `{"spatial": 2}` mesh. While
it runs, this process computes the JAX references on its 8 virtual devices
(data 2 x spatial 4, as tests/test_spatial_inference.py):

- the branches whose forward resizes: COrunInspiredModel (max-pools,
  align-corners upsamples), DualBranchAttentionModel (the same around
  AttentionBlocks, K2's plain version with its maps' halo filled) and the
  medium branch at 64 x 58, whose decoder resizes W alone (58 -> 29 -> 14 ->
  28, resized to 29): c = 8, 64^2, fp32, within 1e-4 of JAX and 1e-5 of the
  port's unsharded forward;
- the half-resolution dial (ops/resolution.py) around the medium and high
  branches: fp32 within 1e-4 of JAX; against the unsharded dial in float64
  within 1e-5 (in float32 the guided lift's integral images sum their rows
  in another order on a taller shard: 3e-5 apart at 64^2 for the medium
  branch, 1.4e-4 at 512^2, a rounding of the box filter and not of the
  resizes); the bilinear dial around the tuned applies' plain versions
  (K3; K6, K4 and K2') within 1e-5 in fp32;
- route_hard with the dial on every branch: the unsharded route's labels on
  every rank, its output within the port's fp32 bound against JAX (1e-4:
  the guided lift again);
- F.interpolate alone on 2 H shards in each ported mode, within 1e-6 of the
  unsharded op (bit for bit where it is the identity along H), its
  gradient against autograd of the unsharded resize, the adaptive pools,
  and the refusals (other modes, uneven outputs, pads of H, strided
  average pools), each naming what it refuses.
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
import torch.nn.functional as F

from adam_dehaze_tpu.models import branches as jb
from adam_dehaze_tpu.ops.resolution import make_lowres_apply as jlowres
from adam_dehaze_tpu.parallel import mesh as jmesh
from adam_dehaze_tpu.parallel import spatial as jspatial
from adam_dehaze_tpu_torch.parallel import mesh as pmesh
from adam_dehaze_tpu_torch.parallel import sharded_ops
from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
from test_torch_parallel import _tensors
from torch_port_util import (
    ATOL,
    images,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    seeded_variables,
)
from torch_spatial_resize_worker import GRAD_RESIZES, RESIZES

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120
# The port's sharded forwards against its own unsharded ones.
SHARDED_ATOL = 1e-5
# One resize on shards against the unsharded op: the same weights, summed
# in another order.
RESIZE_ATOL = 1e-6
JBRANCHES = {"corun": lambda: jb.COrunInspiredModel(8, 2, dtype=jnp.float32),
             "dual_branch": lambda: jb.DualBranchAttentionModel(8, dtype=jnp.float32),
             "medium": lambda: jb.MediumIntensityDehazeModel(8, dtype=jnp.float32),
             "high": lambda: jb.HighIntensityDehazeModel(8, dtype=jnp.float32)}


def _branch_vars():
    return {name: seeded_variables(lambda m=make(): m.init(jax.random.PRNGKey(0),
                                                           jnp.zeros((1, 16, 16, 3)), False), i)
            for i, (name, make) in enumerate(JBRANCHES.items())}


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The two ranks, started with the module's first test, and their
    inputs."""
    tmp = tmp_path_factory.mktemp("spatial_resize")
    inputs = {"branch_vars": _tensors(_branch_vars()),
              "x": torch.from_numpy(images((2, 64, 64, 3), seed=31)),
              "x58": torch.from_numpy(images((2, 64, 58, 3), seed=32)),
              "route_x": torch.from_numpy(images((4, 64, 64, 3), seed=33)),
              "resize_x": torch.from_numpy(np.random.default_rng(34).standard_normal(
                  (2, 3, 8, 6)).astype(np.float32))}
    torch.save(inputs, tmp / "inputs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                           "torch_spatial_resize_worker.py"),
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
            pytest.fail(f"a spatial resize worker ran over {WORKER_TIMEOUT_S} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


def _joined(ranks, key, name, dim=1):
    """The two ranks' H shards of `name`'s output, joined along H."""
    return torch.cat([out[key][name]["sharded"] for out in ranks], dim)


def _err(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a.double() - b.double()).abs().max())


# ------------------------------------------------------------ one process ---

def test_resizes_and_pools_pass_through_without_a_spatial_axis():
    """Outside spatial_sharding, and under channel_sharding alone, the rules
    are torch's own functions."""
    mesh = pmesh.make_mesh({"data": 1}, ["cpu"])
    x = torch.rand(1, 4, 6, 6)
    with channel_sharding(mesh), sharded_ops.intercepting():
        got = [F.interpolate(x, size=(9, 3), mode="bicubic"),
               F.adaptive_avg_pool2d(x, 2), F.adaptive_max_pool2d(x, (3, 2))]
    want = [F.interpolate(x, size=(9, 3), mode="bicubic"), F.adaptive_avg_pool2d(x, 2),
            F.adaptive_max_pool2d(x, (3, 2))]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode,kwargs", [("bilinear", dict(antialias=True)),
                                         ("bilinear", dict(align_corners=True)),
                                         ("nearest-exact", {})])
def test_resize_plan_is_the_op_along_h(mode, kwargs):
    """The plan's matrix applied along H, then the op along W alone, is the
    op: 24 -> 8 and 24 -> 36 rows; with 4 shards the halo covers every
    shard's band."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 2, 24, 5)))
    for rows_out in (8, 36):
        m, identity, top, bottom, bands = sharded_ops._resize_plan(
            24, {"size": (rows_out, 24)}, mode, kwargs.get("align_corners"),
            kwargs.get("antialias", False), torch.float64, x.device, 4)
        assert not identity
        got = F.interpolate(torch.matmul(m, x), size=(rows_out, 7), mode=mode, **kwargs)
        want = F.interpolate(x, size=(rows_out, 7), mode=mode, **kwargs)
        assert _err(got, want) <= 1e-12
        for r, (lo, hi) in enumerate(bands):
            assert r * 6 - top <= lo and hi <= (r + 1) * 6 + bottom
            rows = m[r * rows_out // 4:(r + 1) * rows_out // 4]
            assert not rows[:, :lo].any() and not rows[:, hi:].any()


# ------------------------------------------------------ the JAX references ---

def _jax_spatial(apply, x):
    mesh = jmesh.make_mesh({"data": 2, "spatial": 4, "model": 1})
    infer = jspatial.make_spatial_infer(apply, mesh)
    return np.asarray(infer(jspatial.shard_image_batch(mesh, jnp.asarray(x))))


@pytest.fixture(scope="module")
def jax_spatial(spawned):
    """JAX's make_spatial_infer of corun, dual_branch, the medium branch at
    64 x 58 and the dial around the medium and high branches, on the
    data 2 x spatial 4 mesh."""
    variables = _branch_vars()
    inputs = spawned[2]
    x, x58 = inputs["x"].numpy(), inputs["x58"].numpy()

    def apply(name):
        model = JBRANCHES[name]()
        return lambda img: model.apply(variables[name], img)

    return {"corun": _jax_spatial(apply("corun"), x),
            "dual_branch": _jax_spatial(apply("dual_branch"), x),
            "medium_58": _jax_spatial(apply("medium"), x58),
            "dial_medium": _jax_spatial(jlowres(apply("medium")), x),
            "dial_high": _jax_spatial(jlowres(apply("high")), x)}


# ------------------------------------------------------- the two-rank group ---

@pytest.mark.parametrize("name", ["corun", "dual_branch", "medium_58"])
def test_branch_on_h_shards_matches_jax_and_the_unsharded_forward(ranks, jax_spatial, name):
    got = _joined(ranks, "models", name)
    np.testing.assert_allclose(got.numpy(), jax_spatial[name], rtol=0, atol=ATOL)
    assert _err(got, ranks[0]["models"][name]["whole"]) <= SHARDED_ATOL


@pytest.mark.parametrize("level", ["medium", "high"])
def test_dial_on_h_shards_matches_jax_and_the_unsharded_dial(ranks, jax_spatial, level):
    """fp32 against JAX; float64 against the port's unsharded dial."""
    got = _joined(ranks, "dial", level)
    np.testing.assert_allclose(got.numpy(), jax_spatial[f"dial_{level}"], rtol=0, atol=ATOL)
    assert _err(_joined(ranks, "dial", f"{level}_float64"),
                ranks[0]["dial"][f"{level}_float64"]["whole"]) <= SHARDED_ATOL


@pytest.mark.parametrize("name", ["k3", "k6_k4"])
def test_bilinear_dial_around_the_tuned_applies_on_h_shards(ranks, name):
    assert _err(_joined(ranks, "dial", name), ranks[0]["dial"][name]["whole"]) <= SHARDED_ATOL


def test_hard_route_with_the_dial_over_a_spatial_mesh(ranks):
    """route_hard(..., lowres=every branch) through make_spatial_infer: every
    rank routes as the unsharded route does (each branch serves an image),
    and the shards join into its output within the port's fp32 bound (the
    guided lift's integral images sum in another order on a shard)."""
    for out in ranks:
        assert out["route"]["labels"] == [0, 1, 2, 0]
        assert out["route"]["sharded_labels"] == out["route"]["labels"]
    got = torch.cat([out["route"]["sharded"] for out in ranks], 1)
    assert _err(got, ranks[0]["route"]["whole"]) <= ATOL


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_resize_on_h_shards_equals_the_unsharded_resize(ranks, name):
    """Each mode on 2 H shards of 4 rows: the shards' rows joined along H are
    the unsharded op's, bit for bit where the op is the identity along H."""
    got = _joined(ranks, "resizes", name, dim=2)
    want = ranks[0]["resizes"][name]["whole"]
    if RESIZES[name][1]:
        assert got.shape == want.shape and torch.equal(got, want), name
    else:
        assert _err(got, want) <= RESIZE_ATOL, name


@pytest.mark.parametrize("name", GRAD_RESIZES)
def test_resize_gradient_matches_autograd_of_the_unsharded_resize(ranks, name):
    for out in ranks:
        got, want = out["grads"][name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["avg_1x1", "max_1x1", "avg_whole_h", "max_whole_h"])
def test_adaptive_pool_on_h_shards_equals_the_unsharded_pool(ranks, name):
    """To 1 x 1 every rank holds the whole image's pool; to the whole image's
    H each rank holds its rows."""
    want = ranks[0]["pools"][name]["whole"]
    got = ([out["pools"][name]["sharded"] for out in ranks] if name.endswith("1x1")
           else [_joined(ranks, "pools", name, dim=2)])
    for g in got:
        assert _err(g, want) <= 1e-7, name


@pytest.mark.parametrize("name,kind,words", [
    ("bicubic", "NotImplementedError", ["'bicubic'", "bilinear", "nearest-exact"]),
    ("uneven_rows", "ValueError", ["3 rows", "image of 6", "2 equal H shards"]),
    ("adaptive_2x2", "NotImplementedError", ["2 x 2", "1 x 1"]),
    ("pad_of_h", "NotImplementedError", ["pad of H"]),
    ("strided_avg_pool", "NotImplementedError", ["stride 2", "VALID"])])
def test_what_stays_unported_raises_naming_it(ranks, name, kind, words):
    for out in ranks:
        got = out["refusals"][name]
        assert got is not None and got[0] == kind, got
        for word in words:
            assert word in got[1], got
