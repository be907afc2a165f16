"""The port's parallel/ against the JAX package's.

One gloo group of two processes (tests/torch_parallel_worker.py) is spawned
once for the module, at its start, and runs every case that needs a group:
the metric means, the per-host loader under a real group, the mesh's
groups, `replicate`, the data-parallel steps and the checkpoint written
from both ranks. While it runs, this process computes the JAX references
(the workers import no JAX) and the single-process cases:

- `make_mesh`'s sizes and errors against JAX's for 1 to 8 devices;
- the loaders' per-host shards, with the port's rank helpers patched where
  tests/test_multihost_proc.py patches jax.process_index/process_count;
- `split_devices`, `ExpertParallelRouter` and `TwoStagePipeline` against
  the JAX classes on the same weights (tests/test_parallel.py's and
  tests/test_pipeline_parallel.py's fixtures and tolerances).

The data-parallel step is held against JAX's `shard_train_step` on a
`data: 2` mesh of this process's virtual devices: the two-conv model of
tests/test_parallel.py in float32 (rtol 1e-5, atol 1e-6), and the low
branch with train-mode BN in float64 (1e-4 on parameters and BN
statistics), where the same step with each process's own BN statistics
must fail that bound. The joint step with augmentation and dropout on 2
ranks is held against the port's own single-process step on the global
batch with the same seed, in float64 at 1e-6.
"""
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models.branches import LightweightDehazeModel as JLow
from adam_dehaze_tpu.parallel import data_parallel as jdp
from adam_dehaze_tpu.parallel import expert_parallel as jep
from adam_dehaze_tpu.parallel import mesh as jmesh
from adam_dehaze_tpu.parallel import pipeline as jpipe
from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel as PLow
from adam_dehaze_tpu_torch.parallel import data_parallel as pdp
from adam_dehaze_tpu_torch.parallel import expert_parallel as pep
from adam_dehaze_tpu_torch.parallel import mesh as pmesh
from adam_dehaze_tpu_torch.parallel import multihost as pmh
from adam_dehaze_tpu_torch.parallel import pipeline as ppipe
from torch_port_util import (
    as64,
    images,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    port_of,
    seeded_variables,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120
MEANS = (0.25, 1.75)
LR = 0.1
# The low branch's BN step: parameters and statistics within 1e-4 of the
# JAX step in float64 (JAX float32 is not ground truth for train-mode BN).
BN_STEP_ATOL = 1e-4
# The joint step, data-parallel against single-process, both the port in
# float64 (its branches hand float32 images to the loss).
JOINT_ATOL = 1e-6


def _conv_init():
    from flax import linen as nn

    class TinyConv(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Conv(8, (3, 3), padding=((1, 1), (1, 1)))(x)
            x = nn.relu(x)
            return nn.Conv(3, (3, 3), padding=((1, 1), (1, 1)))(x)

    model = TinyConv()
    return model, seeded_variables(lambda: model.init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 16, 16, 3))), 1)


def _low_vars():
    model = JLow(base_channels=4, n_blocks=1)
    return seeded_variables(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 16, 16, 3)), False), 2)


def _conv_torch(params):
    """flax's two-conv params as TinyConv's (tests/torch_parallel_worker.py)."""
    out = {}
    for i in (0, 1):
        p = params[f"Conv_{i}"]
        out[f"c{i}.weight"] = torch.from_numpy(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
                                               .copy())
        out[f"c{i}.bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).copy())


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The two ranks, started with the module's first test (the cases
    below run while they work), and their inputs."""
    from adam_dehaze_tpu.data.preprocessing import generate_synthetic_dataset
    tmp = tmp_path_factory.mktemp("parallel")
    corpus = str(tmp / "corpus")
    generate_synthetic_dataset(corpus, n_per_class=4, size=16, seed=0)
    _, conv_vars = _conv_init()
    inputs = {"means": MEANS, "corpus": corpus,
              "conv_params": _conv_torch(conv_vars["params"]),
              "conv_x": torch.from_numpy(images((8, 16, 16, 3), seed=3)),
              "conv_y": torch.from_numpy(images((8, 16, 16, 3), seed=4)),
              "low_vars": _tensors(_low_vars()),
              "low_x": torch.from_numpy(images((4, 16, 16, 3), seed=5).astype(np.float64)),
              "low_y": torch.from_numpy(images((4, 16, 16, 3), seed=6).astype(np.float64))}
    torch.save(inputs, tmp / "inputs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                           "torch_parallel_worker.py"),
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
            pytest.fail(f"a parallel worker ran over {WORKER_TIMEOUT_S} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


# ------------------------------------------------------------ one process ---

_SIZES = [None, {"data": 0}, {"data": 0, "spatial": 2}, {"data": 0, "spatial": 2, "model": 2},
          {"data": 2, "spatial": 0}, {"data": 3, "spatial": 1, "model": 1},
          {"data": 0, "spatial": 0}, {"spatial": 4}, {"data": 1, "spatial": 2, "model": 4}]


@pytest.mark.parametrize("sizes", _SIZES, ids=[str(s) for s in _SIZES])
def test_make_mesh_sizes_match_jax(sizes):
    """Shapes and errors of make_mesh over 1 to 8 devices, as JAX's
    make_mesh over that many of this process's virtual devices."""
    for n in range(1, 9):
        try:
            want = dict(jmesh.make_mesh(sizes, jax.devices()[:n]).shape)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                pmesh.make_mesh(sizes, ["cpu"] * n)
            continue
        assert pmesh.make_mesh(sizes, ["cpu"] * n).shape == want == pmesh.mesh_shape(sizes, n)


def test_mesh_without_a_group():
    """One process, no group: the mesh over the devices given, with no
    process group; the config's default; the batch's NHWC spec."""
    from adam_dehaze_tpu_torch.config import load_config
    mesh = pmesh.mesh_from_config(load_config(), ["cpu"] * 2)
    assert mesh.shape == {"data": 2, "spatial": 1, "model": 1}
    assert mesh.group("data") is None and mesh.coordinate("data") == 0
    assert mesh.device == torch.device("cpu")
    assert pmesh.make_mesh().device == torch.device("cuda")
    assert pmesh.batch_spec() == tuple(jmesh.batch_spec())
    x = torch.arange(8.0).reshape(2, 2, 2, 1)
    sharded = pmesh.shard_batch(pmesh.make_mesh(None, ["cpu"]), {"x": x.numpy(), "name": ["a"]})
    assert torch.equal(sharded["x"], x) and sharded["name"] == ["a"]
    model = torch.nn.Linear(2, 2)
    assert pmesh.replicate(mesh, model) is model


def test_single_process_helpers():
    """Without a group: initialize does nothing, the means are `float` of
    their values, the host slice is the whole batch."""
    info = pmh.initialize(num_processes=1, device="cpu")
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert not torch.distributed.is_initialized()
    assert pmh.all_hosts_mean(np.float32(0.5)) == 0.5
    tree = pmh.all_hosts_mean_tree({"a": torch.tensor(2.0), "b": [np.float64(1.5), (3,)]})
    assert tree == {"a": 2.0, "b": [1.5, (3.0,)]}
    assert all(type(v) is float for v in (tree["a"], tree["b"][0], tree["b"][1][0]))
    assert pmh.host_data_slice(8) == slice(0, 8)


def test_step_refuses_the_axes_of_the_next_slice_and_data_without_a_group():
    """The spatial and model axes are ported (tests/test_torch_spatial.py):
    like the data axis, above 1 they need a process group."""
    def step(state, batch, generator=None):
        return {}

    batch = {"x": torch.zeros(4, 8, 8, 3)}
    for sizes in ({"data": 1, "spatial": 2}, {"data": 1, "model": 2}):
        mesh = pmesh.make_mesh(sizes, ["cpu"] * 2)
        for wrap in (pdp.shard_train_step, pdp.shard_eval_step):
            with pytest.raises(ValueError, match="process group"):
                wrap(step, mesh, batch)
    with pytest.raises(ValueError, match="process group"):
        pdp.shard_train_step(step, pmesh.make_mesh({"data": 2}, ["cpu"] * 2), batch)
    assert pdp.shard_train_step(step, pmesh.make_mesh(None, ["cpu"]), batch) is step


def test_draw_rows_outside_and_inside_a_step():
    """Outside a data-parallel step a draw is the plain draw; inside, the
    draw of the global batch cut to this process's rows."""
    gen = torch.Generator().manual_seed(0)
    want = torch.rand(6, generator=torch.Generator().manual_seed(0))
    assert torch.equal(pdp.rand_rows(6, gen, "cpu"), want)
    token = pdp._ROWS.set(pdp._Rows(6, 2, 4))
    try:
        assert torch.equal(pdp.rand_rows(2, torch.Generator().manual_seed(0), "cpu"), want[2:4])
        with pytest.raises(ValueError, match="rows"):
            pdp.rand_rows(3, gen, "cpu")
    finally:
        pdp._ROWS.reset(token)


def _patch_ranks(monkeypatch, pid):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: pid)
    monkeypatch.setattr(pmh, "process_count", lambda: 2)
    monkeypatch.setattr(pmh, "process_index", lambda: pid)


def _assert_loader_equal(got, want):
    assert got.dataset.indices == want.dataset.indices
    assert got.seed == want.seed and got.batch_size == want.batch_size
    assert got.shuffle == want.shuffle and got.drop_remainder == want.drop_remainder
    gb, wb = list(got), list(want)
    assert len(gb) == len(wb) > 0
    for g, w in zip(gb, wb):
        assert g["name"] == w["name"]
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("pid", [0, 1])
def test_loaders_are_host_sharded_as_jax(spawned, tmp_path_factory, monkeypatch, pid):
    """get_dataloader and get_detection_dataloader under a simulated rank
    of two: the strided shard, its shuffle order and seed, and its batches
    equal the JAX package's; shard_per_host=False keeps the whole split."""
    from adam_dehaze_tpu.config import default_config
    from adam_dehaze_tpu.data import dataset as jds
    from adam_dehaze_tpu.data import detection as jdet
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.data import dataset as pds
    from adam_dehaze_tpu_torch.data import detection as pdet
    from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus
    det = str(tmp_path_factory.getbasetemp() / "parallel_det_corpus")
    if not os.path.isdir(det):
        make_corpus(det, 32, 6, 2, 3, seed=1)
    _patch_ranks(monkeypatch, pid)
    jcfg, pcfg = default_config(), load_config()
    for cfg, root in ((jcfg, spawned[2]["corpus"]), (pcfg, spawned[2]["corpus"])):
        cfg["dataset"].update(train_path=root, val_path=root, test_path=root, img_size=16,
                              batch_size=2, num_workers=1)
        cfg["seed"] = 3
    for split in ("train", "test"):
        _assert_loader_equal(pds.get_dataloader(pcfg, split), jds.get_dataloader(jcfg, split))
    whole = pds.get_dataloader(pcfg, "train", shard_per_host=False)
    assert len(whole.dataset) == len(jds.get_dataloader(jcfg, "train",
                                                         shard_per_host=False).dataset)
    for cfg in (jcfg, pcfg):
        cfg["dataset"].update(train_path=det, test_path=det, batch_size=4)
    for kw in (dict(split="test", img_size=32),
               dict(split="train", img_size=32, image_source="clear", augment=True,
                    shuffle=True)):
        _assert_loader_equal(pdet.get_detection_dataloader(pcfg, **kw),
                             jdet.get_detection_dataloader(jcfg, **kw))


@pytest.mark.parametrize("n", range(1, 9))
def test_split_devices_matches_jax(n):
    assert pep.split_devices(list(range(n)), 3) == jep.split_devices(list(range(n)), 3)


@pytest.fixture(scope="module")
def branch_pair():
    """tests/test_parallel.py's three low branches (c = 4, 6, 8, 1 block),
    seeded, in both packages, and its fake classifier in both."""
    widths = {"low": 4, "medium": 6, "high": 8}
    jmods = {lvl: JLow(base_channels=c, n_blocks=1) for lvl, c in widths.items()}
    x0 = jnp.zeros((1, 16, 16, 3))
    jvars = {lvl: seeded_variables(lambda m=m: m.init(jax.random.PRNGKey(0), x0), i)
             for i, (lvl, m) in enumerate(jmods.items())}
    pmods = {lvl: port_of(PLow(c, 1), jvars[lvl]) for lvl, c in widths.items()}

    def jcls(img):
        b = img.mean(axis=(1, 2, 3))
        return jnp.stack([b, 2 * b, 3 * b], axis=1) * 5, None

    def pcls(img):
        b = img.mean(dim=(1, 2, 3))
        return torch.stack([b, 2 * b, 3 * b], dim=1) * 5, None

    return jmods, jvars, pmods, jcls, pcls


@pytest.mark.parametrize("n", [3, 8])
def test_expert_parallel_router_matches_jax(branch_pair, n):
    jmods, jvars, pmods, jcls, pcls = branch_pair
    x = images((4, 16, 16, 3), seed=7)
    want, jinfo = jep.ExpertParallelRouter(jmods, jvars, jcls, temperature=0.5,
                                           devices=jax.devices()[:n])(jnp.asarray(x))
    router = pep.ExpertParallelRouter(pmods, pcls, temperature=0.5, devices=["cpu"] * n)
    assert [len(router.groups[lvl]) for lvl in pep.INTENSITY_ORDER] == \
        [len(g) for g in jep.split_devices(jax.devices()[:n], 3)]
    got, info = router(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(info["weights"].numpy(), np.asarray(jinfo["weights"]),
                               rtol=1e-5, atol=1e-6)
    for lvl in pep.INTENSITY_ORDER:
        np.testing.assert_allclose(info["individual_outputs"][lvl].numpy(),
                                   np.asarray(jinfo["individual_outputs"][lvl]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [3, 8])
def test_two_stage_pipeline_matches_jax(branch_pair, n):
    jmods, jvars, pmods, jcls, pcls = branch_pair
    levels = pep.INTENSITY_ORDER
    japplies = [lambda img, m=jmods[lvl], v=jvars[lvl]: m.apply(v, img) for lvl in levels]
    jp = jpipe.TwoStagePipeline(jcls, japplies, temperature=0.5, devices=jax.devices()[:n])
    pp = ppipe.TwoStagePipeline(pcls, [pmods[lvl] for lvl in levels], temperature=0.5,
                                devices=["cpu"] * n)
    assert (len(pp.stage_a), len(pp.stage_b)) == (len(jp.stage_a), len(jp.stage_b))
    batches = [images((2, 16, 16, 3), seed=10 + i) for i in range(4)]
    want = list(jp.run([jnp.asarray(b) for b in batches]))
    got = list(pp.run(torch.from_numpy(b) for b in batches))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp(batches[0]).numpy(), got[0].numpy(), rtol=1e-6, atol=1e-7)


def test_entry_points_default_to_cuda_devices(monkeypatch):
    """Without `devices`, the router and the pipeline take the visible
    CUDA devices, never the CPU: with none visible they refuse."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="CUDA"):
        pep.split_devices()
    with pytest.raises(ValueError, match="CUDA"):
        ppipe.TwoStagePipeline(lambda x: (x, None), [])


# ------------------------------------------------------ the JAX references ---

def _jax_sgd_step(model, train):
    def step(variables, batch, _key):
        def loss(params):
            vs = {**variables, "params": params}
            if train:
                out, upd = model.apply(vs, batch["x"], True, mutable=["batch_stats"])
            else:
                out, upd = model.apply(vs, batch["x"]), {}
            return jnp.mean((out - batch["y"]) ** 2), upd
        (_, upd), g = jax.value_and_grad(loss, has_aux=True)(variables["params"])
        new = jax.tree_util.tree_map(lambda p, gg: p - LR * gg, variables["params"], g)
        return {**variables, **upd, "params": new}, None
    return step


def _jax_dp_step(model, variables, batch, train):
    mesh = jmesh.make_mesh({"data": 2, "spatial": 1, "model": 1}, jax.devices()[:2])
    step = jdp.shard_train_step(_jax_sgd_step(model, train), mesh, batch)
    return step(variables, batch, jax.random.PRNGKey(0))[0]


@pytest.fixture(scope="module")
def jax_conv_step(spawned):
    model, variables = _conv_init()
    inputs = spawned[2]
    batch = {"x": jnp.asarray(inputs["conv_x"].numpy()), "y": jnp.asarray(inputs["conv_y"].numpy())}
    return _conv_torch(jax.tree_util.tree_map(np.asarray,
                                              _jax_dp_step(model, variables, batch, False)["params"]))


@pytest.fixture(scope="module")
def jax_low_step(spawned):
    """The JAX low-branch step in float64 on the data: 2 mesh, as port
    modules: (before, after)."""
    inputs = spawned[2]
    variables = _low_vars()
    with jax.enable_x64(True):
        model = JLow(base_channels=4, n_blocks=1, dtype=jnp.float64)
        batch = {"x": jnp.asarray(inputs["low_x"].numpy()),
                 "y": jnp.asarray(inputs["low_y"].numpy())}
        new = jax.tree_util.tree_map(np.asarray,
                                     _jax_dp_step(model, as64(variables), batch, True))
    return port_of(PLow(4, 1), variables).double(), port_of(PLow(4, 1), new).double()


def _low_error(got, before, after, n):
    """The port's low-branch step against JAX's: the largest difference of
    any parameter or BN statistic, with flax's running variance (biased
    batch variance) carried to torch's (unbiased, n per channel)."""
    want = after.state_dict()
    err = 0.0
    for k, v in got.items():
        w = want[k].double()
        if k.endswith("running_var"):
            old = before.state_dict()[k].double()
            w = 0.9 * old + 0.1 * (w - 0.9 * old) / 0.1 * n / (n - 1)
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k
            continue
        err = max(err, float((v.double() - w).abs().max()))
    return err


# ------------------------------------------------------- the two-rank group ---

def test_group_info_slices_and_means(ranks):
    for rank, out in enumerate(ranks):
        assert out["info"] == {"process_index": rank, "process_count": 2, "local_devices": 1,
                               "global_devices": 2}
        assert out["slice"] == slice(4 * rank, 4 * rank + 4)
        assert abs(out["mean"] - np.mean(MEANS)) <= 1e-12
        t = out["tree"]
        assert abs(t["a"] - np.mean(MEANS)) <= 1e-12
        assert abs(t["b"][0] - np.mean([2 * m for m in MEANS])) <= 1e-12
        assert t["b"][1] == (0.5,)


def test_loader_shards_under_the_group(ranks):
    n = ranks[0]["whole"]
    for rank, out in enumerate(ranks):
        assert out["loader"]["indices"] == list(range(rank, n, 2))
        assert out["loader"]["seed"] == 1000 * rank
    names = ranks[0]["loader"]["names"] + ranks[1]["loader"]["names"]
    # Batches of 2 with the remainder dropped, on each rank's shard.
    assert len(set(names)) == len(names) == sum(len(range(r, n, 2)) // 2 * 2 for r in (0, 1))


def test_mesh_groups_and_replicate(ranks):
    for rank, out in enumerate(ranks):
        assert out["mesh"] == {"shape": {"data": 2, "spatial": 1, "model": 1}, "data": rank,
                               "ranks": [0, 1]}
        assert torch.equal(out["replicated"], torch.ones(2, 3))


def test_data_parallel_conv_step_matches_jax(ranks, jax_conv_step):
    for out in ranks:
        for k, want in jax_conv_step.items():
            np.testing.assert_allclose(out["conv"]["params"][k].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_data_parallel_bn_step_matches_jax(ranks, jax_low_step):
    """Parameters and BN statistics within 1e-4 of JAX's sharded step; the
    control (each process's own BN statistics) is not."""
    before, after = jax_low_step
    n = 4 * 16 * 16
    for out in ranks:
        assert _low_error(out["low"], before, after, n) <= BN_STEP_ATOL
        assert _low_error(out["low_per_process_bn"], before, after, n) > BN_STEP_ATOL


def _assert_close(got, want, what):
    assert set(got) == set(want), what
    scale = max(float(v.double().abs().max()) for v in want.values()) or 1.0
    for k, v in want.items():
        err = float((got[k].double() - v.double()).abs().max())
        assert err <= JOINT_ATOL * scale, f"{what} {k}: {err:.3e}"


def test_data_parallel_joint_step_matches_the_global_step(ranks):
    """Augmentation and dropout drawn for the global batch, BN over it, the
    gradients averaged: the 2-rank joint step equals the single-process
    step on the 4 images with the same seed (loss, every gradient, the BN
    statistics), and both ranks hold the same result."""
    single = ranks[0]["joint"]["single"]
    for out in ranks:
        dp = out["joint"]["dp"]
        _assert_close(dp["metrics"], single["metrics"], "metric")
        _assert_close(dp["grads"], single["grads"], "gradient")
        _assert_close({k: v for k, v in dp["stats"].items() if "running" in k},
                      {k: v for k, v in single["stats"].items() if "running" in k}, "BN")
        for k, v in single["stats"].items():
            if "num_batches" in k:
                assert torch.equal(dp["stats"][k], v), k
    assert any(k.startswith("classifier.") for k in single["stats"])


def test_data_parallel_eval_step_matches_the_global_step(ranks):
    want = ranks[0]["joint"]["single_eval"]
    for out in ranks:
        got = out["joint"]["dp_eval"]
        assert set(got) == set(want)
        assert int(got["n"]) == int(want["n"]) == 4
        for k in ("loss", "psnr", "ssim", "cls_acc", "dehazed"):
            np.testing.assert_allclose(got[k].double().numpy(), want[k].double().numpy(),
                                       rtol=0, atol=JOINT_ATOL, err_msg=k)


def test_checkpoint_from_both_ranks_is_one_file(ranks):
    for out in ranks:
        assert out["ckpt"]["files"] == ["both.metrics.json", "both.pth"]
        state, metrics = out["ckpt"]["read"]
        assert int(state["rank"]) == 0 and metrics == {"m": 0.0}


def test_best_checkpoint_is_decided_on_process_zero(ranks):
    """The joint trainer with validations that differ per process: both
    processes save the best checkpoint when process 0's PSNR improves (a
    decision on each process's own would leave one in the save's barrier,
    and the worker would run out of time)."""
    for out in ranks:
        assert out["best_decision"]["saves"] == [("best_model", 1), ("best_model", 2)]
        assert out["best_decision"]["best"]["val_psnr"] == 12.0
