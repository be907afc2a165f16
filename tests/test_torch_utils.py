"""The port's utils and the rest of its preprocessing against the JAX
package's, on the CPU:

- utils/helpers.py: count_params and calculate_model_size equal JAX's on
  the same router's weights (carried over), seed_everything repeats its
  draws, and the timing, memory, layout and cast helpers;
- utils/profiling.py: trace writes a Chrome trace, benchmark and
  model_flops count, device_flops_estimate knows the H100 only;
- utils/visualize.py: the six figures are written;
- data/synthetic.py:create_progressive_test_set within one grey level of
  JAX's PNGs, the same file names;
- data/preprocessing.py: resize_and_normalize and split_dataset equal
  JAX's, preprocess_dataset within one grey level.
"""
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.data import preprocessing as JP
from adam_dehaze_tpu.data import synthetic as JS
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu.utils import helpers as JH
from adam_dehaze_tpu_torch.data import preprocessing as PP
from adam_dehaze_tpu_torch.data import synthetic as PS
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.utils import helpers as PH
from adam_dehaze_tpu_torch.utils import profiling as PR
from adam_dehaze_tpu_torch.utils import visualize as PV
from torch_port_util import images, joint_configs, one_torch_thread, port_of

# The port's ops run on one thread in this module (see one_torch_thread).
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _read(path):
    import cv2
    return cv2.imread(path).astype(np.int16)


@pytest.fixture(scope="module")
def routers():
    """The JAX router's params (zeros on the shapes of its init) and the
    port's router filled from them."""
    jcfg, pcfg = joint_configs("soft")
    jr = JR.create_router(JB.create_branch_models(jcfg), JC.create_classifier(jcfg), jcfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jr.init, {"params": key, "dropout": key},
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    vs = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), dict(shapes))
    port = port_of(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg), vs)
    return vs, port


@pytest.mark.parametrize("part", ["router", "low", "medium", "high", "classifier"])
def test_count_params_and_size_equal_jax(routers, part):
    vs, port = routers
    if part == "router":
        tree, module = vs["params"], port
    elif part == "classifier":
        tree, module = vs["params"]["classifier"], port.classifier
    else:
        tree, module = vs["params"][f"models_{part}"], port.models[part]
    assert PH.count_params(module) == JH.count_params(tree) > 0
    assert PH.calculate_model_size(module) == pytest.approx(JH.calculate_model_size(tree),
                                                            rel=1e-12)
    info = PH.model_info(module)
    assert info["params"] == info["trainable_params"] == JH.count_params(tree)
    assert info["model_type"] == type(module).__name__


def test_seed_everything_repeats_draws():
    def draws():
        gen = PH.seed_everything(7)
        return (random.random(), np.random.rand(), torch.rand(3).tolist(),
                torch.rand(3, generator=gen).tolist())
    a, b = draws(), draws()
    assert a == b
    assert PH.seed_everything(8).initial_seed() == 8


def test_timing_memory_layout_and_cast_helpers():
    x = torch.rand(4, 8)
    t = PH.calculate_inference_time(lambda v: v @ v.T, x, n_warmup=1, n_samples=3,
                                    device="cpu")
    assert t > 0
    b = PR.benchmark(lambda v: v * 2, x, n_warmup=1, n_iters=2)
    assert b["items_per_sec"] > 0 and b["ms_per_item"] > 0
    if not torch.cuda.is_available():
        assert PH.get_device_memory_usage() is None
    a = np.zeros((2, 3, 5, 7))
    assert PH.to_nhwc(a).shape == (2, 5, 7, 3) and PH.to_nhwc(a[0]).shape == (5, 7, 3)
    m = PH.module_cast(torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.BatchNorm1d(2)),
                       torch.float64)
    assert {p.dtype for p in m.parameters()} == {torch.float64}
    assert m[1].num_batches_tracked.dtype == torch.int64


def test_model_flops_counts_a_conv():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    flops = PR.model_flops(conv, torch.rand(1, 3, 16, 16))
    assert flops == 2 * 16 * 16 * 3 * 8 * 9


def test_device_flops_estimate_knows_the_h100_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert PR.device_flops_estimate() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other Card")
    with pytest.raises(ValueError, match="no peak known"):
        PR.device_flops_estimate()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PR.device_flops_estimate()


def test_trace_writes_a_chrome_trace(tmp_path):
    with PR.trace(str(tmp_path / "trace")):
        torch.rand(16, 16) @ torch.rand(16, 16)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_enable_debug_checks_turns_on_anomaly_detection():
    try:
        PR.enable_debug_checks()
        assert torch.is_anomaly_enabled()
    finally:
        PR.enable_debug_checks(nans=False, sync="default")
    assert not torch.is_anomaly_enabled()


def test_visualizers_write_their_files(tmp_path):
    imgs = images((2, 16, 16, 3))
    paths = {name: str(tmp_path / f"{name}.png")
             for name in ("cmp", "det", "route", "montage", "summary", "curves")}
    PV.visualize_comparison(imgs, imgs, imgs, paths["cmp"])
    PV.visualize_detections(imgs[0], {"boxes": np.array([[2, 2, 10, 10]]),
                                      "scores": np.array([0.9]), "labels": np.array([3])},
                            paths["det"])
    PV.visualize_routing_weights(np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]]), paths["route"])
    PV.visualize_montage(list(imgs), paths["montage"], ncols=2, titles=["a", "b"])
    PV.plot_summary_chart({"psnr": 24.0, "ssim": 0.9}, paths["summary"])
    jsonl = tmp_path / "metrics.jsonl"
    with open(jsonl, "w") as f:
        for step in range(3):
            f.write(json.dumps({"step": step, "train/loss": 1.0 / (step + 1),
                                "val/loss": 2.0 / (step + 1)}) + "\n")
    PV.plot_training_curves(str(jsonl), paths["curves"])
    for p in paths.values():
        assert os.path.getsize(p) > 500, p


def _write_images(directory, n, size, seed, ext=".png"):
    import cv2
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = (rng.random((size, size + 3, 3)) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(directory, f"img{i}{ext}"), img)


def test_create_progressive_test_set_matches_jax(tmp_path):
    src = str(tmp_path / "clear")
    _write_images(src, 2, 20, seed=0)
    _write_images(src, 1, 18, seed=1, ext=".jpg")
    nj = JS.create_progressive_test_set(src, str(tmp_path / "jax"), fog_levels=3)
    np_ = PS.create_progressive_test_set(src, str(tmp_path / "port"), fog_levels=3)
    assert nj == np_ == 9
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        diff = np.abs(_read(str(tmp_path / "jax" / name)) - _read(str(tmp_path / "port" / name)))
        assert diff.max() <= 1, name


def test_resize_and_normalize_equals_jax():
    rng = np.random.default_rng(2)
    u8 = (rng.random((20, 24, 3)) * 255).astype(np.uint8)
    for img, size in ((u8, 16), (u8, 20), (u8[:16, :16], 16), (u8.astype(np.float32) / 255, 12)):
        np.testing.assert_array_equal(PP.resize_and_normalize(img, size),
                                      JP.resize_and_normalize(img, size))


def _raw_tree(raw, n=7, size=20):
    for i, level in enumerate(("low", "medium", "high")):
        for role in ("hazy", "clear", "dehazed"):
            _write_images(os.path.join(raw, level, role), n, size, seed=10 * i)
    os.remove(os.path.join(raw, "high", "dehazed", "img0.png"))   # an incomplete triplet


def test_preprocess_and_split_match_jax(tmp_path):
    raw = str(tmp_path / "raw")
    _raw_tree(raw)
    trees = {}
    for tag, mod in (("jax", JP), ("port", PP)):
        out = str(tmp_path / tag)
        n = mod.preprocess_dataset(raw, out, size=16)
        counts = mod.split_dataset(out, seed=3)
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, fs in os.walk(out) for f in fs)
        trees[tag] = (n, counts, files)
    assert trees["port"][:2] == trees["jax"][:2] == (20, {"train": 12, "val": 2, "test": 6})
    assert trees["port"][2] == trees["jax"][2]
    for rel in trees["jax"][2]:
        diff = np.abs(_read(str(tmp_path / "jax" / rel)) - _read(str(tmp_path / "port" / rel)))
        assert diff.max() <= 1, rel
