"""The port's COCO evaluation and metric accumulators against the JAX
package's, on the CPU:

- COCOEvaluator (native matcher and Python matcher) against the frozen
  fixture tests/fixtures/coco_golden.json and the loop-based oracle
  tests/coco_oracle.py, and against the JAX evaluator on fuzzed scenes: all
  12 stats within 1e-9;
- the native matcher (native/coco_match.cpp, built under build/native/)
  against `_match_image_py`, and a failed build that raises;
- DetectionMetrics.evaluate_by_category, calculate_image_metrics,
  ImageQualityMetrics and calculate_perceptual_scores against the JAX
  functions on the same inputs and weights.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))

import coco_oracle  # noqa: E402
from make_coco_golden import make_scene  # noqa: E402

from adam_dehaze_tpu.evaluation import coco_eval as JE  # noqa: E402
from adam_dehaze_tpu.evaluation import metrics as JM  # noqa: E402
from adam_dehaze_tpu_torch.evaluation import coco_eval as PE  # noqa: E402
from adam_dehaze_tpu_torch.evaluation import metrics as PM  # noqa: E402
from torch_port_util import port_of  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "coco_golden.json")
KEYS = ["mAP", "mAP_50", "mAP_75", "mAP_small", "mAP_medium", "mAP_large",
        "AR_1", "AR_10", "AR_100", "AR_small", "AR_medium", "AR_large"]


def assert_stats_equal(got, want, atol=1e-9):
    assert set(got) == set(KEYS)
    for k in KEYS:
        assert got[k] == pytest.approx(want[k], abs=atol), (k, got[k], want[k])


@pytest.mark.parametrize("matcher", ["native", "python"])
def test_evaluator_matches_golden_and_oracle(matcher):
    with open(FIXTURE) as f:
        fx = json.load(f)
    ev = PE.COCOEvaluator(fx["gt"], matcher=matcher)
    assert ev.matcher == matcher
    assert_stats_equal(ev.evaluate(fx["results"]), fx["stats"])
    gt, results = make_scene(23)
    assert_stats_equal(PE.COCOEvaluator(gt, matcher=matcher).evaluate(results),
                       coco_oracle.evaluate(gt, results))


@pytest.mark.parametrize("seed", [3, 11, 31])
def test_evaluator_matches_jax_on_fuzzed_scenes(seed):
    """Jittered, duplicated and dropped detections over crowds and every
    size bin, and a subset of the categories."""
    gt, results = make_scene(seed)
    rng = np.random.default_rng(seed)
    results = [r for r in results if rng.random() < 0.85]
    for r in results:
        r["score"] = float(np.clip(r["score"] + rng.normal(0, 0.05), 0, 1))
    assert_stats_equal(PE.COCOEvaluator(gt).evaluate(results),
                       JE.COCOEvaluator(gt).evaluate(results))
    sub = [r for r in results if r["category_id"] != 2]
    assert_stats_equal(PE.COCOEvaluator(gt).evaluate(sub), JE.COCOEvaluator(gt).evaluate(sub))


def test_native_matcher_matches_python():
    rng = np.random.default_rng(0)
    for trial in range(40):
        n_det, n_gt = int(rng.integers(0, 15)), int(rng.integers(0, 10))
        ious = rng.random((n_det, n_gt))
        scores = rng.random(n_det)
        gt_ig, gt_cr = rng.random(n_gt) < 0.3, rng.random(n_gt) < 0.2
        a = PE._match_image_py(scores, ious, gt_ig, gt_cr, 10)
        b = PE._match_image_native(scores, ious, gt_ig, gt_cr, 10)
        c = JE._match_image_py(scores, ious, gt_ig, gt_cr, 10)
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y, err_msg=f"trial {trial}")
            np.testing.assert_array_equal(x, z, err_msg=f"trial {trial}")
    built = list(PE.BUILD_ROOT.glob("*/libcocomatch.so"))
    assert built, "the matcher is not under build/native/"


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a matcher that does not compile raises."""
    bad = tmp_path / "coco_match.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(PE, "NATIVE_SOURCE", bad)
    monkeypatch.setattr(PE, "BUILD_ROOT", tmp_path / "build")
    PE.native_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="building the COCO matcher failed"):
            PE.COCOEvaluator({"images": [{"id": 1}], "annotations": [
                {"id": 1, "image_id": 1, "category_id": 1, "bbox": [0, 0, 10, 10]}],
                "categories": [{"id": 1}]}).evaluate(
                [{"image_id": 1, "category_id": 1, "bbox": [0, 0, 10, 10], "score": 0.9}])
    finally:
        PE.native_library.cache_clear()


def test_detection_metrics_by_category_matches_jax(tmp_path):
    gt, results = make_scene(5)
    path = str(tmp_path / "gt.json")
    with open(path, "w") as f:
        json.dump(gt, f)
    pm, jm = PM.DetectionMetrics(path), JM.DetectionMetrics(gt)
    cats = ("low_intensity", "medium_intensity", "high_intensity")
    for r in results:
        for m in (pm, jm):
            m.add_detection_result(r["image_id"], r["category_id"], r["bbox"], r["score"],
                                   category=cats[r["image_id"] % 3])
    got, want = pm.evaluate_by_category(), jm.evaluate_by_category()
    assert set(got) == set(want) == {"overall", *cats}
    for k in want:
        assert_stats_equal(got[k], want[k])
    assert PM.DetectionMetrics(gt).evaluate() == {}
    out = str(tmp_path / "res" / "det.json")
    pm.save_results(got, out)
    with open(out) as f:
        assert json.load(f)["overall"]["mAP"] == pytest.approx(got["overall"]["mAP"])


@pytest.fixture(scope="module")
def quality_pair():
    rng = np.random.default_rng(0)
    a = rng.random((4, 32, 32, 3), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_calculate_image_metrics_matches_jax(quality_pair):
    a, b = quality_pair
    got, want = PM.calculate_image_metrics(b[0], a[0]), JM.calculate_image_metrics(b[0], a[0])
    assert set(got) == {"psnr", "ssim"}
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-4)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-5)


def test_image_quality_metrics_matches_jax(quality_pair, tmp_path):
    """The same LPIPS weights (the JAX accumulator's seeded ones, carried
    over): per-category averages of PSNR, SSIM and LPIPS."""
    from adam_dehaze_tpu_torch.losses.lpips import LPIPS
    a, b = quality_pair
    jiq = JM.ImageQualityMetrics(image_shape=(1, 32, 32, 3))
    jiq = JM.ImageQualityMetrics(lpips_params=jiq.lpips_params)
    piq = PM.ImageQualityMetrics(lpips_net=port_of(LPIPS(), jax.tree_util.tree_map(
        np.asarray, dict(jiq.lpips_params))), device="cpu")
    assert piq.lpips_key == jiq.lpips_key == "lpips"
    mask = np.array([True, False])
    for iq in (jiq, piq):
        iq.add_batch(b[:2], a[:2], "low_intensity", mask=mask)
        iq.add_batch(b[2:], a[2:], "high_intensity")
        iq.add_sample(b[0], a[0])
    got, want = piq.compute_averages(), jiq.compute_averages()
    assert set(got) == set(want) == {"low_intensity", "high_intensity", "all"}
    for cat in want:
        assert got[cat]["samples"] == want[cat]["samples"]
        for k in ("psnr", "ssim", "lpips"):
            assert got[cat][k] == pytest.approx(want[cat][k], rel=1e-4, abs=1e-5), (cat, k)
    assert PM.ImageQualityMetrics(device="cpu").lpips_key == "lpips_uncal"
    piq.save_results(str(tmp_path / "m" / "iq.json"))
    with open(tmp_path / "m" / "iq.json") as f:
        assert json.load(f)["all"]["samples"] == 1


def test_perceptual_scores_match_jax(quality_pair):
    """Seeded VGG16 taps (the JAX net's weights carried over) on a fake
    dehazer's outputs, valid rows only."""
    from adam_dehaze_tpu.nn.vgg import VGG16Features as JVGG
    from adam_dehaze_tpu_torch.nn.vgg import VGG16Features
    a, b = quality_pair
    taps = ("relu2_2", "relu4_3")
    params = JVGG(taps=taps).init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    net = port_of(VGG16Features(taps=taps), jax.tree_util.tree_map(np.asarray, dict(params)))
    batches = [{"hazy": b[:2], "clear": a[:2], "mask": np.array([True, True])},
               {"hazy": b[2:], "clear": a[2:], "mask": np.array([True, False])}]
    want = JM.calculate_perceptual_scores(lambda x: (jnp.clip(x * 1.1, 0, 1), {}), batches,
                                          vgg_params=params)
    got = PM.calculate_perceptual_scores(lambda x: (torch.clamp(x * 1.1, 0, 1), {}), batches,
                                         vgg_net=net, device="cpu")
    assert got["samples"] == want["samples"] == 3
    for k in ("naturalness", "structure_similarity"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
