"""The port's detection data against the JAX package's, on the CPU:

- the corpus tool (adam_dehaze_tpu_torch/tools/make_synthetic_corpus.py)
  writes the same annotation JSONs, clear and dehazed PNGs as
  tools/make_synthetic_corpus.py for one seed and size; its hazy images
  agree with the JAX tool's within one level of 255 when they are given
  the JAX tool's fog draws (the two tools draw them from different
  generators);
- DetectionDataset / get_detection_dataloader batches on a corpus written
  by the JAX tool equal the JAX loader's: images within 1e-6, boxes,
  labels, n_boxes and names exactly; hazy evaluation batches (resized to
  48^2) and clear training batches with augmentation, shuffled, over 3
  epochs.
"""
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.config import default_config
from adam_dehaze_tpu.data import detection as JDD
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.data import detection as PDD
from adam_dehaze_tpu_torch.tools import make_synthetic_corpus as ptool

SEED, SIZE, COUNTS = 5, 64, (("train", 6), ("val", 2), ("test", 3))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(JAX tool's corpus, the port tool's corpus), same seed and size."""
    import importlib.util
    root = tmp_path_factory.mktemp("corpora")
    spec = importlib.util.spec_from_file_location(
        "jax_corpus_tool", os.path.join(os.path.dirname(__file__), "..", "tools",
                                        "make_synthetic_corpus.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    counts = [f"--{s}={n}" for s, n in COUNTS]
    jtool.main(["--out", str(root / "jax"), f"--size={SIZE}", f"--seed={SEED}", *counts])
    ptool.make_corpus(str(root / "port"), SIZE, *(n for _, n in COUNTS), seed=SEED)
    return str(root / "jax"), str(root / "port")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_corpus_tool_writes_the_jax_tools_layout_annotations_and_clear_images(corpora):
    jroot, proot = corpora
    assert _files(jroot) == _files(proot)
    n_png = 0
    for rel in _files(jroot):
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif "/hazy/" not in rel:
            assert np.array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(b, cv2.IMREAD_UNCHANGED)), rel
            n_png += 1
    assert n_png == 2 * 3 * sum(n for _, n in COUNTS)
    with open(os.path.join(proot, "annotations", "coco_high.json")) as f:
        coco = json.load(f)
    assert len(coco["images"]) == 3 and coco["annotations"]
    assert coco["categories"] == ptool.CATEGORIES


def test_corpus_tool_hazy_images_match_the_jax_tools_on_its_fog_draws(corpora):
    """The JAX tool's key sequence replayed: one split of the key per chunk
    of images, then (kb, ka) -> the beta and A uniforms."""
    jroot, _ = corpora
    rng = np.random.default_rng(SEED)
    key = jax.random.PRNGKey(SEED)
    worst = 0
    for split, n in COUNTS:
        for ci, level in enumerate(ptool.LEVELS):
            clear = np.stack([ptool.make_clear_scene(rng, SIZE)[0] for _ in range(n)])
            key, sub = jax.random.split(key)
            kb, ka = jax.random.split(sub)
            ub = torch.from_numpy(np.array(jax.random.uniform(kb, (n,))))
            ua = torch.from_numpy(np.array(jax.random.uniform(ka, (n,))))
            hazy = ptool.fog_with_margin(clear, ci, ub, ua, margin=0.15)
            for i in range(n):
                name = f"{split}_{level}_{i:04d}.png"
                want = cv2.imread(os.path.join(jroot, split, level, "hazy", name),
                                  cv2.IMREAD_UNCHANGED).astype(np.int16)
                got = (np.clip(hazy[i], 0, 1) * 255).astype(np.uint8).astype(np.int16)
                worst = max(worst, int(np.abs(got - want).max()))
    assert worst <= 1


def _configs(root):
    jcfg, pcfg = default_config(), load_config()
    for cfg in (jcfg, pcfg):
        cfg["dataset"].update(train_path=root, val_path=root, test_path=root,
                              batch_size=4, num_workers=2)
        cfg["seed"] = 3
    return jcfg, pcfg


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["hazy"], w["hazy"], rtol=0, atol=1e-6)
        for k in ("boxes", "labels", "n_boxes", "intensity", "mask"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["name"] == w["name"]


def test_detection_loader_matches_jax_on_hazy_test_batches(corpora):
    jcfg, pcfg = _configs(corpora[0])
    want = list(JDD.get_detection_dataloader(jcfg, "test", img_size=48, shard_per_host=False))
    got = list(PDD.get_detection_dataloader(pcfg, "test", img_size=48))
    assert got[0]["hazy"].shape == (2, 48, 48, 3) and got[0]["boxes"].shape == (2, 64, 4)
    assert int(got[0]["n_boxes"][0]) > 0
    _assert_batches_equal(got, want)


def test_detection_loader_matches_jax_with_augmentation_over_epochs(corpora):
    """Clear training frames, augmented and shuffled, three epochs (the
    trainer bumps `epoch` before each)."""
    jcfg, pcfg = _configs(corpora[0])
    kw = dict(img_size=SIZE, image_source="clear", augment=True, shuffle=True)
    jl = JDD.get_detection_dataloader(jcfg, "train", shard_per_host=False, **kw)
    pl = PDD.get_detection_dataloader(pcfg, "train", **kw)
    assert all(s["hazy"].split(os.sep)[-2] == "clear" for s in pl.dataset.samples)
    for epoch in range(3):
        jl.dataset.epoch = pl.dataset.epoch = epoch
        _assert_batches_equal(list(pl), list(jl))


def test_detection_dataset_shared_annotation_file(tmp_path):
    """A split without per-image files falls back to one instances.json;
    boxes rescale from the file's pixels to the detection resolution."""
    level_dir = tmp_path / "test" / "low" / "hazy"
    level_dir.mkdir(parents=True)
    cv2.imwrite(str(level_dir / "a.png"), np.full((40, 80, 3), 128, np.uint8))
    (tmp_path / "annotations").mkdir()
    (tmp_path / "annotations" / "instances.json").write_text(json.dumps(
        {"annotations": [{"bbox": [8, 4, 16, 20], "category_id": 3}]}))
    args = (str(tmp_path), str(tmp_path / "annotations"))
    got = PDD.DetectionDataset(*args, img_size=32, max_boxes=4).load(0)
    want = JDD.DetectionDataset(*args, img_size=32, max_boxes=4).load(0)
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    np.testing.assert_allclose(got["boxes"][0], [3.2, 3.2, 9.6, 19.2], rtol=1e-6)
    assert int(got["n_boxes"]) == 1 and got["labels"][0] == 3
    np.testing.assert_allclose(got["hazy"], want["hazy"], rtol=0, atol=1e-6)
