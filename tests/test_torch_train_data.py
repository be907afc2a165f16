"""The port's metrics and data pipeline against the JAX package, on the CPU:
PSNR/SSIM, the fog model and the DCP density map, the procedural scenes,
the PNG codec (against OpenCV), the u8 normalise stage, the dataset walk,
the loader's batch order and mask, and the augmentation at given
parameters. Inputs come from numpy seeds; tolerances: 1e-5 for f32 maps
and metrics, exact for integer data."""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.data import augment as jaug
from adam_dehaze_tpu.data import dataset as jds
from adam_dehaze_tpu.data import native_collate as jnc
from adam_dehaze_tpu.data import preprocessing as jpre
from adam_dehaze_tpu.data import synthetic as jsyn
from adam_dehaze_tpu.ops import image as jimg
from adam_dehaze_tpu_torch.data import augment as paug
from adam_dehaze_tpu_torch.data import dataset as pds
from adam_dehaze_tpu_torch.data import native_collate as pnc
from adam_dehaze_tpu_torch.data import preprocessing as ppre
from adam_dehaze_tpu_torch.data import synthetic as psyn
from adam_dehaze_tpu_torch.ops import image as pimg

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    target = rng.random((4, 32, 32, 3), dtype=np.float32)
    noise = rng.normal(0, 0.05, target.shape).astype(np.float32)
    pred = np.clip(target + noise, 0, 1).astype(np.float32)
    return pred, target


@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    """A corpus written by the JAX package (OpenCV PNGs)."""
    root = str(tmp_path_factory.mktemp("jax_corpus"))
    assert jpre.generate_synthetic_dataset(root, n_per_class=10, size=32, seed=0) == 30
    return root


# --------------------------------------------------------------- metrics ---

@pytest.mark.parametrize("fn", ["psnr", "ssim_gray"])
def test_metric_matches_jax(pairs, fn):
    pred, target = pairs
    _close(getattr(pimg, fn)(_t(pred), _t(target)),
           getattr(jimg, fn)(jnp.asarray(pred), jnp.asarray(target)))


def test_batch_quality_matches_jax(pairs):
    pred, target = pairs
    got = pimg.batch_quality(_t(pred), _t(target))
    want = jimg.batch_quality(jnp.asarray(pred), jnp.asarray(target))
    assert set(got) == set(want)
    for k in got:
        _close(got[k], want[k])


def _ssim_f64(a, b, win=7):
    """skimage's SSIM algorithm in float64 numpy on the channel mean."""
    from numpy.lib.stride_tricks import sliding_window_view
    x, y = a.astype(np.float64).mean(-1), b.astype(np.float64).mean(-1)

    def u(v):
        return sliding_window_view(v, (win, win), axis=(1, 2)).mean(axis=(-2, -1))

    cov = win * win / (win * win - 1)
    ux, uy = u(x), u(y)
    vx, vy, vxy = (cov * (u(x * x) - ux * ux), cov * (u(y * y) - uy * uy),
                   cov * (u(x * y) - ux * uy))
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean(axis=(1, 2))


def test_ssim_on_flat_and_identical_images():
    """The cancellation-prone cases, against float64: a flat image (variance
    0) and identical images give SSIM 1 to the last bit where they should.
    (The JAX program's 1/49-weighted convolution leaves uxx - ux^2 a few
    1e-8 off zero on a flat image: it reads 0.99998 for flat against flat
    and is 1.2e-5 off on flat against textured, so it is not the yardstick
    here.)"""
    flat = np.full((2, 16, 16, 3), 0.7, np.float32)
    img = np.random.default_rng(1).random((2, 16, 16, 3), dtype=np.float32)
    for a, b in ((flat, img), (img, flat), (img, img), (flat, flat)):
        got = pimg.ssim_gray(_t(a), _t(b))
        _close(got, _ssim_f64(a, b))
        assert float(got.max()) <= 1.0
    for a in (flat, img):
        np.testing.assert_array_equal(pimg.ssim_gray(_t(a), _t(a)).numpy(), np.ones(2))


def test_psnr_grayscale_and_data_range(pairs):
    pred, target = pairs
    g_p, g_t = pred.mean(-1), target.mean(-1)
    _close(pimg.psnr(_t(g_p), _t(g_t), 2.0), jimg.psnr(jnp.asarray(g_p), jnp.asarray(g_t), 2.0))


# ------------------------------------------------------------- fog model ---

def test_depth_map_and_apply_fog_match_jax():
    rng = np.random.default_rng(2)
    clear = rng.random((3, 24, 40, 3), dtype=np.float32)
    beta = np.array([0.15, 0.55, 0.95], np.float32)
    A = np.array([0.6, 0.8, 0.9], np.float32)
    _close(psyn._depth_map(24, 40), jsyn._depth_map(24, 40))
    _close(psyn.apply_fog(_t(clear), _t(beta), _t(A)),
           jsyn.apply_fog(jnp.asarray(clear), jnp.asarray(beta), jnp.asarray(A)))
    # Scalar parameters, as the progressive set passes them.
    _close(psyn.apply_fog(_t(clear), 0.4, 0.7), jsyn.apply_fog(jnp.asarray(clear), 0.4, 0.7))


@pytest.mark.parametrize("size,radius", [(15, 40), (3, 2), (7, 5)])
def test_min_and_box_filters_match_jax(size, radius):
    x = np.random.default_rng(size).random((2, 3, 29, 33), dtype=np.float32)
    _close(psyn._min_filter(_t(x), size), jsyn._min_filter(jnp.asarray(x), size))
    _close(psyn._box_filter(_t(x), radius), jsyn._box_filter(jnp.asarray(x), radius))


def test_guided_filter_transmission_and_density_match_jax():
    rng = np.random.default_rng(3)
    clear = rng.random((2, 48, 48, 3), dtype=np.float32)
    hazy = np.asarray(jsyn.apply_fog(jnp.asarray(clear), jnp.array([0.3, 0.9]),
                                     jnp.array([0.7, 0.95])))
    guide, src = hazy.mean(-1), rng.random((2, 48, 48), dtype=np.float32)
    _close(psyn.guided_filter(_t(guide), _t(src)), jsyn.guided_filter(guide, src))
    _close(psyn.estimate_transmission_dcp(_t(hazy)), jsyn.estimate_transmission_dcp(hazy))
    _close(psyn.fog_density_map(_t(hazy)), jsyn.fog_density_map(hazy))


def test_random_fog_params_in_class_ranges():
    gen = torch.Generator().manual_seed(0)
    labels = torch.tensor([0, 1, 2] * 100)
    beta, A = psyn.random_fog_params(gen, labels, 300)
    for i, name in enumerate(psyn.INTENSITY_NAMES):
        (b0, b1), (a0, a1) = psyn.INTENSITY_RANGES[name]
        sel = labels == i
        assert bool(((beta[sel] >= b0) & (beta[sel] <= b1)).all())
        assert bool(((A[sel] >= a0) & (A[sel] <= a1)).all())
    assert psyn.INTENSITY_RANGES == jsyn.INTENSITY_RANGES
    hazy = psyn.apply_random_fog(gen, torch.rand(300, 8, 8, 3, generator=gen), labels)
    assert hazy.shape == (300, 8, 8, 3) and 0 <= float(hazy.min()) <= float(hazy.max()) <= 1


def test_boundary_fog_params_keep_labels_and_weight_the_edges():
    """As the JAX test holds its draw: labels stay exact, and about
    boundary_frac of the draws land in the margin strips."""
    gen = torch.Generator().manual_seed(1)
    labels = torch.tensor([0, 1, 2] * 2000)
    beta, _ = psyn.boundary_fog_params(gen, labels, labels.numel(), boundary_frac=0.5,
                                       margin=0.08)
    edges = {0: [(0.32, 0.4)], 1: [(0.4, 0.48), (0.62, 0.7)], 2: [(0.7, 0.78)]}
    for c, strips in edges.items():
        b = beta[labels == c]
        lo, hi = psyn.INTENSITY_RANGES[psyn.INTENSITY_NAMES[c]][0]
        assert bool(((b >= lo - 1e-6) & (b <= hi + 1e-6)).all())
        in_strip = sum(((b >= s0) & (b < s1)).float() for s0, s1 in strips).mean()
        # Half the draws in a strip, plus the full-range draws landing there.
        width = sum(s1 - s0 for s0, s1 in strips) / (hi - lo)
        assert abs(float(in_strip) - (0.5 + 0.5 * width)) < 0.05


def test_refog_batch_replaces_only_hazy():
    gen = torch.Generator().manual_seed(2)
    batch = {k: torch.rand(64, 8, 8, 3, generator=gen) for k in ("hazy", "clear", "dehazed")}
    batch["intensity"] = torch.tensor([0, 1, 2, 1] * 16)
    out = psyn.refog_batch(gen, batch, prob=0.5)
    for k in ("clear", "dehazed", "intensity"):
        assert out[k] is batch[k]
    changed = (out["hazy"] != batch["hazy"]).flatten(1).any(1)
    assert 10 < int(changed.sum()) < 54


def test_progressive_levels_match_jax():
    assert psyn.progressive_fog_levels(7) == jsyn.progressive_fog_levels(7)


# --------------------------------------------------------- scenes, codec ---

@pytest.mark.parametrize("size", [16, 32, 64])
def test_procedural_clear_image_exact(size):
    a = ppre._procedural_clear_image(np.random.default_rng(size), size)
    b = jpre._procedural_clear_image(np.random.default_rng(size), size)
    np.testing.assert_array_equal(a, b)


def test_normalize_u8_matches_jax():
    imgs = np.random.default_rng(6).integers(0, 256, (2, 8, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pnc.normalize_u8(imgs), jnc.normalize_u8(imgs))
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    _close(pnc.normalize_u8(imgs, mean, std), jnc.normalize_u8(imgs, mean, std), atol=1e-6)


# ---------------------------------------------------------- dataset walk ---

@pytest.mark.parametrize("img_size", [None, 32, 48])
def test_imread_matches_jax(jax_corpus, img_size):
    path = os.path.join(jax_corpus, "train", "high", "hazy", "high_0000.png")
    np.testing.assert_array_equal(pds._imread_rgb(path, img_size),
                                  jds._imread_rgb(path, img_size))
    with pytest.raises(FileNotFoundError):
        pds._imread_rgb(path + ".missing", img_size)


def test_write_rgb_matches_jax(tmp_path):
    img = np.random.default_rng(9).random((21, 19, 3)).astype(np.float32) * 1.2 - 0.1
    ours, theirs = str(tmp_path / "a" / "ours.png"), str(tmp_path / "theirs.png")
    ppre._write_rgb(ours, img)
    jpre._write_rgb(theirs, img)
    np.testing.assert_array_equal(cv2.imread(ours), cv2.imread(theirs))


def test_dataset_walk_matches_jax(jax_corpus):
    for split in ("train", "val", "test"):
        p, j = pds.HazyImageDataset(jax_corpus, split, 32), jds.HazyImageDataset(jax_corpus, split, 32)
        assert p.samples == j.samples
    a, b = p.load(3), j.load(3)
    assert a.keys() == b.keys() and a["name"] == b["name"]
    for k in ("hazy", "clear", "dehazed", "intensity"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle,drop", [(True, None), (False, False), (True, False)])
def test_dataloader_order_and_mask_match_jax(jax_corpus, shuffle, drop):
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=2, drop_remainder=drop, seed=7)
    p = pds.DataLoader(pds.HazyImageDataset(jax_corpus, "train", 32), **kw)
    j = jds.DataLoader(jds.HazyImageDataset(jax_corpus, "train", 32), **kw)
    assert len(p) == len(j)
    for _ in range(2):                      # two epochs: the rng carries on
        pb, jb = list(p), list(j)
        assert len(pb) == len(jb) == len(p)
        for a, b in zip(pb, jb):
            assert a.keys() == b.keys()
            assert a["name"] == b["name"]
            for k in ("hazy", "clear", "dehazed", "intensity", "mask"):
                np.testing.assert_array_equal(a[k], b[k])


def test_dataloader_raises_a_failed_read(tmp_path):
    class Broken:
        def __len__(self):
            return 4

        def load(self, idx):
            raise FileNotFoundError(f"image {idx}")

    with pytest.raises(FileNotFoundError):
        list(pds.DataLoader(Broken(), batch_size=2, num_workers=1))


def test_get_dataloader_and_empty_split(jax_corpus, tmp_path):
    from adam_dehaze_tpu_torch.config import load_config
    cfg = load_config()
    cfg["dataset"].update(train_path=jax_corpus, img_size=32, batch_size=2, num_workers=1)
    b = next(iter(pds.get_dataloader(cfg, "train")))
    assert b["hazy"].shape == (2, 32, 32, 3) and b["mask"].all()
    cfg["dataset"]["train_path"] = str(tmp_path)
    with pytest.raises(ValueError, match="No samples"):
        pds.get_dataloader(cfg, "train")


def test_generate_synthetic_dataset_layout(jax_corpus, tmp_path):
    """The port writes the JAX package's tree: the same names in the same
    splits and the same clear scenes (the fog draws differ)."""
    root = str(tmp_path / "port")
    assert ppre.generate_synthetic_dataset(root, n_per_class=10, size=32, seed=0) == 30
    for split in ("train", "val", "test"):
        ours = pds.HazyImageDataset(root, split, 32)
        theirs = jds.HazyImageDataset(jax_corpus, split, 32)
        assert [(s["name"], s["intensity"]) for s in ours.samples] == \
            [(s["name"], s["intensity"]) for s in theirs.samples]
        for i in range(len(ours)):
            a, b = ours.load(i), theirs.load(i)
            np.testing.assert_array_equal(a["clear"], b["clear"])
            assert a["hazy"].min() >= 0 and a["hazy"].max() <= 1


# ---------------------------------------------------------- augmentation ---

def test_flip_and_color_jitter_match_jax():
    rng = np.random.default_rng(8)
    imgs = rng.random((4, 12, 10, 3), dtype=np.float32)
    hflip = np.array([True, False, True, False])
    vflip = np.array([True, True, False, False])
    bf = np.array([0.9, 1.05, 1.1, 0.95], np.float32)
    cf = np.array([1.1, 0.9, 1.0, 0.93], np.float32)
    _close(paug._flip(_t(imgs), _t(hflip), _t(vflip)),
           jaug._flip(jnp.asarray(imgs), jnp.asarray(hflip), jnp.asarray(vflip)), atol=0)
    _close(paug._color_jitter(_t(imgs), _t(bf), _t(cf)),
           jaug._color_jitter(jnp.asarray(imgs), jnp.asarray(bf), jnp.asarray(cf)))


def test_augment_triplet_pairs_the_triplet():
    """One flip and one jitter per sample, the same on all three images:
    an identical triplet stays identical; the labels pass through."""
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(6, 10, 10, 3, generator=gen)
    batch = {"hazy": x, "clear": x.clone(), "dehazed": x.clone(),
             "intensity": torch.arange(6)}
    out = paug.augment_triplet(gen, batch)
    assert torch.equal(out["hazy"], out["clear"]) and torch.equal(out["hazy"], out["dehazed"])
    assert out["intensity"] is batch["intensity"]
    assert not torch.equal(out["hazy"], x)
    assert 0 <= float(out["hazy"].min()) and float(out["hazy"].max()) <= 1
