"""The port's detector training (training/train_detection.py) against the
JAX package's, on the CPU:

- `sigmoid_focal_loss`, `_iou_loss`, `_giou_loss` and `fcos_loss` on the
  same level outputs, within 1e-5 relative; `_assign_level` batched over
  images against the JAX function vmapped: class and box targets and the
  positive mask exactly equal, the centerness target within one unit in
  the last place, at every level range, with padded and empty images;
- one train step (resnet18, 32 channels, 64^2, batch 4, SGD) against the
  JAX step computing in float64 (flax's train-mode BN
  takes the variance as E[x^2] - E[x]^2): the loss within 1e-4 relative,
  every gradient within 1e-4 of the largest, each parameter after the step
  within 1e-4 of its tensor's largest magnitude, the BN statistics as
  flax's with torch's unbiased running variance mapped (n/(n-1));
- `train_detection` on a tiny corpus written by the port's corpus tool: one
  epoch, the best checkpoint written and reloaded.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import detection as JD
from adam_dehaze_tpu.training import train_detection as JT
from adam_dehaze_tpu.training.state import TrainState as JState
from adam_dehaze_tpu_torch.models import detection as PD
from adam_dehaze_tpu_torch.training import train_detection as PT
from adam_dehaze_tpu_torch.training.state import TrainState
from test_torch_detection import seeded_variables
from torch_port_util import assert_bn_stats_match_flax, images, port_of

KW = dict(num_classes=6, channels=32)


def random_boxes(rng, b, m, extent):
    """(B, M, 4) xyxy boxes from 4 px to `extent` a side, labels in [1, 5],
    and a padded count per image (one image empty)."""
    xy = rng.uniform(0, extent * 0.6, (b, m, 2))
    wh = rng.uniform(4, extent, (b, m, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(1, 6, (b, m)).astype(np.int32)
    n_boxes = np.array([m, m // 2, 0, 1][:b], np.int32)
    return boxes, labels, n_boxes


def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 4, (3, 8, 8, 6)).astype(np.float32)
    targets = (rng.random((3, 8, 8, 6)) < 0.2).astype(np.float32)
    want = np.asarray(JT.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = PT.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("level", range(4))
def test_assign_level_matches_jax(level):
    """The P2 ranges (32, 64, 128 px and beyond) on 256-px maps."""
    stride = (4, 8, 16, 32)[level]
    h = w = 256 // stride
    rng_ = PT.level_ranges(4)[level]
    extent = (60.0, 120.0, 250.0, 256.0)[level]
    boxes, labels, n_boxes = random_boxes(np.random.default_rng(level), 4, 16, extent)
    fn = jax.vmap(lambda bx, lb, nb: JT._assign_level(bx, lb, nb, h, w, stride, rng_, 6))
    want = [np.asarray(a) for a in fn(jnp.asarray(boxes), jnp.asarray(labels),
                                      jnp.asarray(n_boxes))]
    got = [t.numpy() for t in PT._assign_level(torch.from_numpy(boxes), torch.from_numpy(labels),
                                                torch.from_numpy(n_boxes), h, w, stride, rng_, 6)]
    assert want[3].any(), f"no positive location at level {level}"
    assert not want[3][2].any()
    for g, wnt, name in zip(got, want, ("cls", "box", "ctr", "pos")):
        assert g.shape == wnt.shape, name
        if name == "ctr":
            # sqrt((lr_min / lr_max) * (tb_min / tb_max)): XLA's fused
            # kernel rounds a few of these a unit in the last place apart.
            np.testing.assert_array_max_ulp(g, wnt, maxulp=1)
        else:
            np.testing.assert_array_equal(g, wnt, err_msg=name)


def test_iou_losses_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 40, (500, 4)).astype(np.float32)
    target = rng.uniform(0, 40, (500, 4)).astype(np.float32)
    target[:50] = 0     # padded targets stay finite
    for jf, pf in ((JT._giou_loss, PT._giou_loss), (JT._iou_loss, PT._iou_loss)):
        want = np.asarray(jf(jnp.asarray(pred), jnp.asarray(target)))
        got = pf(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _random_levels(rng, b, sizes, strides, c=6):
    return [{"logits": rng.normal(-2, 2, (b, s, s, c)).astype(np.float32),
             "offsets": rng.uniform(0, 3 * st, (b, s, s, 4)).astype(np.float32),
             "centerness": rng.normal(0, 1, (b, s, s, 1)).astype(np.float32),
             "stride": st} for s, st in zip(sizes, strides)]


@pytest.mark.parametrize("n_levels", [3, 4, 5])
def test_fcos_loss_matches_jax(n_levels):
    """3 levels (native), 4 (p2), 5 (the tv geometry: the loss covers the
    first three)."""
    rng = np.random.default_rng(n_levels)
    strides = {3: (8, 16, 32), 4: (4, 8, 16, 32), 5: (8, 16, 32, 64, 128)}[n_levels]
    levels = _random_levels(rng, 4, [256 // s for s in strides], strides)
    boxes, labels, n_boxes = random_boxes(rng, 4, 10, 250.0)
    jloss = jax.jit(lambda maps, *args: JT.fcos_loss(
        [{**m, "stride": st} for m, st in zip(maps, strides)], *args, 6))
    want = jloss([{k: v for k, v in lv.items() if k != "stride"} for lv in levels],
                 boxes, labels, n_boxes)
    got = PT.fcos_loss([{k: (torch.from_numpy(v) if k != "stride" else v)
                         for k, v in lv.items()} for lv in levels],
                       torch.from_numpy(boxes), torch.from_numpy(labels),
                       torch.from_numpy(n_boxes), 6)
    assert float(want["n_pos"]) > 0
    for k in ("cls", "box", "ctr", "total", "n_pos"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_train_step_matches_jax():
    """One SGD step: Adam's first step sets every entry to +-lr by the sign
    of its gradient, and entries whose gradient is at the rounding level
    flip that sign between any two implementations. The step's gradients
    are then (before - after) / lr on the JAX side."""
    import optax
    x = images((4, 64, 64, 3), seed=12) * 4 - 2
    boxes, labels, n_boxes = random_boxes(np.random.default_rng(12), 4, 8, 60.0)
    jm = JD.FCOSDetector(backbone_name="fcos_resnet18_fpn", **KW)
    vs = seeded_variables(jm, x[:1], seed=4)
    lr = 1e-2
    with jax.enable_x64(True):
        jm64 = JD.FCOSDetector(backbone_name="fcos_resnet18_fpn", dtype=jnp.float64, **KW)
        p64, bs64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), vs[c])
                     for c in ("params", "batch_stats"))
        tx = optax.sgd(lr)
        state = JState(step=jnp.zeros((), jnp.int32), params=p64, batch_stats=bs64,
                       opt_state=tx.init(p64))
        batch = {"hazy": jnp.asarray(x, jnp.float64), "boxes": jnp.asarray(boxes),
                 "labels": jnp.asarray(labels), "n_boxes": jnp.asarray(n_boxes)}
        new_state, jlosses = JT.make_detection_train_step(jm64, tx)(state, batch)
        jlosses, jparams, jbs = (jax.tree_util.tree_map(np.asarray, t) for t in (
            jlosses, new_state.params, new_state.batch_stats))
    jgrads = jax.tree_util.tree_map(lambda a, b: (np.float64(a) - b) / lr, vs["params"], jparams)

    model = port_of(PD.FCOSDetector(**KW), vs)
    pstate = TrainState(model, torch.optim.SGD(model.parameters(), lr=lr))
    m = PT.make_detection_train_step()(pstate, {
        "hazy": torch.from_numpy(x), "boxes": torch.from_numpy(boxes),
        "labels": torch.from_numpy(labels), "n_boxes": torch.from_numpy(n_boxes)})
    assert pstate.step == 1 and float(m["n_pos"]) > 0
    for k in ("cls", "box", "ctr", "total", "n_pos"):
        np.testing.assert_allclose(float(m[k]), float(jlosses[k]), rtol=1e-4, err_msg=k)
    want_grads = port_of(PD.FCOSDetector(**KW), {"params": jgrads,
                                                 "batch_stats": vs["batch_stats"]})
    g_max = max(float(q.abs().max()) for q in want_grads.parameters())
    want_params = port_of(PD.FCOSDetector(**KW), {"params": jparams, "batch_stats": jbs})
    for (name, p), g, q in zip(model.named_parameters(), want_grads.parameters(),
                               want_params.parameters()):
        assert float((p.grad - g).abs().max()) <= 1e-4 * g_max, name
        assert float((p.detach() - q).abs().max()) <= 1e-4 * float(q.abs().max()), name
    assert_bn_stats_match_flax(model, port_of(PD.FCOSDetector(**KW), vs), want_params,
                               torch.from_numpy(x))


def test_epoch_learning_rate_is_the_jax_schedule():
    base, epochs = 2e-4, 6
    want = [base * 0.3] + [base * (0.05 + 0.95 * 0.5 * (1 + float(np.cos(np.pi * (e - 1) / 5))))
                           for e in range(1, epochs)]
    got = [PT.epoch_learning_rate(base, e, epochs) for e in range(epochs)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[1] == pytest.approx(base)


def test_train_detection_writes_and_reloads_the_best(tmp_path):
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus
    from adam_dehaze_tpu_torch.training import checkpoint as ckpt

    root = str(tmp_path / "corpus")
    make_corpus(root, size=64, train=2, val=1, test=1, seed=1)
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    cfg["dataset"].update(train_path=root, val_path=root, test_path=root, batch_size=4,
                          num_workers=2)
    cfg["detection"].update(num_classes=3, learning_rate=1e-3,
                            checkpoint_dir=str(tmp_path / "ck"))
    cfg["_logs_dir"] = str(tmp_path / "logs")
    det, state = PT.train_detection(cfg, epochs=1, img_size=64, device="cpu")
    assert state.step == 3          # 6 train images, batches of 2
    best = ckpt.best_model_path(cfg["detection"]["checkpoint_dir"])
    tree, metrics = ckpt.load_checkpoint(best)
    assert metrics["epoch"] == 1 and np.isfinite(metrics["val_loss"])
    assert os.path.exists(str(tmp_path / "logs" / "detection" / "metrics.jsonl"))
    fresh = PD.create_detection_model(cfg, device="cpu")
    fresh.init(0)
    fresh.module.load_state_dict(tree["model"])
    fresh.score_threshold = det.score_threshold = 0.0
    x = torch.from_numpy(images((2, 64, 64, 3), seed=3))
    a, b = det(x), fresh(x)
    assert sum(len(r["boxes"]) for r in a) > 0
    for ra, rb in zip(a, b):
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(ra[k], rb[k])
