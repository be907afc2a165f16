"""Evaluation orchestration of the port.

Counterpart of adam_dehaze_tpu/evaluation/evaluate.py, with the same
summary JSON schema:

- `_load_joint`: the router with the port's best joint checkpoint
  (`{joint_training.checkpoint_dir}/best_model.pth`), else the stage
  checkpoints grafted by `build_router_state`;
- `evaluate_baseline_models`: oracle routing, each test image through the
  branch of its ground-truth label;
- `evaluate_fixed_branch`: each branch alone on all test traffic;
- `evaluate_hard_routing`: hard-binned serving under the classifier's
  labels through the port's AdaptiveDehazer (the tuned winners when the
  experiment has a `serving_autotune.json`): fidelity, capacity spill on a
  seeded permutation (steady) and in the loader's order, and up-only
  spill, with the routing accuracy and spilled fractions;
- `evaluate_joint_model`: the router on the test split, per-category PSNR,
  SSIM and LPIPS, the no-reference rows (`fade_proxy`, `brisque_proxy`,
  and `nima_proxy` from the experiment's cached quality head) and two
  figures;
- `load_detection_model` and `evaluate_object_detection`: detection mAP
  on hazy and on dehazed images, the per-intensity GT files merged and
  matched by (level, file name), or a dummy GT file when none is
  configured;
- `run_comprehensive_evaluation`: all of the above, written to
  `comprehensive_results.json`.

The routers run in eval mode under autocast in `cuda.compute_dtype`.
Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.data.dataset import get_dataloader
from adam_dehaze_tpu_torch.data.synthetic import fog_density_map
from adam_dehaze_tpu_torch.evaluation import no_reference as nr
from adam_dehaze_tpu_torch.evaluation.metrics import DetectionMetrics, ImageQualityMetrics
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.detection import (
    create_detection_model,
    create_integrated_system,
    imagenet_normalize,
)
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    BinnedAdaptiveEngine,
    create_router,
)
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training.common import autocast
from adam_dehaze_tpu_torch.training.train_joint import build_router_state
from adam_dehaze_tpu_torch.utils import visualize

_CATEGORY_NAMES = {0: "low_intensity", 1: "medium_intensity", 2: "high_intensity"}
_LEVELS = {0: "low", 1: "medium", 2: "high"}


def _load_joint(config, device="cuda") -> torch.nn.Module:
    """The router of the config in eval mode, with the best joint
    checkpoint, or grafted from the stage checkpoints when there is none."""
    best = ckpt.best_model_path(config["joint_training"]["checkpoint_dir"])
    if not os.path.exists(best):
        router, _ = build_router_state(config, device)
        return router.eval()
    router = create_router(create_branch_models(config), create_classifier(config), config)
    try:
        router.load_state_dict(ckpt.load_checkpoint(best)[0]["model"])
    except RuntimeError as e:
        raise ValueError(
            f"Joint checkpoint at {best} does not match the models built from this config: "
            "the experiment was likely trained with other classifier or dehazing sizes. "
            f"Pass the experiment's own config. [{e}]") from e
    print(f"Loaded joint checkpoint from {best}")
    return router.to(device).eval()


def _quality_metrics(config, device) -> ImageQualityMetrics:
    return ImageQualityMetrics(
        lpips_weights=config.get("loss", {}).get("lpips_weights") or None, device=device)


def _apply_branch(router, level: str, dtype: torch.dtype):
    """The eval apply of one branch of the router: NHWC in, float32 out,
    under autocast in `dtype`."""
    module = router.models[level]

    @torch.no_grad()
    def apply(x):
        with autocast(x.device, dtype):
            return module(x).float()
    return apply


def _dehaze_fn(router, dtype: torch.dtype):
    """The router's eval call: NHWC in, (float32 dehazed, info) out, under
    autocast in `dtype`."""
    @torch.no_grad()
    def dehaze(x):
        with autocast(x.device, dtype):
            dehazed, info = router(x)
        return dehazed.float(), info
    return dehaze


def _loaded(config, router, device):
    """The router given, else `_load_joint`'s, in eval mode on `device`."""
    if router is None:
        return _load_joint(config, device)
    return router.to(device).eval()


def evaluate_baseline_models(config, router=None, device="cuda") -> Dict[str, Dict[str, float]]:
    """Oracle routing: each test image through the branch of its
    ground-truth label; per-category averages, also written to
    baseline_results.json."""
    device = torch.device(device)
    router = _loaded(config, router, device)
    dtype = compute_dtype(config)
    iq = _quality_metrics(config, device)
    branch_fns = {lvl: _apply_branch(router, lvl, dtype) for lvl in INTENSITY_ORDER}
    for batch in get_dataloader(config, "test"):
        hazy = torch.from_numpy(batch["hazy"]).to(device)
        clear = torch.from_numpy(batch["clear"]).to(device)
        labels = torch.from_numpy(batch["intensity"]).to(device)
        picked = torch.zeros_like(clear)
        for i, lvl in enumerate(INTENSITY_ORDER):
            sel = labels == i
            picked[sel] = branch_fns[lvl](hazy)[sel]
        for i in range(3):
            sel = (batch["intensity"] == i) & batch["mask"]
            if sel.any():
                keep = torch.from_numpy(sel).to(device)
                iq.add_batch(picked[keep], clear[keep], _CATEGORY_NAMES[i])
    avg = iq.print_results()
    iq.save_results(os.path.join(config["evaluation"]["results_dir"], "baseline_results.json"))
    return avg


def evaluate_fixed_branch(config, router=None, device="cuda") -> Dict[str, Dict[str, float]]:
    """Each branch alone on all test traffic (no routing): {"fixed_low":
    {psnr, ssim, ...}, "fixed_medium": ..., "fixed_high": ...}, overall
    averages over the whole test split."""
    device = torch.device(device)
    router = _loaded(config, router, device)
    dtype = compute_dtype(config)
    branch_fns = {lvl: _apply_branch(router, lvl, dtype) for lvl in INTENSITY_ORDER}
    accs = {lvl: _quality_metrics(config, device) for lvl in branch_fns}
    for batch in get_dataloader(config, "test"):
        hazy = torch.from_numpy(batch["hazy"]).to(device)
        keep = torch.from_numpy(batch["mask"]).to(device)
        clear = torch.from_numpy(batch["clear"]).to(device)[keep]
        for lvl, fn in branch_fns.items():
            accs[lvl].add_batch(fn(hazy)[keep], clear, "overall")
    results = {}
    for lvl, iq in accs.items():
        results[f"fixed_{lvl}"] = iq.compute_averages().get("overall", {})
        psnr = results[f"fixed_{lvl}"].get("psnr", float("nan"))
        print(f"  fixed {lvl:<6} on ALL traffic: PSNR {psnr:.2f} dB")
    return results


@torch.inference_mode()
def evaluate_hard_routing(config, router=None, device="cuda") -> Dict[str, Any]:
    """Hard-binned serving quality under the classifier's labels, through
    the port's AdaptiveDehazer (serving dtype; the tuned winners when
    `{_exp_dir}/serving_autotune.json` exists):

    - fidelity: every image served by its predicted branch;
    - spill: the capacity plan (`plan_capacity_spill`) on a seeded
      permutation of the test split, so that each batch holds about the
      corpus's class mix ("steady");
    - spill_up: the same, overflow moving only to stronger branches;
    - spill_ordered: the capacity plan in the loader's intensity-sorted
      order, where every batch is one class (the worst case).

    Returns {"fidelity", "spill", "spill_up", "spill_ordered": {psnr, ...},
    "routing_acc", "spilled_frac", "spilled_frac_up",
    "spilled_frac_ordered"}. The capacity plan sees only the real rows of
    a padded batch."""
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

    device = torch.device(device)
    router = _loaded(config, router, device)
    cache = os.path.join(config.get("_exp_dir", "."), "serving_autotune.json")
    dehazer = AdaptiveDehazer(router, None, config, device=device,
                              autotune=os.path.exists(cache), autotune_cache=cache)
    # The serving engine's applies on a one-bucket ladder, the batch size:
    # the capacity plan caps a class at ceil(B / 3) rounded up to a bucket
    # of the ladder, and these rows are the JAX package's, which plans
    # with that ladder.
    bsz = config["dataset"]["batch_size"]
    engine = BinnedAdaptiveEngine(dehazer.engine.classifier_apply,
                                  dehazer.engine.branch_applies, buckets=(bsz,))

    hazy_all, clear_all, level_all = [], [], []
    for batch in get_dataloader(config, "test"):
        m = batch["mask"]
        hazy_all.append(batch["hazy"][m])
        clear_all.append(batch["clear"][m])
        level_all.append(batch["intensity"][m])
    hazy_all = np.concatenate(hazy_all)
    clear_all = np.concatenate(clear_all)
    level_all = np.concatenate(level_all)
    n_imgs = hazy_all.shape[0]

    def _batches(order):
        for i in range(0, n_imgs, bsz):
            idx = order[i:i + bsz]
            pad = bsz - idx.size
            yield (np.concatenate([idx, np.zeros(pad, np.int64)]),
                   np.concatenate([np.ones(idx.size, bool), np.zeros(pad, bool)]))

    accs = {mode: _quality_metrics(config, device)
            for mode in ("fidelity", "spill", "spill_up", "spill_ordered")}
    counters = {"steady": [0, 0], "ordered": [0, 0], "steady_up": [0, 0]}  # [spilled, total]
    n_correct = n_total = 0
    orders = {"ordered": np.arange(n_imgs),
              "steady": np.random.default_rng(0).permutation(n_imgs)}
    for regime, order in orders.items():
        spill_key = "spill" if regime == "steady" else "spill_ordered"
        for idx, mask in _batches(order):
            hazy = torch.from_numpy(hazy_all[idx]).to(device)
            clear = torch.from_numpy(clear_all[idx][mask]).to(device)
            keep = torch.from_numpy(mask).to(device)
            logits = engine.logits(hazy).float().cpu().numpy()
            pred = logits.argmax(axis=1)
            serve_labels = pred.copy()
            serve_labels[mask] = engine.plan_capacity_spill(pred[mask], logits[mask])
            accs[spill_key].add_batch(engine.dispatch(hazy, serve_labels)[keep], clear,
                                      "overall")
            counters[regime][0] += int((serve_labels[mask] != pred[mask]).sum())
            counters[regime][1] += int(mask.sum())
            if regime == "steady":
                up_labels = pred.copy()
                up_labels[mask] = engine.plan_capacity_spill(pred[mask], logits[mask],
                                                             up_only=True)
                accs["spill_up"].add_batch(engine.dispatch(hazy, up_labels)[keep], clear,
                                           "overall")
                counters["steady_up"][0] += int((up_labels[mask] != pred[mask]).sum())
                counters["steady_up"][1] += int(mask.sum())
            else:
                out_fid, _ = engine(hazy, intensity=pred)
                accs["fidelity"].add_batch(out_fid[keep], clear, "overall")
                n_correct += int((pred[mask] == level_all[idx][mask]).sum())
                n_total += int(mask.sum())

    results: Dict[str, Any] = {mode: accs[mode].compute_averages().get("overall", {})
                               for mode in accs}
    results["routing_acc"] = n_correct / max(n_total, 1)
    results["spilled_frac"] = counters["steady"][0] / max(counters["steady"][1], 1)
    results["spilled_frac_up"] = counters["steady_up"][0] / max(counters["steady_up"][1], 1)
    results["spilled_frac_ordered"] = counters["ordered"][0] / max(counters["ordered"][1], 1)
    print(f"  hard routing (acc {results['routing_acc']:.3f}): "
          f"fidelity PSNR {results['fidelity'].get('psnr', float('nan')):.2f}"
          f" | spill steady PSNR {results['spill'].get('psnr', float('nan')):.2f} "
          f"({results['spilled_frac'] * 100:.1f}% spilled) | spill-up "
          f"{results['spill_up'].get('psnr', float('nan')):.2f} "
          f"({results['spilled_frac_up'] * 100:.1f}%) | spill ordered "
          f"{results['spill_ordered'].get('psnr', float('nan')):.2f} "
          f"({results['spilled_frac_ordered'] * 100:.1f}%)")
    return results


def _quality_head(config, device):
    """The experiment's NIMA-analog head (`{_exp_dir}/quality_head.pth`),
    trained and cached on first use; None without an experiment dir, or
    when training fails (the nima_proxy row is then left out)."""
    exp_dir = config.get("_exp_dir")
    if not exp_dir:
        return None
    path = os.path.join(exp_dir, "quality_head.pth")
    head = nr.load_quality_head(path, device)
    if head is None:
        try:
            print("  training nima_proxy quality head (one-time, cached per experiment)...")
            head = nr.train_quality_head(
                config, steps=int(config.get("evaluation", {}).get("nima_steps", 300)),
                device=device)
            nr.save_quality_head(path, head)
        except (ValueError, OSError, RuntimeError) as e:
            print(f"  nima_proxy head training skipped ({type(e).__name__}: {e})")
    return head


def evaluate_joint_model(config, router=None, device="cuda") -> Dict[str, Dict[str, float]]:
    """The router (classifier, branches, blend) on the test split:
    per-category PSNR, SSIM and LPIPS; `fade_proxy` (the mean DCP fog
    density, hazy and dehazed), `brisque_proxy` (the NSS distance from a
    pristine Gaussian fit on this split's clear images) and `nima_proxy`
    (the experiment's quality head); the comparison grid and the routing
    weights of the first batch. Also written to joint_results.json."""
    device = torch.device(device)
    router = _loaded(config, router, device)
    dehaze = _dehaze_fn(router, compute_dtype(config))
    iq = _quality_metrics(config, device)
    q_head = _quality_head(config, device)
    fade_hazy, fade_dehazed = [], []
    nss_clear, nss_hazy, nss_dehazed = [], [], []
    nima_hazy, nima_dehazed = [], []
    vis_done = False
    for batch in get_dataloader(config, "test"):
        hazy = torch.from_numpy(batch["hazy"]).to(device)
        clear = torch.from_numpy(batch["clear"]).to(device)
        dehazed, info = dehaze(hazy)
        m = batch["mask"]
        fade_hazy.append(fog_density_map(hazy).mean(dim=(1, 2)).cpu().numpy()[m])
        fade_dehazed.append(fog_density_map(dehazed).mean(dim=(1, 2)).cpu().numpy()[m])
        nss_clear.append(nr.nss_features(clear).cpu().numpy()[m])
        nss_hazy.append(nr.nss_features(hazy).cpu().numpy()[m])
        nss_dehazed.append(nr.nss_features(dehazed).cpu().numpy()[m])
        if q_head is not None:
            nima_hazy.append(nr.nima_proxy_scores(hazy, q_head)[m])
            nima_dehazed.append(nr.nima_proxy_scores(dehazed, q_head)[m])
        for i in range(3):
            sel = (batch["intensity"] == i) & m
            if sel.any():
                keep = torch.from_numpy(sel).to(device)
                iq.add_batch(dehazed[keep], clear[keep], _CATEGORY_NAMES[i])
        if not vis_done:
            vis_dir = config["evaluation"]["visualization_dir"]
            os.makedirs(vis_dir, exist_ok=True)
            k = min(4, hazy.shape[0])
            visualize.visualize_comparison(
                batch["hazy"][:k], dehazed[:k].cpu().numpy(), batch["clear"][:k],
                os.path.join(vis_dir, "joint_comparison.png"))
            weights = info.get("weights")
            if weights is None:
                weights = info.get("gate_weights")
            if weights is not None:
                visualize.visualize_routing_weights(
                    weights[:k].float().cpu().numpy(),
                    os.path.join(vis_dir, "routing_weights.png"))
            vis_done = True
    avg = iq.print_results()
    fh = float(np.mean(np.concatenate(fade_hazy))) if fade_hazy else None
    fd = float(np.mean(np.concatenate(fade_dehazed))) if fade_dehazed else None
    if fh is not None and fd is not None and fh > 0:
        avg["fade_proxy"] = {"hazy": round(fh, 5), "dehazed": round(fd, 5),
                             "reduction_pct": round((fh - fd) / fh * 100.0, 2)}
        print(f"  fade_proxy (DCP density): hazy {fh:.4f} -> dehazed {fd:.4f} "
              f"({avg['fade_proxy']['reduction_pct']:+.1f}% reduction)")
    if nss_clear:
        pristine = nr.pristine_from_features(np.concatenate(nss_clear))
        bh = float(np.mean(nr.mahalanobis_scores(np.concatenate(nss_hazy), pristine)))
        bd = float(np.mean(nr.mahalanobis_scores(np.concatenate(nss_dehazed), pristine)))
        avg["brisque_proxy"] = {"hazy": round(bh, 4), "dehazed": round(bd, 4),
                                "reduction_pct": round((bh - bd) / max(bh, 1e-9) * 100.0, 2)}
        print(f"  brisque_proxy (NIQE-family, lower=better): hazy {bh:.3f} -> dehazed "
              f"{bd:.3f} ({avg['brisque_proxy']['reduction_pct']:+.1f}% reduction)")
    if nima_hazy:
        nh = float(np.mean(np.concatenate(nima_hazy)))
        nd = float(np.mean(np.concatenate(nima_dehazed)))
        avg["nima_proxy"] = {"hazy": round(nh, 4), "dehazed": round(nd, 4),
                             "delta": round(nd - nh, 4)}
        print(f"  nima_proxy (1-10 MOS, higher=better): hazy {nh:.3f} -> dehazed {nd:.3f} "
              f"({avg['nima_proxy']['delta']:+.3f})")
    iq.save_results(os.path.join(config["evaluation"]["results_dir"], "joint_results.json"))
    return avg


def _dummy_annotations(loader, path: str) -> str:
    """Write a COCO file with the loader's images and no boxes, so that
    detection evaluation runs without labels; returns its path."""
    images, idx = [], 0
    for batch in loader:
        for name, valid in zip(batch["name"], batch["mask"]):
            if valid:
                images.append({"id": idx, "file_name": name})
                idx += 1
    coco = {"images": images, "annotations": [],
            "categories": [{"id": i} for i in range(1, 91)]}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(coco, f)
    return path


def _merge_annotations(ann_cfg: Dict[str, str]):
    """Merge the per-intensity COCO GT files into one GT dict with globally
    unique image and annotation ids, and a (level, file_name) -> image_id
    map, so that detections align with GT by name."""
    merged = {"images": [], "annotations": [], "categories": None}
    name_to_id: Dict[tuple, int] = {}
    next_img, next_ann = 1, 1
    for level in ("low", "medium", "high"):
        path = (ann_cfg or {}).get(level)
        if not path or not os.path.exists(path):
            continue
        with open(path) as f:
            gt = json.load(f)
        if merged["categories"] is None:
            merged["categories"] = gt.get("categories", [])
        remap = {}
        for im in gt.get("images", []):
            remap[im["id"]] = next_img
            name_to_id[(level, im["file_name"])] = next_img
            merged["images"].append({**im, "id": next_img})
            next_img += 1
        for ann in gt.get("annotations", []):
            merged["annotations"].append(
                {**ann, "id": next_ann, "image_id": remap[ann["image_id"]]})
            next_ann += 1
    if not merged["images"]:
        return None, {}
    return merged, name_to_id


def load_detection_model(config, image_size: int = None, device="cuda"):
    """The detector of the config: seeded (seed 1), then filled from
    `{detection.checkpoint_dir}/best_model.pth` when train_detection wrote
    one."""
    det_model = create_detection_model(config, device)
    det_model.init(torch.Generator().manual_seed(1),
                   image_size=image_size or config["dataset"]["img_size"])
    best = ckpt.best_model_path(config["detection"]["checkpoint_dir"])
    if os.path.exists(best):
        det_model.module.load_state_dict(ckpt.load_checkpoint(best)[0]["model"])
        print(f"Loaded trained detector from {best}")
    else:
        print("WARNING: no trained detector checkpoint — detections will be noise "
              "(random detector weights)")
    return det_model


def evaluate_object_detection(config, router=None, device="cuda") -> Dict[str, Any]:
    """Detection mAP on the test split's hazy images against the router's
    dehazed images: {hazy, dehazed}, each with `overall` and the
    per-intensity stats. The router (default: `_load_joint`) runs in eval
    mode under autocast in `cuda.compute_dtype`."""
    device = torch.device(device)
    router = _loaded(config, router, device)
    det_model = load_detection_model(config, device=device)
    integrated = create_integrated_system(_dehaze_fn(router, compute_dtype(config)), det_model)
    loader = get_dataloader(config, "test")
    merged_gt, name_to_id = _merge_annotations(config["evaluation"].get("annotation_paths"))
    sequential_ids = merged_gt is None
    if sequential_ids:
        merged_gt = _dummy_annotations(loader, os.path.join(
            config["evaluation"]["results_dir"], "dummy_annotations.json"))
        print("Using dummy annotations (no GT boxes supplied)")

    hazy_metrics = DetectionMetrics(merged_gt)
    dehazed_metrics = DetectionMetrics(merged_gt)
    fallback_id = 0
    for batch in loader:
        hazy = torch.from_numpy(batch["hazy"]).to(device)
        hazy_dets = det_model(imagenet_normalize(hazy))
        dehazed_dets, _ = integrated(hazy)
        for i in range(hazy.shape[0]):
            if not batch["mask"][i]:
                continue
            level = _LEVELS.get(int(batch["intensity"][i]))
            category = _CATEGORY_NAMES.get(int(batch["intensity"][i]))
            if sequential_ids:
                image_id = fallback_id
                fallback_id += 1
            else:
                image_id = name_to_id.get((level, batch["name"][i]))
                if image_id is None:    # not in the GT: skip, do not misalign
                    continue
            for dets, metrics in ((hazy_dets[i], hazy_metrics),
                                  (dehazed_dets[i], dehazed_metrics)):
                for box, score, label in zip(dets["boxes"], dets["scores"], dets["labels"]):
                    x1, y1, x2, y2 = box
                    metrics.add_detection_result(image_id, int(label),
                                                 [x1, y1, x2 - x1, y2 - y1], float(score),
                                                 category=category)

    hazy_all = hazy_metrics.evaluate_by_category()
    dehazed_all = dehazed_metrics.evaluate_by_category()
    return {
        "hazy": {"overall": hazy_all.pop("overall", {}) or {"mAP": 0.0}, **hazy_all},
        "dehazed": {"overall": dehazed_all.pop("overall", {}) or {"mAP": 0.0}, **dehazed_all},
    }


def _avg_psnr(res) -> float:
    vals = [res[c]["psnr"] for c in _CATEGORY_NAMES.values() if c in res]
    return float(np.mean(vals)) if vals else float("nan")


# The upstream reference's published per-level rows (its README, on
# Cityscapes FogIntensity-25K): level -> (ssim, psnr dB, lpips).
_REFERENCE_ROWS = {
    "low_intensity": (0.9188, 23.95, 0.0585),
    "medium_intensity": (0.8761, 21.78, 0.0929),
    "high_intensity": (0.8060, 19.39, 0.1456),
}


def _baseline_comparison(config, joint_results) -> Dict[str, Any]:
    """The reference's published rows beside the router's measured ones,
    with the corpus the rows were measured on."""
    lpips_key = next((k for k in ("lpips", "lpips_cal_synth", "lpips_uncal")
                      if any(k in joint_results.get(lvl, {}) for lvl in _REFERENCE_ROWS)), None)
    table = {}
    for lvl, (r_ssim, r_psnr, r_lpips) in _REFERENCE_ROWS.items():
        ours = joint_results.get(lvl, {})
        if not ours:
            continue
        row = {"reference": {"ssim": r_ssim, "psnr": r_psnr, "lpips": r_lpips},
               "ours": {"ssim": ours.get("ssim"), "psnr": ours.get("psnr")},
               "delta": {"ssim": (ours.get("ssim") or 0) - r_ssim,
                         "psnr": (ours.get("psnr") or 0) - r_psnr}}
        if lpips_key:
            row["ours"][lpips_key] = ours.get(lpips_key)
            if lpips_key == "lpips":
                row["delta"]["lpips"] = (ours.get(lpips_key) or 0) - r_lpips
        table[lvl] = row
    return {"corpus": config["dataset"].get("test_path", ""),
            "reference_source": "reference README.md:129-131 (Cityscapes FogIntensity-25K)",
            "rows": table}


def run_comprehensive_evaluation(config, router=None, device="cuda") -> Dict[str, Any]:
    """Every evaluation on one router (default: `_load_joint`), written to
    `{results_dir}/comprehensive_results.json` with the JAX package's
    schema: baseline, joint, fixed, hard_routing, detection (hazy,
    dehazed, by_level, improvement_percent), comparison,
    baseline_comparison, and pre_joint_adaptive when train_all wrote
    pre_joint_adaptive.json. Returns the dict."""
    os.makedirs(config["evaluation"]["results_dir"], exist_ok=True)
    os.makedirs(config["evaluation"]["visualization_dir"], exist_ok=True)
    print("=" * 50)
    print("ADAPTIVE FOG INTENSITY DEHAZING FRAMEWORK EVALUATION")
    print("=" * 50)
    device = torch.device(device)
    router = _loaded(config, router, device)

    print("\n1. Evaluating Individual Dehazing Models:")
    baseline_results = evaluate_baseline_models(config, router, device)
    print("\n2. Evaluating Adaptive Framework:")
    joint_results = evaluate_joint_model(config, router, device)
    print("\n3. Evaluating Fixed-Pipeline Baselines (each branch on ALL traffic):")
    fixed_results = evaluate_fixed_branch(config, router, device)
    print("\n3b. Evaluating Hard-Binned Serving (fidelity vs capacity-spill):")
    hard_results = evaluate_hard_routing(config, router, device)
    print("\n4. Evaluating Impact on Object Detection:")
    detection_results = evaluate_object_detection(config, router, device)

    baseline_avg_psnr = _avg_psnr(baseline_results)
    joint_avg_psnr = _avg_psnr(joint_results)
    best_fixed = max((v.get("psnr", float("-inf")) for v in fixed_results.values()),
                     default=float("nan"))
    hazy_map = detection_results["hazy"]["overall"].get("mAP", 0.0)
    dehazed_map = detection_results["dehazed"]["overall"].get("mAP", 0.0)
    detection_improvement = ((dehazed_map - hazy_map) / hazy_map * 100
                             if hazy_map > 0 else 0.0)
    print("\n5. Comparison Summary:")
    print(f"  Baseline Models Avg PSNR: {baseline_avg_psnr:.2f} dB")
    print(f"  Adaptive Framework Avg PSNR: {joint_avg_psnr:.2f} dB")
    print(f"  Best Fixed-Branch PSNR (all traffic): {best_fixed:.2f} dB")
    print(f"  Detection mAP hazy={hazy_map:.4f} dehazed={dehazed_map:.4f}")

    by_level = {}
    for lvl in _CATEGORY_NAMES.values():
        row = {side: detection_results[side][lvl] for side in ("hazy", "dehazed")
               if detection_results[side].get(lvl)}
        if row:
            by_level[lvl] = row
    results = {
        "baseline": baseline_results,
        "joint": joint_results,
        "fixed": fixed_results,
        "hard_routing": hard_results,
        "detection": {"hazy": detection_results["hazy"]["overall"],
                      "dehazed": detection_results["dehazed"]["overall"],
                      "by_level": by_level,
                      "improvement_percent": detection_improvement},
        "comparison": {"baseline_avg_psnr": baseline_avg_psnr,
                       "joint_avg_psnr": joint_avg_psnr,
                       "psnr_improvement": joint_avg_psnr - baseline_avg_psnr,
                       "best_fixed_psnr": best_fixed,
                       "adaptive_vs_best_fixed_psnr": joint_avg_psnr - best_fixed},
        "baseline_comparison": _baseline_comparison(config, joint_results),
    }
    print("\n6. Side by side with the reference's published rows:")
    for lvl, row in results["baseline_comparison"]["rows"].items():
        print(f"  {lvl}: PSNR {row['ours']['psnr']:.2f} vs {row['reference']['psnr']:.2f} "
              f"({row['delta']['psnr']:+.2f} dB) | SSIM {row['ours']['ssim']:.4f} vs "
              f"{row['reference']['ssim']:.4f}")
    pre_path = os.path.join(config["evaluation"]["results_dir"], "pre_joint_adaptive.json")
    if os.path.isfile(pre_path):
        with open(pre_path) as f:
            pre_joint = json.load(f)
        pre_avg = _avg_psnr(pre_joint)
        results["pre_joint_adaptive"] = pre_joint
        results["comparison"]["pre_joint_avg_psnr"] = pre_avg
        results["comparison"]["joint_stage_psnr_gain"] = joint_avg_psnr - pre_avg
    out_path = os.path.join(config["evaluation"]["results_dir"], "comprehensive_results.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nComprehensive evaluation results saved to {out_path}")
    return results
