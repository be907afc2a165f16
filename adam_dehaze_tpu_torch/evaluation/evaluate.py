"""Evaluation orchestration of the port: the detection half.

Counterpart of adam_dehaze_tpu/evaluation/evaluate.py's detection path:

- `_load_joint`: the router with the port's best joint checkpoint
  (`{joint_training.checkpoint_dir}/best_model.pth`), else the stage
  checkpoints grafted by `build_router_state`;
- `load_detection_model`: the detector with `train_detection`'s best
  checkpoint when there is one (seeded weights otherwise, with a warning);
- `evaluate_object_detection`: detection mAP on the test split's hazy
  images and on the router's dehazed images, the per-intensity GT files
  merged and matched to detections by (level, file name), or a dummy GT
  file when none is configured.

The baseline, fixed-branch, hard-routing and joint evaluations and
`run_comprehensive_evaluation` are not ported yet.

Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.data.dataset import get_dataloader
from adam_dehaze_tpu_torch.evaluation.metrics import DetectionMetrics
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.detection import (
    create_detection_model,
    create_integrated_system,
    imagenet_normalize,
)
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training.common import autocast
from adam_dehaze_tpu_torch.training.train_joint import build_router_state

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
    if router is None:
        router = _load_joint(config, device)
    router.eval()
    det_model = load_detection_model(config, device=device)
    dtype = compute_dtype(config)

    @torch.no_grad()
    def dehaze_fn(x):
        with autocast(x.device, dtype):
            dehazed, info = router(x)
        return dehazed.float(), info

    integrated = create_integrated_system(dehaze_fn, det_model)
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
