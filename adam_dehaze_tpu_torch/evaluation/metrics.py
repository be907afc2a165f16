"""Evaluation metric accumulators.

Counterpart of adam_dehaze_tpu/evaluation/metrics.py:

- `calculate_image_metrics` / `ImageQualityMetrics`: PSNR, gray SSIM
  (ops/image.py) and LPIPS (losses/lpips.py) per sample, computed in
  batches on the device, with per-category averages and JSON export;
- `calculate_perceptual_scores`: VGG-feature naturalness and structure
  scores over a loader;
- `DetectionMetrics`: COCO mAP through evaluation/coco_eval.py, the same
  12-stat dict, and the per-category re-evaluation.

LPIPS's honesty rule is the JAX package's: seeded AlexNet trunk and uniform
heads (no weights given) report `lpips_uncal`; heads fitted on synthetic
ranked distortions (a weight file whose sidecar marks
`calibration_synthetic`) report `lpips_cal_synth`; only given or converted
LPIPS weights report `lpips`.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from adam_dehaze_tpu_torch.evaluation.coco_eval import COCOEvaluator
from adam_dehaze_tpu_torch.losses.lpips import LPIPS, lpips_from_unit_range
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.image import psnr, ssim_gray


def calculate_image_metrics(pred: np.ndarray, target: np.ndarray) -> Dict[str, float]:
    """One HWC image pair -> {psnr, ssim} (on the CPU)."""
    p = torch.as_tensor(np.asarray(pred))[None]
    t = torch.as_tensor(np.asarray(target))[None]
    return {"psnr": float(psnr(p, t)[0]), "ssim": float(ssim_gray(p, t)[0])}


class ImageQualityMetrics:
    """Accumulate PSNR / SSIM / LPIPS by category, a batch at a time on
    `device`.

    lpips_net: an LPIPS module with given weights; lpips_weights: the path
    of a port `.pth` holding them (its `.metrics.json` sidecar may mark
    `calibration_synthetic`); neither: a seeded LPIPS (seed 0), reported as
    `lpips_uncal`."""

    def __init__(self, lpips_net: Optional[LPIPS] = None, lpips_weights: Optional[str] = None,
                 device="cuda"):
        self.device = torch.device(device)
        calibrated = lpips_net is not None or lpips_weights is not None
        synth_cal = False
        if lpips_net is None:
            lpips_net = init_params_(LPIPS(), torch.Generator().manual_seed(0))
            if lpips_weights:
                from adam_dehaze_tpu_torch.losses.dehazing import _load_frozen
                from adam_dehaze_tpu_torch.training.checkpoint import load_checkpoint
                _load_frozen(lpips_net, lpips_weights)
                synth_cal = bool(load_checkpoint(lpips_weights)[1].get("calibration_synthetic"))
        self.lpips_net = lpips_net.to(self.device).eval().requires_grad_(False)
        self.lpips_key = ("lpips_cal_synth" if synth_cal
                          else "lpips" if calibrated else "lpips_uncal")
        self.results: Dict[str, List[Dict[str, float]]] = defaultdict(list)

    @torch.no_grad()
    def _batch_metrics(self, pred: torch.Tensor, target: torch.Tensor) -> Dict[str, np.ndarray]:
        m = {"psnr": psnr(pred, target), "ssim": ssim_gray(pred, target),
             self.lpips_key: lpips_from_unit_range(self.lpips_net, pred.float(), target.float())}
        # One host read for the three.
        stacked = torch.stack([v.float() for v in m.values()]).cpu().numpy()
        return dict(zip(m, stacked))

    def add_batch(self, pred, target, category: Optional[str] = None,
                  mask: Optional[np.ndarray] = None):
        """pred/target: (N, H, W, 3) in [0, 1], numpy or tensors."""
        m = self._batch_metrics(torch.as_tensor(pred, device=self.device),
                                torch.as_tensor(target, device=self.device))
        n = pred.shape[0]
        valid = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
        for i in range(n):
            if valid[i]:
                self.results[category or "all"].append({k: float(v[i]) for k, v in m.items()})

    def add_sample(self, pred, target, category: Optional[str] = None):
        """One HWC sample."""
        self.add_batch(np.asarray(pred)[None], np.asarray(target)[None], category)

    def compute_averages(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for category, recs in self.results.items():
            if not recs:
                continue
            out[category] = {k: float(np.mean([r[k] for r in recs])) for k in recs[0]}
            out[category]["samples"] = len(recs)
        return out

    def print_results(self):
        avg = self.compute_averages()
        print("Image Quality Evaluation Results:")
        for category, metrics in sorted(avg.items()):
            print(f"\n{category.upper()} ({metrics['samples']} samples):")
            for name, value in metrics.items():
                if name != "samples":
                    print(f"  {name.upper()}: {value:.4f}")
        return avg

    def save_results(self, output_path: str):
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(self.compute_averages(), f, indent=2)
        print(f"Results saved to {output_path}")


@torch.no_grad()
def calculate_perceptual_scores(dehaze_fn, loader, vgg_net=None, device="cuda") -> Dict[str, float]:
    """VGG-feature scores over a loader's valid rows: naturalness =
    1 / (1 + MSE(relu4_3)), structure_similarity = 1 / (1 + MSE(relu2_2)),
    of dehaze_fn(hazy) against clear. vgg_net: a VGG16Features with those
    taps (default: seeded, seed 0)."""
    from adam_dehaze_tpu_torch.nn.vgg import VGG16Features

    device = torch.device(device)
    if vgg_net is None:
        vgg_net = init_params_(VGG16Features(taps=("relu2_2", "relu4_3")),
                               torch.Generator().manual_seed(0))
    vgg_net = vgg_net.to(device).eval()
    tot_nat, tot_st, n = 0.0, 0.0, 0
    for batch in loader:
        dehazed, _ = dehaze_fn(torch.as_tensor(batch["hazy"], device=device))
        fd = vgg_net(dehazed.float())
        fc = vgg_net(torch.as_tensor(batch["clear"], device=device))
        nat = ((fd["relu4_3"] - fc["relu4_3"]) ** 2).mean(dim=(1, 2, 3))
        st = ((fd["relu2_2"] - fc["relu2_2"]) ** 2).mean(dim=(1, 2, 3))
        mask = np.asarray(batch["mask"], bool)
        both = torch.stack([nat, st]).cpu().numpy()
        tot_nat += float(both[0][mask].sum())
        tot_st += float(both[1][mask].sum())
        n += int(mask.sum())
    n = max(n, 1)
    return {"naturalness": 1.0 / (1.0 + tot_nat / n),
            "structure_similarity": 1.0 / (1.0 + tot_st / n),
            "samples": n}


class DetectionMetrics:
    """COCO-mAP accumulator with the reference's API."""

    def __init__(self, annotation_file):
        """annotation_file: path to a COCO JSON, or the dict itself."""
        if isinstance(annotation_file, str):
            with open(annotation_file) as f:
                gt = json.load(f)
        else:
            gt = annotation_file
        self.evaluator = COCOEvaluator(gt)
        self.results: List[Dict] = []
        self.category_results: Dict[str, List[Dict]] = defaultdict(list)

    def add_detection_result(self, image_id, category_id, bbox, score,
                             category: Optional[str] = None):
        r = {"image_id": image_id, "category_id": int(category_id),
             "bbox": [float(v) for v in bbox], "score": float(score)}
        self.results.append(r)
        if category:
            self.category_results[category].append(r)

    def evaluate(self) -> Dict[str, float]:
        if not self.results:
            print("No detection results to evaluate")
            return {}
        return self.evaluator.evaluate(self.results)

    def evaluate_by_category(self) -> Dict[str, Dict[str, float]]:
        out = {"overall": self.evaluate()}
        for category, recs in self.category_results.items():
            out[category] = self.evaluator.evaluate(recs) if recs else {}
        return out

    def print_results(self, results=None):
        if not results:
            print("No detection results to evaluate")
            return {k: 0.0 for k in ("mAP", "mAP_50", "mAP_75", "mAP_small",
                                     "mAP_medium", "mAP_large")}
        print("Object Detection Evaluation Results:")
        for k in ("mAP", "mAP_50", "mAP_75", "mAP_small", "mAP_medium", "mAP_large"):
            print(f"  {k}: {results.get(k, 0.0):.4f}")
        return results

    def save_results(self, results, output_path: str):
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(results, f, indent=2)
        print(f"Results saved to {output_path}")
