"""COCO-style detection evaluation (numpy, with a native matcher).

Counterpart of adam_dehaze_tpu/evaluation/coco_eval.py, producing the same
12-stat summary as pycocotools' COCOeval 'bbox': AP@[.5:.95], AP@.5,
AP@.75, AP small/medium/large, AR@{1,10,100}, AR small/medium/large.

- IoU thresholds 0.50:0.05:0.95; recall thresholds 0:0.01:1.
- Greedy per-image matching in score order; each GT matched at most once;
  crowd GTs may absorb extra detections and use intersection/det-area IoU.
- GTs outside the area range are "ignore"; detections matched to ignored
  GTs (or unmatched with their area outside the range) leave the PR curve.
- AP = mean of interpolated precision at the recall thresholds, averaged
  over IoU thresholds and the categories with GT present.

The inner matching loop is native/coco_match.cpp through ctypes, compiled
with g++ on first use into build/native/<hash>/ at the repository root
(listed in .gitignore); a failed build raises. `_match_image_py` is the
same algorithm in Python: `COCOEvaluator(gt, matcher="python")` takes it,
and the tests hold the two against each other.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)

_REPO = Path(__file__).resolve().parents[2]
NATIVE_SOURCE = _REPO / "native" / "coco_match.cpp"
BUILD_ROOT = _REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                 iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """IoU matrix (n_det, n_gt) for [x, y, w, h] boxes; crowd GTs use
    intersection / det-area (COCO convention)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.maximum(0, np.minimum(dx2[:, None], gx2[None]) -
                    np.maximum(dx1[:, None], gx1[None]))
    iy = np.maximum(0, np.minimum(dy2[:, None], gy2[None]) -
                    np.maximum(dy1[:, None], gy1[None]))
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = d_area + g_area - inter
    if iscrowd is not None and iscrowd.any():
        union = np.where(iscrowd[None].astype(bool), d_area, union)
    return inter / np.maximum(union, 1e-12)


@functools.lru_cache(maxsize=1)
def native_library() -> ctypes.CDLL:
    """The native matcher, compiled on first use (once per source hash and
    flags); raises with the compiler's message if the build fails."""
    src = NATIVE_SOURCE.read_bytes()
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    lib_path = out_dir / "libcocomatch.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".libcocomatch.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the COCO matcher failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.coco_match.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.coco_match.restype = None
    return lib


def _match_image_native(det_scores, ious, gt_ignore, gt_iscrowd, n_thrs):
    """Greedy COCO matching for one (image, category) in native code; the
    contract of `_match_image_py`."""
    lib = native_library()
    n_det, n_gt = ious.shape
    det_order = np.argsort(-det_scores, kind="stable").astype(np.int32)
    gt_order = np.argsort(gt_ignore.astype(int), kind="stable").astype(np.int32)
    ious_c = np.ascontiguousarray(ious, np.float64)
    gt_ig = np.ascontiguousarray(gt_ignore, np.uint8)
    gt_cr = np.ascontiguousarray(gt_iscrowd, np.uint8)
    thrs = np.ascontiguousarray(IOU_THRS[:n_thrs], np.float64)
    dtm = np.empty((n_thrs, n_det), np.int64)
    dt_ig = np.empty((n_thrs, n_det), np.uint8)

    def p(arr, ty):
        return arr.ctypes.data_as(ctypes.POINTER(ty))
    lib.coco_match(p(ious_c, ctypes.c_double), p(det_order, ctypes.c_int32),
                   p(gt_order, ctypes.c_int32), p(gt_ig, ctypes.c_uint8),
                   p(gt_cr, ctypes.c_uint8), p(thrs, ctypes.c_double),
                   n_det, n_gt, n_thrs, p(dtm, ctypes.c_int64), p(dt_ig, ctypes.c_uint8))
    return dtm, dt_ig.astype(bool)


def _match_image_py(det_scores, ious, gt_ignore, gt_iscrowd, n_thrs):
    """Greedy COCO matching for one (image, category).

    GTs are visited non-ignored first (pycocotools sorts them this way,
    which its early break relies on). Returns (dt_matched_gt [T, D] with -1
    unmatched, dt_ignore [T, D])."""
    n_det, n_gt = ious.shape
    det_order = np.argsort(-det_scores, kind="stable")
    gt_order = np.argsort(gt_ignore.astype(int), kind="stable")
    dtm = -np.ones((n_thrs, n_det), np.int64)
    dt_ig = np.zeros((n_thrs, n_det), bool)
    for ti, t in enumerate(IOU_THRS[:n_thrs]):
        gtm = np.zeros(n_gt, bool)
        for d in det_order:
            best_iou = min(t, 1 - 1e-10)
            best_g = -1
            for g in gt_order:
                if gtm[g] and not gt_iscrowd[g]:
                    continue
                # Matched to a non-ignored GT already, and the remaining
                # GTs are all ignored: stop (pycocotools' break).
                if best_g > -1 and not gt_ignore[best_g] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g >= 0:
                dtm[ti, d] = best_g
                dt_ig[ti, d] = gt_ignore[best_g]
                if not gt_iscrowd[best_g]:
                    gtm[best_g] = True
    return dtm, dt_ig


MATCHERS = {"native": _match_image_native, "python": _match_image_py}


class COCOEvaluator:
    """Evaluate detection results against COCO-format ground truth."""

    def __init__(self, gt: Dict, matcher: str = "native"):
        """gt: COCO dict with 'images', 'annotations', 'categories'.
        matcher: "native" (native/coco_match.cpp) or "python"."""
        self.images = {im["id"] for im in gt.get("images", [])}
        self.cat_ids = sorted({c["id"] for c in gt.get("categories", [])})
        self.gts: Dict = {}
        for ann in gt.get("annotations", []):
            self.gts.setdefault((ann["image_id"], ann["category_id"]), []).append(ann)
        self.matcher = matcher
        self._match = MATCHERS[matcher]

    def evaluate(self, results: Sequence[Dict]) -> Dict[str, float]:
        """results: [{image_id, category_id, bbox xywh, score}, ...] -> the
        12-stat dict with pycocotools' key names."""
        dets: Dict = {}
        for r in results:
            dets.setdefault((r["image_id"], r["category_id"]), []).append(r)

        stats_ap = {}
        stats_ar = {}
        for area_name, area_rng in AREA_RANGES.items():
            per_cat_prec = []   # (T, R) per category
            per_cat_rec = {m: [] for m in MAX_DETS}
            for cat in self.cat_ids or sorted({k[1] for k in self.gts}):
                ev = self._evaluate_category(cat, dets, area_rng)
                if ev is None:
                    continue
                prec, recalls = ev
                per_cat_prec.append(prec)
                for m in MAX_DETS:
                    per_cat_rec[m].append(recalls[m])
            if per_cat_prec:
                P = np.stack(per_cat_prec)  # (K, T, R)
                stats_ap[area_name] = {
                    "all_iou": float(np.mean(P[P > -1])) if (P > -1).any() else -1.0,
                    "iou50": _mean_valid(P[:, 0]),
                    "iou75": _mean_valid(P[:, 5]),
                }
                stats_ar[area_name] = {m: _mean_valid(np.stack(per_cat_rec[m]))
                                       for m in MAX_DETS}
            else:
                stats_ap[area_name] = {"all_iou": -1.0, "iou50": -1.0, "iou75": -1.0}
                stats_ar[area_name] = {m: -1.0 for m in MAX_DETS}

        return {
            "mAP": stats_ap["all"]["all_iou"],
            "mAP_50": stats_ap["all"]["iou50"],
            "mAP_75": stats_ap["all"]["iou75"],
            "mAP_small": stats_ap["small"]["all_iou"],
            "mAP_medium": stats_ap["medium"]["all_iou"],
            "mAP_large": stats_ap["large"]["all_iou"],
            "AR_1": stats_ar["all"][1],
            "AR_10": stats_ar["all"][10],
            "AR_100": stats_ar["all"][100],
            "AR_small": stats_ar["small"][100],
            "AR_medium": stats_ar["medium"][100],
            "AR_large": stats_ar["large"][100],
        }

    def _evaluate_category(self, cat, dets, area_rng):
        T, R = len(IOU_THRS), len(REC_THRS)
        n_gt_valid = 0
        img_ids = self.images or {k[0] for k in list(self.gts) + list(dets)}
        per_image = []
        for img in img_ids:
            g = self.gts.get((img, cat), [])
            d = sorted(dets.get((img, cat), []), key=lambda r: -r["score"])
            d = d[:MAX_DETS[-1]]
            if not g and not d:
                continue
            g_boxes = np.array([a["bbox"] for a in g], float).reshape(-1, 4)
            g_crowd = np.array([a.get("iscrowd", 0) for a in g], bool)
            g_area = np.array([a.get("area", b[2] * b[3]) for a, b in zip(g, g_boxes)], float)
            g_ignore = (g_area < area_rng[0]) | (g_area > area_rng[1]) | g_crowd
            d_boxes = np.array([r["bbox"] for r in d], float).reshape(-1, 4)
            d_scores = np.array([r["score"] for r in d], float)
            d_area = d_boxes[:, 2] * d_boxes[:, 3]
            ious = box_iou_xywh(d_boxes, g_boxes, g_crowd)
            dtm, dt_ig = self._match(d_scores, ious, g_ignore, g_crowd, T)
            # Unmatched dets outside the area range are ignored too.
            out_of_range = (d_area < area_rng[0]) | (d_area > area_rng[1])
            dt_ig = dt_ig | ((dtm == -1) & out_of_range[None])
            n_gt_valid += int((~g_ignore).sum())
            per_image.append((d_scores, dtm, dt_ig))
        if n_gt_valid == 0:
            return None

        recalls_at_m = {}
        prec_out = -np.ones((T, R))
        for max_det in MAX_DETS:
            scores = np.concatenate([p[0][:max_det] for p in per_image]) \
                if per_image else np.zeros(0)
            matched = np.concatenate([p[1][:, :max_det] for p in per_image], axis=1) \
                if per_image else np.zeros((T, 0))
            ignored = np.concatenate([p[2][:, :max_det] for p in per_image], axis=1) \
                if per_image else np.zeros((T, 0), bool)
            order = np.argsort(-scores, kind="mergesort")
            matched = matched[:, order]
            ignored = ignored[:, order]
            tps = (matched > -1) & ~ignored
            fps = (matched == -1) & ~ignored
            tp_cum = np.cumsum(tps, axis=1).astype(float)
            fp_cum = np.cumsum(fps, axis=1).astype(float)
            rc = tp_cum / n_gt_valid
            pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            recalls_at_m[max_det] = rc[:, -1] if rc.shape[1] else np.zeros(T)
            if max_det == MAX_DETS[-1]:
                for ti in range(T):
                    p = pr[ti].copy()
                    if len(p) == 0:
                        prec_out[ti] = 0.0
                        continue
                    # Interpolated precision (monotone non-increasing).
                    for i in range(len(p) - 1, 0, -1):
                        p[i - 1] = max(p[i - 1], p[i])
                    idx = np.searchsorted(rc[ti], REC_THRS, side="left")
                    safe = np.minimum(idx, len(p) - 1)
                    prec_out[ti] = np.where(idx < len(p), p[safe], 0.0)
        return prec_out, {m: recalls_at_m[m] for m in MAX_DETS}


def _mean_valid(arr: np.ndarray) -> float:
    valid = arr[arr > -1]
    return float(valid.mean()) if valid.size else -1.0
