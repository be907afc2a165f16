"""Visualisation utilities of the port, drawn with OpenCV.

Counterpart of adam_dehaze_tpu/utils/visualize.py, function by function,
with the same file names and the same panels: the JAX package draws them
with matplotlib, which the GPU machine does not have, so the port draws
them with OpenCV, as it reads and writes every image. All functions take
NHWC float [0, 1] numpy arrays and write PNGs.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

_PANEL = 256          # side of one image panel, px
_TITLE = 24           # height of a panel's title bar, px
_BG = (255, 255, 255)
_INK = (0, 0, 0)
# BGR colours of successive series (matplotlib's first four defaults).
_COLOURS = ((180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214))


def _save(path: str, canvas_bgr: np.ndarray):
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, canvas_bgr)


def _text(canvas, text: str, org, scale: float = 0.5, colour=_INK):
    import cv2
    cv2.putText(canvas, text, (int(org[0]), int(org[1])), cv2.FONT_HERSHEY_SIMPLEX, scale,
                colour, 1, cv2.LINE_AA)


def _panel(img: np.ndarray, title: str = "") -> np.ndarray:
    """One RGB [0, 1] image as a BGR uint8 panel under a title bar."""
    import cv2
    u8 = (np.clip(np.asarray(img, np.float32), 0, 1) * 255).astype(np.uint8)
    u8 = cv2.resize(cv2.cvtColor(u8, cv2.COLOR_RGB2BGR), (_PANEL, _PANEL),
                    interpolation=cv2.INTER_NEAREST)
    bar = np.full((_TITLE, _PANEL, 3), 255, np.uint8)
    if title:
        _text(bar, title, (4, _TITLE - 7))
    return np.concatenate([bar, u8], axis=0)


def _grid(panels: List[np.ndarray], ncols: int) -> np.ndarray:
    blank = np.full_like(panels[0], 255)
    rows = []
    for r in range(0, len(panels), ncols):
        row = panels[r:r + ncols]
        row += [blank] * (ncols - len(row))
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def visualize_comparison(hazy, dehazed, clear, path: str,
                         titles=("Hazy", "Dehazed", "Clear"),
                         extra_text: Optional[Sequence[str]] = None):
    """Rows of hazy/dehazed/clear triptychs."""
    panels = []
    for i in range(len(hazy)):
        for j, img in enumerate((hazy[i], dehazed[i], clear[i])):
            title = titles[j] if i == 0 else ""
            if j == 0 and extra_text and i < len(extra_text):
                title = f"{title} {extra_text[i]}".strip()
            panels.append(_panel(img, title))
    _save(path, _grid(panels, 3))


def visualize_detections(image, detections: Dict, path: str,
                         score_threshold: float = 0.5):
    """Detection boxes with label:score above the threshold."""
    import cv2
    h, w = np.asarray(image).shape[:2]
    canvas = _panel(image)[_TITLE:].copy()
    sx, sy = _PANEL / w, _PANEL / h
    for box, score, label in zip(detections["boxes"], detections["scores"],
                                 detections["labels"]):
        if score < score_threshold:
            continue
        x1, y1, x2, y2 = box
        cv2.rectangle(canvas, (int(x1 * sx), int(y1 * sy)), (int(x2 * sx), int(y2 * sy)),
                      (0, 255, 0), 2)
        _text(canvas, f"{int(label)}:{score:.2f}", (x1 * sx, max(y1 * sy - 3, 10)), 0.4,
              (0, 255, 0))
    _save(path, canvas)


def _bars(values: np.ndarray, names: Sequence[str], ylabel: str, title: str = "",
          xlabels: Optional[Sequence[str]] = None) -> np.ndarray:
    """Stacked bars: values (n, k), series k named `names`."""
    import cv2
    n, k = values.shape
    bar_w, left, top, plot_h = 40, 60, 30, 200
    width = max(320, left + n * bar_w + 20)
    canvas = np.full((top + plot_h + 60, width, 3), 255, np.uint8)
    vmax = max(float(values.sum(axis=1).max()), 1e-12)
    base = top + plot_h
    for i in range(n):
        y = base
        for s in range(k):
            hgt = int(round(plot_h * max(float(values[i, s]), 0.0) / vmax))
            x0 = left + i * bar_w + 5
            cv2.rectangle(canvas, (x0, y - hgt), (x0 + bar_w - 10, y), _COLOURS[s % 4], -1)
            y -= hgt
        label = xlabels[i] if xlabels else str(i)
        _text(canvas, label, (left + i * bar_w + 5, base + 16), 0.35)
    cv2.line(canvas, (left, base), (width - 10, base), _INK, 1)
    cv2.line(canvas, (left, top), (left, base), _INK, 1)
    _text(canvas, f"{vmax:.3g}", (4, top + 5), 0.35)
    _text(canvas, ylabel, (4, base + 40), 0.4)
    _text(canvas, title, (left, 20), 0.5)
    if k > 1:
        for s, name in enumerate(names):
            cv2.rectangle(canvas, (width - 90, top + 16 * s), (width - 80, top + 16 * s + 10),
                          _COLOURS[s % 4], -1)
            _text(canvas, name, (width - 75, top + 16 * s + 10), 0.4)
    return canvas


def visualize_routing_weights(weights: np.ndarray, path: str,
                              names=("low", "medium", "high")):
    """Per-sample routing-weight bars, stacked by branch."""
    weights = np.asarray(weights, np.float32)
    _save(path, _bars(weights[:, :len(names)], names, "routing weight / sample"))


def visualize_montage(images: Sequence[np.ndarray], path: str, ncols: int = 4,
                      titles: Optional[Sequence[str]] = None):
    """Grid montage."""
    panels = [_panel(img, titles[i] if titles and i < len(titles) else "")
              for i, img in enumerate(images)]
    _save(path, _grid(panels, ncols))


def plot_training_curves(jsonl_path: str, out_path: str,
                         keys: Sequence[str] = ("train/loss", "val/loss")):
    """Metric curves over epochs from a MetricsLogger JSONL stream."""
    import cv2
    steps: Dict[str, List] = {k: [] for k in keys}
    vals: Dict[str, List] = {k: [] for k in keys}
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            for k in keys:
                if k in rec:
                    steps[k].append(rec["step"])
                    vals[k].append(rec[k])
    left, top, pw, ph = 60, 20, 400, 240
    canvas = np.full((top + ph + 50, left + pw + 20, 3), 255, np.uint8)
    xs = [s for k in keys for s in steps[k]] or [0]
    ys = [v for k in keys for v in vals[k]] or [0.0]
    x0, x1 = min(xs), max(max(xs), min(xs) + 1)
    y0, y1 = min(ys), max(max(ys), min(ys) + 1e-12)
    for i, k in enumerate(keys):
        if not steps[k]:
            continue
        pts = np.array([[left + (s - x0) / (x1 - x0) * pw, top + ph - (v - y0) / (y1 - y0) * ph]
                        for s, v in zip(steps[k], vals[k])], np.int32)
        cv2.polylines(canvas, [pts], False, _COLOURS[i % 4], 2, cv2.LINE_AA)
        _text(canvas, k, (left + pw - 120, top + 16 * (i + 1)), 0.45, _COLOURS[i % 4])
    cv2.rectangle(canvas, (left, top), (left + pw, top + ph), _INK, 1)
    _text(canvas, f"{y1:.3g}", (4, top + 5), 0.35)
    _text(canvas, f"{y0:.3g}", (4, top + ph), 0.35)
    _text(canvas, "epoch", (left + pw // 2, top + ph + 35), 0.45)
    _save(out_path, canvas)


def plot_summary_chart(summary: Dict[str, float], path: str,
                       title: str = "Evaluation summary"):
    """Bar chart of scalar results."""
    keys = list(summary)
    values = np.asarray([[summary[k]] for k in keys], np.float32)
    _save(path, _bars(values, ["value"], "", title=title, xlabels=keys))
