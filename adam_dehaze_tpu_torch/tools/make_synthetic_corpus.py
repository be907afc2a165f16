"""Generate a synthetic fog corpus with detection ground truth.

    python -m adam_dehaze_tpu_torch.tools.make_synthetic_corpus --out DIR \\
        [--size 256] [--train 200] [--val 50] [--test 50] [--seed 0]

(counts are per intensity class). The port's counterpart of
tools/make_synthetic_corpus.py, with the same layout:

  {out}/{train,val,test}/{low,medium,high}/{hazy,clear,dehazed}/{split}_{level}_NNNN.png
  {out}/annotations/{split}_{level}_NNNN.json   per-image detection GT
  {out}/annotations/coco_{level}.json           per-intensity COCO GT (test)

Procedural clear scenes (sky gradient, textured ground, shaded and
striped blocks, discs) come from numpy's `default_rng(seed)`, exactly as in
the JAX tool, so both write the same clear images and annotations for one
seed and size. The drawn structures are the ground truth: category 1 =
block (rectangle), category 2 = disc. Fog follows the atmospheric
scattering model (data/synthetic.py:apply_fog) with each class's (beta, A)
range shrunk by `--margin` a side; its uniform draws come from a
`torch.Generator(seed)`, so the hazy images differ from the JAX tool's
(whose draws are jax.random's) except where the same fog parameters are
given. `dehazed/` holds the clear image.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from adam_dehaze_tpu_torch.data.synthetic import INTENSITY_NAMES, INTENSITY_RANGES, apply_fog

CATEGORIES = [{"id": 1, "name": "block"}, {"id": 2, "name": "disc"}]
LEVELS = ("low", "medium", "high")
CHUNK = 25     # images fogged per call


def _octave_noise(rng: np.random.Generator, size: int, octaves: int = 5,
                  persistence: float = 0.55) -> np.ndarray:
    """Multi-octave value noise in [-1, 1] (1/f-like texture)."""
    import cv2

    acc = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cells = max(2, size // (2 ** (octaves - o + 1)))
        grid = rng.standard_normal((cells, cells)).astype(np.float32)
        acc += amp * cv2.resize(grid, (size, size), interpolation=cv2.INTER_CUBIC)
        total += amp
        amp *= persistence
    acc /= total
    return np.clip(acc / (2.5 * acc.std() + 1e-6), -1.0, 1.0)


def make_clear_scene(rng: np.random.Generator, size: int):
    """One procedural street scene: (image (size, size, 3) f32 in [0, 1],
    boxes [x, y, w, h], labels)."""
    import cv2

    img = np.zeros((size, size, 3), np.float32)
    horizon = rng.integers(size // 3, 2 * size // 3)
    sky_top = rng.uniform(0.5, 0.9, 3)
    sky_bot = sky_top * rng.uniform(0.7, 1.0)
    rows = np.linspace(0, 1, horizon)[:, None, None]
    img[:horizon] = sky_top * (1 - rows) + sky_bot * rows
    clouds = _octave_noise(rng, size, octaves=3)[:horizon]
    img[:horizon] += 0.08 * clouds[..., None]
    ground = rng.uniform(0.15, 0.45, 3)
    gtex = _octave_noise(rng, size)[size - (size - horizon):]
    img[horizon:] = ground * (1.0 + 0.35 * gtex[..., None])

    ys = np.arange(size, dtype=np.float32)
    xs = np.arange(size, dtype=np.float32)

    boxes, labels = [], []
    for _ in range(rng.integers(4, 10)):  # buildings / vehicles
        w = int(rng.integers(size // 10, size // 3))
        h = int(rng.integers(size // 8, size // 2))
        x0 = int(rng.integers(0, size - w))
        y0 = int(rng.integers(max(horizon - h, 0), size - h))
        color = rng.uniform(0.1, 0.8, 3)
        patch = np.broadcast_to(color, (h, w, 3)).copy()
        shade = (0.75 + 0.5 * np.linspace(1, 0, h))[:, None, None]
        patch *= shade
        pitch = int(rng.integers(max(3, size // 64), max(6, size // 16)))
        phase = rng.integers(0, pitch)
        if rng.random() < 0.5:
            mask = ((ys[y0:y0 + h].astype(int) + phase) % pitch) < pitch // 2
            patch[mask] *= rng.uniform(0.55, 0.85)
        else:
            mask = ((xs[x0:x0 + w].astype(int) + phase) % pitch) < pitch // 2
            patch[:, mask] *= rng.uniform(0.55, 0.85)
        fine = _octave_noise(rng, max(h, w))[:h, :w]
        patch *= (1.0 + 0.18 * fine[..., None])
        img[y0:y0 + h, x0:x0 + w] = np.clip(patch, 0.0, 1.0)
        boxes.append([x0, y0, w, h])
        labels.append(1)
    for _ in range(rng.integers(2, 6)):  # round features
        cx = int(rng.integers(0, size))
        cy = int(rng.integers(horizon, size))
        r = int(rng.integers(size // 30, size // 8))
        color = rng.uniform(0.1, 0.9, 3)
        disc = np.zeros((size, size), np.float32)
        cv2.circle(disc, (cx, cy), r, 1.0, -1)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        rad = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / max(r, 1)
        shading = np.clip(1.15 - 0.45 * rad, 0.4, 1.15)
        sel = disc > 0
        img[sel] = np.clip(color * shading[sel, None], 0.0, 1.0)
        x0, y0 = max(cx - r, 0), max(cy - r, 0)
        x1, y1 = min(cx + r, size), min(cy + r, size)
        if x1 > x0 and y1 > y0:
            boxes.append([x0, y0, x1 - x0, y1 - y0])
            labels.append(2)

    noise = rng.normal(0, 0.02, img.shape).astype(np.float32)
    tex = 0.06 * _octave_noise(rng, size)
    return np.clip(img + noise + tex[..., None], 0.0, 1.0), boxes, labels


def fog_with_margin(clear: np.ndarray, intensity: int, ub: torch.Tensor, ua: torch.Tensor,
                    margin: float) -> np.ndarray:
    """Fog (N, H, W, 3) clear images of one class: beta and A at the
    uniforms `ub`, `ua` (N,) within the class's ranges shrunk by `margin`
    a side."""
    (b_lo, b_hi), (a_lo, a_hi) = INTENSITY_RANGES[INTENSITY_NAMES[intensity]]
    t = torch.tensor([b_lo, b_hi, a_lo, a_hi], dtype=torch.float32)
    lo_b, hi_b = t[0] + margin * (t[1] - t[0]), t[1] - margin * (t[1] - t[0])
    lo_a, hi_a = t[2] + margin * (t[3] - t[2]), t[3] - margin * (t[3] - t[2])
    beta = lo_b + ub * (hi_b - lo_b)
    A = lo_a + ua * (hi_a - lo_a)
    return apply_fog(torch.from_numpy(clear), beta, A).numpy()


def _write_png(path: str, image: np.ndarray) -> None:
    import cv2
    cv2.imwrite(path, (np.clip(image, 0, 1) * 255).astype(np.uint8))


def make_corpus(out: str, size: int = 256, train: int = 200, val: int = 50, test: int = 50,
                seed: int = 0, margin: float = 0.15) -> int:
    """Write the corpus under `out`; returns the number of triplets."""
    ann_dir = os.path.join(out, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    coco = {level: {"images": [], "annotations": [], "categories": CATEGORIES}
            for level in LEVELS}
    ann_id = {level: 1 for level in LEVELS}
    total = 0
    for split, n in (("train", train), ("val", val), ("test", test)):
        for ci, level in enumerate(LEVELS):
            dirs = {s: os.path.join(out, split, level, s) for s in ("hazy", "clear", "dehazed")}
            for d in dirs.values():
                os.makedirs(d, exist_ok=True)
            done = 0
            while done < n:
                m = min(CHUNK, n - done)
                scenes = [make_clear_scene(rng, size) for _ in range(m)]
                clear = np.stack([s[0] for s in scenes])
                ub = torch.rand(m, generator=gen)
                ua = torch.rand(m, generator=gen)
                hazy = fog_with_margin(clear, ci, ub, ua, margin)
                for i in range(m):
                    # Unique per (split, level): the annotation files share
                    # one directory (data/detection.py reads {base}.json).
                    name = f"{split}_{level}_{done + i:04d}.png"
                    for role, arr in (("hazy", hazy[i]), ("clear", clear[i]),
                                      ("dehazed", clear[i])):
                        _write_png(os.path.join(dirs[role], name), arr)
                    anns = [{"bbox": [float(v) for v in box], "category_id": int(lab),
                             "area": float(box[2] * box[3]), "iscrowd": 0}
                            for box, lab in zip(scenes[i][1], scenes[i][2])]
                    with open(os.path.join(ann_dir, f"{os.path.splitext(name)[0]}.json"),
                              "w") as f:
                        json.dump({"annotations": anns}, f)
                    if split == "test":
                        img_id = len(coco[level]["images"]) + 1
                        coco[level]["images"].append({"id": img_id, "file_name": name,
                                                      "width": size, "height": size})
                        for a in anns:
                            coco[level]["annotations"].append(
                                {**a, "id": ann_id[level], "image_id": img_id})
                            ann_id[level] += 1
                done += m
                total += m
            print(f"{split}/{level}: {n} triplets")
    for level, gt in coco.items():
        with open(os.path.join(ann_dir, f"coco_{level}.json"), "w") as f:
            json.dump(gt, f)
    print(f"Wrote {total} triplets under {out} (+ detection GT)")
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--train", type=int, default=200)
    p.add_argument("--val", type=int, default=50)
    p.add_argument("--test", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--margin", type=float, default=0.15,
                   help="Shrink each class's (beta, A) range by this fraction a side, "
                        "so that the classes do not touch at their edges; 0 keeps "
                        "the raw table.")
    args = p.parse_args(argv)
    make_corpus(args.out, args.size, args.train, args.val, args.test, args.seed, args.margin)


if __name__ == "__main__":
    main()
