"""Dataset preprocessing, splitting and synthetic dataset generation of
the port.

Counterpart of adam_dehaze_tpu/data/preprocessing.py:
`resize_and_normalize` and `preprocess_dataset` resize every
hazy/clear/dehazed triplet to the target size and re-encode it;
`split_dataset` copies the triplets into a seeded 70/15/15
{train,val,test}/{intensity}/{role} split (numpy's `default_rng`: the same
split as the JAX package's); `generate_synthetic_dataset` writes a complete
{split}/{intensity}/{hazy,clear,dehazed} tree from procedural clear images
(`_procedural_clear_image`, numpy's `default_rng`: the JAX package's scenes,
draw for draw) and the port's fog model (data/synthetic.py, its draws from a
`torch.Generator`, so the fog parameters differ from the JAX package's).
Images are written with OpenCV, as the JAX package writes them.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from adam_dehaze_tpu_torch.data.dataset import INTENSITY_MAP
from adam_dehaze_tpu_torch.data.synthetic import apply_fog, random_fog_params


def _write_rgb(path: str, img01: np.ndarray) -> None:
    """Write an (H, W, 3) RGB image in [0, 1] as 8 bits (truncated, as the
    JAX package writes)."""
    import cv2
    os.makedirs(os.path.dirname(path), exist_ok=True)
    u8 = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    cv2.imwrite(path, cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))


_ROLES = ("hazy", "clear", "dehazed")


def resize_and_normalize(img: np.ndarray, size: int = 256) -> np.ndarray:
    """An (H, W, 3) image resized to size x size (OpenCV's bilinear) as
    float32, divided by 255 when its values exceed 1."""
    import cv2
    if img.shape[0] != size or img.shape[1] != size:
        img = cv2.resize(img, (size, size))
    img = img.astype(np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    return img


def preprocess_dataset(raw_dir: str, processed_dir: str, size: int = 256) -> int:
    """Resize and re-encode every {intensity}/{hazy,clear,dehazed}/<name>
    triplet under raw_dir into processed_dir (a triplet with a role
    missing or unreadable is skipped); returns the number written."""
    import cv2
    count = 0
    for intensity in INTENSITY_MAP:
        hazy_dir = os.path.join(raw_dir, intensity, "hazy")
        if not os.path.isdir(hazy_dir):
            continue
        for name in sorted(os.listdir(hazy_dir)):
            if not name.endswith((".jpg", ".png")):
                continue
            imgs = {}
            for role in _ROLES:
                img = cv2.imread(os.path.join(raw_dir, intensity, role, name))
                if img is None:
                    break
                imgs[role] = resize_and_normalize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), size)
            if len(imgs) < len(_ROLES):
                continue
            for role, img in imgs.items():
                _write_rgb(os.path.join(processed_dir, intensity, role, name), img)
            count += 1
    return count


def split_dataset(processed_dir: str, train_ratio: float = 0.7, val_ratio: float = 0.15,
                  test_ratio: float = 0.15, seed: int = 42) -> Dict[str, int]:
    """Copy each intensity's triplets into {split}/{intensity}/{role}/ by a
    seeded permutation: the first train_ratio of it to train, the next
    val_ratio to val, the rest to test (test_ratio is what is left, as in
    the JAX package). Returns the triplets per split."""
    import shutil
    rng = np.random.default_rng(seed)
    counts = {"train": 0, "val": 0, "test": 0}
    for intensity in INTENSITY_MAP:
        hazy_dir = os.path.join(processed_dir, intensity, "hazy")
        if not os.path.isdir(hazy_dir):
            continue
        names = sorted(n for n in os.listdir(hazy_dir) if n.endswith((".jpg", ".png")))
        order = rng.permutation(len(names))
        n_train = int(len(names) * train_ratio)
        n_val = int(len(names) * val_ratio)
        assignments = (["train"] * n_train + ["val"] * n_val
                       + ["test"] * (len(names) - n_train - n_val))
        for pos, split in zip(order, assignments):
            for role in _ROLES:
                src = os.path.join(processed_dir, intensity, role, names[pos])
                dst = os.path.join(processed_dir, split, intensity, role, names[pos])
                if os.path.exists(src):
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copy2(src, dst)
            counts[split] += 1
    return counts


def _procedural_clear_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """A structured random 'scene': gradient sky + coloured rectangles."""
    img = np.zeros((size, size, 3), np.float32)
    base = rng.random(3) * 0.4 + 0.3
    grad = np.linspace(0.0, 1.0, size)[:, None, None]
    img += base * (0.6 + 0.4 * grad)
    for _ in range(rng.integers(4, 9)):
        h0, w0 = rng.integers(0, size - 4, 2)
        h1 = h0 + rng.integers(3, max(4, size // 2))
        w1 = w0 + rng.integers(3, max(4, size // 2))
        img[h0:h1, w0:w1] = rng.random(3)
    return np.clip(img, 0, 1)


def generate_synthetic_dataset(root: str, n_per_class: int = 4, size: int = 64,
                               seed: int = 0,
                               splits: Dict[str, float] = None) -> int:
    """Write a complete {split}/{intensity}/{hazy,clear,dehazed} tree of
    procedural scenes under the atmospheric-scattering fog model; returns
    the number of triplets written."""
    splits = splits or {"train": 0.5, "val": 0.25, "test": 0.25}
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    total = 0
    for intensity, label in INTENSITY_MAP.items():
        split_names: List[str] = []
        for s, frac in splits.items():
            split_names += [s] * max(1, int(round(n_per_class * frac)))
        split_names = split_names[:n_per_class]
        while len(split_names) < n_per_class:
            split_names.append("train")
        for i in range(n_per_class):
            clear = _procedural_clear_image(rng, size)
            beta, A = random_fog_params(gen, torch.tensor([label]), 1)
            hazy = apply_fog(torch.from_numpy(clear[None]), beta, A)[0].numpy()
            # The 'dehazed' role: a plausible stand-in (a blend).
            dehazed = np.clip(0.7 * clear + 0.3 * hazy, 0, 1)
            name = f"{intensity}_{i:04d}.png"
            split = split_names[i]
            for role, img in (("hazy", hazy), ("clear", clear), ("dehazed", dehazed)):
                _write_rgb(os.path.join(root, split, intensity, role, name), img)
            total += 1
    return total
