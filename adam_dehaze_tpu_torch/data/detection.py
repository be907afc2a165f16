"""Detection dataset: images + COCO-format boxes.

Counterpart of adam_dehaze_tpu/data/detection.py, with the same batches:
it walks {split}/{intensity}/hazy, pairs each image with a per-image
`{base}.json` or a shared `instances.json` annotation, resizes to a square
detection resolution and applies ImageNet normalisation. Boxes are padded
to `max_boxes` with a validity count per image, so batches keep static
shapes. The deterministic train-time augmentation draws from numpy's
`default_rng` seeded by (seed, epoch, index) and resizes with OpenCV, as
the JAX package does, so the port's batches equal its batches.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from adam_dehaze_tpu_torch.data.dataset import DataLoader
from adam_dehaze_tpu_torch.data.native_collate import normalize_u8
from adam_dehaze_tpu_torch.parallel.multihost import shard_loader_for_host

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class DetectionDataset:
    """Samples: {hazy (normalised image; also under clear and dehazed),
    boxes xyxy, labels, n_boxes, intensity, name}."""

    def __init__(self, root_dir: str, annotation_dir: str, split: str = "test",
                 img_size: int = 512, max_boxes: int = 64,
                 image_source: str = "hazy", augment: bool = False,
                 seed: int = 0):
        """image_source: "hazy" for evaluation; "clear" for training the
        detector on clean frames (falls back per image to the hazy one
        where no clear counterpart exists). The trainer sets `epoch` to
        reseed the augmentation."""
        self.root_dir = os.path.join(root_dir, split)
        self.annotation_dir = annotation_dir
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.augment = augment
        self.seed = seed
        self.epoch = 0
        self.samples: List[Dict] = []
        for intensity in ("low", "medium", "high"):
            hazy_dir = os.path.join(self.root_dir, intensity, "hazy")
            if not os.path.isdir(hazy_dir):
                continue
            for name in sorted(os.listdir(hazy_dir)):
                if not name.endswith((".jpg", ".png")):
                    continue
                base = os.path.splitext(name)[0]
                ann = os.path.join(self.annotation_dir, f"{base}.json")
                if not os.path.exists(ann):
                    ann = os.path.join(self.annotation_dir, "instances.json")
                if not os.path.exists(ann):
                    continue
                path = os.path.join(hazy_dir, name)
                if image_source == "clear":
                    clear = os.path.join(self.root_dir, intensity, "clear", name)
                    if os.path.exists(clear):
                        path = clear
                self.samples.append({"hazy": path, "annotation": ann, "name": name,
                                     "intensity": intensity})
        print(f"Loaded {len(self.samples)} samples for detection evaluation")

    def __len__(self):
        return len(self.samples)

    def _augment(self, raw, boxes, labels, idx: int):
        """Deterministic per-(seed, epoch, idx) augmentation on the fixed
        (img_size, img_size) canvas: horizontal flip, content scale jitter
        (paste smaller content at a random offset, or crop a window out of
        larger content, dropping boxes less than a quarter visible) and a
        mild photometric gain."""
        import cv2

        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + idx)
        size = self.img_size
        b = np.asarray(boxes, np.float32).reshape(-1, 4)
        lb = np.asarray(labels, np.int64).reshape(-1)

        if rng.random() < 0.5:  # horizontal flip
            raw = np.ascontiguousarray(raw[:, ::-1])
            b = np.stack([size - b[:, 2], b[:, 1], size - b[:, 0], b[:, 3]], axis=1)

        scale = float(rng.uniform(0.6, 1.2))
        new = max(32, int(round(size * scale)))
        if new != size:
            content = cv2.resize(raw, (new, new))
            b = b * (new / size)
            if new < size:
                ox = int(rng.integers(0, size - new + 1))
                oy = int(rng.integers(0, size - new + 1))
                canvas = np.full((size, size, 3), raw.mean(axis=(0, 1)), np.uint8)
                canvas[oy:oy + new, ox:ox + new] = content
                raw = canvas
                b = b + np.array([ox, oy, ox, oy], np.float32)
            else:
                ox = int(rng.integers(0, new - size + 1))
                oy = int(rng.integers(0, new - size + 1))
                raw = np.ascontiguousarray(content[oy:oy + size, ox:ox + size])
                area0 = np.maximum((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]), 1e-6)
                b = b - np.array([ox, oy, ox, oy], np.float32)
                b = np.stack([b[:, 0].clip(0, size), b[:, 1].clip(0, size),
                              b[:, 2].clip(0, size), b[:, 3].clip(0, size)], axis=1)
                vis = (b[:, 2] - b[:, 0]).clip(0) * (b[:, 3] - b[:, 1]).clip(0)
                keep = vis / area0 >= 0.25
                b, lb = b[keep], lb[keep]

        gain = float(rng.uniform(0.9, 1.1))
        if abs(gain - 1.0) > 1e-3:
            raw = np.clip(raw.astype(np.float32) * gain, 0, 255).astype(np.uint8)
        return raw, b.tolist(), lb.tolist()

    def load(self, idx: int) -> Dict:
        import cv2

        s = self.samples[idx]
        raw = cv2.imread(s["hazy"])
        if raw is None:
            raise FileNotFoundError(s["hazy"])
        oh, ow = raw.shape[:2]
        sx, sy = self.img_size / ow, self.img_size / oh
        raw = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
        if (oh, ow) != (self.img_size, self.img_size):
            raw = cv2.resize(raw, (self.img_size, self.img_size))
        with open(s["annotation"]) as f:
            ann = json.load(f)
        boxes, labels = [], []
        for obj in ann.get("annotations", []):
            # bbox [x, y, w, h] in the original image's pixels, rescaled to
            # the square detection resolution.
            x, y, w, h = obj["bbox"]
            boxes.append([x * sx, y * sy, (x + w) * sx, (y + h) * sy])
            labels.append(obj["category_id"])
        if self.augment:
            raw, boxes, labels = self._augment(raw, boxes, labels, idx)
        img = normalize_u8(raw, mean=IMAGENET_MEAN, std=IMAGENET_STD)
        boxes_arr = np.zeros((self.max_boxes, 4), np.float32)
        labels_arr = np.zeros((self.max_boxes,), np.int32)
        n = min(len(boxes), self.max_boxes)
        if n:
            boxes_arr[:n] = np.asarray(boxes[:n], np.float32)
            labels_arr[:n] = np.asarray(labels[:n], np.int32)
        return {
            "hazy": img,
            "clear": img,      # the triplet batch contract
            "dehazed": img,
            "boxes": boxes_arr,
            "labels": labels_arr,
            "n_boxes": np.int32(n),
            "intensity": np.int32({"low": 0, "medium": 1, "high": 2}[s["intensity"]]),
            "name": s["name"],
        }


def get_detection_dataloader(config, split: str = "test", img_size: int = 512,
                             image_source: str = "hazy", shard_per_host: bool = True,
                             augment: bool = False, shuffle: bool = False) -> DataLoader:
    """Batches of `batch_size // 2` from {root}/{split} with annotations
    under {root}/annotations. Under a torch.distributed group of more than
    one process each process reads its strided shard unless
    `shard_per_host` is False (parallel/multihost.py)."""
    key = {"train": "train_path", "val": "val_path"}.get(split, "test_path")
    root = config["dataset"][key]
    ds = DetectionDataset(root_dir=root, annotation_dir=os.path.join(root, "annotations"),
                          split=split, img_size=img_size, image_source=image_source,
                          augment=augment, seed=config.get("seed", 0))
    loader = DataLoader(ds, batch_size=max(config["dataset"]["batch_size"] // 2, 1),
                        shuffle=shuffle, num_workers=config["dataset"]["num_workers"],
                        drop_remainder=shuffle)
    return shard_loader_for_host(loader) if shard_per_host else loader
