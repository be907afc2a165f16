"""Host-side data pipeline of the port.

Counterpart of adam_dehaze_tpu/data/dataset.py, with the same contract:

- batches are dicts of NHWC float32 numpy arrays in [0, 1] with static
  shapes: the train split drops the remainder batch; otherwise the last
  batch is padded and a `mask` marks its valid rows;
- decoding runs in a thread pool with a bounded lookahead queue;
- the shuffle is numpy's `default_rng(seed)`, so the batch order equals the
  JAX loader's;
- augmentation is not done here: it runs on the device inside the train
  step (data/augment.py).

Directory contract:
  {root}/{split}/{low,medium,high}/{hazy,clear,dehazed}/img.png
with the same image name in all three roles. Images are read with OpenCV,
as the JAX package reads them.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from adam_dehaze_tpu_torch.data.native_collate import normalize_u8
from adam_dehaze_tpu_torch.parallel.multihost import shard_loader_for_host

INTENSITY_MAP = {"low": 0, "medium": 1, "high": 2}


def _imread_rgb(path: str, img_size: Optional[int] = None) -> np.ndarray:
    """An image file as (H, W, 3) float32 RGB in [0, 1], resized to
    img_size x img_size when given."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img_size is not None and img.shape[:2] != (img_size, img_size):
        img = cv2.resize(img, (img_size, img_size))
    return normalize_u8(img)


class HazyImageDataset:
    """Triplet dataset: {hazy, clear, dehazed, intensity, name}."""

    def __init__(self, root_dir: str, split: str = "train", img_size: int = 256):
        self.root_dir = os.path.join(root_dir, split)
        self.img_size = img_size
        self.split = split
        self.samples: List[Dict] = []
        for intensity in ("low", "medium", "high"):
            hazy_dir = os.path.join(self.root_dir, intensity, "hazy")
            clear_dir = os.path.join(self.root_dir, intensity, "clear")
            dehazed_dir = os.path.join(self.root_dir, intensity, "dehazed")
            if not os.path.isdir(hazy_dir):
                continue
            for name in sorted(os.listdir(hazy_dir)):
                if not name.endswith((".jpg", ".png")):
                    continue
                paths = {k: os.path.join(d, name) for k, d in
                         (("hazy", hazy_dir), ("clear", clear_dir),
                          ("dehazed", dehazed_dir))}
                if all(os.path.exists(p) for p in paths.values()):
                    self.samples.append({**paths,
                                         "intensity": INTENSITY_MAP[intensity],
                                         "name": name})
        print(f"Loaded {len(self.samples)} samples for {split} split")

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, idx: int) -> Dict:
        s = self.samples[idx]
        return {
            "hazy": _imread_rgb(s["hazy"], self.img_size),
            "clear": _imread_rgb(s["clear"], self.img_size),
            "dehazed": _imread_rgb(s["dehazed"], self.img_size),
            "intensity": np.int32(s["intensity"]),
            "name": s["name"],
        }


class DataLoader:
    """Threaded, prefetching batch iterator yielding dict batches.

    Static batch shapes: when `drop_remainder` (default for training) the
    final partial batch is dropped; otherwise it is padded up to batch_size
    and a `mask` array marks valid rows.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_remainder: Optional[bool] = None,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_remainder = shuffle if drop_remainder is None else drop_remainder
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _collate(self, items: List[Dict]) -> Dict:
        n_valid = len(items)
        pad = self.batch_size - n_valid
        if pad:
            items = items + [items[-1]] * pad
        batch: Dict = {}
        for k, v in items[0].items():
            if isinstance(v, (np.ndarray, np.generic)):
                batch[k] = np.stack([it[k] for it in items])
            else:
                batch[k] = [it[k] for it in items]
        batch["mask"] = np.arange(self.batch_size) < n_valid
        return batch

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                        items = list(pool.map(self.dataset.load, idxs))
                        if not put(self._collate(items)):
                            return
                put(None)
            except Exception as e:      # a failed read: raised in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join(timeout=10)


def get_dataloader(config, split: str = "train", seed: Optional[int] = None,
                   shard_per_host: bool = True) -> DataLoader:
    """The loader of one split under the config's dataset section.

    Under a torch.distributed group of more than one process, each process
    reads only its strided shard (parallel/multihost.py:
    shard_loader_for_host, seeded `seed + 1000 * rank`), as in the JAX
    package; `shard_per_host=False` gives every process the whole split. In
    one process the argument changes nothing."""
    key = {"train": "train_path", "val": "val_path"}.get(split, "test_path")
    ds = HazyImageDataset(
        root_dir=config["dataset"][key], split=split,
        img_size=config["dataset"]["img_size"])
    if len(ds.samples) == 0:
        raise ValueError(
            f"No samples for split '{split}' under "
            f"{os.path.join(config['dataset'][key], split)} — expected "
            "{root}/{split}/{low,medium,high}/{hazy,clear,dehazed}/*.png|jpg "
            "with matching names in all three subdirs")
    loader = DataLoader(
        ds, batch_size=config["dataset"]["batch_size"], shuffle=(split == "train"),
        num_workers=config["dataset"]["num_workers"],
        seed=config["seed"] if seed is None else seed)
    return shard_loader_for_host(loader) if shard_per_host else loader
