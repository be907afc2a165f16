"""Training observability: a JSONL metrics stream, and TensorBoard scalars
and images when `torch.utils.tensorboard` imports.

Counterpart of adam_dehaze_tpu/training/logging.py; the JSONL file is
written always, so metrics survive where TensorBoard is not installed.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, enable_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(log_dir)
            except Exception:
                self.tb = None

    def scalars(self, step: int, values: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            name = f"{prefix}{k}" if prefix else k
            rec[name] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(name, float(v), step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def images(self, step: int, tag: str, images: np.ndarray):
        """images: (N, H, W, C) in [0, 1]."""
        if self.tb is not None:
            for i, img in enumerate(np.asarray(images)):
                self.tb.add_image(f"{tag}/{i}", np.transpose(img, (2, 0, 1)), step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
