"""Configuration system of the PyTorch port.

One YAML dict threaded through every entry point, with the JAX package's
schema (adam_dehaze_tpu/config.py, configs/default.yaml). A `cuda` section
with `compute_dtype` takes the place of `tpu`; nothing selects kernels: the
device of a tensor alone decides between a hand-written kernel and its plain
PyTorch version.
"""
from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

_DEFAULT_PATH = Path(__file__).parent / "configs" / "default.yaml"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def default_config() -> Dict[str, Any]:
    import yaml
    with open(_DEFAULT_PATH) as f:
        return yaml.safe_load(f)


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Load config: defaults <- YAML file <- explicit overrides."""
    import yaml
    cfg = default_config()
    if path:
        with open(path) as f:
            user = yaml.safe_load(f) or {}
        cfg = _deep_merge(cfg, user)
    if overrides:
        cfg = _deep_merge(cfg, overrides)
    return cfg


def update_checkpoint_paths(config: Dict[str, Any],
                            experiment_dir: str) -> Dict[str, Any]:
    """Point checkpoint and result paths at an existing experiment dir."""
    config = copy.deepcopy(config)
    ckpt = os.path.join(experiment_dir, "checkpoints")
    config["classifier"]["checkpoint_dir"] = os.path.join(ckpt, "classifier")
    config["dehazing"]["checkpoint_dir"] = os.path.join(ckpt, "dehazing")
    config["routing"]["checkpoint_dir"] = os.path.join(ckpt, "routing")
    config["joint_training"]["checkpoint_dir"] = os.path.join(ckpt, "joint")
    config["detection"]["checkpoint_dir"] = os.path.join(ckpt, "detection")
    config["evaluation"]["results_dir"] = os.path.join(
        experiment_dir, "results", "metrics")
    config["evaluation"]["visualization_dir"] = os.path.join(
        experiment_dir, "results", "visualizations")
    config["_logs_dir"] = os.path.join(experiment_dir, "logs")
    config["_exp_dir"] = experiment_dir
    return config


def compute_dtype(config: Dict[str, Any]) -> torch.dtype:
    """The `cuda.compute_dtype` setting as a torch dtype."""
    name = config.get("cuda", {}).get("compute_dtype", "float32")
    if name not in _DTYPES:
        raise ValueError(f"unsupported cuda.compute_dtype: {name!r}")
    return _DTYPES[name]
