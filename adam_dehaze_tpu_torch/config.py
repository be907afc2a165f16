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
import time
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


def apply_cli_overrides(config: Dict[str, Any], args) -> Dict[str, Any]:
    """Apply the command line's overrides (--data_dir, --device, --seed,
    --batch_size) to `config`, in place; returns it."""
    if getattr(args, "data_dir", None):
        for split in ("train_path", "val_path", "test_path"):
            config["dataset"][split] = args.data_dir
    if getattr(args, "device", None):
        config["device"] = args.device
    if getattr(args, "seed", None) is not None:
        config["seed"] = args.seed
    if getattr(args, "batch_size", None):
        config["dataset"]["batch_size"] = args.batch_size
    return config


def create_experiment_dir(config: Dict[str, Any], exp_name: Optional[str] = None,
                          root: str = "experiments"):
    """Create `{root}/{exp_name}` (by default a timestamped name) with
    checkpoints/, logs/ and results/, point every checkpoint and result
    path of a copy of `config` into it, and snapshot that copy as
    config.yaml (the keys that start with "_" left out). Returns
    (exp_dir, updated config)."""
    import yaml
    if exp_name is None:
        exp_name = f"experiment_{time.strftime('%Y%m%d_%H%M%S')}"
    exp_dir = os.path.join(root, exp_name)
    for d in (exp_dir, *(os.path.join(exp_dir, s) for s in ("checkpoints", "logs", "results"))):
        os.makedirs(d, exist_ok=True)
    config = update_checkpoint_paths(config, exp_dir)
    with open(os.path.join(exp_dir, "config.yaml"), "w") as f:
        yaml.dump({k: v for k, v in config.items() if not k.startswith("_")}, f)
    return exp_dir, config


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
