#!/usr/bin/env python3
"""Export an experiment of the JAX package into one the PyTorch port serves.

    python3 export_jax_experiment.py --experiment experiments/jax_exp \\
        --out experiments/port_exp

Reads the JAX experiment's config.yaml and its best joint checkpoint (an
orbax directory, `checkpoints/joint/best_model`) through the JAX package's
own `evaluation/evaluate.py:_load_joint`, fills the port's router from that
{"params", "batch_stats"} tree (`training/checkpoint.py:load_flax_variables`)
and writes, under --out:

- config.yaml: the JAX config with its `tpu` section replaced by the
  port's `cuda` section (`tpu.compute_dtype` becomes `cuda.compute_dtype`,
  `tpu.serving_quant` becomes `cuda.serving_quant`, so that an experiment
  served in int8 is served in int8 by the port too), every other
  key kept, the checkpoint and result paths pointed into --out;
- checkpoints/joint/best_model.pth (+ best_model.metrics.json when the JAX
  checkpoint has metrics): {"step", "model": the router's state_dict},
  written by the port's `save_checkpoint`.

The result is an experiment directory for
`adam_dehaze_tpu_torch.serving.AdaptiveDehazer.from_experiment`, for
`main_torch.py --experiment_dir` and for the port's autotune tools. The
serving autotune cache and the resolution policy are not carried over:
they are timings of the JAX package's device, to be taken again on the
port's. This script imports JAX and orbax (it runs on the CPU wherever the
JAX package is installed); the port itself never does.
"""
from __future__ import annotations

import argparse
import json
import os


def port_config(jax_config: dict, out_dir: str) -> dict:
    """The port's config of a JAX config: `tpu.compute_dtype` and
    `tpu.serving_quant` as `cuda.compute_dtype` and `cuda.serving_quant`
    over the port's defaults, every other key kept, paths pointed into
    `out_dir`."""
    from adam_dehaze_tpu_torch.config import load_config, update_checkpoint_paths
    keep = {k: v for k, v in jax_config.items() if k != "tpu" and not k.startswith("_")}
    tpu = jax_config.get("tpu", {})
    cuda = {"compute_dtype": tpu.get("compute_dtype", "bfloat16")}
    if tpu.get("serving_quant"):
        cuda["serving_quant"] = tpu["serving_quant"]
    config = load_config(overrides={**keep, "cuda": cuda})
    return update_checkpoint_paths(config, out_dir)


def export(experiment_dir: str, out_dir: str) -> str:
    """Write the port's experiment of a JAX experiment (see the module's
    docstring); returns the path of the joint checkpoint written."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import yaml

    from adam_dehaze_tpu import config as jax_cfg
    from adam_dehaze_tpu.evaluation.evaluate import _load_joint
    from adam_dehaze_tpu.training import checkpoint as jax_ckpt
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from adam_dehaze_tpu_torch.training import checkpoint as ckpt

    cfg_file = os.path.join(experiment_dir, "config.yaml")
    config = jax_cfg.update_checkpoint_paths(
        jax_cfg.load_config(cfg_file if os.path.exists(cfg_file) else None), experiment_dir)
    best = jax_ckpt.best_model_path(config["joint_training"]["checkpoint_dir"])
    if not os.path.isdir(best):
        raise SystemExit(f"export: no joint checkpoint at {best}")
    _, state = _load_joint(config)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})

    pcfg = port_config(config, out_dir)
    router = create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg)
    ckpt.load_flax_variables(router, variables)
    metrics = None
    if os.path.exists(best + ".metrics.json"):
        with open(best + ".metrics.json") as f:
            metrics = json.load(f)
    path = ckpt.save_checkpoint(pcfg["joint_training"]["checkpoint_dir"], "best_model",
                                {"step": int(state.step), "model": router.state_dict()},
                                metrics)
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        yaml.dump({k: v for k, v in pcfg.items() if not k.startswith("_")}, f)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment", required=True, help="the JAX experiment directory")
    p.add_argument("--out", required=True, help="the port's experiment directory to write")
    args = p.parse_args(argv)
    path = export(args.experiment, args.out)
    print(f"Exported {args.experiment} -> {path}")


if __name__ == "__main__":
    main()
