"""Assemble the full-system evidence JSON of a finished experiment.

    python -m adam_dehaze_tpu_torch.tools.collect_round_results \\
        --experiment_dir experiments/E [--out PATH] [--device cpu]

The counterpart of tools/collect_round_results.py, with its flags and keys.
It reads the metric JSONs that the port's evaluation and trainers write
(`results/metrics/{baseline,joint,comprehensive}_results.json`, each
checkpoint's `best_model.metrics.json` sidecar: classifier, the three
dehazing branches, joint, detection), and runs the experiment's joint
router (`evaluation/evaluate.py:_load_joint`, its soft forward under
autocast in `cuda.compute_dtype`) over the test split for the routing-weight
distribution (the mean of the router's weights per true intensity class)
and its classifier's test accuracy. A missing metric file is `null`; a
router that gives no routing weights (`routing.type: hard`) leaves the
distribution "unavailable: ..."; a failure of the router's forward raises,
where the JAX tool writes it into the JSON.

`--out` defaults to `{experiment_dir}/full_system.json`, not the JAX tool's
`benchmarks/round_results/full_system.json`: that folder holds the JAX
package's rounds. Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER



def _read(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def metric_files(exp: str) -> dict:
    """Every field of the JSON but the routing ones, from the experiment's
    metric files."""
    metrics_dir = os.path.join(exp, "results", "metrics")
    ckpts = os.path.join(exp, "checkpoints")
    return {
        "experiment": os.path.basename(exp.rstrip("/")),
        "baseline_oracle_routing": _read(os.path.join(metrics_dir, "baseline_results.json")),
        "adaptive_joint": _read(os.path.join(metrics_dir, "joint_results.json")),
        "summary": _read(os.path.join(metrics_dir, "comprehensive_results.json")),
        "classifier": _read(os.path.join(ckpts, "classifier", "best_model.metrics.json")),
        "branches": {lvl: _read(os.path.join(ckpts, "dehazing", lvl, "best_model.metrics.json"))
                     for lvl in INTENSITY_ORDER},
        "joint_checkpoint": _read(os.path.join(ckpts, "joint", "best_model.metrics.json")),
        "detection_checkpoint": _read(os.path.join(ckpts, "detection",
                                                   "best_model.metrics.json")),
    }


def routing_fields(exp: str, device) -> dict:
    """{"routing_weight_distribution", "router_classifier_test_acc"} of the
    experiment's joint router on its test split (the accuracy only where
    the router has a classifier)."""
    from adam_dehaze_tpu_torch.config import compute_dtype, load_config, update_checkpoint_paths
    from adam_dehaze_tpu_torch.data.dataset import get_dataloader
    from adam_dehaze_tpu_torch.evaluation.evaluate import _dehaze_fn, _load_joint

    cfg_path = os.path.join(exp, "config.yaml")
    config = update_checkpoint_paths(
        load_config(cfg_path if os.path.exists(cfg_path) else None), exp)
    dehaze = _dehaze_fn(_load_joint(config, device), compute_dtype(config))
    sums, counts = np.zeros((3, 3)), np.zeros(3)
    correct = total = 0
    for batch in get_dataloader(config, "test"):
        _, info = dehaze(torch.from_numpy(batch["hazy"]).to(device))
        w = info.get("weights", info.get("gate_weights"))
        if w is None:
            return {"routing_weight_distribution":
                    "unavailable: the router gives no routing weights "
                    f"(routing.type {config['routing']['type']})"}
        w = w.float().cpu().numpy()
        lab = np.asarray(batch["intensity"])
        mask = np.asarray(batch["mask"], bool)
        for c in range(3):
            sel = (lab == c) & mask
            sums[c] += w[sel].sum(axis=0)
            counts[c] += sel.sum()
        if info.get("logits") is not None:
            pred = info["logits"].argmax(dim=1).cpu().numpy()
            correct += int(((pred == lab) & mask).sum())
            total += int(mask.sum())
    dist = {f"true_{name}": [round(float(v), 4) for v in sums[c] / max(counts[c], 1)]
            for c, name in enumerate(INTENSITY_ORDER)}
    out = {"routing_weight_distribution": {"order": ["w_low", "w_medium", "w_high"], **dist}}
    if total:
        out["router_classifier_test_acc"] = round(correct / total, 4)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment_dir", required=True)
    p.add_argument("--out", default=None,
                   help="the JSON to write (default {experiment_dir}/full_system.json)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    out_path = args.out or os.path.join(args.experiment_dir, "full_system.json")
    out = metric_files(args.experiment_dir)
    out.update(routing_fields(args.experiment_dir, torch.device(args.device)))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"Wrote {out_path}")
    return out


if __name__ == "__main__":
    main()
