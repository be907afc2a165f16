"""Re-run only the hard-routing rows of an experiment's evaluation and patch
them into its `comprehensive_results.json` (and an artifact).

    python -m adam_dehaze_tpu_torch.tools.rerun_hard_routing_eval \\
        --experiment_dir experiments/E [--config CFG] [--device cpu | --cpu] \\
        [--artifact results.json]

The counterpart of tools/rerun_hard_routing_eval.py, with its flags: the
experiment's config (or `--config`) pointed at the experiment
(`update_checkpoint_paths`) goes through the port's
`evaluate_hard_routing` (fidelity, capacity spill and up-only spill through
the port's AdaptiveDehazer, on the experiment's tuned dispatch where it has
a `serving_autotune.json`), and the rows replace `["hard_routing"]` of
`{results_dir}/comprehensive_results.json` (created if missing) and of
`--artifact` where that file exists. Runs on the card unless `--device cpu`
(or the JAX tool's `--cpu`).
"""
from __future__ import annotations

import argparse
import json
import os


def patch_json(path: str, key: str, value) -> None:
    """Set `key` of the JSON object at `path` (an empty one where the file
    is missing) to `value`, written back with indent 2."""
    doc = {}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    doc[key] = value
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"Patched {path}")


def experiment_config(experiment_dir: str, config_path=None):
    """The experiment's config (`config_path`, else its config.yaml) with
    its checkpoint and result paths pointed at `experiment_dir`."""
    from adam_dehaze_tpu_torch.config import load_config, update_checkpoint_paths
    config = load_config(config_path or os.path.join(experiment_dir, "config.yaml"))
    return update_checkpoint_paths(config, experiment_dir)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--artifact", default=None,
                   help="round-results artifact to patch as well")
    args = p.parse_args(argv)
    from adam_dehaze_tpu_torch.evaluation.evaluate import evaluate_hard_routing

    config = experiment_config(args.experiment_dir, args.config)
    hard = evaluate_hard_routing(config, device="cpu" if args.cpu else args.device)
    patch_json(os.path.join(config["evaluation"]["results_dir"], "comprehensive_results.json"),
               "hard_routing", hard)
    if args.artifact and os.path.exists(args.artifact):
        patch_json(args.artifact, "hard_routing", hard)
    return hard


if __name__ == "__main__":
    main()
