"""Re-run only the detection stage of an experiment's evaluation and patch
it into its `comprehensive_results.json`: after the detector is
fine-tuned again, the dehazing rows stand as they are.

    python -m adam_dehaze_tpu_torch.tools.rerun_detection_eval \\
        --experiment_dir experiments/E [--config CFG] [--device cpu]

The counterpart of tools/rerun_detection_eval.py, with its flags: the
experiment's config (or `--config`) pointed at the experiment goes through
the port's `evaluate_object_detection` (the experiment's detector on the
test split's hazy images, and on the same images dehazed by its joint
router's soft forward). `["detection"]` of
`{results_dir}/comprehensive_results.json` becomes {hazy, dehazed: the
overall stats, improvement_percent: the dehazed mAP's change over the hazy
one, in percent}, and the whole result is written to
`{results_dir}/detection_results.json`. Runs on the card unless `--device
cpu`.
"""
from __future__ import annotations

import argparse
import json
import os

from adam_dehaze_tpu_torch.tools.rerun_hard_routing_eval import experiment_config, patch_json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from adam_dehaze_tpu_torch.evaluation.evaluate import evaluate_object_detection

    config = experiment_config(args.experiment_dir, args.config)
    results = evaluate_object_detection(config, device=args.device)
    hazy_map = results["hazy"]["overall"].get("mAP", 0.0)
    dehazed_map = results["dehazed"]["overall"].get("mAP", 0.0)
    improvement = (dehazed_map - hazy_map) / hazy_map * 100 if hazy_map > 0 else 0.0
    print(f"Detection mAP hazy={hazy_map:.4f} dehazed={dehazed_map:.4f} ({improvement:+.1f}%)")

    results_dir = config["evaluation"]["results_dir"]
    patch_json(os.path.join(results_dir, "comprehensive_results.json"), "detection",
               {"hazy": results["hazy"]["overall"], "dehazed": results["dehazed"]["overall"],
                "improvement_percent": improvement})
    det_path = os.path.join(results_dir, "detection_results.json")
    with open(det_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"Wrote {det_path}")
    return results


if __name__ == "__main__":
    main()
