"""Tune the quality-guarded resolution policy of a trained experiment.

    python -m adam_dehaze_tpu_torch.tools.autotune_resolution
        [--experiment experiments/full_system_r3] [--floor-db 0.0]
        [--batch 16] [--split val] [--out FILE] [--device cuda|cpu]
        [--no-autotune]

Measures, per branch, full resolution against the half-resolution
candidates of resolution_autotune.py on the experiment's val split (held
out from the test numbers that evaluation reports), with each image scored
by the branch of its true class, and keeps the choice in
`<experiment>/resolution_policy.json`; `dehazer.route_hard(images,
lowres="auto")` serves it. The dial wraps the serving-autotune winners
(`AdaptiveDehazer.from_experiment(..., autotune=True)`) unless
--no-autotune asks for the default dispatch. `--out` writes a copy of the
policy there too. The port's counterpart of tools/autotune_resolution.py
(`--device cpu` in place of `--cpu`). Run it on an idle host.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from adam_dehaze_tpu_torch.data.dataset import get_dataloader
from adam_dehaze_tpu_torch.resolution_autotune import tune_resolution_policy
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.tools.autotune_serving import serving_device


def probe_set(config, split: str):
    """(hazy, clear, oracle labels) of every image of `split`, as numpy."""
    hazy, clear, levels = [], [], []
    for batch in get_dataloader(config, split):
        m = np.asarray(batch["mask"])
        hazy.append(np.asarray(batch["hazy"])[m])
        clear.append(np.asarray(batch["clear"])[m])
        levels.append(np.asarray(batch["intensity"])[m])
    return np.concatenate(hazy), np.concatenate(clear), np.concatenate(levels)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment", default="experiments/full_system_r3")
    p.add_argument("--floor-db", type=float, default=0.0)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--split", default="val", help="probe split (val; never tune on test)")
    p.add_argument("--out", default=None, help="a copy of the policy (optional)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--no-autotune", action="store_true",
                   help="probe the default dispatch instead of the serving-autotune winners")
    args = p.parse_args(argv)
    device = serving_device(args.device)

    dehazer = AdaptiveDehazer.from_experiment(args.experiment, autotune=not args.no_autotune,
                                              device=device)
    hazy, clear, levels = probe_set(dehazer.config, args.split)
    print(f"probe ({args.split}): {hazy.shape[0]} images")

    cache_path = os.path.join(args.experiment, "resolution_policy.json")
    policy = tune_resolution_policy(dehazer._branch_applies(), hazy, clear, levels,
                                    floor_db=args.floor_db, batch=args.batch,
                                    device=dehazer.device)
    policy["experiment"] = args.experiment
    policy["probe_split"] = args.split
    with open(cache_path, "w") as f:
        json.dump(policy, f, indent=2, sort_keys=True)

    for lvl, entry in policy["levels"].items():
        print(f"{lvl}: {entry['choice']}  (full {entry.get('psnr_full')} dB -> "
              f"{entry.get('psnr_choice', entry.get('psnr_full'))} dB)")
        for name, row in entry.get("table", {}).items():
            print(f"    {name}: {row}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        shutil.copyfile(cache_path, args.out)
        print(f"wrote {cache_path} and {args.out}")
    return policy


if __name__ == "__main__":
    main()
