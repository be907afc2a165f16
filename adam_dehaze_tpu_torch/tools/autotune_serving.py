"""Run the serving autotune of the port on the serving device.

    python -m adam_dehaze_tpu_torch.tools.autotune_serving
        [--experiment experiments/full_system_r3] [--batch 16] [--size 256]
        [--iters 5] [--device cuda|cpu]

Per branch, times every serving apply that computes the branch's function
at the config's compute dtype (serving_autotune.load_or_tune) and keeps the
winner in the experiment's serving_autotune.json, the file that
`AdaptiveDehazer.from_experiment(..., autotune=True)` reads. Without an
experiment (no config.yaml in the directory) it tunes a router of the
default widths with seeded weights and writes nothing. Prints one JSON line
with the per-branch tables. The port's counterpart of
tools/autotune_serving.py (`--device cpu` in place of `--cpu`). Run it on an
idle host: a winner timed under load is kept.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from adam_dehaze_tpu_torch.config import compute_dtype, load_config, update_checkpoint_paths
from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER
from adam_dehaze_tpu_torch.serving_autotune import load_or_tune


def serving_device(name: str) -> torch.device:
    """The device asked for; stops at once when it is CUDA and no card is
    visible."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {device} asked for, but no CUDA card is visible: "
                         "run on a machine with a card, or pass --device cpu")
    return device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment", default="experiments/full_system_r3")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = serving_device(args.device)

    shape = (args.batch, args.size, args.size, 3)
    out = {"backend": device.type, "shape": list(shape)}
    if os.path.isfile(os.path.join(args.experiment, "config.yaml")):
        from adam_dehaze_tpu_torch.evaluation.evaluate import _load_joint
        config = update_checkpoint_paths(
            load_config(os.path.join(args.experiment, "config.yaml")), args.experiment)
        router = _load_joint(config, device)
        cache = os.path.join(args.experiment, "serving_autotune.json")
        out["experiment"] = args.experiment
    else:
        # No trained experiment: seeded weights at the default widths.
        from adam_dehaze_tpu_torch.models.branches import create_branch_models
        from adam_dehaze_tpu_torch.models.classifier import create_classifier
        from adam_dehaze_tpu_torch.models.routing import create_router
        from adam_dehaze_tpu_torch.nn.blocks import init_params_
        config = load_config()
        router = init_params_(
            create_router(create_branch_models(config), create_classifier(config), config),
            torch.Generator().manual_seed(0)).to(device).eval()
        cache = None
        out["experiment"] = None

    dtype = compute_dtype(config)
    for level in INTENSITY_ORDER:
        _, report = load_or_tune(router.models[level], dtype, shape, cache_path=cache,
                                 iters=args.iters)
        out[level] = report
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
