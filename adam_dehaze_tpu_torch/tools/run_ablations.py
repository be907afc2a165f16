"""Loss-term ablation on the synthetic fog corpus.

    python -m adam_dehaze_tpu_torch.tools.run_ablations [--epochs 8] \\
        [--data data/synthetic_corpus] [--level medium] [--lpips-weights W.pth] \\
        [--only full,no_perceptual] [--out ablations.json] [--img_size 256] [--device cpu]

The counterpart of tools/run_ablations.py, with its flags, its `ABLATIONS`
table and its JSON keys: one branch (the medium one by default) is trained
by `train_dehazing_model` under each loss configuration for a fixed number
of epochs, and its best validation sidecar (val PSNR and SSIM) is recorded.
configs/ablations/*.yaml hold the same loss overrides as files for the
command line (`main_torch.py --config`). `--img_size` and `--device` are
the port's own: the JAX tool fixes 256^2, which stays the default. Each run
writes under `experiments/ablations/NAME`, batch 16. On the card
the branch trains in bfloat16, on the CPU in float32, as the JAX tool does
on its TPU and off it.
"""
from __future__ import annotations

import argparse
import copy
import json
import os

ABLATIONS = {
    "full": {},
    "no_perceptual": {"lambda_perceptual": 0.0},
    "no_content": {"lambda_content": 0.0},
    "l1_only": {"lambda_content": 0.0, "lambda_perceptual": 0.0},
    "density_weighted": {"density_weighted": True},
}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--data", default="data/synthetic_corpus")
    p.add_argument("--level", default="medium")
    p.add_argument("--lpips-weights", default=None,
                   help="calibrated LPIPS heads (tools/calibrate_lpips.py), so that the "
                        "perceptual ablation measures a fitted perceptual loss; default: "
                        "uniform heads")
    p.add_argument("--only", default=None,
                   help="comma-separated names of ABLATIONS to run (e.g. 'full,no_perceptual')")
    p.add_argument("--out", default="ablations.json")
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from adam_dehaze_tpu_torch.config import load_config
    from adam_dehaze_tpu_torch.training.train_dehazing import train_dehazing_model

    base = load_config()
    base["dataset"].update(train_path=args.data, val_path=args.data, test_path=args.data,
                           img_size=args.img_size, batch_size=16, num_workers=4)
    base["dehazing"]["epochs"] = args.epochs
    base["cuda"]["compute_dtype"] = "bfloat16" if args.device == "cuda" else "float32"
    if args.lpips_weights:
        base["loss"]["lpips_weights"] = args.lpips_weights

    selected = ABLATIONS
    if args.only:
        selected = {n: ABLATIONS[n] for n in (s.strip() for s in args.only.split(",")) if n}
    results = {}
    for name, overrides in selected.items():
        cfg = copy.deepcopy(base)
        cfg["loss"].update(overrides)
        cfg["dehazing"]["checkpoint_dir"] = f"experiments/ablations/{name}"
        cfg["_logs_dir"] = f"experiments/ablations/{name}/logs"
        print(f"=== ablation {name}: {overrides or 'reference loss'} ===", flush=True)
        train_dehazing_model(args.level, cfg, device=args.device)
        sidecar = os.path.join(cfg["dehazing"]["checkpoint_dir"], args.level,
                               "best_model.metrics.json")
        with open(sidecar) as f:
            best = json.load(f)
        results[name] = {"overrides": overrides, **best}
        print(f"--- {name}: {best}", flush=True)

    doc = {"level": args.level, "epochs": args.epochs, "lpips_weights": args.lpips_weights,
           "results": results}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"Wrote {args.out}")
    return doc


if __name__ == "__main__":
    main()
