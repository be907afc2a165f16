"""The serving dtype's quality cost: one experiment's joint checkpoint
evaluated at bfloat16 and at float32 on the test split.

    python -m adam_dehaze_tpu_torch.tools.eval_dtype_delta --experiment_dir E \\
        [--config CFG] [--cpu] [--artifact results.json]

The counterpart of tools/eval_dtype_delta.py, with its flags: the router of
the experiment's config (its joint best, `evaluation/evaluate.py:_load_joint`)
dehazes each test batch through its soft forward under autocast in each
dtype, and `ImageQualityMetrics` (seeded LPIPS) averages PSNR, SSIM and
LPIPS over the valid rows. `dtype_delta` ({"bf16": row, "f32": row,
"psnr_cost_db", "ssim_cost"}) is printed and patched into the experiment's
`comprehensive_results.json` and `--artifact` where they exist. Runs on the
card unless `--cpu`.
"""
from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

DTYPES = ("bfloat16", "float32")


def dtype_rows(base, device) -> dict:
    """dtype -> the test split's averages {psnr, ssim, lpips_*, samples}."""
    from adam_dehaze_tpu_torch.data.dataset import get_dataloader
    from adam_dehaze_tpu_torch.evaluation.evaluate import _dehaze_fn, _load_joint
    from adam_dehaze_tpu_torch.evaluation.metrics import ImageQualityMetrics

    rows = {}
    for name in DTYPES:
        config = copy.deepcopy(base)
        config["cuda"]["compute_dtype"] = name
        dehaze = _dehaze_fn(_load_joint(config, device), getattr(torch, name))
        iq = ImageQualityMetrics(device=device)
        for batch in get_dataloader(config, "test", shard_per_host=False):
            dehazed, _ = dehaze(torch.from_numpy(batch["hazy"]).to(device))
            m = np.asarray(batch["mask"], bool)
            iq.add_batch(dehazed.cpu().numpy()[m], batch["clear"][m], "overall")
        rows[name] = iq.compute_averages().get("overall", {})
        print(f"  {name}: PSNR {rows[name].get('psnr', float('nan')):.4f} SSIM "
              f"{rows[name].get('ssim', float('nan')):.5f}")
    return rows


def dtype_delta(rows) -> dict:
    bf16, f32 = rows["bfloat16"], rows["float32"]
    return {"bf16": bf16, "f32": f32,
            "psnr_cost_db": f32.get("psnr", 0.0) - bf16.get("psnr", 0.0),
            "ssim_cost": f32.get("ssim", 0.0) - bf16.get("ssim", 0.0)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--artifact", default=None)
    args = p.parse_args(argv)
    from adam_dehaze_tpu_torch.config import load_config, update_checkpoint_paths

    base = load_config(args.config or os.path.join(args.experiment_dir, "config.yaml"))
    base = update_checkpoint_paths(base, args.experiment_dir)
    device = torch.device("cpu" if args.cpu else "cuda")
    delta = dtype_delta(dtype_rows(base, device))
    print(json.dumps({"dtype_delta": {k: v for k, v in delta.items()
                                      if not isinstance(v, dict)}}))
    for path in (os.path.join(base["evaluation"]["results_dir"], "comprehensive_results.json"),
                 args.artifact):
        if path and os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            doc["dtype_delta"] = delta
            with open(path, "w") as f:
                json.dump(doc, f, indent=2)
            print(f"Patched {path}")
    return delta


if __name__ == "__main__":
    main()
