"""Does fitting the LPIPS heads buy anything? The leave-one-family-out check.

    python -m adam_dehaze_tpu_torch.tools.justify_lpips_calibration \\
        [--corpus data/synthetic_corpus_v2] [--patches 120] [--size 64] \\
        [--steps 300] [--seed 0] [--out lpips_justify.json] [--device cpu]

The counterpart of tools/justify_lpips_calibration.py, with its flags and
its JSON keys, on the port's seeded trunk and calibrate_lpips.py's pairs:

1. for each of the six distortion families, fit the heads on the pairs
   that do not involve it and test on the pairs that do (a metric is
   useful only on distortions it was not fit on);
2. the normalised margin (d_worse - d_better) / (d_worse + d_better) on
   those held-out pairs, fitted heads against uniform ones;
3. the decision, written into the JSON: fitted heads win only if they
   raise both the mean held-out accuracy and the mean held-out margin;
   otherwise the uniform heads on the seeded trunk stay the calibration
   default (calibrate_lpips.py --uniform).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from adam_dehaze_tpu_torch.tools import calibrate_lpips as cal


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--corpus", default="data/synthetic_corpus_v2")
    p.add_argument("--patches", type=int, default=120)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="lpips_justify.json")
    p.add_argument("--device", default="cuda", choices=["cuda", "default", "cpu"],
                   help="cuda (or default: the card) or cpu")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    _, dms, pairs, pair_fams, P = cal.prepare(args.corpus, args.patches, args.size, rng,
                                              cal._device(args.device))
    print(f"{P} patches x {len(cal.FAMILIES)} families x {cal.LEVELS} levels; "
          f"{len(pairs)} pairs")
    init_ws = cal.uniform_heads(dms)
    per_family = {}
    for f_hold, fname in enumerate(cal.FAMILIES):
        involves = (pair_fams == f_hold).any(axis=1)
        train_p, test_p = pairs[~involves], pairs[involves]
        ws = cal.fit_heads(dms, train_p, args.steps, np.random.default_rng(100 + f_hold))
        m_fit, m_uni = cal.margins(ws, dms, test_p), cal.margins(init_ws, dms, test_p)
        per_family[fname] = {
            "n_test_pairs": int(len(test_p)),
            "acc_fitted": round(float((m_fit > 0).mean()), 4),
            "acc_uniform": round(float((m_uni > 0).mean()), 4),
            "margin_fitted": round(float(m_fit.mean()), 4),
            "margin_uniform": round(float(m_uni.mean()), 4),
        }
        r = per_family[fname]
        print(f"hold out {fname:9s}: acc fitted {r['acc_fitted']:.4f} vs uniform "
              f"{r['acc_uniform']:.4f} | margin {r['margin_fitted']:.4f} vs "
              f"{r['margin_uniform']:.4f}")

    def mean(key):
        return float(np.mean([v[key] for v in per_family.values()]))

    fitted_wins = bool(mean("acc_fitted") > mean("acc_uniform")
                       and mean("margin_fitted") > mean("margin_uniform"))
    out = {
        "protocol": "leave-one-family-out, 6 distortion families, "
                    "fixed seeded trunk (torch.Generator seed 0)",
        "patches": P, "pairs": int(len(pairs)), "steps": args.steps,
        "per_family": per_family,
        "mean_heldout_acc_fitted": round(mean("acc_fitted"), 4),
        "mean_heldout_acc_uniform": round(mean("acc_uniform"), 4),
        "mean_heldout_margin_fitted": round(mean("margin_fitted"), 4),
        "mean_heldout_margin_uniform": round(mean("margin_uniform"), 4),
        "fitted_wins": fitted_wins,
        "decision": ("fitted heads stay the calibration default" if fitted_wins else
                     "uniform heads on the seeded trunk become the calibration default "
                     "(fitting does not generalise across distortion families)"),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("mean_heldout_acc_fitted", "mean_heldout_acc_uniform",
                                          "mean_heldout_margin_fitted",
                                          "mean_heldout_margin_uniform", "fitted_wins")}))
    print(f"wrote {args.out}\ndecision: {out['decision']}")
    return out


if __name__ == "__main__":
    main()
