"""The readings that the limits of a cell's comparison are set from, on the
card at the cell's own size (perfbench/limits/<workload>.json; PERF.md
gives the readings and the limits).

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6 --faults half,altered] [--detail] \\
        [--seconds 3] [--out file.jsonl]

For each seed a short window of the cell's own traffic, then the numbers
compared, one JSON line each: `kind` "program" (the lower readings); for
each control seed the control, the upper readings: the float32 reference
rounded to fp8 (e4m3, a scale a tensor) in the program's place ("fp8");
and the program with each fault of faults.py planted ("fault:<kind>").
`--detail` adds the drivers' diagnostic readings. All in one process: the
kernel library builds once.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def one(cs, seed, seconds, control=None, fault=None, detail=False) -> dict:
    """One seed's readings: the program (with `fault` planted), or the
    reference rounded to `control` in its place."""
    import torch
    from perfbench import faults
    name = cs["traffic"]["driver"]
    drv = harness.driver(cs["traffic"])
    plant = faults.PLANTS[name](fault) if fault else contextlib.nullcontext()
    with plant:
        cell = drv.Cell(cs["config"], cs["traffic"], seed, "cuda")
        cell.setup()
        cell.window(seconds)
        cell.release()
    out = cell.readings(control=control, detail=detail)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="", help="faults.py's plants, comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--override", default="{}",
                   help='JSON merged into the cell: {"config": {...}, "traffic": {...}}')
    p.add_argument("--detail", action="store_true",
                   help="the drivers' diagnostic readings (worst images, worst leaves)")
    p.add_argument("--no-tf32", action="store_true",
                   help="TF32 off for the program too (a float32 witness)")
    args = p.parse_args(argv)
    harness.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cs = harness.cell_spec(harness.benchmark(), args.workload)
    over = json.loads(args.override)
    cs["config"] = harness.merged(cs["config"], over.get("config", {}))
    cs["traffic"] = harness.merged(cs["traffic"], over.get("traffic", {}))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    runs = [(s, "program", {}) for s in seeds]
    runs += [(s, "fp8", {"control": torch.float8_e4m3fn}) for s in controls]
    runs += [(s, "fault:" + f, {"fault": f}) for s in controls for f in args.faults.split(",")
             if f]
    rows = []
    for seed, kind, kw in runs:
        row = dict(workload=args.workload, seed=seed, kind=kind,
                   **one(cs, seed, args.seconds, detail=args.detail, **kw))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
