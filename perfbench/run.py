"""Run one cell of the benchmark on this machine's card and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs from the seed, the program built, every shape
the cell's traffic uses warmed) is timed from the process's start; then the
cell's traffic runs for `--seconds` on the host clock. With `--trace 0` the
result holds the cell's end-to-end metrics; with `--trace 1` its per-layer
metrics, read from a short window under torch.profiler after the timed one.
Then what the timed path produced is compared with the plain reference
(perfbench/reference/), the numbers compared are printed beside their limits
(perfbench/limits/<workload>.json), and the last line of standard output is
the result's JSON object.

Exits non-zero without a result when there is no CUDA card, when the cell
asks for more cards than there are, or when JAX, jaxlib, flax or the JAX
package was loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             spec=None, limits=None, overrides=None) -> dict:
    """One run of a cell: the result object without `device` (and, off
    the card, `rehearsal` in place of `metrics`). `overrides`: a
    {"config": {...}, "traffic": {...}} merged into the cell's files, for
    the CPU tests' tiny sizes; `limits` in place of the cell's limits
    file."""
    import torch
    cs = harness.cell_spec(spec or harness.benchmark(), workload)
    config, traffic = cs["config"], cs["traffic"]
    if overrides:
        config = harness.merged(config, overrides.get("config", {}))
        traffic = harness.merged(traffic, overrides.get("traffic", {}))
    if limits is None:
        limits = harness.load_json(harness.ROOT / "limits" / f"{workload}.json")
    drv = harness.driver(traffic)
    cell = drv.Cell(config, traffic, seed, device)
    before_setup = harness.process_age_s()
    cell.setup()
    setup_s = harness.process_age_s()
    print(f"[perfbench] set-up {setup_s:.2f} s: start and imports {before_setup:.2f}, "
          + ", ".join(f"{k} {v:.2f}" for k, v in cell.setup_phases.items()), file=sys.stderr)
    window = cell.window(seconds)
    e2e = {m["name"]: m for m in cs["end_to_end"]}
    values = dict(window, setup_s=setup_s)
    metrics = {}
    if not trace:
        for name, m in e2e.items():
            metrics[name] = {"value": float(values[name]), "unit": m["unit"]}
    else:
        ctx = harness.Context(cell, window, cell.traced())
        lost = harness.check_trace_entries(ctx)
        if lost:
            raise RuntimeError("the profiler's window lost device entries: " + "; ".join(lost))
        for m in cs["per_layer"]:
            v = harness.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": ctx.trace.device_ops(),
                     "idle_gaps": ctx.trace.idle_gaps(ctx.spans)}
        busy_s, window_s = ctx.trace.busy_s(), ctx.trace.window_s
    result = {"correct": False, "attempted": int(window["attempted"]),
              "failed": int(window["failed"])}
    if device != "cpu":
        result["device"] = harness.device_info(torch)
        if trace:
            result["device"].update(busy_s=busy_s, window_s=window_s)
    cell.release()
    readings = cell.readings()
    checks = harness.judged([{"name": k, "value": readings.get(k), "limit": lim}
                             for k, lim in limits.items()])
    result["correct"] = bool(checks) and all(c["ok"] for c in checks) and not window["failed"]
    if device == "cpu":
        result["rehearsal"] = {k: values[k] for k in e2e if k in values}
    else:
        result["metrics"] = metrics
    if trace and device != "cpu":
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_env()
    import torch
    spec = harness.benchmark()
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules were loaded: {bad}", file=sys.stderr)
        return 4
    print(f"[perfbench] {harness.nvidia_smi()}", file=sys.stderr)
    print(harness.checks_text(result["checks"]), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
