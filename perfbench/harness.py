"""The benchmark's general part: it finds a cell's configuration, traffic,
driver, per-layer metric readers and kernel work counts by name, runs the
cell and reduces the profiler's trace.

A cell of BENCHMARK.json names a configuration (`perfbench/configs/
<config>.json`) and a traffic mix (`perfbench/traffic/<traffic>.json`); the
mix names its driver (`perfbench/drivers/<driver>.py`), which builds the
program under test from the configuration, drives its timed path and checks
what that path produced against the plain reference (`perfbench/
reference/`). Each per-layer metric is `perfbench/metrics/<name>.py`, whose
`read(ctx)` returns a number or None; each kernel's work count is
`perfbench/kernels/<kernel>.py`. Nothing here is specific to a cell.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent          # perfbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "adam_dehaze_tpu")
# Published peaks of one NVIDIA H100 SXM at its full power limit of 700 W
# (dense rates, no sparsity).
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES_S = 3.35e12
# The configuration files' `precision`, by torch dtype name.
DTYPES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}
# Device activity in a chrome trace of torch.profiler.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (the interpreter's
    own start-up included)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def cache_env(checkout: Path = CHECKOUT) -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout (the kernel library already builds into build/kernels/)."""
    base = checkout / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def merged(base: dict, over: dict) -> dict:
    """A copy of `base` with `over` merged in, dict by dict."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def port_config(config: dict) -> dict:
    """The program's config: its defaults under the configuration file's
    `port` sections."""
    from adam_dehaze_tpu_torch.config import load_config
    return load_config(overrides=config["port"])


@contextlib.contextmanager
def fp32_exact():
    """float32 with TF32 off for convolutions and matrix products."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def compute_dtype(config: dict):
    """The torch dtype of the configuration's `precision`."""
    import torch
    return getattr(torch, DTYPES[config["precision"]])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import a file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name or f"perfbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(checkout: Path = CHECKOUT) -> dict:
    return load_json(checkout / "BENCHMARK.json")


def cell_spec(spec: dict, workload: str) -> dict:
    """The cell's entry, its configuration, traffic and the names of the
    metrics it reports: {workload, config, traffic, end_to_end, per_layer}."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return dict(workload=cell, config=load_json(CHECKOUT / config["file"]),
                traffic=load_json(ROOT / "traffic" / f"{cell['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def driver(traffic: dict) -> ModuleType:
    return load_module(ROOT / "drivers" / f"{traffic['driver']}.py")


def metric_reader(name: str) -> ModuleType:
    return load_module(ROOT / "metrics" / f"{name}.py", "perfbench_metric_" +
                       name.replace(".", "_"))


def kernel_work(name: str) -> ModuleType:
    return load_module(ROOT / "kernels" / f"{name}.py", f"perfbench_kernel_{name}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (whole names: adam_dehaze_tpu_torch is not one)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


# --- timing -----------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's default)."""
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Marks:
    """Seconds between successive calls, by the name each call gives."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now


# --- the profiler's trace ---------------------------------------------------

class Trace:
    """The device activity and the benchmark's own host spans of one
    profiler window, from its chrome trace. Times in microseconds."""

    def __init__(self, events: List[dict], window: str):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.spans = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
        win = [e for e in self.spans if e["name"] == window]
        if not win:
            raise RuntimeError(f"the trace holds no {window!r} span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])

    @classmethod
    def from_profiler(cls, prof, window: str) -> "Trace":
        tmp = tempfile.mkdtemp(prefix="perfbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, window)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy_intervals(self):
        iv = sorted((max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1))
                    for e in self.device)
        merged = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    def kernels(self) -> List[dict]:
        return [e for e in self.device if e.get("cat") == "kernel"]

    def memcpy_s(self) -> float:
        return sum(float(e["dur"]) for e in self.device if e.get("cat") == "gpu_memcpy") * 1e-6

    def matching(self, names) -> List[dict]:
        """Kernel entries whose name contains one of `names`."""
        return [e for e in self.kernels() if any(n in e["name"] for n in names)]

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e["name"][:200]] = by.get(e["name"][:200], 0.0) + float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, labels, top: int = 10) -> List[list]:
        """The longest stretches with nothing on the device, each named by
        the innermost of the benchmark's host spans (`labels`) around its
        middle ("between calls" where none is)."""
        busy = self._busy_intervals()
        gaps, t = [], self.t0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.t1:
            gaps.append((t, self.t1))
        spans = [e for e in self.spans if e["name"] in labels]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (a + b) / 2
            around = [e for e in spans if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
            name = (min(around, key=lambda e: float(e["dur"]))["name"] if around
                    else "between calls")
            out.append([name, (b - a) * 1e-6])
        return out


@contextlib.contextmanager
def profiled():
    """torch.profiler over CPU and CUDA activity; yields the profiler."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


class Context:
    """What a per-layer metric reader reads: the cell (its configuration,
    traffic and work counts), the timed window's readings, and the traced
    window (`trace`, the program's `launches` by counter, `calls`, and the
    driver's own keys)."""

    def __init__(self, cell, window: dict, traced: dict):
        self.cell, self.window = cell, window
        self.config, self.traffic = cell.config, cell.traffic
        for k, v in traced.items():
            setattr(self, k, v)
        self._flops = None

    @property
    def flops(self) -> dict:
        """The driver's model FLOPs (counted once, on the reference)."""
        if self._flops is None:
            self._flops = self.cell.flops()
        return self._flops

    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.config["precision"]]


def roofline_share(ctx, kernel: str) -> Optional[float]:
    """A kernel's share of its roofline over the traced window, in %: the
    least time the card could take for the work the traced calls asked of
    it (kernels/<kernel>.py) over the device time of its entries. None
    where the window ran none of it."""
    mod = kernel_work(kernel)
    work = mod.work(ctx)
    if not work:
        return None
    entries = ctx.trace.matching(mod.TRACE_NAMES)
    seconds = sum(float(e["dur"]) for e in entries) * 1e-6
    if seconds <= 0:
        return None
    bound = max(work["flops"] / PEAK_FLOPS[work["peak"]], work["bytes"] / PEAK_BYTES_S)
    return 100.0 * bound / seconds


def check_trace_entries(ctx) -> List[str]:
    """Kernels whose entries in the trace disagree with the program's own
    launch counters over the traced window (a profiler window that lost
    device entries): what kernels/<name>.py says each counted launch
    enqueues."""
    bad = []
    for path in sorted((ROOT / "kernels").glob("*.py")):
        mod = kernel_work(path.stem)
        counted = ctx.launches.get(mod.COUNTER, 0)
        seen = len(ctx.trace.matching(mod.TRACE_NAMES))
        if seen != counted * mod.ENTRIES_PER_LAUNCH:
            bad.append(f"{path.stem}: {seen} trace entries, {counted} counted launches")
    return bad


# --- the result line --------------------------------------------------------

def device_info(torch, count: int = 1) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def checks_text(checks: Dict[str, dict]) -> str:
    """The numbers compared beside their limits, one a line."""
    return "\n".join(f"check {name}: {c['value']!r} (limit {c['limit']!r})"
                     for name, c in checks.items())


def judged(checks: List[dict]) -> List[dict]:
    """Each check with `ok`: its value at most its limit (NaN fails)."""
    out = []
    for c in checks:
        v, lim = c["value"], c["limit"]
        out.append(dict(c, ok=bool(v is not None and v == v and v <= lim)))
    return out


def nvidia_smi() -> Optional[str]:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
