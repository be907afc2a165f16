"""The port stands alone: importing every module of adam_dehaze_tpu_torch
(parallel/ among them) loads neither JAX nor flax nor the JAX package,
and not triton either (the Triton kernel imports it only when it
launches). `chip_smoke.py` refuses to run without a CUDA card and prints
no result."""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import adam_dehaze_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "triton",
                                    "adam_dehaze_tpu"))
print(len(names), sorted(n for n in names if ".parallel." in n), bad)
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_flax_or_triton():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, env=_clean_env(),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, rest = proc.stdout.strip().split(" ", 1)
    parallel, bad = rest.split("] ", 1)
    assert int(count) >= 24, proc.stdout
    assert parallel + "]" == str([f"adam_dehaze_tpu_torch.parallel.{m}" for m in (
        "collectives", "data_parallel", "dryrun", "expert_parallel", "mesh", "multihost",
        "pipeline", "sharded_ops", "sharding", "spatial")]), proc.stdout
    assert bad == "[]", bad


_TOOLS = """
import importlib, sys
for name in ("convert_reference_checkpoint", "graft_classifier"):
    importlib.import_module("adam_dehaze_tpu_torch.tools." + name)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "adam_dehaze_tpu")))
"""


def test_reference_checkpoint_tools_import_no_jax():
    """The tools that read the upstream reference's checkpoints stand
    alone: neither the JAX package's tools nor JAX come with them."""
    proc = subprocess.run([sys.executable, "-c", _TOOLS], cwd=REPO, capture_output=True,
                          text=True, env=_clean_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_root_tools_and_configs_import_no_jax():
    """The port's counterparts of the JAX package's root tools stand alone,
    and its full-system config loads without the JAX package's."""
    probe = _TOOLS.replace('("convert_reference_checkpoint", "graft_classifier")',
                           '("calibrate_lpips", "justify_lpips_calibration", '
                           '"eval_dtype_delta", "run_ablations")')
    probe = probe.replace("print(sorted(", "from adam_dehaze_tpu_torch.config import load_config\n"
                          "load_config('adam_dehaze_tpu_torch/configs/full_system_cuda.yaml')\n"
                          "print(sorted(", 1)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                          text=True, env=_clean_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_day_one_tools_import_no_jax():
    """The port's counterparts of the JAX package's validation, rerun,
    collection and throughput tools stand alone."""
    probe = _TOOLS.replace('("convert_reference_checkpoint", "graft_classifier")',
                           '("validate_real_weights", "rerun_hard_routing_eval", '
                           '"rerun_detection_eval", "collect_round_results", '
                           '"measure_train_throughput")')
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                          text=True, env=_clean_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


_BENCH = """
import sys
import adam_dehaze_tpu_torch.bench
import adam_dehaze_tpu_torch.cli
print(sorted(m for m in sys.modules
             if m == "bench" or m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax",
                                                    "adam_dehaze_tpu")))
"""


def test_bench_and_cli_import_no_jax():
    """The port's benchmark and the command line that runs it (`--mode
    bench`) stand alone: neither the root bench.py nor JAX comes with them."""
    proc = subprocess.run([sys.executable, "-c", _BENCH], cwd=REPO, capture_output=True,
                          text=True, env=_clean_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_chip_smoke_fails_without_cuda():
    """On a machine without CUDA the smoke run exits non-zero before it
    builds or prints anything that looks like a result."""
    env = _clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass


def test_chip_mutation_check_fails_without_cuda():
    """The mutation check of the chain kernels' bf16 bounds builds and runs
    kernels: without a card it exits non-zero and reports nothing."""
    env = _clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_mutation_check.py"], cwd=REPO,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert "caught" not in proc.stdout


def test_probe_tool_fails_without_cuda():
    """The operation probes launch kernels: without a card the tool exits
    non-zero and reports no pattern."""
    env = _clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "adam_dehaze_tpu_torch.tools.probe_ops"],
                          cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert "PASS" not in proc.stdout and "cuda" in proc.stderr.lower()


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo it
    cannot import the port, and exits non-zero."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=_clean_env(),
                          timeout=300)
    assert proc.returncode != 0
    assert "ModuleNotFoundError" in proc.stderr
    assert '"ok": true' not in proc.stdout


_DEVICE_DEFAULTS = """
import importlib, inspect, pkgutil
import adam_dehaze_tpu_torch as pkg
found = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    mod = importlib.import_module(m.name)
    for name, obj in vars(mod).items():
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        fns = [(name, obj)] if inspect.isfunction(obj) else []
        if inspect.isclass(obj):
            fns = [(f"{name}.{k}", v) for k, v in vars(obj).items()
                   if inspect.isfunction(v) or isinstance(v, (classmethod, staticmethod))]
        for qual, fn in fns:
            fn = getattr(fn, "__func__", fn)
            p = inspect.signature(fn).parameters.get("device")
            if p is not None and str(p.default) == "cpu":
                found.append(f"{mod.__name__}.{qual}")
print(sorted(found))
"""


def test_no_public_entry_point_defaults_to_the_cpu():
    """Entry points run on the card unless the caller asks for the CPU: no
    function or method of the port defaults its `device` to the CPU, but
    the loss nets' `init` helpers, which the trainers call with their
    device (train_dehazing.py, train_joint.py)."""
    proc = subprocess.run([sys.executable, "-c", _DEVICE_DEFAULTS], cwd=REPO,
                          capture_output=True, text=True, env=_clean_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(["adam_dehaze_tpu_torch.losses.dehazing.DehazingLoss.init",
                                       "adam_dehaze_tpu_torch.losses.dehazing.JointLoss.init"])
