"""The port stands alone: importing every module of adam_dehaze_tpu_torch
loads neither JAX nor flax nor the JAX package, and not triton either (the
Triton kernel imports it only when it launches). `chip_smoke.py` refuses
to run without a CUDA card and prints no result."""
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
print(len(names), bad)
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
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 24, proc.stdout
    assert bad == "[]", bad


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
