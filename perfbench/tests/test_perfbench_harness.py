"""CPU tests of the benchmark's harness at tiny widths.

    python -m pytest perfbench/tests -q

Each cell runs end to end through the CPU rehearsal path (no device metric
is written; a measurement run without a card exits non-zero) and holds the
cell's own limits; the faults of perfbench/faults.py and the control (the
reference rounded to fp8 in the program's place) fail those limits. The one
test that needs the card carries the `cuda` marker and skips without one.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

PERFBENCH = Path(__file__).resolve().parents[1]
CHECKOUT = PERFBENCH.parent
sys.path.insert(0, str(CHECKOUT))

from perfbench import faults, harness, run  # noqa: E402

SPEC = harness.benchmark()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
TINY_CONFIG = {"port": {"dataset": {"img_size": 32}, "dehazing": {
    "low": {"channels": 8}, "medium": {"channels": 8}, "high": {"channels": 16}}}}
# Serving keeps the configuration's bf16 (its limits are set against it); a
# bf16 train step at these sizes rounds far more than at the real ones (its
# BN normalises a few dozen values), so the train cell runs in float32.
TINY_PRECISION = {
    "serve_closed_loop": {},
    "train_step": {"precision": "fp32", "port": {"cuda": {"compute_dtype": "float32"}}},
}
TINY_TRAFFIC = {
    "serve_closed_loop": {"batch": 6, "pool_batches": 3, "trace_calls": 2, "check_calls": 2,
                          "warmup_passes": 1},
    "train_step": {"batch": 4, "pool_batches": 4, "trace_steps": 1, "warmup_steps": 1},
}


def tiny(workload: str) -> dict:
    driver = harness.cell_spec(SPEC, workload)["traffic"]["driver"]
    return {"config": harness.merged(TINY_CONFIG, TINY_PRECISION[driver]),
            "traffic": TINY_TRAFFIC[driver]}


def tiny_cell(workload: str, seed: int = 3):
    cs = harness.cell_spec(SPEC, workload)
    over = tiny(workload)
    config = harness.merged(cs["config"], over["config"])
    traffic = harness.merged(cs["traffic"], over["traffic"])
    return harness.driver(traffic).Cell(config, traffic, seed, "cpu")


def limits(workload: str) -> dict:
    return harness.load_json(PERFBENCH / "limits" / f"{workload}.json")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_rehearsal_end_to_end(workload):
    result = run.run_cell(workload, 2 ** 31 + 12345, 0.5, False, device="cpu",
                          overrides=tiny(workload))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "metrics" not in result and "device" not in result
    assert set(result["rehearsal"]) <= {m["name"] for m in SPEC["end_to_end"]}
    assert list(result)[-1] == "checks"


def test_measurement_run_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run([sys.executable, str(PERFBENCH / "run.py"), "--workload", WORKLOADS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=CHECKOUT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


FAULTS = [(w, f) for w in WORKLOADS
          for f in faults.KINDS[harness.cell_spec(SPEC, w)["traffic"]["driver"]]]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_planted_fault_fails_the_comparison(workload, fault):
    cell = tiny_cell(workload)
    with faults.PLANTS[cell.traffic["driver"]](fault):
        result = run.run_cell(workload, 11, 0.3, False, device="cpu", overrides=tiny(workload))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_comparison(workload):
    """The reference rounded to fp8 (e4m3, a scale a tensor) in the
    program's place reads beyond one of the cell's limits."""
    cell = tiny_cell(workload)
    cell.setup()
    cell.window(0.2)
    cell.release()
    readings = cell.readings(control=torch.float8_e4m3fn)
    checks = harness.judged([{"name": k, "value": readings[k], "limit": v}
                             for k, v in limits(workload).items()])
    assert not all(c["ok"] for c in checks), readings


@pytest.mark.parametrize("workload", WORKLOADS)
def test_stall_moves_the_end_to_end_metric(workload):
    cell = tiny_cell(workload)
    cell.setup()
    base = cell.window(0.6)
    call = cell.call

    def stalled(*args, **kwargs):
        time.sleep(0.25)
        return call(*args, **kwargs)

    cell.call = stalled
    slow = cell.window(0.6)
    if "serve_images_per_s" in base:
        assert slow["serve_images_per_s"] < base["serve_images_per_s"]
        assert slow["serve_call_p95_ms"] > base["serve_call_p95_ms"] + 150
    else:
        assert slow["train_step_ms"] > base["train_step_ms"] + 150


class _Ctx:
    def __init__(self, config, images_by_branch):
        self.config, self.images_by_branch = config, images_by_branch
        driver = harness.driver({"driver": "serve_closed_loop"})
        self.flops = driver.flops_per_image(config, config["port"]["dataset"]["img_size"])


def test_kernel_work_matches_the_smoke_arithmetic():
    """At 16 images of 256^2 in bf16: K1 138.9 GFLOP and 25 MB (the images
    in and out in float32, the weights), K2 1107 MB over its 6 blocks
    (chip_smoke.py's counts)."""
    config = harness.load_json(PERFBENCH / "configs" / "adam_dehaze_default.json")
    k1 = harness.kernel_work("K1").work(_Ctx(config, {"low": 16}))
    assert k1["flops"] == pytest.approx(138.9e9, rel=5e-4)
    assert k1["bytes"] == pytest.approx(25.2e6, rel=5e-3)
    k2_mod = harness.kernel_work("K2")
    assert len(k2_mod.block_shapes(config["port"], "high")) == 6
    k2 = k2_mod.work(_Ctx(config, {"high": 16}))
    assert k2["bytes"] == pytest.approx(1107e6, rel=5e-4)
    assert k2_mod.work(_Ctx(config, {"low": 16})) is None


def _python(code: str, *paths) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(str(p) for p in paths))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=paths[0], timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_run_loads_no_jax_and_reference_loads_no_program():
    code = ("import json, sys\n"
            "from perfbench import harness, run\n"
            f"r = run.run_cell({WORKLOADS[0]!r}, 5, 0.3, False, device='cpu', "
            f"overrides={tiny(WORKLOADS[0])!r})\n"
            "print(json.dumps([r['correct'], harness.forbidden_modules()]))\n")
    assert json.loads(_python(code, CHECKOUT)) == [True, []]
    code = ("import json, sys\n"
            "import perfbench.reference.models, perfbench.reference.train, perfbench.inputs\n"
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('adam_dehaze_tpu') or m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax'))))\n")
    assert json.loads(_python(code, CHECKOUT)) == []


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A cell, its configuration, its traffic mix and a per-layer metric
    added as new files and new BENCHMARK.json entries run with no edit to a
    file that is there."""
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    pb = tmp_path / "perfbench"
    config = json.loads((pb / "configs" / "adam_dehaze_default.json").read_text())
    config["name"] = "added_config"
    config["port"]["dehazing"]["high"]["channels"] = 48
    (pb / "configs" / "added_config.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic" / "serve_mixed48.json").read_text())
    traffic["level_probs"] = [0.1, 0.2, 0.7]
    (pb / "traffic" / "added_mix.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "added_metric.serve.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (pb / "limits" / "added.cell.json").write_text(
        (pb / "limits" / "default.serve.mixed48.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="added_config",
                                file="perfbench/configs/added_config.json"))
    spec["workloads"].append({"name": "added.cell", "config": "added_config",
                              "traffic": "added_mix", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "added_metric.serve", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "model",
                              "moves": "serve_images_per_s", "workloads": ["added.cell"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "default.serve.mixed48" in m["workloads"]:
            m["workloads"].append("added.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json\n"
            "from perfbench import harness, run\n"
            "cs = harness.cell_spec(harness.benchmark(), 'added.cell')\n"
            "names = [m['name'] for m in cs['per_layer']]\n"
            "value = harness.metric_reader('added_metric.serve').read(None)\n"
            f"r = run.run_cell('added.cell', 9, 0.3, False, device='cpu', "
            f"overrides={tiny(WORKLOADS[0])!r})\n"
            "print(json.dumps([cs['config']['name'], cs['traffic']['level_probs'], names, value,"
            " r['correct'], str(harness.ROOT)]))\n")
    name, probs, names, value, correct, root = json.loads(_python(code, tmp_path, CHECKOUT))
    assert (name, probs, value, correct) == ("added_config", [0.1, 0.2, 0.7], 42.0, True)
    assert names == ["added_metric.serve"] and root == str(pb)
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "perfbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_new_reference_branch_and_backbone_are_found_by_name(tmp_path):
    """A branch type and a classifier backbone added to the reference as
    files of their own (`reference/branches/<model_type>.py`,
    `reference/backbones/<name>.py`) are built by the router from a
    configuration's names, with no edit to a file that is there."""
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    ref = tmp_path / "perfbench" / "reference"
    before = {p: p.read_bytes() for p in ref.rglob("*.py")}
    (ref / "branches" / "added_branch.py").write_text(
        (ref / "branches" / "lightweight.py").read_text().replace(
            "class LightweightDehazeModel", "class AddedBranch").replace(
            "MODEL = LightweightDehazeModel", "MODEL = AddedBranch"))
    (ref / "backbones" / "added_backbone.py").write_text(
        (ref / "backbones" / "resnet18.py").read_text().replace(
            "class ResNet18", "class AddedBackbone").replace(
            "BACKBONE = ResNet18", "BACKBONE = AddedBackbone"))
    config = harness.load_json(PERFBENCH / "configs" / "adam_dehaze_default.json")["port"]
    config["dehazing"]["low"]["model_type"] = "added_branch"
    config["classifier"]["model"] = "added_backbone"
    code = ("import json, torch\n"
            "from perfbench.reference.models import Router\n"
            "with torch.device('meta'):\n"
            f"    r = Router({config!r})\n"
            "print(json.dumps([type(r.models['low']).__name__, "
            "type(r.classifier.backbone).__name__, r.models['low'].__module__]))\n")
    low, backbone, module = json.loads(_python(code, tmp_path, CHECKOUT))
    assert (low, backbone) == ("AddedBranch", "AddedBackbone")
    assert module == "perfbench.reference.branches.added_branch"
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, str(PERFBENCH / "run.py"), "--workload", WORKLOADS[0],
                           "--seed", "4242", "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, cwd=CHECKOUT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
