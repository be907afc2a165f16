"""The port's command line (adam_dehaze_tpu_torch/cli.py, main_torch.py)
against the JAX package's, on the CPU:

- parse_args has the JAX parser's options, defaults and choices;
- apply_cli_overrides and create_experiment_dir give JAX's config and
  directory layout (the timestamp aside, and the port's `cuda` section
  where JAX has `tpu`);
- `preprocess` writes the JAX CLI's files, within one grey level;
- `train_all` at 32^2 with tiny widths writes the JAX CLI's file set (a
  .pth where JAX writes an orbax directory or msgpack) and a
  comprehensive_results.json with the JAX schema;
- every --serve_mode writes PNGs within one grey level of the port's own
  AdaptiveDehazer route on the same batches, and its labels; --detect
  writes detections.json;
- `train_detection` takes the JAX signature: the JAX CLI's keywords,
  positional (cfg, 1, False, 32), and --resume continuing from the
  checkpoint;
- `--mode bench` runs the port's benchmark and prints its JSON line last;
  the default device without a card stops at once (--lowres is held
  against the JAX CLI in test_torch_serve_experiment.py).
"""
import argparse
import json
import os

import numpy as np
import pytest
import torch
import yaml

from adam_dehaze_tpu import cli as JCLI
from adam_dehaze_tpu import config as JCFG
from adam_dehaze_tpu_torch import cli as PCLI
from adam_dehaze_tpu_torch import config as PCFG
from adam_dehaze_tpu_torch.data.dataset import _imread_rgb
from adam_dehaze_tpu_torch.data.preprocessing import _write_rgb
from adam_dehaze_tpu_torch.evaluation.evaluate import _load_joint
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus
from adam_dehaze_tpu_torch.training import train_detection as PT
from torch_port_util import one_torch_thread

# The port's ops run on one thread in this module (see one_torch_thread).
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The key tree of the JAX package's comprehensive_results.json
# (adam_dehaze_tpu/evaluation/evaluate.py:run_comprehensive_evaluation)
# down to the sections' own keys, with train_all's pre-joint row.
JAX_SCHEMA = {
    "baseline": {"low_intensity", "medium_intensity", "high_intensity"},
    "joint": {"low_intensity", "medium_intensity", "high_intensity", "fade_proxy",
              "brisque_proxy", "nima_proxy"},
    "fixed": {"fixed_low", "fixed_medium", "fixed_high"},
    "hard_routing": {"fidelity", "spill", "spill_up", "spill_ordered", "routing_acc",
                     "spilled_frac", "spilled_frac_up", "spilled_frac_ordered"},
    "detection": {"hazy", "dehazed", "by_level", "improvement_percent"},
    "comparison": {"baseline_avg_psnr", "joint_avg_psnr", "psnr_improvement",
                   "best_fixed_psnr", "adaptive_vs_best_fixed_psnr", "pre_joint_avg_psnr",
                   "joint_stage_psnr_gain"},
    "baseline_comparison": {"corpus", "reference_source", "rows"},
    "pre_joint_adaptive": {"low_intensity", "medium_intensity", "high_intensity",
                           "fade_proxy", "brisque_proxy", "nima_proxy"},
}
# What the JAX CLI's train_all writes into the experiment (logs aside), by
# stem: orbax directories and msgpack are .pth files in the port.
JAX_TRAIN_ALL_FILES = {
    "config.yaml", "quality_head",
    "checkpoints/classifier/best_model", "checkpoints/joint/best_model",
    *(f"checkpoints/dehazing/{lvl}/best_model" for lvl in ("low", "medium", "high")),
    *(f"results/metrics/{name}.json" for name in (
        "pre_joint_adaptive", "baseline_results", "joint_results", "comprehensive_results",
        "dummy_annotations")),
    "results/visualizations/joint_comparison.png", "results/visualizations/routing_weights.png",
}
TINY = {
    "dataset": {"img_size": 32, "batch_size": 4, "num_workers": 2},
    "classifier": {"epochs": 1},
    "dehazing": {"epochs": 1, "low": {"channels": 4, "blocks": 1},
                 "medium": {"channels": 4, "blocks": 2}, "high": {"channels": 8, "blocks": 2}},
    "joint_training": {"epochs": 1},
    "detection": {"num_classes": 3, "epochs": 1},
    "evaluation": {"nima_steps": 2},
    "cuda": {"compute_dtype": "float32"},
}


def _parser(parse_args, monkeypatch):
    """The ArgumentParser that `parse_args` builds."""
    seen = []
    original = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.append(self)
        return original(self, args, namespace)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        parse_args([])
    return seen[0]


def test_parse_args_has_the_jax_options_defaults_and_choices(monkeypatch):
    def actions(parse_args):
        return [(tuple(a.option_strings), a.dest, a.default, a.choices, a.type, a.nargs,
                 type(a).__name__) for a in _parser(parse_args, monkeypatch)._actions]
    assert actions(PCLI.parse_args) == actions(JCLI.parse_args)
    assert PCLI.MODES == JCLI.MODES and PCLI.SERVE_MODES == JCLI.SERVE_MODES
    assert vars(PCLI.parse_args(["--mode", "serve", "--serve_mode", "spill_up", "--seed", "3"])) \
        == vars(JCLI.parse_args(["--mode", "serve", "--serve_mode", "spill_up", "--seed", "3"]))


def test_cli_overrides_and_experiment_dir_match_jax(tmp_path):
    args = JCLI.parse_args(["--data_dir", "/d", "--device", "cpu", "--seed", "5",
                            "--batch_size", "3"])
    got = PCFG.apply_cli_overrides(PCFG.load_config(), args)
    want = JCFG.apply_cli_overrides(JCFG.load_config(), args)
    for cfg in (got, want):
        assert cfg["dataset"]["train_path"] == cfg["dataset"]["test_path"] == "/d"
        assert (cfg["device"], cfg["seed"], cfg["dataset"]["batch_size"]) == ("cpu", 5, 3)
    pdir, pcfg = PCFG.create_experiment_dir(got, "x", root=str(tmp_path / "port"))
    jdir, jcfg = JCFG.create_experiment_dir(want, "x", root=str(tmp_path / "jax"))

    def rel(cfg, root):
        return {k: os.path.relpath(v, root) if isinstance(v, str) and v.startswith(root) else v
                for k, v in cfg.items()}

    for section in ("classifier", "dehazing", "routing", "joint_training", "detection",
                    "evaluation"):
        keys = ("checkpoint_dir", "results_dir", "visualization_dir")
        assert ({k: v for k, v in rel(pcfg[section], pdir).items() if k in keys}
                == {k: v for k, v in rel(jcfg[section], jdir).items() if k in keys}), section
    assert os.path.relpath(pcfg["_logs_dir"], pdir) == os.path.relpath(jcfg["_logs_dir"], jdir)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "checkpoints", "config.yaml", "logs", "results"]
    snap = yaml.safe_load(open(os.path.join(pdir, "config.yaml")))
    jsnap = yaml.safe_load(open(os.path.join(jdir, "config.yaml")))
    assert set(snap) - {"cuda"} == set(jsnap) - {"tpu"}
    assert snap["evaluation"]["results_dir"] == pcfg["evaluation"]["results_dir"]
    # A default name is a timestamp, as in the JAX package.
    auto, _ = PCFG.create_experiment_dir(got, root=str(tmp_path / "auto"))
    assert os.path.basename(auto).startswith("experiment_")


def test_preprocess_writes_the_jax_cli_files(tmp_path, monkeypatch):
    import cv2
    monkeypatch.chdir(tmp_path)
    for side in ("jax", "port"):
        for lvl in ("low", "medium", "high"):
            for i in range(4):
                for role in ("hazy", "clear", "dehazed"):
                    path = tmp_path / side / "raw" / lvl / role / f"{lvl}{i}.png"
                    os.makedirs(path.parent, exist_ok=True)
                    img = (np.random.default_rng(100 * i + len(lvl)).random((40, 44, 3)) * 255)
                    cv2.imwrite(str(path), img.astype(np.uint8))
        cfg = {"dataset": {"train_path": str(tmp_path / side / "processed"), "img_size": 24}}
        with open(tmp_path / f"{side}.yaml", "w") as f:
            yaml.dump(cfg, f)
    JCLI.main(["--config", "jax.yaml", "--mode", "preprocess", "--exp_name", "j",
               "--device", "cpu"])
    PCLI.main(["--config", "port.yaml", "--mode", "preprocess", "--exp_name", "p",
               "--device", "cpu"])

    def tree(side):
        base = tmp_path / side / "processed"
        return sorted(os.path.relpath(os.path.join(d, f), base)
                      for d, _, fs in os.walk(base) for f in fs)

    files = tree("jax")
    assert files == tree("port") and len(files) == 2 * 36
    for rel in files:
        a = cv2.imread(str(tmp_path / "jax" / "processed" / rel)).astype(np.int16)
        b = cv2.imread(str(tmp_path / "port" / "processed" / rel)).astype(np.int16)
        assert a.shape == (24, 24, 3) and np.abs(a - b).max() <= 1, rel


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """`train_all` of the port on a 32^2 corpus with boxes, tiny widths,
    1 epoch each, --device cpu; then `train_detection` on it."""
    tmp = tmp_path_factory.mktemp("cli_train_all")
    root = str(tmp / "corpus")
    make_corpus(root, size=32, train=2, val=2, test=2, seed=3)
    cfg = {**TINY, "dataset": {**TINY["dataset"], "train_path": root, "val_path": root,
                               "test_path": root}}
    with open(tmp / "tiny.yaml", "w") as f:
        yaml.dump(cfg, f)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        PCLI.main(["--config", "tiny.yaml", "--mode", "train_all", "--exp_name", "e",
                   "--device", "cpu"])
        exp = str(tmp / "experiments" / "e")
        PCLI.main(["--mode", "train_detection", "--experiment_dir", exp, "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return exp, root


def test_train_all_writes_the_jax_file_set_and_schema(experiment):
    exp, _ = experiment
    files = set()
    for d, _, fs in os.walk(exp):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), exp)
            if not rel.startswith(("logs", "checkpoints/detection")):
                files.add(rel.removesuffix(".pth").removesuffix(".metrics.json"))
    assert files == JAX_TRAIN_ALL_FILES
    with open(os.path.join(exp, "results", "metrics", "comprehensive_results.json")) as f:
        results = json.load(f)
    assert {k: set(v) for k, v in results.items()} == JAX_SCHEMA
    assert results["hard_routing"]["fidelity"]["samples"] == 6


@pytest.mark.parametrize("mode", JCLI.SERVE_MODES)
def test_serve_modes_write_the_routes_outputs(experiment, mode, tmp_path):
    exp, _ = experiment
    out = str(tmp_path / "served")
    argv = ["--mode", "serve", "--experiment_dir", exp, "--serve_mode", mode, "--device", "cpu",
            "--out", out]
    PCLI.main(argv + (["--detect"] if mode == "hard" else []))
    cfg = PCFG.update_checkpoint_paths(PCFG.load_config(os.path.join(exp, "config.yaml")), exp)
    files = PCLI.serve_inputs(cfg)
    assert len(files) == 6
    d = AdaptiveDehazer(_load_joint(cfg, "cpu"), None, cfg, device="cpu")
    bs = cfg["dataset"]["batch_size"]
    outs, labels = [], []
    for i in range(0, len(files), bs):
        x = np.stack([_imread_rgb(f, 32) for f in files[i:i + bs]])
        if mode == "soft":
            y, lab = d(x), None
        elif mode == "device":
            y, lab = d.route_device_binned(x)
        else:
            spill = {"spill": True, "spill_up": "up"}.get(mode, False)
            y, lab = d.route_hard(x, spill=spill)
        outs.append(y)
        labels.append(lab)
    want = np.concatenate(outs)
    with open(os.path.join(out, "routing.json")) as f:
        manifest = json.load(f)
    assert manifest["serve_mode"] == mode and manifest["lowres"] == []
    for j, path in enumerate(files):
        name = os.path.basename(path)
        ref = str(tmp_path / "ref.png")
        _write_rgb(ref, want[j])
        assert np.abs(_imread_rgb(os.path.join(out, name)) - _imread_rgb(ref)).max() \
            <= 1 / 255 + 1e-6, name
    if mode == "soft":
        assert manifest["images"] == {}
    else:
        got = [manifest["images"][os.path.basename(p)]["intensity"] for p in files]
        assert got == np.concatenate(labels).tolist()
    if mode == "hard":
        with open(os.path.join(out, "detections.json")) as f:
            dets = json.load(f)
        assert sorted(dets) == sorted(os.path.basename(p) for p in files)
        assert all(set(v) == {"boxes", "scores", "labels"} for v in dets.values())


def test_train_detection_resumes_through_the_cli(experiment, capsys):
    """The JAX CLI's call (epochs, resume=, img_size= keywords) with
    --resume: the experiment's detector checkpoint (epoch 1) is picked up
    and training goes on to the config's 2 epochs."""
    exp, _ = experiment
    cfg_path = os.path.join(os.path.dirname(exp), "resume.yaml")
    cfg = yaml.safe_load(open(os.path.join(exp, "config.yaml")))
    cfg["detection"]["epochs"] = 2
    with open(cfg_path, "w") as f:
        yaml.dump(cfg, f)
    PCLI.main(["--config", cfg_path, "--mode", "train_detection", "--experiment_dir", exp,
               "--resume", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "Resumed from" in printed and "Epoch 2/2" in printed and "Epoch 1/2" not in printed


def test_train_detection_takes_the_jax_positional_order(experiment, monkeypatch, tmp_path):
    """(cfg, 1, False, 32): epochs 1, resume False, img_size 32."""
    _, root = experiment
    cfg = PCFG.load_config(overrides=TINY)
    cfg["dataset"].update(train_path=root, val_path=root, test_path=root)
    cfg["detection"]["checkpoint_dir"] = str(tmp_path / "det")
    cfg["_logs_dir"] = str(tmp_path / "logs")
    sizes = []
    loader = PT.get_detection_dataloader

    def spy(*args, **kwargs):
        sizes.append(kwargs["img_size"])
        return loader(*args, **kwargs)

    monkeypatch.setattr(PT, "get_detection_dataloader", spy)
    _, state = PT.train_detection(cfg, 1, False, 32, device="cpu")
    assert sizes == [32, 32] and state.step == 3


def test_unported_surfaces_stop_with_their_message(tmp_path, monkeypatch, capsys):
    """Nothing is refused any more: `--mode bench --device cpu` runs the
    port's benchmark (at narrow widths and 32^2 here; the options this
    parser does not know go to it) and nothing else, and its JSON line is
    the last line printed."""
    import adam_dehaze_tpu_torch.config as config_module
    default = config_module.load_config

    def narrow(*args, **kwargs):
        cfg = default(*args, **kwargs)
        for lvl, (ch, blocks) in {"low": (8, 2), "medium": (8, 6), "high": (16, 9)}.items():
            cfg["dehazing"][lvl].update(channels=ch, blocks=blocks)
        return cfg

    monkeypatch.setattr(config_module, "load_config", narrow)
    for name in ("BENCH_EXPERIMENT", "BENCH_AUTOTUNE_CACHE", "BENCH_RESOLUTION_POLICY",
                 "BENCH_BUDGET_S", "BENCH_FULL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)
    got = PCLI.main(["--mode", "bench", "--device", "cpu", "--batch_size", "12", "--size",
                     "32", "--iters", "1", "--warmup", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(got))
    assert line["metric"] == "adaptive_dehaze_ms_per_image_256" and line["value"] > 0
    assert line["device"] == "cpu" and "skewed_all_high_ms_per_image" in line
    assert not os.path.exists(tmp_path / "experiments")
    with pytest.raises(SystemExit):
        PCLI.main(["--mode", "evaluate", "--device", "cpu", "--iters", "1"])


def test_default_device_without_a_card_stops_at_once(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        PCLI.main(["--mode", "evaluate"])
    assert not os.path.exists(tmp_path / "experiments")


def test_main_torch_runs_the_port_cli(tmp_path):
    """The root entry point runs the port's CLI (here a mode that stops at
    once without a card: exit 1 with the CLI's message), and the JAX
    package is not imported."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = ("import runpy, sys; sys.argv = ['main_torch.py', '--mode', 'evaluate'];\n"
             "try:\n    runpy.run_path('main_torch.py', run_name='__main__')\n"
             "finally:\n    print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'adam_dehaze_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", probe], cwd=repo, capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 1
    assert "no CUDA card is visible" in proc.stderr
    assert proc.stdout.strip().endswith("[]")
