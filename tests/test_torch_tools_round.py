"""The port's full-system config and its counterparts of the JAX package's
root tools (adam_dehaze_tpu_torch/tools/: calibrate_lpips,
justify_lpips_calibration, eval_dtype_delta, run_ablations,
convert_reference_checkpoint), against the JAX package's on the CPU, small
and seeded:

- configs/full_system_cuda.yaml loads through config.py and holds every key
  and value of adam_dehaze_tpu/configs/full_system_tpu.yaml, its `tpu`
  block as the port's `cuda` block; the four ablation files are the JAX
  package's;
- each port tool takes every flag of its JAX tool (the parsers that their
  `main`s build), and the converter parses the JAX tool's command line,
  `--image_size` included;
- the LPIPS tool: its distortions are the JAX tool's on the same patches;
  on one corpus both tools label the same number of ranking pairs (the
  JAX tool run with `--uniform`); its ranking loss and gradient equal the
  JAX tool's expression (jax.value_and_grad) on the same distances and
  heads within 1e-5; a 3-step run writes a checkpoint that
  `loss.lpips_weights` loads and `ImageQualityMetrics` reports as
  `lpips_cal_synth`; the justify tool writes the JAX tool's JSON keys;
- eval_dtype_delta on a seeded tiny experiment: the JAX tool's keys, its
  float32 row the port's `evaluate_joint_model` on the same checkpoint;
- run_ablations: the JAX tool's `ABLATIONS`, and `--only full` for one
  epoch at 32^2 writes the JAX tool's keys (at 16^2 LPIPS's AlexNet has no
  rows left after its second pool).
"""
import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adam_dehaze_tpu_torch.config import load_config, update_checkpoint_paths
from adam_dehaze_tpu_torch.evaluation.evaluate import evaluate_joint_model
from adam_dehaze_tpu_torch.evaluation.metrics import ImageQualityMetrics
from adam_dehaze_tpu_torch.losses.dehazing import DehazingLoss
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.tools import calibrate_lpips as cal
from adam_dehaze_tpu_torch.tools import convert_reference_checkpoint as conv
from adam_dehaze_tpu_torch.tools import eval_dtype_delta as edd
from adam_dehaze_tpu_torch.tools import justify_lpips_calibration as justify
from adam_dehaze_tpu_torch.tools import run_ablations as abl
from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from torch_port_util import one_torch_thread  # noqa: F401  (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIGS = os.path.join(REPO, "adam_dehaze_tpu_torch", "configs")
JAX_CONFIGS = os.path.join(REPO, "adam_dehaze_tpu", "configs")
TOOLS = ("convert_reference_checkpoint", "calibrate_lpips", "justify_lpips_calibration",
         "eval_dtype_delta", "run_ablations")
PORT_TOOLS = {"convert_reference_checkpoint": conv, "calibrate_lpips": cal,
              "justify_lpips_calibration": justify, "eval_dtype_delta": edd,
              "run_ablations": abl}


def _jax_tool(name):
    """The JAX package's tools/NAME.py as a module (it imports no JAX at
    the top)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, prefix + (key,)).items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools_round") / "corpus")
    make_corpus(root, size=64, train=2, val=2, test=2, seed=5)
    return root


# ---------------------------------------------------------------- configs ---

def test_full_system_config_holds_the_jax_files_keys_and_values():
    """Every key of full_system_tpu.yaml with its value, `device` and the
    `tpu` block aside; `tpu`'s compute_dtype and remat under `cuda`
    (`use_pallas` has no counterpart: a tensor's device alone picks a
    kernel); loaded through config.py over the defaults."""
    jax_raw = _yaml(os.path.join(JAX_CONFIGS, "full_system_tpu.yaml"))
    path = os.path.join(PORT_CONFIGS, "full_system_cuda.yaml")
    raw = _yaml(path)
    assert set(raw) == (set(jax_raw) - {"tpu"}) | {"cuda"}
    want = _leaves({k: v for k, v in jax_raw.items() if k not in ("tpu", "device")})
    got = _leaves({k: v for k, v in raw.items() if k not in ("cuda", "device")})
    assert got == want
    assert (jax_raw["device"], raw["device"]) == ("tpu", "cuda")
    assert {k: raw["cuda"][k] for k in ("compute_dtype", "remat")} == \
        {k: jax_raw["tpu"][k] for k in ("compute_dtype", "remat")}
    assert set(jax_raw["tpu"]) - set(raw["cuda"]) == {"use_pallas"}
    cfg = load_config(path)
    assert set(raw["cuda"]) <= set(cfg["cuda"])
    for key, value in _leaves(raw).items():
        node = cfg
        for k in key:
            node = node[k]
        assert node == value, key


@pytest.mark.parametrize("name", ["density_weighted", "no_content", "no_density",
                                  "no_perceptual"])
def test_ablation_configs_are_the_jax_files(name):
    path = os.path.join(PORT_CONFIGS, "ablations", f"{name}.yaml")
    raw = _yaml(path)
    assert raw == _yaml(os.path.join(JAX_CONFIGS, "ablations", f"{name}.yaml"))
    cfg = load_config(path)
    assert {k: cfg["loss"][k] for k in raw["loss"]} == raw["loss"]


# ------------------------------------------------------------ the parsers ---

class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser that `main` builds, taken at its parse_args (which
    then stops `main`)."""
    seen = []

    def grab(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main()
    return seen[0]


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings if s not in ("-h", "--help")}


@pytest.mark.parametrize("tool", TOOLS)
def test_port_tool_takes_every_flag_of_the_jax_tool(tool, monkeypatch):
    """Each option of the JAX tool is the port tool's, with the same
    destination and kind, and every choice the JAX tool offers."""
    want = _options(_parser_of(_jax_tool(tool).main, monkeypatch))
    got = _options(_parser_of(PORT_TOOLS[tool].main, monkeypatch))
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for flag, a in want.items():
        b = got[flag]
        assert (b.dest, type(b).__name__, b.type, b.required) == \
            (a.dest, type(a).__name__, a.type, a.required), flag
        assert a.choices is None or set(a.choices) <= set(b.choices), flag


def test_converter_parses_the_jax_tools_command_line(tmp_path, monkeypatch):
    """The JAX tool's command line, `--image_size` and all, runs the port's
    converter; `--image_size` sizes nothing."""
    argv = ["--kind", "branch", "--level", "medium", "--pth", str(tmp_path / "ref.pth"),
            "--out", str(tmp_path / "out" / "best_model"), "--image_size", "128"]
    jax_args = _parser_of(_jax_tool("convert_reference_checkpoint").main,
                          monkeypatch).parse_args(argv)
    args = conv.parser().parse_args(argv)
    assert {k: v for k, v in vars(args).items() if k in vars(jax_args)} == vars(jax_args)
    seen = []
    monkeypatch.setattr(conv, "convert", lambda kind, pth, config, level: (
        seen.append((kind, pth, level)) or {"model": {}}))
    path = conv.main(argv)
    assert seen == [("branch", str(tmp_path / "ref.pth"), "medium")]
    assert os.path.exists(path) and path.endswith("best_model.pth")


# ----------------------------------------------------------- the LPIPS tool ---

def test_distortions_are_the_jax_tools():
    jcal = _jax_tool("calibrate_lpips")
    img = np.random.default_rng(3).random((32, 32, 3), dtype=np.float32)
    ours, theirs = cal.families(np.random.default_rng(9)), {
        "blur": jcal._blur, "noise": jcal._noise(np.random.default_rng(9)), "fog": jcal._fog,
        "quant": jcal._quant, "pixelate": jcal._pixelate, "contrast": jcal._contrast}
    assert sorted(ours) == list(cal.FAMILIES) == sorted(theirs)
    for name in cal.FAMILIES:
        for lvl in range(cal.LEVELS):
            np.testing.assert_allclose(ours[name](img, lvl), theirs[name](img, lvl), rtol=0,
                                       atol=1e-6, err_msg=f"{name} {lvl}")


def test_both_lpips_tools_label_the_same_pairs(corpus, tmp_path):
    """On one corpus and seed, the JAX tool (`--uniform`, on the CPU) and the
    port's draw the same patches and distortions and label as many
    ranking pairs; both sidecars mark the synthetic calibration."""
    argv = ["--corpus", corpus, "--patches", "4", "--size", "64", "--uniform", "--seed", "1"]
    _jax_tool("calibrate_lpips").main(argv + ["--out", str(tmp_path / "jax" / "cal")])
    with open(tmp_path / "jax" / "cal.metrics.json") as f:
        want = json.load(f)
    path = cal.main(argv + ["--out", str(tmp_path / "port" / "cal"), "--device", "cpu"])
    got = ckpt.load_checkpoint(path)[1]
    assert (got["patches"], got["pairs"]) == (want["patches"], want["pairs"])
    assert got["calibration_synthetic"] == want["calibration_synthetic"] == 1.0
    assert got["uniform_heads"] == 1.0


def _jax_ranking_loss(ws, dms, prs, init_ws):
    """tools/calibrate_lpips.py's loss_fn (its `distance` and `loss_fn`)."""
    def distance(sel):
        return sum(jnp.asarray(d)[sel] @ jax.nn.relu(w) for d, w in zip(dms, ws))

    db, dw = distance(prs[:, 0]), distance(prs[:, 1])
    rank = jnp.mean(jax.nn.softplus(-(dw - db) * 50.0))
    anchor = sum(jnp.mean((w - w0) ** 2) for w, w0 in zip(ws, init_ws)) / len(ws)
    return rank + 0.1 * anchor


def test_ranking_loss_and_gradient_are_the_jax_tools():
    rng = np.random.default_rng(4)
    dms = [rng.random((40, c)).astype(np.float32) * 0.01 for c in (64, 192, 384, 256, 256)]
    heads = [(rng.random(d.shape[1]) / d.shape[1] * 2 - 0.2 / d.shape[1]).astype(np.float32)
             for d in dms]
    pairs = rng.integers(0, 40, size=(64, 2))
    init = [np.full(d.shape[1], 1.0 / d.shape[1], np.float32) for d in dms]
    want, want_g = jax.value_and_grad(_jax_ranking_loss)(
        [jnp.asarray(w) for w in heads], dms, pairs, [jnp.asarray(w) for w in init])
    ws = [torch.from_numpy(w).requires_grad_() for w in heads]
    got = cal.ranking_loss(ws, [torch.from_numpy(d) for d in dms], torch.from_numpy(pairs),
                           [torch.from_numpy(w) for w in init])
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    for w, g in zip(ws, want_g):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g), rtol=0, atol=1e-5)


def test_three_calibration_steps_give_weights_that_report_lpips_cal_synth(corpus, tmp_path):
    path = cal.main(["--corpus", corpus, "--out", str(tmp_path / "cal"), "--patches", "4",
                     "--steps", "3", "--device", "cpu"])
    metrics = ckpt.load_checkpoint(path)[1]
    assert metrics["calibration_synthetic"] == 1.0 and metrics["uniform_heads"] == 0.0
    iq = ImageQualityMetrics(lpips_weights=path, device="cpu")
    assert iq.lpips_key == "lpips_cal_synth"
    heads = iq.lpips_net.lin0.detach()
    assert not torch.allclose(heads, torch.full_like(heads, 1 / 64))   # fitted
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    iq.add_batch(x, x.flip(1), "overall")
    assert set(iq.compute_averages()["overall"]) == {"psnr", "ssim", "lpips_cal_synth",
                                                     "samples"}
    nets = DehazingLoss(lpips_weights=path).init(torch.Generator().manual_seed(1))
    assert torch.equal(nets["lpips"].lin0, iq.lpips_net.lin0)


# tools/justify_lpips_calibration.py's JSON: `out` and each `per_family` entry.
JUSTIFY_KEYS = {"protocol", "patches", "pairs", "steps", "per_family",
                "mean_heldout_acc_fitted", "mean_heldout_acc_uniform",
                "mean_heldout_margin_fitted", "mean_heldout_margin_uniform", "fitted_wins",
                "decision"}
JUSTIFY_FAMILY_KEYS = {"n_test_pairs", "acc_fitted", "acc_uniform", "margin_fitted",
                       "margin_uniform"}


def test_justify_tool_writes_the_jax_tools_keys(corpus, tmp_path):
    out = tmp_path / "justify.json"
    doc = justify.main(["--corpus", corpus, "--patches", "4", "--steps", "2", "--out",
                        str(out), "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(doc))
    assert set(doc) == JUSTIFY_KEYS
    assert sorted(doc["per_family"]) == sorted(cal.FAMILIES)
    for rec in doc["per_family"].values():
        assert set(rec) == JUSTIFY_FAMILY_KEYS and rec["n_test_pairs"] > 0


# ------------------------------------------------------- eval_dtype_delta ---

TINY = {"dataset": {"img_size": 32, "batch_size": 4, "num_workers": 1},
        "dehazing": {"low": {"channels": 8, "blocks": 1}, "medium": {"channels": 4},
                     "high": {"channels": 8}},
        "evaluation": {"nima_steps": 2}, "cuda": {"compute_dtype": "float32"}}


def test_eval_dtype_delta_keys_and_its_fp32_row_are_the_evaluation(corpus, tmp_path):
    """A seeded joint checkpoint: the tool's float32 row is
    evaluate_joint_model's per-sample averages on it, and `dtype_delta` has
    the JAX tool's keys and lands in comprehensive_results.json."""
    exp = tmp_path / "exp"
    cfg = load_config(overrides=TINY)
    cfg["dataset"].update(train_path=corpus, val_path=corpus, test_path=corpus)
    os.makedirs(exp)
    with open(exp / "config.yaml", "w") as f:
        yaml.dump(cfg, f)
    cfg = update_checkpoint_paths(cfg, str(exp))
    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    init_params_(router, torch.Generator().manual_seed(2))
    ckpt.save_checkpoint(cfg["joint_training"]["checkpoint_dir"], "best_model",
                         {"model": router.state_dict()})
    results = os.path.join(cfg["evaluation"]["results_dir"], "comprehensive_results.json")
    os.makedirs(os.path.dirname(results))
    with open(results, "w") as f:
        json.dump({"joint_results": {}}, f)

    delta = edd.main(["--experiment_dir", str(exp), "--cpu"])
    assert set(delta) == {"bf16", "f32", "psnr_cost_db", "ssim_cost"}
    with open(results) as f:
        assert json.load(f)["dtype_delta"] == json.loads(json.dumps(delta))
    rows = evaluate_joint_model(cfg, device="cpu")
    cats = [rows[c] for c in ("low_intensity", "medium_intensity", "high_intensity") if c in rows]
    n = sum(c["samples"] for c in cats)
    assert delta["f32"]["samples"] == n
    for key in ("psnr", "ssim", "lpips_uncal"):
        want = sum(c[key] * c["samples"] for c in cats) / n
        assert abs(delta["f32"][key] - want) <= 1e-5, key
    assert delta["psnr_cost_db"] == delta["f32"]["psnr"] - delta["bf16"]["psnr"]


# ----------------------------------------------------------- run_ablations ---

def test_ablations_table_is_the_jax_tools():
    assert abl.ABLATIONS == _jax_tool("run_ablations").ABLATIONS


def test_run_ablations_writes_the_jax_tools_keys(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)     # the runs write under experiments/ablations/
    out = tmp_path / "ablations.json"
    doc = abl.main(["--only", "full", "--epochs", "1", "--data", corpus, "--img_size", "32",
                    "--out", str(out), "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == doc
    assert set(doc) == {"level", "epochs", "lpips_weights", "results"}
    assert (doc["level"], doc["epochs"], list(doc["results"])) == ("medium", 1, ["full"])
    rec = doc["results"]["full"]
    assert rec["overrides"] == {} and {"val_psnr", "val_ssim", "epoch"} <= set(rec)
