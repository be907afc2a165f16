"""The port's counterparts of the JAX package's last user tools
(adam_dehaze_tpu_torch/tools/: validate_real_weights,
rerun_hard_routing_eval, rerun_detection_eval, collect_round_results,
measure_train_throughput) and the measured dispatch cost of the serving
autotune, on the CPU, small and seeded:

- each tool takes every flag of its JAX tool (the parsers that their
  `main`s build);
- `validate_real_weights --selftest --device cpu` passes for the four kinds
  at narrow widths, with the JAX tool's keys; for branch (high) and joint
  the same `.pth` also goes through the JAX package's readers (the JAX
  converter's), its orbax save and restore, and its forward, which matches
  the port's recorded one within 1e-4;
- each rerun on a tiny experiment writes the files that the JAX tool,
  given the same rows, writes; the rows are the port's own
  `evaluate_hard_routing` / `evaluate_object_detection` on the experiment;
- `collect_round_results` writes the JAX tool's fields, every one but the
  routing ones equal to the JAX tool's on the same metric files; its
  classifier accuracy is the hard-routing rows' routing accuracy;
- `measure_train_throughput` prints the JAX tool's keys in both modes;
- `load_or_tune` stores the winner's intercept (`dispatch_ms`) in its
  report and cache entry, `_chunk_costs` feeds it to the planner, and a
  cache entry without it falls back to `AdaptiveDehazer.DISPATCH_MS`; a
  line through the two times that does not rise gives no intercept.
"""
import concurrent.futures
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adam_dehaze_tpu.config import load_config as jax_load_config
from adam_dehaze_tpu.evaluation import evaluate as JEV
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu.training import checkpoint as JCK
from adam_dehaze_tpu_torch import serving_autotune
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.evaluation.evaluate import (
    evaluate_hard_routing,
    evaluate_object_detection,
)
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER, create_router
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.tools import collect_round_results as collect
from adam_dehaze_tpu_torch.tools import measure_train_throughput as throughput
from adam_dehaze_tpu_torch.tools import rerun_detection_eval as rerun_det
from adam_dehaze_tpu_torch.tools import rerun_hard_routing_eval as rerun_hard
from adam_dehaze_tpu_torch.tools import validate_real_weights as validate
from test_torch_tools_round import _jax_tool, _options, _parser_of
from torch_port_util import ATOL, TINY, images, tiny_experiment, zeros_like_variables
from torch_port_util import one_torch_thread  # noqa: F401  (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOOLS = {"validate_real_weights": validate, "rerun_hard_routing_eval": rerun_hard,
         "rerun_detection_eval": rerun_det, "collect_round_results": collect,
         "measure_train_throughput": throughput}
KEY = jax.random.PRNGKey(0)
# Narrow widths for the validation tool and the throughput tool.
WIDTHS = {"low": {"channels": 8, "blocks": 2}, "medium": {"channels": 8},
          "high": {"channels": 16}}
# tools/validate_real_weights.py's summary keys, with the restore's fields
# of each kind; the port adds `device` and `launches`.
VALIDATE_KEYS = {"kind", "pth", "converted", "ok", "mode", "parity", "atol",
                 "forward_max_abs_diff", "device", "launches"}
VALIDATE_EXTRA = {"classifier": set(), "branch": set(),
                  "joint": {"eval_psnr_dehazed", "eval_psnr_hazy"},
                  "fcos": {"n_levels", "finite"}}
VALIDATE_DIFFS = {"classifier": {"logits"}, "branch": {"out"}, "fcos": set(),
                  "joint": {"classifier_logits", "low_out", "medium_out", "high_out"}}
# tools/measure_train_throughput.py's JSON keys in each mode (the cost
# analysis's among them); the port adds `nvidia_smi`.
THROUGHPUT_KEYS = {
    "soft": {"metric", "value", "sec_per_step", "batch", "size", "remat", "device",
             "train_gflops_per_step", "train_mfu_pct", "assumed_peak_tflops", "nvidia_smi"},
    "hard": {"metric", "value", "sec_per_round", "batch", "size", "device",
             "gflops_per_image", "tflops_per_sec", "nvidia_smi"}}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_port_tool_takes_every_flag_of_the_jax_tool(tool, monkeypatch):
    """Each option of the JAX tool is the port tool's, with the same
    destination and kind, and every choice the JAX tool offers."""
    want = _options(_parser_of(_jax_tool(tool).main, monkeypatch))
    got = _options(_parser_of(TOOLS[tool].main, monkeypatch))
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for flag, a in want.items():
        b = got[flag]
        assert (b.dest, type(b).__name__, b.type, b.required) == \
            (a.dest, type(a).__name__, a.type, a.required), flag
        assert a.choices is None or set(a.choices) <= set(b.choices), flag


# -------------------------------------------------------- validate_real_weights ---

@pytest.fixture(scope="module")
def validated(tmp_path_factory):
    """kind -> (the tool's JSON fields, its workdir, the config file) of
    `--selftest --device cpu` at narrow widths, the four kinds at once."""
    tmp = tmp_path_factory.mktemp("validate")
    cfg_path = str(tmp / "narrow.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"dehazing": WIDTHS}, f)

    def run(kind):
        workdir = str(tmp / kind)
        argv = ["--kind", kind, "--selftest", "--config", cfg_path, "--workdir", workdir,
                "--device", "cpu"] + (["--level", "high"] if kind == "branch" else [])
        return kind, (validate.validate(argv), workdir, cfg_path)

    with pytest.MonkeyPatch.context() as m:
        m.setenv("OMP_NUM_THREADS", "1")        # the tool's subprocesses
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            return dict(pool.map(run, validate.KINDS))


@pytest.mark.parametrize("kind", validate.KINDS)
def test_validate_selftest_passes(validated, kind):
    line, _, _ = validated[kind]
    assert line["ok"] is True, line
    assert set(line) == VALIDATE_KEYS | VALIDATE_EXTRA[kind]
    assert (line["mode"], line["device"], line["launches"]) == ("selftest", "cpu", {})
    assert line["parity"] == ("layout_only" if kind == "fcos" else "forward_numeric")
    assert set(line["forward_max_abs_diff"]) == VALIDATE_DIFFS[kind]
    assert all(d <= 1e-4 for d in line["forward_max_abs_diff"].values())
    assert os.path.exists(line["pth"]) and os.path.exists(line["converted"])
    if kind == "fcos":
        assert line["n_levels"] == 5 and line["finite"] is True
    if kind == "joint":
        assert all(np.isfinite(line[k]) for k in VALIDATE_EXTRA["joint"])


def _jax_template_and_applies(kind, cfg, x):
    """(the converter's template of zeros, {output: the apply of a restored
    tree}) of the JAX package's module of `kind`, as the JAX tool's restore
    script computes its outputs."""
    if kind == "branch":
        model = JB.create_high_intensity_model(cfg)
        apply = jax.jit(lambda v: model.apply(v, x, train=False))
        return zeros_like_variables(lambda: model.init(KEY, x[:1])), {"out": apply}
    branches = JB.create_branch_models(cfg)
    clf = JC.create_classifier(cfg)
    router = JR.create_router(branches, clf, cfg)
    template = zeros_like_variables(lambda: router.init({"params": KEY, "dropout": KEY}, x[:1]))

    def part(name, module, **kw):
        fn = jax.jit(lambda v: module.apply(v, x, **kw))
        return lambda t: fn({"params": t["params"][name], "batch_stats": t["batch_stats"][name]})

    logits = part("classifier", clf)
    applies = {"classifier_logits": lambda t: logits(t)[0]}
    for lvl in INTENSITY_ORDER:
        applies[f"{lvl}_out"] = part(f"models_{lvl}", branches[lvl], train=False)
    return template, applies


@pytest.mark.parametrize("kind", ["branch", "joint"])
def test_jax_forward_of_the_selftest_pth_matches_the_port(validated, kind):
    """The selftest's `.pth` through the JAX package's reader (what its
    converter runs), an orbax save and restore, and the JAX forward of the
    fixed input: every output within 1e-4 of the port's recorded one."""
    _, workdir, cfg_path = validated[kind]
    cfg = jax_load_config(cfg_path)
    cfg["tpu"]["compute_dtype"] = "float32"
    recorded = np.load(os.path.join(workdir, "recorded.npz"))
    x = jnp.asarray(recorded["x"])
    template, applies = _jax_template_and_applies(kind, cfg, x)
    pth = torch.load(os.path.join(workdir, f"{kind}_selftest.pth"), weights_only=True)
    as_np = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) and
                 k != "optimizer_state_dict" else v) for k, v in pth.items()}
    if kind == "branch":
        params, stats = JCK.load_torch_branch(as_np["model_state_dict"], "high",
                                              template["params"],
                                              template["batch_stats"])
        tree = {"params": params, "batch_stats": stats}
    else:
        tree = JCK.load_torch_joint(as_np, template, cfg)
    path = JCK.save_checkpoint(os.path.join(workdir, "jax"), "converted", tree, {"source": 0.0})
    restored, _ = JCK.load_checkpoint(path, tree)
    assert set(applies) == set(recorded.files) - {"x"}
    for name, apply in applies.items():
        np.testing.assert_allclose(np.asarray(apply(restored)), recorded[name], rtol=0,
                                   atol=ATOL, err_msg=name)


def test_validate_fails_on_a_surplus_key(tmp_path, capsys):
    """A `.pth` with a key the port's module lacks stops at the record
    stage: `ok: false`, exit code 1."""
    model = create_branch_models(load_config(overrides={"dehazing": WIDTHS}))["medium"]
    sd = {**model.state_dict(), "extra.weight": torch.zeros(1)}
    pth = str(tmp_path / "medium.pth")
    torch.save({"model_state_dict": sd}, pth)
    cfg_path = str(tmp_path / "narrow.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"dehazing": WIDTHS}, f)
    rc = validate.main(["--kind", "branch", "--pth", pth, "--config", cfg_path,
                        "--workdir", str(tmp_path), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and line["ok"] is False and line["stage"] == "record"
    assert "extra.weight" in line["error"]


# ------------------------------------------------- the experiment's tools ---

@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A tiny experiment directory (torch_port_util.tiny_experiment, two
    test images a level). Returns (dir, config pointed at it)."""
    return tiny_experiment(tmp_path_factory.mktemp("day_one"), test=2)


def _results(cfg, name):
    with open(os.path.join(cfg["evaluation"]["results_dir"], name)) as f:
        return json.load(f)


def _run_both(exp, cfg, port_argv, jax_name, jax_evaluator, rows, monkeypatch, names,
              artifact=None):
    """The port tool, then the JAX tool with `jax_evaluator` returning
    `rows`, each from the same comprehensive_results.json (and artifact):
    {file name: (port's JSON, JAX's JSON)} of `names` (and "artifact")."""
    results = cfg["evaluation"]["results_dir"]
    start = {n: _results(cfg, n) for n in os.listdir(results)}
    art_start = {"round": 1}

    def reset():
        for n in os.listdir(results):
            os.remove(os.path.join(results, n))
        for n, doc in start.items():
            with open(os.path.join(results, n), "w") as f:
                json.dump(doc, f)
        if artifact:
            with open(artifact, "w") as f:
                json.dump(art_start, f)

    def read():
        docs = {n: _results(cfg, n) for n in names}
        if artifact:
            with open(artifact) as f:
                docs["artifact"] = json.load(f)
        return docs

    reset()
    port_rows = TOOLS[port_argv[0]].main(port_argv[1:])
    port = read()
    reset()
    monkeypatch.setattr(JEV, jax_evaluator, lambda config: rows)
    _jax_tool(jax_name).main(["--experiment_dir", exp]
                             + (["--artifact", artifact] if artifact else []))
    jax_side = read()
    reset()
    return port_rows, {n: (port[n], jax_side[n]) for n in port}


def test_rerun_hard_routing_patches_what_the_jax_tool_does(experiment, tmp_path,
                                                           monkeypatch):
    exp, cfg = experiment
    want = evaluate_hard_routing(cfg, device="cpu")
    artifact = str(tmp_path / "artifact.json")
    rows, docs = _run_both(exp, cfg, ["rerun_hard_routing_eval", "--experiment_dir", exp,
                                      "--cpu", "--artifact", artifact],
                           "rerun_hard_routing_eval", "evaluate_hard_routing",
                           json.loads(json.dumps(want)), monkeypatch,
                           ["comprehensive_results.json"], artifact)
    assert json.loads(json.dumps(rows)) == json.loads(json.dumps(want))
    for name, (port, jax_doc) in docs.items():
        assert port == jax_doc, name
    assert set(docs["comprehensive_results.json"][0]) == {"joint", "hard_routing"}
    assert set(docs["artifact"][0]) == {"round", "hard_routing"}


def test_rerun_detection_patches_what_the_jax_tool_does(experiment, monkeypatch):
    exp, cfg = experiment
    want = json.loads(json.dumps(evaluate_object_detection(cfg, device="cpu")))
    rows, docs = _run_both(exp, cfg, ["rerun_detection_eval", "--experiment_dir", exp,
                                      "--device", "cpu"],
                           "rerun_detection_eval", "evaluate_object_detection", want,
                           monkeypatch, ["comprehensive_results.json",
                                         "detection_results.json"])
    assert json.loads(json.dumps(rows)) == want
    for name, (port, jax_doc) in docs.items():
        assert port == jax_doc, name
    det = docs["comprehensive_results.json"][0]["detection"]
    assert set(det) == {"hazy", "dehazed", "improvement_percent"}
    assert det["hazy"] == want["hazy"]["overall"]


def test_collect_round_results_writes_the_jax_tools_fields(experiment, tmp_path,
                                                           monkeypatch):
    """The JAX tool on the same experiment (its router unavailable: there
    is no JAX checkpoint) writes every field the port writes, equal but the
    routing ones; the port's routing rows are means of softmax weights, and
    its accuracy is evaluate_hard_routing's routing accuracy."""
    exp, cfg = experiment
    got = collect.main(["--experiment_dir", exp, "--device", "cpu"])
    with open(os.path.join(exp, "full_system.json")) as f:
        assert json.load(f) == json.loads(json.dumps(got))

    def no_jax_router(config):
        raise FileNotFoundError("no JAX joint checkpoint in this experiment")

    monkeypatch.setattr(JEV, "_load_joint", no_jax_router)
    out = str(tmp_path / "jax_full_system.json")
    _jax_tool("collect_round_results").main(["--experiment_dir", exp, "--out", out])
    with open(out) as f:
        want = json.load(f)
    assert want["routing_weight_distribution"].startswith("unavailable")
    assert set(got) == set(want) | {"router_classifier_test_acc"}
    routing = {"routing_weight_distribution", "router_classifier_test_acc"}
    assert {k: v for k, v in got.items() if k not in routing} == \
        {k: v for k, v in want.items() if k not in routing}
    assert got["branches"]["medium"] is None and got["branches"]["low"] == {"val_psnr": 21.0}
    dist = got["routing_weight_distribution"]
    assert dist["order"] == ["w_low", "w_medium", "w_high"]
    for name in ("true_low", "true_medium", "true_high"):
        assert len(dist[name]) == 3 and abs(sum(dist[name]) - 1.0) <= 2e-4, dist
    hard = evaluate_hard_routing(cfg, device="cpu")
    assert got["router_classifier_test_acc"] == round(hard["routing_acc"], 4)


# --------------------------------------------------- measure_train_throughput ---

@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_measure_train_throughput_prints_the_jax_tools_keys(mode, monkeypatch, capsys):
    """At narrow widths on the CPU: the JAX tool's keys, a positive rate,
    the FLOPs counted, no MFU and no nvidia-smi line off the card."""
    import adam_dehaze_tpu_torch.config as config_module
    default = config_module.load_config

    def narrow(*args, **kwargs):
        cfg = default(*args, **kwargs)
        for lvl, w in WIDTHS.items():
            cfg["dehazing"][lvl].update(w)
        return cfg

    monkeypatch.setattr(config_module, "load_config", narrow)
    line = throughput.main(["--device", "cpu", "--batch", "2", "--size", "32", "--steps", "2",
                            "--mode", mode] + (["--remat", "full"] if mode == "soft" else []))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert set(line) == THROUGHPUT_KEYS[mode]
    assert (line["device"], line["nvidia_smi"], line["batch"], line["size"]) == \
        ("cpu", None, 2, 32)
    assert line["value"] > 0
    if mode == "soft":
        assert line["remat"] == "full" and line["train_gflops_per_step"] > 0
        assert line["train_mfu_pct"] is None and line["assumed_peak_tflops"] is None
        assert line["metric"] == "joint_train_imgs_per_sec_per_chip"
    else:
        assert line["gflops_per_image"] > 0
        assert line["metric"] == "joint_train_hard_imgs_per_sec_per_chip"


# ------------------------------------------------- the measured dispatch cost ---

def test_tuned_intercept_reaches_the_chunk_planner(tmp_path, monkeypatch):
    """With `_time_ms` an affine function of the rows (a + b * rows), the
    tuner's `dispatch_ms` is a in every report and cache entry, and
    `_chunk_costs` gives (a, b) for each branch; a cache entry written
    without it falls back to DISPATCH_MS. Served outputs do not move."""
    a, b = 0.7, 0.05
    monkeypatch.setattr(serving_autotune, "_time_ms",
                        lambda fn, x, iters, warm: a + b * x.shape[0])
    cfg = load_config(overrides=TINY)
    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    init_params_(router, torch.Generator().manual_seed(8))
    cache = str(tmp_path / "autotune.json")
    tuned = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device="cpu", autotune=True,
                            autotune_cache=cache)
    for report in tuned.autotune_report.values():
        assert report["dispatch_ms"] == pytest.approx(a, abs=1e-4)
        assert report["cached"] is False
    dispatch, row = tuned._chunk_costs()
    assert dispatch == pytest.approx([a] * 3, abs=1e-4)
    assert row == pytest.approx([b] * 3, abs=1e-4)
    assert tuned.engine.program_overhead_rows == pytest.approx([a / b] * 3, rel=1e-3)
    with open(cache) as f:
        entries = json.load(f)
    assert all(e["dispatch_ms"] == pytest.approx(a, abs=1e-4) for e in entries.values())

    with open(cache, "w") as f:       # an entry written before the intercept was measured
        json.dump({k: {n: v for n, v in e.items() if n != "dispatch_ms"}
                   for k, e in entries.items()}, f)
    old = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device="cpu", autotune=True,
                          autotune_cache=cache)
    assert all(r["cached"] and "dispatch_ms" not in r for r in old.autotune_report.values())
    dispatch, row = old._chunk_costs()
    want = [AdaptiveDehazer.DISPATCH_MS[lvl] for lvl in INTENSITY_ORDER]
    assert dispatch == want
    ms16 = a + 16 * b
    assert row == pytest.approx([max(ms16 - d, 1e-6) / 16 for d in want])
    x = images((6, 32, 32, 3), seed=9)
    for got, want_out in zip(tuned.route_hard(x), old.route_hard(x)):
        np.testing.assert_array_equal(got, want_out)


def test_dispatch_ms_needs_more_rows_than_it_times_again():
    """A sample of DISPATCH_ROWS rows or fewer gives no intercept, and so
    does a line that does not rise (the few rows no faster than the whole
    sample). Each point is the least of DISPATCH_REPEATS runs, the full
    one no more than the tuner's time; the intercept is clamped at
    MIN_DISPATCH_MS."""
    model = create_branch_models(load_config(overrides=TINY))["low"]
    fn = lambda x: x    # noqa: E731
    assert serving_autotune.dispatch_ms(fn, model, (2, 8, 8, 3), 1.0) is None
    with pytest.MonkeyPatch.context() as m:
        m.setattr(serving_autotune, "_time_ms", lambda fn, x, iters, warm: 5.0)
        # 5 ms at 2 rows and 1 ms at 16: no intercept, not one above 5 ms.
        assert serving_autotune.dispatch_ms(fn, model, (16, 8, 8, 3), 1.0) is None
        assert serving_autotune.dispatch_ms(fn, model, (16, 8, 8, 3), 100.0) is None
        # A host hiccup on the first run of each point: the least is kept.
        runs = iter([9.0, 1.2, 1.4, 30.0, 3.0, 3.3])
        m.setattr(serving_autotune, "_time_ms", lambda fn, x, iters, warm: next(runs))
        assert serving_autotune.DISPATCH_REPEATS == 3
        assert serving_autotune.dispatch_ms(fn, model, (16, 8, 8, 3), 4.0) == \
            pytest.approx(1.2 - 2 * (3.0 - 1.2) / 14)
        # The tuner's own time where it is below the re-timed one.
        m.setattr(serving_autotune, "_time_ms",
                  lambda fn, x, iters, warm: 1.0 + 0.5 * x.shape[0])
        assert serving_autotune.dispatch_ms(fn, model, (16, 8, 8, 3), 7.0) == \
            pytest.approx(2.0 - 2 * (7.0 - 2.0) / 14)
        m.setattr(serving_autotune, "_time_ms",
                  lambda fn, x, iters, warm: 0.1 if x.shape[0] == 2 else 100.0)
        assert serving_autotune.dispatch_ms(fn, model, (16, 8, 8, 3), 100.0) == \
            serving_autotune.MIN_DISPATCH_MS
