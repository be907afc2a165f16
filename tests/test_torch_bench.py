"""The port's benchmark (adam_dehaze_tpu_torch/bench.py) on the CPU, at
narrow widths, 32^2, batch 12, one warm-up call and one timed call:

- its JSON line from a `--full` run on a tiny experiment (a resolution
  policy and a serving-autotune cache in it) holds every key that the root
  bench.py writes for the rows that ran (read from bench.py's source with
  `ast`, never run), plus `device` and nothing else, and no row is skipped;
- the timed callables (the primary engine, buckets (2, 4, bucket); the
  device-binned engine; the switch apply) against the JAX package's
  BinnedAdaptiveEngine, make_device_binned_infer and
  make_adaptive_infer("switch") on the JAX/port pair of
  torch_port_util.dehazer_pair, fp32, at 1e-4;
- a tiny BENCH_BUDGET_S still prints the primary row and skips the rest.
"""
import ast
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu_torch import bench
from adam_dehaze_tpu_torch import serving_autotune
from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER
from torch_port_util import ATOL, dehazer_pair, images, tiny_experiment
from torch_port_util import one_torch_thread  # noqa: F401  (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--size", "32", "--batch", "12", "--iters", "1", "--warmup", "1"]
BUCKET = 4
# Narrow widths for the bench's seeded models.
WIDTHS = {"low": {"channels": 8, "blocks": 2}, "medium": {"channels": 8},
          "high": {"channels": 16}}
# The keys of the line whatever rows ran.
CLOSING = {"unit", "metric", "value", "mode", "flops_source", "measured_gflops_per_image",
           "mfu_pct", "assumed_peak_tflops", "best_serving_ms_per_image",
           "imgs_per_sec_per_chip", "vs_baseline", "bench_wall_s"}
BENCH_ENV = ("BENCH_EXPERIMENT", "BENCH_AUTOTUNE_CACHE", "BENCH_RESOLUTION_POLICY",
             "BENCH_BUDGET_S", "BENCH_FULL", "BENCH_AUTOTUNE")


def jax_bench_keys():
    """Every key root bench.py writes into its line: `result["..."]`
    subscripts, the dict it starts from, and each f-string key's suffix
    after each prefix that `_switch_rows` is called with."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys, suffixes, prefixes = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "result":
            if isinstance(node.slice, ast.Constant):
                keys.add(node.slice.value)
            elif isinstance(node.slice, ast.JoinedStr):
                suffixes.add("".join(v.value for v in node.slice.values
                                     if isinstance(v, ast.Constant)))
        elif (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result"
              and isinstance(node.value, ast.Dict)):
            keys.update(k.value for k in node.value.keys)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_switch_rows":
            prefixes.add(node.args[-1].value)
    return keys | {p + s for p in prefixes for s in suffixes}


@pytest.fixture
def narrow(monkeypatch):
    """The bench's config at narrow widths (a config file read by path, an
    experiment's, stays as it is) and the bench's variables out of the
    environment."""
    import adam_dehaze_tpu_torch.config as config_module
    default = config_module.load_config

    def patched(*args, **kwargs):
        cfg = default(*args, **kwargs)
        if not args and not kwargs:
            for lvl, w in WIDTHS.items():
                cfg["dehazing"][lvl].update(w)
        return cfg

    monkeypatch.setattr(config_module, "load_config", patched)
    for name in BENCH_ENV:
        monkeypatch.delenv(name, raising=False)
    return patched


def _line(capsys):
    out, err = capsys.readouterr()
    launches = [ln for ln in err.splitlines() if ln.startswith("[bench launches] ")]
    assert len(launches) == 1, err
    return (json.loads(out.strip().splitlines()[-1]),
            json.loads(launches[0][len("[bench launches] "):]), err)


def test_full_line_has_the_jax_bench_keys(narrow, tmp_path, monkeypatch, capsys):
    exp, _ = tiny_experiment(tmp_path, test=BUCKET)
    # A hit for every branch on the CPU's one candidate; high without a
    # measured dispatch_ms (the planner takes DISPATCH_MS for it).
    cfg = narrow()
    _, branches, _ = bench.seeded(cfg, torch.device("cpu"), 3, 32)
    cache = {serving_autotune._cache_key(branches[n], torch.float32, (BUCKET, 32, 32, 3)):
             {"best": "canonical", "table": {"canonical": 2.0},
              **({} if n == "high" else {"dispatch_ms": 0.5})}
             for n in INTENSITY_ORDER}
    with open(os.path.join(exp, "serving_autotune.json"), "w") as f:
        json.dump(cache, f)
    with open(os.path.join(exp, "resolution_policy.json"), "w") as f:
        json.dump({"levels": {"low": {"choice": "full"},
                              "medium": {"choice": "lowres", "scale": 2, "mode": "bilinear",
                                         "radius": 4},
                              "high": {"choice": "lowres", "scale": 2, "mode": "guided",
                                       "radius": 2}}}, f)
    monkeypatch.setenv("BENCH_EXPERIMENT", exp)
    monkeypatch.chdir(tmp_path)

    got = bench.main(SMALL + ["--full"])
    line, launches, err = _line(capsys)
    assert line == json.loads(json.dumps(got))
    want = jax_bench_keys() - {"partial"}
    if line["mode"] != "device_binned":
        want -= {"host_binned_ms_per_image"}
    assert set(line) == want | {"device"}
    assert "skipped" not in err and "failed" not in err, err
    assert (line["metric"], line["device"]) == ("adaptive_dehaze_ms_per_image_256", "cpu")
    assert line["mode"] in ("binned", "device_binned") and line["value"] > 0
    assert line["autotuned_dispatch"] == dict.fromkeys(INTENSITY_ORDER, "canonical")
    assert line["resolution_policy"] == {"low": "full", "medium": "lowres", "high": "lowres"}
    assert 0.0 <= line["trained_routing_acc"] <= 1.0
    assert len(line["queued_routing_trained_ms_samples"]) == 3
    assert line["mfu_pct"] is None and line["guarded_lowres_mfu_pct"] is None
    assert line["measured_gflops_per_image"] > 0
    assert line["int8_lowering"] == bench.INT8_LOWERING["cpu"]
    # Every row that ran is in the launches line; no kernel runs on the CPU.
    assert {"binned", "device_binned", "single_image", "single_image_guarded",
            "detection_pipeline", "predicted_routing_trained", "spill_routing_trained",
            "spill_up_routing_trained", "device_spill_trained", "queued_routing_trained",
            "stream", "device_binned_stream", "skewed", "lowres_medhigh", "guarded_lowres",
            "predicted_routing", "int8"} == set(launches)
    assert not any(launches.values())


def test_tiny_budget_prints_the_primary_row_only(narrow, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_BUDGET_S", "1e-9")
    monkeypatch.chdir(tmp_path)
    bench.main(SMALL)
    line, launches, err = _line(capsys)
    assert set(line) == CLOSING | {"device"}
    assert line["metric"] == "adaptive_dehaze_ms_per_image_256" and line["mode"] == "binned"
    assert set(launches) == {"binned"}
    for row in ("device_binned", "single_image", "detection_pipeline", "trained_routing",
                "stream", "skewed", "lowres", "guarded_lowres"):
        assert f"exceeded; skipping {row}" in err


# ------------------------------------------------ the timed callables vs JAX ---

@pytest.fixture(scope="module")
def pair_callables():
    """The port bench's callables on the port dehazer's modules, and the
    JAX package's on the JAX dehazer's applies (jitted, as bench.py jits
    them), the same weights."""
    jd, pd = dehazer_pair()
    port = bench.build_callables(pd.router.classifier, pd.router.models, torch.float32,
                                 BUCKET, 32)
    jclf, japp = jd._classifier_apply(), jd._branch_applies()
    jax_calls = {
        "engine": JR.BinnedAdaptiveEngine(jax.jit(jclf), [jax.jit(f) for f in japp],
                                          buckets=(2, 4, BUCKET)),
        "device_binned": jax.jit(JR.make_device_binned_infer(jclf, japp, chunk=BUCKET)),
        "switch": jax.jit(JR.make_adaptive_infer(jclf, japp, mode="switch")),
    }
    return port, jax_calls


@pytest.mark.parametrize("name", ["engine", "device_binned", "switch"])
def test_timed_callable_matches_the_jax_engine(pair_callables, name):
    port, jax_calls = pair_callables
    x = images((3 * BUCKET, 32, 32, 3), seed=5)
    xt = torch.from_numpy(x)
    balanced = np.repeat(np.arange(3), BUCKET)
    # Skewed, and in buckets of BUCKET only: JAX compiles a program a bucket size.
    skewed = np.array([2, 2, 0, 2, 2, 2, 0, 2, 2, 2, 0, 0])
    with torch.inference_mode():
        if name == "engine":
            for labels in (balanced, skewed):
                got = port.engine(xt, intensity=labels)[0]
                want = jax_calls["engine"](jnp.asarray(x), intensity=labels)[0]
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        elif name == "device_binned":
            for labels in (balanced, skewed):
                got, gi, _ = port.device_binned(xt, torch.from_numpy(labels))
                want, wi, _ = jax_calls["device_binned"](jnp.asarray(x), jnp.asarray(labels))
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
                np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        else:
            got, gi = port.switch(xt[:3])
            want, wi = jax_calls["switch"](jnp.asarray(x[:3]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_cache_hit_feeds_the_planner(narrow, tmp_path):
    """A hit for all three branches sets the planner's overhead rows from
    each entry's dispatch_ms (DISPATCH_MS without one) over the winner's
    ms per row beyond it; a miss leaves the engine's default."""
    cfg = narrow()
    classifier, branches, _ = bench.seeded(cfg, torch.device("cpu"), 3, 32)
    ms = {"low": 1.2, "medium": 3.0, "high": 6.0}
    cache = {serving_autotune._cache_key(branches[n], torch.float32, (BUCKET, 32, 32, 3)):
             {"best": "canonical", "table": {"canonical": ms[n]},
              **({} if n == "high" else {"dispatch_ms": 0.4})}
             for n in INTENSITY_ORDER}
    path = str(tmp_path / "cache.json")
    with open(path, "w") as f:
        json.dump(cache, f)
    calls = bench.build_callables(classifier, branches, torch.float32, BUCKET, 32, path)
    fixed = {"low": 0.4, "medium": 0.4, "high": bench.DISPATCH_MS}
    assert calls.engine.program_overhead_rows == pytest.approx(
        [fixed[n] / ((ms[n] - fixed[n]) / BUCKET) for n in INTENSITY_ORDER])
    assert calls.dispatch_used == dict.fromkeys(INTENSITY_ORDER, "canonical")
    miss = bench.build_callables(classifier, branches, torch.float32, 2 * BUCKET, 32, path)
    assert miss.dispatch_used == {} and miss.engine.program_overhead_rows == [2.0] * 3
