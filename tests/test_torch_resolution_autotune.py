"""The quality-guarded resolution tuner of the port
(adam_dehaze_tpu_torch/resolution_autotune.py) and its tool against the
JAX package's (adam_dehaze_tpu/resolution_autotune.py), on the CPU.

Every case of tests/test_resolution_autotune.py runs on both packages with
the same probe images and constructed branches whose corrections lift
exactly (identity) or not at all (a pixel-rate checkerboard): the port
picks the same `choice` per level as JAX and its PSNRs agree within 1e-3
dB (the PSNR of float32 outputs that agree within 1e-4). The policy file's
keys are JAX's, with the device and the torch and CUDA versions in place
of jaxlib's. The port's table records only a kernel apply's up-front shape
refusal (ValueError) and running out of device memory as a candidate's
`error` row; any other failure raises.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu import resolution_autotune as JRA
from adam_dehaze_tpu.serving import AdaptiveDehazer as JaxDehazer
from adam_dehaze_tpu_torch import resolution_autotune as PRA
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 32
PSNR_DB = 1e-3
# The policy keys of both packages, and each package's own.
COMMON_KEYS = {"floor_db", "batch", "timed", "backend", "device_kind", "levels"}


def _smooth_probe(n=6, seed=0):
    """Low-frequency hazy images in [0.1, 0.9]: per-image affine ramps."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / (SIZE - 1)
    a = rng.uniform(0.1, 0.4, (n, 1, 1, 3)).astype(np.float32)
    b = rng.uniform(0.0, 0.3, (n, 1, 1, 3)).astype(np.float32)
    img = a + b * yy[None, :, :, None] + (0.9 - a - b) * 0.5 * xx[None, :, :, None]
    return np.clip(img, 0.1, 0.9).astype(np.float32)


def _identity(x):
    return x


def _checker(h, w, xp):
    if xp is torch:
        return ((torch.arange(h)[:, None] + torch.arange(w)[None, :]) % 2).float() * 0.1
    return ((jnp.arange(h)[:, None] + jnp.arange(w)[None, :]) % 2).astype(jnp.float32) * 0.1


def _jax_checker_apply(x):
    """Exact at full resolution, unliftable at half: a pixel-rate
    checkerboard (Nyquist content, gone after a 2x shrink and lift)."""
    return jnp.clip(x * 0.8 + _checker(x.shape[1], x.shape[2], jnp)[None, :, :, None], 0, 1)


def _port_checker_apply(x):
    return torch.clamp(x * 0.8 + _checker(x.shape[1], x.shape[2], torch)[None, :, :, None],
                       0, 1)


def _levels(n):
    return np.tile(np.arange(3), -(-n // 3))[:n]


def _both(jax_applies, port_applies, *args, **kwargs):
    want = JRA.tune_resolution_policy(jax_applies, *args, **kwargs)
    got = PRA.tune_resolution_policy(port_applies, *args, device="cpu", **kwargs)
    return want, got


def assert_same_policy(want, got):
    """The same choice and chosen parameters per level, every PSNR within
    PSNR_DB, the same table rows and eligibility."""
    assert COMMON_KEYS <= set(got) and COMMON_KEYS <= set(want)
    assert {k: got[k] for k in ("floor_db", "batch", "timed")} == \
        {k: want[k] for k in ("floor_db", "batch", "timed")}
    assert set(got["levels"]) == set(want["levels"])
    for level, w in want["levels"].items():
        g = got["levels"][level]
        assert {k: v for k, v in g.items() if k not in ("psnr_full", "psnr_choice", "table")} \
            == {k: v for k, v in w.items() if k not in ("psnr_full", "psnr_choice", "table")}, \
            level
        for key in ("psnr_full", "psnr_choice"):
            if key in w:
                assert abs(g[key] - w[key]) <= PSNR_DB, (level, key, g[key], w[key])
        assert set(g.get("table", {})) == set(w.get("table", {}))
        for name, row in w.get("table", {}).items():
            assert g["table"][name].get("eligible") == row.get("eligible"), (level, name)
            assert abs(g["table"][name]["psnr"] - row["psnr"]) <= PSNR_DB, (level, name)


def test_identity_branch_adopts_lowres():
    """Zero-correction branches lift exactly, so the dial ties full
    resolution on PSNR and wins on the FLOP proxy."""
    hazy = _smooth_probe(6)
    want, got = _both([_identity] * 3, [_identity] * 3, hazy, hazy, _levels(6),
                      floor_db=0.0, batch=2, time_candidates=False)
    assert_same_policy(want, got)
    for level, entry in got["levels"].items():
        assert entry["choice"] == "guided_r4_s2", (level, entry)
        assert entry["scale"] == 2 and entry["mode"] == "guided"
        assert entry["table"]["guided_r4_s2"]["eligible"]


def test_high_frequency_branch_keeps_full():
    hazy = _smooth_probe(6, seed=1)
    clear = np.asarray(_jax_checker_apply(jnp.asarray(hazy)))
    want, got = _both([_jax_checker_apply] * 3, [_port_checker_apply] * 3, hazy, clear,
                      _levels(6), floor_db=0.0, batch=2, time_candidates=False)
    assert_same_policy(want, got)
    for level, entry in got["levels"].items():
        assert entry["choice"] == "full", (level, entry)
        assert not entry["table"]["guided_r4_s2"]["eligible"]
        assert entry["psnr_full"] - entry["table"]["guided_r4_s2"]["psnr"] > 3.0


def test_floor_knob_licenses_lossy_lowres():
    """A huge floor makes the lossy dial eligible: the gate is the floor."""
    hazy = _smooth_probe(6, seed=2)
    clear = np.asarray(_jax_checker_apply(jnp.asarray(hazy)))
    want, got = _both([_jax_checker_apply], [_port_checker_apply], hazy, clear,
                      np.zeros(6, np.int64), floor_db=1000.0, batch=2, time_candidates=False)
    assert_same_policy(want, got)
    assert got["levels"]["low"]["choice"] != "full"


def test_missing_probe_class_defaults_full():
    hazy = _smooth_probe(4, seed=3)
    want, got = _both([_identity] * 3, [_identity] * 3, hazy, hazy, np.zeros(4, np.int64),
                      floor_db=0.0, batch=2, time_candidates=False)
    assert_same_policy(want, got)
    assert got["levels"]["low"]["choice"] == "guided_r4_s2"
    assert got["levels"]["medium"] == {"choice": "full", "reason": "no probe images"}
    assert got["levels"]["high"]["choice"] == "full"


def test_timed_path_and_cache_roundtrip(tmp_path):
    """time_candidates=True times on the probe's device (the CPU here); the
    written file reloads into the same policy and converts to the serving
    API's lowres dict. The timed winner depends on the host's speed, so
    only the conversion is held, as in the JAX package's test."""
    hazy = _smooth_probe(3, seed=4)
    cache = str(tmp_path / "resolution_policy.json")
    policy = PRA.tune_resolution_policy([_identity], hazy, hazy, np.zeros(3, np.int64),
                                        floor_db=0.0, batch=2, iters=1, time_candidates=True,
                                        cache_path=cache, device="cpu")
    loaded = PRA.load_policy(cache)
    assert loaded == json.loads(json.dumps(policy))
    assert {k: loaded[k] for k in ("backend", "device_kind", "torch")} == \
        {"backend": "cpu", "device_kind": "cpu", "torch": torch.__version__}
    assert "ms" in loaded["levels"]["low"]["table"]["full"]
    lowres = PRA.policy_to_lowres(loaded)
    if loaded["levels"]["low"]["choice"] == "full":
        assert "low" not in lowres
    else:
        assert lowres["low"]["mode"] == "guided" and lowres["low"]["scale"] == 2
        assert lowres["low"]["radius"] in (2, 4)
    assert lowres == JRA.policy_to_lowres(loaded)


def test_policy_to_lowres_shapes():
    policy = {"levels": {
        "low": {"choice": "full"},
        "medium": {"choice": "guided_r2_s2", "mode": "guided", "radius": 2, "scale": 2},
        "high": {"choice": "guided_r4_s2", "mode": "guided", "radius": 4, "scale": 2},
    }}
    lowres = PRA.policy_to_lowres(policy)
    assert set(lowres) == {"medium", "high"} and lowres["medium"]["radius"] == 2
    assert lowres == JRA.policy_to_lowres(policy)


@pytest.mark.parametrize("lowres", [
    (),
    ("high",),
    ["medium", "high"],
    {"medium": {"scale": 2}, "high": {"scale": 2, "mode": "bilinear", "radius": 8}},
])
def test_norm_lowres_forms(lowres):
    got = AdaptiveDehazer._norm_lowres(lowres)
    assert got == JaxDehazer._norm_lowres(lowres)
    if lowres == ("high",):
        assert got == {"high": {"scale": 2, "mode": "guided", "radius": 4}}


def test_load_policy_missing_and_corrupt(tmp_path):
    assert PRA.load_policy(str(tmp_path / "nope.json")) is None
    assert PRA.load_policy(None) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert PRA.load_policy(str(bad)) is None


def test_batched_psnr_pads_to_the_batch():
    """Probes served in fixed batches, the last one padded: every call
    sees `batch` rows, and the mean is JAX's."""
    hazy = _smooth_probe(5, seed=5)
    clear = np.clip(hazy + 0.05, 0, 1)
    rows = []

    def apply(x):
        rows.append(x.shape[0])
        return x

    got = PRA._batched_psnr(apply, hazy, clear, 2, torch.device("cpu"))
    assert rows == [2, 2, 2]
    want = JRA._batched_psnr(lambda x: x, hazy, clear, 2)
    assert abs(got - want) <= PSNR_DB


def test_shape_refusal_is_an_error_row_and_other_failures_raise():
    """A candidate that a kernel apply refuses by shape loses with an error
    row (as in JAX); a failure of any other kind propagates."""
    hazy = _smooth_probe(3, seed=6)

    def refuses_half_size(x):
        if x.shape[1] != SIZE:
            raise ValueError(f"does not take {x.shape[1]}x{x.shape[2]}")
        return x

    policy = PRA.tune_resolution_policy([refuses_half_size], hazy, hazy,
                                        np.zeros(3, np.int64), batch=2,
                                        time_candidates=False, device="cpu")
    entry = policy["levels"]["low"]
    assert entry["choice"] == "full"
    assert entry["table"]["guided_r4_s2"] == {"error": "ValueError: does not take 16x16"}

    def broken(x):
        if x.shape[1] != SIZE:
            raise RuntimeError("launch failed")
        return x

    with pytest.raises(RuntimeError, match="launch failed"):
        PRA.tune_resolution_policy([broken], hazy, hazy, np.zeros(3, np.int64), batch=2,
                                   time_candidates=False, device="cpu")


# --- the two tools, on a tiny experiment on the CPU ------------------------

@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A port experiment directory: config.yaml (32^2, low 4 x 1, medium 4,
    high 8, fp32, a corpus with val images) and a seeded joint checkpoint."""
    import yaml

    from adam_dehaze_tpu_torch.config import load_config, update_checkpoint_paths
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from adam_dehaze_tpu_torch.nn.blocks import init_params_
    from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus
    from adam_dehaze_tpu_torch.training import checkpoint as ckpt

    tmp = tmp_path_factory.mktemp("resolution_tool")
    root = str(tmp / "corpus")
    make_corpus(root, size=SIZE, train=1, val=2, test=1, seed=5)
    exp = str(tmp / "exp")
    cfg = load_config(overrides={
        "dataset": {"train_path": root, "val_path": root, "test_path": root,
                    "img_size": SIZE, "batch_size": 4, "num_workers": 1},
        "dehazing": {"low": {"channels": 4, "blocks": 1}, "medium": {"channels": 4},
                     "high": {"channels": 8}},
        "cuda": {"compute_dtype": "float32"}})
    cfg = update_checkpoint_paths(cfg, exp)
    router = init_params_(create_router(create_branch_models(cfg), create_classifier(cfg), cfg),
                          torch.Generator().manual_seed(0))
    ckpt.save_checkpoint(cfg["joint_training"]["checkpoint_dir"], "best_model",
                         {"step": 0, "model": router.state_dict()})
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.dump({k: v for k, v in cfg.items() if not k.startswith("_")}, f)
    return exp


def test_autotune_resolution_tool_writes_the_policy(experiment, tmp_path, capsys):
    """The tool probes the val split with oracle labels (2 images a level)
    through the tuned serving applies, writes <exp>/resolution_policy.json
    and the --out copy, and `lowres="auto"` then serves that policy."""
    from adam_dehaze_tpu_torch.tools import autotune_resolution

    out = str(tmp_path / "copy" / "policy.json")
    policy = autotune_resolution.main(["--experiment", experiment, "--batch", "2",
                                       "--device", "cpu", "--out", out])
    path = os.path.join(experiment, "resolution_policy.json")
    assert PRA.load_policy(path) == PRA.load_policy(out) == json.loads(json.dumps(policy))
    assert policy["probe_split"] == "val" and policy["timed"] and policy["backend"] == "cpu"
    for level, entry in policy["levels"].items():
        assert entry["n_probe"] == 2, level
        assert set(entry["table"]) == {"full", "guided_r4_s2", "guided_r2_s2"}
        assert all("error" not in row and "ms" in row for row in entry["table"].values())
    assert "probe (val): 6 images" in capsys.readouterr().out
    d = AdaptiveDehazer.from_experiment(experiment, device="cpu")
    x = np.random.default_rng(0).random((3, SIZE, SIZE, 3), dtype=np.float32)
    auto, _ = d.route_hard(x, lowres="auto")
    explicit, _ = d.route_hard(x, lowres=PRA.policy_to_lowres(policy))
    np.testing.assert_array_equal(auto, explicit)


def test_autotune_serving_tool_fills_the_experiment_cache(experiment):
    """The tool writes the experiment's serving_autotune.json, which
    from_experiment(autotune=True) then reads without timing."""
    from adam_dehaze_tpu_torch.tools import autotune_serving

    out = autotune_serving.main(["--experiment", experiment, "--batch", "16", "--size",
                                 str(SIZE), "--iters", "1", "--device", "cpu"])
    assert out["backend"] == "cpu" and out["experiment"] == experiment
    assert out["shape"] == [16, SIZE, SIZE, 3]
    # On the CPU the one candidate is `canonical` (no kernel runs there).
    assert all(out[lvl]["best"] == "canonical" for lvl in ("low", "medium", "high"))
    with open(os.path.join(experiment, "serving_autotune.json")) as f:
        assert len(json.load(f)) == 3
    d = AdaptiveDehazer.from_experiment(experiment, autotune=True, device="cpu")
    assert sorted(d.autotune_report) == ["high", "low", "medium"]
    assert all(r["cached"] for r in d.autotune_report.values())


def test_tools_stop_without_a_card(monkeypatch):
    from adam_dehaze_tpu_torch.tools import autotune_resolution, autotune_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (autotune_serving, autotune_resolution):
        with pytest.raises(SystemExit, match="no CUDA card"):
            tool.main(["--experiment", "nowhere"])
