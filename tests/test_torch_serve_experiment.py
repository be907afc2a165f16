"""Serving an experiment directory in the port as the JAX package does, on
the CPU:

- export_jax_experiment.py turns a JAX experiment (an orbax joint checkpoint
  written here from seeded variables, no training) into the port's, and
  `AdaptiveDehazer.from_experiment` of both packages on the two directories
  give the same route_hard labels and outputs and the same soft outputs;
- the half-resolution dial of route_hard and route_hard_stream (a tuple of
  levels, a per-level dict, "auto" from resolution_policy.json, None for the
  construction default, () for full resolution) against the JAX package's
  on the same weights, with forced labels so that every branch serves; the
  cases of tests/test_serving.py:102-152 (lowres="auto" loud without a
  policy, low rows equal to the plain engine's, from_experiment(lowres=
  "auto") as the default and () overriding it); the engines' keys;
- a precompiled bundle of the port's experiment serves route_hard,
  route_hard_queued and route_device_binned bit for bit as without it, and
  route_hard as the JAX package's;
- the CLI's `serve --lowres`: JAX's SystemExit messages, and routing.json's
  `lowres` field, labels and images beside the JAX CLI's.

The widths are the joint trainer tests' (low 4 x 1, medium 4, high 8,
resnet18, 32^2, fp32). The classifier's BN statistics are reset to (0, 1)
and its last bias centred on a calibration batch so that route_hard sends
images to every branch (seeded random weights otherwise route everything to
one class); the smallest top-two logit margin of the served images is
checked to be far above fp32 rounding. fp32 against fp32 at ATOL 1e-4: at
32^2 the guided filter's float32 error is under 1e-5 in both packages
(tests/test_torch_resolution.py holds it against float64).
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import export_jax_experiment
from adam_dehaze_tpu import cli as JCLI
from adam_dehaze_tpu import config as JCFG
from adam_dehaze_tpu.serving import AdaptiveDehazer as JaxDehazer
from adam_dehaze_tpu_torch import cli as PCLI
from adam_dehaze_tpu_torch.data.dataset import _imread_rgb
from adam_dehaze_tpu_torch.data.preprocessing import _write_rgb
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables
from torch_port_util import ATOL, images, jax_router_variables, joint_configs
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 6
LABELS = np.arange(N) % 3
# The served batch of every test: the same shapes and labels, so that the
# JAX engines compile each bucket once.
X = images((N, 32, 32, 3), seed=21)
ALL = ("low", "medium", "high")
# Two dials that differ only in the high branch's radius.
POLICY_R4 = {"levels": {
    "low": {"choice": "full"},
    "medium": {"choice": "guided_r4_s2", "mode": "guided", "radius": 4, "scale": 2},
    "high": {"choice": "guided_r4_s2", "mode": "guided", "radius": 4, "scale": 2}}}
POLICY_R2 = {"levels": {**POLICY_R4["levels"],
                        "high": {"choice": "guided_r2_s2", "mode": "guided", "radius": 2,
                                 "scale": 2}}}


def _unit_bn_stats(tree):
    """Every flax BN's {"mean", "var"} in a batch_stats tree set to (0, 1)."""
    if "mean" in tree:
        return {"mean": np.zeros_like(tree["mean"]), "var": np.ones_like(tree["var"])}
    return {k: _unit_bn_stats(v) for k, v in tree.items()}


def routing_variables():
    """The joint tests' seeded router variables, the classifier's BN
    statistics at (0, 1) and its last bias centred on a calibration batch."""
    vs = jax_router_variables("soft")
    _, pcfg = joint_configs("soft")
    vs["batch_stats"]["classifier"] = _unit_bn_stats(vs["batch_stats"]["classifier"])
    head = {c: vs[c]["classifier"] for c in ("params", "batch_stats")}
    with torch.no_grad():
        logits, _ = load_flax_variables(create_classifier(pcfg), head).eval()(
            torch.from_numpy(images((12, 32, 32, 3), seed=20)))
    vs["params"]["classifier"]["Dense_1"]["bias"] = -logits.numpy().mean(0)
    return vs


def _write_jax_experiment(exp, variables):
    """A JAX experiment directory: config.yaml and an orbax joint
    checkpoint of the state the JAX `_load_joint` restores."""
    from adam_dehaze_tpu.training import checkpoint as jax_ckpt
    from adam_dehaze_tpu.training.common import state_to_tree
    from adam_dehaze_tpu.training.state import TrainState
    from adam_dehaze_tpu.training.train_joint import make_optimizer

    jcfg, _ = joint_configs("soft")
    for level in ALL:
        jcfg["dehazing"][level]["blocks"] = 1
    jcfg = JCFG.update_checkpoint_paths(jcfg, exp)
    tx = make_optimizer(jcfg["joint_training"]["learning_rate"])
    state = TrainState(step=jnp.asarray(7, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    jax_ckpt.save_checkpoint(jcfg["joint_training"]["checkpoint_dir"], "best_model",
                             state_to_tree(state), {"val_psnr": 21.5})
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.dump({k: v for k, v in jcfg.items() if not k.startswith("_")}, f)


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """(JAX experiment dir, the port's exported dir)."""
    tmp = tmp_path_factory.mktemp("serve_experiment")
    jax_exp, port_exp = str(tmp / "jax"), str(tmp / "port")
    _write_jax_experiment(jax_exp, routing_variables())
    export_jax_experiment.main(["--experiment", jax_exp, "--out", port_exp])
    return jax_exp, port_exp


@pytest.fixture(scope="module")
def pair(experiments):
    jax_exp, port_exp = experiments
    return (JaxDehazer.from_experiment(jax_exp),
            AdaptiveDehazer.from_experiment(port_exp, device="cpu"))


@pytest.fixture
def policy_files(experiments):
    """Writes a policy into both experiments; removed after the test."""
    paths = [os.path.join(exp, "resolution_policy.json") for exp in experiments]

    def write(policy):
        for path in paths:
            with open(path, "w") as f:
                json.dump(policy, f)

    yield write
    for path in paths:
        if os.path.exists(path):
            os.remove(path)


def _forced(engine, x, port):
    """The engine's output on forced labels cycling 0, 1, 2."""
    if port:
        with torch.inference_mode():
            return engine(torch.from_numpy(x), intensity=LABELS)[0].numpy()
    return np.asarray(engine(jnp.asarray(x), intensity=LABELS)[0])


def test_exporter_writes_the_ports_experiment(experiments):
    jax_exp, port_exp = experiments
    with open(os.path.join(port_exp, "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    with open(os.path.join(jax_exp, "config.yaml")) as f:
        jcfg = yaml.safe_load(f)
    assert "tpu" not in cfg and cfg["cuda"]["compute_dtype"] == jcfg["tpu"]["compute_dtype"]
    assert set(cfg) - {"cuda"} >= set(jcfg) - {"tpu"}
    for section in ("classifier", "dehazing", "routing", "dataset"):
        assert {k: v for k, v in cfg[section].items() if k != "checkpoint_dir"} == \
            {k: v for k, v in jcfg[section].items() if k != "checkpoint_dir"}, section
    joint = os.path.join(port_exp, "checkpoints", "joint")
    assert cfg["joint_training"]["checkpoint_dir"] == joint
    assert sorted(os.listdir(joint)) == ["best_model.metrics.json", "best_model.pth"]
    with open(os.path.join(joint, "best_model.metrics.json")) as f:
        assert json.load(f) == {"val_psnr": 21.5}
    assert torch.load(os.path.join(joint, "best_model.pth"))["step"] == 7


def test_from_experiment_matches_jax(pair):
    """route_hard (labels and outputs), the soft call and classify of the
    exported experiment against JAX's from_experiment on the orbax one."""
    jd, pd = pair
    want, want_i = jd.route_hard(X)
    got, got_i = pd.route_hard(X)
    with torch.inference_mode():
        logits = np.sort(pd.engine.logits(torch.from_numpy(X)).numpy(), axis=1)
    assert float((logits[:, -1] - logits[:, -2]).min()) > 1e-4
    assert len(set(want_i.tolist())) == 3, want_i
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(pd(X), jd(X), atol=ATOL)
    np.testing.assert_array_equal(pd.classify(X), want_i)


def test_route_hard_lowres_high_matches_jax(pair):
    jd, pd = pair
    want, want_i = jd.route_hard(X, lowres=("high",))
    got, got_i = pd.route_hard(X, lowres=("high",))
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_every_branch_at_half_resolution_matches_jax(pair):
    """All three branches dialled, on forced labels (every branch serves):
    the port follows JAX, and the dial moves each branch's rows."""
    jd, pd = pair
    dialled = _forced(pd._binned_engine(ALL), X, True)
    np.testing.assert_allclose(dialled, _forced(jd._binned_engine(ALL), X, False), atol=ATOL)
    plain = _forced(pd.engine, X, True)
    for cls in range(3):
        rows = LABELS == cls
        assert np.abs(dialled[rows] - plain[rows]).max() > 1e-3, cls


def test_serving_lowres_auto(pair, policy_files):
    """tests/test_serving.py:test_serving_lowres_auto on both packages:
    loud without a policy; with one, low stays the exact path (its rows
    equal the plain engine's within 1e-6), medium and high go through the
    guided lift, and the port follows JAX."""
    jd, pd = pair
    with pytest.raises(FileNotFoundError):
        pd.route_hard(X, lowres="auto")
    with pytest.raises(FileNotFoundError):
        jd.route_hard(X, lowres="auto")
    policy_files(POLICY_R4)
    out, intensity = pd.route_hard(X, lowres="auto")
    want, want_i = jd.route_hard(X, lowres="auto")
    np.testing.assert_array_equal(intensity, want_i)
    np.testing.assert_allclose(out, want, atol=ATOL)
    assert any(k.startswith("binned_lowres_") for k in pd._engines)
    base, i_base = pd.route_hard(X)
    np.testing.assert_array_equal(intensity, i_base)
    for cls in range(3):
        rows = intensity == cls
        assert rows.any(), cls
        if cls == 0:
            np.testing.assert_allclose(out[rows], base[rows], atol=1e-6)
        else:
            assert np.abs(out[rows] - base[rows]).max() > 1e-3, cls


def test_serving_default_lowres_policy(experiments, policy_files):
    """tests/test_serving.py:test_serving_default_lowres_policy:
    from_experiment(lowres="auto") makes the tuned policy the default dial
    of route_hard; an explicit () overrides it with the plain engine."""
    _, port_exp = experiments
    policy_files({"levels": {"low": {"choice": "full"}, "medium": {"choice": "full"},
                             "high": POLICY_R4["levels"]["high"]}})
    pd = AdaptiveDehazer.from_experiment(port_exp, lowres="auto", device="cpu")
    out, _ = pd.route_hard(X)
    assert list(pd._engines) == ["binned_lowres_high-2-guided-4"]
    out_full, _ = pd.route_hard(X, lowres=())
    assert "binned" in pd._engines
    plain = AdaptiveDehazer.from_experiment(port_exp, device="cpu")
    np.testing.assert_array_equal(out_full, plain.route_hard(X)[0])
    np.testing.assert_array_equal(out, plain.route_hard(X, lowres=("high",))[0])


def test_route_hard_stream_lowres_matches_jax(pair, policy_files):
    """route_hard_stream with a tuple of levels and with "auto" (the same
    dial here): each batch as route_hard gives it, and as JAX's stream
    gives it."""
    jd, pd = pair
    policy_files(POLICY_R4)
    batches = [X, X[::-1].copy()]
    for lowres in (("medium", "high"), "auto"):
        got = list(pd.route_hard_stream(batches, lowres=lowres))
        want = list(jd.route_hard_stream([jnp.asarray(b) for b in batches], lowres=lowres))
        assert len(got) == len(want) == 2
        for b, (y, i), (wy, wi) in zip(batches, got, want):
            np.testing.assert_array_equal(i, wi)
            np.testing.assert_allclose(y, wy, atol=ATOL)
            direct, di = pd.route_hard(b, lowres=lowres)
            np.testing.assert_array_equal(i, di)
            np.testing.assert_allclose(y, direct, atol=1e-6)


def test_engine_keys_hold_each_levels_dial(pair, policy_files):
    """Dials that differ in one level's radius get engines of their own,
    named as the JAX package names them."""
    jd, pd = pair
    outs = []
    for policy in (POLICY_R4, POLICY_R2):
        policy_files(policy)
        outs.append(_forced(pd._binned_engine(pd._resolve_lowres("auto")), X, True))
        jd._binned_engine(jd._resolve_lowres("auto"))
    assert np.abs(outs[0][LABELS == 2] - outs[1][LABELS == 2]).max() > 1e-4
    np.testing.assert_array_equal(outs[0][LABELS != 2], outs[1][LABELS != 2])
    keys = {k for k in pd._engines if k.startswith("binned_lowres_")}
    assert {"binned_lowres_high-2-guided-4_medium-2-guided-4",
            "binned_lowres_high-2-guided-2_medium-2-guided-4"} <= keys
    assert keys == {k for k in jd._engines if k.startswith("binned_lowres_")}


def test_lowres_auto_without_a_policy_path():
    """A dehazer built without `resolution_policy` refuses lowres="auto"
    with the JAX package's ValueError."""
    _, pcfg = joint_configs("soft")
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.routing import create_router
    d = AdaptiveDehazer(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg),
                        None, pcfg, device="cpu")
    with pytest.raises(ValueError, match="lowres='auto' needs an experiment-backed dehazer"):
        d.route_hard(images((2, 32, 32, 3)), lowres="auto")


def test_precompiled_bundle_serves_as_jax(pair, experiments, tmp_path):
    """A bundle exported from the port's experiment: from_experiment(
    precompiled=...) attaches it and serves route_hard, route_hard_queued
    and route_device_binned bit for bit as the unbundled dehazer, and
    route_hard as the JAX package's on the JAX experiment. "auto" attaches
    <exp>/precompiled only when it exists."""
    jd, pd = pair
    _, port_exp = experiments
    bundle = str(tmp_path / "precompiled")
    pd.export_precompiled(bundle, batch_sizes=(N,), queue_buckets=(3,), device_buckets=(N,),
                          device_chunk=2)
    d = AdaptiveDehazer.from_experiment(port_exp, precompiled=bundle, device="cpu")
    got, got_i = d.route_hard(X)
    want, want_i = pd.route_hard(X)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got, want)
    jwant, jwant_i = jd.route_hard(X)
    np.testing.assert_array_equal(got_i, jwant_i)
    np.testing.assert_allclose(got, jwant, atol=ATOL)
    for a, b in zip(d.route_device_binned(X, chunk=2), pd.route_device_binned(X, chunk=2)):
        np.testing.assert_array_equal(a, b)
    batches = [X[:3], X[3:]]
    for (a, ga, ca), (b, gb, cb) in zip(d.route_hard_queued(batches, queue_bucket=3),
                                        pd.route_hard_queued(batches, queue_bucket=3)):
        np.testing.assert_array_equal(ga, gb)
        assert ca == cb
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # The queued route classifies batches of 3, a shape not exported; the
    # steps and the binning miss nothing.
    assert d._dispatches["step0"].hits and d._dispatches["device2_0"].hits
    assert all(d._dispatches[n].misses == 0 for n in ("step0", "step1", "step2", "device2_0"))
    # "auto" without <exp>/precompiled serves unbundled; with it, attached.
    assert AdaptiveDehazer.from_experiment(port_exp, precompiled="auto",
                                           device="cpu")._bundle_table is None
    auto = os.path.join(port_exp, "precompiled")
    shutil.copytree(bundle, auto)
    try:
        assert AdaptiveDehazer.from_experiment(port_exp, precompiled="auto",
                                               device="cpu")._bundle_table
    finally:
        shutil.rmtree(auto)


def test_from_experiment_takes_a_config_path(experiments, tmp_path):
    """config_path in place of <exp>/config.yaml: a config whose widths do
    not match the checkpoint stops with _load_joint's message."""
    _, port_exp = experiments
    bad = tmp_path / "wide.yaml"
    bad.write_text(yaml.dump({"dehazing": {"high": {"channels": 16}}}))
    with pytest.raises(ValueError, match="does not match the models built from this config"):
        AdaptiveDehazer.from_experiment(port_exp, config_path=str(bad), device="cpu")


# --- the CLI's serve --lowres ----------------------------------------------

@pytest.fixture(scope="module")
def served_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_inputs")
    for i in range(4):
        _write_rgb(str(root / f"img{i}.png"), images((32, 32, 3), seed=30 + i))
    return str(root)


@pytest.mark.parametrize("argv, message", [
    (["--lowres", "high,bogus"], "serve: unknown --lowres levels ['bogus'] "
                                 "(choose from ['low', 'medium', 'high'] or 'auto')"),
    (["--lowres", "high", "--serve_mode", "queued"],
     "serve: --lowres applies to hard/spill/stream modes"),
])
def test_cli_lowres_stops_as_jax_does(experiments, served_inputs, tmp_path, argv, message):
    jax_exp, port_exp = experiments
    common = ["--mode", "serve", "--data_dir", served_inputs, "--device", "cpu"]
    with pytest.raises(SystemExit) as want:
        JCLI.main(common + ["--experiment_dir", jax_exp, "--out", str(tmp_path / "j")] + argv)
    with pytest.raises(SystemExit) as got:
        PCLI.main(common + ["--experiment_dir", port_exp, "--out", str(tmp_path / "p")] + argv)
    assert str(got.value) == str(want.value) == message


def test_cli_serve_lowres_auto_matches_jax(experiments, served_inputs, policy_files, tmp_path):
    """routing.json's `lowres` field and labels, and the images within one
    grey level, beside the JAX CLI's on the same weights."""
    jax_exp, port_exp = experiments
    policy_files(POLICY_R2)
    outs, manifests = {}, {}
    for side, main, exp in (("jax", JCLI.main, jax_exp), ("port", PCLI.main, port_exp)):
        outs[side] = str(tmp_path / side)
        main(["--mode", "serve", "--experiment_dir", exp, "--data_dir", served_inputs,
              "--lowres", "auto", "--out", outs[side], "--device", "cpu"])
        with open(os.path.join(outs[side], "routing.json")) as f:
            manifests[side] = json.load(f)
    assert manifests["port"] == manifests["jax"]
    assert manifests["port"]["lowres"] == "auto" and len(manifests["port"]["images"]) == 4
    for name in manifests["port"]["images"]:
        a = _imread_rgb(os.path.join(outs["port"], name))
        b = _imread_rgb(os.path.join(outs["jax"], name))
        assert np.abs(a - b).max() <= 1 / 255 + 1e-6, name


def test_cli_serve_stream_lowres_levels(experiments, served_inputs, tmp_path):
    """--serve_mode stream --lowres medium,high: routing.json lists the
    levels as the JAX CLI does, and the images are the route's."""
    _, port_exp = experiments
    out = str(tmp_path / "served")
    PCLI.main(["--mode", "serve", "--experiment_dir", port_exp, "--data_dir", served_inputs,
               "--serve_mode", "stream", "--lowres", "medium,high", "--out", out,
               "--device", "cpu"])
    with open(os.path.join(out, "routing.json")) as f:
        manifest = json.load(f)
    assert manifest["serve_mode"] == "stream" and manifest["lowres"] == ["medium", "high"]
    files = sorted(os.path.join(served_inputs, n) for n in os.listdir(served_inputs))
    d = AdaptiveDehazer.from_experiment(port_exp, device="cpu")
    bs = d.config["dataset"]["batch_size"]
    for i in range(0, len(files), bs):
        x = np.stack([_imread_rgb(f, 32) for f in files[i:i + bs]])
        want, labels = d.route_hard(x, lowres=("medium", "high"))
        for f, y, label in zip(files[i:i + bs], want, labels):
            name = os.path.basename(f)
            assert manifest["images"][name]["intensity"] == int(label)
            ref = str(tmp_path / "ref.png")
            _write_rgb(ref, y)
            assert np.abs(_imread_rgb(os.path.join(out, name)) - _imread_rgb(ref)).max() \
                <= 1 / 255 + 1e-6, name
