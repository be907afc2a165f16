"""Precompiled serving bundles of the port (serving_export.py) on the CPU,
mirroring tests/test_serving_export.py: export and load, the dispatch's
hits and misses, the bound-module signature, the refusal of a bundle of
another runtime (a warning naming the field, then the same output as
without it) or of another quant mode or autotune setting, the manifest's
extra, a bundle-served dehazer bitwise equal to an unbundled one on every
bundle-backed route, the half-resolution engine left eager, a JAX bundle's
manifest refused, the kernel library's prebuilt path and the CLI's `export`
then `serve --precompiled auto`. On the CPU a loaded program is the eager
callable, so only the dispatch logic runs here: the CUDA graphs, their
output and their launch counts are tests/test_torch_cuda.py's and
chip_smoke.py's. tests/test_torch_serve_experiment.py holds a bundle-served
route_hard against the JAX package's.

The dehazer is the joint tests' widths (low 4 x 1, medium 4, high 8,
resnet18, 32^2, fp32) with seeded weights, the classifier's BN statistics
at (0, 1) and its last bias centred, so that the images reach every branch.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch import nn

from adam_dehaze_tpu_torch import cli as PCLI
from adam_dehaze_tpu_torch.cli import NOT_PORTED
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.serving_export import (
    MANIFEST,
    PINNED,
    PrecompiledDispatch,
    _bound_sig,
    bundle_compatible,
    export_program,
    load_bundle_programs,
    read_manifest,
    set_manifest_extra,
)
from adam_dehaze_tpu_torch.training.checkpoint import save_checkpoint
from torch_port_util import images
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 6
X = images((N, 32, 32, 3), seed=41)
LABELS = np.arange(N) % 3


def _conv(cin=3, cout=4):
    torch.manual_seed(cin * 10 + cout)
    return nn.Conv2d(cin, cout, 3, padding=1).eval()


def test_export_load_roundtrip(tmp_path):
    """A program exported with its bound module loads as {name: {sig:
    spec}} and dispatches to the same result."""
    m = _conv()
    x = torch.rand(2, 3, 8, 8)
    fname = export_program((m, x), "conv", str(tmp_path), n_bound=1)
    assert fname == "conv__float322x3x8x8"
    ok, reason = bundle_compatible(str(tmp_path))
    assert ok, reason
    table = load_bundle_programs(str(tmp_path), "cpu")
    (spec,) = table["conv"].values()
    assert spec.n_bound == 1 and spec.bound_sig == _bound_sig((m,))
    assert spec.args == (((2, 3, 8, 8), torch.float32),)
    d = PrecompiledDispatch(m, table["conv"], bind=(m,))
    with torch.no_grad():
        torch.testing.assert_close(d(x), m(x), rtol=0, atol=0)
    assert (d.hits, d.misses) == (1, 0)


def test_dispatch_hits_and_fallback(tmp_path):
    m = _conv()
    x4, x3 = torch.rand(4, 3, 8, 8), torch.rand(3, 3, 8, 8)
    export_program((m, x4), "conv", str(tmp_path), n_bound=1)
    d = PrecompiledDispatch(m, load_bundle_programs(str(tmp_path), "cpu")["conv"], bind=(m,))
    with torch.no_grad():
        d(x4)
        assert (d.hits, d.misses) == (1, 0)
        torch.testing.assert_close(d(x3), m(x3))
    assert (d.hits, d.misses) == (1, 1)


class _Folded(nn.Module):
    """Holds its weights as a tuple of tensors, as the kernels' folded
    weights are held."""

    def __init__(self, c):
        super().__init__()
        self.weights = (torch.ones(c, c), torch.zeros(c))


def test_bound_sig_mismatch_refused(tmp_path):
    """A program bound to a module of other shapes is dropped with a
    warning and the call runs the fallback. The signature reads tensors in
    plain attributes too."""
    m = _conv()
    x = torch.rand(2, 3, 8, 8)
    export_program((m, x), "conv", str(tmp_path), n_bound=1)
    programs = load_bundle_programs(str(tmp_path), "cpu")["conv"]
    other = _conv(3, 8)
    with pytest.warns(UserWarning, match="bound-module signature"):
        d = PrecompiledDispatch(other, programs, bind=(other,))
    assert not d._programs
    with torch.no_grad():
        assert d(x).shape == (2, 8, 8, 8) and (d.hits, d.misses) == (0, 1)
    assert _bound_sig((_Folded(4),)) != _bound_sig((_Folded(5),))
    assert _bound_sig((_Folded(4),)) == _bound_sig((_Folded(4),))


@pytest.mark.parametrize("field", PINNED)
def test_incompatible_bundle_refused(tmp_path, field):
    export_program((_conv(), torch.rand(2, 3, 8, 8)), "conv", str(tmp_path), n_bound=1)
    manifest = read_manifest(str(tmp_path))
    manifest["meta"][field] = "other"
    with open(tmp_path / MANIFEST, "w") as f:
        json.dump(manifest, f)
    ok, reason = bundle_compatible(str(tmp_path), "cpu")
    assert not ok and reason.startswith(f"{field}:")
    with pytest.raises(ValueError, match=field):
        load_bundle_programs(str(tmp_path), "cpu")


def test_manifest_extra(tmp_path):
    set_manifest_extra(str(tmp_path), quant=None, autotune=False)
    assert read_manifest(str(tmp_path))["extra"] == {"quant": None, "autotune": False}


def test_prebuilt_library_needs_its_source_hash(tmp_path, monkeypatch):
    """The bundle's kernel library is loaded only when it was built from
    this checkout's sources; then no build runs."""
    monkeypatch.setattr(_build, "_prebuilt", None)
    lib = tmp_path / _build.LIB_NAME
    with pytest.raises(ValueError, match="built from sources"):
        _build.use_prebuilt(lib, "0" * 16)
    monkeypatch.setattr(_build, "build", lambda: pytest.fail("a build ran"))
    _build.use_prebuilt(lib, _build._source_hash())
    assert _build.library_path() == lib


# --- a dehazer's bundle -----------------------------------------------------

def _config(**cuda):
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32", **cuda}})
    for level, (c, b) in {"low": (4, 1), "medium": (4, 2), "high": (8, 2)}.items():
        cfg["dehazing"][level].update(channels=c, blocks=b)
    cfg["dataset"].update(img_size=32, batch_size=N)
    return cfg


@pytest.fixture(scope="module")
def weights():
    """The seeded router's state dict, the classifier's BN statistics at
    (0, 1) and its last bias centred on X, so that route_hard reaches every
    branch."""
    cfg = _config()
    router = init_params_(create_router(create_branch_models(cfg), create_classifier(cfg), cfg),
                          torch.Generator().manual_seed(3))
    for m in router.classifier.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
    with torch.no_grad():
        head = router.classifier.classifier[4]
        head.bias -= router.classifier.eval()(torch.from_numpy(X))[0].mean(0)
    return router.state_dict()


def _dehazer(weights, cfg=None, **kw):
    cfg = cfg or _config()
    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    router.load_state_dict(weights)
    return AdaptiveDehazer(router, None, cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def bundle(weights, tmp_path_factory):
    """(the exporting dehazer, the bundle's directory): batch N, queue
    bucket 4, the device-binned engine at N with chunks of 2."""
    path = str(tmp_path_factory.mktemp("bundle") / "precompiled")
    d = _dehazer(weights)
    written = d.export_precompiled(path, batch_sizes=(N,), queue_buckets=(4,),
                                   device_buckets=(N,), device_chunk=2)
    # classify, logits, 3 x 6 bucket steps, 3 x 2 branch sizes, the binning
    assert len(written) == 2 + 18 + 6 + 1
    return d, path


def _routes(d):
    with torch.inference_mode():
        forced = d.engine(torch.from_numpy(X), intensity=LABELS)[0].numpy()
    queued = {}
    for out, gidx, cls in d.route_hard_queued([X, X[::-1].copy()], queue_bucket=4):
        for row, g in zip(out.numpy(), gidx):
            queued[int(g)] = (row, cls)
    return {"route_hard": d.route_hard(X), "spill": d.route_hard(X, spill=True),
            "forced": forced, "queued": queued,
            "device": d.route_device_binned(X, chunk=2),
            "device_stream": list(d.route_device_binned_stream([X[:4], X[4:]], chunk=2,
                                                               buckets=(N,)))}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_bundle_serves_identically(weights, bundle):
    """Every bundle-backed route of a bundle-served dehazer gives the
    unbundled dehazer's labels and outputs bit for bit; the exported
    programs hit and none misses where its shapes were exported."""
    ref, path = bundle
    d = _dehazer(weights, precompiled=path)
    want, got = _routes(ref), _routes(d)
    assert len(set(want["route_hard"][1].tolist())) == 3, want["route_hard"][1]
    _assert_same(got, want)
    engine = d.engine
    for name in ("classify", "logits", "step0", "step1", "step2", "branch0", "branch1",
                 "branch2", "device2_0"):
        p = d._dispatches[name]
        assert isinstance(p, PrecompiledDispatch) and p.hits > 0, name
    assert engine._classify is d._dispatches["classify"]
    assert engine._bucket_steps[2] is d._dispatches["step2"]
    assert d._engines["device_binned_2_False"].bin_program is d._dispatches["device2_0"]
    # One dispatcher for each branch serves run_queued and the device-binned
    # chunks; the steps, the classifier and the binning miss nothing (the
    # stream pads both its batches to N).
    assert d._engines["device_binned_2_False"].branch_applies[1] is engine.branch_applies[1]
    assert all(d._dispatches[n].misses == 0 for n in
               ("classify", "logits", "step0", "step1", "step2", "device2_0"))
    assert d._dispatches["device2_0"].hits == 3


@pytest.mark.parametrize("field, value", [("device_name", "NVIDIA H100 80GB HBM3"),
                                          ("source_hash", "0123456789abcdef"),
                                          ("torch_version", "0.0.0")])
def test_incompatible_bundle_serves_eagerly(weights, bundle, tmp_path, field, value):
    ref, path = bundle
    other = str(tmp_path / "other")
    shutil.copytree(path, other)
    manifest = read_manifest(other)
    manifest["meta"][field] = value
    with open(os.path.join(other, MANIFEST), "w") as f:
        json.dump(manifest, f)
    with pytest.warns(UserWarning, match=f"ignoring precompiled bundle .*{field}"):
        d = _dehazer(weights, precompiled=other)
    assert d._bundle_table is None
    _assert_same(d.route_hard(X), ref.route_hard(X))
    assert not d._dispatches and not isinstance(d.engine._classify, PrecompiledDispatch)


@pytest.mark.parametrize("extra, kwargs, needle", [
    ({"quant": "int8"}, {}, "quant"),
    ({}, {"autotune": True, "autotune_cache": None}, "autotune"),
])
def test_bundle_quant_and_autotune_mismatch_refused(weights, bundle, tmp_path, extra, kwargs,
                                                    needle):
    """A bundle exported under another quant mode or autotune setting never
    attaches; serving goes on eagerly."""
    _, path = bundle
    other = str(tmp_path / "other")
    shutil.copytree(path, other)
    set_manifest_extra(other, **extra)
    with pytest.warns(UserWarning, match=needle):
        d = _dehazer(weights, precompiled=other, **kwargs)
    assert d._bundle_table is None
    out, _ = d.route_hard(X)
    assert out.shape == X.shape


def test_lowres_engine_not_bundle_backed(weights, bundle):
    """The half-resolution engine computes other math behind the same input
    signatures: it never serves the bundle's programs."""
    _, path = bundle
    d = _dehazer(weights, precompiled=path)
    engine = d._binned_engine(("high",))
    assert not isinstance(engine._classify, PrecompiledDispatch)
    assert not any(isinstance(s, PrecompiledDispatch) for s in engine._bucket_steps)
    assert not any(isinstance(b, PrecompiledDispatch) for b in engine.branch_applies)
    assert isinstance(d.engine._classify, PrecompiledDispatch)


def test_jax_bundle_refused(weights, bundle, tmp_path):
    """A manifest the JAX package writes (no compile: its manifest writers
    alone) is refused by the port with a warning, and serving goes on."""
    from adam_dehaze_tpu import serving_export as jse
    ref, _ = bundle
    jdir = str(tmp_path / "jax_bundle")
    os.makedirs(jdir)
    jse._update_manifest(jdir, "classify__float326x32x32x3.jexec", "classify",
                         "float326x32x32x3")
    jse.set_manifest_extra(jdir, quant=None, autotune=False)
    ok, reason = bundle_compatible(jdir, "cpu")
    assert not ok and reason.startswith("format:")
    with pytest.warns(UserWarning, match="ignoring precompiled bundle .*format"):
        d = _dehazer(weights, precompiled=jdir)
    assert d._bundle_table is None
    _assert_same(d.route_hard(X), ref.route_hard(X))


def test_serving_quant_refused_and_carried_over(weights, tmp_path):
    """A config with cuda.serving_quant is refused (the port has no
    quantized serving), and export_jax_experiment carries the JAX config's
    tpu.serving_quant into it."""
    import export_jax_experiment
    with pytest.raises(NotImplementedError) as e:
        _dehazer(weights, cfg=_config(serving_quant="int8"))
    assert str(e.value) == NOT_PORTED["serving_quant"]
    jax_cfg = {"tpu": {"compute_dtype": "float32", "serving_quant": "int8"}}
    cfg = export_jax_experiment.port_config(jax_cfg, str(tmp_path))
    assert cfg["cuda"]["serving_quant"] == "int8" and cfg["cuda"]["compute_dtype"] == "float32"
    del jax_cfg["tpu"]["serving_quant"]
    assert not export_jax_experiment.port_config(jax_cfg, str(tmp_path))["cuda"].get(
        "serving_quant")


def _experiment(weights, root):
    """A port experiment directory: config.yaml and the joint checkpoint."""
    import yaml
    from adam_dehaze_tpu_torch.config import update_checkpoint_paths
    exp = str(root / "exp")
    cfg = update_checkpoint_paths(_config(), exp)
    save_checkpoint(cfg["joint_training"]["checkpoint_dir"], "best_model",
                    {"step": 1, "model": weights})
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.dump({k: v for k, v in cfg.items() if not k.startswith("_")}, f)
    return exp


def test_cli_export_then_serve_precompiled_auto(weights, tmp_path, monkeypatch):
    """`--mode export` writes <exp>/precompiled at the config's batch size;
    `serve --precompiled auto` then serves through it, with the same
    routing.json and images as a serve without it."""
    from adam_dehaze_tpu_torch.data.dataset import _imread_rgb
    from adam_dehaze_tpu_torch.data.preprocessing import _write_rgb
    exp = _experiment(weights, tmp_path)
    inputs = tmp_path / "inputs"
    for i in range(N):
        _write_rgb(str(inputs / f"img{i}.png"), X[i])
    PCLI.main(["--mode", "export", "--experiment_dir", exp, "--queue_bucket", "4",
               "--device", "cpu"])
    manifest = read_manifest(os.path.join(exp, "precompiled"))
    names = {p["name"] for p in manifest["programs"].values()}
    assert {"classify", "logits", "step0", "branch2", "device16_0"} <= names
    assert manifest["extra"] == {"quant": None, "autotune": False}
    attach = AdaptiveDehazer._attach
    served, attached = {}, []
    monkeypatch.setattr(AdaptiveDehazer, "_attach",
                        lambda self, engine: (attached.append(engine), attach(self, engine)))
    for tag, extra in (("eager", []), ("bundle", ["--precompiled", "auto"])):
        out = str(tmp_path / tag)
        PCLI.main(["--mode", "serve", "--experiment_dir", exp, "--data_dir", str(inputs),
                   "--out", out, "--device", "cpu"] + extra)
        with open(os.path.join(out, "routing.json")) as f:
            served[tag] = (json.load(f), out)
        assert len(attached) == (tag == "bundle")
    assert served["bundle"][0] == served["eager"][0]
    assert len(served["bundle"][0]["images"]) == N
    for name in served["eager"][0]["images"]:
        np.testing.assert_array_equal(_imread_rgb(os.path.join(served["bundle"][1], name)),
                                      _imread_rgb(os.path.join(served["eager"][1], name)))
