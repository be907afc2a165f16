"""The port's evaluation rows (evaluation/evaluate.py) against the JAX
package's, on the CPU, fp32: one seeded soft router carried over from
`jax_router_variables("soft")`, the same seeded detector, the same tiny
corpus with boxes (the port's corpus tool, 32^2, two test images an
intensity), the same LPIPS weights (drawn with numpy and given to both
sides' metric accumulators, reported as `lpips_uncal` as a seeded net is)
and the same quality head (drawn with numpy, cached in each experiment
dir). Each JAX section runs once for the
module, and JAX's run_comprehensive_evaluation assembles them; each port
function is held against its section:

- PSNR within 1e-3 dB, SSIM, LPIPS-uncal and fade_proxy within 1e-5,
  brisque_proxy within 1e-3 relative, nima_proxy within 1e-4 (the hazy and
  dehazed values, as the JAX package rounds them; the reduction_pct or
  delta column within what those bounds carry into it);
- routing_acc and the spilled fractions equal;
- run_comprehensive_evaluation: the same key tree, the same numbers under
  the same bounds.
"""
import copy
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adam_dehaze_tpu.evaluation import evaluate as JEV
from adam_dehaze_tpu.evaluation import metrics as JM
from adam_dehaze_tpu.evaluation import no_reference as JNR
from adam_dehaze_tpu.losses import lpips as JL
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.models import detection as JD
from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu_torch.evaluation import evaluate as PEV
from adam_dehaze_tpu_torch.evaluation import metrics as PM
from adam_dehaze_tpu_torch.evaluation import no_reference as PNR
from adam_dehaze_tpu_torch.losses.lpips import LPIPS
from adam_dehaze_tpu_torch.models import detection as PD
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from test_torch_detection import seeded_variables
from torch_port_util import (
    images,
    jax_router_variables,
    joint_configs,
    one_torch_thread,
    port_of,
)

# The port's ops run on one thread in this module (see one_torch_thread).
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# metric -> (bound, relative)
BOUNDS = {"psnr": (1e-3, False), "ssim": (1e-5, False), "lpips_uncal": (1e-5, False)}
PROXY_BOUNDS = {"fade_proxy": (1e-5, False), "brisque_proxy": (1e-3, True),
                "nima_proxy": (1e-4, False)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_rows")
    root = str(tmp / "corpus")
    make_corpus(root, size=32, train=2, val=0, test=2, seed=4)
    jcfg, pcfg = joint_configs("soft")
    for cfg, tag in ((jcfg, "jax"), (pcfg, "port")):
        exp = str(tmp / tag)
        cfg["dataset"].update(train_path=root, test_path=root)
        cfg["detection"].update(num_classes=3, score_threshold=0.0,
                                checkpoint_dir=os.path.join(exp, "detection"))
        cfg["joint_training"]["checkpoint_dir"] = os.path.join(exp, "joint")
        cfg["evaluation"].update(
            results_dir=os.path.join(exp, "results"),
            visualization_dir=os.path.join(exp, "vis"),
            annotation_paths={lvl: os.path.join(root, "annotations", f"coco_{lvl}.json")
                              for lvl in ("low", "medium", "high")})
        cfg["_exp_dir"] = exp
    rvs = jax_router_variables("soft")
    jrouter = JR.create_router(JB.create_branch_models(jcfg), JC.create_classifier(jcfg), jcfg)
    jstate = types.SimpleNamespace(params=rvs["params"], batch_stats=rvs["batch_stats"])
    prouter = port_of(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg),
                      rvs)

    jdet = JD.create_detection_model(jcfg)
    dvs = seeded_variables(jdet.module, images((1, 32, 32, 3)), seed=6)
    jdet.variables = dvs
    jdet._forward = jax.jit(lambda v, x: JD._device_topk(jdet.module.apply(v, x), jdet.topk))
    port_det = port_of(PD.create_detection_model(pcfg, device="cpu").module, dvs)
    ckpt.save_checkpoint(pcfg["detection"]["checkpoint_dir"], "best_model",
                         {"model": port_det.state_dict()})

    qparams = drawn_params(lambda k: JNR.QualityHead().init(k, jnp.zeros((1, 128, 128, 3))), 8)
    JNR.save_quality_head(os.path.join(jcfg["_exp_dir"], "quality_head.msgpack"), qparams)
    PNR.save_quality_head(os.path.join(pcfg["_exp_dir"], "quality_head.pth"),
                          port_of(PNR.QualityHead(), qparams))
    dummy = jnp.zeros((1, 32, 32, 3))
    lpips = drawn_params(lambda k: JL.LPIPS().init(k, dummy, dummy), 9)
    return dict(jcfg=jcfg, pcfg=pcfg, jrouter=jrouter, jstate=jstate, prouter=prouter,
                jdet=jdet, lpips=lpips)


def drawn_params(init, seed):
    """Variables on the shapes of `init` (jax.eval_shape: flax's init runs
    op by op for seconds), drawn with numpy: kernels lecun-normal, the rest
    uniform in [-0.1, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return {c: jax.tree_util.tree_map_with_path(draw, dict(t)) for c, t in shapes.items()}


class UncalMetrics(JM.ImageQualityMetrics):
    """JAX's ImageQualityMetrics on given LPIPS params, reported as
    `lpips_uncal` as the seeded net is, with one compiled metric program
    shared by every instance (the same params and shapes)."""
    lpips = None
    compiled = None

    def __init__(self, image_shape=None, lpips_weights=None):
        super().__init__(lpips_params=UncalMetrics.lpips)
        self.lpips_key = "lpips_uncal"
        if UncalMetrics.compiled is None:
            UncalMetrics.compiled = self._batch_metrics
        self._batch_metrics = UncalMetrics.compiled


SECTIONS = {"baseline": "evaluate_baseline_models", "joint": "evaluate_joint_model",
            "fixed": "evaluate_fixed_branch", "hard_routing": "evaluate_hard_routing",
            "detection": "evaluate_object_detection"}


@pytest.fixture(scope="module")
def want(setup):
    """JAX's rows on the setup: want(section) runs that section's function
    once, on first use; want() is JAX's run_comprehensive_evaluation over
    those sections."""
    functions = {fn: getattr(JEV, fn) for fn in SECTIONS.values()}
    cache = {}

    def patched(mp):
        mp.setattr(JEV, "load_detection_model", lambda config, image_size=None: setup["jdet"])
        mp.setattr(UncalMetrics, "lpips", setup["lpips"])
        mp.setattr(JEV, "ImageQualityMetrics", UncalMetrics)

    def section(fn):
        if fn not in cache:
            with pytest.MonkeyPatch.context() as mp:
                patched(mp)
                cache[fn] = functions[fn](setup["jcfg"], setup["jrouter"], setup["jstate"])
        return cache[fn]

    def rows(name=None):
        if name is not None:
            return section(SECTIONS[name])
        with pytest.MonkeyPatch.context() as mp:
            patched(mp)
            for fn in functions:
                mp.setattr(JEV, fn, lambda *args, fn=fn: section(fn))
            return JEV.run_comprehensive_evaluation(setup["jcfg"], setup["jrouter"],
                                                    setup["jstate"])
    return rows


@pytest.fixture
def port(setup, monkeypatch):
    """The port's config (a copy) and router, with the drawn LPIPS net in
    every metric accumulator."""
    def metrics(config, device):
        iq = PM.ImageQualityMetrics(lpips_net=port_of(LPIPS(), setup["lpips"]), device=device)
        iq.lpips_key = "lpips_uncal"
        return iq

    monkeypatch.setattr(PEV, "_quality_metrics", metrics)
    return copy.deepcopy(setup["pcfg"]), setup["prouter"]


def _close(got, want, bound, relative):
    scale = max(abs(want), 1.0) if relative else 1.0
    return abs(got - want) <= bound * scale * (1 + 1e-6)


def assert_proxy_matches(got, want, bound, relative, where):
    """A proxy row: hazy and dehazed within the bound; the derived column
    (reduction_pct, rounded to 0.01, or delta) within what the bound
    carries into it."""
    h, d = want["hazy"], want["dehazed"]
    for side in ("hazy", "dehazed"):
        assert _close(got[side], want[side], bound, relative), (where, side, got, want)
    eh, ed = (bound * abs(h), bound * abs(d)) if relative else (bound, bound)
    if "delta" in want:
        assert abs(got["delta"] - want["delta"]) <= (eh + ed) * (1 + 1e-6), (where, got, want)
    else:
        # 100 (h - d) / h moves by 100 (ed + eh |d / h|) / |h| at most.
        carried = 100.0 * (ed + eh * abs(d / h)) / abs(h) + 0.01
        assert abs(got["reduction_pct"] - want["reduction_pct"]) <= carried, (where, got, want)


def assert_rows_match(got, want, path=""):
    """Every number of `want` in `got` under BOUNDS / PROXY_BOUNDS (by the
    innermost metric or proxy name), equal otherwise; the same keys."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        where = f"{path}/{k}"
        if isinstance(w, dict):
            if k in PROXY_BOUNDS:
                assert set(g) == set(w), where
                assert_proxy_matches(g, w, *PROXY_BOUNDS[k], where)
            else:
                assert_rows_match(g, w, where)
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), where
        elif isinstance(w, (int, float)) and not isinstance(w, bool) and k in BOUNDS:
            assert _close(g, w, *BOUNDS[k]), (where, g, w)
        elif isinstance(w, (int, float)) and not isinstance(w, bool):
            assert g == pytest.approx(w, abs=1e-3), (where, g, w)
        else:
            assert g == w, where


def test_evaluate_baseline_models_matches_jax(want, port):
    cfg, router = port
    got = PEV.evaluate_baseline_models(cfg, router, device="cpu")
    assert set(got) == {"low_intensity", "medium_intensity", "high_intensity"}
    assert_rows_match(got, want("baseline"))
    assert os.path.exists(os.path.join(cfg["evaluation"]["results_dir"], "baseline_results.json"))


def test_evaluate_fixed_branch_matches_jax(want, port):
    cfg, router = port
    assert_rows_match(PEV.evaluate_fixed_branch(cfg, router, device="cpu"), want("fixed"))


def test_evaluate_hard_routing_matches_jax(want, port):
    cfg, router = port
    got = PEV.evaluate_hard_routing(cfg, router, device="cpu")
    for k in ("routing_acc", "spilled_frac", "spilled_frac_up", "spilled_frac_ordered"):
        assert got[k] == want("hard_routing")[k], k
    assert_rows_match(got, want("hard_routing"))


def test_evaluate_joint_model_matches_jax_without_an_experiment_dir(want, port):
    """No _exp_dir: no quality head, so no nima_proxy row; every other row
    is JAX's."""
    cfg, router = port
    del cfg["_exp_dir"]
    got = PEV.evaluate_joint_model(cfg, router, device="cpu")
    assert "nima_proxy" not in got and {"fade_proxy", "brisque_proxy"} <= set(got)
    assert_rows_match(got, {k: v for k, v in want("joint").items() if k != "nima_proxy"})
    for name in ("joint_comparison.png", "routing_weights.png"):
        assert os.path.exists(os.path.join(cfg["evaluation"]["visualization_dir"], name))


def test_evaluate_joint_model_matches_jax_with_the_cached_head(want, port):
    cfg, router = port
    got = PEV.evaluate_joint_model(cfg, router, device="cpu")
    assert "nima_proxy" in want("joint")
    assert_rows_match(got, want("joint"))


def test_run_comprehensive_evaluation_matches_jax(want, port):
    cfg, router = port
    got = PEV.run_comprehensive_evaluation(cfg, router, device="cpu")
    whole = want()
    assert list(got) == list(whole)
    assert whole["detection"]["hazy"]["mAP"] > 0 or whole["detection"]["dehazed"]["mAP"] > 0
    assert_rows_match(got, whole)
    with open(os.path.join(cfg["evaluation"]["results_dir"], "comprehensive_results.json")) as f:
        assert json.load(f).keys() == whole.keys()
