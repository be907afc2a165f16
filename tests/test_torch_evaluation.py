"""`evaluate_object_detection` of the port against the JAX package's, on
the CPU, fp32: the same seeded soft router (tests/torch_port_util.py), the
same seeded detector (written as the port's best_model.pth and read back by
load_detection_model), the same tiny corpus with boxes (the port's corpus
tool, 32^2, two test images an intensity). Every stat of the hazy and the
dehazed side, overall and per intensity, within 1e-6: with the
per-intensity GT files, and with dummy annotations (no GT configured; the
router then read back through `_load_joint` from a joint checkpoint).
The score threshold is 0, so that a seeded detector keeps its candidates.
"""
import os
import types

import jax
import pytest

from adam_dehaze_tpu.evaluation import evaluate as JEV
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.models import detection as JD
from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu_torch.evaluation import evaluate as PEV
from adam_dehaze_tpu_torch.models import detection as PD
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from test_torch_detection import seeded_variables
from torch_port_util import images, jax_router_variables, joint_configs, port_of


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("det_eval")
    root = str(tmp / "corpus")
    make_corpus(root, size=32, train=0, val=0, test=2, seed=4)
    jcfg, pcfg = joint_configs("soft")
    for cfg, tag in ((jcfg, "jax"), (pcfg, "port")):
        cfg["dataset"].update(test_path=root)
        cfg["detection"].update(num_classes=3, score_threshold=0.0,
                                checkpoint_dir=str(tmp / tag / "detection"))
        cfg["joint_training"]["checkpoint_dir"] = str(tmp / tag / "joint")
        cfg["evaluation"]["results_dir"] = str(tmp / tag / "results")
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
    return root, jcfg, pcfg, jrouter, jstate, prouter, jdet


def _assert_results_equal(got, want):
    assert set(got) == set(want) == {"hazy", "dehazed"}
    for side in want:
        assert set(got[side]) == set(want[side])
        for cat, stats in want[side].items():
            assert set(got[side][cat]) == set(stats), (side, cat)
            for k, v in stats.items():
                assert got[side][cat][k] == pytest.approx(v, abs=1e-6), (side, cat, k)


def test_evaluate_object_detection_matches_jax_with_gt(setup, monkeypatch):
    root, jcfg, pcfg, jrouter, jstate, prouter, jdet = setup
    for cfg in (jcfg, pcfg):
        cfg["evaluation"]["annotation_paths"] = {
            lvl: os.path.join(root, "annotations", f"coco_{lvl}.json")
            for lvl in ("low", "medium", "high")}
    monkeypatch.setattr(JEV, "load_detection_model", lambda config: jdet)
    want = JEV.evaluate_object_detection(jcfg, jrouter, jstate)
    got = PEV.evaluate_object_detection(pcfg, prouter, device="cpu")
    assert set(want["hazy"]) == {"overall", "low_intensity", "medium_intensity",
                                 "high_intensity"}
    assert want["hazy"]["overall"]["mAP"] > 0 or want["dehazed"]["overall"]["mAP"] > 0
    _assert_results_equal(got, want)


def test_evaluate_object_detection_matches_jax_with_dummy_annotations(setup, monkeypatch):
    _, jcfg, pcfg, jrouter, jstate, prouter, jdet = setup
    for cfg in (jcfg, pcfg):
        cfg["evaluation"]["annotation_paths"] = {"low": "", "medium": "", "high": ""}
    ckpt.save_checkpoint(pcfg["joint_training"]["checkpoint_dir"], "best_model",
                         {"model": prouter.state_dict()})
    monkeypatch.setattr(JEV, "load_detection_model", lambda config: jdet)
    want = JEV.evaluate_object_detection(jcfg, jrouter, jstate)
    got = PEV.evaluate_object_detection(pcfg, device="cpu")
    _assert_results_equal(got, want)
    assert os.path.exists(os.path.join(pcfg["evaluation"]["results_dir"],
                                       "dummy_annotations.json"))


def test_load_joint_grafts_without_a_joint_checkpoint(setup, tmp_path):
    """No joint checkpoint: the router of build_router_state, in eval mode;
    a checkpoint of other sizes raises with the config hint."""
    _, _, pcfg, _, _, prouter, _ = setup
    cfg = {**pcfg, "joint_training": {**pcfg["joint_training"],
                                      "checkpoint_dir": str(tmp_path / "none")}}
    router = PEV._load_joint(cfg, device="cpu")
    assert not router.training
    other = {k: v for k, v in prouter.state_dict().items() if not k.startswith("models.high")}
    ckpt.save_checkpoint(str(tmp_path / "bad"), "best_model", {"model": other})
    cfg["joint_training"] = {**cfg["joint_training"], "checkpoint_dir": str(tmp_path / "bad")}
    with pytest.raises(ValueError, match="does not match"):
        PEV._load_joint(cfg, device="cpu")
