"""The port's readers of the upstream reference's checkpoints
(training/checkpoint.py: load_torch_joint, load_torch_branch,
load_torch_classifier, load_torch_gate, load_torch_resnet, load_torch_vgg16,
load_torch_alexnet, load_torch_lpips, load_torch_mobilenet_v2/v3,
load_torch_efficientnet) and its two tools (tools/convert_reference_
checkpoint.py, tools/graft_classifier.py) against the JAX package's, on the
CPU, fp32.

No reference weight file is in the repository: every state dict is
synthetic, in the reference's layout. A seeded port module's state_dict()
carries the reference's names (tests/test_torch_models.py), to which the
keys a reference file holds beyond them are added (torchvision's `fc` and
`classifier` heads, VGG16's convolutions past the deepest tap, the lpips
package's head names). Each dict goes through the JAX reader (into a flax
tree over a template of zeros) and through the port's reader (into a fresh
module):

- the module the port's reader fills equals the JAX tree carried into the
  port by `load_flax_variables`, tensor for tensor, on every classifier
  backbone, branch kind, the gate and the loss nets;
- the filled modules' forwards equal the JAX applies of the JAX trees
  within 1e-4 (ATOL): the classifier on MobileNetV2, MobileNetV3-small and
  EfficientNet-B0, VGG16's taps, LPIPS; the joint checkpoint through the
  conversion tool, `_load_joint` and `route_hard` against the JAX
  dehazer's `route_hard` on `load_torch_joint`'s tree;
- a missing key, a surplus key and a mis-shaped key raise, naming it;
- each `--kind` of the tool writes a checkpoint that the config key it is
  for reads back; `graft_classifier` swaps the classifier into the joint
  best and leaves the branches, the gate and the optimizer bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adam_dehaze_tpu.losses.lpips import LPIPS as JLPIPS
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu.nn.vgg import VGG16Features as JVGG16
from adam_dehaze_tpu.serving import AdaptiveDehazer as JDehazer
from adam_dehaze_tpu.training import checkpoint as JCK
from adam_dehaze_tpu_torch.config import load_config, update_checkpoint_paths
from adam_dehaze_tpu_torch.evaluation.evaluate import _load_joint
from adam_dehaze_tpu_torch.losses.dehazing import _load_frozen
from adam_dehaze_tpu_torch.losses.lpips import LPIPS
from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import FogIntensityClassifier, create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.nn.resnet import resnet18, resnet34, resnet50
from adam_dehaze_tpu_torch.nn.vgg import VGG16Features
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.tools import convert_reference_checkpoint, graft_classifier
from adam_dehaze_tpu_torch.training import checkpoint as PCK
from adam_dehaze_tpu_torch.training.common import state_to_tree
from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
from adam_dehaze_tpu_torch.training.train_classifier import init_classifier
from torch_port_util import (
    ATOL,
    images,
    joint_configs,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    port_of,
    zeros_like_variables,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEY = jax.random.PRNGKey(0)
BACKBONES = ["resnet18", "resnet34", "resnet50", "mobilenet_v2", "mobilenet_v3_small",
             "mobilenet_v3_large", *[f"efficientnet_b{i}" for i in range(4)]]
# The classifiers also held by their forward against the JAX apply.
FORWARD_BACKBONES = ("mobilenet_v2", "mobilenet_v3_small", "efficientnet_b0")
# (the JAX branch, the port's, their keyword arguments) of each kind.
BRANCHES = {
    "lightweight": (JB.LightweightDehazeModel, PB.LightweightDehazeModel,
                    dict(base_channels=8, n_blocks=2)),
    "low_unet": (JB.LowIntensityUNet, PB.LowIntensityUNet, dict(base_channels=8, n_blocks=3)),
    "medium": (JB.MediumIntensityDehazeModel, PB.MediumIntensityDehazeModel,
               dict(base_channels=8)),
    "corun": (JB.COrunInspiredModel, PB.COrunInspiredModel, dict(base_channels=8, n_blocks=2)),
    "high": (JB.HighIntensityDehazeModel, PB.HighIntensityDehazeModel, dict(base_channels=8)),
    "dual_branch": (JB.DualBranchAttentionModel, PB.DualBranchAttentionModel,
                    dict(base_channels=16)),
}


@torch.no_grad()
def randomized_(module, seed):
    """Every floating tensor of `module`'s state drawn from `seed`: weights
    of std 1/sqrt(fan-in), running variances in [0.5, 1.5], the rest of std
    0.1. Returns the module."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        if "running_var" in name:
            t.uniform_(0.5, 1.5, generator=gen)
        elif t.dim() >= 2:
            t.copy_(torch.randn(t.shape, generator=gen) / float(np.prod(t.shape[1:])) ** 0.5)
        else:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return module


def as_np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_same_state(got, want):
    got, want = got.state_dict(), want.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def _classifier_config(name):
    cfg = load_config()
    cfg["classifier"]["model"] = name
    return cfg


@pytest.mark.parametrize("name", BACKBONES)
def test_classifier_reader_matches_jax(name):
    """The reference classifier's dict on each backbone: the port's reader
    fills what the JAX reader's tree carried into the port holds; on
    FORWARD_BACKBONES the logits equal the JAX apply's within 1e-4."""
    sd = randomized_(create_classifier(_classifier_config(name)), 1).state_dict()
    got = PCK.load_torch_classifier(sd, create_classifier(_classifier_config(name))).eval()
    jm = JC.FogIntensityClassifier(model_name=name, num_classes=3)
    template = zeros_like_variables(
        lambda: jm.init({"params": KEY, "dropout": KEY}, jnp.zeros((1, 64, 64, 3))))
    params, stats = JCK.load_torch_classifier(as_np(sd), template["params"],
                                              template["batch_stats"], name)
    tree = {"params": params, "batch_stats": stats}
    assert_same_state(got, port_of(FogIntensityClassifier(name, 3), tree))
    if name in FORWARD_BACKBONES:
        x = images((2, 64, 64, 3), seed=2)
        want = jax.jit(lambda v, a: jm.apply(v, a)[0])(tree, jnp.asarray(x))
        with torch.no_grad():
            logits = got(torch.from_numpy(x))[0]
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", sorted(BRANCHES))
def test_branch_reader_matches_jax(kind):
    """Each reference branch kind: the port's reader fills what the JAX
    reader's tree carried into the port holds."""
    jcls, pcls, kw = BRANCHES[kind]
    sd = randomized_(pcls(**kw), 3).state_dict()
    got = PCK.load_torch_branch(sd, kind, pcls(**kw))
    jm = jcls(**kw)
    template = zeros_like_variables(lambda: jm.init(KEY, jnp.zeros((1, 32, 32, 3)), False))
    params, stats = JCK.load_torch_branch(as_np(sd), kind, template["params"],
                                          template["batch_stats"])
    assert_same_state(got, port_of(pcls(**kw), {"params": params, "batch_stats": stats}))


@pytest.mark.parametrize("level,model_type,kind", [
    ("low", "lightweight", "lightweight"), ("low", "unet", "low_unet"),
    ("medium", "standard", "medium"), ("medium", "corun", "corun"),
    ("high", "standard", "high"), ("high", "dual_branch", "dual_branch")])
def test_branch_kind_for(level, model_type, kind):
    assert PCK.branch_kind_for(level, model_type) == JCK.branch_kind_for(level, model_type) \
        == kind


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50"])
def test_resnet_reader_drops_the_torchvision_head(name):
    """A torchvision ResNet's dict (its `fc` head included): the port's
    reader fills the ResNet as the JAX reader fills its backbone tree."""
    make = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}[name]
    sd = dict(randomized_(make(), 4).state_dict())
    width = 2048 if name == "resnet50" else 512
    sd["fc.weight"], sd["fc.bias"] = torch.ones(1000, width), torch.zeros(1000)
    got = PCK.load_torch_resnet(sd, make())
    cfg = _classifier_config(name)
    jm = JC.FogIntensityClassifier(model_name=name, num_classes=3)
    template = zeros_like_variables(
        lambda: jm.init({"params": KEY, "dropout": KEY}, jnp.zeros((1, 64, 64, 3))))
    bb = next(k for k in template["params"] if k.startswith("ResNet"))
    params, stats = JCK.load_torch_resnet(
        as_np(sd), template["params"][bb], template["batch_stats"][bb],
        stage_sizes={"resnet18": (2, 2, 2, 2)}.get(name, (3, 4, 6, 3)),
        bottleneck=name == "resnet50")
    template["params"][bb], template["batch_stats"][bb] = params, stats
    want = port_of(create_classifier(cfg), template).backbone
    assert_same_state(got, want)


def test_gate_reader_matches_jax():
    """The gated router's `gate_network.{0,3,5}` from its router state
    dict (the rest of which is the classifier and the branches)."""
    jcfg, pcfg = joint_configs("gated")
    router = randomized_(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg),
                         5)
    fresh = create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg)
    got = PCK.load_torch_gate(router.state_dict(), fresh).gate_network
    params = {f"Dense_{i}": {"kernel": np.zeros(tuple(reversed(lin.weight.shape)), np.float32),
                             "bias": np.zeros(lin.bias.shape, np.float32)}
              for i, lin in enumerate(m for m in router.gate_network
                                      if isinstance(m, torch.nn.Linear))}
    filled = JCK.load_torch_gate(as_np(router.state_dict()), params)
    for i, lin in enumerate(m for m in got if isinstance(m, torch.nn.Linear)):
        np.testing.assert_array_equal(lin.weight.detach().numpy(), filled[f"Dense_{i}"]["kernel"].T)
        np.testing.assert_array_equal(lin.bias.detach().numpy(), filled[f"Dense_{i}"]["bias"])


@pytest.fixture(scope="module")
def vgg_pair():
    """A torchvision VGG16 dict (features.0-28 and the classifier head) and
    the JAX VGG16Features' template."""
    net = randomized_(VGG16Features(), 6)
    sd = dict(net.state_dict())
    widths = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 17: 512, 19: 512,
              21: 512, 24: 512, 26: 512, 28: 512}
    prev = 3
    for idx, w in widths.items():
        if f"features.{idx}.weight" not in sd:
            sd[f"features.{idx}.weight"] = torch.zeros(w, prev, 3, 3)
            sd[f"features.{idx}.bias"] = torch.zeros(w)
        prev = w
    sd["classifier.0.weight"], sd["classifier.0.bias"] = torch.zeros(4096, 25088), torch.zeros(4096)
    jm = JVGG16()
    return sd, jm, zeros_like_variables(lambda: jm.init(KEY, jnp.zeros((1, 32, 32, 3))))


def test_vgg16_reader_matches_jax(vgg_pair):
    """VGG16's taps from the torchvision dict: equal tensors, and every tap
    of the forward within 1e-4 of the JAX apply's."""
    sd, jm, template = vgg_pair
    got = PCK.load_torch_vgg16(sd, VGG16Features()).eval()
    tree = JCK.load_torch_vgg16(as_np(sd), template)
    assert_same_state(got, port_of(VGG16Features(), tree))
    x = images((1, 32, 32, 3), seed=7)
    want = jax.jit(jm.apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        feats = got(torch.from_numpy(x))
    for tap, w in want.items():
        np.testing.assert_allclose(feats[tap].numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL * max(1.0, float(np.abs(w).max())), err_msg=tap)


@pytest.fixture(scope="module")
def lpips_pair():
    """The JAX LPIPS, its template, and an AlexNet trunk dict in
    torchvision's layout (features and classifier) and the lpips package's
    head dicts in both names."""
    net = randomized_(LPIPS(), 8)
    trunk = {k[len("net."):]: v for k, v in net.state_dict().items() if k.startswith("net.")}
    trunk["classifier.1.weight"], trunk["classifier.1.bias"] = torch.zeros(4096, 9216), \
        torch.zeros(4096)
    heads = {form: {(f"lin{i}.model.1.weight" if form == "lin" else f"lins.{i}.model.1.weight"):
                    getattr(net, f"lin{i}").detach().reshape(1, -1, 1, 1).clone()
                    for i in range(5)} for form in ("lin", "lins")}
    jm = JLPIPS()
    z = jnp.zeros((1, 32, 32, 3))
    return jm, zeros_like_variables(lambda: jm.init(KEY, z, z)), trunk, heads


@pytest.mark.parametrize("form", ["lin", "lins"])
def test_lpips_and_alexnet_readers_match_jax(lpips_pair, form):
    """The AlexNet trunk (load_torch_alexnet) then the heads
    (load_torch_lpips) into LPIPS: equal tensors, and the LPIPS distance
    within 1e-4 of the JAX apply's over the JAX readers' tree."""
    jm, template, trunk, heads = lpips_pair
    got = PCK.load_torch_lpips(heads[form], PCK.load_torch_alexnet(trunk, LPIPS())).eval()
    tree = JCK.load_torch_lpips(as_np(heads[form]), JCK.load_torch_alexnet(as_np(trunk), template))
    assert_same_state(got, port_of(LPIPS(), tree))
    a, b = images((2, 32, 32, 3), seed=9) * 2 - 1, images((2, 32, 32, 3), seed=10) * 2 - 1
    want = jax.jit(jm.apply)(tree, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        dist = got(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(dist.numpy().reshape(-1), np.asarray(want).reshape(-1), rtol=0,
                               atol=ATOL)


def _branch_dict():
    return dict(randomized_(PB.MediumIntensityDehazeModel(8), 11).state_dict())


@pytest.mark.parametrize("fault", ["missing", "surplus", "shape"])
@pytest.mark.parametrize("what", ["branch", "classifier"])
def test_readers_refuse_a_missing_surplus_or_misshaped_key(fault, what):
    """Each fault raises ValueError naming the key."""
    if what == "branch":
        sd = _branch_dict()
        key = "encoder.1.1.conv2.block.0.weight"
        read = lambda d: PCK.load_torch_branch(d, "medium", PB.MediumIntensityDehazeModel(8))  # noqa: E731
    else:
        sd = dict(create_classifier(_classifier_config("resnet18")).state_dict())
        key = "backbone.layer2.0.bn1.running_mean"
        read = lambda d: PCK.load_torch_classifier(  # noqa: E731
            d, create_classifier(_classifier_config("resnet18")))
    if fault == "missing":
        del sd[key]
    elif fault == "surplus":
        key = key.replace("weight", "extra").replace("running_mean", "extra")
        sd[key] = torch.zeros(1)
    else:
        sd[key] = torch.zeros(3)
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        read(sd)


def _five_states(router):
    """The reference joint checkpoint of a port router."""
    sd = router.state_dict()

    def under(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    return {"router_state_dict": sd, "classifier_state_dict": under("classifier."),
            "optimizer_state_dict": {"state": {}, "param_groups": []}, "epoch": 3,
            **{f"{lvl}_model_state_dict": under(f"models.{lvl}.")
               for lvl in ("low", "medium", "high")}}


@pytest.fixture(scope="module")
def joint_pair(tmp_path_factory):
    """A seeded gated router's five-state .pth, converted by the tool into an
    experiment's joint best, and the JAX package's load_torch_joint tree of
    the same dict."""
    tmp = tmp_path_factory.mktemp("reference")
    jcfg, pcfg = joint_configs("gated")
    router = randomized_(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg),
                         12)
    with torch.no_grad():           # the classifier's statistics at (0, 1): every class served
        for m in router.classifier.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    ckpt = _five_states(router)
    pth = tmp / "joint.pth"
    torch.save(ckpt, pth)
    exp = tmp / "exp"
    os.makedirs(exp)
    with open(exp / "config.yaml", "w") as f:
        yaml.safe_dump(pcfg, f)
    cfg = update_checkpoint_paths(pcfg, str(exp))
    convert_reference_checkpoint.main(
        ["--kind", "joint", "--pth", str(pth), "--config", str(exp / "config.yaml"),
         "--out", os.path.join(cfg["joint_training"]["checkpoint_dir"], "best_model")])
    jr = JR.create_router(JB.create_branch_models(jcfg), JC.create_classifier(jcfg), jcfg)
    template = zeros_like_variables(
        lambda: jr.init({"params": KEY, "dropout": KEY}, jnp.zeros((1, 32, 32, 3))))
    tree = JCK.load_torch_joint(
        {k: (as_np(v) if k.endswith("_state_dict") and k != "optimizer_state_dict" else v)
         for k, v in ckpt.items()}, template, jcfg)
    return router, exp, cfg, (jr, tree, jcfg)


def test_converted_joint_serves_as_jax_route_hard(joint_pair):
    """The converted joint best through `_load_joint` and route_hard (fp32,
    the CPU) against the JAX dehazer's route_hard on load_torch_joint's tree
    of the same .pth: labels equal, outputs within 1e-4; the router the
    tool wrote is the reference's tensor for tensor."""
    router, _, cfg, (jr, tree, jcfg) = joint_pair
    served = _load_joint(cfg, device="cpu")
    assert_same_state(served, router)
    x = images((6, 32, 32, 3), seed=13)
    got, labels = AdaptiveDehazer(served, None, cfg, device="cpu").route_hard(x)
    state = type("State", (), {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    want, want_labels = JDehazer(jr, state, jcfg).route_hard(jnp.asarray(x))
    np.testing.assert_array_equal(labels, np.asarray(want_labels))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_graft_classifier_swaps_only_the_classifier(joint_pair):
    """A joint best with its Adam state (the classifier frozen, out of the
    optimizer) and a retrained classifier's best: the grafted joint best
    holds the new classifier and, bit for bit, the old branches, gate,
    step and optimizer."""
    router, exp, cfg, _ = joint_pair
    joint_dir = cfg["joint_training"]["checkpoint_dir"]
    router.classifier.requires_grad_(False)
    state = TrainState(router, make_optimizer([p for p in router.parameters()
                                               if p.requires_grad], 1e-3))
    before = state_to_tree(state)
    PCK.save_checkpoint(joint_dir, "best_model", before)
    new = randomized_(create_classifier(cfg), 14)
    PCK.save_checkpoint(cfg["classifier"]["checkpoint_dir"], "best_model",
                        {"model": new.state_dict()}, {"val_acc": 0.5})
    graft_classifier.main(["--experiment", str(exp)])
    after, metrics = PCK.load_checkpoint(PCK.best_model_path(joint_dir))
    assert metrics == {"grafted_classifier": 1.0}
    assert after["step"] == before["step"] and after["optimizer"] == before["optimizer"]
    for k, v in before["model"].items():
        want = new.state_dict()[k[len("classifier."):]] if k.startswith("classifier.") else v
        assert torch.equal(after["model"][k], want), k


def test_converted_kinds_are_read_by_their_config_keys(tmp_path):
    """classifier (classifier.pretrained), resnet18 (a backbone for it),
    vgg16 (loss.vgg_weights), lpips (loss.lpips_weights) and branch (the
    dehazing trainer's best model): each converted file, read back the way
    its config key reads it, gives the reference's tensors."""
    cfg = load_config(overrides={"classifier": {"model": "resnet18"}})
    cfg["dehazing"]["medium"]["channels"] = 8
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    def converted(kind, module, *extra):
        pth = tmp_path / f"{kind}.pth"
        torch.save({"model_state_dict": module.state_dict()}, pth)
        return convert_reference_checkpoint.main(
            ["--kind", kind, "--pth", str(pth), "--out", str(tmp_path / "out" / kind),
             "--config", str(path), *extra])

    clf = randomized_(create_classifier(cfg), 15)
    cfg["classifier"]["pretrained"] = converted("classifier", clf)
    assert_same_state(init_classifier(cfg, "cpu"), clf)
    cfg["classifier"]["pretrained"] = converted("resnet18", clf.backbone)
    assert_same_state(init_classifier(cfg, "cpu").backbone, clf.backbone)
    vgg = randomized_(VGG16Features(), 16)
    filled = VGG16Features()
    _load_frozen(filled, converted("vgg16", vgg))
    assert_same_state(filled, vgg)
    lp = randomized_(LPIPS(), 17)
    pth = tmp_path / "heads.pth"
    torch.save({f"lin{i}.model.1.weight": getattr(lp, f"lin{i}").detach().reshape(1, -1, 1, 1)
                for i in range(5)}, pth)
    out = convert_reference_checkpoint.main(["--kind", "lpips", "--pth", str(pth), "--out",
                                             str(tmp_path / "out" / "lpips")])
    filled = LPIPS()
    _load_frozen(filled, out)
    for i in range(5):
        assert torch.equal(getattr(filled, f"lin{i}"), getattr(lp, f"lin{i}"))
    medium = randomized_(create_branch_models(cfg)["medium"], 18)
    best = PCK.load_checkpoint(converted("branch", medium, "--level", "medium"))[0]["model"]
    assert all(torch.equal(best[k], v) for k, v in medium.state_dict().items())
