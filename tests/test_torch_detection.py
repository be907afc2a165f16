"""The port's detector (models/detection.py) against the JAX package's, on
the CPU: the port in fp32, the JAX reference in float64, on seeded weights
carried over by load_flax_variables:

- FCOSDetector in the native, p2 and torchvision_compat geometries (the
  resnet18 backbone, 32 and 64 channels) at 64^2 and 80^2: each level's
  logits, offsets and centerness within 1e-4 of the tensor's largest
  magnitude. At 80^2 C5 is 3x3 under a 5x5 C4, where
  nearest upsampling with half-pixel centres ("nearest-exact") and torch's
  "nearest" pick different source rows;
- `_device_topk` (the same candidate indices and labels, also on scores
  full of ties), `decode_detections`, `nms` and `DetectionModel.__call__`:
  the same kept boxes, labels and order, boxes within 1e-3 px, scores
  within 1e-5;
- `IntegratedDetectionSystem` behind a seeded soft router pair.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import detection as JD
from adam_dehaze_tpu_torch.models import detection as PD
from torch_port_util import images, port_of

GEOMETRIES = {
    # name: (JAX kwargs = port kwargs)
    "native": dict(num_classes=11, channels=32),
    "p2": dict(num_classes=11, channels=32, p2=True),
    # 64 channels: two a GroupNorm(32) group. At 32 a group is one channel,
    # and on the 1x1 P6/P7 maps of these sizes one value, whose
    # normalisation is 0 in exact arithmetic and rounding noise times 1e3
    # (1/sqrt(eps)) in torch's CPU kernel.
    "tv": dict(num_classes=11, channels=64, torchvision_compat=True),
}
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def pairs():
    """Per geometry: (the jitted apply of the JAX module computing in
    float64, its variables, the port module on the same weights). The
    reference runs in float64: flax's GroupNorm takes the variance as E[x^2] - E[x]^2, which in
    float32 loses most digits of a group whose values lie close (the tv
    geometry's P6/P7 groups at these sizes hold two values)."""
    out = {}
    for name, kw in GEOMETRIES.items():
        jm = JD.FCOSDetector(backbone_name="fcos_resnet18_fpn", **kw)
        vs = seeded_variables(jm, images((1, 64, 64, 3)), seed=3)
        jm64 = JD.FCOSDetector(backbone_name="fcos_resnet18_fpn", dtype=jnp.float64, **kw)
        out[name] = (jax.jit(jm64.apply), vs, port_of(PD.FCOSDetector(**kw), vs))
    return out


def seeded_variables(jm, x, seed):
    """flax variables of `jm` drawn with numpy from `seed` on the shapes of
    its init (jax.eval_shape: flax's own init compiles for seconds a
    detector on the CPU): kernels lecun-normal, biases and norm shifts
    small, scales near 1, BN statistics off 0/1."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.3, leaf.shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, dict(t)) for c, t in shapes.items()}


def jax_apply64(apply64, vs, x):
    """The level outputs (f32, as the JAX head returns them) on float64
    variables and inputs, as numpy."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), vs)
        outs = apply64(v64, jnp.asarray(x, jnp.float64))
        return [{k: (np.asarray(v) if k != "stride" else int(v)) for k, v in lv.items()}
                for lv in outs]


def jax_levels(pair, x):
    return jax_apply64(pair[0], pair[1], x)


@pytest.mark.parametrize("size", [64, 80])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_fcos_forward_matches_jax(pairs, geometry, size):
    x = images((2, size, size, 3), seed=size)
    want = jax_levels(pairs[geometry], x)
    with torch.no_grad():
        got = pairs[geometry][2](torch.from_numpy(x))
    assert [lv["stride"] for lv in got] == [lv["stride"] for lv in want]
    for g, w in zip(got, want):
        for key in ("logits", "offsets", "centerness"):
            assert tuple(g[key].shape) == w[key].shape, key
            assert rel_err(g[key].numpy(), w[key]) <= 1e-4, (key, g["stride"])


def test_nearest_exact_is_the_jax_upsampling():
    """The 3 -> 5 resize of the 80^2 pyramid: "nearest-exact" is JAX's
    nearest, plain "nearest" is not."""
    x = np.arange(9, dtype=np.float32).reshape(1, 3, 3, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 5, 5, 1), "nearest"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    exact = torch.nn.functional.interpolate(t, size=(5, 5), mode="nearest-exact")
    plain = torch.nn.functional.interpolate(t, size=(5, 5), mode="nearest")
    np.testing.assert_array_equal(exact.permute(0, 2, 3, 1).numpy(), want)
    assert not np.array_equal(plain.permute(0, 2, 3, 1).numpy(), want)


def test_group_norm_epsilon_is_flax():
    head = PD.FCOSHead(11, 32, tower_convs=4, group_norm=True, softplus=False)
    assert head.cls_gn0.eps == 1e-6 and head.reg_gn3.eps == 1e-6


def _to_torch(levels):
    return [{k: (torch.from_numpy(np.array(v)) if k != "stride" else v) for k, v in lv.items()}
            for lv in levels]


def _check_candidates(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"].numpy(), np.asarray(w["labels"]))
        np.testing.assert_allclose(g["scores"].numpy(), np.asarray(w["scores"]),
                                   rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(g["boxes"].numpy(), np.asarray(w["boxes"]),
                                   rtol=0, atol=BOX_ATOL)


@pytest.mark.parametrize("k", [5, 300])
def test_device_topk_matches_jax(pairs, k):
    levels = jax_levels(pairs["native"], images((2, 80, 80, 3), seed=5))
    want = jax.jit(JD._device_topk, static_argnums=1)(levels, k)
    _check_candidates(PD._device_topk(_to_torch(levels), k), want)


def test_device_topk_ties_take_the_lower_index_first():
    """Scores full of exact ties (logits on a coarse grid): the candidate
    order is lax.top_k's, lower location first among equals."""
    rng = np.random.default_rng(0)
    levels = [{"logits": (rng.integers(-2, 2, (2, 8, 8, 5)) * 2.0).astype(np.float32),
               "offsets": rng.random((2, 8, 8, 4), dtype=np.float32) * 16,
               "centerness": np.zeros((2, 8, 8, 1), np.float32), "stride": 8}]
    for k in (10, 64):
        want = JD._device_topk([{kk: (jnp.asarray(v) if kk != "stride" else v)
                                 for kk, v in levels[0].items()}], k)
        got = PD._device_topk(_to_torch(levels), k)
        # Indices equal: the boxes of tied locations differ.
        _check_candidates(got, want)


def test_decode_detections_and_nms_match_jax(pairs):
    levels = jax_levels(pairs["native"], images((2, 80, 80, 3), seed=7))
    for lv in levels:     # scores above 0.05 at many locations
        lv["logits"] = lv["logits"] + 3.0
    for size in (None, (80, 80)):
        want = JD.decode_detections(levels, score_threshold=0.05, image_size=size)
        got = PD.decode_detections(_to_torch(levels), score_threshold=0.05, image_size=size)
        assert sum(len(w["boxes"]) for w in want) > 20
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["labels"], w["labels"])
            np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=BOX_ATOL)
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=SCORE_ATOL)
    rng = np.random.default_rng(1)
    xy = rng.random((200, 2)) * 60
    boxes = np.concatenate([xy, xy + 5 + rng.random((200, 2)) * 20], 1).astype(np.float32)
    scores = rng.random(200).astype(np.float32)
    labels = rng.integers(1, 4, 200)
    for thr in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(PD.nms(boxes, scores, labels, thr),
                                      JD.nms(boxes, scores, labels, thr))


def jax_detection_model(pair, **kw):
    """The JAX DetectionModel over a pair's float64 forward."""
    apply64, vs, _ = pair
    jdet = JD.DetectionModel(**kw)
    jdet.variables = vs
    jdet._forward = lambda v, x: JD._device_topk(
        [{k: (jnp.asarray(a) if k != "stride" else a) for k, a in lv.items()}
         for lv in jax_apply64(apply64, v, x)], jdet.topk)
    return jdet


@pytest.mark.parametrize("geometry", ["native", "p2"])
def test_detection_model_call_matches_jax(pairs, geometry):
    """DetectionModel on the same weights: one host read, threshold, clip,
    NMS, at most 100. The threshold is low enough that seeded weights
    (class bias -4) keep candidates. (The tv geometry's boxes are held by
    the forward test at 1e-4 of the largest offset: at these sizes its
    P6/P7 GroupNorm groups hold two values, too few for 1e-3 px.)"""
    kw = dict(num_classes=11, score_threshold=0.004, topk=50)
    jdet = jax_detection_model(pairs[geometry], **kw)
    pdet = PD.DetectionModel(device="cpu", p2=geometry == "p2", **kw)
    pdet.module = pairs[geometry][2]
    x = images((2, 80, 80, 3), seed=80) * 4 - 2
    want = jdet(jnp.asarray(x))
    got = pdet(torch.from_numpy(x))
    assert sum(len(w["boxes"]) for w in want) > 10
    for g, w in zip(got, want):
        assert set(g) == {"boxes", "scores", "labels"}
        assert g["labels"].dtype == np.int64 and g["boxes"].dtype == np.float32
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=SCORE_ATOL)


def test_create_detection_model_names_and_init():
    from adam_dehaze_tpu_torch.config import load_config
    assert set(PD._BACKBONES) == set(JD._BACKBONES)
    cfg = load_config()
    det = PD.create_detection_model(cfg, device="cpu")
    assert det.dtype == torch.bfloat16 and det.num_classes == 91
    assert det.module.strides == (8, 16, 32)
    det.init(7, image_size=64)
    assert torch.all(det.module.head.cls_out.bias == -4.0)
    again = PD.create_detection_model(cfg, device="cpu")
    again.init(7)
    for a, b in zip(det.module.state_dict().values(), again.module.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        PD.DetectionModel(model_name="yolo", device="cpu")


def test_integrated_system_matches_jax(pairs):
    """Soft router (seeded, 32^2) -> ImageNet renormalisation -> detector,
    against the JAX system on the same weights."""
    from adam_dehaze_tpu.models import branches as JB
    from adam_dehaze_tpu.models import classifier as JC
    from adam_dehaze_tpu.models import routing as JR
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from torch_port_util import jax_router_variables, joint_configs

    jcfg, pcfg = joint_configs("soft")
    rvs = jax_router_variables("soft")
    jrouter = JR.create_router(JB.create_branch_models(jcfg), JC.create_classifier(jcfg), jcfg)
    prouter = port_of(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg),
                      rvs)
    kw = dict(num_classes=11, score_threshold=0.004, topk=50)
    jdet = jax_detection_model(pairs["native"], **kw)
    pdet = PD.DetectionModel(device="cpu", **kw)
    pdet.module = pairs["native"][2]
    jsys = JD.create_integrated_system(
        jax.jit(lambda x: jrouter.apply(rvs, x, train=False)), jdet)

    def dehaze(x):
        with torch.no_grad():
            return prouter(x)

    psys = PD.create_integrated_system(dehaze, pdet)
    x = images((2, 32, 32, 3), seed=4)
    want, want_dehazed = jsys(jnp.asarray(x))
    got, got_dehazed = psys(torch.from_numpy(x))
    np.testing.assert_allclose(got_dehazed.numpy(), np.asarray(want_dehazed), atol=1e-4)
    assert sum(len(w["boxes"]) for w in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=SCORE_ATOL)
