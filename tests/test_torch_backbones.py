"""The port's classifier backbones (MobileNetV2, MobileNetV3 small and
large, EfficientNet-B0..B3) and DenseFeatureExtractor against the JAX
package's, on the CPU, fp32:

- FogIntensityClassifier on mobilenet_v2, mobilenet_v3_small,
  mobilenet_v3_large and efficientnet_b0, eval mode, 64^2, batch 2, seeded
  flax variables carried over by load_flax_variables: logits and features
  at 1e-4 (EfficientNet's BN eps 1e-3 included);
- every new backbone by parameter count, feature dim and every tensor's
  shape through jax.eval_shape (no forward compile; B1-B3 only so);
- the reference layout: a seeded port backbone's state_dict (torchvision's
  keys, timm's for EfficientNet) through the JAX package's
  load_torch_mobilenet_v2, load_torch_mobilenet_v3 and
  load_torch_efficientnet gives the JAX backbone the port's features;
- DenseFeatureExtractor on resnet18 and resnet50;
- the factory EfficientNetB0 against the JAX package's, seeded flax
  variables carried over, at 1e-4;
- the classifier's compute dtype on a bf16 serving copy of a non-ResNet
  backbone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.nn.efficientnet import EfficientNet as JEfficientNet
from adam_dehaze_tpu.nn.mobilenet import MobileNetV2 as JMobileNetV2
from adam_dehaze_tpu.nn.mobilenet import MobileNetV3 as JMobileNetV3
from adam_dehaze_tpu.training import checkpoint as JCK
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.models.classifier import (
    DenseFeatureExtractor,
    FogIntensityClassifier,
    create_classifier,
)
from adam_dehaze_tpu_torch.nn import efficientnet as PE
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.serving_apply import make_classifier_serving_apply
from torch_port_util import (
    ATOL,
    images,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    port_of,
    seeded_variables,
    zeros_like_variables,
)

# The port's ops run on one thread in this module (see one_torch_thread).
pytestmark = pytest.mark.usefixtures("one_torch_thread")

NEW_BACKBONES = ["mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large",
                 *[f"efficientnet_b{i}" for i in range(4)]]
KEY = jax.random.PRNGKey(0)


def _classifier_init(jm, side=64):
    return lambda: jm.init({"params": KEY, "dropout": KEY}, jnp.zeros((1, side, side, 3)))


@pytest.mark.parametrize("name", NEW_BACKBONES[:4])
def test_classifier_matches_flax(name):
    jm = JC.FogIntensityClassifier(model_name=name, num_classes=3)
    vs = seeded_variables(_classifier_init(jm), seed=1)
    port = port_of(FogIntensityClassifier(name, 3), vs)
    x = images((2, 64, 64, 3), seed=2)
    want_l, want_f = jax.jit(lambda v, x: jm.apply(v, x))(vs, jnp.asarray(x))
    with torch.no_grad():
        got_l, got_f = port(torch.from_numpy(x))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL)


@pytest.mark.parametrize("name", NEW_BACKBONES)
def test_backbone_shapes_match_flax(name):
    """Parameter count, feature dim and each tensor's shape (load_flax_
    variables raises on a mismatch or a tensor left unset) against the JAX
    classifier's shapes, through the config's factory."""
    cfg = load_config()
    cfg["classifier"]["model"] = name
    port = create_classifier(cfg)
    jm = JC.FogIntensityClassifier(model_name=name, num_classes=3)
    zeros = zeros_like_variables(_classifier_init(jm, side=32))
    assert port.feature_dim == jm.feature_dim == port.backbone.feature_dim
    assert (sum(p.numel() for p in port.parameters())
            == sum(a.size for a in jax.tree_util.tree_leaves(zeros["params"])))
    port_of(port, zeros)


def test_backbone_tables_match_jax():
    from adam_dehaze_tpu.nn import efficientnet as JE
    from adam_dehaze_tpu.nn import mobilenet as JM
    from adam_dehaze_tpu_torch.nn import mobilenet as PM
    assert PE._B0_CONFIG == JE._B0_CONFIG and PE.SCALING == JE.SCALING
    assert (PM._V2_CONFIG, PM.V3_SMALL_CONFIG, PM.V3_LARGE_CONFIG) == (
        JM._V2_CONFIG, JM.V3_SMALL_CONFIG, JM.V3_LARGE_CONFIG)
    for v in PE.SCALING:
        for f in (16, 32, 40, 112, 320, 1280):
            assert PE.round_filters(f, PE.SCALING[v][0]) == JE.round_filters(f, JE.SCALING[v][0])
        assert PE.efficientnet_feature_dim(v) == JE.efficientnet_feature_dim(v)
    assert [PM._make_divisible(v) for v in range(1, 300, 7)] == [
        JM._make_divisible(v) for v in range(1, 300, 7)]


# name -> (the JAX backbone, the JAX converter of its torch state_dict).
REFERENCE = {
    "mobilenet_v2": (JMobileNetV2, JCK.load_torch_mobilenet_v2),
    "mobilenet_v3_small": (lambda: JMobileNetV3(variant="small"),
                           lambda sd, p, s: JCK.load_torch_mobilenet_v3(sd, p, s, "small")),
    "mobilenet_v3_large": (lambda: JMobileNetV3(variant="large"),
                           lambda sd, p, s: JCK.load_torch_mobilenet_v3(sd, p, s, "large")),
    "efficientnet_b0": (lambda: JEfficientNet(variant="b0"),
                        lambda sd, p, s: JCK.load_torch_efficientnet(sd, p, s, "b0")),
}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_reference_layout_through_jax_converter(name):
    make, convert = REFERENCE[name]
    gen = torch.Generator().manual_seed(3)
    backbone = init_params_(FogIntensityClassifier(name).backbone, gen).eval()
    with torch.no_grad():
        for m in backbone.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.8, 1.3, generator=gen)
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.uniform_(-0.1, 0.1, generator=gen)
    jm = make()
    zeros = zeros_like_variables(lambda: jm.init(KEY, jnp.zeros((1, 64, 64, 3))))
    sd = {k: v.numpy() for k, v in backbone.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = convert(sd, zeros["params"], zeros["batch_stats"])
    x = images((2, 64, 64, 3), seed=4)
    want = jax.jit(lambda v, x: jm.apply(v, x))({"params": params, "batch_stats": stats},
                                                jnp.asarray(x))
    with torch.no_grad():
        got = backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_dense_feature_extractor_matches_flax(name):
    jm = JC.DenseFeatureExtractor(model_name=name)
    vs = seeded_variables(lambda: jm.init(KEY, jnp.zeros((1, 64, 64, 3))), seed=5)
    port = port_of(DenseFeatureExtractor(name), vs)
    x = images((2, 64, 64, 3), seed=6)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(vs, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 2048 if name == "resnet50" else 512)
    np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError, match="feature extraction"):
        DenseFeatureExtractor("mobilenet_v2")


def test_efficientnet_b0_factory_matches_flax():
    """The factory's module carries a seeded JAX classifier's backbone
    (loaded as that classifier's backbone) and computes what the JAX
    factory's module does on the same subtree."""
    from adam_dehaze_tpu.nn.efficientnet import EfficientNetB0 as JEfficientNetB0
    jc = JC.FogIntensityClassifier(model_name="efficientnet_b0", num_classes=3)
    vs = seeded_variables(_classifier_init(jc), seed=8)
    port = FogIntensityClassifier("efficientnet_b0", 3)
    port.backbone = PE.EfficientNetB0()
    backbone = port_of(port, vs).backbone
    jm = JEfficientNetB0()
    sub = {c: vs[c]["EfficientNet_0"] for c in ("params", "batch_stats")}
    x = images((2, 64, 64, 3), seed=9)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(sub, jnp.asarray(x)))
    with torch.no_grad():
        got = backbone(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert backbone.variant == jm.variant == "b0"
    assert got.shape == want.shape == (2, backbone.feature_dim)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", ["mobilenet_v3_small", "efficientnet_b0"])
def test_serving_copy_computes_in_its_dtype(name):
    """A bf16 serving copy of a classifier without `backbone.conv1` runs in
    bf16 and returns float32 logits and features."""
    port = init_params_(FogIntensityClassifier(name), torch.Generator().manual_seed(7))
    fn = make_classifier_serving_apply(port, torch.bfloat16)
    with torch.inference_mode():
        logits, features = fn(torch.from_numpy(images((2, 32, 32, 3))))
        ref_logits, _ = port.eval()(torch.from_numpy(images((2, 32, 32, 3))))
    assert logits.dtype == features.dtype == torch.float32
    assert features.shape == (2, port.feature_dim)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), atol=0.1)
