"""`training/checkpoint.py:load_torch_fcos` of the port against the JAX
package's, on the CPU: a synthetic state dict in torchvision's
fcos_resnet50_fpn layout (tests/test_converters.py's, in both key forms
torchvision has shipped: nested `.0` and flat) fills the port's
tv_fcos_resnet50_fpn detector, and the JAX package's load_torch_fcos fills
its FCOSDetector(torchvision_compat=True) from the same dict. Each level's
logits, offsets and centerness of the port in fp32 agree with the JAX
forward over the JAX loader's tree within 1e-4 of the tensor's largest
magnitude; the JAX reference computes in float64 (flax's GroupNorm takes
E[x^2] - E[x]^2, and the P6/P7 groups at 64^2 hold eight values), as
tests/test_torch_detection.py's does. A dict missing a key is refused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import detection as JD
from adam_dehaze_tpu.training.checkpoint import load_torch_fcos as jax_load_torch_fcos
from adam_dehaze_tpu_torch.models import detection as PD
from adam_dehaze_tpu_torch.training.checkpoint import load_torch_fcos
from test_converters import _tv_fcos_state_dict
from test_torch_detection import jax_apply64, rel_err
from torch_port_util import images
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(num_classes=91, backbone_name="tv_fcos_resnet50_fpn", channels=256,
          torchvision_compat=True)
SIZE = 64
RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_side():
    """(the jitted float64 apply, a template of the JAX detector's
    variables: zeros in the shapes of its init)."""
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: JD.FCOSDetector(**KW).init(k, x), jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    return jax.jit(JD.FCOSDetector(dtype=jnp.float64, **KW).apply), template


@pytest.mark.parametrize("nested", [True, False])
def test_load_torch_fcos_matches_jax(jax_side, nested):
    apply64, template = jax_side
    sd = _tv_fcos_state_dict(np.random.default_rng(0 if nested else 1), nested=nested)
    tree = jax_load_torch_fcos(sd, template)
    port = load_torch_fcos(sd, PD.FCOSDetector(**KW)).eval()
    np.testing.assert_array_equal(port.head.cls2.weight.detach().numpy(),
                                  sd["head.classification_head.conv.2.0.weight" if nested
                                     else "head.classification_head.conv.6.weight"])
    x = images((1, SIZE, SIZE, 3), seed=7)
    want = jax_apply64(apply64, tree, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [lv["stride"] for lv in got] == [lv["stride"] for lv in want] == [8, 16, 32, 64, 128]
    for g, w in zip(got, want):
        for k in ("logits", "offsets", "centerness"):
            assert rel_err(g[k].numpy(), w[k]) <= RTOL, (g["stride"], k)


def test_load_torch_fcos_refuses_a_missing_key():
    sd = _tv_fcos_state_dict(np.random.default_rng(2), nested=True)
    del sd["head.regression_head.bbox_ctrness.bias"]
    with pytest.raises(KeyError):
        load_torch_fcos(sd, PD.FCOSDetector(**KW))
