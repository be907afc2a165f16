"""The port's branches and classifier against the flax models, eval mode,
fp32, small widths, the same seeded inputs and weights (ATOL 1e-4, fp32 vs
fp32 after tens of layers of reordered sums). Also: parameter counts at the
default widths (golden values of tests/test_branches.py, which cost no
forward pass), the serving applies, and the weight round trip
flax -> port -> state_dict() -> the JAX package's load_torch_joint -> flax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models.classifier import FogIntensityClassifier as JClf
from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.models.classifier import FogIntensityClassifier
from adam_dehaze_tpu_torch.ops.serving_apply import (
    make_classifier_serving_apply,
    make_serving_apply,
)
from torch_port_util import ATOL, images, init_flax, port_of

BRANCHES = {
    "low": (lambda: JB.LightweightDehazeModel(8, 2, dtype=jnp.float32),
            lambda: PB.LightweightDehazeModel(8, 2)),
    "low_c4": (lambda: JB.LightweightDehazeModel(4, 1, dtype=jnp.float32),
               lambda: PB.LightweightDehazeModel(4, 1)),
    "medium": (lambda: JB.MediumIntensityDehazeModel(8, dtype=jnp.float32),
               lambda: PB.MediumIntensityDehazeModel(8)),
    "high": (lambda: JB.HighIntensityDehazeModel(16, dtype=jnp.float32),
             lambda: PB.HighIntensityDehazeModel(16)),
}


def _branch_pair(name, seed=0):
    jm, pm = BRANCHES[name][0](), BRANCHES[name][1]()
    vs = init_flax(jm, images((1, 32, 32, 3)), seed=seed)
    return jm, vs, port_of(pm, vs)


@pytest.mark.parametrize("name", sorted(BRANCHES))
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 24, 40, 3), (1, 30, 30, 3)],
                         ids=["32x32", "24x40", "30x30_resize"])
def test_branch_matches_flax(name, shape):
    """30x30 makes the decoder's upsampled maps miss the skips' sizes, so
    the medium and high branches go through resize_bilinear."""
    jm, vs, port = _branch_pair(name)
    x = images(shape, seed=2)
    want = np.asarray(jm.apply(vs, jnp.asarray(x), False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_serving_apply_matches_flax(name):
    """make_serving_apply in fp32 on the CPU: K1's plain version for the
    low branch where the width allows it (c=8), the canonical forward
    otherwise (c=4, medium, high)."""
    jm, vs, port = _branch_pair(name, seed=3)
    x = images((3, 32, 32, 3), seed=4)
    want = np.asarray(jm.apply(vs, jnp.asarray(x), False))
    fn = make_serving_apply(port, torch.float32)
    with torch.inference_mode():
        got = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_serving_copy_casts_convs_and_leaves_the_model():
    _, _, port = _branch_pair("high")
    fn = make_serving_apply(port, torch.bfloat16)
    assert fn.init_conv.block[0].weight.dtype == torch.bfloat16
    assert fn.init_conv.block[1].weight.dtype == torch.float32
    assert port.init_conv.block[0].weight.dtype == torch.float32
    with torch.inference_mode():
        y = fn(torch.from_numpy(images((1, 16, 16, 3))))
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("model_name", ["resnet18", "resnet34", "resnet50"])
def test_classifier_matches_flax(model_name):
    jm = JClf(model_name=model_name, num_classes=3, dtype=jnp.float32)
    x = images((2, 32, 32, 3), seed=5)
    vs = jm.init({"params": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x))
    vs = jax.tree_util.tree_map(np.asarray, dict(vs))
    port = port_of(FogIntensityClassifier(model_name, 3), vs)
    want_l, want_f = jm.apply(vs, jnp.asarray(x))
    with torch.no_grad():
        got_l, got_f = port(torch.from_numpy(x))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL)
    fn = make_classifier_serving_apply(port, torch.float32)
    with torch.inference_mode():
        np.testing.assert_allclose(fn(torch.from_numpy(x))[0].numpy(),
                                   np.asarray(want_l), atol=ATOL)


@pytest.mark.parametrize("name,make,count", [
    ("lightweight", lambda: PB.LightweightDehazeModel(32, 3), 66_756),
    ("medium", lambda: PB.MediumIntensityDehazeModel(64, 6), 7_228_835),
    ("high", lambda: PB.HighIntensityDehazeModel(96, 9), 16_320_576),
])
def test_default_width_param_counts(name, make, count):
    assert sum(p.numel() for p in make().parameters()) == count


def _small_config():
    from adam_dehaze_tpu.config import default_config
    cfg = default_config()
    for level, ch, blocks in (("low", 8, 2), ("medium", 8, 6), ("high", 16, 9)):
        cfg["dehazing"][level].update(channels=ch, blocks=blocks)
    cfg["dataset"]["img_size"] = 32
    cfg["tpu"].update(compute_dtype="float32", use_pallas=False)
    return cfg


def test_router_weight_round_trip_through_jax_converter():
    """flax -> port -> port.state_dict() -> load_torch_joint -> flax is the
    identity: the port's key names are the upstream reference's."""
    from adam_dehaze_tpu.models.branches import create_branch_models
    from adam_dehaze_tpu.models.classifier import create_classifier
    from adam_dehaze_tpu.models.routing import create_router
    from adam_dehaze_tpu.training.checkpoint import load_torch_joint
    from adam_dehaze_tpu_torch.models import routing as PR
    from adam_dehaze_tpu_torch.models.classifier import create_classifier as pclf

    cfg = _small_config()
    jr = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    x = jnp.asarray(images((1, 32, 32, 3)))
    vs = jr.init({"params": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)}, x)
    vs = jax.tree_util.tree_map(np.asarray, dict(vs))
    rng = np.random.default_rng(9)
    vs["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0, 0.3, a.shape)).astype(np.float32),
        vs["batch_stats"])

    port = port_of(PR.create_router(PB.create_branch_models(cfg), pclf(cfg), cfg), vs)
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    ckpt = {"classifier_state_dict": sub("classifier."),
            **{f"{lvl}_model_state_dict": sub(f"models.{lvl}.")
               for lvl in ("low", "medium", "high")}}
    zeros = jax.tree_util.tree_map(np.zeros_like, vs)
    back = load_torch_joint(ckpt, zeros, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(vs)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))


def test_config_schema_matches_jax(tmp_path):
    """The port's config is the JAX schema with `cuda` in place of `tpu`;
    load_config merges a user file and overrides the same way, and
    update_checkpoint_paths rewrites the same keys."""
    from adam_dehaze_tpu import config as JC
    from adam_dehaze_tpu_torch import config as PC

    j, p = JC.default_config(), PC.default_config()
    assert set(j) - {"tpu"} == set(p) - {"cuda"}
    for key in set(j) - {"tpu", "device"}:
        assert j[key] == p[key], key
    assert PC.compute_dtype(p) == torch.bfloat16
    user = tmp_path / "user.yaml"
    user.write_text("dehazing:\n  low:\n    channels: 16\n")
    merged = PC.load_config(str(user), {"cuda": {"compute_dtype": "float32"}})
    assert merged["dehazing"]["low"]["channels"] == 16
    assert merged["dehazing"]["low"]["blocks"] == 3
    assert PC.compute_dtype(merged) == torch.float32
    want = JC.update_checkpoint_paths(j, "exp")
    got = PC.update_checkpoint_paths(p, "exp")
    for key in ("classifier", "dehazing", "routing", "joint_training",
                "detection", "evaluation"):
        assert got[key] == want[key], key
    assert (got["_exp_dir"], got["_logs_dir"]) == (want["_exp_dir"], want["_logs_dir"])
    with pytest.raises(ValueError):
        PC.compute_dtype({"cuda": {"compute_dtype": "float16"}})
