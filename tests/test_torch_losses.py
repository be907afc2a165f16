"""The port's loss nets and DehazingLoss against the JAX package, on the
CPU: VGG16 taps, AlexNet taps, LPIPS, the loss's components (plain and
density-weighted) and its gradient with respect to the prediction, all on
the JAX package's seeded parameters carried across by load_flax_variables
(fp32, matmul precision "highest"). Tolerance 1e-4, in units of each
tensor's largest magnitude where the values are not O(1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.losses import dehazing as jdl
from adam_dehaze_tpu.losses.lpips import LPIPS as JLPIPS
from adam_dehaze_tpu.nn.alexnet import AlexNetFeatures as JAlexNet
from adam_dehaze_tpu.nn.vgg import VGG16Features as JVGG
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.losses import dehazing as pdl
from adam_dehaze_tpu_torch.losses.lpips import LPIPS, lpips_from_unit_range
from adam_dehaze_tpu_torch.nn.alexnet import AlexNetFeatures
from adam_dehaze_tpu_torch.nn.vgg import VGG16Features
from adam_dehaze_tpu_torch.training.checkpoint import (
    load_flax_variables,
    save_checkpoint,
)
from torch_port_util import ATOL, images, port_loss_params, port_of

ALL_TAPS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_1")


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.fixture(scope="module")
def jax_loss():
    """The JAX DehazingLoss, its params at 32^2, and the port's nets on them."""
    loss = jdl.DehazingLoss()
    params = jax.jit(lambda k: loss.init(k, (1, 32, 32, 3)))(jax.random.PRNGKey(0))
    return loss, params, port_loss_params(params)


@pytest.fixture(scope="module")
def pred_target():
    target = images((3, 32, 32, 3), seed=1)
    noise = np.random.default_rng(2).normal(0, 0.1, target.shape)
    return np.clip(target + noise, 0, 1).astype(np.float32), target


def test_vgg_taps_match_jax():
    x = images((2, 40, 40, 3), seed=3)
    jnet = JVGG(taps=ALL_TAPS)
    vs = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jnet.apply(vs, jnp.asarray(x))
    net = port_of(VGG16Features(ALL_TAPS), vs)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert set(got) == set(ALL_TAPS)
    for t in ALL_TAPS:
        assert got[t].shape == want[t].shape
        assert _scaled_err(got[t], want[t]) <= ATOL, t


def test_vgg_layout_is_torchvision_features():
    """Conv k of VGG16 sits at torchvision's `features.N`, the trunk ends at
    the deepest tap's stage."""
    keys = [k for k in VGG16Features(("relu2_2", "relu3_3", "relu4_3")).state_dict()
            if k.endswith("weight")]
    assert keys == [f"features.{i}.weight" for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)]
    assert len(VGG16Features(("relu1_1",)).features) == 4     # all of stage 1, as flax


def test_alexnet_taps_match_jax():
    x = images((2, 64, 64, 3), seed=4) * 2 - 1
    jnet = JAlexNet()
    vs = jnet.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = jnet.apply(vs, jnp.asarray(x))
    net = port_of(AlexNetFeatures(), vs)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _scaled_err(g, w) <= ATOL


def test_lpips_matches_jax(pred_target):
    pred, target = pred_target
    jnet = JLPIPS()
    vs = jnet.init(jax.random.PRNGKey(3), jnp.asarray(pred), jnp.asarray(target))
    # Non-uniform heads, so that every lin{i} is read where it should be.
    rng = np.random.default_rng(5)
    vs = jax.tree_util.tree_map(np.asarray, dict(vs))
    for i in range(5):
        vs["params"][f"lin{i}"] = rng.random(vs["params"][f"lin{i}"].shape).astype(np.float32)
    want = jnet.apply(vs, 2 * jnp.asarray(pred) - 1, 2 * jnp.asarray(target) - 1)
    net = port_of(LPIPS(), vs)
    with torch.no_grad():
        got = lpips_from_unit_range(net, torch.from_numpy(pred), torch.from_numpy(target))
        same = net(torch.from_numpy(pred), torch.from_numpy(pred))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("density", [False, True])
def test_dehazing_loss_and_grad_match_jax(jax_loss, pred_target, density):
    jloss, jparams, nets = jax_loss
    jloss = jdl.DehazingLoss(density_weighted=density, lambda_density=0.5)
    ploss = pdl.DehazingLoss(density_weighted=density, lambda_density=0.5)
    pred, target = pred_target
    hazy = images(pred.shape, seed=6)

    def jfn(p):
        return jloss(jparams, p, jnp.asarray(target), hazy=jnp.asarray(hazy))

    (jtotal, jcomps), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    total, comps = ploss(nets, p, torch.from_numpy(target), hazy=torch.from_numpy(hazy))
    total.backward()
    assert set(comps) == set(jcomps)
    for k in comps:
        np.testing.assert_allclose(float(comps[k].detach()), float(jcomps[k]), rtol=ATOL, atol=ATOL)
    assert _scaled_err(p.grad, jgrad) <= ATOL
    # The frozen nets took no gradient.
    assert all(q.grad is None for net in nets.values() for q in net.parameters())


def test_density_weighting_changes_only_l1(jax_loss, pred_target):
    _, _, nets = jax_loss
    pred, target = (torch.from_numpy(a) for a in pred_target)
    hazy = torch.from_numpy(images(pred.shape, seed=7))
    _, plain = pdl.DehazingLoss()(nets, pred, target, hazy=hazy)
    _, dens = pdl.DehazingLoss(density_weighted=True)(nets, pred, target, hazy=hazy)
    assert float(plain["l1"]) != float(dens["l1"])
    for k in ("content", "perceptual"):
        assert float(plain[k]) == float(dens[k])


def test_get_dehazing_loss_reads_the_config():
    cfg = load_config()
    cfg["loss"].update(lambda_l1=2.0, lambda_content=0.3, lambda_perceptual=0.4,
                       density_weighted=True, lambda_density=0.2)
    p, j = pdl.get_dehazing_loss(cfg), jdl.get_dehazing_loss(
        {"loss": cfg["loss"], "tpu": {"compute_dtype": "float32"}})
    for k in ("lambda_l1", "lambda_content", "lambda_perceptual", "density_weighted",
              "lambda_density", "vgg_weights", "lpips_weights"):
        assert getattr(p, k) == getattr(j, k), k


def test_init_is_seeded_frozen_and_on_device():
    loss = pdl.DehazingLoss()
    a = loss.init(torch.Generator().manual_seed(0))
    b = loss.init(torch.Generator().manual_seed(0))
    for name in ("content", "lpips"):
        assert not a[name].training
        assert not any(q.requires_grad for q in a[name].parameters())
        for (k, va), vb in zip(a[name].state_dict().items(), b[name].state_dict().values()):
            assert torch.equal(va, vb), k
    w = a["content"].features[0].weight
    assert abs(float(w.std()) - 27 ** -0.5) < 0.05          # lecun-normal, fan-in 27
    assert float(a["lpips"].lin0[0]) == pytest.approx(1 / 64)


def test_loss_nets_load_from_weight_files(tmp_path):
    """`loss.vgg_weights` / `loss.lpips_weights` fill the nets through the
    port's checkpoint reader; a torchvision-style VGG16 state_dict, deeper
    than the taps and with a classifier, loads by its own keys."""
    gen = torch.Generator().manual_seed(4)
    full = VGG16Features(("relu5_3",))
    for q in full.parameters():
        q.data.normal_(generator=gen)
    sd = {k: v for k, v in full.state_dict().items()}
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    vgg_path = tmp_path / "vgg16.pth"
    torch.save(sd, vgg_path)
    lp = LPIPS()
    for q in lp.parameters():
        q.data.uniform_(generator=gen)
    lpips_path = save_checkpoint(str(tmp_path), "lpips", {"state_dict": lp.state_dict()})
    nets = pdl.DehazingLoss(vgg_weights=str(vgg_path), lpips_weights=lpips_path).init(
        torch.Generator().manual_seed(0))
    for k, v in nets["content"].state_dict().items():
        assert torch.equal(v, sd[k]), k
    for k, v in nets["lpips"].state_dict().items():
        assert torch.equal(v, lp.state_dict()[k]), k
    torch.save({"features.0.weight": sd["features.0.weight"]}, tmp_path / "short.pth")
    with pytest.raises(ValueError, match="lacks"):
        pdl.DehazingLoss(vgg_weights=str(tmp_path / "short.pth")).init(torch.Generator())


def test_load_flax_variables_fills_every_loss_net_tensor():
    x = jnp.zeros((1, 32, 32, 3))
    for jnet, net, args in ((JVGG(), VGG16Features(), (x,)),
                            (JAlexNet(), AlexNetFeatures(), (x,)),
                            (JLPIPS(), LPIPS(), (x, x))):
        vs = jnet.init(jax.random.PRNGKey(0), *args)
        load_flax_variables(net, vs)      # raises on a tensor left unset
        n_flax = sum(a.size for a in jax.tree_util.tree_leaves(vs))
        assert n_flax == sum(q.numel() for q in net.parameters())
