"""The port's no-reference proxies (evaluation/no_reference.py) against the
JAX package's on the same inputs, on the CPU, fp32:

- the NSS half: `interp` against jnp.interp over the GGD table, `mscn` and
  the 36 `nss_features` within 1e-4 of max(1, |JAX|) at an even and an odd
  size, the antialiased half-scale resize against jax.image.resize, and
  the Mahalanobis scores (numpy on both sides: equal);
- the NIMA half: QualityHead's logits and MOS within 1e-5 on weights
  carried over from flax (load_flax_variables) at 128^2 and 96^2;
  `_distort_batch` with JAX's draws injected (images within 1e-5, targets
  within 1e-4); one training step's loss and gradients against
  jax.value_and_grad of the same loss, the gradients within 1e-4 of the
  largest; the .pth cache round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.evaluation import no_reference as J
from adam_dehaze_tpu_torch.evaluation import no_reference as P
from torch_port_util import as_np, images, one_torch_thread, port_of

# The port's ops run on one thread in this module (see one_torch_thread).
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZES = [(32, 32), (33, 35)]


def _rel_err(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


@pytest.fixture(scope="module")
def nss_reference():
    """Per size: the images and JAX's gray, mscn and features of them."""
    out = {}
    feats = jax.jit(J.nss_features)
    for i, hw in enumerate(SIZES):
        x = images((3, *hw, 3), seed=i)
        gray = x @ np.asarray([0.299, 0.587, 0.114], np.float32)
        out[hw] = dict(x=x, gray=gray, mscn=np.asarray(J.mscn(jnp.asarray(gray))),
                       feats=np.asarray(feats(jnp.asarray(x))),
                       half=np.asarray(jax.image.resize(
                           jnp.asarray(gray), (3, hw[0] // 2, hw[1] // 2), "bilinear")))
    return out


def test_interp_matches_jnp_interp_on_the_ggd_table():
    rng = np.random.default_rng(0)
    rho = J._GGD_TABLE[0]
    x = np.concatenate([rng.uniform(float(rho[0]) - 0.5, float(rho[-1]) + 0.5, 2000),
                        np.asarray(rho[::997])]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), *J._GGD_TABLE))
    got = P.interp(torch.from_numpy(x), P._table("rho_rev", "cpu"),
                   P._table("alpha_rev", "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", SIZES, ids=["even", "odd"])
def test_mscn_and_nss_features_match_jax(nss_reference, hw):
    ref = nss_reference[hw]
    assert _rel_err(P.mscn(torch.from_numpy(ref["gray"])).numpy(), ref["mscn"]) <= 1e-4
    got = P.nss_features(torch.from_numpy(ref["x"])).numpy()
    assert got.shape == (3, 36)
    assert _rel_err(got, ref["feats"]) <= 1e-4


@pytest.mark.parametrize("hw", SIZES, ids=["even", "odd"])
def test_half_scale_resize_matches_jax_image_resize(nss_reference, hw):
    ref = nss_reference[hw]
    got = P.resize_bilinear(torch.from_numpy(ref["gray"]), hw[0] // 2, hw[1] // 2).numpy()
    np.testing.assert_allclose(got, ref["half"], rtol=0, atol=1e-6)


def test_mahalanobis_scores_equal_jax(nss_reference, tmp_path):
    """Numpy on both sides: the same features give the same scores, the
    pristine model and its .npz round trip too."""
    clear = np.concatenate([r["feats"] for r in nss_reference.values()])
    rng = np.random.default_rng(3)
    test = clear + rng.normal(0, 0.01, clear.shape)
    pj, pp = J.pristine_from_features(clear), P.pristine_from_features(clear)
    np.testing.assert_array_equal(pp["mu"], pj["mu"])
    np.testing.assert_array_equal(pp["cov"], pj["cov"])
    np.testing.assert_array_equal(P.mahalanobis_scores(test, pp),
                                  J.mahalanobis_scores(test, pj))
    P.save_pristine(str(tmp_path / "p.npz"), pp)
    back = P.load_pristine(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(back["cov"], pp["cov"])
    assert P.load_pristine(str(tmp_path / "missing.npz")) is None


@pytest.fixture(scope="module")
def head_pair():
    """JAX's QualityHead params (seed 0) and the port's head filled from
    them."""
    model = J.QualityHead()
    params = as_np(dict(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))))
    return model, params, port_of(P.QualityHead(), params)


@pytest.mark.parametrize("size", [128, 96])
def test_quality_head_logits_and_mos_match_jax(head_pair, size):
    model, params, head = head_pair
    x = images((2, size, size, 3), seed=size)
    lj = np.asarray(model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        lp = head(torch.from_numpy(x))
    np.testing.assert_allclose(lp.numpy(), lj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(P.QualityHead.mos(lp).numpy(),
                               np.asarray(J.QualityHead.mos(jnp.asarray(lj))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(P.nima_proxy_scores(torch.from_numpy(x), head, img_size=size),
                               np.asarray(J.nima_proxy_scores(jnp.asarray(x), model, params,
                                                              img_size=size)),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def distorted():
    """JAX's _distort_batch on a clear batch at 32^2 and the draws it made."""
    clear = images((2, 32, 32, 3), seed=7)
    key = jax.random.PRNGKey(5)
    imgs, mos = J._distort_batch(key, jnp.asarray(clear))
    ks = jax.random.split(key, 4)
    a = np.array(jax.random.uniform(ks[0], (2,), minval=0.6, maxval=0.95))
    noise = np.array(jax.random.normal(ks[1], clear.shape))
    return clear, a, noise, np.array(imgs), np.array(mos)


def test_distort_batch_matches_jax_with_its_draws(distorted):
    clear, a, noise, want_imgs, want_mos = distorted
    imgs, mos = P._distort_batch(torch.from_numpy(clear), a=torch.from_numpy(a),
                                 noise=torch.from_numpy(noise))
    assert imgs.shape == want_imgs.shape == (12, 32, 32, 3)
    np.testing.assert_allclose(imgs.numpy(), want_imgs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mos.numpy(), want_mos, rtol=0, atol=1e-4)
    # The draws from a generator: a in [0.6, 0.95), the same shapes.
    imgs_g, mos_g = P._distort_batch(torch.from_numpy(clear), torch.Generator().manual_seed(0))
    assert imgs_g.shape == imgs.shape and bool(((mos_g >= 1) & (mos_g <= 10)).all())


def test_train_step_loss_and_gradients_match_jax(head_pair, distorted):
    """One step of train_quality_head's loss: the value and every gradient
    against jax.value_and_grad of the JAX package's loss_fn on the same
    images, targets and params (Adam's first step is +-lr by sign, so the
    gradients are compared, not the updated params)."""
    model, params, _ = head_pair
    _, _, _, imgs, mos = distorted
    bins = jnp.arange(1, 11, dtype=jnp.float32)

    def loss_fn(p):   # the JAX package's train_quality_head loss
        logits = model.apply(p, jnp.asarray(imgs))
        target = jax.nn.softmax(-((bins[None, :] - mos[:, None]) ** 2) / (2 * 0.7 ** 2), axis=-1)
        ce = -jnp.sum(target * jax.nn.log_softmax(logits, -1), axis=-1)
        return jnp.mean(ce), jnp.mean(jnp.abs(J.QualityHead.mos(logits) - mos))

    (loss_j, mae_j), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    head = port_of(P.QualityHead(), params).train()
    loss, mae = P.quality_loss(head, torch.from_numpy(imgs), torch.from_numpy(mos))
    loss.backward()
    loss, mae = loss.detach(), mae.detach()
    assert float(loss) == pytest.approx(float(loss_j), abs=1e-5)
    assert float(mae) == pytest.approx(float(mae_j), abs=1e-4)
    want = port_of(P.QualityHead(), as_np(dict(grads))).state_dict()
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(grads))
    for name, p in head.named_parameters():
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_quality_head_cache_round_trip(head_pair, tmp_path):
    _, _, head = head_pair
    path = str(tmp_path / "exp" / "quality_head.pth")
    assert P.load_quality_head(path, device="cpu") is None
    P.save_quality_head(path, head)
    back = P.load_quality_head(path, device="cpu")
    assert not back.training
    for k, v in head.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
