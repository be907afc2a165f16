"""The whole serving slice of the port against the JAX package, on the CPU
at small widths, fp32 (ATOL 1e-4: fp32 vs fp32 after some 40 layers of
reordered sums).

Both `AdaptiveDehazer`s hold the same converted weights: the JAX one is
built from its router and variables with `tpu.compute_dtype: float32`, the
port's from its own router and the same variables through
`load_flax_variables`. Checked: hard routing (labels and outputs), the
engine with forced labels that cover every class (so a near-tie in the
random classifier's argmax cannot decide the test), the capacity spill
plan, soft routing, and the bucket rules.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu_torch.models import routing as PR
from torch_port_util import ATOL, dehazer_pair, images

N_IMAGES = 6


@pytest.fixture(scope="module")
def dehazers():
    return dehazer_pair()


def test_route_hard_matches_jax(dehazers):
    jd, pd = dehazers
    x = images((N_IMAGES, 32, 32, 3), seed=1)
    want, want_i = jd.route_hard(x)
    got, got_i = pd.route_hard(x)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(pd.classify(x), want_i)


def test_forced_labels_cover_every_branch(dehazers):
    jd, pd = dehazers
    x = images((N_IMAGES, 32, 32, 3), seed=2)
    labels = np.arange(N_IMAGES) % 3
    want, _ = jd._binned_engine()(jnp.asarray(x), intensity=labels)
    with torch.inference_mode():
        got, got_i = pd.engine(torch.from_numpy(x), intensity=labels)
    np.testing.assert_array_equal(got_i, labels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_spill_matches_jax(dehazers):
    """spill=True with a skewed batch: the port's plan and outputs follow
    the JAX engine's."""
    jd, pd = dehazers
    x = images((N_IMAGES, 32, 32, 3), seed=3)
    want, want_i = jd.route_hard(x, spill=True)
    got, got_i = pd.route_hard(x, spill=True)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_soft_matches_jax(dehazers):
    jd, pd = dehazers
    x = images((3, 32, 32, 3), seed=4)
    np.testing.assert_allclose(pd(x), jd(x), atol=ATOL)


def test_soft_and_hard_share_one_serving_copy(dehazers):
    """Soft routing and the engine run the same applies: the low branch
    folded once for K1, the other branches and the classifier cast once."""
    from adam_dehaze_tpu_torch.ops.serving_apply import LightweightChainApply

    _, pd = dehazers
    soft = pd._serving
    assert pd.engine.classifier_apply is soft.classifier
    assert pd.engine.branch_applies == [soft.models[n] for n in PR.INTENSITY_ORDER]
    assert isinstance(soft.models["low"], LightweightChainApply)
    assert soft.models["high"] is not pd.router.models["high"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("up_only", [False, True], ids=["both", "up"])
def test_capacity_spill_plan_matches_jax(seed, up_only):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    labels = rng.choice(3, size=n, p=[0.6, 0.3, 0.1])
    logits = rng.standard_normal((n, 3)).astype(np.float32)
    jeng = JR.BinnedAdaptiveEngine(lambda x: x, [lambda x: x] * 3)
    peng = PR.BinnedAdaptiveEngine(lambda x: x, [lambda x: x] * 3)
    for lg, thr in ((None, None), (logits, None), (logits, 0.5)):
        np.testing.assert_array_equal(
            peng.plan_capacity_spill(labels, lg, up_only, thr),
            jeng.plan_capacity_spill(labels, lg, up_only, thr))


def test_bucket_rules_match_jax():
    ladder = (1, 2, 4, 8, 16, 32)
    for n in range(1, 81):
        for extend in (False, True):
            assert PR.bucket_for(n, ladder, extend) == JR.bucket_for(n, ladder, extend)
        for overhead in (0.5, 2.0, 13.0):
            assert (PR.plan_chunks(n, ladder, overhead)
                    == JR.plan_chunks(n, ladder, overhead))
    assert PR.plan_chunks(0, ladder) == ()
    with pytest.raises(ValueError):
        PR.plan_chunks(3, ())
