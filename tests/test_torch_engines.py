"""The serving engines and routes of the port against the JAX package, on
the CPU.

Engine level: deterministic toy branches written in both frameworks
(branch i: tanh((i + 2) x) / 2 + i / 10, per row) and the content
classifier of tests/test_binned_routing.py (class = floor(1e4 * mean) % 3).
The images are multiples of 2^-8, so the mean of a 16x16x3 image is exact
in float32 in any summation order and both classifiers pick the same class.
Labels, global indices, class order and the branch calls (class, rows) must
be equal; outputs match to 1e-6 (tanh in two libraries).

Route level: the module-scoped `dehazer_pair()` (fp32, 32^2); labels exact,
outputs at ATOL (1e-4, fp32 after some 40 layers of sums in another order).
Its seeded classifier routes every image high, so the spill cases are the
ones that reach all three branches there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu_torch.models import routing as PR
from torch_port_util import ATOL, dehazer_pair, images

TOY_ATOL = 1e-6
SIDE = 16


def _toy_jax():
    return [(lambda img, k=i: jnp.tanh(img * (k + 2.0)) * 0.5 + 0.1 * k) for i in range(3)]


def _toy_torch():
    return [(lambda img, k=i: torch.tanh(img * (k + 2.0)) * 0.5 + 0.1 * k) for i in range(3)]


def _content_jax(img):
    cls = jnp.floor(img.mean(axis=(1, 2, 3)) * 1e4).astype(jnp.int32) % 3
    return jax.nn.one_hot(cls, 3) * 10.0, None


def _content_torch(img):
    cls = torch.floor(img.mean(dim=(1, 2, 3)) * 1e4).long() % 3
    return torch.nn.functional.one_hot(cls, 3).float() * 10.0, None


def _fixed_logits(rows):
    """(JAX, port) classifiers whose logits for a batch of n are `rows(n)`."""
    return ((lambda img: (jnp.asarray(rows(img.shape[0])), None)),
            (lambda img: (torch.from_numpy(rows(img.shape[0])), None)))


def _constant(cls):
    def rows(n):
        out = np.zeros((n, 3), np.float32)
        out[:, cls] = 10.0
        return out
    return _fixed_logits(rows)


def _clumped():
    """Class = round(100 * mean) % 3: a batch filled with cls / 100 is all cls."""
    return ((lambda img: (jax.nn.one_hot(jnp.round(img.mean(axis=(1, 2, 3)) * 100)
                                         .astype(jnp.int32) % 3, 3) * 10.0, None)),
            (lambda img: (torch.nn.functional.one_hot(
                torch.round(img.mean(dim=(1, 2, 3)) * 100).long() % 3, 3).float() * 10.0, None)))


def _one_high_rest_low():
    def rows(n):
        out = np.tile(np.array([[10.0, 0.0, 0.0]], np.float32), (n, 1))
        out[0] = [0.0, 0.0, 10.0]
        return out
    return _fixed_logits(rows)


def _quantized(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIDE, SIDE, 3)) / 256.0).astype(np.float32)


class _Calls:
    """Records (class, rows) of every branch call."""

    def __init__(self):
        self.calls = []

    def wrap(self, fns):
        return [(lambda x, c=c, f=f: (self.calls.append((c, int(x.shape[0]))), f(x))[1])
                for c, f in enumerate(fns)]

    def wrap_steps(self, steps):
        """The JAX engine's fused bucket steps step(x, idx, out)."""
        return [(lambda x, idx, out, c=c, s=s: (self.calls.append((c, int(idx.shape[0]))),
                                                  s(x, idx, out))[1])
                for c, s in enumerate(steps)]


def _engines(classifiers=None, buckets=(1, 2, 4)):
    """(JAX engine, port engine, JAX calls, port calls) on the toy branches;
    the JAX engine's bucket steps and branch applies both record."""
    jclf, pclf = classifiers or (_content_jax, _content_torch)
    jeng = JR.BinnedAdaptiveEngine(jclf, _toy_jax(), buckets=buckets)
    peng = PR.BinnedAdaptiveEngine(pclf, _toy_torch(), buckets=buckets)
    jcalls, pcalls = _Calls(), _Calls()
    jeng._bucket_steps = jcalls.wrap_steps(jeng._bucket_steps)
    jeng.branch_applies = jcalls.wrap(jeng.branch_applies)
    peng.branch_applies = pcalls.wrap(peng.branch_applies)
    return jeng, peng, jcalls, pcalls


# ---------------------------------------------------------------------------
# run_stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("labels", ["predicted", "given", "spill"])
def test_run_stream_matches_jax(labels):
    jeng, peng, jcalls, pcalls = _engines()
    x = _quantized(6, 0)
    batches = [x[:3], x[3:], x[1:4]]
    given = ([np.array([0, 1, 2]), np.array([2, 2, 2]), np.array([1, 0, 1])]
             if labels == "given" else None)
    if labels == "spill":
        given = [np.array([0, 0, 0]), np.array([2, 2, 2]), np.array([1, 1, 0])]
    kw = dict(intensities=given, spill=labels == "spill")
    want = list(jeng.run_stream([jnp.asarray(b) for b in batches], **kw))
    got = list(peng.run_stream([torch.from_numpy(b) for b in batches], **kw))
    if labels == "predicted":
        assert len(np.unique(np.concatenate([w[1] for w in want]))) == 3
    assert len(got) == len(want) == 3
    for (yw, lw), (yg, lg) in zip(want, got):
        np.testing.assert_array_equal(lg, lw)
        np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=TOY_ATOL)
    assert pcalls.calls == jcalls.calls


def test_run_stream_equals_per_batch_calls():
    _, peng, _, _ = _engines()
    x = torch.from_numpy(_quantized(7, 1))
    batches = [x[:4], x[4:], x[2:5]]
    for (ys, ls), b in zip(peng.run_stream(batches), batches):
        yd, ld = peng(b)
        np.testing.assert_array_equal(ls, ld)
        torch.testing.assert_close(ys, yd, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# run_queued
# ---------------------------------------------------------------------------

def _queued_case(name):
    """(classifiers, buckets, batches, run_queued kwargs) of the cases of
    tests/test_binned_routing.py and test_plan_chunks.py."""
    rng = np.random.default_rng(3)
    if name == "ordered":
        batches = [np.full((5, SIDE, SIDE, 3), c / 100.0, np.float32) for c in range(3)]
        return _clumped(), (1, 2, 4), batches, dict(queue_bucket=4)
    if name == "mixed":
        batches = [_quantized(6, s) for s in (10, 11, 12)]
        return None, (1, 2, 4, 8), batches, dict(queue_bucket=4)
    if name == "no_flush":
        return _constant(2), (1, 2, 4), [_quantized(3, 13)], dict(queue_bucket=4, flush=False)
    if name == "flush":
        return _constant(2), (1, 2, 4), [_quantized(3, 13)], dict(queue_bucket=4)
    if name == "beyond_ladder":
        return _constant(2), (1, 2, 4), [_quantized(5, 14)], dict(queue_bucket=8)
    if name == "intensities":
        labels = [np.array([2, 2, 2, 2]), np.array([1, 1, 2, 2])]
        return (_constant(0), (1, 2, 4), [_quantized(4, 15), _quantized(4, 16)],
                dict(queue_bucket=4, intensities=labels))
    if name == "max_wait":
        batches = [rng.uniform(size=(4, SIDE, SIDE, 3)).astype(np.float32) for _ in range(5)]
        return (_one_high_rest_low(), (1, 2, 4), batches,
                dict(queue_bucket=4, max_wait_batches=2, flush=False))
    if name == "max_wait_flush":
        batches = [_quantized(5, s) for s in (17, 18, 19, 20)]
        return None, (1, 2, 4, 8), batches, dict(queue_bucket=8, max_wait_batches=1)
    if name == "plan_flush":
        return (_constant(0), (1, 2, 4, 8, 16, 32), [_quantized(18, 21)],
                dict(intensities=[np.zeros(18, np.int64)]))
    raise KeyError(name)


QUEUED_CASES = ["ordered", "mixed", "no_flush", "flush", "beyond_ladder", "intensities",
                "max_wait", "max_wait_flush", "plan_flush"]


def _queued_pair(classifiers, buckets, batches, kw):
    jeng, peng, jcalls, pcalls = _engines(classifiers, buckets)
    want = list(jeng.run_queued([jnp.asarray(b) for b in batches], **kw))
    got = list(peng.run_queued([torch.from_numpy(b) for b in batches], **kw))
    return want, got, jcalls.calls, pcalls.calls


@pytest.mark.parametrize("case", QUEUED_CASES)
def test_run_queued_matches_jax(case):
    classifiers, buckets, batches, kw = _queued_case(case)
    want, got, jcalls, pcalls = _queued_pair(classifiers, buckets, batches, kw)
    assert [(g.tolist(), c) for _, g, c in got] == [(g.tolist(), c) for _, g, c in want]
    for (yw, _, _), (yg, gidx, _) in zip(want, got):
        assert yg.shape[0] == gidx.size
        np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=TOY_ATOL)
    assert pcalls == jcalls
    served = np.concatenate([g for _, g, _ in got]) if got else np.zeros(0, int)
    assert served.size == np.unique(served).size
    total = sum(b.shape[0] for b in batches)
    if kw.get("flush", True):
        np.testing.assert_array_equal(np.sort(served), np.arange(total))
    if case == "no_flush":
        assert got == []
    if case == "plan_flush":
        assert [c[1] for c in pcalls] == [16, 2]
    if case == "max_wait":
        assert {int(g) for _, gi, c in got if c == 2 for g in gi} == {0, 4, 8}


def test_run_queued_serves_every_image_once_at_random():
    rng = np.random.default_rng(7)
    for trial in range(4):
        sizes = rng.integers(1, 7, size=rng.integers(1, 4))
        batches = [_quantized(int(s), 100 * trial + i) for i, s in enumerate(sizes)]
        want, got, jcalls, pcalls = _queued_pair(None, (1, 2, 4), batches, dict(queue_bucket=4))
        assert [(g.tolist(), c) for _, g, c in got] == [(g.tolist(), c) for _, g, c in want]
        assert pcalls == jcalls
        seen = np.zeros(int(sizes.sum()), np.int32)
        for y, gidx, cls in got:
            assert torch.isfinite(y).all() and 0 <= cls < 3
            seen[gidx] += 1
        np.testing.assert_array_equal(seen, 1)


# ---------------------------------------------------------------------------
# _device_capacity_labels and the choice table
# ---------------------------------------------------------------------------

def _capacity_pair(intensity, logits, cap, n_cls=3):
    want = np.asarray(JR._device_capacity_labels(jnp.asarray(intensity),
                                                 jnp.asarray(logits), cap, n_cls))
    got = PR._device_capacity_labels(torch.from_numpy(np.asarray(intensity)),
                                     torch.from_numpy(np.asarray(logits, np.float32)),
                                     cap, n_cls).numpy()
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("n_cls", [2, 3, 4, 5])
def test_spill_choice_table_matches_jax(n_cls):
    np.testing.assert_array_equal(PR._spill_choice_table(n_cls).numpy(),
                                  np.asarray(JR._spill_choice_table(n_cls)))


def test_capacity_labels_policy():
    intensity = np.array([0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 2])
    logits = np.full((12, 3), -10.0, np.float32)
    logits[np.arange(12), intensity] = 10.0
    logits[1, 1] = 9.9          # the least confident low: it spills
    eff = _capacity_pair(intensity, logits, cap=4)
    np.testing.assert_array_equal(np.nonzero(eff != intensity)[0], [1])
    assert eff[1] == 1


def test_capacity_labels_identity_when_balanced():
    intensity = np.repeat(np.arange(3), 4)
    eff = _capacity_pair(intensity, np.eye(3, dtype=np.float32)[intensity], cap=4)
    np.testing.assert_array_equal(eff, intensity)


def test_capacity_labels_cascade():
    eff = _capacity_pair(np.zeros(6, np.int64), np.tile([5.0, 1.0, 0.0], (6, 1)), cap=2)
    np.testing.assert_array_equal(np.bincount(eff, minlength=3), [2, 2, 2])


@pytest.mark.parametrize("seed", range(6))
def test_capacity_labels_with_tied_margins(seed):
    """Margins drawn from a few values, so that many tie: the stable sort
    decides which images spill, on both sides alike."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 40))
    n_cls = 3 + seed % 2
    intensity = rng.choice(n_cls, size=n, p=None if seed % 3 else [0.7] + [0.3 / (n_cls - 1)] * (n_cls - 1))
    logits = rng.integers(0, 3, (n, n_cls)).astype(np.float32)
    logits[np.arange(n), intensity] += 2.0     # ties at margins 0, 1 and 2
    b = int(rng.integers(1, 5))
    cap = -(-n // (n_cls * b)) * b
    eff = _capacity_pair(intensity, logits, cap, n_cls)
    assert np.bincount(eff, minlength=n_cls).max() <= cap


# ---------------------------------------------------------------------------
# The device-binned engine, adaptive infer, sharded
# ---------------------------------------------------------------------------

def _device_pair(classifiers=None, chunk=2, spill=False, applies=None):
    jclf, pclf = classifiers or (_content_jax, _content_torch)
    japp, papp = applies or (_toy_jax(), _toy_torch())
    calls = _Calls()
    jfn = jax.jit(JR.make_device_binned_infer(jclf, japp, chunk=chunk, spill=spill))
    pfn = PR.make_device_binned_infer(pclf, calls.wrap(papp), chunk=chunk, spill=spill)
    return jfn, pfn, calls


def _chunks_per_class(labels, b, n_cls=3):
    return [(c, b) for c in range(n_cls) for _ in range(-(-int((labels == c).sum()) // b))]


@pytest.mark.parametrize("batch,chunk", [(7, 2), (12, 4), (3, 8), (9, 3)])
def test_device_binned_matches_jax(batch, chunk):
    jfn, pfn, calls = _device_pair(chunk=chunk)
    x = _quantized(batch, batch)
    yw, iw, lw = jfn(jnp.asarray(x))
    yg, ig, lg = pfn(torch.from_numpy(x))
    np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))
    np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=TOY_ATOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw))
    if batch >= 7:
        assert len(np.unique(ig.numpy())) >= 2
    # One branch call per real chunk, in class order; none for tail chunks.
    assert calls.calls == _chunks_per_class(ig.numpy(), min(chunk, batch))
    ys, isel = PR.make_adaptive_infer(_content_torch, _toy_torch(), "select")(torch.from_numpy(x))
    np.testing.assert_array_equal(isel.numpy(), ig.numpy())
    torch.testing.assert_close(yg, ys, rtol=0, atol=TOY_ATOL)


def test_device_binned_single_class():
    jfn, pfn, calls = _device_pair(_constant(2), chunk=2)
    x = _quantized(5, 30)
    yw, iw, _ = jfn(jnp.asarray(x))
    yg, ig, _ = pfn(torch.from_numpy(x))
    assert (ig.numpy() == 2).all()
    np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=TOY_ATOL)
    np.testing.assert_allclose(yg.numpy(), _toy_torch()[2](torch.from_numpy(x)).numpy(),
                               atol=TOY_ATOL)
    assert calls.calls == [(2, 2)] * 3


def test_device_binned_oracle_override():
    jfn, pfn, _ = _device_pair(chunk=2)
    x = _quantized(6, 31)
    oracle = np.array([2, 2, 0, 1, 2, 0])
    yw, iw, _ = jfn(jnp.asarray(x), jnp.asarray(oracle))
    yg, ig, lg = pfn(torch.from_numpy(x), oracle)
    np.testing.assert_array_equal(ig.numpy(), oracle)
    assert tuple(lg.shape) == (6, 3)
    np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=TOY_ATOL)
    host, _ = PR.BinnedAdaptiveEngine(_content_torch, _toy_torch(), buckets=(2, 4))(
        torch.from_numpy(x), intensity=oracle)
    torch.testing.assert_close(yg, host, rtol=0, atol=0)


def _scale_applies():
    """Branch i multiplies by i + 1: the output names the serving branch."""
    return ([(lambda img, k=i + 1.0: img * k) for i in range(3)],
            [(lambda img, k=i + 1.0: img * k) for i in range(3)])


def _labels_classifier(labels):
    return _fixed_logits(lambda n: (np.eye(3, dtype=np.float32)[labels[:n]] * 10.0))


@pytest.mark.parametrize("labels", [[0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 2],
                                    [0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 1, 2],
                                    [2] * 12])
def test_device_binned_spill_matches_jax(labels):
    labels = np.array(labels)
    jfn, pfn, calls = _device_pair(_labels_classifier(labels), chunk=4, spill=True,
                                   applies=_scale_applies())
    x = _quantized(12, 32) + 0.5
    yw, iw, _ = jfn(jnp.asarray(x))
    yg, ig, _ = pfn(torch.from_numpy(x))
    np.testing.assert_array_equal(ig.numpy(), labels)
    np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=TOY_ATOL)
    served = np.rint(yg.numpy()[:, 0, 0, 0] / x[:, 0, 0, 0]).astype(int) - 1
    np.testing.assert_array_equal(np.bincount(served, minlength=3), [4, 4, 4])
    assert sorted(calls.calls) == [(0, 4), (1, 4), (2, 4)]   # no extra chunk


@pytest.mark.parametrize("mode", ["soft", "select", "switch"])
def test_adaptive_infer_matches_jax(mode):
    x = _quantized(7, 33)
    yw, iw = jax.jit(JR.make_adaptive_infer(_content_jax, _toy_jax(), mode))(jnp.asarray(x))
    yg, ig = PR.make_adaptive_infer(_content_torch, _toy_torch(), mode)(torch.from_numpy(x))
    np.testing.assert_allclose(ig.numpy(), np.asarray(iw), atol=TOY_ATOL)
    np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=TOY_ATOL)
    with pytest.raises(ValueError):
        PR.make_adaptive_infer(_content_torch, _toy_torch(), "blend")


@pytest.mark.parametrize("spill", [False, True], ids=["fidelity", "spill"])
def test_sharded_matches_jax_mesh(spill):
    """Eight `cpu` shards against the JAX engine under shard_map on the
    eight-device CPU mesh of tests/conftest.py: the same shards, so the
    same per-shard binning and spill."""
    labels = np.zeros(16, np.int64) if spill else None
    jclf, pclf = _labels_classifier(labels) if spill else (_content_jax, _content_torch)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("data",))
    jfn = JR.make_sharded_binned_infer(jclf, _toy_jax(), mesh, chunk=2, spill=spill)
    pfn = PR.make_sharded_binned_infer(pclf, _toy_torch(), ["cpu"] * 8, chunk=2, spill=spill)
    x = _quantized(16, 34)
    yw, iw, lw = jfn(jnp.asarray(x))
    yg, ig, lg = pfn(torch.from_numpy(x))
    np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))
    np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=TOY_ATOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw))
    with pytest.raises(ValueError):
        pfn(torch.from_numpy(x[:12]))


def test_upload_and_host_read_on_cpu():
    a = np.arange(5)
    t = PR._upload(a, torch.device("cpu"))
    assert t.device.type == "cpu" and t.tolist() == a.tolist()
    assert PR._upload(t, torch.device("cpu")) is t
    np.testing.assert_array_equal(PR._HostRead(t).get(), a)


# ---------------------------------------------------------------------------
# The AdaptiveDehazer routes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dehazers():
    return dehazer_pair()


def _assert_route(got, want):
    (yg, ig), (yw, iw) = got, want
    np.testing.assert_array_equal(ig, iw)
    assert isinstance(yg, np.ndarray)
    np.testing.assert_allclose(yg, np.asarray(yw), atol=ATOL)


@pytest.mark.parametrize("spill", [False, True], ids=["fidelity", "spill"])
def test_route_device_binned_matches_jax(dehazers, spill):
    jd, pd = dehazers
    x = images((8, 32, 32, 3), seed=1)
    _assert_route(pd.route_device_binned(x, chunk=2, spill=spill),
                  jd.route_device_binned(x, chunk=2, spill=spill))
    assert pd._device_binned_fn(2, spill) is pd._engines[f"device_binned_2_{spill}"]


def test_route_hard_stream_matches_jax(dehazers):
    jd, pd = dehazers
    x = images((8, 32, 32, 3), seed=2)
    batches = [x[:3], x[3:], x[1:6]]
    got, want = list(pd.route_hard_stream(batches)), list(jd.route_hard_stream(batches))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_route(g, w)
    for g, w in zip(pd.route_hard_stream(batches, spill=True),
                    jd.route_hard_stream(batches, spill=True)):
        _assert_route(g, w)


def test_route_hard_queued_matches_jax(dehazers):
    jd, pd = dehazers
    x = images((9, 32, 32, 3), seed=3)
    batches = [x[:4], x[4:7], x[7:]]
    got = list(pd.route_hard_queued(batches, queue_bucket=4))
    want = list(jd.route_hard_queued(batches, queue_bucket=4))
    assert [(g.tolist(), c) for _, g, c in got] == [(g.tolist(), c) for _, g, c in want]
    for (yg, _, _), (yw, _, _) in zip(got, want):
        assert isinstance(yg, torch.Tensor)
        np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=ATOL)
    np.testing.assert_array_equal(np.sort(np.concatenate([g for _, g, _ in got])), np.arange(9))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_route_device_binned_stream_matches_jax(dehazers, depth):
    """Ragged batches, padded with their last image to STREAM_BUCKETS."""
    jd, pd = dehazers
    x = images((16, 32, 32, 3), seed=4)
    batches = [x[:8], x[8:11], x[11:15], x[15:]]
    assert pd.STREAM_BUCKETS == jd.STREAM_BUCKETS
    got = list(pd.route_device_binned_stream(batches, chunk=2, depth=depth))
    want = list(jd.route_device_binned_stream(batches, chunk=2, depth=depth))
    assert [g[0].shape[0] for g in got] == [8, 3, 4, 1]
    for g, w in zip(got, want, strict=True):
        _assert_route(g, w)


def test_route_switch_matches_jax(dehazers):
    jd, pd = dehazers
    x = images((5, 32, 32, 3), seed=5)
    _assert_route(pd.route_switch(x), jd.route_switch(x))
    _assert_route(pd.route_switch(x), pd.route_hard(x))


@pytest.mark.parametrize("n", [8, 7])
def test_route_sharded_matches_device_binned(dehazers, n):
    """Two `cpu` shards, fidelity: each image through its own branch, as
    JAX's route_device_binned on the whole batch (a batch of 7 pads to 8)."""
    jd, pd = dehazers
    x = images((n, 32, 32, 3), seed=6)
    got = pd.route_sharded(x, devices=["cpu", "cpu"], chunk=2)
    assert got[0].shape[0] == n
    _assert_route(got, jd.route_device_binned(x, chunk=2))
    _assert_route(pd.route_sharded(x, chunk=2), jd.route_device_binned(x, chunk=2))


def test_route_sharded_spill_is_shard_local(dehazers):
    """With spill, each shard applies its own capacity plan: two `cpu`
    shards equal JAX's route_device_binned(spill=True) on each half."""
    jd, pd = dehazers
    x = images((8, 32, 32, 3), seed=7)
    got = pd.route_sharded(x, devices=["cpu", "cpu"], chunk=2, spill=True)
    halves = [jd.route_device_binned(h, chunk=2, spill=True) for h in (x[:4], x[4:])]
    _assert_route(got, tuple(np.concatenate(p) for p in zip(*halves)))


def test_replica_serves_as_the_serving_copy(dehazers):
    """The serving copy built anew for another device (here the CPU again)
    gives the same outputs as the one the dehazer holds."""
    _, pd = dehazers
    x = torch.from_numpy(images((3, 32, 32, 3), seed=8))
    replica = pd._replica(torch.device("cpu"))
    assert replica is not pd._serving
    with torch.inference_mode():
        for level in PR.INTENSITY_ORDER:
            torch.testing.assert_close(replica.models[level](x), pd._serving.models[level](x),
                                       rtol=0, atol=0)
    assert pd._serving_on(torch.device("cpu")) is pd._serving
