"""The serving autotune of the PyTorch port and the autotuned
AdaptiveDehazer, on the CPU.

On the CPU only `canonical` is offered (the kernel candidates are serving
paths of a CUDA device), which is enough for the whole cycle: tune, pick,
cache, reuse; the cases of tests/test_serving_autotune.py. Which kernel
candidates a CUDA device would be offered is read with `_device_of`
patched. The autotuned
dehazer is held against the JAX package's AdaptiveDehazer on the same
variables at ATOL 1e-4 (fp32 vs fp32), and `set_chunk_costs` against the
JAX engine's.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.models import routing as TR
from adam_dehaze_tpu_torch.serving_autotune import (
    _cache_key,
    autotune,
    candidate_builders,
    load_cached,
    load_or_tune,
)
from torch_port_util import ATOL, dehazer_pair, images, init_flax, port_of

SIZE = 32
SHAPE = (2, SIZE, SIZE, 3)
F32 = torch.float32


def _port_model(kind):
    from adam_dehaze_tpu.models import branches as JB
    jcls, pcls, c = {
        "low": (JB.LightweightDehazeModel, PB.LightweightDehazeModel, 8),
        "medium": (JB.MediumIntensityDehazeModel, PB.MediumIntensityDehazeModel, 16),
        "high": (JB.HighIntensityDehazeModel, PB.HighIntensityDehazeModel, 16)}[kind]
    jmodel = jcls(base_channels=c, dtype=jnp.float32)
    vs = init_flax(jmodel, images((1, SIZE, SIZE, 3)), seed=2)
    return jmodel, vs, port_of(pcls(c), vs)


@pytest.fixture(scope="module")
def low_model():
    return _port_model("low")


@pytest.mark.parametrize("kind", ["low", "medium", "high"])
def test_candidates_cpu(kind):
    """The kernel candidates are never offered for a model on the CPU."""
    _, _, port = _port_model(kind)
    assert list(candidate_builders(port, F32)) == ["canonical"]


def test_autotune_picks_a_working_apply(low_model):
    jmodel, vs, port = low_model
    best, table, best_fn = autotune(port, F32, SHAPE, iters=1, warm=1)
    assert best in table and table[best] is not None
    x = images(SHAPE, seed=1)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(x), train=False))
    with torch.inference_mode():
        np.testing.assert_allclose(best_fn(torch.from_numpy(x)).numpy(), want, atol=ATOL)
        fn = candidate_builders(port, F32)[best]()
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want, atol=ATOL)


def test_autotune_skips_broken_candidate(low_model):
    """A builder that refuses the shape up front (ValueError, before
    anything ran) lands as None and never wins."""
    _, _, port = low_model

    def broken():
        raise ValueError("a width the kernel does not take")

    cands = {"broken": broken, **candidate_builders(port, F32)}
    best, table, _ = autotune(port, F32, SHAPE, iters=1, warm=1, candidates=cands)
    assert best != "broken"
    assert table["broken"] is None
    assert "ValueError" in table["broken_error"]


@pytest.mark.parametrize("where", ["build", "run"])
def test_autotune_raises_on_a_candidate_that_fails(low_model, where):
    """A candidate that was offered and then fails to build (the compiler)
    or to run (a launch) raises: the tuner never serves `canonical` behind
    a broken kernel."""
    _, _, port = low_model

    def fails(*_):
        raise RuntimeError("nvcc failed")

    broken = fails if where == "build" else (lambda: fails)
    cands = {**candidate_builders(port, F32), "broken": broken}
    with pytest.raises(RuntimeError, match="nvcc failed"):
        autotune(port, F32, SHAPE, iters=1, warm=1, candidates=cands)


@pytest.mark.parametrize("kind,shape,dtype,want", [
    ("medium", SHAPE, F32, ["canonical", "tail_chain", "chain_hybrid"]),
    ("high", SHAPE, torch.bfloat16,
     ["canonical", "tail_chain", "res_chain_e2b", "res_e2b_tail_chain"]),
    ("high", None, F32, ["canonical", "tail_chain", "res_chain_e2b", "res_e2b_tail_chain"]),
    ("medium", (2, 30, 32, 3), F32, ["canonical"]),      # the forward resizes
    ("high", SHAPE, torch.float16, ["canonical"]),
    ("low", SHAPE, F32, ["canonical", "chain"])])
def test_kernel_candidates_are_decided_up_front(monkeypatch, kind, shape, dtype, want):
    """For a model on a CUDA device a kernel candidate is offered exactly
    where its kernel takes the width, the dtype and the sample size."""
    from adam_dehaze_tpu_torch import serving_autotune
    _, _, port = _port_model(kind)
    monkeypatch.setattr(serving_autotune, "_device_of", lambda m: torch.device("cuda"))
    assert list(candidate_builders(port, dtype, shape)) == want
    narrow = PB.LightweightDehazeModel(12, 2)    # K1 wants a multiple of 8
    assert list(candidate_builders(narrow, dtype, shape)) == ["canonical"]


@pytest.mark.parametrize("cls,c,shape,want", [
    # The tail wants c >= 16; the e2b segment is 4c = 32 wide.
    (PB.HighIntensityDehazeModel, 8, SHAPE, ["canonical", "res_chain_e2b"]),
    # 4c = 16 is the narrowest segment K6 takes.
    (PB.HighIntensityDehazeModel, 4, SHAPE, ["canonical", "res_chain_e2b"]),
    (PB.HighIntensityDehazeModel, 2, SHAPE, ["canonical"]),
    # chain_hybrid needs all three segments: 2c = 16 at the least.
    (PB.MediumIntensityDehazeModel, 8, SHAPE, ["canonical", "chain_hybrid"]),
    (PB.MediumIntensityDehazeModel, 4, SHAPE, ["canonical"]),
    (PB.MediumIntensityDehazeModel, 12, SHAPE, ["canonical"]),     # 24 is no multiple of 16
    (PB.HighIntensityDehazeModel, 16, (2, 32, 34, 3), ["canonical"])])
def test_res_chain_candidates_follow_the_shape_selectors(monkeypatch, cls, c, shape, want):
    """`chain_hybrid`, `res_chain_e2b` and `res_e2b_tail_chain` are offered
    exactly where `res_chain_supported` takes every segment they put on K6
    and, for the last, `tail_supported` takes the tail."""
    from adam_dehaze_tpu_torch import serving_autotune
    monkeypatch.setattr(serving_autotune, "_device_of", lambda m: torch.device("cuda"))
    assert list(candidate_builders(cls(c), F32, shape)) == want


def test_cached_res_e2b_tail_chain_winner_is_rebuilt(monkeypatch, tmp_path):
    """A cache that names `res_e2b_tail_chain` gives that apply back without
    timing: the e2b segment on K6 and the tail on K4 (their plain versions
    here, since the tensors lie on the CPU)."""
    import types

    from adam_dehaze_tpu_torch import serving_autotune
    from adam_dehaze_tpu_torch.ops.serving_apply import BranchChainApply
    jmodel, vs, port = _port_model("high")
    monkeypatch.setattr(serving_autotune, "_device_of",
                        lambda m: types.SimpleNamespace(type="cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some GPU")
    key = _cache_key(port, F32, SHAPE)
    assert key.startswith("cuda:Some_GPU:")
    cache = str(tmp_path / "autotune.json")
    table = {"canonical": 2.0, "tail_chain": 3.0, "res_chain_e2b": 1.5,
             "res_e2b_tail_chain": 1.0}
    with open(cache, "w") as f:
        json.dump({key: {"best": "res_e2b_tail_chain", "table": table}}, f)
    fn, hit = load_cached(port, F32, SHAPE, cache)
    assert hit == {"best": "res_e2b_tail_chain", "table": table, "cached": True}
    assert isinstance(fn, BranchChainApply)
    assert fn.segments == ("e2b",) and fn.tail is not None
    x = images(SHAPE, seed=3)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(x), train=False))
    with torch.inference_mode():
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want, atol=ATOL)


def test_autotune_raises_when_no_candidate_runs(low_model):
    _, _, port = low_model

    def broken():
        raise ValueError("nope")

    with pytest.raises(RuntimeError, match="no serving candidate ran"):
        autotune(port, F32, SHAPE, iters=1, warm=1, candidates={"broken": broken})


def test_autotune_sample_comes_from_the_generator(low_model):
    """The timing sample is drawn from the explicit generator: the same
    seed gives the same sample, whatever the global RNG did."""
    _, _, port = low_model
    seen = []

    def spy():
        return lambda x: seen.append(x.clone()) or x

    for _ in range(2):
        torch.rand(3)   # moves the global generator only
        autotune(port, F32, SHAPE, iters=1, warm=0, candidates={"spy": spy},
                 generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(seen[0], seen[1], rtol=0, atol=0)
    assert tuple(seen[0].shape) == SHAPE and 0 <= float(seen[0].min()) <= 1


def test_load_or_tune_caches(low_model, tmp_path):
    _, _, port = low_model
    cache = str(tmp_path / "autotune.json")
    fn1, rep1 = load_or_tune(port, F32, SHAPE, cache_path=cache, iters=1, warm=1)
    assert rep1["cached"] is False
    with open(cache) as f:
        stored = json.load(f)
    assert list(stored) == [_cache_key(port, F32, SHAPE)]
    fn2, rep2 = load_or_tune(port, F32, SHAPE, cache_path=cache, iters=1, warm=1)
    assert rep2["cached"] is True and rep2["best"] == rep1["best"]
    assert rep2["table"] == rep1["table"]
    x = torch.from_numpy(images(SHAPE, seed=1))
    with torch.inference_mode():
        torch.testing.assert_close(fn1(x), fn2(x), rtol=0, atol=1e-6)


def test_load_cached_read_only(low_model, tmp_path):
    """load_cached gives (None, None) on a miss without creating the cache,
    and the winner after a tune; it never times or writes."""
    jmodel, vs, port = low_model
    cache = str(tmp_path / "autotune.json")
    assert load_cached(port, F32, SHAPE, cache) == (None, None)
    assert not os.path.exists(cache)
    _, rep = load_or_tune(port, F32, SHAPE, cache_path=cache, iters=1, warm=1)
    mtime = os.path.getmtime(cache)
    fn, hit = load_cached(port, F32, SHAPE, cache)
    assert hit["best"] == rep["best"] and hit["cached"] is True
    assert os.path.getmtime(cache) == mtime
    x = images(SHAPE, seed=1)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(x), train=False))
    with torch.inference_mode():
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want, atol=ATOL)


def test_cache_key_distinguishes_shape_dtype_and_width(low_model, tmp_path):
    _, _, port = low_model
    cache = str(tmp_path / "autotune.json")
    load_or_tune(port, F32, SHAPE, cache_path=cache, iters=1, warm=1)
    load_or_tune(port, F32, (1, SIZE, SIZE, 3), cache_path=cache, iters=1, warm=1)
    load_or_tune(port, torch.bfloat16, SHAPE, cache_path=cache, iters=1, warm=1)
    with open(cache) as f:
        assert len(json.load(f)) == 3
    key = _cache_key(port, F32, SHAPE)
    assert key == (f"cpu:cpu:torch{torch.__version__}:LightweightDehazeModel:8:"
                   f"float32:2x32x32x3")
    assert _cache_key(PB.LightweightDehazeModel(16, 2), F32, SHAPE) != key


def test_cache_hit_on_a_candidate_not_offered_retunes(low_model, tmp_path):
    """A cache written where a kernel candidate won (a CUDA device) names a
    candidate this device does not offer: tune again, and replace it."""
    _, _, port = low_model
    cache = str(tmp_path / "autotune.json")
    key = _cache_key(port, F32, SHAPE)
    with open(cache, "w") as f:
        json.dump({key: {"best": "chain", "table": {"chain": 1.0}}}, f)
    assert load_cached(port, F32, SHAPE, cache) == (None, None)
    _, rep = load_or_tune(port, F32, SHAPE, cache_path=cache, iters=1, warm=1)
    assert rep["cached"] is False and rep["best"] == "canonical"
    with open(cache) as f:
        assert json.load(f)[key]["best"] == "canonical"


def test_unreadable_cache_is_a_miss(low_model, tmp_path):
    _, _, port = low_model
    cache = tmp_path / "autotune.json"
    cache.write_text("{not json")
    _, rep = load_or_tune(port, F32, SHAPE, cache_path=str(cache), iters=1, warm=1)
    assert rep["cached"] is False
    assert json.loads(cache.read_text())


# ---- the autotuned dehazer ---------------------------------------------------

@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("tune") / "autotune.json")
    jd, pd = dehazer_pair(autotune=True, autotune_cache=cache)
    return jd, pd, cache


def test_autotuned_dehazer_reports_and_caches(tuned):
    _, pd, cache = tuned
    assert set(pd.autotune_report) == set(TR.INTENSITY_ORDER)
    for report in pd.autotune_report.values():
        assert report["best"] == "canonical" and report["cached"] is False
        assert report["table"]["canonical"] > 0
    with open(cache) as f:
        stored = json.load(f)
    assert len(stored) == 3 and all(":16x32x32x3" in k for k in stored)
    # The tuned applies took the serving copy's branches, for soft and hard.
    assert pd.engine.branch_applies == [pd._serving.models[n] for n in TR.INTENSITY_ORDER]


def test_autotuned_dehazer_matches_jax(tuned):
    jd, pd, _ = tuned
    x = images((6, 32, 32, 3), seed=1)
    want, want_i = jd.route_hard(x)
    got, got_i = pd.route_hard(x)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got, want, atol=ATOL)
    labels = np.arange(6) % 3
    want_f, _ = jd._binned_engine()(jnp.asarray(x), intensity=labels)
    with torch.inference_mode():
        got_f, _ = pd.engine(torch.from_numpy(x), intensity=labels)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=ATOL)
    xs = images((3, 32, 32, 3), seed=4)
    np.testing.assert_allclose(pd(xs), jd(xs), atol=ATOL)


def test_second_dehazer_reads_the_cache(tuned):
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
    _, pd, cache = tuned
    again = AdaptiveDehazer(pd.router, None, pd.config, device="cpu", autotune=True,
                            autotune_cache=cache)
    for level, report in again.autotune_report.items():
        assert report["cached"] is True
        assert report["table"] == pd.autotune_report[level]["table"]
    x = images((3, 32, 32, 3), seed=6)
    np.testing.assert_allclose(again(x), pd(x), atol=1e-6)


def test_autotune_feeds_the_chunk_planner(tuned):
    """The engine's per-class overhead is the branch's dispatch cost over
    the winner's ms per row, as the JAX dehazer computes it from its table
    (there with one dispatch cost for every branch); a fresh tuning run
    measured each branch's dispatch cost (`dispatch_ms`) where its line
    rose, and DISPATCH_MS stands in where it did not."""
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
    _, pd, _ = tuned
    assert set(AdaptiveDehazer.DISPATCH_MS) == set(TR.INTENSITY_ORDER)
    want = []
    for level in TR.INTENSITY_ORDER:
        rep = pd.autotune_report[level]
        # Measured unless the 2-row time did not fall below the 16-row one.
        dispatch = rep.get("dispatch_ms", AdaptiveDehazer.DISPATCH_MS[level])
        assert dispatch >= 1e-3
        row = max(rep["table"][rep["best"]] - dispatch, 1e-6) / 16.0
        want.append(dispatch / max(row, 1e-6))
    assert pd.engine.program_overhead_rows == pytest.approx(want)


def test_default_dehazer_keeps_the_scalar_overhead():
    engine = TR.BinnedAdaptiveEngine(lambda x: x, [lambda x: x] * 3)
    assert engine.program_overhead_rows == [2.0, 2.0, 2.0]


@pytest.mark.parametrize("dispatch_ms,row_ms", [
    (0.35, [0.25, 0.5, 1.2]), (0.35, [0.01, 0.0, 3.0]), (1.0, [2.0, 2.0, 2.0])])
def test_set_chunk_costs_matches_jax(dispatch_ms, row_ms):
    jeng = JR.BinnedAdaptiveEngine(lambda x: x, [lambda x: x] * 3)
    peng = TR.BinnedAdaptiveEngine(lambda x: x, [lambda x: x] * 3)
    jeng.set_chunk_costs(dispatch_ms, row_ms)
    peng.set_chunk_costs(dispatch_ms, row_ms)
    assert peng.program_overhead_rows == pytest.approx(jeng.program_overhead_rows)
    for n in (3, 18, 37):
        for cls in range(3):
            assert (TR.plan_chunks(n, peng.buckets, peng.program_overhead_rows[cls])
                    == JR.plan_chunks(n, jeng.buckets, jeng.program_overhead_rows[cls]))


def test_set_chunk_costs_takes_one_dispatch_cost_per_class():
    eng = TR.BinnedAdaptiveEngine(lambda x: x, [lambda x: x] * 3)
    eng.set_chunk_costs([0.2, 1.2, 2.4], [0.25, 0.5, 1.2])
    assert eng.program_overhead_rows == pytest.approx([0.8, 2.4, 2.0])
    with pytest.raises(ValueError):
        eng.set_chunk_costs([0.2, 1.2], [0.25, 0.5, 1.2])
