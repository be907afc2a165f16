"""Measurement-gated serving dispatch.

Counterpart of adam_dehaze_tpu/serving_autotune.py: every branch has more
than one serving apply that computes the same function, and which is
fastest depends on the device, the toolchain, the dtype, the width and the
batch shape. This module times them at deployment on the device that will
serve, and caches the winner per branch:

    from adam_dehaze_tpu_torch.serving_autotune import load_or_tune
    fn, report = load_or_tune(model, torch.bfloat16, (16, 256, 256, 3),
                              cache_path="exp/serving_autotune.json")

or through the serving API:

    d = AdaptiveDehazer(router, variables, config, autotune=True,
                        autotune_cache="exp/serving_autotune.json")

Candidates, all held to the canonical forward by the tests:

- `canonical` for every branch: the eval forward on a serving copy (conv
  and linear weights cast to the compute dtype), through the branch's
  modules (cuDNN on a CUDA device); for the low branch that is
  `module_forward` (`serving_apply.ModulePathApply`), never kernel K1;
- `chain` for the low branch: kernel K1 on weights folded once;
- `tail_chain` for the medium and the high branch: the prefix canonical,
  everything after the d1 concat on kernel K3 or K4 (the JAX package's
  `s2d_tail_chain`; its space-to-depth prefix is not ported);
- `chain_hybrid` for the medium branch: its three residual segments (after
  each down conv and the first up conv) on kernel K6, all else canonical;
- `res_chain_e2b` for the high branch: the 4c-wide encoder and bottleneck
  segment on K6; and `res_e2b_tail_chain`: that and the tail on K4 (the JAX
  package's `s2d_res_chain_e2b` and `s2d_res_e2b_tail_chain`).

The kernel candidates are offered only for a model on a CUDA device (their
plain versions are a correctness tool, not a serving path) and only at a
width, dtype and sample size the kernels take: that is decided up front,
by `chain_supported` and `chain_apply_supported` (`tail_supported`,
`res_chain_supported`). A kernel candidate that is offered and then fails
to build, to launch or to run raises out of the tuner: the port never gives
way to `canonical` behind a broken kernel. The cache key holds the device,
the torch version, the model class, the width, the dtype, the sample shape
and, on a CUDA device, the hash of the kernels' sources
(`_build._source_hash`), since their speed moves with the sources as a
compiler's does with its version; a cache hit skips all timing.

On the NVIDIA H100 80GB HBM3 in bf16 the kernel candidates win every branch:
`chain`, `tail_chain` and `res_e2b_tail_chain` (PERF.md). The dispatch that
`make_router_serving_apply` builds without tuning is still `chain` /
`canonical` / `canonical`, so tuning serves faster there.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from adam_dehaze_tpu_torch.models.branches import (
    HighIntensityDehazeModel,
    LightweightDehazeModel,
    MediumIntensityDehazeModel,
)
from adam_dehaze_tpu_torch.ops import serving_apply
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import chain_supported


# branch kind -> candidate -> (segments on kernel K6, the tail on K3 or K4).
_CHAIN_CANDIDATES = {
    "medium": {"tail_chain": ((), True),
               "chain_hybrid": (serving_apply.SEGMENTS, False)},
    "high": {"tail_chain": ((), True),
             "res_chain_e2b": (("e2b",), False),
             "res_e2b_tail_chain": (("e2b",), True)},
}


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def candidate_builders(model, dtype: torch.dtype,
                       sample_shape=None) -> Dict[str, Callable]:
    """name -> zero-argument function that builds a serving apply for
    `model`.

    A kernel candidate is offered only where its kernel takes the model's
    width and depth, the dtype and (when given) the sample's height and
    width; a shape it refuses is no candidate at all."""
    canonical = (serving_apply.ModulePathApply if isinstance(model, LightweightDehazeModel)
                 else serving_apply.cast_for_serving)
    cands: Dict[str, Callable] = {"canonical": lambda: canonical(model, dtype)}
    if _device_of(model).type != "cuda":
        return cands
    _, h, w, _ = sample_shape or (1, 4, 4, 3)
    if isinstance(model, LightweightDehazeModel):
        if chain_supported(model.base_channels, model.n_blocks, dtype):
            cands["chain"] = lambda: serving_apply.LightweightChainApply(
                model.serving_chain(dtype))
    elif isinstance(model, (MediumIntensityDehazeModel, HighIntensityDehazeModel)):
        kind = "high" if isinstance(model, HighIntensityDehazeModel) else "medium"
        for name, (segments, tail) in _CHAIN_CANDIDATES[kind].items():
            if serving_apply.chain_apply_supported(model.base_channels, h, w, dtype,
                                                   segments, tail):
                cands[name] = (lambda s=segments, t=tail: serving_apply.BranchChainApply(
                    model, dtype, kind, segments=s, tail=t))
    return cands


def _cache_key(model, dtype: torch.dtype, sample_shape) -> str:
    device = _device_of(model)
    # The device name tells GPU generations apart, the torch version a
    # change of cuDNN, and the sources' hash a change of the port's own
    # kernels: a cached winner is as stale across any of them as across
    # backends.
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device).replace(" ", "_") if cuda else "cpu"
    shape = "x".join(str(int(s)) for s in sample_shape)
    kernels = f":kernels{_build._source_hash()}" if cuda else ""
    return (f"{device.type}:{kind}:torch{torch.__version__}:"
            f"{type(model).__name__}:{getattr(model, 'base_channels', 0)}:"
            f"{str(dtype).replace('torch.', '')}:{shape}{kernels}")


def _read_cache(cache_path: Optional[str]) -> Dict:
    if not cache_path or not os.path.exists(cache_path):
        return {}
    try:
        with open(cache_path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def load_cached(model, dtype: torch.dtype, sample_shape, cache_path):
    """Read-only look at the cache: (apply, entry) when it holds a winner
    for this key that is still offered, else (None, None). Never times,
    never writes. If the cached winner fails to build, that raises."""
    hit = _read_cache(cache_path).get(_cache_key(model, dtype, sample_shape))
    if not hit:
        return None, None
    cands = candidate_builders(model, dtype, sample_shape)
    if hit.get("best") not in cands:
        return None, None
    return cands[hit["best"]](), {**hit, "cached": True}


def _time_ms(fn: Callable, x: torch.Tensor, iters: int, warm: int) -> float:
    """Mean ms of fn(x) over `iters` warm runs: CUDA events around the runs
    on the card, the host clock on the CPU."""
    for _ in range(warm):
        fn(x)
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        return (time.perf_counter() - t0) / iters * 1000.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(x.device)
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    torch.cuda.synchronize(x.device)
    return start.elapsed_time(end) / iters


@torch.inference_mode()
def autotune(model, dtype: torch.dtype, sample_shape, iters: int = 5,
             warm: int = 2, candidates: Optional[Dict[str, Callable]] = None,
             generator: Optional[torch.Generator] = None,
             ) -> Tuple[str, Dict[str, Optional[float]], Callable]:
    """Time every candidate at `sample_shape`, all in the same dtype;
    returns (winner, ms table, the winner's apply, the one that was timed).

    A candidate whose builder refuses the shape up front (a ValueError from
    the builder, before anything ran) lands in the table as None, with the
    refusal under `<name>_error`, and never wins. Any other failure, of a
    build, a launch or a run, raises: a device error leaves the later
    timings worthless, and a broken kernel must not pass as a slow one.
    The sample is uniform noise drawn from `generator` (seed 0 when None)."""
    cands = candidates or candidate_builders(model, dtype, sample_shape)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = torch.rand(tuple(sample_shape), generator=generator).to(_device_of(model))
    table: Dict[str, Optional[float]] = {}
    best: Tuple[Optional[str], float, Optional[Callable]] = (None, float("inf"), None)
    for name, build in cands.items():
        try:
            fn = build()
        except ValueError as e:   # refused by shape, up front
            table[name] = None
            table[f"{name}_error"] = f"{type(e).__name__}: {e}"[:200]
            continue
        ms = _time_ms(fn, x, iters, warm)
        table[name] = round(ms, 4)
        if ms < best[1]:
            best = (name, ms, fn)
    if best[0] is None:
        raise RuntimeError(f"no serving candidate ran: {table}")
    return best[0], table, best[2]


def load_or_tune(model, dtype: torch.dtype, sample_shape,
                 cache_path: Optional[str] = None, iters: int = 5,
                 warm: int = 2):
    """Returns (apply, report). A cache hit on a candidate that is still
    offered skips the timing and builds that candidate (load_cached). On a
    miss every candidate is timed, the winner is returned and the table is
    written to `cache_path`."""
    fn, hit = load_cached(model, dtype, sample_shape, cache_path)
    if fn is not None:
        return fn, hit

    best_name, table, best_fn = autotune(model, dtype, sample_shape, iters=iters,
                                         warm=warm)
    report = {"best": best_name, "table": table, "cached": False}
    if cache_path:
        cache = _read_cache(cache_path)
        cache[_cache_key(model, dtype, sample_shape)] = {"best": best_name, "table": table}
        tmp = cache_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=2, sort_keys=True)
        os.replace(tmp, cache_path)
    return best_fn, report
