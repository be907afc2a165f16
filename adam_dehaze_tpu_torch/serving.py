"""High-level serving API of the port: load an experiment and dehaze images.

Counterpart of adam_dehaze_tpu/serving.py:

    dehazer = AdaptiveDehazer.from_experiment("experiments/exp1")
    out = dehazer(images_nhwc_float01)            # soft routing
    out, intensity = dehazer.route_hard(images)   # binned hard routing
    out, intensity = dehazer.route_device_binned(images)   # binned on the card
    for out, intensity in dehazer.route_device_binned_stream(batches): ...

    dehazer = AdaptiveDehazer(router, variables, config, device="cuda",
                              autotune=True, autotune_cache="exp/tune.json")
    dehazer.autotune_report    # per branch: the winner, the ms table, dispatch_ms, cached

`from_experiment` reads an experiment directory of the port's own
checkpoints (`config.yaml`, `checkpoints/joint/best_model.pth`, as
`evaluation/evaluate.py:_load_joint` reads them; export_jax_experiment.py
writes one from a JAX experiment), with `serving_autotune.json` as the
autotune cache and `resolution_policy.json` as the tuned resolution policy.

With `autotune=True` every branch's apply is the winner of a timing run on
the serving device at (16, img_size, img_size, 3) (serving_autotune.py),
read from `autotune_cache` when that file already holds it. On a CUDA device
the run times `canonical` and `chain` for the low branch, `canonical`,
`tail_chain` and `chain_hybrid` for the medium one, and `canonical`,
`tail_chain`, `res_chain_e2b` and `res_e2b_tail_chain` for the high one.

The routes map onto the engines of models/routing.py as in the JAX package:
`route_hard` (host binning), `route_hard_stream` (the same, the classifier
pipelined over a stream), `route_hard_queued` (per-class queues across
batches), `route_device_binned` and `route_device_binned_stream` (the
binning on the device; one read of K chunk classes a batch), `route_switch`
(each image at batch 1 through its own branch) and `route_sharded` (one
shard per device). All of them serve through the one serving copy, the
tuned winners under `autotune=True`.

`route_hard` and `route_hard_stream` take `lowres`, the half-resolution
dial (ops/resolution.py): `("high",)` serves those branches at half
resolution with a guided-filter lift of the correction, a dict gives each
level its {scale, mode, radius}, "auto" reads the experiment's tuned
policy (resolution_autotune.py), `()` is full resolution and None the
construction-time default (`lowres=` of the constructor). Each distinct
dial has an engine of its own, over the same serving applies.

Images go in and come out as numpy NHWC float32 in [0, 1] (`route_hard_queued`
yields device tensors, as the JAX route yields device arrays). Everything
runs in eval mode, under torch.inference_mode, in the config's
`cuda.compute_dtype`.

Int8 serving (ops/quant.py), as in the JAX package: with
`cuda.serving_quant: int8` every hard route (route_hard and its stream and
queued forms, the device-binned routes, route_switch, route_sharded and its
replicas) serves each branch's int8 copy: its ConvBlock convolutions on
kernels Q1 and Q2, everything else in the compute dtype, the low branch
through its modules (never K1), the high one with K2 in its
AttentionBlocks. The soft call and the classifier stay unquantized, the
serving autotune is skipped for the branches, and `export_precompiled`
refuses. Under `make_spatial_infer` and `channel_sharding` (parallel/) the
int8 copies take their shards (ops/quant.py). Any other `serving_quant`
value is served unquantized, with a warning.

Precompiled serving (serving_export.py), as in the JAX package:

    d.export_precompiled("experiments/x/precompiled")
    d2 = AdaptiveDehazer.from_experiment("experiments/x", precompiled="auto")

`export_precompiled` writes the bundle of the full-resolution binned
engine's programs (classify, logits, each class's bucket step over the
bucket ladder, each branch at the queue buckets) and of the device-binned
engine's (its binning, its chunks' branch calls). A dehazer given a bundle
attaches it to those engines as they are built, never to a half-resolution
one; on the card each program is a CUDA graph captured at attach. A bundle
exported under another quant mode or autotune setting, or on another
runtime, is refused with a warning and serving goes on eagerly.
"""
from __future__ import annotations

import copy
import os
import warnings
from collections import deque
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import compute_dtype, load_config, update_checkpoint_paths
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    BinnedAdaptiveEngine,
    DeviceBinnedInfer,
    _HostRead,
    bucket_for,
    make_adaptive_infer,
    make_device_binned_infer,
    make_sharded_binned_infer,
)
from adam_dehaze_tpu_torch.ops.quant import quantize_apply
from adam_dehaze_tpu_torch.ops.resolution import make_lowres_apply
from adam_dehaze_tpu_torch.ops.serving_apply import make_router_serving_apply
from adam_dehaze_tpu_torch.resolution_autotune import load_policy, policy_to_lowres
from adam_dehaze_tpu_torch.serving_autotune import candidate_builders, load_or_tune
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables


class AdaptiveDehazer:
    """router: a SoftRouter or HardRouter of the port (its classifier and
    the three branches). variables: the JAX package's {"params",
    "batch_stats"} tree to load into it, or None to serve the router's own
    weights. The router is moved to `device` in place; one serving copy of
    it (weights cast, the low branch folded for K1) backs both the soft
    call and the hard-routing engines; under `cuda.serving_quant: int8` the
    hard routes serve int8 copies of the branches beside its classifier
    (`_hard`). autotune (ignored under int8): replace that copy's branches
    by the timed winners of serving_autotune.load_or_tune
    (`autotune_report[level]` holds each report; `autotune_cache` is the
    JSON file that keeps the winners between processes), and feed the
    winners' times to the full-resolution engine's chunk planner.
    resolution_policy: the tuned policy file that lowres="auto" reads;
    lowres: the default dial of route_hard and route_hard_stream.
    precompiled: a bundle directory written by `export_precompiled`, whose
    programs back the full-resolution binned engine and the device-binned
    engines (see the module's docstring)."""

    # What one more bucket of each branch costs, in ms: the part of a branch
    # call that does not grow with its rows (mostly the host's enqueue of
    # its launches). Under autotune `_chunk_costs` feeds the report's
    # measured `dispatch_ms` (serving_autotune.dispatch_ms) to the chunk
    # planner. These constants stand in where the report has none: a cache
    # entry written before the tuner measured it, or a winner whose time at
    # 2 rows did not fall below its time at 16. They are chip_smoke.py's
    # [dispatch tuned bf16] intercepts over 1-32 rows on an NVIDIA H100 80GB
    # HBM3 at 700 W, bf16, 256^2, the winners chain, tail_chain and
    # res_e2b_tail_chain; the median of three runs (PERF.md).
    DISPATCH_MS = {"low": 0.19, "medium": 2.79, "high": 2.78}

    def __init__(self, router, variables, config, device="cuda",
                 autotune: bool = False, autotune_cache: Optional[str] = None,
                 resolution_policy: Optional[str] = None, lowres=(),
                 precompiled: Optional[str] = None):
        if variables is not None:
            load_flax_variables(router, variables)
        self.device = torch.device(device)
        self.config = config
        self._autotune = autotune
        # The config's serving_quant; only "int8" quantizes (as in the JAX
        # package, another value serves unquantized).
        self.quant = config.get("cuda", {}).get("serving_quant") or None
        if self.quant not in (None, "int8"):
            warnings.warn(f"cuda.serving_quant={self.quant!r} is not a quantization mode "
                          "(only 'int8' is): the branches are served unquantized")
        # The bundle's programs (serving_export.py), attached to the engines
        # as they are built; their dispatchers by program name, and the pool
        # their graphs share. Loaded first: on the card it points the kernel
        # library at the bundle's copy.
        self._bundle_table = self._load_bundle(precompiled) if precompiled else None
        self._dispatches: Dict[str, Callable] = {}
        self._graph_pool = None
        self.router = router.to(self.device).eval()
        self.dtype = compute_dtype(config)
        # The soft call's serving copy, never quantized; `_hard` is what the
        # hard routes serve (its branches in int8 under int8 serving).
        self._serving = make_router_serving_apply(self.router, self.dtype)
        self._hard = self._hard_serving(self._serving, self.router)
        self._engines: Dict[str, Callable] = {}
        self._replicas: Dict[torch.device, object] = {}
        self._resolution_policy_path = resolution_policy
        # () = full resolution; "auto" = the tuned policy. A route's own
        # `lowres=` overrides it.
        self._default_lowres = lowres
        self.autotune_report: Dict[str, dict] = {}
        if autotune and self.quant != "int8":
            self._serving.models.update(self._tuned_applies(autotune_cache))

    def _hard_serving(self, serving: torch.nn.Module, router: torch.nn.Module):
        """What the hard routes serve from a serving copy of `router`: the
        copy itself, or under int8 its classifier beside the int8 copy of
        each branch (ops/quant.py:quantize_apply)."""
        if self.quant != "int8":
            return serving
        return SimpleNamespace(classifier=serving.classifier, models={
            lvl: quantize_apply(router.models[lvl], self.dtype) for lvl in INTENSITY_ORDER})

    @classmethod
    def from_experiment(cls, experiment_dir: str, config_path: Optional[str] = None,
                        autotune: bool = False, precompiled: Optional[str] = None,
                        lowres=(), device="cuda") -> "AdaptiveDehazer":
        """The dehazer of an experiment directory: its config.yaml (or
        `config_path`), its best joint checkpoint (`_load_joint`), the
        autotune cache `serving_autotune.json` and the resolution policy
        `resolution_policy.json` in it. lowres="auto" makes the tuned policy
        the default dial of route_hard and route_hard_stream. precompiled:
        a bundle written by `export_precompiled`, or "auto" for
        `<experiment_dir>/precompiled` when it exists."""
        if precompiled == "auto":
            cand = os.path.join(experiment_dir, "precompiled")
            precompiled = cand if os.path.isdir(cand) else None
        cfg_file = config_path or os.path.join(experiment_dir, "config.yaml")
        config = load_config(cfg_file if os.path.exists(cfg_file) else None)
        config = update_checkpoint_paths(config, experiment_dir)
        from adam_dehaze_tpu_torch.evaluation.evaluate import _load_joint
        return cls(_load_joint(config, device), None, config, device=device,
                   autotune=autotune,
                   autotune_cache=os.path.join(experiment_dir, "serving_autotune.json"),
                   resolution_policy=os.path.join(experiment_dir, "resolution_policy.json"),
                   lowres=lowres, precompiled=precompiled)

    def _load_bundle(self, bundle_dir: str):
        """The bundle's programs, or None (with a warning) for a bundle of
        another quant mode, autotune setting or runtime: the JAX package's
        refusal rules."""
        from adam_dehaze_tpu_torch.serving_export import load_bundle_programs, read_manifest
        extra = (read_manifest(bundle_dir) or {}).get("extra", {})
        try:
            if extra.get("quant") != self.quant:
                raise ValueError(f"bundle quant={extra.get('quant')!r} != config "
                                 f"quant={self.quant!r} (results would differ)")
            if bool(extra.get("autotune", False)) != bool(self._autotune):
                raise ValueError(f"bundle autotune={extra.get('autotune')!r} != requested "
                                 f"autotune={self._autotune!r} (the tuned dispatch may "
                                 "differ from the exported programs)")
            return load_bundle_programs(bundle_dir, self.device)
        except (ValueError, OSError) as e:
            warnings.warn(f"ignoring precompiled bundle {bundle_dir}: {e}")
            return None

    def _attach(self, engine) -> None:
        """Back `engine`'s programs by the bundle's (attach_engine), each
        program bound to the serving module it runs."""
        from adam_dehaze_tpu_torch.serving_export import GraphPool, attach_engine
        clf = (self._hard.classifier,)
        binds = {"classify": clf, "logits": clf}
        for i, lvl in enumerate(INTENSITY_ORDER):
            binds[f"step{i}"] = binds[f"branch{i}"] = (self._hard.models[lvl],)
        if isinstance(engine, DeviceBinnedInfer):
            binds[f"device{engine.chunk}_{int(engine.spill)}"] = clf
        if self._graph_pool is None and self.device.type == "cuda":
            self._graph_pool = GraphPool(self.device)
        attach_engine(engine, self._bundle_table, binds, device=self.device,
                      pool=self._graph_pool, shared=self._dispatches)

    def _tuned_applies(self, cache_path: Optional[str]) -> Dict[str, torch.nn.Module]:
        """The tuned serving apply of every branch, by level; fills
        `autotune_report`."""
        img = self.config["dataset"]["img_size"]
        applies = {}
        for level in INTENSITY_ORDER:
            applies[level], self.autotune_report[level] = load_or_tune(
                self.router.models[level], self.dtype, (16, img, img, 3),
                cache_path=cache_path)
        return applies

    def _chunk_costs(self) -> Optional[Tuple[list, list]]:
        """(ms per bucket, ms per row) of each branch: the report's measured
        `dispatch_ms` (DISPATCH_MS where the report has none), and the
        winner's time per 16 images in the autotune table less one
        dispatch; None without the tables."""
        dispatch_ms, row_ms = [], []
        for level in INTENSITY_ORDER:
            report = self.autotune_report.get(level) or {}
            ms16 = (report.get("table") or {}).get(report.get("best"))
            if not ms16:
                return None
            fixed = float(report.get("dispatch_ms", self.DISPATCH_MS[level]))
            dispatch_ms.append(fixed)
            row_ms.append(max(float(ms16) - fixed, 1e-6) / 16.0)
        return dispatch_ms, row_ms

    def _to_device(self, images) -> torch.Tensor:
        if isinstance(images, torch.Tensor):    # a device tensor (parallel/spatial.py)
            return images.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(images, np.float32)).to(self.device)

    @staticmethod
    def _norm_lowres(lowres) -> Dict[str, dict]:
        """The `lowres` argument as {level: {scale, mode, radius}}: a tuple
        or list of levels (scale 2, guided, radius 4), or a dict of
        per-level parameters (the tuned policy's form,
        resolution_autotune.policy_to_lowres)."""
        if not lowres:
            return {}
        if isinstance(lowres, dict):
            return {lvl: {"scale": int(p.get("scale", 2)), "mode": p.get("mode", "guided"),
                          "radius": int(p.get("radius", 4))}
                    for lvl, p in lowres.items()}
        return {lvl: {"scale": 2, "mode": "guided", "radius": 4} for lvl in lowres}

    def _resolution_policy_lowres(self) -> Dict[str, dict]:
        """lowres="auto": the per-level dial of the experiment's tuned
        policy. Raises when there is none: a silent fall back to full
        resolution would misreport the serving mode asked for."""
        if not self._resolution_policy_path:
            raise ValueError(
                "lowres='auto' needs an experiment-backed dehazer "
                "(from_experiment) with a tuned resolution policy")
        policy = load_policy(self._resolution_policy_path)
        if policy is None:
            raise FileNotFoundError(
                f"no resolution policy at {self._resolution_policy_path}; run "
                "python -m adam_dehaze_tpu_torch.tools.autotune_resolution "
                "--experiment <dir> first")
        return policy_to_lowres(policy)

    def _resolve_lowres(self, lowres):
        """None -> the construction-time default; "auto" -> the tuned
        policy; anything else as it is (() is full resolution)."""
        if lowres is None:
            lowres = self._default_lowres
        if isinstance(lowres, str) and lowres == "auto":
            lowres = self._resolution_policy_lowres()
        return lowres

    def _branch_applies(self, lowres=()) -> list:
        """The hard routes' applies of the branches in INTENSITY_ORDER (the
        int8 copies under int8 serving), those named in `lowres` wrapped by
        make_lowres_apply (see _norm_lowres)."""
        lowres = self._norm_lowres(lowres)
        return [make_lowres_apply(self._hard.models[lvl], **lowres[lvl])
                if lvl in lowres else self._hard.models[lvl]
                for lvl in INTENSITY_ORDER]

    def _binned_engine(self, lowres=()) -> BinnedAdaptiveEngine:
        """The binned engine of one dial, built on first use and kept under
        the JAX package's key ("binned", or "binned_lowres_" and each
        level's scale, mode and radius). Only the full-resolution engine
        gets the tuned chunk costs: the winners were timed at full
        resolution, and a half-resolution branch costs a fraction of that."""
        lowres = self._norm_lowres(lowres)
        key = ("binned" if not lowres else "binned_lowres_" + "_".join(
            f"{lvl}-{p['scale']}-{p['mode']}-{p['radius']}"
            for lvl, p in sorted(lowres.items())))
        if key not in self._engines:
            engine = BinnedAdaptiveEngine(self._hard.classifier,
                                          self._branch_applies(lowres))
            costs = self._chunk_costs()
            if costs is not None and not lowres:
                engine.set_chunk_costs(*costs)
            # Only the full-resolution engine: a half-resolution one computes
            # other math behind the same input signatures.
            if self._bundle_table and key == "binned":
                self._attach(engine)
            self._engines[key] = engine
        return self._engines[key]

    @property
    def engine(self) -> BinnedAdaptiveEngine:
        """The full-resolution binned hard-routing engine."""
        return self._binned_engine()

    @torch.inference_mode()
    def __call__(self, images) -> np.ndarray:
        """Soft-routed dehazing: (N, H, W, 3) float [0, 1] -> same."""
        dehazed, _ = self._serving(self._to_device(images))
        return dehazed.float().cpu().numpy()

    @torch.inference_mode()
    def route_hard(self, images, spill=False, lowres=None) -> Tuple[np.ndarray, np.ndarray]:
        """Binned hard routing: each image pays only its own branch. spill:
        see BinnedAdaptiveEngine.__call__. lowres: the half-resolution dial
        (see the module's docstring; None is the construction default).
        Returns (dehazed, intensity)."""
        engine = self._binned_engine(self._resolve_lowres(lowres))
        out, intensity = engine(self._to_device(images), spill=spill)
        return out.cpu().numpy(), np.asarray(intensity)

    @torch.inference_mode()
    def route_hard_stream(self, batches, spill=False, lowres=None):
        """Pipelined serving over an iterable of batches: the classifier of
        batch k+1 overlaps batch k's host binning
        (BinnedAdaptiveEngine.run_stream). lowres: as in route_hard. Yields
        (dehazed, intensity) as numpy."""
        engine = self._binned_engine(self._resolve_lowres(lowres))
        uploads = (self._to_device(x) for x in batches)
        for out, intensity in engine.run_stream(uploads, spill=spill):
            yield out.cpu().numpy(), np.asarray(intensity)

    @torch.inference_mode()
    def route_hard_queued(self, batches, queue_bucket: int = 16, flush: bool = True,
                          max_wait_batches: Optional[int] = None):
        """Continuous batching for class-clumped traffic: images queue per
        predicted class across batches and a branch runs on full buckets of
        its class (BinnedAdaptiveEngine.run_queued; `max_wait_batches`
        bounds an image's wait). Yields (dehazed device tensor,
        global_indices, cls) per bucket."""
        uploads = (self._to_device(x) for x in batches)
        yield from self.engine.run_queued(uploads, queue_bucket=queue_bucket, flush=flush,
                                          max_wait_batches=max_wait_batches)

    def _device_binned_fn(self, chunk: int, spill: bool):
        key = f"device_binned_{chunk}_{spill}"
        if key not in self._engines:
            fn = make_device_binned_infer(self._hard.classifier, self._branch_applies(),
                                          chunk=chunk, spill=spill)
            if self._bundle_table:
                self._attach(fn)
            self._engines[key] = fn
        return self._engines[key]

    @torch.inference_mode()
    def route_device_binned(self, images, chunk: int = 16, spill: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Hard routing with the binning on the device
        (models/routing.py:DeviceBinnedInfer): one read of the chunk
        classes a call, no read of the labels. spill=True applies the
        on-device capacity plan. Returns (dehazed, intensity)."""
        out, intensity, _ = self._device_binned_fn(chunk, spill)(self._to_device(images))
        return out.cpu().numpy(), intensity.cpu().numpy()

    # Batch sizes of route_device_binned_stream: a ragged batch is padded up
    # to the nearest (bucket_for, extend=True: beyond the largest, to a
    # multiple of it), so the branches see a few batch shapes only.
    STREAM_BUCKETS = (1, 2, 4, 8, 16, 32, 48, 64)

    def _bucket_batch(self, n: int, buckets) -> int:
        return bucket_for(n, buckets, extend=True)

    @torch.inference_mode()
    def route_device_binned_stream(self, batches, chunk: int = 16, depth: int = 2,
                                   buckets=None, spill: bool = False):
        """Device-binned serving over a stream, `depth` batches enqueued
        ahead: each batch goes up through a pinned staging buffer (padded
        with its last image to a size in `buckets`, STREAM_BUCKETS by
        default), its classifier and binning are enqueued, and its chunk
        classes are read once `depth` binned batches wait (with depth 2,
        after the next batch's classifier is enqueued); its results come
        down to pinned memory behind an event and are yielded after the
        next batch's branches are enqueued. Yields (dehazed,
        intensity) as numpy, the pad rows sliced off."""
        fn = self._device_binned_fn(chunk, spill)
        buckets = tuple(sorted(buckets or self.STREAM_BUCKETS))
        staging = _StagingRing(self.device, depth + 1)
        binned, fetching = deque(), deque()

        def serve(item):
            binning, n = item
            out, intensity, _ = fn.serve(binning)
            return _HostRead(out[:n]), _HostRead(intensity[:n])

        for x in batches:
            x = np.asarray(x, np.float32)
            n = x.shape[0]
            binned.append((fn.bin(staging.upload(x, self._bucket_batch(n, buckets))), n))
            if len(binned) >= depth:
                fetching.append(serve(binned.popleft()))
            if len(fetching) > 1:
                yield tuple(r.get() for r in fetching.popleft())
        while binned:
            fetching.append(serve(binned.popleft()))
        while fetching:
            yield tuple(r.get() for r in fetching.popleft())

    @torch.inference_mode()
    def route_switch(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """Each image through its own branch at batch 1 (the lowest latency
        for one image; make_adaptive_infer "switch")."""
        if "switch" not in self._engines:
            self._engines["switch"] = make_adaptive_infer(
                self._hard.classifier, self._branch_applies(), "switch")
        out, intensity = self._engines["switch"](self._to_device(images))
        return out.cpu().numpy(), intensity.cpu().numpy()

    @torch.inference_mode()
    def route_sharded(self, images, devices=None, chunk: int = 16, spill: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Data-parallel serving: the device-binned engine on one shard per
        device (models/routing.py:make_sharded_binned_infer; binning and
        spill local to each shard, no collective). devices: a list of
        torch devices; None is every visible CUDA device, or [self.device]
        on the CPU. Each device serves from its own replica of what the
        hard routes serve (`_hard`). A ragged batch is padded with its last
        image to the ladder (n_dev,) + STREAM_BUCKETS * n_dev. Returns
        (dehazed, intensity)."""
        if devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        devices = [torch.device(d) for d in devices]
        n_dev = len(devices)
        key = f"sharded_{[str(d) for d in devices]}_{chunk}_{spill}"
        if key not in self._engines:
            self._engines[key] = make_sharded_binned_infer(
                self._replicated(lambda s: s.classifier),
                [self._replicated(lambda s, lvl=lvl: s.models[lvl]) for lvl in INTENSITY_ORDER],
                devices, chunk=chunk, spill=spill)
        images = np.asarray(images, np.float32)
        n = images.shape[0]
        ladder = sorted({n_dev, *(b * n_dev for b in self.STREAM_BUCKETS)})
        padded = bucket_for(max(n, n_dev), ladder, extend=True)
        if padded > n:
            images = np.concatenate([images, np.repeat(images[-1:], padded - n, axis=0)])
        out, intensity, _ = self._engines[key](self._to_device(images))
        return out[:n].cpu().numpy(), intensity[:n].cpu().numpy()

    def _replicated(self, pick: Callable) -> Callable:
        """An apply that runs `pick(hard serving)` on the replica of `_hard`
        that lives on its input's device."""
        return lambda x: pick(self._serving_on(x.device))(x)

    def _serving_on(self, device: torch.device):
        device = _indexed(device)
        if device == _indexed(self.device):
            return self._hard
        if device not in self._replicas:
            self._replicas[device] = self._replica(device)
        return self._replicas[device]

    def _replica(self, device: torch.device):
        """`_hard` built anew on `device`: the serving copy with the tuned
        winners of `autotune_report` where the tuner ran, or its int8
        branches under int8 serving."""
        router = copy.deepcopy(self.router).to(device)
        serving = make_router_serving_apply(router, self.dtype)
        if self.quant == "int8":
            return self._hard_serving(serving, router)
        img = self.config["dataset"]["img_size"]
        for level, report in self.autotune_report.items():
            serving.models[level] = candidate_builders(
                router.models[level], self.dtype, (16, img, img, 3))[report["best"]]()
        return serving

    @torch.inference_mode()
    def export_precompiled(self, bundle_dir: str, batch_sizes=(16,), queue_buckets=(16,),
                           device_buckets=(16,), device_chunk: int = 16,
                           device_spill: bool = False, buckets=None, progress=None) -> dict:
        """Write a precompiled serving bundle (serving_export.py) of this
        dehazer's serving programs, under the JAX package's program names:
        at each batch size in `batch_sizes`, `classify`, `logits` and every
        class's bucket step `step{c}` over the bucket ladder (`buckets`, the
        engine's by default); each branch `branch{c}` at `queue_buckets`
        and at the device-binned chunk (min(device_chunk, n) for n in
        `device_buckets`); the device-binned binning
        `device{device_chunk}_{device_spill}` at `device_buckets`. Records
        the quant mode and autotune setting the bundle is pinned to.
        Returns {program key: name}. Raises ValueError under serving_quant,
        as the JAX package does: the programs are the default serving
        applies."""
        from adam_dehaze_tpu_torch.serving_export import export_program, set_manifest_extra
        if self.quant:
            raise ValueError(f"export_precompiled does not support serving_quant="
                             f"{self.quant!r}: exported programs are the default serving "
                             "applies")
        img = self.config["dataset"]["img_size"]
        engine = self._binned_engine()
        buckets = tuple(buckets if buckets is not None else engine.buckets)
        clf = self._serving.classifier
        branches = [self._serving.models[lvl] for lvl in INTENSITY_ORDER]
        written = {}

        def export(args, name, what):
            if progress:
                progress(f"export {name} {what}")
            written[export_program(args, name, bundle_dir, n_bound=1)] = name

        def images(n):
            return torch.zeros((n, img, img, 3), device=self.device)

        for n in batch_sizes:
            x = images(n)
            for name in ("classify", "logits"):
                export((clf, x), name, f"n={n}")
            out = images(n + 1)
            for cls, branch in enumerate(branches):
                for b in buckets:
                    if b <= max(engine.buckets):
                        idx = torch.zeros((2, b), dtype=torch.long, device=self.device)
                        export((branch, x, idx, out), f"step{cls}", f"n={n} b={b}")
        branch_sizes = dict.fromkeys([*queue_buckets,
                                      *(min(device_chunk, n) for n in device_buckets)])
        for cls, branch in enumerate(branches):
            for b in branch_sizes:
                export((branch, images(b)), f"branch{cls}", f"b={b}")
        for n in dict.fromkeys(device_buckets):
            export((clf, images(n)), f"device{device_chunk}_{int(device_spill)}", f"n={n}")
        set_manifest_extra(bundle_dir, quant=self.quant, autotune=self._autotune)
        return written

    @torch.inference_mode()
    def classify(self, images) -> np.ndarray:
        """Fog-intensity predictions (N,) in {0: low, 1: medium, 2: high}."""
        logits, _ = self.engine.classifier_apply(self._to_device(images))
        return torch.argmax(logits, dim=1).cpu().numpy()


def _indexed(device) -> torch.device:
    """`cuda` as `cuda:<current device>`, so that devices compare equal to
    the device of a tensor on them."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _StagingRing:
    """Uploads of host batches through pinned staging buffers: `slots`
    buffers per batch shape, taken in turn; a buffer is written again only
    after the event of the copy that last read it. A batch is padded with
    its last image to `rows`. To a CPU device the batch is a plain tensor."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = slots
        self._rings: Dict[tuple, list] = {}   # shape -> [[buffer, event], ...]
        self._turn: Dict[tuple, int] = {}

    def upload(self, x: np.ndarray, rows: int) -> torch.Tensor:
        n = x.shape[0]
        if self.device.type != "cuda":
            if rows > n:
                x = np.concatenate([x, np.repeat(x[-1:], rows - n, axis=0)])
            return torch.from_numpy(x).to(self.device)
        shape = (rows,) + x.shape[1:]
        ring = self._rings.setdefault(shape, [])
        turn = self._turn.get(shape, 0)
        self._turn[shape] = (turn + 1) % self.slots
        if turn == len(ring):
            ring.append([torch.empty(shape, dtype=torch.float32, pin_memory=True), None])
        buf, event = ring[turn]
        if event is not None:
            event.synchronize()
        host = buf.numpy()
        host[:n] = x
        host[n:] = x[-1]
        xd = buf.to(self.device, non_blocking=True)
        ring[turn][1] = torch.cuda.Event()
        ring[turn][1].record(torch.cuda.current_stream(self.device))
        return xd
