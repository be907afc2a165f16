"""High-level serving API of the port: dehaze images with a router.

Counterpart of adam_dehaze_tpu/serving.py:

    dehazer = AdaptiveDehazer(router, variables, config, device="cuda")
    out = dehazer(images_nhwc_float01)            # soft routing
    out, intensity = dehazer.route_hard(images)   # binned hard routing
    out, intensity = dehazer.route_device_binned(images)   # binned on the card
    for out, intensity in dehazer.route_device_binned_stream(batches): ...

    dehazer = AdaptiveDehazer(router, variables, config, device="cuda",
                              autotune=True, autotune_cache="exp/tune.json")
    dehazer.autotune_report    # per branch: the winner, the ms table, cached

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

Images go in and come out as numpy NHWC float32 in [0, 1] (`route_hard_queued`
yields device tensors, as the JAX route yields device arrays). Everything
runs in eval mode, under torch.inference_mode, in the config's
`cuda.compute_dtype`. `from_experiment` needs orbax checkpoints, which only
JAX reads, and waits for a checkpoint format the port can read; the
`lowres` argument of the routes and `export_precompiled` wait too.
"""
from __future__ import annotations

import copy
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    BinnedAdaptiveEngine,
    _HostRead,
    bucket_for,
    make_adaptive_infer,
    make_device_binned_infer,
    make_sharded_binned_infer,
)
from adam_dehaze_tpu_torch.ops.serving_apply import make_router_serving_apply
from adam_dehaze_tpu_torch.serving_autotune import candidate_builders, load_or_tune
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables


class AdaptiveDehazer:
    """router: a SoftRouter or HardRouter of the port (its classifier and
    the three branches). variables: the JAX package's {"params",
    "batch_stats"} tree to load into it, or None to serve the router's own
    weights. The router is moved to `device` in place; one serving copy of
    it (weights cast, the low branch folded for K1) backs both the soft
    call and the hard-routing engine. autotune: replace that copy's
    branches by the timed winners of serving_autotune.load_or_tune
    (`autotune_report[level]` holds each report; `autotune_cache` is the
    JSON file that keeps the winners between processes), and feed the
    winners' times to the engine's chunk planner."""

    # What one more bucket of each branch costs, in ms: the part of a branch
    # call that does not grow with its rows (mostly the host's enqueue of
    # its launches). `_chunk_costs` subtracts it from the tuned winner's
    # time, so it is read on the winners: chip_smoke.py's [dispatch tuned
    # bf16] lines (the intercept of the winner's warm time over 1-32 rows),
    # on an NVIDIA H100 80GB HBM3 at 700 W, bf16, 256^2, where the winners
    # are chain, tail_chain (K3 and the canonical prefix) and
    # res_e2b_tail_chain (K6 and K4, 32 launches); the median of three runs.
    # Hosts spread about 2x (PERF.md).
    DISPATCH_MS = {"low": 0.19, "medium": 2.79, "high": 2.78}

    def __init__(self, router, variables, config, device="cuda",
                 autotune: bool = False, autotune_cache: Optional[str] = None):
        if variables is not None:
            load_flax_variables(router, variables)
        self.device = torch.device(device)
        self.router = router.to(self.device).eval()
        self.config = config
        self.dtype = compute_dtype(config)
        self._serving = make_router_serving_apply(self.router, self.dtype)
        self._engine: Optional[BinnedAdaptiveEngine] = None
        self._engines: Dict[str, Callable] = {}
        self._replicas: Dict[torch.device, torch.nn.Module] = {}
        self.autotune_report: Dict[str, dict] = {}
        if autotune:
            self._serving.models.update(self._branch_applies(autotune_cache))

    def _branch_applies(self, cache_path: Optional[str]) -> Dict[str, torch.nn.Module]:
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
        """(ms per bucket, ms per row) of each branch: DISPATCH_MS, and the
        winner's time per 16 images in the autotune table less one
        dispatch; None without the tables."""
        dispatch_ms, row_ms = [], []
        for level in INTENSITY_ORDER:
            report = self.autotune_report.get(level) or {}
            ms16 = (report.get("table") or {}).get(report.get("best"))
            if not ms16:
                return None
            dispatch_ms.append(self.DISPATCH_MS[level])
            row_ms.append(max(float(ms16) - self.DISPATCH_MS[level], 1e-6) / 16.0)
        return dispatch_ms, row_ms

    def _to_device(self, images) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images, np.float32)).to(self.device)

    @property
    def engine(self) -> BinnedAdaptiveEngine:
        """The binned hard-routing engine, built on first use."""
        if self._engine is None:
            self._engine = BinnedAdaptiveEngine(
                self._serving.classifier,
                [self._serving.models[lvl] for lvl in INTENSITY_ORDER])
            costs = self._chunk_costs()
            if costs is not None:
                self._engine.set_chunk_costs(*costs)
        return self._engine

    @torch.inference_mode()
    def __call__(self, images) -> np.ndarray:
        """Soft-routed dehazing: (N, H, W, 3) float [0, 1] -> same."""
        dehazed, _ = self._serving(self._to_device(images))
        return dehazed.float().cpu().numpy()

    @torch.inference_mode()
    def route_hard(self, images, spill=False) -> Tuple[np.ndarray, np.ndarray]:
        """Binned hard routing: each image pays only its own branch. spill:
        see BinnedAdaptiveEngine.__call__. Returns (dehazed, intensity)."""
        out, intensity = self.engine(self._to_device(images), spill=spill)
        return out.cpu().numpy(), np.asarray(intensity)

    @torch.inference_mode()
    def route_hard_stream(self, batches, spill=False):
        """Pipelined serving over an iterable of batches: the classifier of
        batch k+1 overlaps batch k's host binning
        (BinnedAdaptiveEngine.run_stream). Yields (dehazed, intensity) as
        numpy."""
        uploads = (self._to_device(x) for x in batches)
        for out, intensity in self.engine.run_stream(uploads, spill=spill):
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
            self._engines[key] = make_device_binned_infer(
                self._serving.classifier,
                [self._serving.models[lvl] for lvl in INTENSITY_ORDER],
                chunk=chunk, spill=spill)
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
                self._serving.classifier,
                [self._serving.models[lvl] for lvl in INTENSITY_ORDER], "switch")
        out, intensity = self._engines["switch"](self._to_device(images))
        return out.cpu().numpy(), intensity.cpu().numpy()

    @torch.inference_mode()
    def route_sharded(self, images, devices=None, chunk: int = 16, spill: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Data-parallel serving: the device-binned engine on one shard per
        device (models/routing.py:make_sharded_binned_infer; binning and
        spill local to each shard, no collective). devices: a list of
        torch devices; None is every visible CUDA device, or [self.device]
        on the CPU. Each device serves from its own replica of the serving
        copy. A ragged batch is padded with its last image to the ladder
        (n_dev,) + STREAM_BUCKETS * n_dev. Returns (dehazed, intensity)."""
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
        """An apply that runs `pick(serving copy)` on the replica of the
        serving copy that lives on its input's device."""
        return lambda x: pick(self._serving_on(x.device))(x)

    def _serving_on(self, device: torch.device) -> torch.nn.Module:
        device = _indexed(device)
        if device == _indexed(self.device):
            return self._serving
        if device not in self._replicas:
            self._replicas[device] = self._replica(device)
        return self._replicas[device]

    def _replica(self, device: torch.device) -> torch.nn.Module:
        """The serving copy built anew on `device`, with the tuned winners
        of `autotune_report` where the tuner ran."""
        router = copy.deepcopy(self.router).to(device)
        serving = make_router_serving_apply(router, self.dtype)
        img = self.config["dataset"]["img_size"]
        for level, report in self.autotune_report.items():
            serving.models[level] = candidate_builders(
                router.models[level], self.dtype, (16, img, img, 3))[report["best"]]()
        return serving

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
