"""High-level serving API of the port: dehaze images with a router.

Counterpart of adam_dehaze_tpu/serving.py:

    dehazer = AdaptiveDehazer(router, variables, config, device="cuda")
    out = dehazer(images_nhwc_float01)            # soft routing
    out, intensity = dehazer.route_hard(images)   # binned hard routing

    dehazer = AdaptiveDehazer(router, variables, config, device="cuda",
                              autotune=True, autotune_cache="exp/tune.json")
    dehazer.autotune_report    # per branch: the winner, the ms table, cached

With `autotune=True` every branch's apply is the winner of a timing run on
the serving device at (16, img_size, img_size, 3) (serving_autotune.py),
read from `autotune_cache` when that file already holds it. On a CUDA device
the run times `canonical` and `chain` for the low branch, `canonical`,
`tail_chain` and `chain_hybrid` for the medium one, and `canonical`,
`tail_chain`, `res_chain_e2b` and `res_e2b_tail_chain` for the high one.

Images go in and come out as numpy NHWC float32 in [0, 1]. Everything runs
in eval mode, under torch.inference_mode, in the config's
`cuda.compute_dtype`. `from_experiment` needs orbax checkpoints, which
only JAX reads, and waits for a checkpoint format the port can read.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    BinnedAdaptiveEngine,
)
from adam_dehaze_tpu_torch.ops.serving_apply import make_router_serving_apply
from adam_dehaze_tpu_torch.serving_autotune import load_or_tune
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
    def classify(self, images) -> np.ndarray:
        """Fog-intensity predictions (N,) in {0: low, 1: medium, 2: high}."""
        logits, _ = self.engine.classifier_apply(self._to_device(images))
        return torch.argmax(logits, dim=1).cpu().numpy()
