"""High-level serving API of the port: dehaze images with a router.

Counterpart of adam_dehaze_tpu/serving.py:

    dehazer = AdaptiveDehazer(router, variables, config, device="cuda")
    out = dehazer(images_nhwc_float01)            # soft routing
    out, intensity = dehazer.route_hard(images)   # binned hard routing

Images go in and come out as numpy NHWC float32 in [0, 1]. Everything runs
in eval mode, under torch.inference_mode, in the config's
`cuda.compute_dtype`. `from_experiment` needs orbax checkpoints, which
only JAX reads, and waits for a checkpoint format the port can read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    BinnedAdaptiveEngine,
)
from adam_dehaze_tpu_torch.ops.serving_apply import make_router_serving_apply
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables


class AdaptiveDehazer:
    """router: a SoftRouter or HardRouter of the port (its classifier and
    the three branches). variables: the JAX package's {"params",
    "batch_stats"} tree to load into it, or None to serve the router's own
    weights. The router is moved to `device` in place; one serving copy of
    it (weights cast, the low branch folded for K1) backs both the soft
    call and the hard-routing engine."""

    def __init__(self, router, variables, config, device="cuda"):
        if variables is not None:
            load_flax_variables(router, variables)
        self.device = torch.device(device)
        self.router = router.to(self.device).eval()
        self.config = config
        self.dtype = compute_dtype(config)
        self._serving = make_router_serving_apply(self.router, self.dtype)
        self._engine: Optional[BinnedAdaptiveEngine] = None

    def _to_device(self, images) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images, np.float32)).to(self.device)

    @property
    def engine(self) -> BinnedAdaptiveEngine:
        """The binned hard-routing engine, built on first use."""
        if self._engine is None:
            self._engine = BinnedAdaptiveEngine(
                self._serving.classifier,
                [self._serving.models[lvl] for lvl in INTENSITY_ORDER])
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
