"""Pipeline parallelism for the serving path.

Counterpart of adam_dehaze_tpu/parallel/pipeline.py. The adaptive pipeline
is two stages, (1) the fog classifier and (2) the soft-blended dehazing
branches, so serving can run them on two device groups: while stage B
dehazes batch i, stage A already classifies batch i+1. CUDA launches
return at once, which gives the overlap; this class handles placement and
the one-batch skew. On one device both stages share it: the results are
the same, with no overlap.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import torch

from adam_dehaze_tpu_torch.ops.kernels.blend import blend3


class TwoStagePipeline:
    """classifier (stage A's first device) -> soft-blend dehaze (stage B's
    first device).

    Args:
      classifier_apply: x -> (logits, features), weights on stage A's
        first device.
      branch_applies: [low, medium, high]: x -> dehazed, weights on stage
        B's first device.
      temperature: soft-routing temperature.
      devices: devices to split between the two stages (default: every
        visible CUDA device; the CPU only when it is passed).
    """

    def __init__(self, classifier_apply: Callable,
                 branch_applies: Sequence[Callable],
                 temperature: float = 0.5,
                 devices: Optional[Sequence] = None):
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("no device for the pipeline: no CUDA device is visible")
        half = max(len(devices) // 2, 1)
        self.stage_a = devices[:half]
        self.stage_b = devices[half:] or devices[:1]
        self._classifier = classifier_apply
        self._branches = list(branch_applies)
        self.temperature = temperature

    @torch.no_grad()
    def _stage_a(self, x):
        xa = torch.as_tensor(x).to(self.stage_a[0], non_blocking=True)
        return xa, self._classifier(xa)[0]

    @torch.no_grad()
    def _stage_b(self, x, logits):
        xb = x.to(self.stage_b[0], non_blocking=True)
        w = torch.softmax(logits.to(self.stage_b[0], non_blocking=True) / self.temperature,
                          dim=1)
        return blend3(w, *[f(xb) for f in self._branches])

    def run(self, batches: Iterable) -> Iterator[torch.Tensor]:
        """Stream batches through the two stages with one-batch skew;
        yields dehazed batches in order."""
        in_flight: Optional[Tuple] = None
        for x in batches:
            staged = self._stage_a(x)  # enqueued on stage A's device
            if in_flight is not None:
                yield self._stage_b(*in_flight)
            in_flight = staged
        if in_flight is not None:
            yield self._stage_b(*in_flight)

    def __call__(self, x) -> torch.Tensor:
        """Single batch (no pipelining benefit; correctness path)."""
        return self._stage_b(*self._stage_a(x))
