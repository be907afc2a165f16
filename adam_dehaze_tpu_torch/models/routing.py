"""Adaptive routing: the soft and hard routers and the binned serving engine.

Counterparts of adam_dehaze_tpu/models/routing.py:

- `SoftRouter`: softmax(logits / T) blend of all three branches; the blend
  is kernel K5 (`blend3`) on CUDA tensors.
- `HardRouter`: one-hot select over all three branch outputs (training
  parity, not a serving path).
- `bucket_for` / `plan_chunks`: the bucket rule and the chunk planner,
  pure Python, as in the JAX package.
- `BinnedAdaptiveEngine`: classify, bin images by class on the host, pad
  each bin to planned bucket sizes, run one branch per bucket, scatter back.
  A bucket step is `index_select` -> branch -> `index_copy_` into a
  preallocated output; `set_chunk_costs` feeds the planner measured
  costs. run_stream, run_queued and the device-binned engines come in later
  work.

Routers take and return NHWC images and keep the branch modules under
`models.{low,medium,high}` and the classifier under `classifier`.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from adam_dehaze_tpu_torch.ops.kernels.blend import blend3

INTENSITY_ORDER = ("low", "medium", "high")


def _branch_outputs(models: nn.ModuleDict, x):
    return {name: models[name](x) for name in INTENSITY_ORDER if name in models}


class SoftRouter(nn.Module):
    """Blend all branches with softmax(logits / T) weights."""

    def __init__(self, models: Dict[str, nn.Module],
                 classifier: Optional[nn.Module] = None,
                 temperature: float = 1.0):
        super().__init__()
        self.models = nn.ModuleDict(models)
        self.classifier = classifier
        self.temperature = temperature

    def forward(self, x, classifier_logits=None):
        if classifier_logits is None and self.classifier is not None:
            logits, _ = self.classifier(x)
        else:
            logits = classifier_logits
        weights = torch.softmax(logits / self.temperature, dim=1)
        outputs = _branch_outputs(self.models, x)
        ys = [outputs[n] for n in INTENSITY_ORDER if n in outputs]
        if len(ys) == 3:
            blended = blend3(weights, *ys)
        else:
            blended = torch.zeros_like(x)
            for i, name in enumerate(INTENSITY_ORDER):
                if name in outputs:
                    blended = blended + weights[:, i, None, None, None] * outputs[name]
        return blended, {"weights": weights, "individual_outputs": outputs,
                         "logits": logits}


class HardRouter(nn.Module):
    """Route each image through the branch picked by argmax intensity, as a
    one-hot select over all three branch outputs (3x the FLOPs: for
    adaptive-FLOPs serving use `BinnedAdaptiveEngine`)."""

    def __init__(self, models: Dict[str, nn.Module],
                 classifier: Optional[nn.Module] = None):
        super().__init__()
        self.models = nn.ModuleDict(models)
        self.classifier = classifier

    def forward(self, x, intensity=None):
        logits = None
        if intensity is None and self.classifier is not None:
            logits, _ = self.classifier(x)
            intensity = torch.argmax(logits.detach(), dim=1)
        outputs = _branch_outputs(self.models, x)
        onehot = nn.functional.one_hot(intensity, 3).to(x.dtype)
        routed = torch.zeros_like(x)
        for i, name in enumerate(INTENSITY_ORDER):
            if name in outputs:
                routed = routed + onehot[:, i, None, None, None] * outputs[name]
        return routed, {"intensity": intensity, "low_mask": intensity == 0,
                        "medium_mask": intensity == 1,
                        "high_mask": intensity == 2, "logits": logits}


def create_router(models: Dict[str, nn.Module], classifier, config) -> nn.Module:
    routing_type = config["routing"]["type"]
    if routing_type == "hard":
        return HardRouter(models, classifier)
    if routing_type == "soft":
        return SoftRouter(models, classifier, config["routing"]["temperature"])
    raise ValueError(f"Unsupported routing type: {routing_type}")


# ---------------------------------------------------------------------------
# Host-binned serving engine.
# ---------------------------------------------------------------------------

def bucket_for(n: int, buckets, extend: bool = False) -> int:
    """Smallest bucket >= n from a sorted ladder. Beyond the largest bucket:
    extend=False saturates at buckets[-1] (callers chunk); extend=True
    rounds up to a multiple of it."""
    for b in buckets:
        if b >= n:
            return b
    m = buckets[-1]
    return -(-n // m) * m if extend else m


@functools.lru_cache(maxsize=4096)
def plan_chunks(n: int, buckets: tuple, overhead_rows: float = 2.0) -> tuple:
    """Cost-model bucket decomposition of n rows: the multiset of ladder
    sizes minimizing padded_rows + overhead_rows * n_programs (see the JAX
    package's plan_chunks). Returns a descending tuple with sum >= n."""
    buckets = tuple(sorted(buckets))
    if not buckets:
        raise ValueError("plan_chunks requires a non-empty bucket ladder")
    if n <= 0:
        return ()
    INF = float("inf")
    cost = [0.0] + [INF] * n
    pick = [0] * (n + 1)
    for r in range(1, n + 1):
        for b in buckets:
            rest = max(0, r - b)
            c = b + overhead_rows + cost[rest]
            if c < cost[r]:
                cost[r], pick[r] = c, b
    plan, r = [], n
    while r > 0:
        b = pick[r]
        plan.append(b)
        r -= b
    return tuple(sorted(plan, reverse=True))


class BinnedAdaptiveEngine:
    """Host-binned hard routing: each image pays only its own branch.

    classifier_apply: x -> (logits, features); branch_applies: [low, medium,
    high], x (n, H, W, 3) -> dehazed. Images are binned by class on the
    host; per class, plan_chunks decides the bucket sizes; each bucket
    gathers its rows (padding repeats the bin's last image), runs the
    branch and copies the real rows into the output. Eager PyTorch has no
    per-shape compile, so the buckets bound the number of distinct branch
    shapes rather than programs.
    """

    def __init__(self, classifier_apply: Callable,
                 branch_applies: Sequence[Callable],
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 program_overhead_rows=2.0):
        self.classifier_apply = classifier_apply
        self.branch_applies = list(branch_applies)
        self.buckets = tuple(sorted(buckets))
        if isinstance(program_overhead_rows, (int, float)):
            program_overhead_rows = [float(program_overhead_rows)] * len(
                self.branch_applies)
        self.program_overhead_rows = [float(v) for v in program_overhead_rows]

    def _bucket(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    def plan_capacity_spill(self, intensity, logits=None, up_only: bool = False,
                            margin_threshold: float = None):
        """Capacity-constrained routing plan: cap each class at
        ceil(n / n_classes) rounded up to a bucket size and serve overflow
        images with a neighbouring branch's free pad slots (the stronger
        branch first; `up_only` forbids weaker ones). With `logits`, the
        images closest to the target class spill first, and
        `margin_threshold` bounds which may spill. Returns the serving
        labels (the JAX package's plan_capacity_spill, line for line)."""
        intensity = np.asarray(intensity)
        n = intensity.size
        k = len(self.branch_applies)
        per_class = -(-n // k)
        bmax = self.buckets[-1]
        cap = (self._bucket(per_class) if per_class <= bmax
               else -(-per_class // bmax) * bmax)
        counts = np.bincount(intensity, minlength=k)
        free = cap - counts
        labels_eff = intensity.copy()
        for c in range(k):
            if free[c] >= 0:
                continue
            pool = list(np.nonzero(intensity == c)[0])
            targets = (list(range(c + 1, k)) if up_only else
                       list(range(c + 1, k)) + list(range(c - 1, -1, -1)))
            for t in targets:
                overflow = -free[c]
                if overflow <= 0 or free[t] <= 0:
                    continue
                m = int(min(overflow, free[t]))
                if logits is not None:
                    lg = np.asarray(logits)
                    pool.sort(key=lambda i: lg[i, t] - lg[i, c])
                    if margin_threshold is not None:
                        eligible = sum(1 for i in pool
                                       if lg[i, c] - lg[i, t] < margin_threshold)
                        m = int(min(m, eligible))
                        if m <= 0:
                            continue
                chosen, pool = pool[-m:], pool[:-m]
                labels_eff[np.asarray(chosen, np.int64)] = t
                free[t] -= m
                free[c] += m
        return labels_eff

    def set_chunk_costs(self, dispatch_overhead_ms,
                        branch_row_ms: Sequence[float]) -> None:
        """Feed measured serving costs into the chunk planner: one more
        bucket costs `dispatch_overhead_ms` (one figure, or one per class:
        on the GPU a branch call's fixed cost is the host's enqueue of its
        launches, which differs tenfold between the branches); a padded row
        of class c costs `branch_row_ms[c]`. plan_chunks then trades them
        in row units (overhead_ms / row_ms) per class, e.g. from the
        serving autotune table's times per 16 images."""
        if isinstance(dispatch_overhead_ms, (int, float)):
            dispatch_overhead_ms = [dispatch_overhead_ms] * len(branch_row_ms)
        self.program_overhead_rows = [
            float(d) / max(float(r), 1e-6)
            for d, r in zip(dispatch_overhead_ms, branch_row_ms, strict=True)]

    def _dispatch(self, x: torch.Tensor, intensity: np.ndarray) -> torch.Tensor:
        """Run the binned branch buckets for one batch (labels on host)."""
        out = torch.zeros_like(x)
        for cls, branch in enumerate(self.branch_applies):
            idxs = np.nonzero(intensity == cls)[0]
            if idxs.size == 0:
                continue
            pos = 0
            for b in plan_chunks(int(idxs.size), self.buckets,
                                 self.program_overhead_rows[cls]):
                chunk = idxs[pos:pos + b]
                padded = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - chunk.size)])
                idx = torch.from_numpy(padded).to(x.device)
                y = branch(x.index_select(0, idx))
                # Only the real rows: pad rows duplicate an index.
                out.index_copy_(0, idx[:chunk.size], y[:chunk.size].to(out.dtype))
                pos += chunk.size
        return out

    def __call__(self, x: torch.Tensor, intensity=None, spill=False):
        """x: (N, H, W, 3) on the serving device. intensity: optional labels
        that override the routing (the classifier still runs, for the same
        serving cost). spill=True serves per-class overflow with a
        neighbouring branch (`plan_capacity_spill`); spill="up" only moves
        overflow to stronger branches. Returns (dehazed, the classifier's
        labels or the given ones as numpy)."""
        logits, _ = self.classifier_apply(x)
        # As in the JAX engine, spill ranks by logits only for predicted
        # labels; given labels spill without them.
        spill_logits = None
        if intensity is None:
            intensity = torch.argmax(logits, dim=1).cpu().numpy()
            if spill:
                spill_logits = logits.cpu().numpy()
        else:
            intensity = np.asarray(intensity)
        serve = (self.plan_capacity_spill(intensity, spill_logits,
                                          up_only=(spill == "up"))
                 if spill else intensity)
        return self._dispatch(x, serve), intensity
