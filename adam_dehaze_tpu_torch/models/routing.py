"""Adaptive routing: the soft, hard and gated routers and the binned
serving engine.

Counterparts of adam_dehaze_tpu/models/routing.py:

- `SoftRouter`: softmax(logits / T) blend of all three branches; the blend
  is kernel K5 (`blend3`) on CUDA tensors, differentiable in training.
- `HardRouter`: one-hot select over all three branch outputs by the argmax
  of the classifier's logits, no gradient through the choice (training
  parity, not a serving path).
- `GatedRouter`: a learned gate MLP over the classifier's features
  (Dense 256 -> ReLU -> Dropout 0.3 -> Dense 128 -> ReLU -> Dense 3,
  softmax) blends the branches.
- `bucket_for` / `plan_chunks`: the bucket rule and the chunk planner,
  pure Python, as in the JAX package.
- `BinnedAdaptiveEngine`: classify, bin images by class on the host, pad
  each bin to planned bucket sizes, run one branch per bucket, scatter back.
  A bucket step is `index_select` -> branch -> `index_copy_` into a
  preallocated output; `set_chunk_costs` feeds the planner measured
  costs. `run_stream` pipelines the classifier over a stream of batches,
  `run_queued` queues images per class across batches.
- `make_device_binned_infer`: the binning on the device (stable argsort by
  class, chunk-aligned segments), with `_device_capacity_labels` for the
  capacity spill; `make_sharded_binned_infer` runs it on one shard per
  device; `make_adaptive_infer`: soft, select and per-image switch.

On a CUDA device no engine reads a device tensor with a plain `.cpu()`:
labels go to pinned host memory with non_blocking=True behind an event
(`_HostRead`), and index arrays come up the same way (`_upload`), so a read
waits for the work it needs and not for what was enqueued after it.

Routers take and return NHWC images and keep the branch modules under
`models.{low,medium,high}` and the classifier under `classifier`. In train
mode the classifier's dropouts (and the gate's) draw from the
`torch.Generator` passed to forward, as the JAX routers draw from the
step's dropout key.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from adam_dehaze_tpu_torch.nn.blocks import Dropout
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

    def forward(self, x, classifier_logits=None, generator=None):
        if classifier_logits is None and self.classifier is not None:
            logits, _ = self.classifier(x, generator)
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

    def forward(self, x, intensity=None, generator=None):
        logits = None
        if intensity is None and self.classifier is not None:
            logits, _ = self.classifier(x, generator)
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


class GatedRouter(nn.Module):
    """Blend the branches with a learned gate over the classifier's
    features; without a classifier, uniform weights. The gate runs in f32
    (outside autocast), as the JAX gate's Dense layers run in their f32
    parameters' dtype. `gate_network.{0,3,5}` are the reference's keys."""

    def __init__(self, models: Dict[str, nn.Module],
                 classifier: Optional[nn.Module] = None, feature_dim: int = 512):
        super().__init__()
        self.models = nn.ModuleDict(models)
        self.classifier = classifier
        self.feature_dim = feature_dim
        if classifier is not None:
            self.gate_network = nn.Sequential(
                nn.Linear(feature_dim, 256), nn.ReLU(), Dropout(0.3),
                nn.Linear(256, 128), nn.ReLU(), nn.Linear(128, len(models)))

    def forward(self, x, generator=None):
        n_models = len(self.models)
        logits = None
        if self.classifier is not None:
            logits, features = self.classifier(x, generator)
            fc0, relu0, drop, fc1, relu1, fc2 = self.gate_network
            with torch.autocast(x.device.type, enabled=False):
                h = drop(relu0(fc0(features.float())), generator)
                gate = torch.softmax(fc2(relu1(fc1(h))), dim=1)
        else:
            gate = torch.full((x.shape[0], n_models), 1.0 / n_models,
                              dtype=x.dtype, device=x.device)
        outputs = _branch_outputs(self.models, x)
        final = torch.zeros_like(x)
        for i, name in enumerate(INTENSITY_ORDER):
            if name in outputs:
                final = final + gate[:, i, None, None, None] * outputs[name]
        return final, {"gate_weights": gate, "individual_outputs": outputs,
                       "logits": logits}


def create_router(models: Dict[str, nn.Module], classifier, config) -> nn.Module:
    routing_type = config["routing"]["type"]
    if routing_type == "hard":
        return HardRouter(models, classifier)
    if routing_type == "soft":
        return SoftRouter(models, classifier, config["routing"]["temperature"])
    if routing_type == "gated":
        fdim = classifier.feature_dim if classifier is not None else 512
        return GatedRouter(models, classifier, fdim)
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


def _upload(a, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on `device`. To a CUDA device
    the copy goes through pinned memory with non_blocking=True: a copy from
    pageable memory synchronizes the stream, and with it every kernel
    already enqueued."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _HostRead:
    """A device tensor on its way to the host. On CUDA the copy goes to
    pinned memory with non_blocking=True and an event is recorded behind it
    on the tensor's stream; `get` waits on that event alone, not on what
    the stream runs after it. A CPU tensor is read as it is."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = t.to("cpu", non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


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
        """Run the binned branch buckets for one batch (labels on host).
        The padded indices of every bucket go up in one copy."""
        buckets, index = [], []   # (class, real rows, bucket size)
        for cls in range(len(self.branch_applies)):
            idxs = np.nonzero(intensity == cls)[0]
            pos = 0
            for b in plan_chunks(int(idxs.size), self.buckets,
                                 self.program_overhead_rows[cls]):
                chunk = idxs[pos:pos + b]
                index.append(np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - chunk.size)]))
                buckets.append((cls, chunk.size, b))
                pos += chunk.size
        out = torch.zeros_like(x)
        if not buckets:
            return out
        index = _upload(np.concatenate(index), x.device)
        start = 0
        for cls, rows, b in buckets:
            idx = index[start:start + b]
            y = self.branch_applies[cls](x.index_select(0, idx))
            # Only the real rows: pad rows duplicate an index.
            out.index_copy_(0, idx[:rows], y[:rows].to(out.dtype))
            start += b
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

    def _classify_async(self, x: torch.Tensor, given) -> _HostRead:
        """Enqueue the classifier on x and the copy of its argmax to the
        host; with labels given (the classifier still runs, for the same
        serving cost) the read holds those instead."""
        logits, _ = self.classifier_apply(x)
        return _HostRead(torch.argmax(logits, dim=1) if given is None
                         else torch.from_numpy(np.asarray(given)))

    def run_stream(self, batches, intensities=None, spill=False):
        """Steady-state serving over a stream of batches (tensors on the
        serving device): batch k+1's classifier is enqueued before batch
        k's labels are read, and that read waits on an event behind batch
        k's argmax copy only, so the host's binning of batch k overlaps
        batch k+1's classifier. (`.cpu()` on batch k's labels would wait
        for batch k+1's classifier too: one stream runs both.)
        `intensities`: optional per-batch labels that override the
        routing. spill=True applies `plan_capacity_spill` to each batch's
        serving labels. Yields (dehazed device tensor, intensity numpy)."""
        def serve(x, read):
            labels = read.get()
            labels_eff = (self.plan_capacity_spill(labels, up_only=(spill == "up"))
                          if spill else labels)
            return self._dispatch(x, labels_eff), labels

        pending = None   # (x, its label read)
        intensities = iter(intensities) if intensities is not None else None
        for x in batches:
            read = self._classify_async(x, next(intensities) if intensities is not None else None)
            if pending is not None:
                yield serve(*pending)
            pending = (x, read)
        if pending is not None:
            yield serve(*pending)

    def run_queued(self, batches, queue_bucket: Optional[int] = None,
                   flush: bool = True, intensities=None,
                   max_wait_batches: Optional[int] = None):
        """Cross-batch per-class queueing (continuous batching) for
        class-clumped traffic, as the JAX package's run_queued: images
        queue per predicted (or given) class across batch boundaries, and
        a branch runs only on a full `queue_bucket` of its class; with
        flush=True the remainders are served at the end through the padded
        `plan_chunks` ladder (a pad repeats the bucket's last row), and
        `max_wait_batches=W` serves a class's remainder that way once its
        oldest image has waited W further batches. Buckets are composed
        with `index_select` from the batches already on the device; the
        classifier is pipelined as in `run_stream`.

        Yields (dehazed device tensor, global_indices numpy, cls) per
        bucket; `global_indices` index the concatenated input stream. The
        outputs stay on the device, so that bucket dispatches pipeline: a
        fetch per bucket would serialize them."""
        q = queue_bucket or self.buckets[-1]
        k = len(self.branch_applies)
        # per class: (x, local indices on the host and on the device, base,
        # tick); tick is the enqueue count at arrival, so queues[cls][0][4] is
        # the class's oldest (a partly consumed entry keeps its tick).
        queues = [[] for _ in range(k)]
        counts = [0] * k
        seq = 0

        def compose(cls, take):
            """Pop `take` images off class cls's queue: (batch on the
            device, global indices)."""
            parts, gidx, got = [], [], 0
            while got < take:
                x, local, local_dev, base, tick = queues[cls][0]
                need = take - got
                parts.append(x.index_select(0, local_dev[:need]))
                gidx.append(base + local[:need])
                got += min(need, local.size)
                if local.size > need:
                    queues[cls][0] = (x, local[need:], local_dev[need:], base, tick)
                else:
                    queues[cls].pop(0)
            counts[cls] -= take
            xq = parts[0] if len(parts) == 1 else torch.cat(parts)
            return xq, np.concatenate(gidx)

        def serve_padded(cls):
            """One remainder bucket through the padded ladder, at most
            buckets[-1] even when queue_bucket is larger: the planner's
            largest chunk of the remainder."""
            cap = min(counts[cls], q, self.buckets[-1])
            b = plan_chunks(cap, self.buckets, self.program_overhead_rows[cls])[0]
            take = min(cap, b)
            xq, gidx = compose(cls, take)
            if b != take:
                xq = torch.cat([xq, xq[-1:].expand(b - take, *xq.shape[1:])])
            return self.branch_applies[cls](xq)[:take], gidx, cls

        def enqueue(x, labels, base):
            nonlocal seq
            seq += 1
            for cls in range(k):
                local = np.nonzero(labels == cls)[0]
                if local.size:
                    queues[cls].append((x, local, _upload(local, x.device), base, seq))
                    counts[cls] += local.size

        def drain(final):
            for cls in range(k):
                while counts[cls] >= q:
                    xq, gidx = compose(cls, q)
                    yield self.branch_applies[cls](xq), gidx, cls
            if max_wait_batches is not None and not final:
                for cls in range(k):
                    while queues[cls] and seq - queues[cls][0][4] >= max_wait_batches:
                        yield serve_padded(cls)

        base = 0
        pending = None   # (x, its label read, base)
        intensities = iter(intensities) if intensities is not None else None
        for x in batches:
            read = self._classify_async(x, next(intensities) if intensities is not None else None)
            if pending is not None:
                px, pread, pbase = pending
                enqueue(px, pread.get(), pbase)
                yield from drain(final=False)
            pending = (x, read, base)
            base += int(x.shape[0])
        if pending is not None:
            px, pread, pbase = pending
            enqueue(px, pread.get(), pbase)
            yield from drain(final=flush)
        if flush:
            for cls in range(k):
                while counts[cls] > 0:
                    yield serve_padded(cls)


# ---------------------------------------------------------------------------
# Device-binned serving engines.
# ---------------------------------------------------------------------------

def _spill_choice_table(n_cls: int, device=None) -> torch.Tensor:
    """Per-class serving preference, (n_cls, n_cls): own class, then the
    stronger neighbours ascending, then the weaker descending (the policy
    of BinnedAdaptiveEngine.plan_capacity_spill). Row c, rank j is c + j
    for j <= s = n_cls - 1 - c and c - (j - s) beyond: computed on the
    device, since a table copied up from the host would synchronize."""
    c = torch.arange(n_cls, device=device)[:, None]
    j = torch.arange(n_cls, device=device)[None, :]
    s = n_cls - 1 - c
    return torch.where(j <= s, c + j, c - (j - s))


def _device_capacity_labels(intensity: torch.Tensor, logits: torch.Tensor,
                            cap: int, n_cls: int) -> torch.Tensor:
    """On-device capacity assignment in fixed shapes (the JAX package's
    `_device_capacity_labels`, line for line): every class serves at most
    `cap` images; overflow images move along `_spill_choice_table`, the
    most confident images (largest margin of their logit over the best
    other class) claiming their own class first, so the least confident
    spill. One pass per preference rank: a still-unassigned image takes
    its rank-j choice if that class has room at its queue position. The
    sort is stable, as jnp.argsort: with tied margins the order decides
    who spills. No op here reads the device (no bincount, nonzero or mask
    indexing)."""
    n = intensity.shape[0]
    device = intensity.device
    intensity = intensity.long()
    classes = torch.arange(n_cls, device=device)
    choices = _spill_choice_table(n_cls, device).index_select(0, intensity)   # (n, n_cls)
    own = logits.gather(1, intensity[:, None])[:, 0]
    other = torch.where(intensity[:, None] == classes, float("-inf"), logits).amax(dim=1)
    margin = own - other
    perm = torch.argsort(-margin, stable=True)        # most confident claim slots first
    choices_p = choices.index_select(0, perm)

    free = torch.full((n_cls,), cap, dtype=torch.long, device=device)
    assigned = torch.full((n,), -1, dtype=torch.long, device=device)
    for j in range(n_cls):
        cand = choices_p[:, j]
        pending = assigned < 0
        onehot = (cand[:, None] == classes).long() * pending[:, None].long()
        pos = torch.cumsum(onehot, dim=0) - onehot                    # queue position
        mypos = pos.gather(1, cand[:, None])[:, 0]
        ok = pending & (mypos < free.index_select(0, cand))
        assigned = torch.where(ok, cand, assigned)
        free = free - (onehot * ok[:, None].long()).sum(dim=0)
    # assigned[inverse of perm], as a scatter.
    return torch.empty_like(assigned).scatter_(0, perm, assigned)


class _Binning(NamedTuple):
    """One batch binned on the device: the input, the routing labels and
    logits, per chunk slot the source row and the destination row (n, the
    trash row, for a pad slot), and the chunk classes on their way to the
    host (n_cls: a chunk past every class segment)."""
    x: torch.Tensor
    intensity: torch.Tensor
    logits: torch.Tensor
    src: torch.Tensor            # (K, b)
    dst: torch.Tensor            # (K, b)
    classes: _HostRead           # (K,)


class DeviceBinnedInfer:
    """fn(x, intensity=None) -> (dehazed, intensity, logits), all on
    x.device: the binned adaptive routing of the JAX package's
    `make_device_binned_infer`, with the binning on the device.

    classifier -> argmax (or the given labels; the classifier still runs)
    -> `_device_capacity_labels` with spill -> stable argsort by serving
    class -> each class's segment laid out at chunk-aligned offsets ->
    K = ceil(N / b) + n_cls - 1 chunks of b = min(chunk, N) slots, each
    slot a source row and a destination row; a pad slot gathers image 0
    and writes the trash row N of an (N + 1, ...) output.

    The one difference from the JAX engine: `lax.switch` picks a chunk's
    branch from a device scalar, and eager PyTorch cannot. So after the
    binning is enqueued the K chunk classes are copied once, with
    non_blocking=True, to pinned host memory behind a CUDA event, and
    `serve` waits on that event: the only read of the call, K values, not
    N labels (the JAX engine reads nothing). Then each chunk launches its
    branch on `index_select(x, src)` and `index_copy_`s into the output,
    with the indices already on the device; a chunk past every segment
    launches nothing. On a CPU tensor the same code reads the classes
    directly. `bin` alone enqueues no read of the device but that copy.

    spill=True caps each class at cap = ceil(N / (n_cls * b)) * b
    (`_device_capacity_labels`); the returned intensity stays the routing
    decision, not the serving assignment."""

    def __init__(self, classifier_apply: Callable, branch_applies: Sequence[Callable],
                 chunk: int = 16, spill: bool = False):
        self.classifier_apply = classifier_apply
        self.branch_applies = list(branch_applies)
        self.chunk = chunk
        self.spill = spill

    def bin(self, x: torch.Tensor, intensity=None) -> _Binning:
        n_cls = len(self.branch_applies)
        n = x.shape[0]
        b = min(self.chunk, n)
        k_chunks = -(-n // b) + (n_cls - 1)
        device = x.device
        logits, _ = self.classifier_apply(x)
        if intensity is None:
            intensity = torch.argmax(logits, dim=1)
        else:
            intensity = _upload(intensity, device).long()
        if self.spill:
            cap = -(-n // (n_cls * b)) * b
            serve = _device_capacity_labels(intensity, logits, cap, n_cls)
        else:
            serve = intensity

        order = torch.argsort(serve, stable=True)      # image indices by serving class
        counts = torch.zeros(n_cls, dtype=torch.long, device=device).scatter_add_(
            0, serve, torch.ones_like(serve))
        padded = (counts + b - 1) // b * b             # chunk-aligned sizes
        seg_start = torch.cumsum(padded, dim=0) - padded
        src_start = torch.cumsum(counts, dim=0) - counts

        slot = torch.arange(k_chunks * b, device=device)
        # The class segment of each slot; n_cls past the last one.
        cls_of_slot = (slot[:, None] >= (seg_start + padded)[None, :]).sum(dim=1)
        in_tail = cls_of_slot >= n_cls
        safe_cls = torch.where(in_tail, 0, cls_of_slot)
        rank = slot - seg_start.index_select(0, safe_cls)
        valid = (rank < counts.index_select(0, safe_cls)) & ~in_tail
        pick = (src_start.index_select(0, safe_cls) + rank).clamp(0, n - 1)
        src = torch.where(valid, order.index_select(0, pick), 0)
        dst = torch.where(valid, src, n)               # n: the trash row
        chunk_cls = cls_of_slot.view(k_chunks, b)[:, 0].contiguous()
        return _Binning(x, intensity, logits, src.view(k_chunks, b),
                        dst.view(k_chunks, b), _HostRead(chunk_cls))

    def serve(self, binning: _Binning):
        """Wait for the chunk classes, launch every chunk's branch, and
        return (dehazed, intensity, logits) on the device."""
        x = binning.x
        n = x.shape[0]
        out = x.new_zeros((n + 1,) + tuple(x.shape[1:]))
        for k, cls in enumerate(binning.classes.get().tolist()):
            if cls < len(self.branch_applies):
                y = self.branch_applies[cls](x.index_select(0, binning.src[k]))
                out.index_copy_(0, binning.dst[k], y.to(out.dtype))
        return out[:n], binning.intensity, binning.logits

    def __call__(self, x: torch.Tensor, intensity=None):
        return self.serve(self.bin(x, intensity))


def make_device_binned_infer(classifier_apply: Callable,
                             branch_applies: Sequence[Callable],
                             chunk: int = 16, spill: bool = False) -> DeviceBinnedInfer:
    """The device-binned engine: fn(x, intensity=None) -> (dehazed,
    intensity, logits) on x.device (`DeviceBinnedInfer`)."""
    return DeviceBinnedInfer(classifier_apply, branch_applies, chunk=chunk, spill=spill)


def make_sharded_binned_infer(classifier_apply: Callable,
                              branch_applies: Sequence[Callable],
                              devices: Sequence, chunk: int = 16,
                              spill: bool = False) -> Callable:
    """Data-parallel serving: the batch is split into equal shards, one per
    device in `devices` (the counterpart of the JAX package's data `Mesh`),
    and each shard runs the device-binned engine on its device, with the
    binning and the capacity spill local to the shard; no collective, no
    thread. The applies are called with each shard on its device and must
    run there: AdaptiveDehazer.route_sharded passes applies that pick the
    replica of its serving copy on the input's device. Every shard's
    classifier and binning is enqueued before any shard's chunk classes are
    read. Returns fn(x) -> (dehazed, intensity, logits) on x.device; the
    batch must divide into len(devices) shards."""
    devices = [torch.device(d) for d in devices]
    local = make_device_binned_infer(classifier_apply, branch_applies, chunk=chunk,
                                     spill=spill)

    def infer(x: torch.Tensor):
        if x.shape[0] % len(devices):
            raise ValueError(f"a batch of {x.shape[0]} does not split into "
                             f"{len(devices)} equal shards")
        shards = torch.split(x, x.shape[0] // len(devices))
        binned = [local.bin(s.to(d, non_blocking=True)) for s, d in zip(shards, devices)]
        outs = [local.serve(b) for b in binned]
        return tuple(torch.cat([o[i].to(x.device) for o in outs]) for i in range(3))

    return infer


def make_adaptive_infer(classifier_apply: Callable,
                        branch_applies: Sequence[Callable],
                        mode: str = "soft", temperature: float = 0.5) -> Callable:
    """End-to-end adaptive inference, fn(x) -> (dehazed, weights or
    intensity), as the JAX package's make_adaptive_infer:

    - "soft": softmax(logits / temperature) blend of all three branches,
      through `blend3` (kernel K5 on a CUDA tensor; the device decides, so
      there is no use_pallas);
    - "select": a one-hot select over all three branch outputs;
    - "switch": each image through its own branch at batch 1, after one
      read of the labels (pinned memory behind an event on CUDA), where
      the JAX package runs `lax.switch` under `lax.scan`."""
    if mode not in ("soft", "select", "switch"):
        raise ValueError(f"Unknown mode: {mode}")

    def infer(x: torch.Tensor):
        logits, _ = classifier_apply(x)
        if mode == "soft":
            weights = torch.softmax(logits / temperature, dim=1)
            return blend3(weights, *[f(x) for f in branch_applies]), weights
        intensity = torch.argmax(logits, dim=1)
        if mode == "select":
            onehot = nn.functional.one_hot(intensity, 3).to(x.dtype)
            ys = [f(x) for f in branch_applies]
            return sum(onehot[:, i, None, None, None] * y for i, y in enumerate(ys)), intensity
        labels = _HostRead(intensity).get().tolist()
        return torch.cat([branch_applies[c](x[i:i + 1]) for i, c in enumerate(labels)]), intensity

    return infer
