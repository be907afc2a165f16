"""Headline benchmark of the port: adaptive dehazing end-to-end latency per image.

    python -m adam_dehaze_tpu_torch.bench [--full] [--device cpu]
        [--size 256] [--batch 48] [--iters 30] [--warmup 5]
    python3 main_torch.py --mode bench [--full] [--device cpu]

The port's counterpart of the root bench.py: the same rows, in the same
order, under the same keys, measured on the port's modules. The fog
classifier's forward, the routing and the routed dehazing branch, on the
card at 256^2 in bf16 (the kernels of ops/kernels/ wherever the serving
applies run them), with seeded weights: one torch.Generator seeded at 0
draws the classifier's, the three branches' and then the images x, uniform
in (48, 256, 256, 3). `--device cpu` runs fp32 on the CPU, where every
kernel wrapper takes its plain version; without a card and without it the
command stops at once. The other flags only shrink the run (the CPU tests).

Primary metric (`adaptive_dehaze_ms_per_image_256`): the host-binned
engine (`BinnedAdaptiveEngine`, buckets (2, 4, 16)) on balanced labels, 16
images a class; the device-binned engine takes `value` when it is faster
(`mode` says which). Each row's time is a loop of warm calls: every warm-up
call is forced before the clock starts, and the last call is drained before
it stops. The single-image rows (make_adaptive_infer "switch", blocking p50
and streamed), the detection pipeline (the seeded FCOS detector's forward
and on-device top-k chained onto the engine; host NMS excluded), the
trained-routing family (an experiment's test images and its trained
classifier's labels: fidelity, spill_up, and in the full tier spill,
device spill and queued), the stream rows (run_stream; the device-binned
engine at depths 2, 3 and 4), all-high traffic, the half-resolution rows
and the MFU (FLOPs counted by FlopCounterMode on the modules, against the
card's published bf16 peak) follow; the full tier adds the int8 row (Q1 and
Q2) and random-weight predicted routing.

The serving-autotune cache is read, never written: a hit on
`BENCH_AUTOTUNE_CACHE` (else the experiment's `serving_autotune.json`)
serves the tuned winner and feeds the chunk planner (`autotuned_dispatch`
names the winners); BENCH_AUTOTUNE=0 turns it off. The experiment is
`BENCH_EXPERIMENT`, else the newest `experiments/full_system*` with a
config.yaml (a `train_all` of configs/full_system_cuda.yaml with
`--exp_name full_system`); without one the trained rows are skipped. The
resolution policy is `BENCH_RESOLUTION_POLICY`, else the experiment's
`resolution_policy.json`. BENCH_BUDGET_S (1500 s, 3600 s in the full tier;
0 turns it off) skips the optional rows once spent; the primary row always
runs. If the engine fails, the soft three-branch blend (kernel K5) is
measured instead under a metric name of its own.

Prints `[bench launches] {row: {kernel: launches}}` on stderr (each row's
kernel launches, counters at 0 as the row starts), then one JSON line on
stdout: bench.py's keys, plus `device` (the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them,
or "cpu").
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import signal
import sys
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER

# The upstream reference's own claim for its GPU: 30 ms/image of average
# adaptive inference (its README.md:149, as bench.py cites it). It is not a
# reading of this card; vs_baseline = this / ours.
BASELINE_MS_PER_IMAGE = 30.0
BATCH = 48  # divisible by 3 for balanced binning
SIZE = 256
WARMUP = 5
ITERS = 30
SINGLE_CALLS = 20
# The per-bucket enqueue cost the chunk planner assumes where a cache entry
# has no measured `dispatch_ms` (bench.py's constant).
DISPATCH_MS = 0.35
# What the int8 row runs on the card.
INT8_LOWERING = {"cuda": "Q1 int8_quantize + Q2 int8_conv (wgmma s8; mma.sync on RGB inputs)",
                 "cpu": "plain int8 reference (cpu)"}


class _Budget:
    """bench.py's `_budget_ok`: once `seconds` have passed since the start
    (0: never), optional rows are skipped with a message."""

    def __init__(self, seconds: float):
        self.t0 = time.perf_counter()
        self.seconds = seconds

    def ok(self, label: str) -> bool:
        if self.seconds and time.perf_counter() - self.t0 > self.seconds:
            print(f"bench budget ({self.seconds:.0f}s) exceeded; skipping {label}",
                  file=sys.stderr)
            return False
        return True


def _install_emergency_dump(result):
    """On SIGTERM after the primary row was measured, print the partial
    line (`"partial": true`) instead of losing the run. Returns the handler
    it replaced (None where none can be installed)."""
    def handler(signum, frame):
        if "value" in result:
            result["partial"] = True
            if "vs_baseline" not in result:
                result["vs_baseline"] = round(BASELINE_MS_PER_IMAGE / result["value"], 2)
            print(json.dumps(result), flush=True)
        sys.exit(1)

    try:
        return signal.signal(signal.SIGTERM, handler)
    except (ValueError, OSError):
        return None  # not the main thread


def _first_tensor(out) -> torch.Tensor:
    while not isinstance(out, torch.Tensor):
        out = next(iter(out.values())) if isinstance(out, dict) else out[0]
    return out


def _sync(out) -> float:
    """Wait for the card, then read one scalar of `out` (its first tensor)."""
    t = _first_tensor(out)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


def _time(fn, iters: int, warmup: int) -> float:
    """Seconds a call of fn(): each warm-up call forced before the clock
    starts, then `iters` calls back to back, the last drained before the
    clock stops."""
    for _ in range(warmup):
        _sync(fn())
    start = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    _sync(out)
    return (time.perf_counter() - start) / iters


def _fraction(iters: int, div: int) -> int:
    """bench.py's max(ITERS // div, 5), never more than `iters`."""
    return max(iters // div, min(5, iters))


def _default_experiment():
    """BENCH_EXPERIMENT, else the newest experiments/full_system* with a
    config.yaml, else None."""
    exp = os.environ.get("BENCH_EXPERIMENT")
    if exp:
        return exp
    found = sorted(glob.glob(os.path.join("experiments", "full_system*", "config.yaml")),
                   key=os.path.getmtime, reverse=True)
    return os.path.dirname(found[0]) if found else None


def _tuned_artifact(env_key: str, exp_file: str):
    """A tuning artifact: the env override, else the experiment's file,
    else None (the TPU's snapshots under benchmarks/ are never read)."""
    p = os.environ.get(env_key)
    if p:
        return p
    exp = _default_experiment()
    if exp:
        cand = os.path.join(exp, exp_file)
        if os.path.isfile(cand):
            return cand
    return None


def _trained_routing_inputs(bucket: int, size: int, device: torch.device):
    """The experiment's test images and its trained classifier's labels:
    (x_real (3 * bucket, size, size, 3) on `device`, labels, accuracy), or
    None when an artifact is absent. The classifier runs in fp32 over the
    whole test split in chunks of 3 * bucket (the last padded); accuracy is
    the split's, and `bucket` evenly spaced images a level are kept."""
    exp = _default_experiment()
    if exp is None:
        return None
    cfg_path = os.path.join(exp, "config.yaml")
    if not os.path.isfile(cfg_path):
        return None
    from adam_dehaze_tpu_torch.config import load_config, update_checkpoint_paths
    from adam_dehaze_tpu_torch.data.dataset import _imread_rgb
    from adam_dehaze_tpu_torch.evaluation.evaluate import _load_joint
    from adam_dehaze_tpu_torch.training.checkpoint import best_model_path
    config = update_checkpoint_paths(load_config(cfg_path), exp)
    test_root = os.path.join(config["dataset"]["test_path"], "test")
    if not (os.path.isdir(test_root)
            and os.path.exists(best_model_path(config["joint_training"]["checkpoint_dir"]))):
        return None
    imgs, gts, keep = [], [], []
    for lbl, level in enumerate(INTENSITY_ORDER):
        d = os.path.join(test_root, level, "hazy")
        names = sorted(n for n in os.listdir(d) if n.endswith((".png", ".jpg")))
        if len(names) < bucket:
            return None
        sel = set(np.linspace(0, len(names) - 1, bucket).astype(int).tolist())
        for i, n in enumerate(names):
            imgs.append(_imread_rgb(os.path.join(d, n), size))
            gts.append(lbl)
            keep.append(i in sel)
    x_all = torch.from_numpy(np.stack(imgs)).to(device)
    gts, keep = np.asarray(gts), np.asarray(keep)
    clf = _load_joint(config, device).classifier
    chunk = 3 * bucket
    labels = []
    for i in range(0, x_all.shape[0], chunk):
        part = x_all[i:i + chunk]
        real = part.shape[0]
        if real < chunk:
            part = torch.cat([part, part[:1].expand(chunk - real, *part.shape[1:])])
        labels.append(torch.argmax(clf(part)[0], dim=1)[:real].cpu().numpy())
    labels = np.concatenate(labels)
    acc = float((labels == gts).mean())
    return x_all[torch.from_numpy(np.nonzero(keep)[0]).to(device)], labels[keep], acc


def seeded(config, device: torch.device, batch: int, size: int):
    """The config's classifier and three branches, and the images x: one
    generator seeded at 0 draws the weights (classifier, low, medium, high,
    in that order), then x, uniform in (batch, size, size, 3). Models in
    eval mode and x on `device`: (classifier, {level: branch}, x)."""
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.nn.blocks import init_params_
    gen = torch.Generator().manual_seed(0)
    classifier = init_params_(create_classifier(config), gen).to(device).eval()
    made = create_branch_models(config)
    branches = {n: init_params_(made[n], gen).to(device).eval() for n in INTENSITY_ORDER}
    x = torch.rand((batch, size, size, 3), generator=gen).to(device)
    return classifier, branches, x


def build_callables(classifier, branches, dtype: torch.dtype, bucket: int, size: int,
                    cache_path=None):
    """The bench's serving callables: the classifier's serving apply, each
    branch's (the tuned winner on a hit of the autotune cache at `cache_path`,
    read only; else make_serving_apply), the primary engine
    (BinnedAdaptiveEngine, buckets (2, 4, bucket); on a hit for all three
    branches its planner gets each winner's `dispatch_ms`, DISPATCH_MS where
    the entry has none, and the winner's ms per row beyond it), the
    device-binned engine (chunk `bucket`) and the switch apply."""
    from adam_dehaze_tpu_torch.models.routing import (
        BinnedAdaptiveEngine,
        make_adaptive_infer,
        make_device_binned_infer,
    )
    from adam_dehaze_tpu_torch.ops.serving_apply import (
        make_classifier_serving_apply,
        make_serving_apply,
    )
    from adam_dehaze_tpu_torch.serving_autotune import load_cached
    clf = make_classifier_serving_apply(classifier, dtype)
    applies = [make_serving_apply(branches[n], dtype) for n in INTENSITY_ORDER]
    dispatch_used, hits = {}, {}
    if cache_path:
        sample_shape = (bucket, size, size, 3)
        for i, n in enumerate(INTENSITY_ORDER):
            try:
                fn, hit = load_cached(branches[n], dtype, sample_shape, cache_path)
            except Exception as e:
                print(f"autotuned dispatch for {n} failed ({type(e).__name__}: {e})",
                      file=sys.stderr)
                continue
            if fn is not None:
                applies[i] = fn
                dispatch_used[n] = hit["best"]
                hits[n] = hit
    engine = BinnedAdaptiveEngine(clf, applies, buckets=(2, 4, bucket))
    ms = [(hits.get(n, {}).get("table") or {}).get(hits.get(n, {}).get("best"))
          for n in INTENSITY_ORDER]
    if all(ms):
        fixed = [float(hits[n].get("dispatch_ms", DISPATCH_MS)) for n in INTENSITY_ORDER]
        engine.set_chunk_costs(fixed, [max(float(m) - f, 1e-6) / bucket
                                       for m, f in zip(ms, fixed)])
    return SimpleNamespace(
        classifier_apply=clf, applies=applies, engine=engine,
        device_binned=make_device_binned_infer(clf, applies, chunk=bucket),
        switch=make_adaptive_infer(clf, applies, mode="switch"),
        dispatch_used=dispatch_used)


class _Launches:
    """Kernel launches by row: the counters are set to 0 as a row starts
    and read as it ends."""

    def __init__(self):
        self.rows = {}

    @contextlib.contextmanager
    def row(self, name: str):
        from adam_dehaze_tpu_torch.ops.kernels import launch_counters, reset_launch_counts
        reset_launch_counts()
        try:
            yield
        finally:
            self.rows[name] = {k: fn.launches for k, fn in launch_counters().items()
                               if fn.launches}


def _count_flops(classifier, branches, x, bucket, lowres=None):
    """FLOPs per image (GFLOP) of the adaptive accounting: the classifier's
    at the whole batch plus the mean of the branches' at `bucket` (a level
    in `lowres` through make_lowres_apply with its dial), each counted by
    FlopCounterMode on the modules, which compute what the serving applies
    do (a kernel launched through ctypes is invisible to the counter)."""
    from adam_dehaze_tpu_torch.ops.resolution import make_lowres_apply
    from adam_dehaze_tpu_torch.utils.profiling import model_flops
    lowres = lowres or {}
    xb = x[:bucket]
    per_branch = [
        (model_flops(make_lowres_apply(branches[n], **lowres[n]), xb) if n in lowres
         else model_flops(branches[n], xb)) or 0.0
        for n in INTENSITY_ORDER]
    clf = model_flops(classifier, x) or 0.0
    return (clf / x.shape[0] + sum(f / bucket for f in per_branch) / 3.0) / 1e9


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--full", action="store_true",
                   help="the full tier (also BENCH_FULL=1): int8, spill, device spill, "
                        "queued and random-weight predicted routing")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--batch", type=int, default=BATCH, help="a multiple of 3")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--warmup", type=int, default=WARMUP)
    args = p.parse_args(argv)
    if args.batch % 3:
        p.error(f"--batch {args.batch} is not a multiple of 3")

    from adam_dehaze_tpu_torch.tools.autotune_serving import serving_device
    device = serving_device(args.device)
    full = args.full or os.environ.get("BENCH_FULL", "0") == "1"
    budget = _Budget(float(os.environ.get("BENCH_BUDGET_S", "3600" if full else "1500") or 0))
    result = {"unit": "ms/image"}
    prev = _install_emergency_dump(result)
    try:
        with torch.inference_mode():
            _run(args, device, full, budget, result)
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
    print(json.dumps(result), flush=True)
    return result


def _run(args, device: torch.device, full: bool, budget: _Budget, result: dict) -> None:
    from adam_dehaze_tpu_torch.config import compute_dtype, load_config
    from adam_dehaze_tpu_torch.models.routing import (
        BinnedAdaptiveEngine,
        make_adaptive_infer,
        make_device_binned_infer,
    )
    from adam_dehaze_tpu_torch.tools.measure_train_throughput import nvidia_smi
    from adam_dehaze_tpu_torch.utils.profiling import device_flops_estimate

    on_card = device.type == "cuda"
    config = load_config()
    config["cuda"]["compute_dtype"] = "bfloat16" if on_card else "float32"
    dtype = compute_dtype(config)
    batch, size, iters, warmup = args.batch, args.size, args.iters, args.warmup
    bucket = batch // 3
    third, half = _fraction(iters, 3), _fraction(iters, 2)
    result["device"] = nvidia_smi(device) or "cpu"

    classifier, branches, x = seeded(config, device, batch, size)
    cache = (_tuned_artifact("BENCH_AUTOTUNE_CACHE", "serving_autotune.json")
             if os.environ.get("BENCH_AUTOTUNE", "1") != "0" else None)
    calls = build_callables(classifier, branches, dtype, bucket, size, cache)
    clf_serving, serving_applies, engine = calls.classifier_apply, calls.applies, calls.engine
    balanced = np.repeat(np.arange(3), bucket)
    skewed = np.full(batch, 2)  # all-high: worst-case adaptive FLOPs
    launches = _Launches()
    if calls.dispatch_used:
        result["autotuned_dispatch"] = calls.dispatch_used

    def per_image(seconds):
        return round(seconds / batch * 1000.0, 4)

    try:
        with launches.row("binned"):
            per_iter = _time(lambda: engine(x, intensity=balanced)[0], iters, warmup)
        result["metric"] = "adaptive_dehaze_ms_per_image_256"
        result["value"] = per_image(per_iter)
        result["mode"] = "binned"

        # The binning on the device (one read of the chunk classes a call);
        # the same adaptive accounting, and the primary value when faster.
        dev_fn = calls.device_binned
        try:
            if not budget.ok("device_binned"):
                raise RuntimeError("budget")
            balanced_dev = torch.from_numpy(balanced).to(device)
            with launches.row("device_binned"):
                per_iter_dev = _time(lambda: dev_fn(x, balanced_dev)[0], iters, warmup)
            result["device_binned_ms_per_image"] = per_image(per_iter_dev)
            if per_iter_dev < per_iter:
                result["host_binned_ms_per_image"] = result["value"]
                result["value"] = result["device_binned_ms_per_image"]
                result["mode"] = "device_binned"
                per_iter = per_iter_dev
        except Exception as e:
            print(f"device-binned variant skipped ({type(e).__name__}: {e})", file=sys.stderr)

        # Single-image latency through the switch (each image at batch 1 on
        # its own branch), early: the batch-1 rows must not fall off the end.
        if budget.ok("single_image"):
            x1 = x[:1]

            def _switch_rows(fn, prefix):
                """Blocking p50 and streamed latency of a batch-1 switch apply."""
                with launches.row(prefix):
                    _sync(fn(x1))
                    lat = []
                    for _ in range(SINGLE_CALLS):
                        t0 = time.perf_counter()
                        _sync(fn(x1))
                        lat.append((time.perf_counter() - t0) * 1000.0)
                    result[f"{prefix}_p50_ms"] = round(float(np.percentile(lat, 50)), 3)
                    t0 = time.perf_counter()
                    outs = [fn(x1) for _ in range(SINGLE_CALLS)]
                    _sync(outs[-1])
                    result[f"{prefix}_streamed_ms"] = round(
                        (time.perf_counter() - t0) / SINGLE_CALLS * 1000.0, 3)

            if full:
                _switch_rows(calls.switch, "single_image")
            try:
                from adam_dehaze_tpu_torch.ops.resolution import make_lowres_apply
                from adam_dehaze_tpu_torch.resolution_autotune import (
                    load_policy,
                    policy_to_lowres,
                )
                pol = load_policy(_tuned_artifact("BENCH_RESOLUTION_POLICY",
                                                  "resolution_policy.json"))
                lowres_g = policy_to_lowres(pol) if pol else {}
                if lowres_g:
                    g_applies1 = [make_lowres_apply(f, **lowres_g[n]) if n in lowres_g else f
                                  for n, f in zip(INTENSITY_ORDER, serving_applies)]
                    _switch_rows(make_adaptive_infer(clf_serving, g_applies1, mode="switch"),
                                 "single_image_guarded")
                elif not full:
                    # No tuned policy: the plain switch is the batch-1 row.
                    _switch_rows(calls.switch, "single_image")
            except Exception as e:
                print(f"guarded single-image variant skipped ({type(e).__name__}: {e})",
                      file=sys.stderr)

        # The whole pipeline with detection: the engine, ImageNet
        # renormalisation, the seeded detector's forward and its on-device
        # top-k; the host NMS over the candidates is excluded.
        try:
            if not budget.ok("detection_pipeline"):
                raise RuntimeError("budget")
            from adam_dehaze_tpu_torch.models.detection import (
                create_detection_model,
                imagenet_normalize,
            )
            det = create_detection_model(config, device=device)
            det.init(torch.Generator().manual_seed(7), image_size=size)

            def _pipeline():
                dehazed = engine(x, intensity=balanced)[0]
                return det.candidates(imagenet_normalize(dehazed))[0]["scores"]

            with launches.row("detection_pipeline"):
                per_iter_det = _time(_pipeline, third, warmup)
            result["with_detection_ms_per_image"] = per_image(per_iter_det)
            # Against the same host-binned engine the pipeline chains.
            host_ms = result.get("host_binned_ms_per_image", result["value"])
            result["detection_overhead_ms_per_image"] = round(
                per_iter_det / batch * 1000.0 - host_ms, 4)
        except Exception as e:
            print(f"detection pipeline variant skipped ({type(e).__name__}: {e})",
                  file=sys.stderr)

        # Trained-classifier routing: the experiment's test images binned by
        # its trained classifier's labels, through the same engine.
        try:
            trained = (_trained_routing_inputs(bucket, size, device)
                       if budget.ok("trained_routing") else None)
            if trained is not None:
                x_real, labels_trained, acc = trained
                with launches.row("predicted_routing_trained"):
                    per_iter_tr = _time(lambda: engine(x_real, intensity=labels_trained)[0],
                                        iters, warmup)
                ms_tr = per_iter_tr / batch * 1000.0
                result["predicted_routing_trained_ms_per_image"] = round(ms_tr, 4)
                result["trained_routing_acc"] = round(acc, 4)
                # Against the host engine's balanced number even when the
                # device engine took `value`: the skew's cost alone.
                oracle_host = result.get("host_binned_ms_per_image", result["value"])
                result["predicted_trained_minus_oracle_ms"] = round(ms_tr - oracle_host, 4)
                if full:
                    with launches.row("spill_routing_trained"):
                        per_iter_sp = _time(
                            lambda: engine(x_real, intensity=labels_trained, spill=True)[0],
                            iters, warmup)
                    result["spill_routing_trained_ms_per_image"] = per_image(per_iter_sp)
                with launches.row("spill_up_routing_trained"):
                    per_iter_spu = _time(
                        lambda: engine(x_real, intensity=labels_trained, spill="up")[0],
                        iters, warmup)
                result["spill_up_routing_trained_ms_per_image"] = per_image(per_iter_spu)
                try:
                    if not full:
                        raise RuntimeError("full tier only")
                    dev_sp = make_device_binned_infer(clf_serving, serving_applies,
                                                      chunk=bucket, spill=True)
                    lab_dev = torch.from_numpy(labels_trained).to(device)
                    with launches.row("device_spill_trained"):
                        per_iter_dsp = _time(lambda: dev_sp(x_real, lab_dev)[0], iters, warmup)
                    result["device_spill_trained_ms_per_image"] = per_image(per_iter_dsp)
                except Exception as e:
                    print(f"device-spill variant skipped ({type(e).__name__}: {e})",
                          file=sys.stderr)
                # Queued serving (run_queued): three batches of `bucket` in
                # the trained labels' order. Each rep forces every warm-up
                # call, then times the loop and the drain of the timed
                # calls' accumulators only: 3 reps, min and median.
                try:
                    if not full:
                        raise RuntimeError("full tier only")
                    qbatches = [x_real[i:i + bucket] for i in range(0, x_real.shape[0], bucket)]
                    qlabels = [labels_trained[i:i + bucket]
                               for i in range(0, x_real.shape[0], bucket)]

                    def _run_q():
                        acc = None
                        for out, _g, _c in engine.run_queued(qbatches, queue_bucket=bucket,
                                                             intensities=qlabels):
                            s = out.float().sum()
                            acc = s if acc is None else acc + s
                        return acc

                    reps = []
                    with launches.row("queued_routing_trained"):
                        for _ in range(3):
                            for _ in range(warmup):
                                _sync(_run_q())
                            accs = []
                            t0 = time.perf_counter()
                            for _ in range(third):
                                accs.append(_run_q())
                            for a in accs:
                                _sync(a)
                            reps.append((time.perf_counter() - t0) / third / batch * 1000.0)
                    result["queued_routing_trained_ms_per_image"] = round(min(reps), 4)
                    result["queued_routing_trained_ms_median"] = round(float(np.median(reps)), 4)
                    result["queued_routing_trained_ms_samples"] = [round(r, 4) for r in reps]
                except Exception as e:
                    print(f"queued variant skipped ({type(e).__name__}: {e})", file=sys.stderr)
        except Exception as e:
            print(f"trained-routing variant skipped ({type(e).__name__}: {e})", file=sys.stderr)

        # Steady-state stream: run_stream enqueues batch k+1's classifier
        # before batch k's labels are read. Only the last batch is synced.
        if budget.ok("stream"):
            n_stream = 12
            with launches.row("stream"):
                for _ in engine.run_stream([x] * 2, intensities=[balanced] * 2):
                    pass  # warm
                t0 = time.perf_counter()
                last = None
                for out, _lab in engine.run_stream([x] * n_stream,
                                                   intensities=[balanced] * n_stream):
                    last = out
                _sync(last)
            stream_per_img = (time.perf_counter() - t0) / (n_stream * batch)
            result["stream_ms_per_image"] = round(stream_per_img * 1000.0, 4)
            result["stream_imgs_per_sec_per_chip"] = round(1.0 / stream_per_img, 1)

        # The device-binned engine over a stream, `depth` batches binned
        # ahead: a batch is served once `depth` binnings wait, and its labels
        # are fetched (from pinned memory behind an event) after that.
        try:
            if "device_binned_ms_per_image" not in result:
                raise RuntimeError("device-binned engine unavailable")
            if not budget.ok("device_binned_stream"):
                raise RuntimeError("budget")
            from adam_dehaze_tpu_torch.models.routing import _HostRead
            n_dev_stream = 12
            labels_dev = torch.from_numpy(balanced).to(device)

            def _dev_stream(n_batches, depth):
                pending, last = deque(), None

                def serve():
                    nonlocal last
                    binning, labels = pending.popleft()
                    last = dev_fn.serve(binning)[0]
                    labels.get()

                for _ in range(n_batches):
                    binning = dev_fn.bin(x, labels_dev)
                    pending.append((binning, _HostRead(binning.intensity)))
                    if len(pending) >= depth:
                        serve()
                while pending:
                    serve()
                _sync(last)

            best = (float("inf"), 0)
            with launches.row("device_binned_stream"):
                for depth in (2, 3, 4):
                    _dev_stream(2, depth)  # warm
                    t0 = time.perf_counter()
                    _dev_stream(n_dev_stream, depth)
                    best = min(best, ((time.perf_counter() - t0) / (n_dev_stream * batch),
                                      depth))
            dev_stream_per_img, best_depth = best
            result["device_binned_stream_ms_per_image"] = round(dev_stream_per_img * 1000.0, 4)
            result["device_binned_stream_imgs_per_sec"] = round(1.0 / dev_stream_per_img, 1)
            result["device_binned_stream_depth"] = best_depth
        except Exception as e:
            print(f"device-binned stream skipped ({type(e).__name__}: {e})", file=sys.stderr)

        # All-high traffic: the same engine, no balance.
        if budget.ok("skewed"):
            with launches.row("skewed"):
                per_iter_skew = _time(lambda: engine(x, intensity=skewed)[0], third, warmup)
            result["skewed_all_high_ms_per_image"] = per_image(per_iter_skew)

        # Medium and high at half resolution, their corrections lifted back
        # by the guided filter (ops/resolution.py).
        try:
            if not budget.ok("lowres"):
                raise RuntimeError("budget")
            from adam_dehaze_tpu_torch.ops.resolution import make_lowres_apply
            engine_lr = BinnedAdaptiveEngine(
                clf_serving, [serving_applies[0]] + [make_lowres_apply(f)
                                                    for f in serving_applies[1:]],
                buckets=(bucket,))
            with launches.row("lowres_medhigh"):
                per_iter_lr = _time(lambda: engine_lr(x, intensity=balanced)[0], third, warmup)
            result["lowres_medhigh_ms_per_image"] = per_image(per_iter_lr)
        except Exception as e:
            print(f"lowres variant skipped ({type(e).__name__}: {e})", file=sys.stderr)

        # The quality-guarded per-branch {full, lowres} policy of the
        # experiment (tools/autotune_resolution.py); its FLOPs counted on
        # the dial it runs.
        try:
            if not budget.ok("guarded_lowres"):
                raise RuntimeError("budget")
            from adam_dehaze_tpu_torch.ops.resolution import make_lowres_apply
            from adam_dehaze_tpu_torch.resolution_autotune import load_policy, policy_to_lowres
            policy = load_policy(_tuned_artifact("BENCH_RESOLUTION_POLICY",
                                                 "resolution_policy.json"))
            if policy is not None:
                lowres = policy_to_lowres(policy)
                result["resolution_policy"] = {
                    lvl: policy["levels"][lvl].get("choice", "full")
                    for lvl in INTENSITY_ORDER if lvl in policy.get("levels", {})}
                if not lowres:
                    # Full resolution everywhere: the guarded row is the primary.
                    result["guarded_lowres_ms_per_image"] = result["value"]
                elif (set(lowres) == {"medium", "high"}
                      and all(v == {"scale": 2, "mode": "guided", "radius": 4}
                              for v in lowres.values())
                      and "lowres_medhigh_ms_per_image" in result):
                    # The dial of the row above.
                    result["guarded_lowres_ms_per_image"] = result["lowres_medhigh_ms_per_image"]
                else:
                    engine_g = BinnedAdaptiveEngine(
                        clf_serving, [make_lowres_apply(f, **lowres[n]) if n in lowres else f
                                      for n, f in zip(INTENSITY_ORDER, serving_applies)],
                        buckets=(bucket,))
                    with launches.row("guarded_lowres"):
                        per_iter_g = _time(lambda: engine_g(x, intensity=balanced)[0], third,
                                           warmup)
                    result["guarded_lowres_ms_per_image"] = per_image(per_iter_g)
                g_ms = result.get("guarded_lowres_ms_per_image")
                if g_ms:
                    per_image_g = _count_flops(classifier, branches, x, bucket, lowres)
                    result["guarded_lowres_gflops_per_image"] = round(per_image_g, 1)
                    result["guarded_lowres_mfu_pct"] = (
                        round(per_image_g * 1e9 / (g_ms / 1e3)
                              / device_flops_estimate(device) * 100.0, 1) if on_card else None)
        except Exception as e:
            print(f"guarded-lowres variant skipped ({type(e).__name__}: {e})", file=sys.stderr)

        # Routing by the random-weight classifier's own argmax (arbitrary
        # skew, pad waste included).
        if full and budget.ok("predicted_routing"):
            with launches.row("predicted_routing"):
                per_iter_pred = _time(lambda: engine(x)[0], third, warmup)
            result["predicted_routing_ms_per_image"] = per_image(per_iter_pred)

        # The balanced primary row's MFU from counted FLOPs.
        gflops = _count_flops(classifier, branches, x, bucket)
        result["flops_source"] = "flop_counter"
        result["measured_gflops_per_image"] = round(gflops, 1)
        peak = device_flops_estimate(device) if on_card else None
        result["mfu_pct"] = (round(gflops * 1e9 * batch / per_iter / peak * 100.0, 1)
                             if peak else None)
        result["assumed_peak_tflops"] = peak / 1e12 if peak else None

        # Int8 serving (ops/quant.py): every ConvBlock conv through Q1
        # (per-image quantize) and Q2 (int8 conv), BN and ReLU in Q2's
        # epilogue; the low branch through its modules, never K1.
        try:
            if not full:
                raise RuntimeError("full tier only")
            if not budget.ok("int8"):
                raise RuntimeError("budget")
            from adam_dehaze_tpu_torch.ops.quant import quantize_apply
            engine_q = BinnedAdaptiveEngine(
                clf_serving, [quantize_apply(branches[n], dtype) for n in INTENSITY_ORDER],
                buckets=(bucket,))
            with launches.row("int8"):
                per_iter_q = _time(lambda: engine_q(x, intensity=balanced)[0], half, warmup)
            result["int8_ms_per_image"] = per_image(per_iter_q)
            result["int8_lowering"] = INT8_LOWERING[device.type]
        except Exception as e:
            print(f"int8 variant skipped ({type(e).__name__}: {e})", file=sys.stderr)

    except Exception as e:  # never lose the run entirely
        print(f"binned engine failed ({type(e).__name__}: {e}); "
              "reporting the soft blend under its own metric name", file=sys.stderr)
        soft = make_adaptive_infer(clf_serving, serving_applies, mode="soft", temperature=0.5)
        with launches.row("soft_fallback"):
            per_iter = _time(lambda: soft(x)[0], iters, warmup)
        # Another metric name: three branches an image is not the binned trend.
        result["metric"] = "adaptive_dehaze_soft_fallback_ms_per_image_256"
        result["value"] = per_image(per_iter)
        result["mode"] = "soft_fallback"

    # The throughput headline is the fastest serving mode; `value` stays the
    # per-batch latency.
    best_ms = min(result["value"], result.get("stream_ms_per_image", float("inf")),
                  result.get("device_binned_stream_ms_per_image", float("inf")))
    result["best_serving_ms_per_image"] = round(best_ms, 4)
    result["imgs_per_sec_per_chip"] = round(1000.0 / best_ms, 1)
    result["vs_baseline"] = round(BASELINE_MS_PER_IMAGE / result["value"], 2)
    result["bench_wall_s"] = round(time.perf_counter() - budget.t0, 1)
    print(f"[bench launches] {json.dumps(launches.rows)}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
