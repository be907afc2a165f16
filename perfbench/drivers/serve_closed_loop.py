"""Closed-loop hard-routed serving: one client hands the entry a numpy batch
and waits for the numpy result, call after call.

The entry is the default-dispatch engine of `AdaptiveDehazer`
(`BinnedAdaptiveEngine.__call__(x, intensity=labels)`: the given labels
route, the classifier still runs), wrapped in the dehazer's own upload
(`_to_device`) and the fetch `route_hard` does (`out.cpu().numpy()`).

The traffic file gives the batch, the image side, the levels' draw
probabilities and attenuations, and the pool: `pool_batches` batches whose
class counts are drawn i.i.d. once from `composition_seed`, so that every
run serves the same set of bucket sizes; the run's seed places the labels
inside each batch, orders the batches and draws the pixels and weights.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.inputs import generator, hazy_images, make_weights
from perfbench.reference.layers import set_rounding
from perfbench.reference.models import INTENSITY_ORDER, Router

SPANS = ("upload", "engine", "fetch")


def build_dehazer(config: dict, state: dict, device):
    """The program under test: the configuration's router with the
    benchmark's weights, behind an AdaptiveDehazer with autotune off."""
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
    pcfg = harness.port_config(config)
    with torch.device("meta"):
        router = create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg)
    router = router.to_empty(device=device)
    router.load_state_dict(state)
    return AdaptiveDehazer(router, None, pcfg, device=device)


def compositions(traffic: dict) -> np.ndarray:
    """(pool_batches, levels) class counts, drawn i.i.d. per image from the
    traffic's fixed composition seed."""
    rng = np.random.default_rng(traffic["composition_seed"])
    draws = rng.choice(len(traffic["levels"]), p=traffic["level_probs"],
                       size=(traffic["pool_batches"], traffic["batch"]))
    return np.stack([np.bincount(d, minlength=len(traffic["levels"])) for d in draws])


def flops_per_image(config: dict, size: int) -> dict:
    """Model FLOPs of one image, counted by FlopCounterMode on the reference
    modules on the meta device: the classifier and each branch."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        ref = Router(config["port"]).eval()
        x = torch.empty(1, size, size, 3)
        out = {}
        for name, mod in [("classifier", ref.classifier)] + list(ref.models.items()):
            counter = FlopCounterMode(display=False)
            with counter, torch.no_grad():
                mod(x)
            out[name] = float(counter.get_total_flops())
    return out


class Cell:
    """One run of a serving cell: set-up, the timed window, the traced
    window, the comparison with the reference."""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.size = config["port"]["dataset"]["img_size"]
        self.batch = traffic["batch"]
        self.rng = np.random.default_rng(self.seed % 2 ** 63)

    # --- set-up -------------------------------------------------------------

    def setup(self) -> None:
        t = self.traffic
        mark = harness.Marks()
        import adam_dehaze_tpu_torch.serving  # noqa: F401
        mark("program imports")
        self.state = make_weights(self.config["port"], self.seed, self.device)
        mark("weights")
        self.dehazer = build_dehazer(self.config, self.state, self.device)
        self.engine = self.dehazer.engine
        mark("program")
        counts = compositions(t)
        gen = generator(self.seed, 3, self.device)
        labels = []
        for c in counts:
            lab = np.repeat(np.arange(len(c)), c)
            labels.append(self.rng.permutation(lab).astype(np.int64))
        self.labels = labels
        flat = torch.as_tensor(np.concatenate(labels), device=self.device)
        images, _ = hazy_images(flat, self.size, t["beta"], t["depth_m"], t["airlight"], gen)
        host = images.cpu().numpy()
        self.pool = [host[i * self.batch:(i + 1) * self.batch] for i in range(len(labels))]
        self.order = self.rng.permutation(len(self.pool))
        mark("inputs")
        for _ in range(t["warmup_passes"]):
            for k in self.order:
                self.call(k)
        self.sync()
        mark("warm-up")
        self.setup_phases = mark.phases

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, k: int, spans: bool = False):
        """The timed path on pool batch k: (numpy output, labels returned)."""
        span = torch.profiler.record_function if spans else (
            lambda name: contextlib.nullcontext())
        with torch.inference_mode():
            with span("upload"):
                x = self.dehazer._to_device(self.pool[k])
            with span("engine"):
                out, lab = self.engine(x, intensity=self.labels[k])
            with span("fetch"):
                y = out.cpu().numpy()
        return y, np.asarray(lab)

    # --- the window -----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Calls back to back for `seconds`; every call started before the
        deadline is waited for and counted."""
        n_levels = len(self.traffic["levels"])
        lat, per_level = [], np.zeros(n_levels, np.int64)
        self.sample, self.slowest = [], None
        self.labels_wrong = failed = i = 0
        keep = self.traffic["check_calls"]
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline:
                break
            k = self.order[i % len(self.order)]
            try:
                y, lab = self.call(k)
            except Exception:       # a failed call counts; the loop goes on
                failed += 1
                y = lab = None
            end = time.perf_counter()
            lat.append(end - t0)
            if lab is not None:
                self.labels_wrong += int(not np.array_equal(lab, self.labels[k]))
                per_level += np.bincount(self.labels[k], minlength=n_levels)
                item = (k, y)
                if self.slowest is None or lat[-1] > self.slowest[0]:
                    self.slowest = (lat[-1], item)
                if len(self.sample) < keep:           # reservoir sample of the calls
                    self.sample.append(item)
                else:
                    j = int(self.rng.integers(0, i + 1))
                    if j < keep:
                        self.sample[j] = item
            i += 1
        elapsed = end - start
        self.images_by_level = per_level
        images = int(per_level.sum())
        return {"attempted": i, "failed": failed, "elapsed_s": elapsed,
                "images": images, "images_by_level": per_level.tolist(),
                "serve_images_per_s": images / elapsed if elapsed > 0 else 0.0,
                "serve_call_p95_ms": harness.percentile(lat, 95) * 1e3 if lat else 0.0}

    def traced(self) -> dict:
        """`trace_calls` calls under the profiler, spans around upload,
        engine and fetch; the program's launch counters over them."""
        from adam_dehaze_tpu_torch.ops.kernels import launch_counters
        n = self.traffic["trace_calls"]
        counters = launch_counters()
        self.sync()
        before = {k: f.launches for k, f in counters.items()}
        per_level = np.zeros(len(self.traffic["levels"]), np.int64)
        with harness.profiled() as prof:
            with torch.profiler.record_function("perfbench.window"):
                for i in range(n):
                    k = self.order[i % len(self.order)]
                    self.call(k, spans=True)
                    per_level += np.bincount(self.labels[k], minlength=len(per_level))
                self.sync()
        launches = {k: f.launches - before[k] for k, f in counters.items()}
        return {"trace": harness.Trace.from_profiler(prof, "perfbench.window"),
                "launches": launches, "calls": n, "spans": SPANS,
                "images_by_branch": dict(zip(INTENSITY_ORDER, per_level.tolist()))}

    # --- work counts ----------------------------------------------------------

    def flops(self) -> dict:
        """Model FLOPs of one image: the classifier's and each branch's."""
        return flops_per_image(self.config, self.size)

    # --- correctness ------------------------------------------------------------

    def items(self):
        """The sampled calls, (pool batch, program output): the reservoir
        sample and the slowest call."""
        return list(self.sample) + ([self.slowest[1]] if self.slowest else [])

    def program_logits(self) -> None:
        """The classifier's logits through the same engine (called without
        labels) on the sampled calls' inputs."""
        with torch.inference_mode():
            self.logits = [self.engine.logits(self.dehazer._to_device(self.pool[k])).float().cpu()
                           for k, _ in self.items()]

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.program_logits()
        del self.engine, self.dehazer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rounding=None) -> Router:
        """The float32 reference with the run's weights (its convs and
        linears rounded to `rounding` for the control)."""
        ref = Router(self.config["port"]).to(self.device)
        ref.load_state_dict(self.state)
        return set_rounding(ref.eval(), rounding)

    def readings(self, control=None, detail=False) -> dict:
        """The numbers compared against the float32 reference, over the
        sampled calls: for all their outputs and for each branch's images
        alone, the RMS error (`out_rms.<level>`) and the same in units of
        the RMS error of the reference itself under autocast in the
        configuration's precision (`out_rms_rel`, `out_rms_rel.<level>`:
        how much a seed's weights amplify rounding varies from seed to
        seed, the ratio less); the RMS error of the classifier's logits
        relative to the reference features' RMS (`logit_rms`); the calls of
        the window whose returned labels were not the given ones.
        `control`: a dtype; the reference rounded to it stands in the
        program's place (the control of the comparison). `detail`: also the
        pooled RMS error, the worst and the median image's, and the worst
        logit error."""
        ref = self.reference()
        compute = harness.compute_dtype(self.config)
        stand_in = self.reference(control) if control is not None else None
        block = self.traffic["reference_block"]
        logit_sq, feat_sq, logit_max = [], [], []
        by_level = {name: [] for name in INTENSITY_ORDER}
        by_level_yard = {name: [] for name in INTENSITY_ORDER}
        with harness.fp32_exact(), torch.no_grad():
            for i, (k, y) in enumerate(self.items()):
                x = torch.as_tensor(self.pool[k], device=self.device)
                lab = self.labels[k]
                for lvl, name in enumerate(INTENSITY_ORDER):
                    rows = np.nonzero(lab == lvl)[0]
                    for s in range(0, rows.size, block):
                        r = torch.as_tensor(rows[s:s + block], device=self.device)
                        want = ref.models[name](x[r])
                        got = (stand_in.models[name](x[r]) if stand_in is not None
                               else torch.as_tensor(y[rows[s:s + block]], device=self.device))
                        by_level[name].append((got - want).square().mean(dim=(1, 2, 3)))
                        with torch.autocast(self.device.type, dtype=compute,
                                            enabled=compute != torch.float32):
                            yard = ref.models[name](x[r]).float()
                        by_level_yard[name].append((yard - want).square().mean(dim=(1, 2, 3)))
                want, feats = (t.cpu() for t in ref.classifier(x))
                got = stand_in.classifier(x)[0].cpu() if stand_in is not None else self.logits[i]
                logit_sq.append((got - want).square().mean())
                feat_sq.append(feats.square().mean())
                logit_max.append((got - want).abs().max() / want.abs().max())
        sq = torch.cat([e for v in by_level.values() for e in v])
        yard_sq = torch.cat([e for v in by_level_yard.values() for e in v])
        # Means and maxima keep a NaN: a non-finite output fails the comparison.
        out = {"out_rms_rel": float((sq.mean() / yard_sq.mean()).sqrt()),
               "logit_rms": float((torch.stack(logit_sq).mean()
                                   / torch.stack(feat_sq).mean()).sqrt()),
               "labels_wrong": float(self.labels_wrong)}
        for name, e in by_level.items():
            if e:
                e = torch.cat(e)
                out[f"out_rms.{name}"] = float(e.mean().sqrt())
                out[f"out_rms_rel.{name}"] = float((e.mean() / torch.cat(
                    by_level_yard[name]).mean()).sqrt())
        if detail:
            out.update(out_rms=float(sq.mean().sqrt()), out_rms_worst_image=float(sq.max().sqrt()),
                       out_rms_median_image=float(sq.median().sqrt()),
                       logit_err_worst=float(torch.stack(logit_max).max()))
        return out
