"""Quality-guarded resolution dispatch: per branch, full resolution or the
half-resolution dial of ops/resolution.py, chosen by measuring both on
held-out probe images and adopting the dial only where its PSNR clears a
floor relative to full resolution.

Counterpart of adam_dehaze_tpu/resolution_autotune.py, with the same policy
JSON. serving_autotune.py only times applies that compute the same
function; the dial changes the outputs, so it is gated here, on quality,
instead. Each branch is scored on probe images of its own class (oracle
labels, so that routing errors do not leak into a per-branch decision),
timed at the serving batch, and the cheapest candidate whose PSNR is at
least the full resolution's less `floor_db` wins. Full resolution always
clears its own floor, so the tuner falls back to the exact serving path
wherever the dial loses quality.

The decision belongs to the trained weights and the corpus, so the policy
is kept per experiment (`resolution_policy.json`) and read by the serving
API:

    python -m adam_dehaze_tpu_torch.tools.autotune_resolution --experiment experiments/x
    dehazer.route_hard(images, lowres="auto")

The probe split must be held out from every reported evaluation (the tool
takes the val split; quality is reported on test).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER
from adam_dehaze_tpu_torch.ops.image import psnr
from adam_dehaze_tpu_torch.ops.resolution import make_lowres_apply

# The dials tried per branch; each is timed (or ranked by its FLOP proxy
# when timing is off). The names are the policy's keys.
DEFAULT_CANDIDATES = (
    {"name": "guided_r4_s2", "mode": "guided", "radius": 4, "scale": 2},
    {"name": "guided_r2_s2", "mode": "guided", "radius": 2, "scale": 2},
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def _time_ms(fn: Callable, x: torch.Tensor, iters: int, warm: int = 1) -> float:
    """Mean ms of fn(x) over `iters` runs: the host clock around the loop,
    the device drained before the clock starts and again before it stops."""
    for _ in range(warm):
        fn(x)
    _sync(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    _sync(x.device)
    return (time.perf_counter() - t0) / iters * 1000.0


@torch.inference_mode()
def _batched_psnr(apply_fn: Callable, hazy: np.ndarray, clear: np.ndarray, batch: int,
                  device: torch.device) -> float:
    """Mean PSNR of apply_fn over (n, H, W, C) probe pairs, served in batches
    of exactly `batch` rows (the last one padded with its last image)."""
    n = hazy.shape[0]
    vals = []
    for i in range(0, n, batch):
        idx = np.arange(i, min(i + batch, n))
        pad = batch - idx.size
        full = np.concatenate([idx, np.repeat(idx[-1:], pad)]) if pad else idx
        out = apply_fn(torch.from_numpy(hazy[full]).to(device))
        target = torch.from_numpy(clear[idx]).to(device)
        vals.append(psnr(out.float()[:idx.size], target).cpu().numpy())
    return float(np.concatenate(vals).mean())


def tune_resolution_policy(
        branch_applies: Sequence[Callable],
        probe_hazy: np.ndarray, probe_clear: np.ndarray, probe_levels: np.ndarray,
        floor_db: float = 0.0, candidates: Sequence[dict] = DEFAULT_CANDIDATES,
        batch: int = 16, iters: int = 5, time_candidates: bool = True,
        cache_path: Optional[str] = None, device="cuda") -> dict:
    """Measure full resolution and every candidate per branch on that
    branch's probe images; return the policy (and write it to `cache_path`).

    branch_applies: the serving applies in INTENSITY_ORDER, on `device` (the
    dial wraps whatever serves the branch). probe_*: held-out hazy and clear
    pairs (n, H, W, 3) float32 with oracle labels (n,). floor_db: a
    candidate is eligible when its PSNR >= the full resolution's - floor_db.
    time_candidates=False skips the timing and ranks the eligible candidates
    by the FLOP proxy 1/scale^2, ties broken by PSNR.

    A candidate that a kernel apply refuses by shape up front (its
    ValueError) or that runs out of device memory lands in its table as an
    `error` row and loses; any other failure raises."""
    device = torch.device(device)
    probe_levels = np.asarray(probe_levels)
    policy: Dict[str, dict] = {}
    for lvl_i, level in enumerate(INTENSITY_ORDER):
        if lvl_i >= len(branch_applies):
            break
        base = branch_applies[lvl_i]
        sel = probe_levels == lvl_i
        if not sel.any():
            policy[level] = {"choice": "full", "reason": "no probe images"}
            continue
        hz, cl = probe_hazy[sel], probe_clear[sel]
        psnr_full = _batched_psnr(base, hz, cl, batch, device)
        x_t = None
        if time_candidates:
            # Timed at the padded batch shape that the PSNR pass served.
            reps = -(-batch // hz.shape[0])
            x_t = torch.from_numpy(np.tile(hz, (reps, 1, 1, 1))[:batch]).to(device)
        ms_full = _time_ms(base, x_t, iters) if time_candidates else None
        table: Dict[str, dict] = {
            "full": {"psnr": round(psnr_full, 4),
                     **({"ms": round(ms_full, 3)} if ms_full is not None else {})}}
        # (cost, -psnr) minimisation; full's cost proxy is 1.0.
        best = (ms_full if time_candidates else 1.0), -psnr_full, "full", None
        for cand in candidates:
            fn = make_lowres_apply(base, scale=cand["scale"], mode=cand["mode"],
                                   radius=cand.get("radius", 4))
            try:
                psnr_c = _batched_psnr(fn, hz, cl, batch, device)
                ms_c = _time_ms(fn, x_t, iters) if time_candidates else None
            except (ValueError, torch.cuda.OutOfMemoryError) as e:
                table[cand["name"]] = {"error": f"{type(e).__name__}: {e}"[:160]}
                continue
            row = {"psnr": round(psnr_c, 4)}
            if ms_c is not None:
                row["ms"] = round(ms_c, 3)
            eligible = psnr_c >= psnr_full - floor_db
            row["eligible"] = bool(eligible)
            table[cand["name"]] = row
            if eligible:
                cost = ms_c if time_candidates else 1.0 / cand["scale"] ** 2
                key = (cost, -psnr_c, cand["name"], cand)
                if key[:2] < best[:2]:
                    best = key
        _, _, choice, cand = best
        entry = {"choice": choice, "psnr_full": round(psnr_full, 4),
                 "n_probe": int(sel.sum()), "table": table}
        if cand is not None:
            entry.update({k: cand[k] for k in ("mode", "radius", "scale") if k in cand})
            entry["psnr_choice"] = table[choice]["psnr"]
        policy[level] = entry
    # The device and the versions of torch and CUDA: the ranking may move
    # with any of them.
    result = {"floor_db": floor_db, "batch": batch, "timed": bool(time_candidates),
              "backend": device.type,
              "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                              else "cpu"),
              "torch": torch.__version__, "cuda": torch.version.cuda, "levels": policy}
    if cache_path:
        tmp = cache_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
        os.replace(tmp, cache_path)
    return result


def load_policy(path: Optional[str]) -> Optional[dict]:
    """The policy at `path`, or None when it is absent or unreadable."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def policy_to_lowres(policy: dict) -> Dict[str, dict]:
    """Policy -> the per-level dial that AdaptiveDehazer takes as `lowres`:
    {level: {scale, mode, radius}} for the levels not chosen "full"."""
    out: Dict[str, dict] = {}
    for level, entry in (policy.get("levels") or {}).items():
        if entry.get("choice", "full") == "full":
            continue
        out[level] = {"scale": int(entry.get("scale", 2)),
                      "mode": entry.get("mode", "guided"),
                      "radius": int(entry.get("radius", 4))}
    return out
