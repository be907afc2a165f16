#!/usr/bin/env python3
"""Where the device time goes, on one GPU: torch.profiler over warm calls.

    python3 chip_profile.py

Profiles, each over 3 warm calls at the sizes of chip_smoke.py (16 images at
256^2, bf16, the same seeded weights and inputs):

- the low-branch chain K1 alone, so that each fused group shows, and the
  canonical high branch alone, so that K2's two passes show beside cuDNN;
- the tail chains K3 and K4 alone, so that each stage's kernel shows;
- the segment chain K6 alone at the high branch's 64^2 x 384 segment and at
  the medium branch's 128^2 x 128 one;
- route_hard and soft routing under the default dispatch, under the forced
  chain / tail_chain / tail_chain dispatch and under the forced chain /
  chain_hybrid / res_e2b_tail_chain dispatch.

For each it prints the device-busy time per call (kernels and memcpys,
summed once each), the host wall time per call, and the largest device
entries by name. It fails without a CUDA card, and if the profiler saw no
device time.
"""
import copy
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

CALLS = 3
TOP = 12


def profiled(tag, fn):
    """Run fn CALLS times under the profiler; print the busy time per call
    and the top device entries."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / CALLS
    rows = [(e.key, e.self_device_time_total / 1e3 / CALLS, e.count // CALLS)
            for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, ms, _ in rows)
    cs.check(busy > 0, f"{tag}: the profiler saw no device time")
    cs.log(f"[profile {tag}] device busy {busy:.3f} ms per call, host wall (profiler on) "
           f"{wall:.3f} ms per call; {len(rows)} kinds of device entries")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:TOP]:
        cs.log(f"[profile {tag}]   {ms:8.3f} ms  x{count:<4d} {name[:110]}")


def main():
    cs.phase_device()
    dev = torch.device("cuda")
    cs.phase_build()
    gen = torch.Generator().manual_seed(cs.SEED)

    # Their own generator: the draws below, and with them the router's
    # weights and where it routes the batch, stay as they were.
    own = torch.Generator().manual_seed(cs.SEED + 2)
    low = cs.perturb_bn_(cs.init_params_(cs.LightweightDehazeModel(32, 3), own), own).eval()
    chain = cs.fold_lightweight(low.to(dev), torch.bfloat16)
    x = torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=own).to(dev)
    high = cs.cast_for_serving(
        cs.perturb_bn_(cs.init_params_(cs.HighIntensityDehazeModel(96), own), own),
        torch.bfloat16).to(dev)
    with torch.inference_mode():
        profiled("K1 lightweight_chain", lambda: cs.lightweight_chain(x, chain))
        profiled("canonical high branch", lambda: high(x))
    del x, high

    for name, cls, c, fold_fn, tail in (
            ("K3 medium_tail_chain", cs.MediumIntensityDehazeModel, 64,
             cs.fold_medium_tail, cs.medium_tail_chain),
            ("K4 high_tail_chain", cs.HighIntensityDehazeModel, 96,
             cs.fold_high_tail, cs.high_tail_chain)):
        model = cs.perturb_bn_(cs.init_params_(cls(c), gen), gen).eval().to(dev)
        d1 = torch.relu(torch.randn(cs.BATCH, cs.SIZE // 2, cs.SIZE // 2, 4 * c,
                                    generator=gen)).to(dev).bfloat16()
        f0 = torch.relu(torch.randn(cs.BATCH, cs.SIZE, cs.SIZE, c,
                                    generator=gen)).to(dev).bfloat16()
        x = torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=gen).to(dev)
        weights = fold_fn(model, torch.bfloat16)
        with torch.inference_mode():
            profiled(name, lambda: tail(d1, f0, x, weights))
        del d1, f0, x

    for name in ("high e2b", "medium e1"):
        c, down, kinds = cs.RES_SEGMENTS[name]
        blocks = torch.nn.Sequential(*[cs.ResidualBlock(c) if k == "res"
                                       else cs.AttentionBlock(c) for k in kinds])
        blocks = cs.perturb_bn_(cs.init_params_(blocks, gen), gen).eval().to(dev)
        side = cs.SIZE // down
        x = torch.relu(torch.randn(cs.BATCH, side, side, c, generator=gen)).to(dev).bfloat16()
        weights = cs.fold_res_attn_chain(blocks, torch.bfloat16)
        with torch.inference_mode():
            profiled(f"K6 res_attn_chain, {name}", lambda: cs.res_attn_chain(x, weights))
        del x

    router = cs.make_router(load_config(), gen)
    x = np.random.default_rng(cs.SEED).random((cs.BATCH, cs.SIZE, cs.SIZE, 3),
                                              dtype=np.float32)
    cfg = load_config()
    with tempfile.TemporaryDirectory() as tmp:
        (tail_cache, res_cache), _ = cs.tune_then_force(
            router, cfg, dev, tmp, "bf16", (cs.TAIL_FORCED, cs.RES_FORCED))
        for tag, kwargs in (("default", {}),
                            ("tail_chain", dict(autotune=True, autotune_cache=tail_cache)),
                            ("res_chain", dict(autotune=True, autotune_cache=res_cache))):
            d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev, **kwargs)
            _, intensity = d.route_hard(x)
            cs.log(f"[profile {tag}] route_hard intensities "
                   f"{np.bincount(intensity, minlength=3).tolist()}")
            profiled(f"{tag} route_hard", lambda: d.route_hard(x))
            profiled(f"{tag} soft", lambda: d(x))
            del d
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
