#!/usr/bin/env python3
"""Where the device time goes, on one GPU: torch.profiler over warm calls.

    python3 chip_profile.py [kernels] [routes]      (both by default)

Profiles, each over 3 warm calls at the sizes of chip_smoke.py (16 images at
256^2, bf16, the same seeded weights and inputs). `kernels`:

- the low-branch chain K1 alone, so that each fused group shows, and the
  canonical high branch alone, so that K2's two passes show beside cuDNN;
- the soft blend K5 alone at (16, 256, 256, 3) in fp32 and in bf16: its
  device time, which CUDA events around back-to-back launches through
  Triton's launcher do not read apart from the host's;
- the tail chains K3 and K4 alone, so that each stage's kernel shows (K3's
  head group as `lightweight_group_kernel<64, 3>`, its trunk layers as
  `conv_tile_wgmma_kernel<N, taps, slots>`);
- the segment chain K6 alone at the high branch's 64^2 x 384 segment and at
  the medium branch's 128^2 x 128 one;
- route_hard and soft routing under the default dispatch, under the forced
  chain / tail_chain / tail_chain dispatch and under the forced chain /
  chain_hybrid / res_e2b_tail_chain dispatch.

`routes`: under the default dispatch, route_hard and route_device_binned on
the 16 images, and route_hard_stream, route_hard_queued and
route_device_binned_stream over 8 batches of them (a call is the 8
batches; each result dropped as it comes, and route_hard_stream again with
all 8 kept), each with the largest host-side entries (CUDA runtime calls
included) beside the device ones.

For each it prints the device-busy time per call (kernels and memcpys,
summed once each), the host wall time per call, and the largest device
entries by name. It fails without a CUDA card, and if the profiler saw no
device time.
"""
import copy
import sys
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


def profiled(tag, fn, host_top=0):
    """Run fn CALLS times under the profiler; print the busy time per call
    and the top device entries (and the `host_top` largest host entries by
    self time)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()   # the profiler's own start and stop left out
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
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / CALLS, e.count // CALLS)
                   for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda r: -r[1])
    for name, ms, count in host[:host_top]:
        cs.log(f"[profile {tag}]   host {ms:8.3f} ms  x{count:<4d} {name[:100]}")


def profile_routes(router, dev):
    """The serving routes under the default dispatch (see the docstring)."""
    cfg = load_config()
    d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev)
    x = np.random.default_rng(cs.SEED).random((cs.BATCH, cs.SIZE, cs.SIZE, 3),
                                              dtype=np.float32)
    stream = [x] * 8
    cs.log(f"[profile routes] route_hard intensities "
           f"{np.bincount(d.route_hard(x)[1], minlength=3).tolist()}")
    for tag, fn in (
            ("route_hard", lambda: d.route_hard(x)),
            ("route_device_binned", lambda: d.route_device_binned(x)),
            ("route_hard_stream, 8 batches", lambda: cs.drain(d.route_hard_stream(stream))),
            ("route_hard_stream, 8 batches, results kept",
             lambda: list(d.route_hard_stream(stream))),
            ("route_hard_queued, 8 batches", lambda: cs.drain(d.route_hard_queued(stream))),
            ("route_device_binned_stream, 8 batches",
             lambda: cs.drain(d.route_device_binned_stream(stream)))):
        profiled(tag, fn, host_top=8)
    del d
    torch.cuda.empty_cache()


def main():
    sections = sys.argv[1:] or ["kernels", "routes"]
    unknown = set(sections) - {"kernels", "routes"}
    if unknown:
        raise SystemExit(f"chip_profile: unknown sections {sorted(unknown)}")
    cs.phase_device()
    dev = torch.device("cuda")
    cs.phase_build()
    if "kernels" in sections:
        profile_kernels(dev)
    if "routes" in sections:
        profile_routes(cs.make_router(load_config(), torch.Generator().manual_seed(cs.SEED)),
                       dev)


def profile_kernels(dev):
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
    ys = [torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=own).to(dev) for _ in range(3)]
    wts = torch.softmax(torch.randn(cs.BATCH, 3, generator=own), dim=1).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        imgs = [y.to(dtype) for y in ys]
        with torch.inference_mode():
            profiled(f"K5 blend3 {str(dtype)[6:]}", lambda: cs.blend3(wts, *imgs))
    del ys, imgs

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
        (tail_cache, res_cache), _, _ = cs.tune_then_force(
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
