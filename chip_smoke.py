#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (adam_dehaze_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card is required; prints its name and power limit.
2. Build: compiles the CUDA kernels from csrc/ (build/kernels/, on first
   use) and prints the build time and the compiler's register report.
3. Kernel vs plain on the card, at the main path's shapes: K1 (low-branch
   chain), K2 (CBAM gate, at each AttentionBlock shape of the high branch)
   and K5 (soft blend). fp32 against the fp32 plain version at 1e-4 with
   TF32 off; bf16 against the fp32 plain version at 3e-2. K1's bf16
   tensor-core body is also held against the bf16 plain version, which
   rounds at the same points, with alpha 1, at c=32 and c=48 (K1_BF16_ATOL).
   Prints errors and times (CUDA events) of kernel and plain version.
4. Slice: the full-width default router (resnet18, low c=32, medium c=64,
   high c=96) with seeded random weights behind an AdaptiveDehazer in
   bf16, 16 images at 256^2: route_hard, the engine with forced labels
   cycling 0, 1, 2 (so every branch runs), and soft routing. Outputs must
   be finite and in [0, 1], and the launch counters must show that the
   runs went through K1, K2 (6 launches per high-branch call) and K5.
   Prints the warm ms/image of route_hard and soft.
5. Slice vs plain: the same weights run a forced-label batch on the CPU in
   fp32 (the plain versions) and on the card in fp32 (the kernels).
6. Prints the kernels' JSON line and, last, {"ok": true, "device": ...}.
"""
import copy
import json
import subprocess
import time

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.models.branches import (
    LightweightDehazeModel,
    create_branch_models,
)
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router, plan_chunks
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.kernels import _build, reset_launch_counts
from adam_dehaze_tpu_torch.ops.kernels.blend import blend3, blend3_reference
from adam_dehaze_tpu_torch.ops.kernels.cbam import (
    channel_spatial_gate,
    channel_spatial_gate_reference,
    launch_cbam_gate,
    padded_stats,
)
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    fold_lightweight,
    lightweight_chain,
    lightweight_chain_reference,
)
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

SEED = 0
BATCH, SIZE = 16, 256
FP32_ATOL = 1e-4      # fp32 kernel vs fp32 plain, TF32 off: reordered sums
BF16_ATOL = 3e-2      # bf16 kernel vs fp32 plain: the JAX tail-chain bound
# bf16 K1 vs bf16 plain, alpha 1: both sum each conv in f32 over the same
# bf16 values and round at the same points; they differ only where the two
# sum orders put a value on either side of a bf16 rounding boundary.
K1_BF16_ATOL = 4e-3
# fp32 slice, card vs CPU: some 40 layers of fp32 sums taken in another
# order on each side (cuDNN and the hand-written kernels vs the CPU's
# convolutions), each rounding at ~1e-7 relative, amplified by the random
# weights' activations: 1e-3 bounds that with room.
SLICE_ATOL = 1e-3
# Main-path K2 shapes of the canonical high branch (c=96) at 256^2: AB0 and
# AB4 at 128^2 x 192, AB1-3 at 64^2 x 384, AB5 at 256^2 x 96.
K2_SHAPES = {(BATCH, 128, 128, 192): 2, (BATCH, 64, 64, 384): 3,
             (BATCH, 256, 256, 96): 1}
KERNELS = {
    "lightweight_chain": ("cuda", "adam_dehaze_tpu_torch/csrc/lightweight_chain.cu",
                          "adam_dehaze_tpu/ops/pallas/s2d_chain.py:107", lightweight_chain),
    "cbam_gate": ("cuda", "adam_dehaze_tpu_torch/csrc/cbam_gate.cu",
                  "adam_dehaze_tpu/ops/pallas/cbam.py:71", channel_spatial_gate),
    "blend3": ("triton", "adam_dehaze_tpu_torch/ops/kernels/blend.py",
               "adam_dehaze_tpu/ops/pallas/blend.py:22", blend3),
}


def log(msg):
    print(msg, flush=True)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, from CUDA events around `iters` runs."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def perturb_bn_(module, gen):
    """BN running stats away from 0/1, so that every fold is exercised."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return module


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)


def phase_build():
    t0 = time.perf_counter()
    path, nvcc_s, nvcc_log = _build.build()
    _build.library()
    log(f"[build] {path}: nvcc {nvcc_s:.1f} s, build and load "
        f"{time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(dev, gen):
    results = {}

    # K1 at (16, 256, 256, 3), c=32, 3 residual blocks.
    low = perturb_bn_(init_params_(LightweightDehazeModel(32, 3), gen), gen).eval()
    x = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen).to(dev)
    c32 = fold_lightweight(low.to(dev), torch.float32)
    cbf = fold_lightweight(low, torch.bfloat16)
    with torch.inference_mode():
        ref = lightweight_chain_reference(x, c32)
        e32 = max_err(lightweight_chain(x, c32), ref)
        ebf = max_err(lightweight_chain(x, cbf), ref)
        ms = cuda_ms(lambda: lightweight_chain(x, cbf))
        plain = cuda_ms(lambda: lightweight_chain_reference(x, cbf))
    log(f"[K1 lightweight_chain] {tuple(x.shape)} c=32: fp32 err {e32:.3e}, "
        f"bf16 vs fp32 plain err {ebf:.3e}; bf16 kernel {ms:.3f} ms, plain {plain:.3f} ms")
    check(e32 <= FP32_ATOL and ebf <= BF16_ATOL, "K1 disagrees with its plain version")
    # The tensor-core body (every bf16 c -> c layer) against the bf16 plain
    # version, alpha 1 so that the conv stack is not scaled down by 0.1.
    tight = {}
    wide = perturb_bn_(init_params_(LightweightDehazeModel(48, 3), gen), gen).eval()
    for c, model in ((32, low), (48, wide)):
        chain = fold_lightweight(model.to(dev), torch.bfloat16)._replace(alpha=1.0)
        with torch.inference_mode():
            tight[c] = max_err(lightweight_chain(x, chain),
                               lightweight_chain_reference(x, chain))
    log(f"[K1 lightweight_chain] bf16 vs bf16 plain, alpha 1: c=32 err {tight[32]:.3e}, "
        f"c=48 err {tight[48]:.3e} (bound {K1_BF16_ATOL})")
    check(max(tight.values()) <= K1_BF16_ATOL,
          "K1's tensor-core body disagrees with the bf16 plain version")
    results["lightweight_chain"] = dict(
        max_abs_err=max(tight.values()), max_abs_err_bf16_vs_fp32=ebf,
        max_abs_err_fp32=e32, ms=ms, plain_ms=plain, shape=list(x.shape))
    del x, ref

    # K2 at every AttentionBlock shape; ms per high-branch call = the sum
    # over its six blocks.
    tot = dict(ms=0.0, plain_ms=0.0, kernel_only_ms=0.0)
    errs, errs32, shapes = [], [], []
    for shape, calls in K2_SHAPES.items():
        x = torch.rand(shape, generator=gen).to(dev)
        g = torch.sigmoid(torch.randn(shape[0], shape[3], generator=gen)).to(dev)
        w = (torch.randn(7, 7, 2, 1, generator=gen) * 0.1).to(dev)
        xb, wb = x.bfloat16(), w.bfloat16().float()
        with torch.inference_mode():
            ref = channel_spatial_gate_reference(x, g, w)
            e32 = max_err(channel_spatial_gate(x, g, w), ref)
            ebf = max_err(channel_spatial_gate(xb, g, wb),
                          channel_spatial_gate_reference(x, g, wb))
            ms = cuda_ms(lambda: channel_spatial_gate(xb, g, wb))
            plain = cuda_ms(lambda: channel_spatial_gate_reference(xb, g, wb))
            mean_p, max_p = padded_stats(xb, g)
            out = torch.empty_like(xb)
            wf = wb.contiguous()
            kernel_only = cuda_ms(lambda: launch_cbam_gate(xb, g, mean_p, max_p, wf, out))
        gbs = 2 * xb.numel() * 2 / (kernel_only * 1e-3) / 1e9
        log(f"[K2 cbam_gate] {shape}: fp32 err {e32:.3e}, bf16 err {ebf:.3e}; bf16 "
            f"wrapper {ms:.3f} ms (kernel alone {kernel_only:.3f} ms, "
            f"{gbs:.0f} GB/s of x read+write), plain {plain:.3f} ms")
        check(e32 <= FP32_ATOL and ebf <= BF16_ATOL,
              f"K2 disagrees with its plain version at {shape}")
        errs.append(ebf)
        errs32.append(e32)
        shapes.append(list(shape))
        tot["ms"] += calls * ms
        tot["plain_ms"] += calls * plain
        tot["kernel_only_ms"] += calls * kernel_only
        del x, ref, out, mean_p, max_p, xb
    log(f"[K2 cbam_gate] per high-branch call (6 blocks): wrapper {tot['ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms")
    results["cbam_gate"] = dict(max_abs_err=max(errs), max_abs_err_fp32=max(errs32),
                                shapes=shapes, per="high-branch call (6 blocks)",
                                **tot)

    # K5 at (16, 256, 256, 3).
    ys = [torch.rand(BATCH, SIZE, SIZE, 3, generator=gen).to(dev) for _ in range(3)]
    wts = torch.softmax(torch.randn(BATCH, 3, generator=gen), dim=1).to(dev)
    ybf = [y.bfloat16() for y in ys]
    with torch.inference_mode():
        ref = blend3_reference(wts, *ys)
        e32 = max_err(blend3(wts, *ys), ref)
        ebf = max_err(blend3(wts, *ybf), ref)
        ms = cuda_ms(lambda: blend3(wts, *ys))
        plain = cuda_ms(lambda: blend3_reference(wts, *ys))
    log(f"[K5 blend3] {tuple(ys[0].shape)}: fp32 err {e32:.3e}, bf16 err {ebf:.3e}; "
        f"fp32 kernel {ms:.3f} ms, plain {plain:.3f} ms")
    check(e32 <= FP32_ATOL and ebf <= BF16_ATOL, "K5 disagrees with its plain version")
    results["blend3"] = dict(max_abs_err=e32, max_abs_err_bf16=ebf, ms=ms,
                             plain_ms=plain, shape=list(ys[0].shape))
    return results


def make_router(cfg, gen):
    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    return perturb_bn_(init_params_(router, gen), gen)


def check_images(y, n, what):
    check(tuple(y.shape) == (n, SIZE, SIZE, 3), f"{what}: shape {y.shape}")
    check(bool(np.isfinite(y).all()), f"{what}: non-finite output")
    check(float(y.min()) >= 0.0 and float(y.max()) <= 1.0, f"{what}: outside [0, 1]")


def counts():
    return {k: v[3].launches for k, v in KERNELS.items()}


def delta(before):
    now = counts()
    return {k: now[k] - before[k] for k in now}


def phase_slice(router, dev, rng):
    cfg = load_config()   # bf16, the default compute dtype
    d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev)
    x = rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    labels = np.arange(BATCH) % 3
    eng = d.engine
    per_class = [len(plan_chunks(int((labels == c).sum()), eng.buckets,
                                 eng.program_overhead_rows[c])) for c in range(3)]

    reset_launch_counts()
    out, intensity = d.route_hard(x)
    torch.cuda.synchronize()
    hard = counts()
    before = counts()
    with torch.inference_mode():
        forced, _ = eng(torch.from_numpy(x).to(dev), intensity=labels)
        forced = forced.cpu().numpy()
    forced_d = delta(before)
    before = counts()
    soft = d(x)
    soft_d = delta(before)
    main = counts()

    log(f"[slice] route_hard intensities {np.bincount(intensity, minlength=3).tolist()}; "
        f"launches: route_hard {hard}, forced labels {forced_d}, soft {soft_d}")
    check_images(out, BATCH, "route_hard")
    check_images(forced, BATCH, "forced-label engine")
    check_images(soft, BATCH, "soft")
    check(forced_d["lightweight_chain"] == 9 * per_class[0],
          f"forced run: K1 launches {forced_d} vs {per_class[0]} low buckets")
    check(forced_d["cbam_gate"] == 6 * per_class[2],
          f"forced run: K2 launches {forced_d} vs {per_class[2]} high buckets")
    check(soft_d == {"lightweight_chain": 9, "cbam_gate": 6, "blend3": 1},
          f"soft run launches {soft_d}")
    check(all(v > 0 for v in main.values()), f"a kernel never ran: {main}")

    def run_hard():
        d.route_hard(x)
        torch.cuda.synchronize()

    def run_soft():
        d(x)
        torch.cuda.synchronize()

    for name, fn in (("route_hard", run_hard), ("soft", run_soft)):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3 / BATCH)
        log(f"[slice] {name}: {np.mean(times):.3f} ms/image warm (min "
            f"{min(times):.3f}, max {max(times):.3f}; 5 runs of {BATCH} images at "
            f"{SIZE}^2, bf16, numpy in and out)")
    return main


def phase_vs_plain(router, dev, rng):
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    x = rng.random((3, SIZE, SIZE, 3), dtype=np.float32)
    labels = np.array([0, 1, 2])
    outs = []
    for device in ("cpu", dev):
        d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=device)
        with torch.inference_mode():
            y, _ = d.engine(torch.from_numpy(x).to(device), intensity=labels)
        outs.append(y.cpu())
    err = max_err(outs[0], outs[1])
    log(f"[slice vs plain] fp32, labels {labels.tolist()}, {SIZE}^2: max abs err "
        f"card vs CPU {err:.3e} (bound {SLICE_ATOL})")
    check(err <= SLICE_ATOL, "the card's slice disagrees with the plain path")


def main():
    phase_device()
    dev = torch.device("cuda")
    phase_build()
    gen = torch.Generator().manual_seed(SEED)
    kernels = phase_kernels(dev, gen)
    router = make_router(load_config(), gen)
    rng = np.random.default_rng(SEED)
    launches = phase_slice(router, dev, rng)
    phase_vs_plain(router, dev, rng)

    line = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], **kernels[name]}
        for name, (route, source, replaces, _) in KERNELS.items()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
