#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (adam_dehaze_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card is required; prints its name and power limit.
2. Build: compiles the CUDA kernels from csrc/ (build/kernels/, on first
   use) and prints the build time and the compiler's register report.
3. Kernel vs plain on the card, at the main path's shapes: K1 (low-branch
   chain; bf16 must take the fused wgmma body, whose plan is printed), K2
   (CBAM gate, at each AttentionBlock shape of the high branch; its
   statistics pass also against `padded_stats` at MAPS_ATOL, and timed
   alone), K5 (soft blend), K2' (spatial gate, at the high tail's shape), the
   conv-layer table (every distinct conv layer that K3, K4 and K6 launch,
   through `conv_tile` alone: body taken, plan, error, time, TFLOP/s, bound,
   and one cuDNN call on the same tensors as the yardstick), K3 and K4 (the
   medium and high tail chains), K6 (the res/attention segment chain, at
   the six segments of the medium and the high branch) and the ten
   operation probes. fp32 against the fp32 plain version at 1e-4 with TF32
   off; bf16 against the fp32 plain version at 3e-2. The bf16 tensor-core
   bodies are also held against the bf16 plain versions, which round at the
   same points: K1 with alpha 1 at c=32 and c=48 (K1_BF16_ATOL), K3 and K4
   at TAIL_BF16_ATOL, K6 at RES_BF16_RTOL. K6's errors are in units of the
   plain result's largest magnitude (its segments end in a ReLU or a gate,
   not in a clip to [0, 1]). Prints errors, times (CUDA events) of kernel
   and plain version, for K3, K4 and K6 the time of the same stage on the
   serving copy's canonical modules (cuDNN), and each kernel's bound: the
   larger of its bytes over the card's memory rate and its operations over
   the card's peak rate, counted from this run's shapes.
4. Slice, default dispatch: the full-width default router (resnet18, low
   c=32, medium c=64, high c=96) with seeded random weights behind an
   AdaptiveDehazer in bf16, 16 images at 256^2: route_hard, the engine with
   forced labels cycling 0, 1, 2 (so every branch runs), and soft routing.
   Outputs must be finite and in [0, 1], and the launch counters, set to 0
   just before, must show that the runs went through K1 (4 launches per
   low bucket in bf16), K2 (6 launches per high-branch call) and K5. Prints the warm ms/image of route_hard and
   soft, and what one more bucket of each branch costs the engine (the
   intercept of the branch apply's time over its rows), beside the
   constants the chunk planner is fed under autotune
   (AdaptiveDehazer.DISPATCH_MS).
5. Tune: a dehazer with autotune=True and a fresh cache file times every
   candidate of the three branches at (16, 256, 256, 3) and prints the
   tables (no candidate may fail). The two forced paths below share this
   one tuning run (each used to tune for itself).
6. Slice, tail-chain dispatch: a dehazer whose cache names chain /
   tail_chain / tail_chain runs the same three calls. The counters, set to
   0 just before, must show K3 and K4 launched once per medium and high
   bucket (6 and 11 launches), K2' once and K2 5 times per high bucket; the
   outputs must agree with phase 4's within 3e-2. Prints the warm ms/image
   beside phase 4's.
7. Slice, res-chain dispatch: the same under chain / chain_hybrid /
   res_e2b_tail_chain: K6 must show 14 launches per medium bucket and 17
   per high bucket, K4 11 and K2' 1 per high bucket, K2 5 (3 inside K6, 2
   in the AttentionBlocks that stay canonical).
8. The probe tool's own entry point (run_probes): every pattern must PASS,
   ten launches.
9. Slice vs plain: the same weights run a forced-label batch on the CPU in
   fp32 (the plain versions) and on the card in fp32 (the kernels), under
   the default, the tail-chain and the res-chain dispatch.
10. Prints the kernels' JSON line and, last, {"ok": true, "device": ...}.
"""
import copy
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.models.branches import (
    HighIntensityDehazeModel,
    LightweightDehazeModel,
    MediumIntensityDehazeModel,
    create_branch_models,
)
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    create_router,
    plan_chunks,
)
from adam_dehaze_tpu_torch.nn.blocks import (
    AttentionBlock,
    ResidualBlock,
    init_params_,
)
from adam_dehaze_tpu_torch.ops.kernels import (
    _build,
    launch_counters,
    reset_launch_counts,
)
from adam_dehaze_tpu_torch.ops.kernels.blend import blend3, blend3_reference
from adam_dehaze_tpu_torch.ops.kernels.cbam import (
    channel_spatial_gate,
    channel_spatial_gate_reference,
    gated_maps,
    launch_cbam_gate,
    launch_spatial_gate,
    padded_stats,
    spatial_gate,
    spatial_gate_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.conv_tile import (
    conv_tile,
    conv_tile_plan,
    conv_tile_reference,
    pack_conv_weights,
)
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    chain_plan,
    fold_lightweight,
    lightweight_chain,
    lightweight_chain_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.res_chain import (
    SEGMENTS,
    fold_res_attn_chain,
    launches_of,
    res_attn_chain,
    res_attn_chain_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.tail_chain import (
    HIGH_TAIL_LAUNCHES,
    MEDIUM_TAIL_LAUNCHES,
    fold_high_tail,
    fold_medium_tail,
    high_tail_chain,
    high_tail_chain_reference,
    medium_tail_chain,
    medium_tail_chain_reference,
    weight_tensors,
)
from adam_dehaze_tpu_torch.ops.serving_apply import cast_for_serving
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.tools import probe_ops

SEED = 0
BATCH, SIZE = 16, 256
FP32_ATOL = 1e-4      # fp32 kernel vs fp32 plain, TF32 off: reordered sums
BF16_ATOL = 3e-2      # bf16 kernel vs fp32 plain: the JAX tail-chain bound
# bf16 K1 vs bf16 plain, alpha 1: both sum each conv in f32 over the same
# bf16 values and round at the same points; they differ only where the two
# sum orders put a value on either side of a bf16 rounding boundary.
K1_BF16_ATOL = 4e-3
# K2's statistics pass vs its plain version: f32 sums in another order.
MAPS_ATOL = 1e-5
# bf16 K3/K4 vs their bf16 plain versions: the same argument. The output is
# clip(x + tanh(.) [* guidance]), so a flipped bf16 rounding upstream (one
# part in 256 of an activation) reaches it at a few 1e-3; a dropped tap,
# phase, input half or residual add moves it by 5e-2 or more (PERF.md).
TAIL_BF16_ATOL = 1e-2
# bf16 K6 vs its bf16 plain version, in units of the plain result's largest
# magnitude: the same argument again, but a segment ends in a ReLU or a gate
# and its activations are not confined to [0, 1], so the bound is relative.
# A flipped rounding is one bf16 step, 2^-8 of the value it hits, and up to
# eight convs carry it on: on an NVIDIA H100 80GB HBM3 the six segments read
# 4.3e-3 to 6.5e-3, and a dropped tap, chunk, skip add or gate 0.38 or more.
# The bound does not see the activation rounded before the spatial gate
# (9.8e-3 against 7.8e-3 unchanged; chip_mutation_check.py, PERF.md).
RES_BF16_RTOL = 2e-2
# Published peaks of one H100 SXM at its full power limit: device memory
# rate, dense bf16 tensor-core rate, f32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# fp32 slice, card vs CPU: some 40 layers of fp32 sums taken in another
# order on each side (cuDNN and the hand-written kernels vs the CPU's
# convolutions), each rounding at ~1e-7 relative, amplified by the random
# weights' activations: 1e-3 bounds that with room.
SLICE_ATOL = 1e-3
# Main-path K2 shapes of the canonical high branch (c=96) at 256^2: AB0 and
# AB4 at 128^2 x 192, AB1-3 at 64^2 x 384, AB5 at 256^2 x 96.
K2_SHAPES = {(BATCH, 128, 128, 192): 2, (BATCH, 64, 64, 384): 3,
             (BATCH, 256, 256, 96): 1}
# name -> (route, source, the TPU kernel it replaces).
KERNELS = {
    "lightweight_chain": ("cuda", "adam_dehaze_tpu_torch/csrc/lightweight_chain.cu",
                          "adam_dehaze_tpu/ops/pallas/s2d_chain.py:107"),
    "cbam_gate": ("cuda", "adam_dehaze_tpu_torch/csrc/cbam_gate.cu",
                  "adam_dehaze_tpu/ops/pallas/cbam.py:71"),
    "blend3": ("triton", "adam_dehaze_tpu_torch/ops/kernels/blend.py",
               "adam_dehaze_tpu/ops/pallas/blend.py:22"),
    "spatial_gate": ("cuda", "adam_dehaze_tpu_torch/csrc/cbam_gate.cu",
                     "adam_dehaze_tpu/ops/pallas/cbam.py:53"),
    "medium_tail_chain": ("cuda", "adam_dehaze_tpu_torch/csrc/tail_chain.cu",
                          "adam_dehaze_tpu/ops/pallas/tail_chain.py:349"),
    "high_tail_chain": ("cuda", "adam_dehaze_tpu_torch/csrc/tail_chain.cu",
                        "adam_dehaze_tpu/ops/pallas/tail_chain.py:184"),
    "res_attn_chain": ("cuda", "adam_dehaze_tpu_torch/csrc/conv_tile.cu",
                       "adam_dehaze_tpu/ops/pallas/res_chain.py:89"),
    "probe_ops": ("cuda", "adam_dehaze_tpu_torch/csrc/probe_ops.cu",
                  "tools/probe_mosaic_ops.py:29"),
}
# The main-path segments of K6 at 256^2: name -> (channels, downscale, kinds).
RES_SEGMENTS = {
    "high e1": (192, 2, ("res", "res", "attn")),
    "high e2b": (384, 4, ("res", "res", "attn", "res", "attn", "res", "attn")),
    "high d1": (192, 2, ("res", "attn")),
    "medium e1": (128, 2, ("res", "res")),
    "medium e2b": (256, 4, ("res", "res", "res", "res")),
    "medium d1": (128, 2, ("res",)),
}


# The distinct conv layers that K3, K4 and K6 launch on the forced paths, at
# batch 16: name -> (side of the input, c0, c1, cout, ksize). ksize 2 is the
# transposed conv (the output is twice the side).
CONV_LAYERS = {
    "K6 128^2 128->128": (128, 128, 0, 128, 3),
    "K6 64^2 256->256": (64, 256, 0, 256, 3),
    "K6 128^2 192->192": (128, 192, 0, 192, 3),
    "K6 64^2 384->384": (64, 384, 0, 384, 3),
    "K4 up 128^2 384->96": (128, 384, 0, 96, 2),
    "K4 256^2 96->96": (256, 96, 0, 96, 3),
    "K4 256^2 [96+96]->96": (256, 96, 96, 96, 3),
    "K4 256^2 96->48": (256, 96, 0, 48, 3),
    "K4 256^2 16->16": (256, 16, 0, 16, 3),
    "K3 up 128^2 256->64": (128, 256, 0, 64, 2),
    "K3 256^2 64->64": (256, 64, 0, 64, 3),
    "K3 256^2 [64+64]->64": (256, 64, 64, 64, 3),
    "K3 256^2 64->32": (256, 64, 0, 32, 3),
}
# One conv layer in bf16 against its plain version, which rounds once at
# the same point, in units of the plain result's largest magnitude: one
# bf16 step (2^-8 of the value) where the two sum orders straddle a rounding
# boundary.
CONV_BF16_RTOL = 2 ** -7


# K1's launches per low bucket at the slice's width and depth, by compute
# dtype: the fused groups in bf16 (4), one launch per layer in fp32 (9).
K1_LAUNCHES = {dt: chain_plan(32, 3, dt).launches for dt in (torch.bfloat16, torch.float32)}


def _k6_launches(level, segments):
    """(on K6, on K2) per bucket of a branch with these segments on K6."""
    per = [launches_of(RES_SEGMENTS[f"{level} {seg}"][2]) for seg in segments]
    return sum(a for a, _ in per), sum(b for _, b in per)


# Kernel launches per bucket of every serving candidate: (level, name) ->
# {kernel: launches} (K1's by compute dtype). K2 counts the AttentionBlocks that stay canonical and
# the gates' pass of every attention block on K6.
BUCKET_LAUNCHES = {
    ("low", "canonical"): {"lightweight_chain": K1_LAUNCHES},
    ("low", "chain"): {"lightweight_chain": K1_LAUNCHES},
    ("medium", "canonical"): {},
    ("medium", "tail_chain"): {"medium_tail_chain": MEDIUM_TAIL_LAUNCHES},
    ("medium", "chain_hybrid"): {"res_attn_chain": _k6_launches("medium", SEGMENTS)[0]},
    ("high", "canonical"): {"cbam_gate": 6},
    ("high", "tail_chain"): {"high_tail_chain": HIGH_TAIL_LAUNCHES, "spatial_gate": 1,
                             "cbam_gate": 5},
    ("high", "res_chain_e2b"): {
        "res_attn_chain": _k6_launches("high", ("e2b",))[0],
        "cbam_gate": 3 + _k6_launches("high", ("e2b",))[1]},
    ("high", "res_e2b_tail_chain"): {
        "res_attn_chain": _k6_launches("high", ("e2b",))[0],
        "high_tail_chain": HIGH_TAIL_LAUNCHES, "spatial_gate": 1,
        "cbam_gate": 2 + _k6_launches("high", ("e2b",))[1]},
}
CLASS_OF = {"LightweightDehazeModel": "low", "MediumIntensityDehazeModel": "medium",
            "HighIntensityDehazeModel": "high"}
# The forced dispatches: level -> candidate.
TAIL_FORCED = {"low": "chain", "medium": "tail_chain", "high": "tail_chain"}
RES_FORCED = {"low": "chain", "medium": "chain_hybrid", "high": "res_e2b_tail_chain"}
# Kernels each path must launch at least once.
DEFAULT_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "blend3")
TAIL_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "blend3", "spatial_gate",
                     "medium_tail_chain", "high_tail_chain")
RES_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "blend3", "spatial_gate",
                    "high_tail_chain", "res_attn_chain")


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


def bound(flops, nbytes, peak_flops):
    """The least time the card could take, in ms, and what sets it: the
    bytes moved once over the memory rate, or the operations over the peak
    rate of their type."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = flops / peak_flops * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=int(nbytes), flops=int(flops))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def weights_nbytes(weights):
    """Bytes of a chain's folded weights as a launch reads them: each conv's
    weights once (the packed copies hold the same values again)."""
    if hasattr(weights, "trunk"):
        weights = weights._replace(trunk=weights.trunk._replace(packed=()),
                                   guidance2_packed=None)
    else:
        weights = weights._replace(packed=())
    return nbytes(*weight_tensors(weights))


def conv_flops(pixels, taps, cin, cout):
    return 2 * pixels * taps * cin * cout


def tail_flops(n, h, w, c, high):
    """Operations of one tail call from its shapes: the convolutions, and
    for the high tail the attention block's passes and the guidance head."""
    px = n * h * w
    flops = (conv_flops(px, 4, 4 * c, c) + 2 * conv_flops(px, 9, c, c)
             + conv_flops(px, 9, 2 * c, c) + conv_flops(px, 9, c, c // 2)
             + conv_flops(px, 9, c // 2, 3))
    if high:
        flops += conv_flops(px, 9, 3, 16) + conv_flops(px, 9, 16, 16) + 2 * px * 16
        flops += 6 * px * c + conv_flops(px, 49, 2, 1)
    return flops


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
    plan = chain_plan(32, 3, torch.bfloat16)
    log(f"[K1 lightweight_chain] {tuple(x.shape)} c=32: fp32 err {e32:.3e}, "
        f"bf16 vs fp32 plain err {ebf:.3e}; bf16 kernel {ms:.3f} ms, plain {plain:.3f} ms; "
        f"bf16 body {plan.body}, tile {plan.tile}, launches {plan.groups}, shared memory "
        f"{plan.smem_bytes}")
    check(plan.body == "fused", "the bf16 low branch did not take the fused wgmma body")
    check(e32 <= FP32_ATOL and ebf <= BF16_ATOL, "K1 disagrees with its plain version")
    # The fused wgmma body (every bf16 layer) against the bf16 plain version,
    # alpha 1 so that the conv stack is not scaled down by 0.1.
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
          "K1's fused wgmma body disagrees with the bf16 plain version")
    px = x.numel() // 3
    k1_flops = sum(conv_flops(px, 9, w.shape[2], w.shape[3]) for w, _ in cbf.layers)
    results["lightweight_chain"] = dict(
        max_abs_err=max(tight.values()), max_abs_err_bf16_vs_fp32=ebf,
        max_abs_err_fp32=e32, ms=ms, plain_ms=plain, library_ms=None,
        shape=list(x.shape),
        **bound(k1_flops, 2 * nbytes(x) + nbytes(*weight_tensors(cbf.layers)),
                PEAK_BF16_FLOPS))
    del x, ref

    # K2 at every AttentionBlock shape; ms per high-branch call = the sum
    # over its six blocks.
    tot = dict(ms=0.0, plain_ms=0.0, kernel_only_ms=0.0, maps_ms=0.0, maps_plain_ms=0.0)
    k2_bytes = k2_flops = 0
    errs, errs32, errs_maps, shapes = [], [], [], []
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
            # The statistics pass against its plain version, then alone.
            mean_p, max_p = gated_maps(xb, g)
            emaps = max(max_err(a, b) for a, b in zip((mean_p, max_p), padded_stats(xb, g)))
            maps = cuda_ms(lambda: gated_maps(xb, g))
            maps_plain = cuda_ms(lambda: padded_stats(xb, g))
            out = torch.empty_like(xb)
            wf = wb.contiguous()
            kernel_only = cuda_ms(lambda: launch_cbam_gate(xb, g, mean_p, max_p, wf, out))
        gbs = 2 * xb.numel() * 2 / (kernel_only * 1e-3) / 1e9
        log(f"[K2 cbam_gate] {shape}: fp32 err {e32:.3e}, bf16 err {ebf:.3e}, maps err "
            f"{emaps:.3e}; bf16 wrapper {ms:.3f} ms (statistics pass {maps:.3f} ms, "
            f"{nbytes(xb) / (maps * 1e-3) / 1e9:.0f} GB/s of x read; its plain version "
            f"{maps_plain:.3f} ms; gate kernel alone {kernel_only:.3f} ms, "
            f"{gbs:.0f} GB/s of x read+write), plain {plain:.3f} ms")
        check(e32 <= FP32_ATOL and ebf <= BF16_ATOL,
              f"K2 disagrees with its plain version at {shape}")
        check(emaps <= MAPS_ATOL, f"K2's statistics pass disagrees with padded_stats at {shape}")
        errs_maps.append(emaps)
        tot["maps_ms"] += calls * maps
        tot["maps_plain_ms"] += calls * maps_plain
        errs.append(ebf)
        errs32.append(e32)
        shapes.append(list(shape))
        tot["ms"] += calls * ms
        tot["plain_ms"] += calls * plain
        tot["kernel_only_ms"] += calls * kernel_only
        # x read and the result written once, the gate and the stencil read;
        # per element two multiplies and the (mean, max) reduction.
        k2_bytes += calls * (2 * nbytes(xb) + nbytes(g, wb))
        k2_flops += calls * (4 * xb.numel() + conv_flops(xb.numel() // shape[3], 49, 2, 1))
        del x, ref, out, mean_p, max_p, xb
    log(f"[K2 cbam_gate] per high-branch call (6 blocks): wrapper {tot['ms']:.3f} ms "
        f"(statistics pass {tot['maps_ms']:.3f} ms, gate kernel {tot['kernel_only_ms']:.3f} "
        f"ms), plain {tot['plain_ms']:.3f} ms")
    results["cbam_gate"] = dict(max_abs_err=max(errs), max_abs_err_fp32=max(errs32),
                                max_abs_err_maps=max(errs_maps),
                                shapes=shapes, per="high-branch call (6 blocks)",
                                library_ms=None,
                                **bound(k2_flops, k2_bytes, PEAK_F32_FLOPS), **tot)

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
                             plain_ms=plain, library_ms=None, shape=list(ys[0].shape),
                             **bound(5 * ys[0].numel(), 4 * nbytes(ys[0]) + nbytes(wts),
                                     PEAK_F32_FLOPS))
    del ys, ybf, ref

    # K2' at the high tail's shape, where K4 launches it.
    shape = (BATCH, SIZE, SIZE, 96)
    x = torch.rand(shape, generator=gen).to(dev)
    w = (torch.randn(7, 7, 2, 1, generator=gen) * 0.1).to(dev)
    xb, wb = x.bfloat16(), w.bfloat16().float()
    with torch.inference_mode():
        ref = spatial_gate_reference(x, w)
        e32 = max_err(spatial_gate(x, w), ref)
        ebf = max_err(spatial_gate(xb, wb), spatial_gate_reference(x, wb))
        ms = cuda_ms(lambda: spatial_gate(xb, wb))
        plain = cuda_ms(lambda: spatial_gate_reference(xb, wb))
        mean_p, max_p = gated_maps(xb)
        emaps = max(max_err(a, b) for a, b in zip((mean_p, max_p), padded_stats(xb)))
        maps = cuda_ms(lambda: gated_maps(xb))
        maps_plain = cuda_ms(lambda: padded_stats(xb))
        out = torch.empty_like(xb)
        wf = wb.reshape(7, 7, 2).contiguous()
        kernel_only = cuda_ms(lambda: launch_spatial_gate(xb, mean_p, max_p, wf, out))
    log(f"[K2' spatial_gate] {shape}: fp32 err {e32:.3e}, bf16 err {ebf:.3e}, maps err "
        f"{emaps:.3e}; bf16 wrapper {ms:.3f} ms (statistics pass {maps:.3f} ms, its plain "
        f"version {maps_plain:.3f} ms; gate kernel alone {kernel_only:.3f} ms, "
        f"{2 * nbytes(xb) / (kernel_only * 1e-3) / 1e9:.0f} GB/s of x read+write), "
        f"plain {plain:.3f} ms")
    check(e32 <= FP32_ATOL and ebf <= BF16_ATOL, "K2' disagrees with its plain version")
    check(emaps <= MAPS_ATOL, "K2''s statistics pass disagrees with padded_stats")
    results["spatial_gate"] = dict(
        max_abs_err=ebf, max_abs_err_fp32=e32, max_abs_err_maps=emaps, ms=ms, plain_ms=plain,
        kernel_only_ms=kernel_only, maps_ms=maps, maps_plain_ms=maps_plain,
        library_ms=None, shape=list(shape),
        **bound(3 * xb.numel() + conv_flops(xb.numel() // 96, 49, 2, 1),
                2 * nbytes(xb) + nbytes(wb), PEAK_F32_FLOPS))
    del x, xb, ref, out, mean_p, max_p

    # Its own generator: the draws of the other phases, and with them the
    # router's weights and where it routes the batch, stay as they were.
    conv_layers = phase_conv_layers(dev, torch.Generator().manual_seed(SEED + 1))
    results.update(phase_tail_kernels(dev, gen))
    results["res_attn_chain"] = phase_res_chain_kernels(dev, gen)
    results["probe_ops"] = phase_probe_kernels(dev)
    return results, conv_layers


def phase_conv_layers(dev, gen):
    """The conv-layer table: every distinct layer of CONV_LAYERS through
    `conv_tile` alone, bf16, batch 16: the body it took and its plan, its
    error against `conv_tile_reference`, its time, rate and bound, and as
    the yardstick one cuDNN call on the same tensors (`F.conv2d`, bf16,
    channels_last; for a two-input layer on their concat, made beforehand;
    `F.conv_transpose2d` for the up layers), without the shift and the ReLU.
    The port never calls those on this path."""
    rows = {}
    for name, (side, c0, c1, cout, ksize) in CONV_LAYERS.items():
        cin = c0 + c1
        taps = ksize * ksize
        x = torch.relu(torch.randn(BATCH, side, side, cin, generator=gen)).to(dev).bfloat16()
        shift = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        if ksize == 3:
            oihw = torch.randn(cout, cin, 3, 3, generator=gen) * (9 * cin) ** -0.5
            oihw = oihw.to(dev).bfloat16()
            w = oihw.permute(2, 3, 1, 0).contiguous()
            lib_w = oihw.contiguous(memory_format=torch.channels_last)

            def library(x=x, lib_w=lib_w):
                return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), lib_w, padding=1)
        else:
            iohw = torch.randn(cin, cout, 4, 4, generator=gen) * (4 * cin) ** -0.5
            iohw = iohw.to(dev).bfloat16()
            # The sub-pixel phases of ops/fold.py:fold_upblock_phases.
            w = torch.stack([iohw[:, :, 3 - a - 2 * u, 3 - b - 2 * v]
                             for a in (0, 1) for b in (0, 1)
                             for u in (0, 1) for v in (0, 1)]).reshape(4, 4, cin, cout)
            w = w.contiguous()

            def library(x=x, iohw=iohw):
                return torch.nn.functional.conv_transpose2d(
                    x.permute(0, 3, 1, 2), iohw, stride=2, padding=1)
        kwargs = dict(ksize=ksize)
        first = x
        if c1:
            first = x[..., :c0].contiguous()
            kwargs.update(x2=x[..., c0:].contiguous(), w2=w[:, :, c0:].contiguous())
            w = w[:, :, :c0].contiguous()
        packed = dict(packed=pack_conv_weights(w, ksize))
        if c1:
            packed.update(packed2=pack_conv_weights(kwargs["w2"], ksize))
        plan = conv_tile_plan(c0, c1, cout, ksize, torch.bfloat16)
        with torch.inference_mode():
            want = conv_tile_reference(first, w, shift, **kwargs)
            out = torch.empty_like(want)
            got = conv_tile(first, w, shift, out=out, **kwargs, **packed)
            torch.cuda.synchronize()
            err = scaled_err(got, want)
            lib_out = torch.relu(library().float() + shift[None, :, None, None])
            lib_err = scaled_err(lib_out.permute(0, 2, 3, 1), want)
            ms = cuda_ms(lambda: conv_tile(first, w, shift, out=out, **kwargs, **packed))
            lib_ms = cuda_ms(library)
        flops = conv_flops(BATCH * side * side, taps * (4 if ksize == 2 else 1), cin, cout)
        moved = nbytes(x, w, shift, got) + (nbytes(kwargs["w2"]) if c1 else 0)
        bd = bound(flops, moved, PEAK_BF16_FLOPS)
        log(f"[conv {name}] body {plan.body}, {plan.cout_chunk} output channels by "
            f"{plan.tile[0]}x{plan.tile[1]} positions a block, {plan.kc} input channels a "
            f"stage, {plan.stages} slots, {plan.smem_bytes} B of shared memory: err "
            f"{err:.3e} of max|plain| (bound {CONV_BF16_RTOL:.3e}), the library call against "
            f"plain {lib_err:.3e}; kernel {ms:.3f} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
            f"TFLOP/s), bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} "
            f"({flops / 1e9:.1f} GFLOP, {moved / 1e6:.0f} MB), library {lib_ms:.3f} ms "
            f"({flops / (lib_ms * 1e-3) / 1e12:.1f} TFLOP/s)")
        check(plan.body == "wgmma" and plan.smem_bytes <= 232448,
              f"conv layer {name} does not take the wgmma body: {plan}")
        check(err <= CONV_BF16_RTOL, f"conv layer {name} disagrees with its plain version")
        check(lib_err <= BF16_ATOL, f"conv layer {name}: the library call computes another function")
        rows[name] = dict(body=plan.body, cout_chunk=plan.cout_chunk, tile=list(plan.tile),
                          kc=plan.kc, stages=plan.stages, smem_bytes=plan.smem_bytes,
                          max_abs_err=err, ms=ms, tflops=flops / (ms * 1e-3) / 1e12,
                          library_ms=lib_ms, **bd)
        del x, first, want, got, out, lib_out, kwargs
        torch.cuda.empty_cache()
    return rows


def canonical_tail(model, high):
    """The tail as the canonical forward runs it on a serving copy: cuDNN
    convs, eval BN, elementwise passes. NHWC in, NHWC f32 out."""
    def run(d1, f0, x):
        xin = x.to(d1.dtype).permute(0, 3, 1, 2)
        d2 = model.decoder[1](d1.permute(0, 3, 1, 2))
        res = torch.tanh(model.output_conv(torch.cat([d2, f0.permute(0, 3, 1, 2)], dim=1)))
        if high:
            res = res * model.detail_branch(xin)
        return torch.clamp(xin + res, 0.0, 1.0).permute(0, 2, 3, 1).float()
    return run


def phase_tail_kernels(dev, gen):
    """K3 and K4 alone at the main path's shapes: d1 (16, 128, 128, 4c) and
    f0 (16, 256, 256, c) drawn non-negative like the real decoder state."""
    results = {}
    for name, label, cls, c, fold_fn, tail, reference, n_launch in (
            ("medium_tail_chain", "K3", MediumIntensityDehazeModel, 64, fold_medium_tail,
             medium_tail_chain, medium_tail_chain_reference, MEDIUM_TAIL_LAUNCHES),
            ("high_tail_chain", "K4", HighIntensityDehazeModel, 96, fold_high_tail,
             high_tail_chain, high_tail_chain_reference, HIGH_TAIL_LAUNCHES)):
        high = name == "high_tail_chain"
        model = perturb_bn_(init_params_(cls(c), gen), gen).eval().to(dev)
        d1 = torch.relu(torch.randn(BATCH, SIZE // 2, SIZE // 2, 4 * c, generator=gen)).to(dev)
        f0 = torch.relu(torch.randn(BATCH, SIZE, SIZE, c, generator=gen)).to(dev)
        x = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen).to(dev)
        w32, wbf = fold_fn(model, torch.float32), fold_fn(model, torch.bfloat16)
        d1b, f0b = d1.bfloat16(), f0.bfloat16()
        serving = cast_for_serving(model, torch.bfloat16)
        canonical = canonical_tail(serving, high)
        with torch.inference_mode():
            ref = reference(d1, f0, x, w32)
            e32 = max_err(tail(d1, f0, x, w32), ref)
            before = tail.launches, spatial_gate.launches
            got = tail(d1b, f0b, x, wbf)
            launched = tail.launches - before[0], spatial_gate.launches - before[1]
            ebf = max_err(got, ref)
            tight = max_err(got, reference(d1b, f0b, x, wbf))
            ecan = max_err(got, canonical(d1b, f0b, x))
            ms = cuda_ms(lambda: tail(d1b, f0b, x, wbf), iters=10)
            ms32 = cuda_ms(lambda: tail(d1, f0, x, w32), iters=3, warmup=1)
            plain = cuda_ms(lambda: reference(d1b, f0b, x, wbf), iters=5, warmup=1)
            can_ms = cuda_ms(lambda: canonical(d1b, f0b, x), iters=10)
        flops = tail_flops(BATCH, SIZE, SIZE, c, high)
        moved = nbytes(d1b, f0b, x, got) + weights_nbytes(wbf)
        bd = bound(flops, moved, PEAK_BF16_FLOPS)
        log(f"[{label} {name}] d1 {tuple(d1.shape)}, f0 {tuple(f0.shape)}, c={c}: fp32 err "
            f"{e32:.3e}, bf16 vs fp32 plain {ebf:.3e}, bf16 vs bf16 plain {tight:.3e} "
            f"(bound {TAIL_BF16_ATOL}), bf16 vs the canonical bf16 tail {ecan:.3e}; "
            f"launches per call {launched[0]} (+{launched[1]} of K2'); bf16 kernel "
            f"{ms:.3f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), fp32 kernel "
            f"{ms32:.3f} ms, plain {plain:.3f} ms, canonical tail (cuDNN, bf16) "
            f"{can_ms:.3f} ms; bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} "
            f"({flops / 1e9:.1f} GFLOP, {moved / 1e6:.0f} MB)")
        check(e32 <= FP32_ATOL and ebf <= BF16_ATOL,
              f"{label} disagrees with its plain version")
        check(tight <= TAIL_BF16_ATOL,
              f"{label}'s bf16 kernels disagree with the bf16 plain version")
        check(launched == (n_launch, int(high)), f"{label} launches per call {launched}")
        results[name] = dict(
            max_abs_err=tight, max_abs_err_bf16_vs_fp32=ebf, max_abs_err_fp32=e32,
            ms=ms, fp32_ms=ms32, plain_ms=plain, canonical_ms=can_ms, library_ms=None,
            launches_per_call=launched[0], shape=list(d1.shape), **bd)
        del d1, f0, x, d1b, f0b, ref, got
        torch.cuda.empty_cache()
    return results


def scaled_err(a, ref):
    """Max abs difference in units of the reference's largest magnitude (at
    least 1)."""
    return max_err(a, ref) / max(1.0, float(ref.float().abs().max()))


def phase_res_chain_kernels(dev, gen):
    """K6 alone at the six main-path segments, batch 16, inputs drawn
    non-negative like the activation after a ConvBlock. Returns the sums
    over the six segments and each segment's readings."""
    segments = {}
    for name, (c, down, kinds) in RES_SEGMENTS.items():
        blocks = torch.nn.Sequential(*[ResidualBlock(c) if k == "res" else AttentionBlock(c)
                                       for k in kinds])
        blocks = perturb_bn_(init_params_(blocks, gen), gen).eval().to(dev)
        side = SIZE // down
        x = torch.relu(torch.randn(BATCH, side, side, c, generator=gen)).to(dev)
        xb = x.bfloat16()
        w32 = fold_res_attn_chain(blocks, torch.float32)
        wbf = fold_res_attn_chain(blocks, torch.bfloat16)
        serving = cast_for_serving(blocks, torch.bfloat16)

        def canonical(v, serving=serving):
            return serving(v.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        with torch.inference_mode():
            ref = res_attn_chain_reference(x, w32)
            e32 = scaled_err(res_attn_chain(x, w32), ref)
            before = res_attn_chain.launches, channel_spatial_gate.launches
            got = res_attn_chain(xb, wbf)
            launched = (res_attn_chain.launches - before[0],
                        channel_spatial_gate.launches - before[1])
            ebf = scaled_err(got, ref)
            tight = scaled_err(got, res_attn_chain_reference(xb, wbf))
            ecan = scaled_err(got, canonical(xb))
            ms = cuda_ms(lambda: res_attn_chain(xb, wbf), iters=5, warmup=1)
            ms32 = cuda_ms(lambda: res_attn_chain(x, w32), iters=2, warmup=1)
            plain = cuda_ms(lambda: res_attn_chain_reference(xb, wbf), iters=2, warmup=1)
            can_ms = cuda_ms(lambda: canonical(xb), iters=5, warmup=1)
        px = BATCH * side * side
        n_res = sum(k == "res" for k in kinds)
        n_attn = len(kinds) - n_res
        flops = (2 * n_res * conv_flops(px, 9, c, c)
                 + n_attn * (6 * px * c + conv_flops(px, 49, 2, 1)))
        moved = 2 * nbytes(xb) + weights_nbytes(wbf)
        bd = bound(flops, moved, PEAK_BF16_FLOPS)
        scale = float(ref.abs().max())
        log(f"[K6 res_attn_chain] {name} {tuple(x.shape)} {list(kinds)}: errors in units of "
            f"max|plain| = {scale:.2f}: fp32 {e32:.3e}, bf16 vs fp32 plain {ebf:.3e}, bf16 vs "
            f"bf16 plain {tight:.3e} (bound {RES_BF16_RTOL}), bf16 vs the canonical bf16 "
            f"blocks {ecan:.3e}; launches per call {launched[0]} (+{launched[1]} of K2); "
            f"bf16 kernel {ms:.3f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), fp32 kernel "
            f"{ms32:.3f} ms, plain {plain:.3f} ms, canonical blocks (cuDNN + K2, bf16) "
            f"{can_ms:.3f} ms; bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} "
            f"({flops / 1e9:.1f} GFLOP, {moved / 1e6:.0f} MB)")
        check(e32 <= FP32_ATOL and ebf <= BF16_ATOL,
              f"K6 disagrees with its plain version at {name}")
        check(tight <= RES_BF16_RTOL,
              f"K6's bf16 kernels disagree with the bf16 plain version at {name}")
        check(launched == launches_of(kinds), f"K6 launches per call at {name}: {launched}")
        segments[name] = dict(
            max_abs_err=tight, max_abs_err_bf16_vs_fp32=ebf, max_abs_err_fp32=e32,
            err_unit=scale, ms=ms, fp32_ms=ms32, plain_ms=plain, canonical_ms=can_ms,
            launches_per_call=launched[0], shape=list(x.shape), kinds=list(kinds), **bd)
        del x, xb, ref, got, blocks, serving
        torch.cuda.empty_cache()
    total = {k: sum(seg[k] for seg in segments.values())
             for k in ("ms", "fp32_ms", "plain_ms", "canonical_ms", "bound_ms", "bytes", "flops")}
    for level in ("medium", "high"):
        own = [seg for name, seg in segments.items() if name.startswith(level)]
        log(f"[K6 res_attn_chain] the {level} branch's three segments: bf16 kernel "
            f"{sum(s['ms'] for s in own):.3f} ms, canonical blocks "
            f"{sum(s['canonical_ms'] for s in own):.3f} ms, bound "
            f"{sum(s['bound_ms'] for s in own):.3f} ms")
    return dict(max_abs_err=max(seg["max_abs_err"] for seg in segments.values()),
                max_abs_err_fp32=max(seg["max_abs_err_fp32"] for seg in segments.values()),
                err_unit="max|plain| of each segment",
                per="one call of each of the six main-path segments",
                bound_by=segments["high e2b"]["bound_by"], library_ms=None,
                segments=segments, **total)


def phase_probe_kernels(dev):
    """Each probe's wrapper on the card against its plain expression, and
    their times; sums over the ten patterns."""
    x, w, wrep = probe_ops.probe_inputs(dev, SEED)
    worst, ms, plain, moved, flops = 0.0, 0.0, 0.0, 0, 0
    for name in probe_ops.PROBES:
        got = probe_ops.probe_op(name, x, w, wrep)
        want = probe_ops.probe_reference(name, x, w, wrep)
        err = scaled_err(got, want)
        check(got.shape == want.shape and err <= probe_ops.PROBE_RTOL,
              f"probe {name} disagrees with its plain expression: {err:.3e}")
        worst = max(worst, err)
        ms += cuda_ms(lambda: probe_ops.probe_op(name, x, w, wrep))
        plain += cuda_ms(lambda: probe_ops.probe_reference(name, x, w, wrep))
        moved += nbytes(x, got) + (nbytes(w) if "K384" in name else 0) + (
            nbytes(wrep) if "N384" in name else 0)
        flops += 2 * x.numel() + 2 * got.numel() * (384 if "dot" in name else 1)
    bd = bound(flops, moved, PEAK_F32_FLOPS)
    log(f"[probes] ten patterns on x {tuple(x.shape)} bf16: worst err {worst:.3e} of the "
        f"result's largest magnitude (bound {probe_ops.PROBE_RTOL}); kernels {ms:.3f} ms, "
        f"plain {plain:.3f} ms; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    return dict(max_abs_err=worst, err_unit="max|plain| of each pattern", ms=ms,
                plain_ms=plain, library_ms=None, per="the ten patterns, one launch each",
                shape=list(x.shape), **bd)


def make_router(cfg, gen):
    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    return perturb_bn_(init_params_(router, gen), gen)


def check_images(y, n, what):
    check(tuple(y.shape) == (n, SIZE, SIZE, 3), f"{what}: shape {y.shape}")
    check(bool(np.isfinite(y).all()), f"{what}: non-finite output")
    check(float(y.min()) >= 0.0 and float(y.max()) <= 1.0, f"{what}: outside [0, 1]")


def counts():
    return {k: fn.launches for k, fn in launch_counters().items()}


def time_slice(d, x, tag):
    """Warm ms/image of route_hard and soft, host clock around a
    synchronize, 3 runs each."""
    def run_hard():
        d.route_hard(x)
        torch.cuda.synchronize()

    def run_soft():
        d(x)
        torch.cuda.synchronize()

    means = {}
    for name, fn in (("route_hard", run_hard), ("soft", run_soft)):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3 / BATCH)
        means[name] = float(np.mean(times))
        log(f"[{tag}] {name}: {means[name]:.3f} ms/image warm (min "
            f"{min(times):.3f}, max {max(times):.3f}; 3 runs of {BATCH} images at "
            f"{SIZE}^2, bf16, numpy in and out)")
    return means


def dispatch_cost_ms(d, dev, gen):
    """What one more bucket costs the engine: the part of a branch call
    that does not grow with its rows. Every branch apply is timed warm at
    every bucket size (host clock around a synchronize, the least of 5
    runs); the intercept of the least-squares line through (rows, ms) is
    that branch's fixed cost, printed beside the constant the chunk planner
    is fed for it under autotune. Returns {level: intercept}."""
    eng = d.engine
    x = torch.rand(max(eng.buckets), SIZE, SIZE, 3, generator=gen).to(dev)
    fixed = {}
    for level, apply in zip(INTENSITY_ORDER, eng.branch_applies):
        ms = []
        for b in eng.buckets:
            times = []
            for _ in range(6):   # the first run warms this size
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode():
                    apply(x[:b])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms.append(min(times[1:]))
        slope, fixed[level] = np.polyfit(np.asarray(eng.buckets, float), ms, 1)
        log(f"[dispatch] {level}: ms at {list(eng.buckets)} rows "
            f"{[round(v, 3) for v in ms]}: {slope:.4f} ms/row, fixed {fixed[level]:.4f} ms "
            f"({fixed[level] / slope:.2f} rows; default dispatch, bf16, {SIZE}^2); the "
            f"chunk planner is fed AdaptiveDehazer.DISPATCH_MS = "
            f"{AdaptiveDehazer.DISPATCH_MS[level]}")
    return {k: float(v) for k, v in fixed.items()}


def drive(d, x, labels, dev):
    """The three calls of a path, the counters read around each: returns
    the outputs and the launches of (route_hard, forced labels, soft)."""
    reset_launch_counts()
    out, intensity = d.route_hard(x)
    torch.cuda.synchronize()
    hard = counts()
    before = counts()
    with torch.inference_mode():
        forced, _ = d.engine(torch.from_numpy(x).to(dev), intensity=labels)
        forced = forced.cpu().numpy()
    forced_d = delta(before)
    before = counts()
    soft = d(x)
    soft_d = delta(before)
    return (out, forced, soft), intensity, (hard, forced_d, soft_d), counts()


def delta(before):
    now = counts()
    return {k: now[k] - before[k] for k in now}


def buckets_per_class(eng, labels):
    return [len(plan_chunks(int((labels == c).sum()), eng.buckets,
                            eng.program_overhead_rows[c])) for c in range(3)]


def nonzero(d):
    return {k: v for k, v in d.items() if v}


def phase_slice(router, dev, x, labels, gen):
    """The default dispatch (autotune off)."""
    cfg = load_config()   # bf16, the default compute dtype
    d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev)
    per_class = buckets_per_class(d.engine, labels)
    outs, intensity, (hard, forced_d, soft_d), main = drive(d, x, labels, dev)

    log(f"[slice] route_hard intensities {np.bincount(intensity, minlength=3).tolist()}; "
        f"launches: route_hard {nonzero(hard)}, forced labels {nonzero(forced_d)}, "
        f"soft {nonzero(soft_d)}")
    for y, what in zip(outs, ("route_hard", "forced-label engine", "soft")):
        check_images(y, BATCH, what)
    k1 = K1_LAUNCHES[torch.bfloat16]
    check(nonzero(forced_d) == {"lightweight_chain": k1 * per_class[0],
                                "cbam_gate": 6 * per_class[2]},
          f"forced run: launches {forced_d} vs buckets {per_class}")
    check(nonzero(soft_d) == {"lightweight_chain": k1, "cbam_gate": 6, "blend3": 1},
          f"soft run launches {soft_d}")
    check(all(main[k] > 0 for k in DEFAULT_PATH_KERNELS), f"a kernel never ran: {main}")
    return main, outs, time_slice(d, x, "slice"), dispatch_cost_ms(d, dev, gen)


def tune_then_force(router, cfg, dev, tmp, tag, dispatches):
    """A dehazer with autotune on and a fresh cache times every candidate
    and prints the tables; returns, for each forced dispatch (level ->
    candidate), the path of a copy of that cache whose winners are set to
    it, and the tables."""
    fresh = os.path.join(tmp, f"autotune_{tag}.json")
    d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev, autotune=True,
                        autotune_cache=fresh)
    tables = {}
    for level, report in d.autotune_report.items():
        log(f"[autotune {tag}] {level}: best {report['best']}, ms per 16 images "
            f"{json.dumps(report['table'])}")
        check(report["cached"] is False, f"{level}: a fresh cache gave a hit")
        check(all(v is not None for v in report["table"].values()),
              f"{level}: a candidate failed: {report['table']}")
        offered = {name for lvl, name in BUCKET_LAUNCHES if lvl == level}
        check(set(report["table"]) == offered,
              f"{level}: candidates {sorted(report['table'])}, expected {sorted(offered)}")
        tables[level] = dict(best=report["best"], **report["table"])
    with open(fresh) as f:
        cache = json.load(f)
    check(len(cache) == 3, f"the cache holds {len(cache)} entries, not 3")
    paths = []
    for i, forced in enumerate(dispatches):
        for key, entry in cache.items():
            entry["best"] = forced[CLASS_OF[key.split(":")[3]]]
            check(entry["best"] in entry["table"], f"{key}: {entry['best']} was not offered")
        paths.append(os.path.join(tmp, f"autotune_{tag}_forced{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(cache, f)
    del d
    torch.cuda.empty_cache()
    return paths, tables


def expected_launches(forced, per_class, soft, dtype=torch.bfloat16):
    """The counters a run under the forced dispatch must show in compute
    dtype `dtype`: per bucket of each class (`per_class`), plus the blend on
    the soft call."""
    want = {"blend3": 1} if soft else {}
    for level, buckets in zip(INTENSITY_ORDER, per_class):
        for kernel, n in BUCKET_LAUNCHES[(level, forced[level])].items():
            n = n[dtype] if isinstance(n, dict) else n
            want[kernel] = want.get(kernel, 0) + n * buckets
    return nonzero(want)


def phase_forced_slice(router, dev, x, labels, canonical_outs, forced_cache, forced, tag,
                       path_kernels):
    """A forced dispatch: serve from a cache that names the kernel
    candidates `forced`, and hold the outputs against the default dispatch's
    and the counters against the candidates' launches per bucket."""
    cfg = load_config()
    d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev, autotune=True,
                        autotune_cache=forced_cache)
    check(all(r["cached"] is True for r in d.autotune_report.values()),
          f"the {tag} dehazer did not read the cache: {d.autotune_report}")
    check({lvl: r["best"] for lvl, r in d.autotune_report.items()} == forced,
          f"forced dispatch: {d.autotune_report}")
    per_class = buckets_per_class(d.engine, labels)
    outs, intensity, (hard, forced_d, soft_d), main = drive(d, x, labels, dev)
    log(f"[{tag}] dispatch {forced}; chunk overhead rows "
        f"{[round(v, 3) for v in d.engine.program_overhead_rows]}, "
        f"buckets per class {per_class}; route_hard intensities "
        f"{np.bincount(intensity, minlength=3).tolist()}; launches: route_hard "
        f"{nonzero(hard)}, forced labels {nonzero(forced_d)}, soft {nonzero(soft_d)}")
    for y, ref, what in zip(outs, canonical_outs,
                            ("route_hard", "forced-label engine", "soft")):
        check_images(y, BATCH, f"{tag} {what}")
        err = float(np.abs(y - ref).max())
        log(f"[{tag}] {what}: max abs diff to the default dispatch {err:.3e} "
            f"(bound {BF16_ATOL})")
        check(err <= BF16_ATOL, f"{tag} {what} disagrees with the default dispatch")
    check(nonzero(forced_d) == expected_launches(forced, per_class, soft=False),
          f"{tag}, forced run: launches {forced_d} vs buckets {per_class}")
    check(nonzero(soft_d) == expected_launches(forced, (1, 1, 1), soft=True),
          f"{tag}, soft run launches {soft_d}")
    check(all(main[k] > 0 for k in path_kernels), f"{tag}: a kernel never ran: {main}")
    return main, time_slice(d, x, tag)


def phase_probe_tool(dev):
    """The probe tool as its user runs it: every pattern must pass. Returns
    the launch counters of that run."""
    reset_launch_counts()
    failed = probe_ops.run_probes(dev, SEED, log=lambda line: log(f"[probe tool] {line}"))
    torch.cuda.synchronize()
    check(not failed, f"probes failed: {failed}")
    main = counts()
    check(main["probe_ops"] == len(probe_ops.PROBES), f"the probe tool launched {main}")
    return main


def phase_vs_plain(router, dev, rng, tmp):
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    x = rng.random((3, SIZE, SIZE, 3), dtype=np.float32)
    labels = np.array([0, 1, 2])
    (tail_cache, res_cache), _ = tune_then_force(router, cfg, dev, tmp, "fp32",
                                                 (TAIL_FORCED, RES_FORCED))
    outs = {}
    for tag, device, cache, forced in (
            ("CPU", "cpu", None, None), ("card, default dispatch", dev, None, None),
            ("card, tail-chain dispatch", dev, tail_cache, TAIL_FORCED),
            ("card, res-chain dispatch", dev, res_cache, RES_FORCED)):
        kwargs = dict(autotune=True, autotune_cache=cache) if cache else {}
        d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=device, **kwargs)
        before = counts()
        with torch.inference_mode():
            y, _ = d.engine(torch.from_numpy(x).to(device), intensity=labels)
        outs[tag] = y.cpu()
        if forced:
            ran = nonzero(delta(before))
            check(ran == expected_launches(forced, (1, 1, 1), soft=False, dtype=torch.float32),
                  f"the fp32 {tag} launched {ran}")
    for tag in list(outs)[1:]:
        err = max_err(outs["CPU"], outs[tag])
        log(f"[slice vs plain] fp32, labels {labels.tolist()}, {SIZE}^2, {tag}: max abs "
            f"err vs CPU {err:.3e} (bound {SLICE_ATOL})")
        check(err <= SLICE_ATOL, f"the card's slice ({tag}) disagrees with the plain path")


def main():
    phase_device()
    dev = torch.device("cuda")
    phase_build()
    gen = torch.Generator().manual_seed(SEED)
    kernels, conv_layers = phase_kernels(dev, gen)
    router = make_router(load_config(), gen)
    rng = np.random.default_rng(SEED)
    x = rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    labels = np.arange(BATCH) % 3
    with tempfile.TemporaryDirectory() as tmp:
        default, outs, default_ms, dispatch = phase_slice(router, dev, x, labels, gen)
        (tail_cache, res_cache), tables = tune_then_force(
            router, load_config(), dev, tmp, "bf16", (TAIL_FORCED, RES_FORCED))
        tail, tail_ms = phase_forced_slice(router, dev, x, labels, outs, tail_cache,
                                           TAIL_FORCED, "tail slice", TAIL_PATH_KERNELS)
        res, res_ms = phase_forced_slice(router, dev, x, labels, outs, res_cache,
                                         RES_FORCED, "res slice", RES_PATH_KERNELS)
        probes = phase_probe_tool(dev)
        phase_vs_plain(router, dev, rng, tmp)
    for name in ("route_hard", "soft"):
        log(f"[slices] {name}: default dispatch {default_ms[name]:.3f} ms/image, "
            f"tail-chain dispatch {tail_ms[name]:.3f} ms/image, res-chain dispatch "
            f"{res_ms[name]:.3f} ms/image")

    paths = {"default": default, "tail_chain": tail, "res_chain": res, "probe_tool": probes}
    line = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": sum(path[name] for path in paths.values()),
         "launches_by_path": {tag: path[name] for tag, path in paths.items()},
         **kernels[name]}
        for name, (route, source, replaces) in KERNELS.items()],
        "conv_layers": conv_layers, "autotune_ms_per_16_images": tables, "dispatch_ms": dispatch,
        "slice_ms_per_image": {"default": default_ms, "tail_chain": tail_ms,
                               "res_chain": res_ms}}
    check(all(k["launches"] > 0 for k in line["kernels"]),
          f"a kernel was launched no time on any path: {line['kernels']}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
