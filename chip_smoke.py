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
   the card's peak rate, counted from this run's shapes. The conv-layer
   table also prints each layer's plan (ring slots, blocks an SM) and the
   blocks an SM the occupancy API gives its kernel; K3 its plan (in bf16
   at c=64 the head group, its tile and shared memory: 5 launches).
4. Slice, default dispatch: the full-width default router (resnet18, low
   c=32, medium c=64, high c=96) with seeded random weights behind an
   AdaptiveDehazer in bf16, 16 images at 256^2: route_hard, the engine with
   forced labels cycling 0, 1, 2 (so every branch runs), and soft routing.
   Outputs must be finite and in [0, 1], and the launch counters, set to 0
   just before, must show that the runs went through K1 (4 launches per
   low bucket in bf16), K2 (6 launches per high-branch call) and K5. Prints
   the warm ms/image of route_hard (the classifier's labels: with this seed
   all 16 images route medium), of the forced-label engine (labels cycling
   0, 1, 2: the one hard-routing reading that runs every branch) and of soft
   routing, and what one more bucket of each branch costs the engine (the
   intercept of the branch apply's time over its rows).
4b. Engines, on phase 4's dehazer and the same 16 images. Forced labels
   (cycling 0, 1, 2) through run_stream and run_queued (three batches,
   given intensities) and the device-binned engine with and without spill
   (three calls): every output within 3e-2 of phase 4's forced-label
   engine, run_queued's global indices cover 0..47 once, and the counters
   (set to 0 just before) show 4 K1 launches per low chunk and 6 K2
   launches per high chunk. The product routes route_hard_stream,
   route_hard_queued, route_device_binned, route_device_binned_stream (on
   ragged batches of 16, 5, 16 and 11), route_switch and route_sharded:
   labels equal route_hard's on the same batches, outputs finite and in
   [0, 1]; make_adaptive_infer("soft") launches K5 once. The device-binned
   call's classifier and binning, up to its one event-guarded read, run
   under torch.cuda.set_sync_debug_mode("error"); whether each branch apply
   synchronizes is printed (a reading). Prints the warm ms/image of every
   route beside route_hard's (16 images, 3 runs, host clock around a
   synchronize; the stream routes over 8 batches of 16, each result dropped
   as it comes, and the two numpy stream routes again with all 8 kept).
5. Tune: a dehazer with autotune=True and a fresh cache file times every
   candidate of the three branches at (16, 256, 256, 3) and prints the
   tables (no candidate may fail; the low `canonical` must launch no K1).
   The cost of one more bucket is read again on the tuned winners: the
   chunk planner subtracts AdaptiveDehazer.DISPATCH_MS from the winners'
   times, so those intercepts are the ones it stands for, and they are
   printed beside it. The two forced paths below share this one tuning run.
6. Slice, tail-chain dispatch: a dehazer whose cache names chain /
   tail_chain / tail_chain runs the same three calls. The counters, set to
   0 just before, must show K3 and K4 launched once per medium and high
   bucket (5 and 11 launches in bf16), K2' once and K2 5 times per high
   bucket; the outputs must agree with phase 4's within 3e-2. Prints the
   warm ms/image of the three calls beside phase 4's.
7. Slice, res-chain dispatch: the same under chain / chain_hybrid /
   res_e2b_tail_chain: K6 must show 14 launches per medium bucket and 17
   per high bucket, K4 11 and K2' 1 per high bucket, K2 5 (3 inside K6, 2
   in the AttentionBlocks that stay canonical).
8. The probe tool's own entry point (run_probes): every pattern must PASS,
   ten launches.
9. Slice vs plain: the same weights run a forced-label batch on the CPU in
   fp32 (the plain versions) and on the card in fp32 (the kernels), under
   the default, the tail-chain and the res-chain dispatch.
10. Training (the per-branch trainer, adam_dehaze_tpu_torch/training/
   train_dehazing.py). First, with the launches of this part not counted
   on any path: K2's autograd Function at the six AttentionBlock shapes of
   the high branch, its forward against the fp32 plain version and its
   gradients against plain autograd of the plain version in the same dtype
   (fp32 within 1e-4, bf16 within 3e-2 of each result's largest magnitude),
   its forward and backward timed per high train step (the bf16 gradients
   also against the fp32 plain version, as a reading); and one fp32 train
   step of each default branch (TF32 off, augmentation off, 64^2, batch 2)
   on the card against the same step on the CPU (loss within 1e-4
   relative) and against float64 on the CPU: each gradient, in units of
   its own largest magnitude, within 4 times the CPU's fp32 error on it or
   1e-1, whichever is larger; all of them within 1e-3 of the branch's
   largest gradient, or twice the CPU's own error there (see STEP_GRAD_K).
   Then, counters
   at 0: a synthetic 256^2 corpus (48 train and 16 val images an intensity)
   written by the port, `train_all_dehazing_models` at the default widths in
   bf16 for 1 epoch, then again with resume=True for 2 epochs, which must
   pick up each branch's best_model (6 steps in all). Every loss component
   of every step must be finite; after each branch's first step every
   trainable parameter must hold a finite gradient that is not all zero;
   each high train step must launch K2 six times and each high eval batch
   six times, the low validation must launch K1; each branch's best_model
   must reload into a fresh module and give the same eval output. Prints
   each branch's warm ms per train step (synchronized), images/s and peak
   memory, with the card's name and power limit.
   The same fp32 check (card and CPU against float64, the same per-tensor
   rule) also takes one soft joint step of the default router (64^2, batch
   2, dropout off): the frozen classifier, the three branches, K5 and the
   JointLoss.
11. The autograd Functions of K5 and K2' (launches not counted on any
   path): at (16, 256, 256, 3) and (16, 256, 256, 96), fp32 and bf16, the
   forward launches the kernel once and matches the fp32 plain version,
   every gradient matches plain autograd of the plain version in the same
   dtype (1e-4 fp32, 3e-2 bf16 of each result's largest magnitude), the
   backward launches nothing; the Function's forward and backward and the
   plain forward and backward timed (CUDA events; K5 in fp32, its dtype in
   the joint step, K2' in bf16).
12. The classifier trainer (training/train_classifier.py) at the default
   width (resnet18, bf16, 256^2, batch 16) on phase 10's corpus, counters
   at 0: 1 epoch, then resumed to 2 (9 steps each, the second run from the
   saved step 9); the best checkpoint, reloaded into a fresh classifier,
   gives the same eval output. Prints warm ms/step, images/s, peak memory
   and the validation accuracy.
13. The joint trainer (training/train_joint.py) at the default widths
   (soft routing, T = 0.5, bf16), counters at 0, grafting phase 12's
   classifier and phase 10's branches: 2 epochs, soft then hard
   (hard_finetune_frac 0.5). Every soft step and soft validation batch
   launches K5 once and K2 six times (and the validation K1); each hard
   step of the high branch K2 six times and none of the others K2 or K5;
   the classifier's parameters stay bitwise as grafted while its BN
   statistics move; the best checkpoint, reloaded into a fresh router,
   gives the same eval output. That checkpoint is then served through
   `AdaptiveDehazer(router, None, cfg).route_hard` on the 48 validation
   images: its label histogram, accuracy, kernels launched and warm
   ms/image. Prints the soft ms/step, images/s and peak memory, and each
   hard branch's.
14. Detection (models/detection.py, training/train_detection.py,
   evaluation/evaluate.py) at full width: fcos_resnet18_fpn, 91 classes,
   256^2, bf16, detection batch 8. A corpus with boxes from the port's
   corpus tool (32 train, 16 val and 16 test images an intensity). The
   seeded detector in fp32 on the card against the CPU on 8 test images
   (TF32 off): each level's logits, offsets and centerness within 1e-4 of
   the tensor's largest magnitude, the same top-k candidates (labels equal,
   boxes within 1e-3 px, scores within 1e-5) and the same detections; bf16
   against fp32 at 3e-2. `train_detection` for 2 epochs, counters at 0:
   every loss component finite, the best checkpoint reloaded into a fresh
   DetectionModel gives bitwise the same candidates and detections; warm
   ms/step, images/s and peak memory. `evaluate_object_detection` with phase
   13's joint checkpoint as the dehazer and the trained detector, counters
   at 0: every test batch's dehazing launches K2 six times and K5 once; the
   COCO matcher that ran must be the native one, and its 12 stats on the
   phase's detections equal the Python matcher's. Prints hazy and dehazed
   mAP (no threshold: two epochs train no detector), the detector's warm
   ms/image (forward and top-k, synchronized, batch 16), the router's and
   the integrated system's ms/image and the host's decode + NMS ms a batch.
15. The command line (adam_dehaze_tpu_torch/cli.py, what main_torch.py
   runs), through `cli.main([...])` on the card, on an experiment directory
   in the layout of `create_experiment_dir`: config.yaml at the default
   widths, 256^2, bf16, with phase 14's corpus (and its boxes) as the
   dataset; the best checkpoints of phases 12 (classifier), 10 (the three
   branches), 13 (joint) and 14 (detection); phase 5's tuned cache as
   serving_autotune.json. Counters at 0 before each run: `--mode evaluate`
   must write comprehensive_results.json with the JAX package's key tree
   (COMPREHENSIVE_SCHEMA) and only finite numbers, serve its hard rows from
   the tuned cache (the dispatch of each branch is printed), and launch K1,
   K2 and K5 (K3, K4, K2' and K6 printed); each section's seconds, the PSNR
   rows, routing_acc, the spilled fractions, the three no-reference proxies
   and the two mAPs are printed. `--mode serve` with hard (and --detect),
   spill_up, stream, queued, device and soft on the test split's hazy
   images: one PNG per image and a routing.json each, hard's labels equal
   route_hard's on the same batches, detections.json one entry per image;
   each mode's ms/image by the host clock, process set-up and PNG I/O
   included (a reading). `--mode demo` writes its figures and `--mode
   preprocess` splits a raw directory of a few triplets.
16. The half-resolution dial (ops/resolution.py, resolution_autotune.py)
   on phase 15's experiment. First the kernels of its path alone at its
   shapes, every branch at 128^2 (launches not counted on any path): K1,
   K2 at the six AttentionBlock shapes, K2', K3, K4 and K6's six segments,
   each against its plain version at phase 3's bounds, timed, with its
   bound. Then `AdaptiveDehazer.from_experiment(exp, autotune=True)` reads
   the experiment's tuned cache, and its route_hard gives phase 15's
   dehazer's labels and outputs within 3e-2; the port's resolution tool
   (tools/autotune_resolution.py) probes the val split through the tuned
   winners and writes resolution_policy.json: every candidate of every
   branch has a PSNR and a time, no error row (full against half
   resolution, ms/image and PSNR per branch, printed as readings). Counters
   at 0: forced labels 0/1/2 through the engine's `dispatch` with every
   branch at half resolution under the default, the tuned and phase 5's
   two forced dispatches (each within 3e-2 of the default's), route_hard
   with lowres="auto", route_hard_stream with lowres=("high",) (batch by
   batch as route_hard), and the CLI's `serve --lowres high` (hard) and
   `--lowres auto` (stream), whose routing.json holds the dial and
   route_hard's labels; K1, K2, K2', K3, K4 and K6 must all have launched.
   Prints full and half-resolution ms/image of the forced-label engine
   under the default and the tuned dispatch. Last, the fp32 path with
   every branch at half resolution, forced labels 0/1/2, on the card under
   the default, the tail-chain and the res-chain dispatch against the CPU
   at 1e-3.
17. The alternate branches and backbones, at the default config's widths,
   256^2, batch 16, bf16, seeded weights (ALT_ROUTERS). First K2 alone at
   the shapes these branches give it (dual_branch: c = 96 at 128^2 and
   64^2; the high encoder_decoder: 768 channels at 32^2), against its plain
   version at phase 3's bounds (its statistics pass at MAPS_ATOL), timed
   beside its bound (launches not counted on any path). Then router A
   (low unet c=32, medium corun c=64 x 6, high dual_branch c=96,
   mobilenet_v3_small) and router B (default low, medium and high
   encoder_decoder c=64 and c=96, efficientnet_b0) each behind an
   AdaptiveDehazer: route_hard, forced labels 0/1/2 and soft, the counters
   at 0 before them: outputs finite and in [0, 1], K2 launched once per
   AttentionBlock of each high bucket (two in dual_branch, one in the high
   encoder_decoder), K1 per low bucket of router B, K5 once per soft call.
   Prints each router's warm ms/image (route_hard, forced labels, soft).
   Last, fp32 with TF32 off: each alternate branch and each new backbone on
   the card against the CPU at 1e-3 (2 images).
18. Precompiled serving (serving_export.py) on phase 15's experiment: the
   CLI's `--mode export` at batch 48 (the default dispatch; the bundle must
   hold the kernel library) and `export_precompiled` of the tuned dehazer
   (phase 5's winners from the experiment's cache). Cold start in a fresh
   process each, from_experiment and one route_hard of 48 images, without
   the bundle (the library built on disk) and with it (an empty kernel
   build directory: the process must load the bundle's library), beside
   phase 2's nvcc seconds. The engines built (the attach: warm-ups and
   captures, timed, with the graphs' peak memory), then counters at 0:
   forced labels (16 a class), route_hard and route_device_binned of the 48
   images through the graphs must launch K1 and K2 (default bundle) and K3,
   K4, K2' and K6 (tuned bundle) by replays alone; every dispatcher shows
   hits and no miss. Graphs against eager dehazers on the same
   inputs (labels equal; outputs within GRAPH_FP32_ATOL in fp32, BF16_ATOL
   in bf16; the error is printed) and warm ms/image of each, eager and
   graphs, under both dispatches (forced labels also on 3 images, one a
   class, exported through the API: buckets of one image, where the host's
   launches weigh most). A copy of the
   bundle whose manifest names another device is refused with a warning
   naming the field, and route_hard serves the eager output.
19. Prints each phase's seconds, the kernels' JSON line (`launches_by_path`
   with "training", "classifier_training", "joint_training", "detection",
   "cli", "lowres", "alternate" and "precompiled"; K5's and K2''s Function
   readings under "function"; each lowres kernel's readings at 128^2 under
   "lowres", K2's at the alternate branches' shapes under "alternate"; the
   CLI's, the dial's, the alternates' and precompiled serving's readings
   under "cli", "lowres", "alternate" and "precompiled") and, last, {"ok":
   true, "device": ...}.
"""
import collections
import copy
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.data.dataset import get_dataloader
from adam_dehaze_tpu_torch.data.detection import get_detection_dataloader
from adam_dehaze_tpu_torch.data.preprocessing import generate_synthetic_dataset
from adam_dehaze_tpu_torch.evaluation import coco_eval
from adam_dehaze_tpu_torch.evaluation import evaluate as det_eval
from adam_dehaze_tpu_torch.losses.dehazing import get_dehazing_loss, get_joint_loss
from adam_dehaze_tpu_torch.models.branches import (
    HighIntensityDehazeModel,
    LightweightDehazeModel,
    MediumIntensityDehazeModel,
    create_branch_models,
)
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.detection import (
    DetectionModel,
    _device_topk,
    candidates_agree,
    create_detection_model,
    create_integrated_system,
    detections_agree,
    imagenet_normalize,
    postprocess,
)
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    create_router,
    make_adaptive_infer,
    plan_chunks,
)
from adam_dehaze_tpu_torch.nn.blocks import (
    AttentionBlock,
    Dropout,
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
    fold_high_tail,
    fold_medium_tail,
    high_tail_chain,
    high_tail_chain_reference,
    medium_tail_chain,
    medium_tail_chain_reference,
    medium_tail_plan,
    weight_tensors,
)
from adam_dehaze_tpu_torch.ops.serving_apply import cast_for_serving
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.serving_autotune import candidate_builders
from adam_dehaze_tpu_torch.tools import probe_ops
from adam_dehaze_tpu_torch.tools.make_synthetic_corpus import make_corpus
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training import train_classifier as tc
from adam_dehaze_tpu_torch.training import train_detection as tdet
from adam_dehaze_tpu_torch.training import train_dehazing as td
from adam_dehaze_tpu_torch.training import train_joint as tj
from adam_dehaze_tpu_torch.training.common import autocast, device_batch
from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer

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
def k2_shapes(size):
    """K2's shapes in the canonical high branch (c=96) on size^2 images: calls
    per branch call, by shape."""
    return {(BATCH, size // 2, size // 2, 192): 2, (BATCH, size // 4, size // 4, 384): 3,
            (BATCH, size, size, 96): 1}


K2_SHAPES = k2_shapes(SIZE)
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
# K3's at the medium width: the head group in bf16 (5), two launches for the
# head in fp32 (6).
K3_LAUNCHES = {dt: medium_tail_plan(64, dt).launches for dt in (torch.bfloat16, torch.float32)}


def _k6_launches(level, segments):
    """(on K6, on K2) per bucket of a branch with these segments on K6."""
    per = [launches_of(RES_SEGMENTS[f"{level} {seg}"][2]) for seg in segments]
    return sum(a for a, _ in per), sum(b for _, b in per)


# Kernel launches per bucket of every serving candidate: (level, name) ->
# {kernel: launches} (K1's and K3's by compute dtype). K2 counts the AttentionBlocks that stay
# canonical and the gates' pass of every attention block on K6. The low
# `canonical` runs the branch's modules: no kernel.
BUCKET_LAUNCHES = {
    ("low", "canonical"): {},
    ("low", "chain"): {"lightweight_chain": K1_LAUNCHES},
    ("medium", "canonical"): {},
    ("medium", "tail_chain"): {"medium_tail_chain": K3_LAUNCHES},
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
TRAINING_PATH_KERNELS = ("lightweight_chain", "cbam_gate")
# The joint trainer's path: the soft step and the soft validation blend
# through K5 and run K2 in the high branch; the validation's low branch is K1.
JOINT_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "blend3")
# The autograd Functions of K5 and K2' at their main-path shapes: K5 in the
# soft joint step (the branches return f32, so fp32 is the step's dtype),
# K2' at the high tail's shape. Forward against the fp32 plain version,
# gradients against plain autograd of the plain version in the same dtype,
# in units of each result's largest magnitude.
GRAD_FUNCTION_SHAPES = {"blend3": (BATCH, SIZE, SIZE, 3), "spatial_gate": (BATCH, SIZE, SIZE, 96)}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# The training phase's corpus: per intensity 48 train images (3 steps of 16)
# and 16 val images (one validation batch).
TRAIN_PER_CLASS = 64
TRAIN_SPLITS = {"train": 0.75, "val": 0.25}
# K2's autograd Function vs the plain version on the same inputs, in units
# of each result's largest magnitude: its forward (the kernel) against the
# plain version in fp32, and its gradients against plain autograd of the
# plain version in the same dtype (its backward recomputes that plain
# version, so these read 0 unless a library pass sums in another order). The
# bounds are the port's fp32 and bf16 ones.
K2_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# One fp32 train step (TF32 off), card vs CPU: the loss, relative. The
# gradients are held against the same step in float64 on the CPU, twice:
# - per tensor, in units of its own largest magnitude: the card's error
#   within STEP_GRAD_K times the CPU's fp32 error on that tensor, or within
#   STEP_GRAD_FLOOR where that is larger. fp32 itself is far from float64 on
#   some tensors at the default widths, 64^2, batch 2 (`chip_profile.py
#   grads`; NVIDIA H100 80GB HBM3, 700.00 W): up to 5.8e-2 on the CPU
#   (the high branch's decoder.0.3.conv1 weight), 5.4e-2 on the card with
#   cuDNN off, 3.8e-2 with cuDNN's default algorithms on a tensor where the
#   CPU reads 1.0e-3 (decoder.1.3.conv1). The floor is under twice the
#   largest; a gradient with its sign flipped reads 2;
# - all together, in units of the branch's largest gradient: within
#   STEP_GRAD_RTOL, or twice the CPU's own error where that is larger (the
#   medium branch's CPU reads 2.2e-3 there, the card 1.0e-3 to 1.5e-3).
# A gradient that is 0 in exact arithmetic (a bias before a train-mode BN:
# float64 max below ZERO_GRAD of the branch's largest) has no scale of its
# own and is held only by the second.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_K = 4.0
STEP_GRAD_FLOOR = 1e-1
STEP_GRAD_RTOL = 1e-3
ZERO_GRAD = 1e-6


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
        weights = weights._replace(trunk=weights.trunk._replace(packed=(), head_group=None),
                                   guidance2_packed=None)
    else:
        weights = weights._replace(packed=())
        if hasattr(weights, "head_group"):
            weights = weights._replace(head_group=None)
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
    return smi


def phase_build():
    t0 = time.perf_counter()
    path, nvcc_s, nvcc_log = _build.build()
    _build.library()
    log(f"[build] {path}: nvcc {nvcc_s:.1f} s, build and load "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    coco_eval.native_library()
    log(f"[build] the COCO matcher (native/coco_match.cpp, g++): {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    return nvcc_s


def phase_kernels(dev, gen):
    results = {"lightweight_chain": check_k1(dev, gen, SIZE),
               "cbam_gate": check_k2(dev, gen, SIZE)}

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
    results["spatial_gate"] = check_k2_prime(dev, gen, SIZE)

    # Its own generator: the draws of the other phases, and with them the
    # router's weights and where it routes the batch, stay as they were.
    conv_layers = phase_conv_layers(dev, torch.Generator().manual_seed(SEED + 1))
    results.update(phase_tail_kernels(dev, gen))
    results["res_attn_chain"] = phase_res_chain_kernels(dev, gen)
    results["probe_ops"] = phase_probe_kernels(dev)
    return results, conv_layers


def check_k1(dev, gen, size, tag=""):
    """K1 at (16, size, size, 3), c=32, 3 residual blocks: fp32 and bf16
    against the fp32 plain version, the fused bf16 body against the bf16
    plain version at c=32 and c=48 (alpha 1); times and bound."""
    low = perturb_bn_(init_params_(LightweightDehazeModel(32, 3), gen), gen).eval()
    x = torch.rand(BATCH, size, size, 3, generator=gen).to(dev)
    c32 = fold_lightweight(low.to(dev), torch.float32)
    cbf = fold_lightweight(low, torch.bfloat16)
    with torch.inference_mode():
        ref = lightweight_chain_reference(x, c32)
        e32 = max_err(lightweight_chain(x, c32), ref)
        ebf = max_err(lightweight_chain(x, cbf), ref)
        ms = cuda_ms(lambda: lightweight_chain(x, cbf))
        plain = cuda_ms(lambda: lightweight_chain_reference(x, cbf))
    plan = chain_plan(32, 3, torch.bfloat16)
    log(f"[{tag}K1 lightweight_chain] {tuple(x.shape)} c=32: fp32 err {e32:.3e}, "
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
    log(f"[{tag}K1 lightweight_chain] bf16 vs bf16 plain, alpha 1: c=32 err {tight[32]:.3e}, "
        f"c=48 err {tight[48]:.3e} (bound {K1_BF16_ATOL})")
    check(max(tight.values()) <= K1_BF16_ATOL,
          "K1's fused wgmma body disagrees with the bf16 plain version")
    px = x.numel() // 3
    k1_flops = sum(conv_flops(px, 9, w.shape[2], w.shape[3]) for w, _ in cbf.layers)
    return dict(
        max_abs_err=max(tight.values()), max_abs_err_bf16_vs_fp32=ebf,
        max_abs_err_fp32=e32, ms=ms, plain_ms=plain, library_ms=None,
        shape=list(x.shape),
        **bound(k1_flops, 2 * nbytes(x) + nbytes(*weight_tensors(cbf.layers)),
                PEAK_BF16_FLOPS))


def check_k2(dev, gen, size, tag="", shapes=None, branch="high-branch"):
    """K2 at every AttentionBlock shape of a high branch on size^2 images
    (`shapes`: shape -> calls per branch call; the canonical high branch's
    by default); ms per branch call = the sum over its blocks."""
    shapes = shapes or k2_shapes(size)
    blocks = sum(shapes.values())
    tot = dict(ms=0.0, plain_ms=0.0, kernel_only_ms=0.0, maps_ms=0.0, maps_plain_ms=0.0)
    k2_bytes = k2_flops = 0
    errs, errs32, errs_maps, done = [], [], [], []
    for shape, calls in shapes.items():
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
        log(f"[{tag}K2 cbam_gate] {shape}: fp32 err {e32:.3e}, bf16 err {ebf:.3e}, maps err "
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
        done.append(list(shape))
        tot["ms"] += calls * ms
        tot["plain_ms"] += calls * plain
        tot["kernel_only_ms"] += calls * kernel_only
        # x read and the result written once, the gate and the stencil read;
        # per element two multiplies and the (mean, max) reduction.
        k2_bytes += calls * (2 * nbytes(xb) + nbytes(g, wb))
        k2_flops += calls * (4 * xb.numel() + conv_flops(xb.numel() // shape[3], 49, 2, 1))
        del x, ref, out, mean_p, max_p, xb
    per = f"{branch} call ({blocks} blocks)"
    log(f"[{tag}K2 cbam_gate] per {per}: wrapper {tot['ms']:.3f} ms "
        f"(statistics pass {tot['maps_ms']:.3f} ms, gate kernel {tot['kernel_only_ms']:.3f} "
        f"ms), plain {tot['plain_ms']:.3f} ms")
    return dict(max_abs_err=max(errs), max_abs_err_fp32=max(errs32),
                max_abs_err_maps=max(errs_maps), shapes=done, per=per, library_ms=None,
                **bound(k2_flops, k2_bytes, PEAK_F32_FLOPS), **tot)


def check_k2_prime(dev, gen, size, tag=""):
    """K2' at the high tail's shape on size^2 images, where K4 launches it."""
    shape = (BATCH, size, size, 96)
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
    log(f"[{tag}K2' spatial_gate] {shape}: fp32 err {e32:.3e}, bf16 err {ebf:.3e}, maps err "
        f"{emaps:.3e}; bf16 wrapper {ms:.3f} ms (statistics pass {maps:.3f} ms, its plain "
        f"version {maps_plain:.3f} ms; gate kernel alone {kernel_only:.3f} ms, "
        f"{2 * nbytes(xb) / (kernel_only * 1e-3) / 1e9:.0f} GB/s of x read+write), "
        f"plain {plain:.3f} ms")
    check(e32 <= FP32_ATOL and ebf <= BF16_ATOL, "K2' disagrees with its plain version")
    check(emaps <= MAPS_ATOL, "K2''s statistics pass disagrees with padded_stats")
    return dict(
        max_abs_err=ebf, max_abs_err_fp32=e32, max_abs_err_maps=emaps, ms=ms, plain_ms=plain,
        kernel_only_ms=kernel_only, maps_ms=maps, maps_plain_ms=maps_plain,
        library_ms=None, shape=list(shape),
        **bound(3 * xb.numel() + conv_flops(xb.numel() // 96, 49, 2, 1),
                2 * nbytes(xb) + nbytes(wb), PEAK_F32_FLOPS))


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
        resident = _build.library().conv_tile_blocks_per_sm(cout, ksize)
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
            f"stage, {plan.stages} slots, {plan.smem_bytes} B of shared memory, planned for "
            f"{plan.blocks_per_sm} blocks an SM, {resident} by the occupancy API: err "
            f"{err:.3e} of max|plain| (bound {CONV_BF16_RTOL:.3e}), the library call against "
            f"plain {lib_err:.3e}; kernel {ms:.3f} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
            f"TFLOP/s), bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} "
            f"({flops / 1e9:.1f} GFLOP, {moved / 1e6:.0f} MB), library {lib_ms:.3f} ms "
            f"({flops / (lib_ms * 1e-3) / 1e12:.1f} TFLOP/s)")
        check(plan.body == "wgmma" and plan.smem_bytes <= 232448,
              f"conv layer {name} does not take the wgmma body: {plan}")
        check(resident >= 1, f"conv layer {name}: the occupancy API read {resident}")
        check(err <= CONV_BF16_RTOL, f"conv layer {name} disagrees with its plain version")
        check(lib_err <= BF16_ATOL, f"conv layer {name}: the library call computes another function")
        rows[name] = dict(body=plan.body, cout_chunk=plan.cout_chunk, tile=list(plan.tile),
                          kc=plan.kc, stages=plan.stages, smem_bytes=plan.smem_bytes,
                          blocks_per_sm_planned=plan.blocks_per_sm, blocks_per_sm=resident,
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


def phase_tail_kernels(dev, gen, size=SIZE, tag=""):
    """K3 and K4 alone at the main path's shapes on size^2 images: d1 (16,
    size/2, size/2, 4c) and f0 (16, size, size, c) drawn non-negative like
    the real decoder state."""
    results = {}
    for name, label, cls, c, fold_fn, tail, reference, n_launch in (
            ("medium_tail_chain", "K3", MediumIntensityDehazeModel, 64, fold_medium_tail,
             medium_tail_chain, medium_tail_chain_reference, K3_LAUNCHES[torch.bfloat16]),
            ("high_tail_chain", "K4", HighIntensityDehazeModel, 96, fold_high_tail,
             high_tail_chain, high_tail_chain_reference, HIGH_TAIL_LAUNCHES)):
        high = name == "high_tail_chain"
        model = perturb_bn_(init_params_(cls(c), gen), gen).eval().to(dev)
        d1 = torch.relu(torch.randn(BATCH, size // 2, size // 2, 4 * c, generator=gen)).to(dev)
        f0 = torch.relu(torch.randn(BATCH, size, size, c, generator=gen)).to(dev)
        x = torch.rand(BATCH, size, size, 3, generator=gen).to(dev)
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
        flops = tail_flops(BATCH, size, size, c, high)
        moved = nbytes(d1b, f0b, x, got) + weights_nbytes(wbf)
        bd = bound(flops, moved, PEAK_BF16_FLOPS)
        if not high:
            plan = medium_tail_plan(c, torch.bfloat16)
            log(f"[{tag}{label} {name}] bf16 plan: head {plan.head}, tile {plan.tile}, "
                f"{plan.smem_bytes} B of shared memory a block, {plan.launches} launches")
            check(plan.head == "group", "K3's head did not take the fused group")
        log(f"[{tag}{label} {name}] d1 {tuple(d1.shape)}, f0 {tuple(f0.shape)}, c={c}: fp32 err "
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


def phase_res_chain_kernels(dev, gen, size=SIZE, tag=""):
    """K6 alone at the six main-path segments on size^2 images, batch 16,
    inputs drawn non-negative like the activation after a ConvBlock.
    Returns the sums over the six segments and each segment's readings."""
    segments = {}
    for name, (c, down, kinds) in RES_SEGMENTS.items():
        blocks = torch.nn.Sequential(*[ResidualBlock(c) if k == "res" else AttentionBlock(c)
                                       for k in kinds])
        blocks = perturb_bn_(init_params_(blocks, gen), gen).eval().to(dev)
        side = size // down
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
        log(f"[{tag}K6 res_attn_chain] {name} {tuple(x.shape)} {list(kinds)}: errors in units of "
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
        log(f"[{tag}K6 res_attn_chain] the {level} branch's three segments: bf16 kernel "
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


def time_slice(d, x, labels, tag):
    """Warm ms/image of route_hard (the classifier's labels), of the engine
    on the forced labels (numpy in and out, as route_hard) and of soft
    routing; host clock around a synchronize, 3 runs each."""
    def run_hard():
        d.route_hard(x)
        torch.cuda.synchronize()

    def run_forced():
        with torch.inference_mode():
            y, _ = d.engine(torch.from_numpy(x).to(d.device), intensity=labels)
            y.cpu().numpy()
        torch.cuda.synchronize()

    def run_soft():
        d(x)
        torch.cuda.synchronize()

    means = {}
    for name, fn in (("route_hard", run_hard), ("forced_labels", run_forced),
                     ("soft", run_soft)):
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


def dispatch_cost_ms(d, dev, gen, tag):
    """What one more bucket costs the engine: the part of a branch call
    that does not grow with its rows. Every branch apply of dehazer `d` is
    timed warm at every bucket size (host clock around a synchronize, the
    least of 5 runs); the intercept of the least-squares line through (rows,
    ms) is that branch's fixed cost, printed beside the constant the chunk
    planner is fed for it under autotune. Returns {level: intercept}."""
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
        log(f"[dispatch {tag}] {level}: ms at {list(eng.buckets)} rows "
            f"{[round(v, 3) for v in ms]}: {slope:.4f} ms/row, fixed {fixed[level]:.4f} ms "
            f"({fixed[level] / slope:.2f} rows; bf16, {SIZE}^2); the "
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
    return (main, outs, time_slice(d, x, labels, "slice"),
            dispatch_cost_ms(d, dev, gen, "default"), d)


def chunks(labels, b):
    """The device-binned engine's chunks of each class for these labels."""
    return [-(-int((labels == c).sum()) // b) for c in range(3)]


def first_line(err):
    return str(err).strip().splitlines()[0]


def syncs_under_debug_mode(fn):
    """Run fn() with torch.cuda.set_sync_debug_mode("error"): None if no op
    of it synchronizes, else the error's first line. The mode is restored."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as err:
        return first_line(err)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return None


def drain(results):
    """Consume an iterator, dropping each item as it comes."""
    collections.deque(results, maxlen=0)


def route_ms(run, n_images):
    """Warm ms/image of run(): one warm-up, then 3 runs, host clock around a
    synchronize."""
    run()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n_images)
    return float(np.mean(times)), min(times), max(times)


def phase_engines(d, dev, x, labels, forced_ref, smi):
    """The serving engines and routes on phase 4's dehazer (default
    dispatch): forced labels through every engine, the product routes, the
    binning under the sync debug mode, and the routes' ms/image. Returns the
    launch counters of the checked runs, the errors and the times."""
    k1 = K1_LAUNCHES[torch.bfloat16]
    eng = d.engine
    xd = torch.from_numpy(x).to(dev)
    n = BATCH
    reps = 3
    want = {"lightweight_chain": 0, "cbam_gate": 0}

    def expect(low, high):
        want["lightweight_chain"] += k1 * low
        want["cbam_gate"] += 6 * high

    errs = {}

    def agree(name, y, ref):
        y = y.float().cpu().numpy() if isinstance(y, torch.Tensor) else y
        check_images(y, ref.shape[0], name)
        errs[name] = max(errs.get(name, 0.0), float(np.abs(y - ref).max()))

    reset_launch_counts()
    with torch.inference_mode():
        per_class = buckets_per_class(eng, labels)
        streamed = list(eng.run_stream([xd] * reps, intensities=[labels] * reps))
        check(len(streamed) == reps, f"run_stream yielded {len(streamed)} batches")
        for y, lab in streamed:
            check(np.array_equal(lab, labels), f"run_stream labels {lab}")
            agree("run_stream", y, forced_ref)
        expect(reps * per_class[0], reps * per_class[2])

        served = np.zeros(reps * n, np.int32)
        for y, gidx, cls in eng.run_queued([xd] * reps, intensities=[labels] * reps):
            check(bool((labels[gidx % n] == cls).all()), f"run_queued class {cls} for {gidx}")
            agree("run_queued", y, forced_ref[gidx % n])
            served[gidx] += 1
            expect(int(cls == 0), int(cls == 2))
        check(bool((served == 1).all()), f"run_queued served the images {served.tolist()} times")

        for spill in (False, True):
            fn = d._device_binned_fn(16, spill)
            for _ in range(reps):
                y, lab, logits = fn(xd, labels)
                check(np.array_equal(lab.cpu().numpy(), labels), "device-binned labels")
                agree(f"device_binned spill={spill}", y, forced_ref)
            low, _, high = chunks(labels, min(16, n))
            expect(reps * low, reps * high)
        torch.cuda.synchronize()
        forced = nonzero(counts())
        log(f"[engines] forced labels {labels.tolist()} x {reps} batches: launches {forced} "
            f"(K1 {k1} a low chunk, K2 6 a high chunk: {nonzero(want)}); largest error "
            f"against phase 4's forced-label engine: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {BF16_ATOL})")
        check(forced == nonzero(want), f"engine launches {forced}, expected {nonzero(want)}")
        check(all(v <= BF16_ATOL for v in errs.values()), f"an engine disagrees: {errs}")

        # The product routes: labels are route_hard's on the same batches.
        ragged = [x[:16], x[:5], x[:16], x[5:16]]
        ref = [d.route_hard(b) for b in ragged]
        top2 = torch.topk(eng.classifier_apply(xd)[0].float(), 2, dim=1).values
        log(f"[routes] route_hard labels per ragged batch "
            f"{[np.bincount(r[1], minlength=3).tolist() for r in ref]}; smallest top-2 "
            f"logit margin {float((top2[:, 0] - top2[:, 1]).min()):.3e}")
        # route_device_binned_stream classifies each batch padded with its
        # last image to STREAM_BUCKETS: its reference is route_hard on that
        # padded batch (a bf16 logit margin can be one step, and the convs'
        # sums follow the batch size).
        padded = [np.concatenate([b, np.repeat(b[-1:], d._bucket_batch(
            b.shape[0], d.STREAM_BUCKETS) - b.shape[0], axis=0)]) for b in ragged]
        ref_padded = [d.route_hard(p)[1][:b.shape[0]] for p, b in zip(padded, ragged)]
        for name, got, want_labels in (
                ("route_hard_stream", list(d.route_hard_stream(ragged)), [r[1] for r in ref]),
                ("route_device_binned_stream", list(d.route_device_binned_stream(ragged)),
                 ref_padded)):
            check(len(got) == len(ragged), f"{name} yielded {len(got)} batches")
            for (y, lab), want_lab, b in zip(got, want_labels, ragged):
                check_images(y, b.shape[0], name)
                check(np.array_equal(lab, want_lab), f"{name} labels {lab} vs {want_lab}")
        ref_labels = np.concatenate([r[1] for r in ref])
        served = np.zeros(ref_labels.size, np.int32)
        for y, gidx, cls in d.route_hard_queued(ragged):
            check_images(y.cpu().numpy(), gidx.size, "route_hard_queued")
            check(bool((ref_labels[gidx] == cls).all()), f"route_hard_queued class {cls}")
            served[gidx] += 1
        check(bool((served == 1).all()), "route_hard_queued: an image not served once")
        _, hard_lab = ref[0]
        for name, (y, lab) in (("route_device_binned", d.route_device_binned(x)),
                               ("route_switch", d.route_switch(x)),
                               ("route_sharded", d.route_sharded(x))):
            check_images(y, n, name)
            check(np.array_equal(lab, hard_lab), f"{name} labels {lab} vs {hard_lab}")
        soft = make_adaptive_infer(eng.classifier_apply, eng.branch_applies, "soft",
                                   temperature=d.router.temperature)
        before = counts()
        y, _ = soft(xd)
        check_images(y.cpu().numpy(), n, "make_adaptive_infer soft")
        check(delta(before)["blend3"] == 1, f"soft infer launched {nonzero(delta(before))}")
        log("[routes] route_hard_stream, route_hard_queued, route_device_binned, "
            "route_device_binned_stream (ragged 16, 5, 16, 11), route_switch, route_sharded: "
            "labels equal route_hard's, outputs finite in [0, 1]; soft infer: K5 once")

        # No hidden sync: the classifier and the binning, up to the one read.
        fns = [d._device_binned_fn(16, spill) for spill in (False, True)]
        binned = []
        sync = syncs_under_debug_mode(lambda: binned.extend(
            [fns[0].bin(xd), fns[0].bin(xd, labels), fns[1].bin(xd, labels)]))
        log(f"[sync] device-binned classifier and binning (predicted, forced, forced with "
            f"spill) under set_sync_debug_mode('error'): {sync or 'no sync'}")
        check(sync is None, f"the device binning synchronizes: {sync}")
        for fn, b in zip((fns[0], fns[0], fns[1]), binned):
            fn.serve(b)
        torch.cuda.synchronize()
        main = counts()

        for level, apply in zip(INTENSITY_ORDER, eng.branch_applies):
            sync = syncs_under_debug_mode(lambda apply=apply: apply(xd))
            log(f"[sync] branch apply {level}: {sync or 'no sync'} (a reading)")

    # The stream routes' consumer drops each result as it comes, as a server
    # that sends it on; "results kept" holds all 8 (fresh pageable pages for
    # every numpy fetch of route_hard_stream).
    times = {"route_hard": route_ms(lambda: d.route_hard(x), n)}
    stream = [x] * 8
    for name, run, images in (
            ("route_hard_stream", lambda: drain(d.route_hard_stream(stream)), 8 * n),
            ("route_hard_stream, results kept", lambda: list(d.route_hard_stream(stream)),
             8 * n),
            ("route_hard_queued", lambda: drain(d.route_hard_queued(stream)), 8 * n),
            ("route_device_binned", lambda: d.route_device_binned(x), n),
            ("route_device_binned_stream", lambda: drain(d.route_device_binned_stream(stream)),
             8 * n),
            ("route_device_binned_stream, results kept",
             lambda: list(d.route_device_binned_stream(stream)), 8 * n),
            ("route_switch", lambda: d.route_switch(x), n),
            ("route_sharded", lambda: d.route_sharded(x), n)):
        times[name] = route_ms(run, images)
    for name, (mean, lo, hi) in times.items():
        log(f"[routes] {name}: {mean:.3f} ms/image warm (min {lo:.3f}, max {hi:.3f}; 3 runs "
            f"of {n} images at {SIZE}^2{', 8 batches' if 'stream' in name or 'queued' in name else ''}"
            f", bf16, default dispatch; route_hard {times['route_hard'][0]:.3f}; {smi})")
    return main, errs, {k: v[0] for k, v in times.items()}


def tune_then_force(router, cfg, dev, tmp, tag, dispatches, gen=None):
    """A dehazer with autotune on and a fresh cache times every candidate
    and prints the tables; returns, for each forced dispatch (level ->
    candidate), the path of a copy of that cache whose winners are set to
    it, the tables, and (with `gen`) what one more bucket of each tuned
    winner costs (`dispatch_cost_ms`), else None."""
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
    # The low `canonical` is the branch's module path: no kernel launch.
    reset_launch_counts()
    with torch.inference_mode():
        candidate_builders(d.router.models["low"], d.dtype)["canonical"]()(
            torch.rand(2, SIZE, SIZE, 3, device=dev))
    torch.cuda.synchronize()
    check(not nonzero(counts()), f"the low canonical candidate launched {nonzero(counts())}")
    dispatch = dispatch_cost_ms(d, dev, gen, f"tuned {tag}") if gen is not None else None
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
    return paths, tables, dispatch


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
    return main, time_slice(d, x, labels, tag)


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
    (tail_cache, res_cache), _, _ = tune_then_force(router, cfg, dev, tmp, "fp32",
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
    return tail_cache, res_cache


def phase_gate_grad(dev, gen):
    """K2's autograd Function at the six AttentionBlock shapes: its forward
    against the fp32 plain version, its gradients against plain autograd of
    the plain version on the same inputs in the same dtype (and, as a
    reading, the bf16 ones against the fp32 plain version), and the bf16
    forward and backward time of one high train step's six blocks."""
    fwd_ms = bwd_ms = 0.0
    worst, worst_y, vs_fp32 = {}, {}, 0.0
    for shape, n_blocks in K2_SHAPES.items():
        b, _, _, c = shape
        base = (torch.randn(shape, generator=gen), torch.rand(b, c, generator=gen),
                torch.randn(7, 7, 2, 1, generator=gen) * 0.1)
        dy = torch.randn(shape, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            dyd = dy.to(dev, dtype)
            ref_in = [t.to(dev, dtype).requires_grad_(True) for t in base]
            want = torch.autograd.grad(channel_spatial_gate_reference(*ref_in), ref_in, dyd)
            ours = [t.to(dev, dtype).requires_grad_(True) for t in base]
            y = channel_spatial_gate(*ours)
            got = torch.autograd.grad(y, ours, dyd, retain_graph=True)
            with torch.no_grad():
                y_ref = channel_spatial_gate_reference(*(t.float() for t in ours))
            torch.cuda.synchronize()
            err_y = max_err(y.detach(), y_ref) / float(y_ref.abs().max())
            errs = [max_err(a, b) / float(b.float().abs().max()) for a, b in zip(got, want)]
            worst[dtype] = max(worst.get(dtype, 0.0), *errs)
            worst_y[dtype] = max(worst_y.get(dtype, 0.0), err_y)
            note = ""
            if dtype == torch.bfloat16:
                errs32 = [max_err(a, b) / float(b.float().abs().max())
                          for a, b in zip(got, fp32_want)]
                vs_fp32 = max(vs_fp32, *errs32)
                note = (f"; against the fp32 plain version {', '.join(f'{e:.2e}' for e in errs32)}"
                        " (a reading: bf16 rounding can move a pixel's channel max)")
            log(f"[train K2 grad] {shape} {str(dtype)[6:]}: forward err {err_y:.2e} of max|y| "
                f"against the fp32 plain version; (dx, dg, dw) err "
                f"{', '.join(f'{e:.2e}' for e in errs)} of max|grad| (bound "
                f"{K2_GRAD_TOL[dtype]}){note}")
            check(err_y <= K2_GRAD_TOL[dtype],
                  f"K2's Function forward at {shape} {dtype} disagrees with the plain version")
            check(max(errs) <= K2_GRAD_TOL[dtype],
                  f"K2's Function gradient at {shape} {dtype} disagrees with plain autograd")
            if dtype == torch.bfloat16:
                fwd_ms += n_blocks * cuda_ms(lambda: channel_spatial_gate(*ours))
                bwd_ms += n_blocks * cuda_ms(
                    lambda: torch.autograd.grad(y, ours, dyd, retain_graph=True))
            else:
                fp32_want = want
            del y, y_ref, got, ref_in
        del fp32_want, want
    log(f"[train K2] the high branch's six AttentionBlocks, bf16, batch {BATCH}: K2 forward "
        f"{fwd_ms:.3f} ms + backward (autograd of the plain version) {bwd_ms:.3f} ms per "
        "train step")
    torch.cuda.empty_cache()
    return dict(forward_ms=fwd_ms, backward_ms=bwd_ms, bf16_vs_fp32_plain=vs_fp32,
                grad_err={str(k)[6:]: v for k, v in worst.items()},
                forward_err={str(k)[6:]: v for k, v in worst_y.items()})


def fp32_step_batch():
    """The fixed inputs of the fp32 step checks: 2 images at 64^2."""
    rng = np.random.default_rng(SEED + 5)
    return {k: torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
            for k in ("hazy", "clear")}


def fp32_step(level, cfg, loss, batch, device, dtype, capture=None):
    """One train step (augmentation off) of the freshly initialised `level`
    branch in `dtype` on `device`: (total loss, {parameter: gradient as
    float64 on the CPU}, the module). With a dict `capture`, each Conv2d's
    input and output gradient go into it under the module's name."""
    model = td.init_branch(level, cfg, device).train().to(dtype)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4))
    nets = {k: v.to(dtype) for k, v in
            loss.init(torch.Generator().manual_seed(0), device).items()}

    def keep(name):
        def hook(module, inputs, out):
            capture[name] = [inputs[0].detach()]
            out.register_hook(lambda dy: capture[name].append(dy.detach()))
        return hook

    hooks = [] if capture is None else [
        m.register_forward_hook(keep(n)) for n, m in model.named_modules()
        if type(m) is torch.nn.Conv2d]
    comps = td.make_train_step(loss, nets, augmentation=False)(
        state, {k: v.to(device, dtype) for k, v in batch.items()})
    for h in hooks:
        h.remove()
    return (float(comps["total"]),
            {n: p.grad.double().cpu() for n, p in model.named_parameters()}, model)


def fp32_joint_step(cfg, loss, batch, device, dtype):
    """One soft joint step (augmentation and dropout off) of the seeded
    default router in `dtype` on `device`: (total loss, {trainable
    parameter: gradient as float64 on the CPU})."""
    router, state = tj.build_router_state(cfg, device)
    for m in router.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    router.train().to(dtype)
    nets = {k: v.to(dtype) for k, v in
            loss.init(torch.Generator().manual_seed(0), device).items()}
    comps = tj.make_train_step(loss, nets, augmentation=False)(
        state, {k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
                for k, v in batch.items()})
    return (float(comps["total"]),
            {n: p.grad.double().cpu() for n, p in router.named_parameters()
             if p.grad is not None})


def per_tensor_errs(grads, g64):
    """Each gradient's error against float64 in units of its own largest
    magnitude, over the tensors whose float64 gradient is not 0 in exact
    arithmetic; and the largest error of all in units of the branch's
    largest gradient."""
    g_max = max(float(g.abs().max()) for g in g64.values())
    live = {n: float(g.abs().max()) for n, g in g64.items()
            if float(g.abs().max()) > ZERO_GRAD * g_max}
    errs = {n: max_err(grads[n], g64[n]) / scale for n, scale in live.items()}
    return errs, max(max_err(grads[n], g) for n, g in g64.items()) / g_max


def phase_train_step_vs_cpu(dev):
    """One fp32 train step of each default branch, and one fp32 soft joint
    step of the default router (dropout off), on the card and on the CPU,
    both held against the same step in float64 on the CPU."""
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    cfg["classifier"]["checkpoint_dir"] = cfg["dehazing"]["checkpoint_dir"] = "absent"
    batch = fp32_step_batch()
    loss = get_dehazing_loss(cfg)
    joint_loss = get_joint_loss(cfg)
    errs = {}
    for level in INTENSITY_ORDER + ("joint",):
        if level == "joint":
            jbatch = {**batch, "intensity": torch.tensor([2, 0])}
            (l_cpu, g_cpu), (l64, g64), (l_card, g_card) = (
                fp32_joint_step(cfg, joint_loss, jbatch, device, dtype)
                for device, dtype in (("cpu", torch.float32), ("cpu", torch.float64),
                                      (dev, torch.float32)))
        else:
            (l_cpu, g_cpu, _), (l64, g64, _), (l_card, g_card, _) = (
                fp32_step(level, cfg, loss, batch, device, dtype)
                for device, dtype in (("cpu", torch.float32), ("cpu", torch.float64),
                                      (dev, torch.float32)))
        cpu, cpu_all = per_tensor_errs(g_cpu, g64)
        card, card_all = per_tensor_errs(g_card, g64)
        # The card's error over its bound, per tensor: at most 1 passes.
        over = {n: e / max(STEP_GRAD_K * cpu[n], STEP_GRAD_FLOOR) for n, e in card.items()}
        tight = max(over, key=over.get)
        worst = {tag: max(r, key=r.get) for tag, r in (("card", card), ("cpu", cpu))}
        bound_all = max(STEP_GRAD_RTOL, 2 * cpu_all)
        loss_err = abs(l_card - l_cpu) / abs(l_cpu)
        errs[level] = dict(loss_rel=loss_err, loss_f64_rel=abs(l_card - l64) / abs(l64),
                           card_vs_f64=card_all, cpu_vs_f64=cpu_all, bound=bound_all,
                           per_tensor=dict(card=card[worst["card"]], cpu=cpu[worst["cpu"]],
                                           tightest=tight, of_bound=over[tight]))
        log(f"[train fp32 step] {level}: loss CPU {l_cpu:.7f}, card {l_card:.7f}, float64 "
            f"{l64:.7f} (card vs CPU rel err {loss_err:.2e}, bound {STEP_LOSS_RTOL}); "
            f"gradients against float64 in units of the branch's max|g|: card "
            f"{card_all:.2e}, CPU {cpu_all:.2e} (bound {bound_all:.2e}); {len(card)} of "
            f"{len(g64)} per tensor, in units of its own max|g|: card at most "
            f"{card[worst['card']]:.2e} ({worst['card']}; the CPU's fp32 "
            f"{cpu[worst['card']]:.2e} there), CPU at most {cpu[worst['cpu']]:.2e} "
            f"({worst['cpu']}); closest to its bound (the larger of {STEP_GRAD_K:g} x the "
            f"CPU's error and {STEP_GRAD_FLOOR:g}): {tight}, {over[tight]:.2f} of it")
        check(loss_err <= STEP_LOSS_RTOL, f"the fp32 {level} train step's loss: card vs CPU")
        check(card_all <= bound_all, f"the fp32 {level} train step's gradients: card vs float64")
        check(over[tight] <= 1.0,
              f"the fp32 {level} train step's gradient of {tight}: card vs float64")
    return errs


class StepProbe:
    """Wraps a trainer's step makers. Per step kind (a name, or a function
    of the state): the steps taken and the step count each run started
    from, every loss component finite, the warm step times (synchronized),
    the peak memory, and the kernels' launches per step and per eval
    batch; `on_first(state)` after a kind's first step."""

    def __init__(self):
        self.run = 0
        self.rec = collections.defaultdict(lambda: dict(
            steps=0, warm_ms=[], peak=0, by_run=collections.Counter(), start_step={},
            launches=[]))

    def wrap(self, make, kind, eval_step=False, on_first=None):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)

            def probed(state, batch, *rest):
                tag = kind(state) if callable(kind) else kind
                rec = self.rec[tag]
                before = counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = step(state, batch, *rest)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                rec["launches"].append(nonzero(delta(before)))
                rec["peak"] = max(rec["peak"], torch.cuda.max_memory_allocated())
                if not eval_step:
                    check(all(bool(torch.isfinite(v)) for v in out.values()),
                          f"{tag}: a loss component is not finite: {out}")
                    if on_first is not None and rec["steps"] == 0:
                        on_first(state)
                    if rec["by_run"][self.run]:
                        rec["warm_ms"].append(ms)
                    else:
                        rec["start_step"][self.run] = state.step - 1
                    rec["by_run"][self.run] += 1
                rec["steps"] += 1
                return out
            return probed
        return made


def launch_sum(rec):
    """A probed kind's kernel launches over all its steps."""
    return sum((collections.Counter(launches) for launches in rec["launches"]),
               collections.Counter())


def warm_reading(rec, images=BATCH):
    ms = float(np.median(rec["warm_ms"]))
    return dict(ms_per_step=ms, images_per_s=images / ms * 1e3,
                peak_gib=rec["peak"] / 2 ** 30, warm_ms=rec["warm_ms"], steps=rec["steps"])


def phase_training(dev, smi, tmp):
    """The trainer at the default widths, bf16 (see phase 10 above).
    Returns the training path's launch counts and the readings."""
    root = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    n = generate_synthetic_dataset(root, n_per_class=TRAIN_PER_CLASS, size=SIZE, seed=SEED,
                                   splits=TRAIN_SPLITS)
    log(f"[training] corpus: {n} triplets at {SIZE}^2 in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated on the card before "
        "the trainer (earlier phases)")
    cfg = load_config()     # default widths, bf16
    cfg["dataset"].update(train_path=root, val_path=root, test_path=root)
    cfg["dehazing"].update(epochs=1, checkpoint_dir=os.path.join(tmp, "checkpoints"))
    cfg["_logs_dir"] = os.path.join(tmp, "logs")
    resumed_cfg = copy.deepcopy(cfg)
    resumed_cfg["dehazing"]["epochs"] = 2

    def branch(state):
        return CLASS_OF[type(state.module).__name__]

    def first_gradients(state):
        for name, p in state.module.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  and bool(p.grad.abs().max() > 0),
                  f"after the first step, {name} has no finite non-zero gradient")

    probe = StepProbe()
    makers = td.make_train_step, td.make_eval_step
    td.make_train_step = probe.wrap(makers[0], branch, on_first=first_gradients)
    td.make_eval_step = probe.wrap(makers[1], lambda state: (branch(state), "eval"),
                                   eval_step=True)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        td.train_all_dehazing_models(cfg)
        probe.run = 1
        trained = td.train_all_dehazing_models(resumed_cfg, resume=True)
        path = counts()
        wall = time.perf_counter() - t0
    finally:
        td.make_train_step, td.make_eval_step = makers
    log(f"[training] two trainer runs (1 epoch, then resumed to 2) in {wall:.1f} s; "
        f"launches {nonzero(path)}")

    readings = {}
    loss = get_dehazing_loss(cfg)
    nets = loss.init(torch.Generator().manual_seed(0), dev)
    for level in INTENSITY_ORDER:
        rec, ev, (model, state) = probe.rec[level], probe.rec[(level, "eval")], trained[level]
        train_l, eval_l = launch_sum(rec), launch_sum(ev)
        check(rec["by_run"] == {0: 3, 1: 3} and rec["start_step"] == {0: 0, 1: 3},
              f"{level}: steps {dict(rec['by_run'])} from step {rec['start_step']} in the two "
              "runs; the resumed run should have taken one epoch of 3 from the saved step 3")
        if level == "low":
            check(eval_l["lightweight_chain"] > 0, "the low validation launched no K1")
        k2_train = 6 * rec["steps"] if level == "high" else 0
        k2_eval = 6 * ev["steps"] if level == "high" else 0
        check(train_l["cbam_gate"] == k2_train and eval_l["cbam_gate"] == k2_eval,
              f"{level}: K2 launched {train_l['cbam_gate']} times in training and "
              f"{eval_l['cbam_gate']} in validation, expected {k2_train} and {k2_eval}")
        # The best checkpoint in a fresh module gives the same eval output.
        fresh = TrainState(td.init_branch(level, cfg, dev), None)
        best = ckpt.best_model_path(os.path.join(cfg["dehazing"]["checkpoint_dir"], level))
        fresh.module.load_state_dict(ckpt.load_checkpoint(best)[0]["model"])
        batch = device_batch(next(iter(td.get_intensity_loader(cfg, "val", level))), dev)
        step = td.make_eval_step(loss, nets, torch.bfloat16)
        a, b = step(state, batch), step(fresh, batch)
        reload_err = max_err(a["dehazed"], b["dehazed"])
        check(reload_err == 0.0 and float(a["psnr"]) == float(b["psnr"]),
              f"{level}: best_model reloaded gives another eval output ({reload_err:.2e})")
        ms = float(np.median(rec["warm_ms"]))
        readings[level] = dict(ms_per_step=ms, images_per_s=BATCH / ms * 1e3,
                               peak_gib=rec["peak"] / 2 ** 30, warm_ms=rec["warm_ms"],
                               val_psnr=float(a["psnr"]))
        log(f"[training] {level}: {rec['steps']} steps of {BATCH} at {SIZE}^2 bf16, warm "
            f"{ms:.2f} ms/step (median of {len(rec['warm_ms'])}: "
            f"{', '.join(f'{t:.2f}' for t in rec['warm_ms'])}), {BATCH / ms * 1e3:.1f} "
            f"images/s, peak memory {rec['peak'] / 2 ** 30:.2f} GiB; train launches "
            f"{dict(train_l)}, eval {dict(eval_l)}; best_model reloaded: eval "
            f"output identical, val PSNR {float(a['psnr']):.2f} dB; {smi}")
    for name in TRAINING_PATH_KERNELS:
        check(path[name] > 0, f"the training path launched no {name}")
    return path, readings


def phase_grad_functions(dev, gen):
    """(a) The autograd Functions of K5 and K2' at GRAD_FUNCTION_SHAPES, fp32
    and bf16: the forward launches the kernel once and matches the fp32
    plain version; every gradient matches plain autograd of the plain
    version on the same inputs in the same dtype; the backward launches
    nothing. Times (CUDA events) the Function's forward and backward and
    the plain version's forward and backward, in K5's training dtype (fp32)
    and K2''s serving dtype (bf16)."""
    out = {}
    for name, shape in GRAD_FUNCTION_SHAPES.items():
        fn, ref_fn = (blend3, blend3_reference) if name == "blend3" else (
            spatial_gate, spatial_gate_reference)
        if name == "blend3":
            base = [torch.softmax(torch.randn(shape[0], 3, generator=gen), 1)] + [
                torch.rand(shape, generator=gen) for _ in range(3)]
        else:
            base = [torch.randn(shape, generator=gen),
                    torch.randn(7, 7, 2, 1, generator=gen) * 0.1]
        dy32 = torch.randn(shape, generator=gen)
        rec = {}
        for dtype in (torch.float32, torch.bfloat16):
            # K5's weights stay f32 (the softmax's dtype); its images and
            # K2''s x and w take the dtype.
            args = [t.to(dev) if (name == "blend3" and i == 0) else t.to(dev, dtype)
                    for i, t in enumerate(base)]
            dy = dy32.to(dev, dtype)
            ref = [a.clone().requires_grad_(True) for a in args]
            want = torch.autograd.grad(ref_fn(*ref), ref, dy)
            ours = [a.clone().requires_grad_(True) for a in args]
            before = fn.launches
            y = fn(*ours)
            fwd_launches = fn.launches - before
            got = torch.autograd.grad(y, ours, dy, retain_graph=True)
            torch.cuda.synchronize()
            check(fwd_launches == 1 and fn.launches - before == 1,
                  f"{name}'s Function launched {fn.launches - before} times, expected 1")
            with torch.no_grad():
                y32 = ref_fn(*(a.float() for a in args))
            err_y = max_err(y.detach(), y32) / float(y32.abs().max())
            errs = [max_err(a, b) / float(b.float().abs().max()) for a, b in zip(got, want)]
            check(err_y <= GRAD_TOL[dtype], f"{name}'s Function forward ({dtype}) disagrees "
                  f"with the fp32 plain version: {err_y:.2e}")
            check(max(errs) <= GRAD_TOL[dtype], f"{name}'s Function gradients ({dtype}) "
                  f"disagree with plain autograd: {errs}")
            timed = (name == "blend3") == (dtype == torch.float32)
            if timed:
                rec.update(
                    dtype=str(dtype)[6:], shape=list(shape),
                    forward_ms=cuda_ms(lambda: fn(*ours)),
                    backward_ms=cuda_ms(lambda: torch.autograd.grad(y, ours, dy,
                                                                    retain_graph=True)),
                    plain_forward_backward_ms=cuda_ms(
                        lambda: torch.autograd.grad(ref_fn(*ref), ref, dy)))
            rec[f"forward_err_{str(dtype)[6:]}"] = err_y
            rec[f"grad_err_{str(dtype)[6:]}"] = max(errs)
            log(f"[grad {name}] {shape} {str(dtype)[6:]}: forward err {err_y:.2e} of max|y| "
                f"against the fp32 plain version; gradients err "
                f"{', '.join(f'{e:.2e}' for e in errs)} of max|grad| against plain autograd "
                f"(bound {GRAD_TOL[dtype]})"
                + (f"; Function forward {rec['forward_ms']:.4f} ms, backward "
                   f"{rec['backward_ms']:.4f} ms; plain forward + backward "
                   f"{rec['plain_forward_backward_ms']:.4f} ms" if timed else ""))
            del y, got, want, ref, ours, args, dy, y32
        out[name] = rec
    torch.cuda.empty_cache()
    return out


def phase_classifier_training(dev, smi, tmp, root):
    """(b) The classifier trainer at the default width (resnet18, bf16, 256²,
    batch 16) on the training phase's corpus: 1 epoch, then resumed to 2.
    Returns its launch counts, its readings and its checkpoint directory."""
    cfg = load_config()
    cfg["dataset"].update(train_path=root, val_path=root, test_path=root)
    ck_dir = os.path.join(tmp, "classifier")
    cfg["classifier"].update(epochs=1, checkpoint_dir=ck_dir)
    cfg["_logs_dir"] = os.path.join(tmp, "logs")
    resumed_cfg = copy.deepcopy(cfg)
    resumed_cfg["classifier"]["epochs"] = 2
    probe = StepProbe()
    makers = tc.make_train_step, tc.make_eval_step
    tc.make_train_step = probe.wrap(makers[0], "train")
    tc.make_eval_step = probe.wrap(makers[1], "eval", eval_step=True)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        tc.train_classifier(cfg)
        probe.run = 1
        model, state = tc.train_classifier(resumed_cfg, resume=True)
        path = counts()
        wall = time.perf_counter() - t0
    finally:
        tc.make_train_step, tc.make_eval_step = makers
    rec = probe.rec["train"]
    per_epoch = 3 * TRAIN_PER_CLASS * 3 // 4 // BATCH
    check(rec["by_run"] == {0: per_epoch, 1: per_epoch}
          and rec["start_step"] == {0: 0, 1: per_epoch},
          f"classifier: steps {dict(rec['by_run'])} from step {rec['start_step']}; the "
          f"resumed run should have taken one epoch of {per_epoch} from the saved step")
    # The best checkpoint in a fresh classifier gives the same eval logits.
    fresh = TrainState(tc.init_classifier(cfg, dev), None)
    best = ckpt.load_checkpoint(ckpt.best_model_path(ck_dir))
    fresh.module.load_state_dict(best[0]["model"])
    batch = device_batch(next(iter(get_dataloader(cfg, "val"))), dev)
    step = makers[1](torch.bfloat16)
    a, b = step(state, batch), step(fresh, batch)
    reload_err = max_err(a["pred"], b["pred"]) + abs(float(a["loss"]) - float(b["loss"]))
    check(reload_err == 0.0, "classifier: best_model reloaded gives another eval output")
    val = tc.evaluate_classifier_pass(step, state, get_dataloader(cfg, "val"), dev)
    readings = warm_reading(rec)
    readings.update(val_acc=val["acc"], val_loss=val["loss"], best_epoch=best[1]["epoch"],
                    wall_s=wall)
    log(f"[classifier training] {rec['steps']} steps of {BATCH} at {SIZE}^2 bf16 (resnet18), "
        f"warm {readings['ms_per_step']:.2f} ms/step (median of {len(rec['warm_ms'])}: "
        f"{', '.join(f'{t:.2f}' for t in rec['warm_ms'])}), {readings['images_per_s']:.1f} "
        f"images/s, peak memory {readings['peak_gib']:.2f} GiB; val accuracy "
        f"{val['acc']:.4f} (loss {val['loss']:.4f}; best epoch {best[1]['epoch']:.0f}); "
        f"best_model reloaded: eval output identical; two runs in {wall:.1f} s; launches "
        f"{nonzero(path)}; {smi}")
    return path, readings, ck_dir


def phase_joint_training(dev, smi, tmp, root, classifier_dir, dehazing_dir):
    """(c) The joint trainer at the default widths (soft routing, T = 0.5,
    bf16, 256², batch 16), grafting what the classifier and the per-branch
    trainers saved: 2 epochs, soft then hard (hard_finetune_frac 0.5); then
    its best checkpoint served through route_hard. Returns its launch
    counts and its readings."""
    cfg = load_config()
    cfg["dataset"].update(train_path=root, val_path=root, test_path=root)
    cfg["classifier"]["checkpoint_dir"] = classifier_dir
    cfg["dehazing"]["checkpoint_dir"] = dehazing_dir
    ck_dir = os.path.join(tmp, "joint")
    cfg["joint_training"].update(epochs=2, hard_finetune_frac=0.5, checkpoint_dir=ck_dir)
    cfg["_logs_dir"] = os.path.join(tmp, "logs")
    probe = StepProbe()
    built = {}
    makers = (tj.make_train_step, tj.make_hard_branch_step, tj.make_eval_step,
              tj.build_router_state)

    def build(*args, **kwargs):
        router, state = makers[3](*args, **kwargs)
        built["classifier"] = {k: v.clone() for k, v in router.classifier.state_dict().items()}
        return router, state

    tj.make_train_step = probe.wrap(makers[0], "soft")
    tj.make_hard_branch_step = probe.wrap(
        makers[1], lambda state: CLASS_OF[type(state.module).__name__])
    tj.make_eval_step = probe.wrap(makers[2], "eval", eval_step=True)
    tj.build_router_state = build
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        router, state = tj.train_joint_model(cfg)
        path = counts()
        wall = time.perf_counter() - t0
    finally:
        (tj.make_train_step, tj.make_hard_branch_step, tj.make_eval_step,
         tj.build_router_state) = makers
    per_epoch = 3 * TRAIN_PER_CLASS * 3 // 4 // BATCH
    soft = probe.rec["soft"]
    check(soft["steps"] == per_epoch, f"joint: {soft['steps']} soft steps, expected {per_epoch}")
    for launches in soft["launches"]:
        check(launches.get("blend3") == 1 and launches.get("cbam_gate") == 6,
              f"joint: a soft step launched {launches}, expected K5 once and K2 six times")
    for launches in probe.rec["eval"]["launches"]:
        check(launches.get("blend3") == 1 and launches.get("cbam_gate") == 6
              and launches.get("lightweight_chain", 0) > 0,
              f"joint: a soft validation batch launched {launches}, expected K5 once, K2 six "
              "times and K1")
    hard = {}
    for level in INTENSITY_ORDER:
        rec = probe.rec[level]
        check(rec["steps"] == per_epoch // 3, f"joint: {rec['steps']} hard {level} steps")
        k2 = 6 if level == "high" else 0
        for launches in rec["launches"]:
            check(launches.get("cbam_gate", 0) == k2 and not launches.get("blend3"),
                  f"joint: a hard {level} step launched {launches}")
        hard[level] = warm_reading(rec)
    # The classifier is frozen: its parameters bitwise as grafted, its BN
    # statistics moved by the soft epoch's train-mode forwards.
    now = router.classifier.state_dict()
    moved = [k for k in now if "running" in k and not torch.equal(now[k], built["classifier"][k])]
    for k, v in now.items():
        if "running" not in k and "num_batches" not in k:
            check(torch.equal(v, built["classifier"][k]), f"joint: classifier {k} moved")
    check(len(moved) > 0, "joint: the classifier's BN statistics did not move")
    # The best checkpoint in a fresh router gives the same eval output.
    fresh = create_router(create_branch_models(cfg), create_classifier(cfg), cfg).to(dev)
    best = ckpt.load_checkpoint(ckpt.best_model_path(ck_dir))
    fresh.load_state_dict(best[0]["model"])
    loss = get_joint_loss(cfg)
    nets = loss.init(torch.Generator().manual_seed(0), dev)
    step = makers[2](loss, nets, torch.bfloat16)
    batch = device_batch(next(iter(get_dataloader(cfg, "val"))), dev)
    a, b = step(state, batch), step(TrainState(fresh, None), batch)
    reload_err = max_err(a["dehazed"], b["dehazed"])
    check(reload_err == 0.0 and float(a["psnr"]) == float(b["psnr"]),
          f"joint: best_model reloaded gives another eval output ({reload_err:.2e})")
    val = tj._validate(step, state, get_dataloader(cfg, "val"), dev)
    readings = dict(soft=warm_reading(soft), hard=hard, wall_s=wall, best_epoch=best[1]["epoch"],
                    moved_bn_buffers=len(moved), **{f"val_{k}": v for k, v in val.items()})
    # The hard epoch's images over its steps at each branch's warm median.
    hard_ips = per_epoch * BATCH / sum(
        np.median(r["warm_ms"]) * r["steps"] for r in hard.values()) * 1e3
    readings["hard_tail_images_per_s"] = hard_ips
    log(f"[joint training] soft: {soft['steps']} steps of {BATCH} at {SIZE}^2 bf16, warm "
        f"{readings['soft']['ms_per_step']:.2f} ms/step (median of {len(soft['warm_ms'])}: "
        f"{', '.join(f'{t:.2f}' for t in soft['warm_ms'])}), "
        f"{readings['soft']['images_per_s']:.1f} images/s, peak memory "
        f"{readings['soft']['peak_gib']:.2f} GiB; each soft step and val batch: K5 1, K2 6; "
        f"{smi}")
    for level, r in hard.items():
        log(f"[joint training] hard {level}: {r['steps']} steps, warm {r['ms_per_step']:.2f} "
            f"ms/step ({r['images_per_s']:.1f} images/s), peak {r['peak_gib']:.2f} GiB")
    log(f"[joint training] hard tail {hard_ips:.1f} images/s (warm medians); val PSNR "
        f"{val['psnr']:.2f} dB, SSIM {val['ssim']:.4f}, classifier accuracy "
        f"{val['cls_acc']:.4f} (best epoch {best[1]['epoch']:.0f}); classifier parameters "
        f"bitwise as grafted, {len(moved)} BN buffers moved; best_model reloaded: eval output "
        f"identical; trainer {wall:.1f} s; launches {nonzero(path)}")
    for name in JOINT_PATH_KERNELS:
        check(path[name] > 0, f"the joint training path launched no {name}")

    # Serve the best checkpoint: route_hard over the validation images.
    val_x = np.concatenate([b["hazy"][b["mask"]] for b in get_dataloader(cfg, "val")])
    val_y = np.concatenate([b["intensity"][b["mask"]] for b in get_dataloader(cfg, "val")])
    d = AdaptiveDehazer(fresh, None, cfg, device=dev)
    reset_launch_counts()
    y, labels = d.route_hard(val_x)
    torch.cuda.synchronize()
    served = nonzero(counts())
    check_images(y, len(val_x), "route_hard on the joint checkpoint")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.route_hard(val_x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / len(val_x))
    hist = np.bincount(labels, minlength=3).tolist()
    readings["served"] = dict(labels_histogram=hist, launches=served,
                              accuracy=float((labels == val_y).mean()),
                              ms_per_image=float(np.median(times)), ms_runs=times)
    log(f"[joint serving] route_hard on the {len(val_x)} validation images with the joint "
        f"checkpoint: labels (low, medium, high) {hist}, accuracy {readings['served']['accuracy']:.4f}; "
        f"kernels launched {served}; warm {np.median(times):.3f} ms/image (3 runs: "
        f"{', '.join(f'{t:.3f}' for t in times)}; bf16, numpy in and out)")
    return path, readings


# The detection phase's corpus: per intensity 32 train, 16 val and 16 test
# images at 256^2, with boxes (the port's corpus tool).
DET_COUNTS = {"train": 32, "val": 16, "test": 16}
# fp32 detector, card vs CPU (TF32 off), in units of each level tensor's
# largest magnitude: the backbone, FPN and head sum in another order on
# each side; candidates and detections: boxes in px, scores absolute.
DET_FP32_RTOL = 1e-4
DET_BOX_ATOL, DET_SCORE_ATOL = 1e-3, 1e-5
# A score threshold that the seeded detector (class bias -4) passes, so that
# the card-vs-CPU detections are not empty.
DET_SEEDED_THRESHOLD = 0.005
# Kernels each detection-evaluation batch must launch: the soft router's
# high branch K2 six times, its blend K5 once.
DETECTION_PATH_KERNELS = {"cbam_gate": 6, "blend3": 1}


def detection_levels_err(got, want):
    """Per level and tensor, the largest difference in units of the
    reference tensor's largest magnitude."""
    return [{key: max_err(g[key].cpu(), w[key].cpu()) / float(w[key].abs().max())
             for key in ("logits", "offsets", "centerness")} for g, w in zip(got, want)]


def warm_ms(fn, runs=3):
    """Host clock around fn() and a synchronize: the first call warms."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def phase_detection(dev, smi, tmp, joint_dir):
    """14. The detection stage at full width (see the docstring). Returns the
    evaluation path's launch counts and the readings."""
    root = os.path.join(tmp, "det_corpus")
    t0 = time.perf_counter()
    n = make_corpus(root, SIZE, DET_COUNTS["train"], DET_COUNTS["val"], DET_COUNTS["test"],
                    seed=SEED)
    log(f"[detection] corpus with boxes: {n} triplets at {SIZE}^2 in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = load_config()     # fcos_resnet18_fpn, 91 classes, bf16
    cfg["dataset"].update(train_path=root, val_path=root, test_path=root)
    cfg["joint_training"]["checkpoint_dir"] = joint_dir
    cfg["detection"]["checkpoint_dir"] = os.path.join(tmp, "detection")
    cfg["evaluation"].update(results_dir=os.path.join(tmp, "results"), annotation_paths={
        lvl: os.path.join(root, "annotations", f"coco_{lvl}.json") for lvl in INTENSITY_ORDER})
    cfg["_logs_dir"] = os.path.join(tmp, "logs")
    readings = {}

    # (a) The seeded detector, fp32, card vs CPU; bf16 vs fp32 on the card.
    batch = next(iter(get_detection_dataloader(cfg, "test", img_size=SIZE)))
    x = torch.from_numpy(batch["hazy"])
    dets = {}
    for name, device, dtype in (("cpu", "cpu", torch.float32), ("fp32", dev, torch.float32),
                                ("bf16", dev, torch.bfloat16)):
        det = DetectionModel(dtype=dtype, score_threshold=DET_SEEDED_THRESHOLD, device=device)
        det.init(SEED, image_size=SIZE)
        xd = x.to(device)
        with torch.no_grad(), autocast(xd.device, dtype):
            levels = det.module(xd)
        dets[name] = (levels, _device_topk(levels, det.topk), det(xd))
    fp32_err = detection_levels_err(dets["fp32"][0], dets["cpu"][0])
    bf16_err = detection_levels_err(dets["bf16"][0], dets["fp32"][0])
    worst = max(max(e.values()) for e in fp32_err)
    check(worst <= DET_FP32_RTOL, f"detection: fp32 card vs CPU {fp32_err}")
    worst_bf16 = max(max(e.values()) for e in bf16_err)
    check(worst_bf16 <= BF16_ATOL, f"detection: bf16 vs fp32 {bf16_err}")
    agree, moved = candidates_agree(dets["fp32"][1], dets["cpu"][1], DET_BOX_ATOL,
                                    DET_SCORE_ATOL)
    check(agree, "detection: the card's top-k candidates differ from the CPU's")
    card_dets, cpu_dets = dets["fp32"][2], dets["cpu"][2]
    n_dets = sum(len(r["labels"]) for r in cpu_dets)
    check(n_dets > 0 and detections_agree(card_dets, cpu_dets, DET_BOX_ATOL, DET_SCORE_ATOL),
          f"detection: the card's detections differ from the CPU's ({n_dets} on the CPU)")
    n_cand = sum(int(lv["index"].numel()) for lv in dets["cpu"][1])
    readings.update(fp32_card_vs_cpu=worst, bf16_vs_fp32=worst_bf16, seeded_detections=n_dets,
                    candidates=n_cand, candidates_reordered=moved)
    log(f"[detection] seeded fcos_resnet18_fpn, {len(x)} test images at {SIZE}^2: fp32 card vs "
        f"CPU {worst:.2e} of each level tensor's max (bound {DET_FP32_RTOL}); top-k "
        f"candidates agree ({moved} of {n_cand} positions hold another location, all within "
        f"score ties of {DET_SCORE_ATOL}); {n_dets} detections above {DET_SEEDED_THRESHOLD} "
        f"agree (boxes within {DET_BOX_ATOL} px); bf16 vs fp32 {worst_bf16:.2e} "
        f"(bound {BF16_ATOL})")
    del dets

    # (b) train_detection, 2 epochs, counters at 0.
    probe = StepProbe()
    make = tdet.make_detection_train_step
    tdet.make_detection_train_step = probe.wrap(make, "detection")
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        det, state = tdet.train_detection(cfg, epochs=2, img_size=SIZE, device=dev)
        wall = time.perf_counter() - t0
        train_path = nonzero(counts())
    finally:
        tdet.make_detection_train_step = make
    rec = probe.rec["detection"]
    per_epoch = 3 * DET_COUNTS["train"] // (BATCH // 2)
    check(rec["steps"] == 2 * per_epoch, f"detection: {rec['steps']} train steps")
    best = ckpt.load_checkpoint(ckpt.best_model_path(cfg["detection"]["checkpoint_dir"]))
    fresh = create_detection_model(cfg, dev)
    fresh.init(SEED + 1, image_size=SIZE)
    fresh.module.load_state_dict(best[0]["model"])
    xd = x.to(dev)
    same = (np.array_equal(det.host_candidates(xd), fresh.host_candidates(xd))
            and detections_agree(det(xd), fresh(xd), 0.0, 0.0))
    check(same, "detection: best_model reloaded gives other candidates or detections")
    readings["training"] = dict(warm_reading(rec, BATCH // 2), wall_s=wall,
                                best_epoch=best[1]["epoch"], val_loss=best[1]["val_loss"],
                                launches=train_path)
    r = readings["training"]
    log(f"[detection training] {rec['steps']} steps of {BATCH // 2} at {SIZE}^2 bf16, warm "
        f"{r['ms_per_step']:.2f} ms/step (median of {len(rec['warm_ms'])}), "
        f"{r['images_per_s']:.1f} images/s, peak memory {r['peak_gib']:.2f} GiB; best epoch "
        f"{best[1]['epoch']:.0f} (val loss {best[1]['val_loss']:.4f}); best_model reloaded: "
        f"candidates and detections identical; trainer {wall:.1f} s; launches {train_path}; "
        f"{smi}")

    # (c) evaluate_object_detection: phase 13's joint checkpoint as the
    # dehazer, the trained detector; counters at 0.
    router = det_eval._load_joint(cfg, dev)
    per_call = []
    forward = router.forward

    def counted_forward(*args, **kwargs):
        before = counts()
        out = forward(*args, **kwargs)
        per_call.append(nonzero(delta(before)))
        return out

    router.forward = counted_forward
    built = []

    class RecordedMetrics(det_eval.DetectionMetrics):
        def __init__(self, annotation_file):
            super().__init__(annotation_file)
            self.gt = annotation_file      # the merged GT dict
            built.append(self)

    metrics_cls = det_eval.DetectionMetrics
    det_eval.DetectionMetrics = RecordedMetrics
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        result = det_eval.evaluate_object_detection(cfg, router, device=dev)
        torch.cuda.synchronize()
        path = counts()
        eval_wall = time.perf_counter() - t0
    finally:
        det_eval.DetectionMetrics = metrics_cls
        router.forward = forward
    n_batches = len(get_dataloader(cfg, "test"))
    check(len(per_call) == n_batches, f"detection: {len(per_call)} router calls, "
          f"{n_batches} test batches")
    for launches in per_call:
        for name, least in DETECTION_PATH_KERNELS.items():
            check(launches.get(name, 0) >= least,
                  f"detection: a test batch's dehazing launched {launches}")
    matchers = {m.evaluator.matcher for m in built}
    check(len(built) == 2 and matchers == {"native"}, f"detection: matchers {matchers}")
    for side, m in zip(("hazy", "dehazed"), built):
        native = m.evaluate()
        python = coco_eval.COCOEvaluator(m.gt, matcher="python").evaluate(m.results)
        check(native == python, f"detection: {side} native stats {native} != python {python}")
    hazy_map = result["hazy"]["overall"]["mAP"]
    dehazed_map = result["dehazed"]["overall"]["mAP"]
    readings["evaluation"] = dict(
        hazy=result["hazy"]["overall"], dehazed=result["dehazed"]["overall"],
        by_level={side: {k: v.get("mAP") for k, v in result[side].items() if k != "overall"}
                  for side in ("hazy", "dehazed")},
        launches_per_batch=per_call, matcher="native", wall_s=eval_wall,
        detections={side: len(m.results) for side, m in zip(("hazy", "dehazed"), built)})
    log(f"[detection eval] {n_batches} test batches of {BATCH} ({3 * DET_COUNTS['test']} "
        f"images): mAP hazy {hazy_map:.4f}, dehazed {dehazed_map:.4f} (mAP_50 "
        f"{result['hazy']['overall']['mAP_50']:.4f} / {result['dehazed']['overall']['mAP_50']:.4f}; "
        f"{len(built[0].results)} / {len(built[1].results)} detections); COCO matcher: native "
        f"(native/coco_match.cpp), its 12 stats equal the Python matcher's on both sides; "
        f"launches per batch {per_call}; {eval_wall:.1f} s")

    # (d) Where an evaluation batch's time goes, batch 16 at 256^2, bf16.
    hazy = torch.from_numpy(next(iter(get_dataloader(cfg, "test")))["hazy"]).to(dev)
    dtype = torch.bfloat16

    @torch.no_grad()
    def dehaze(images):
        with autocast(images.device, dtype):
            out, info = router(images)
        return out.float(), info

    norm = imagenet_normalize(hazy)
    det_ms, det_runs = warm_ms(lambda: det.candidates(norm))
    router_ms, _ = warm_ms(lambda: dehaze(hazy))
    integrated = create_integrated_system(dehaze, det)
    sys_ms, sys_runs = warm_ms(lambda: integrated(hazy))
    packed = det.host_candidates(norm)
    above = int((packed[..., 4] > det.score_threshold).sum())
    nms_ms, _ = warm_ms(lambda: [postprocess(packed[i], det.score_threshold, (SIZE, SIZE))
                                 for i in range(len(packed))])
    read_ms, _ = warm_ms(lambda: det.host_candidates(norm))
    readings["timing"] = dict(
        detector_ms_per_image=det_ms / BATCH, router_ms_per_image=router_ms / BATCH,
        integrated_ms_per_image=sys_ms / BATCH, host_nms_ms_per_batch=nms_ms,
        forward_topk_read_ms_per_batch=read_ms, candidates_above_threshold=above,
        detector_runs_ms=det_runs, integrated_runs_ms=sys_runs)
    log(f"[detection timing] batch {BATCH} at {SIZE}^2 bf16, warm (synchronized): detector "
        f"(forward + top-k) {det_ms / BATCH:.3f} ms/image, router {router_ms / BATCH:.3f} "
        f"ms/image, integrated system {sys_ms / BATCH:.3f} ms/image; forward, top-k and the "
        f"one host read {read_ms:.2f} ms a batch, host decode + NMS {nms_ms:.2f} ms a batch "
        f"({above} candidates above {det.score_threshold}); {smi}")
    return path, readings


# Phase 15's experiment: the serve modes it drives through the CLI (the
# first with --detect), the quality head's training steps (the CLI's
# `evaluation.nima_steps`; 300 by default), and the key tree of
# comprehensive_results.json as the JAX package writes it
# (adam_dehaze_tpu/evaluation/evaluate.py:662-737), without train_all's
# pre-joint row.
CLI_SERVE_MODES = ("hard", "spill_up", "stream", "queued", "device", "soft")
CLI_NIMA_STEPS = 50
COMPREHENSIVE_SCHEMA = {
    "baseline": {"low_intensity", "medium_intensity", "high_intensity"},
    "joint": {"low_intensity", "medium_intensity", "high_intensity", "fade_proxy",
              "brisque_proxy", "nima_proxy"},
    "fixed": {"fixed_low", "fixed_medium", "fixed_high"},
    "hard_routing": {"fidelity", "spill", "spill_up", "spill_ordered", "routing_acc",
                     "spilled_frac", "spilled_frac_up", "spilled_frac_ordered"},
    "detection": {"hazy", "dehazed", "by_level", "improvement_percent"},
    "comparison": {"baseline_avg_psnr", "joint_avg_psnr", "psnr_improvement",
                   "best_fixed_psnr", "adaptive_vs_best_fixed_psnr"},
    "baseline_comparison": {"corpus", "reference_source", "rows"},
}
# Kernels the CLI's `evaluate` must launch: K1 (the low branch of the
# baseline, fixed and hard rows), K2 (every high-branch call) and K5 (the
# router's soft blend).
CLI_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "blend3")


def numbers(tree, path=""):
    """(path, value) of every number in a JSON tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numbers(v, f"{path}/{k}")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, tree


def phase_cli(dev, smi, tmp):
    """15. The command line (adam_dehaze_tpu_torch/cli.py) on an experiment
    directory built from the earlier phases' checkpoints (see the
    docstring). Returns the phase's launch counts and readings."""
    from adam_dehaze_tpu_torch import cli, serving
    from adam_dehaze_tpu_torch.config import create_experiment_dir
    from adam_dehaze_tpu_torch.data.dataset import _imread_rgb
    from adam_dehaze_tpu_torch.data.preprocessing import _write_rgb

    root = os.path.join(tmp, "det_corpus")
    cfg = load_config()     # default widths, 256^2, bf16
    cfg["dataset"].update(train_path=root, val_path=root, test_path=root)
    cfg["evaluation"].update(nima_steps=CLI_NIMA_STEPS, annotation_paths={
        lvl: os.path.join(root, "annotations", f"coco_{lvl}.json") for lvl in INTENSITY_ORDER})
    exp, cfg = create_experiment_dir(cfg, "cli", root=os.path.join(tmp, "experiments"))
    sources = {"classifier": os.path.join(tmp, "classifier"),
               "joint": os.path.join(tmp, "joint"),
               "detection": os.path.join(tmp, "detection"),
               **{f"dehazing/{lvl}": os.path.join(tmp, "checkpoints", lvl)
                  for lvl in INTENSITY_ORDER}}
    for name, src in sources.items():
        dst = os.path.join(exp, "checkpoints", name)
        os.makedirs(dst, exist_ok=True)
        for f in ("best_model.pth", "best_model.metrics.json"):
            if os.path.exists(os.path.join(src, f)):
                shutil.copy2(os.path.join(src, f), dst)
        check(os.path.exists(os.path.join(dst, "best_model.pth")), f"cli: no {name} checkpoint")
    cache = os.path.join(exp, "serving_autotune.json")
    shutil.copy2(os.path.join(tmp, "autotune_bf16.json"), cache)
    readings, runs = {}, {}

    def run(tag, argv):
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        runs[tag] = counts()
        wall = time.perf_counter() - t0
        log(f"[cli] {tag}: {wall:.1f} s, launches {nonzero(runs[tag])}")
        return wall

    # (a) evaluate: the tuned cache serves the hard rows; each section timed.
    tuned = []
    load_or_tune = serving.load_or_tune

    def recorded(model, *args, **kwargs):
        fn, report = load_or_tune(model, *args, **kwargs)
        tuned.append((CLASS_OF[type(model).__name__], report["best"], report["cached"]))
        return fn, report

    sections, section_s = ("evaluate_baseline_models", "evaluate_joint_model",
                           "evaluate_fixed_branch", "evaluate_hard_routing",
                           "evaluate_object_detection"), {}
    originals = {name: getattr(det_eval, name) for name in sections}

    def timed_section(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            section_s[name] = time.perf_counter() - t0
            return out
        return call

    serving.load_or_tune = recorded
    for name in sections:
        setattr(det_eval, name, timed_section(name))
    try:
        eval_s = run("evaluate", ["--mode", "evaluate", "--experiment_dir", exp])
    finally:
        serving.load_or_tune = load_or_tune
        for name, fn in originals.items():
            setattr(det_eval, name, fn)
    check(sorted(level for level, _, _ in tuned) == sorted(INTENSITY_ORDER)
          and all(cached for _, _, cached in tuned),
          f"cli: the hard rows did not serve from the experiment's tuned cache: {tuned}")
    with open(os.path.join(cfg["evaluation"]["results_dir"], "comprehensive_results.json")) as f:
        results = json.load(f)
    tree = {k: set(v) for k, v in results.items()}
    check(tree == COMPREHENSIVE_SCHEMA, f"cli: comprehensive_results.json keys {tree}")
    bad = [p for p, v in numbers(results) if not np.isfinite(v)]
    check(not bad, f"cli: numbers that are not finite: {bad}")
    for name in CLI_PATH_KERNELS:
        check(runs["evaluate"][name] > 0, f"cli: evaluate launched no {name}")
    joint, hard, comp = results["joint"], results["hard_routing"], results["comparison"]
    readings["evaluate"] = dict(
        wall_s=eval_s, section_s=section_s, tuned={lvl: best for lvl, best, _ in tuned},
        launches=nonzero(runs["evaluate"]),
        psnr={k: comp[k] for k in ("baseline_avg_psnr", "joint_avg_psnr", "best_fixed_psnr")},
        routing_acc=hard["routing_acc"],
        spilled={k: hard[k] for k in ("spilled_frac", "spilled_frac_up", "spilled_frac_ordered")},
        proxies={k: joint[k] for k in ("fade_proxy", "brisque_proxy", "nima_proxy")},
        mAP={side: results["detection"][side]["mAP"] for side in ("hazy", "dehazed")})
    r = readings["evaluate"]
    log(f"[cli evaluate] {eval_s:.1f} s; sections (s) "
        f"{ {k.replace('evaluate_', ''): round(v, 2) for k, v in section_s.items()} }; "
        f"hard rows on the tuned dispatch {r['tuned']}; PSNR baseline "
        f"{comp['baseline_avg_psnr']:.3f}, joint {comp['joint_avg_psnr']:.3f}, best fixed "
        f"{comp['best_fixed_psnr']:.3f} dB; routing_acc {hard['routing_acc']:.4f}, spilled "
        f"{r['spilled']}; fade {joint['fade_proxy']}, brisque {joint['brisque_proxy']}, nima "
        f"{joint['nima_proxy']}; mAP hazy {r['mAP']['hazy']:.4f}, dehazed "
        f"{r['mAP']['dehazed']:.4f}; K3 {runs['evaluate']['medium_tail_chain']}, K4 "
        f"{runs['evaluate']['high_tail_chain']}, K2' {runs['evaluate']['spatial_gate']}, K6 "
        f"{runs['evaluate']['res_attn_chain']} launches; {smi}")

    # (b) serve, each mode on the test split's hazy images.
    files = cli.serve_inputs(cfg)
    bs = cfg["dataset"]["batch_size"]
    d = AdaptiveDehazer(det_eval._load_joint(cfg, dev), None, cfg, device=dev)
    want = np.concatenate([d.route_hard(np.stack([_imread_rgb(f, SIZE)
                                                  for f in files[i:i + bs]]))[1]
                           for i in range(0, len(files), bs)])
    del d
    readings["serve"] = {}
    for mode in CLI_SERVE_MODES:
        out = os.path.join(exp, f"served_{mode}")
        argv = ["--mode", "serve", "--experiment_dir", exp, "--serve_mode", mode, "--out", out]
        wall = run(f"serve {mode}", argv + (["--detect"] if mode == "hard" else []))
        pngs = [f for f in os.listdir(out) if f.endswith(".png")]
        check(len(pngs) == len(files), f"cli: serve {mode} wrote {len(pngs)} PNGs")
        with open(os.path.join(out, "routing.json")) as f:
            manifest = json.load(f)["images"]
        labels = [manifest.get(os.path.basename(p), {}).get("intensity") for p in files]
        if mode == "soft":
            check(manifest == {}, "cli: serve soft wrote labels")
        elif mode == "hard":
            check(labels == want.tolist(), "cli: serve hard's labels differ from route_hard's")
            with open(os.path.join(out, "detections.json")) as f:
                check(len(json.load(f)) == len(files), "cli: detections.json misses images")
        else:
            check(None not in labels, f"cli: serve {mode} left images unlabelled")
        readings["serve"][mode] = dict(ms_per_image=wall * 1e3 / len(files),
                                       launches=nonzero(runs[f"serve {mode}"]))
    log(f"[cli serve] {len(files)} test images, ms/image by the host clock with the process's "
        f"loading and PNG I/O (hard with --detect): "
        f"{ {m: round(v['ms_per_image'], 2) for m, v in readings['serve'].items()} }; hard's "
        f"labels equal route_hard's (histogram {np.bincount(want, minlength=3).tolist()}); "
        f"{smi}")

    # (c) demo, (d) preprocess of a raw directory of a few triplets.
    run("demo", ["--mode", "demo", "--experiment_dir", exp])
    demo = sorted(os.listdir(os.path.join(exp, "demo")))
    check(any(f.startswith("demo_batch") for f in demo), f"cli: demo wrote {demo}")
    pre = os.path.join(tmp, "preprocess")
    rng = np.random.default_rng(SEED)
    for lvl in INTENSITY_ORDER:
        for i in range(4):
            for role in ("hazy", "clear", "dehazed"):
                _write_rgb(os.path.join(pre, "raw", lvl, role, f"{lvl}_{i}.png"),
                           rng.random((300, 280, 3), dtype=np.float32))
    pre_cfg = os.path.join(pre, "config.yaml")
    with open(pre_cfg, "w") as f:
        json.dump({"dataset": {"train_path": os.path.join(pre, "processed")}}, f)
    run("preprocess", ["--mode", "preprocess", "--config", pre_cfg,
                       "--experiment_dir", os.path.join(tmp, "experiments", "pre")])
    done = [f for d_, _, fs in os.walk(os.path.join(pre, "processed", "train")) for f in fs]
    check(len(done) > 0, "cli: preprocess wrote no train split")
    readings.update(demo_files=demo, runs={k: nonzero(v) for k, v in runs.items()})
    path = {k: sum(r[k] for r in runs.values()) for k in runs["evaluate"]}
    log(f"[cli] demo wrote {len(demo)} files; preprocess split {len(done)} train files; "
        f"launches on the cli path {nonzero(path)}")
    return path, readings, exp


# The half-resolution dial on every branch, and the kernels its paths must
# launch: K1 and K2 under the default dispatch, K3, K4, K2' and K6 under
# the kernel dispatches (the tuned winners and phase 5's two forced ones).
LOWRES = ("low", "medium", "high")
LOWRES_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "spatial_gate", "medium_tail_chain",
                       "high_tail_chain", "res_attn_chain")
# The guided lift divides differences of box means of float32 integral
# images by var + 1e-4, and the corpus's sky is flat: var is near 0 there,
# so float32 rounding (and a 1e-6 difference of the branch outputs) moves
# the lifted output by 1e-3 to 1e-2 (PERF.md). The lift is held on the card
# against float64 within LIFT_K times the CPU's own float32 error: the
# card's scan sums the integral images in another order than the CPU's
# sequential cumsum, and read 2.7 times the CPU's error (4.4e-3 against
# 1.6e-3 at radius 4; NVIDIA H100 80GB HBM3, 700.00 W).
LIFT_K = 8.0


def phase_lowres_kernels(dev, gen):
    """The kernels of the half-resolution path alone at its shapes: each
    branch at half the image side (128^2 of 256^2), batch 16, against the
    plain versions at phase 3's bounds (launches not counted on any path)."""
    size, tag = SIZE // 2, "lowres "
    results = {"lightweight_chain": check_k1(dev, gen, size, tag),
               "cbam_gate": check_k2(dev, gen, size, tag),
               "spatial_gate": check_k2_prime(dev, gen, size, tag)}
    results.update(phase_tail_kernels(dev, gen, size, tag))
    results["res_attn_chain"] = phase_res_chain_kernels(dev, gen, size, tag)
    return results


def phase_lowres(dev, smi, exp, forced_caches, fp32_caches):
    """16. The half-resolution dial (ops/resolution.py) on phase 15's
    experiment, served through `AdaptiveDehazer.from_experiment` (see the
    docstring). Returns the path's launch counts, the kernels' readings at
    128^2 and the phase's readings."""
    from adam_dehaze_tpu_torch import cli
    from adam_dehaze_tpu_torch.data.dataset import _imread_rgb
    from adam_dehaze_tpu_torch.resolution_autotune import policy_to_lowres
    from adam_dehaze_tpu_torch.tools import autotune_resolution

    kernels = phase_lowres_kernels(dev, torch.Generator().manual_seed(SEED + 7))
    readings = {}

    # (a) from_experiment with the experiment's tuned cache, beside phase
    # 15's dehazer (the default dispatch) on the same test images.
    tuned = AdaptiveDehazer.from_experiment(exp, autotune=True, device=dev)
    cfg = tuned.config
    check(all(r["cached"] for r in tuned.autotune_report.values()),
          f"lowres: from_experiment did not read the tuned cache: {tuned.autotune_report}")
    winners = {lvl: r["best"] for lvl, r in tuned.autotune_report.items()}
    phase15 = AdaptiveDehazer(det_eval._load_joint(cfg, dev), None, cfg, device=dev)
    files = cli.serve_inputs(cfg)
    x = np.stack([_imread_rgb(f, SIZE) for f in files[:BATCH]])
    got, got_i = tuned.route_hard(x)
    want, want_i = phase15.route_hard(x)
    err = float(np.abs(got - want).max())
    log(f"[lowres] from_experiment(autotune=True), winners {winners}: route_hard labels "
        f"{np.bincount(got_i, minlength=3).tolist()} equal phase 15's dehazer's: "
        f"{bool((got_i == want_i).all())}; max abs diff {err:.3e} (bound {BF16_ATOL})")
    check((got_i == want_i).all() and err <= BF16_ATOL,
          "lowres: from_experiment's route_hard disagrees with phase 15's dehazer")

    # (b) the resolution tool on the val split, through the tuned winners.
    t0 = time.perf_counter()
    policy = autotune_resolution.main(["--experiment", exp])
    tool_s = time.perf_counter() - t0
    per_branch = {}
    for level, entry in policy["levels"].items():
        table = entry.get("table", {})
        check(set(table) == {"full", "guided_r4_s2", "guided_r2_s2"}
              and all("error" not in row and "psnr" in row and "ms" in row
                      for row in table.values()),
              f"lowres: the tuner's {level} table {table}")
        per_branch[level] = {name: dict(psnr=row["psnr"], ms_per_image=row["ms"] / policy["batch"])
                             for name, row in table.items()}
        log(f"[lowres tune] {level}: choice {entry['choice']} on {entry['n_probe']} val images; "
            + "; ".join(f"{name} {row['psnr']:.3f} dB, {row['ms'] / policy['batch']:.4f} "
                        f"ms/image" for name, row in table.items())
            + f" (batch {policy['batch']}, bf16, {SIZE}^2; {smi})")
    readings["tune"] = dict(seconds=tool_s, branches=per_branch,
                            choice={k: v["choice"] for k, v in policy["levels"].items()})

    # (c) the lowres path, counters at 0 just before it and read just after.
    labels = np.arange(BATCH) % 3
    default = AdaptiveDehazer.from_experiment(exp, device=dev)
    forced = {tag: AdaptiveDehazer(det_eval._load_joint(cfg, dev), None, cfg, device=dev,
                                   autotune=True, autotune_cache=cache)
              for tag, cache in zip(("tail-chain", "res-chain"), forced_caches)}
    dehazers = {"default": default, "tuned": tuned, **forced}
    xd = torch.from_numpy(x).to(dev)
    served = {}
    reset_launch_counts()
    with torch.inference_mode():
        for tag, d in dehazers.items():
            served[tag] = d._binned_engine(LOWRES).dispatch(xd, labels)
    auto, auto_i = tuned.route_hard(x, lowres="auto")
    stream = list(tuned.route_hard_stream([x[:BATCH // 2], x[BATCH // 2:]], lowres=("high",)))
    cli_runs = {}
    for mode, lowres in (("hard", "high"), ("stream", "auto")):
        out = os.path.join(exp, f"served_lowres_{lowres}")
        t0 = time.perf_counter()
        cli.main(["--mode", "serve", "--experiment_dir", exp, "--serve_mode", mode,
                  "--lowres", lowres, "--out", out])
        with open(os.path.join(out, "routing.json")) as f:
            cli_runs[lowres] = (json.load(f), time.perf_counter() - t0)
    torch.cuda.synchronize()
    path = counts()
    log(f"[lowres] launches on the lowres path: {nonzero(path)}")
    check(all(path[k] > 0 for k in LOWRES_PATH_KERNELS),
          f"lowres: a kernel of the lowres path never ran: {path}")

    for tag, y in served.items():
        check(y.device.type == "cuda", f"lowres: the {tag} dispatch served off the card")
        y = y.cpu().numpy()
        check_images(y, BATCH, f"lowres {tag}")
        err = float(np.abs(y - served["default"].cpu().numpy()).max())
        dispatch = {lvl: r["best"] for lvl, r in dehazers[tag].autotune_report.items()}
        log(f"[lowres] forced labels 0/1/2, every branch at {SIZE // 2}^2, {tag} dispatch "
            f"{dispatch or 'chain / canonical / canonical'}: max abs diff to the default "
            f"dispatch {err:.3e} (bound {BF16_ATOL})")
        check(err <= BF16_ATOL, f"lowres: the {tag} dispatch disagrees with the default")
    check_images(auto, BATCH, "lowres auto")
    check((auto_i == want_i).all(), "lowres: route_hard(lowres='auto') labels differ")
    check("binned_lowres_high-2-guided-4" in tuned._engines,
          f"lowres: route_hard_stream built no high-only engine: {sorted(tuned._engines)}")
    for (y, i), part in zip(stream, (x[:BATCH // 2], x[BATCH // 2:])):
        direct, direct_i = tuned.route_hard(part, lowres=("high",))
        check((i == direct_i).all() and float(np.abs(y - direct).max()) <= BF16_ATOL,
              "lowres: route_hard_stream(lowres=('high',)) differs from route_hard")
    bs = cfg["dataset"]["batch_size"]
    cli_labels = np.concatenate([phase15.route_hard(
        np.stack([_imread_rgb(f, SIZE) for f in files[i:i + bs]]))[1]
        for i in range(0, len(files), bs)]).tolist()
    for lowres, (manifest, wall) in cli_runs.items():
        labels_cli = [manifest["images"][os.path.basename(f)]["intensity"] for f in files]
        check(manifest["lowres"] == ("auto" if lowres == "auto" else [lowres]),
              f"lowres: routing.json says lowres {manifest['lowres']!r}")
        check(labels_cli == cli_labels, f"lowres: serve --lowres {lowres} labels differ")
        readings[f"cli_{lowres}_ms_per_image"] = wall * 1e3 / len(files)
    log(f"[lowres cli] serve --lowres high (hard) and --lowres auto (stream, policy "
        f"{policy_to_lowres(policy)}): routing.json's lowres field and labels as route_hard's; "
        f"{readings['cli_high_ms_per_image']:.2f} and {readings['cli_auto_ms_per_image']:.2f} "
        f"ms/image with the process's set-up and PNG I/O")

    # (d) full against half resolution, forced labels, warm ms/image (host
    # clock around a synchronize), under the default and the tuned dispatch.
    timing = {}
    for tag in ("default", "tuned"):
        d = dehazers[tag]
        for dial, eng in (("full", d.engine), ("lowres", d._binned_engine(LOWRES))):
            def run(eng=eng):
                with torch.inference_mode():
                    eng.dispatch(xd, labels)
            timing[f"{tag}_{dial}"] = route_ms(run, BATCH)[0]
        log(f"[lowres timing] {tag} dispatch, forced labels 0/1/2, {BATCH} images at {SIZE}^2 "
            f"bf16: full {timing[f'{tag}_full']:.3f} ms/image, every branch at {SIZE // 2}^2 "
            f"{timing[f'{tag}_lowres']:.3f} ms/image; {smi}")
    readings["forced_ms_per_image"] = timing
    del dehazers, default, tuned, forced, phase15, xd, served
    torch.cuda.empty_cache()

    # (e) fp32, forced labels 0, 1, 2, every branch at half resolution, on
    # the card under the default, the tail-chain and the res-chain dispatch
    # against the CPU, in its two parts (LIFT_K): the shrink, and the branches
    # at 128^2 on the same shrunk images, at SLICE_ATOL; the lift on the same
    # corrections against float64.
    from adam_dehaze_tpu_torch.ops import resolution
    cfg32 = copy.deepcopy(cfg)
    cfg32["cuda"]["compute_dtype"] = "float32"
    x3 = torch.from_numpy(x[:3])
    x_lo = resolution._resize_nhwc(x3, (SIZE // 2, SIZE // 2))
    shrink_err = max_err(resolution._resize_nhwc(x3.to(dev), (SIZE // 2, SIZE // 2)).cpu(), x_lo)
    log(f"[lowres vs plain] the antialiased shrink {SIZE}^2 -> {SIZE // 2}^2, fp32, card vs "
        f"CPU: {shrink_err:.3e} (bound {FP32_ATOL})")
    check(shrink_err <= FP32_ATOL, "lowres: the shrink on the card disagrees with the CPU")
    lows, ends = {}, {}
    for tag, device, cache in (("CPU", "cpu", None), ("card, default", dev, None),
                               ("card, tail-chain", dev, fp32_caches[0]),
                               ("card, res-chain", dev, fp32_caches[1])):
        kwargs = dict(autotune=True, autotune_cache=cache) if cache else {}
        d = AdaptiveDehazer(det_eval._load_joint(cfg32, device), None, cfg32, device=device,
                            **kwargs)
        check(all(r["cached"] for r in d.autotune_report.values()),
              f"lowres fp32 {tag}: the cache was not read")
        with torch.inference_mode():
            lows[tag] = d.engine.dispatch(x_lo.to(device), np.arange(3)).cpu()
            ends[tag] = d._binned_engine(LOWRES).dispatch(x3.to(device), np.arange(3)).cpu()
        del d
    errs = {}
    for tag in list(lows)[1:]:
        errs[tag] = max_err(lows["CPU"], lows[tag])
        log(f"[lowres vs plain] fp32, labels [0, 1, 2], the branches at {SIZE // 2}^2, {tag}: "
            f"max abs err vs CPU {errs[tag]:.3e} (bound {SLICE_ATOL}); with the lift, a "
            f"reading: {max_err(ends['CPU'], ends[tag]):.3e}")
        check(errs[tag] <= SLICE_ATOL,
              f"lowres: the card's fp32 branches at half resolution ({tag}) disagree with the CPU")

    def lift(xx, xx_lo, y_lo):
        corr = resolution.guided_upsample(resolution._gray(xx), resolution._gray(xx_lo),
                                          y_lo - xx_lo)
        return torch.clamp(xx + corr, 0.0, 1.0)

    ref = lift(x3.double(), x_lo.double(), lows["CPU"].double())
    cpu_err = max_err(lift(x3, x_lo, lows["CPU"]), ref)
    card_err = max_err(lift(x3.to(dev), x_lo.to(dev), lows["CPU"].to(dev)).cpu(), ref)
    lift_bound = max(FP32_ATOL, LIFT_K * cpu_err)
    log(f"[lowres vs plain] the guided lift {SIZE // 2}^2 -> {SIZE}^2 (radius 4) of the CPU's "
        f"corrections, fp32 against float64: card {card_err:.3e}, CPU {cpu_err:.3e} (bound "
        f"{lift_bound:.3e}, {LIFT_K:g}x the CPU's or {FP32_ATOL})")
    check(card_err <= lift_bound, "lowres: the guided lift on the card disagrees with float64")
    readings["fp32_vs_cpu"] = dict(shrink=shrink_err, branches=errs, lift_card=card_err,
                                   lift_cpu=cpu_err,
                                   end_to_end={t: max_err(ends["CPU"], ends[t])
                                               for t in list(ends)[1:]})
    return path, kernels, readings


# Phase 17's two routers at the default config's widths: level -> (model_type,
# channels, blocks), and the classifier's backbone. Router B keeps the
# default low branch (K1).
ALT_ROUTERS = {
    "A": ({"low": ("unet", 32, 3), "medium": ("corun", 64, 6),
           "high": ("dual_branch", 96, 9)}, "mobilenet_v3_small"),
    "B": ({"medium": ("encoder_decoder", 64, 6), "high": ("encoder_decoder", 96, 9)},
          "efficientnet_b0"),
}
# K2 in the alternate high branches at 256^2, batch 16: shape -> calls per
# branch call. dual_branch: c = 96 at 128^2 and 64^2; encoder_decoder: 8c =
# 768 at 32^2.
ALT_K2_SHAPES = {
    "dual_branch": {(BATCH, SIZE // 2, SIZE // 2, 96): 1, (BATCH, SIZE // 4, SIZE // 4, 96): 1},
    "encoder_decoder": {(BATCH, SIZE // 8, SIZE // 8, 768): 1},
}
ALTERNATE_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "blend3")


def alternate_config(name, dtype="bfloat16"):
    branches, backbone = ALT_ROUTERS[name]
    cfg = load_config(overrides={"cuda": {"compute_dtype": dtype}})
    for level, (model_type, channels, blocks) in branches.items():
        cfg["dehazing"][level].update(model_type=model_type, channels=channels, blocks=blocks)
    cfg["classifier"]["model"] = backbone
    return cfg


def forward_gflops(module, x):
    """module(x) and the GFLOP per image of its convolutions, transposed
    convolutions and linear layers, counted from their shapes by forward
    hooks (a multiply-add is two operations)."""
    total = [0]

    def count(mod, inp, out):
        if isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features
        elif isinstance(mod, torch.nn.ConvTranspose2d):   # weight (in, out, k, k)
            total[0] += 2 * inp[0].numel() * mod.weight[0].numel()
        else:                                             # weight (out, in / groups, k, k)
            total[0] += 2 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))]
    try:
        out = module(x)
    finally:
        for h in hooks:
            h.remove()
    return out, total[0] / x.shape[0] / 1e9


def phase_alternate(dev, smi, x, labels):
    """17. The alternate branches and backbones (see the docstring): K2 at
    their shapes, routers A and B through an AdaptiveDehazer with the
    counters at 0, fp32 card vs CPU. Returns the path's launch counts, K2's
    readings at the new shapes and the phase's readings."""
    gen = torch.Generator().manual_seed(SEED + 8)
    kernels = {branch: check_k2(dev, gen, SIZE, f"alternate {branch} ", shapes, branch)
               for branch, shapes in ALT_K2_SHAPES.items()}
    readings, path, routers = {}, collections.Counter(), {}
    for name in ALT_ROUTERS:
        cfg = alternate_config(name)
        routers[name] = make_router(cfg, gen)
        d = AdaptiveDehazer(copy.deepcopy(routers[name]), None, cfg, device=dev)
        kinds = {lvl: type(m).__name__ for lvl, m in d.router.models.items()}
        per_class = buckets_per_class(d.engine, labels)
        outs, intensity, (hard, forced_d, soft_d), main = drive(d, x, labels, dev)
        path.update(main)
        log(f"[alternate {name}] {kinds}, classifier {cfg['classifier']['model']}: route_hard "
            f"intensities {np.bincount(intensity, minlength=3).tolist()}; launches: route_hard "
            f"{nonzero(hard)}, forced labels {nonzero(forced_d)}, soft {nonzero(soft_d)}")
        for y, what in zip(outs, ("route_hard", "forced-label engine", "soft")):
            check_images(y, BATCH, f"alternate {name} {what}")
        k2 = sum(isinstance(m, AttentionBlock) for m in d.router.models["high"].modules())
        k1 = K1_LAUNCHES[torch.bfloat16] if kinds["low"] == "LightweightDehazeModel" else 0
        check(nonzero(forced_d) == nonzero({"lightweight_chain": k1 * per_class[0],
                                            "cbam_gate": k2 * per_class[2]}),
              f"alternate {name}, forced run: launches {forced_d} vs buckets {per_class}")
        check(nonzero(soft_d) == nonzero({"lightweight_chain": k1, "cbam_gate": k2,
                                          "blend3": 1}),
              f"alternate {name}, soft run launches {soft_d}")
        readings[name] = dict(branches=kinds, classifier=cfg["classifier"]["model"],
                              ms_per_image=time_slice(d, x, labels, f"alternate {name}"))
        del d
    check(all(path[k] > 0 for k in ALTERNATE_PATH_KERNELS),
          f"alternate: a kernel of the path never ran: {dict(path)}")
    torch.cuda.empty_cache()

    # fp32 with TF32 off: each alternate branch and each new backbone on the
    # card against the CPU, the same weights, 2 images at 256^2.
    xs = torch.from_numpy(x[:2])
    errs, gflops = {}, {}
    for name, router in routers.items():
        branches, backbone = ALT_ROUTERS[name]
        modules = {f"{lvl} {branches[lvl][0]}": router.models[lvl] for lvl in branches}
        modules[backbone] = router.classifier
        for what, module in modules.items():
            module = module.eval()
            with torch.inference_mode():
                want, gflops[what] = forward_gflops(module, xs)
                got = copy.deepcopy(module).to(dev)(xs.to(dev))
            if isinstance(want, tuple):   # the classifier: logits, features
                errs[what] = max(max_err(a.cpu(), b) for a, b in zip(got, want))
            else:
                errs[what] = max_err(got.cpu(), want)
            log(f"[alternate vs plain] fp32, {SIZE}^2, {what} ({gflops[what]:.2f} GFLOP/image): "
                f"max abs err card vs CPU {errs[what]:.3e} (bound {SLICE_ATOL})")
            check(errs[what] <= SLICE_ATOL, f"alternate: the card's fp32 {what} disagrees "
                  "with the CPU")
    readings.update(fp32_card_vs_cpu=errs, gflop_per_image=gflops)
    log(f"[alternate] {smi}")
    return dict(path), kernels, readings


# Precompiled serving (serving_export.py): the experiment of phase 15
# exported through the CLI (default dispatch) and the API (its tuned
# cache), 48 images, 16 a class; and 3 images, one a class, where a
# bucket is one image and the host's launches weigh most.
PRE_BATCH = 48
PRE_SMALL = 3
# The kernels its graphs must replay: K1 and K2 under the default dispatch,
# K3, K4, K2' and K6 under the tuned one (phase 5's winners).
PRECOMPILED_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "medium_tail_chain",
                            "high_tail_chain", "spatial_gate", "res_attn_chain")
# Graph against eager on the same inputs: the same kernels on the same data.
GRAPH_FP32_ATOL = 1e-6
# Cold start in a fresh process: from_experiment, then one route_hard of the
# batch in argv[2]; argv[1] is the bundle ("" for none). With a bundle the
# kernel build directory is an empty one: a build there would show.
COLD_START = """
import json, sys, time
t0 = time.perf_counter()
from pathlib import Path
import numpy as np, torch
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
exp, bundle, images, empty = sys.argv[1:5]
if bundle:
    _build.BUILD_ROOT = Path(empty)
x = np.load(images)
torch.cuda.init()
t1 = time.perf_counter()
d = AdaptiveDehazer.from_experiment(exp, precompiled=bundle or None)
t2 = time.perf_counter()
out, labels = d.route_hard(x)
torch.cuda.synchronize()
t3 = time.perf_counter()
print(json.dumps({"import_s": t1 - t0, "from_experiment_s": t2 - t1, "first_batch_s": t3 - t2,
                  "in_process_s": t3 - t0, "library": str(_build.library_path()),
                  "built_here": any(Path(empty).rglob(_build.LIB_NAME)),
                  "bundle": d._bundle_table is not None, "finite": bool(np.isfinite(out).all())}))
"""


def dispatches(d):
    """Every bundle-backed dispatcher of dehazer d, by program name."""
    return dict(d._dispatches)


def phase_precompiled(dev, smi, exp, nvcc_s):
    """18. Precompiled serving (see the docstring): export through the CLI
    and the API, cold start with and without the bundle in fresh processes,
    graphs against eager at 48 images under both dispatches, a bundle of
    another device refused. Returns the path's launch counts and readings."""
    import subprocess as sp
    import sys
    import warnings

    from adam_dehaze_tpu_torch import cli
    from adam_dehaze_tpu_torch.serving_export import MANIFEST, read_manifest

    default_dir = os.path.join(exp, "precompiled")
    tuned_dir = os.path.join(exp, "precompiled_tuned")
    t0 = time.perf_counter()
    cli.main(["--mode", "export", "--experiment_dir", exp, "--batch_size", str(PRE_BATCH)])
    export_s = time.perf_counter() - t0
    eager = {"default": AdaptiveDehazer.from_experiment(exp, device=dev),
             "tuned": AdaptiveDehazer.from_experiment(exp, autotune=True, device=dev)}
    eager["default"].export_precompiled(default_dir, batch_sizes=(PRE_SMALL,),
                                        queue_buckets=(), device_buckets=())
    eager["tuned"].export_precompiled(tuned_dir, batch_sizes=(PRE_BATCH, PRE_SMALL),
                                      device_buckets=(16, PRE_BATCH))
    manifest = read_manifest(default_dir)
    log(f"[precompiled] export: CLI {export_s:.1f} s, {len(manifest['programs'])} programs + "
        f"{manifest.get('library')}; tuned {len(read_manifest(tuned_dir)['programs'])} programs; "
        f"tuned dispatch {({k: r['best'] for k, r in eager['tuned'].autotune_report.items()})}")
    check(manifest.get("library") and os.path.exists(os.path.join(default_dir,
                                                                    manifest["library"])),
          "precompiled: the bundle holds no kernel library")

    # Cold start: a fresh process each, no bundle (the library built on
    # disk) and the bundle (an empty build directory).
    rng = np.random.default_rng(SEED + 18)
    x = rng.random((PRE_BATCH, SIZE, SIZE, 3), dtype=np.float32)
    images = os.path.join(exp, "precompiled_images.npy")
    np.save(images, x)
    cold = {}
    for tag, bundle in (("eager", ""), ("bundle", default_dir)):
        empty = tempfile.mkdtemp(dir=exp)
        t0 = time.perf_counter()
        proc = sp.run([sys.executable, "-c", COLD_START, exp, bundle, images, empty],
                      capture_output=True, text=True, timeout=300,
                      cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"precompiled: cold start {tag} failed:\n{proc.stderr}")
        cold[tag] = dict(json.loads(proc.stdout.strip().splitlines()[-1]), wall_s=wall)
        check(cold[tag]["finite"] and cold[tag]["bundle"] == bool(bundle),
              f"precompiled: cold start {tag}: {cold[tag]}")
    check(not cold["bundle"]["built_here"]
          and cold["bundle"]["library"].startswith(default_dir),
          f"precompiled: the bundle's process did not load the bundle's library: {cold['bundle']}")
    log(f"[precompiled cold start] fresh process to the first batch of {PRE_BATCH} served "
        f"(from_experiment + route_hard): no bundle {cold['eager']['wall_s']:.2f} s (in the "
        f"process {cold['eager']['in_process_s']:.2f}: import "
        f"{cold['eager']['import_s']:.2f}, from_experiment {cold['eager']['from_experiment_s']:.2f}"
        f", first batch {cold['eager']['first_batch_s']:.2f}), the library already built; "
        f"bundle {cold['bundle']['wall_s']:.2f} s (in the process "
        f"{cold['bundle']['in_process_s']:.2f}: import {cold['bundle']['import_s']:.2f}, "
        f"from_experiment {cold['bundle']['from_experiment_s']:.2f}, first batch with the "
        f"captures {cold['bundle']['first_batch_s']:.2f}), the bundle's library, no nvcc; "
        f"phase 2's nvcc {nvcc_s:.1f} s is what a checkout without a build adds; {smi}")

    # Warm: graphs against eager. The engines are built first (the attach:
    # warm-ups and captures), then the counters go to 0, so that the path's
    # launches are the replays'.
    labels = np.repeat(np.arange(3), PRE_BATCH // 3)
    xd = torch.from_numpy(x).to(dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    graphs = {"default": AdaptiveDehazer.from_experiment(exp, precompiled="auto", device=dev),
              "tuned": AdaptiveDehazer.from_experiment(exp, autotune=True, device=dev,
                                                       precompiled=tuned_dir)}
    t0 = time.perf_counter()
    for d in graphs.values():
        d._binned_engine()
        d._device_binned_fn(16, False)
    torch.cuda.synchronize()
    attach_s = time.perf_counter() - t0
    pool_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    reset_launch_counts()
    outs, path = {}, collections.Counter()
    for kind, d in graphs.items():
        before = counts()
        with torch.inference_mode():
            forced = d.engine(xd, intensity=labels)[0].cpu()
        outs[kind] = (forced, d.route_hard(x), d.route_device_binned(x))
        torch.cuda.synchronize()
        ran = delta(before)
        path.update(ran)
        for y, what in ((forced.numpy(), "forced labels"), (outs[kind][1][0], "route_hard"),
                        (outs[kind][2][0], "route_device_binned")):
            check_images(y, PRE_BATCH, f"precompiled {kind} {what}")
        want = PRECOMPILED_PATH_KERNELS[:2] if kind == "default" else PRECOMPILED_PATH_KERNELS
        check(all(ran[k] > 0 for k in want),
              f"precompiled {kind}: a kernel of the path never ran: {nonzero(ran)}")
        log(f"[precompiled {kind}] launches of forced labels, route_hard and "
            f"route_device_binned through the graphs {nonzero(ran)}")
    readings = {"cold_start": cold, "nvcc_s": nvcc_s, "export_s": export_s,
                "attach_s": attach_s, "graphs_peak_gb": pool_gb}
    for kind, d in graphs.items():
        table = dispatches(d)
        hm = {name: (p.hits, p.misses) for name, p in table.items()}
        check(table and all(m == 0 for _, m in hm.values())
              and all(hm[n][0] > 0 for n in ("classify", "device16_0", "step0", "step1", "step2")),
              f"precompiled {kind}: hits and misses {hm}")
        e = eager[kind]
        dtype_atol = GRAPH_FP32_ATOL if e.dtype == torch.float32 else BF16_ATOL
        with torch.inference_mode():
            want = e.engine(xd, intensity=labels)[0].cpu()
        errs = {"forced": max_err(outs[kind][0], want)}
        for name, (got, lab), (ref, ref_lab) in (
                ("route_hard", outs[kind][1], e.route_hard(x)),
                ("route_device_binned", outs[kind][2], e.route_device_binned(x))):
            check(np.array_equal(lab, ref_lab), f"precompiled {kind} {name}: labels differ")
            errs[name] = float(np.abs(got - ref).max())
        check(max(errs.values()) <= dtype_atol,
              f"precompiled {kind}: graphs against eager {errs} (bound {dtype_atol})")

        def forced_run(dd, n=PRE_BATCH):
            with torch.inference_mode():
                dd.engine(torch.from_numpy(x[:n]).to(dev), intensity=labels[::PRE_BATCH // n]
                          )[0].cpu().numpy()

        ms = {}
        for name, run, n in (
                ("forced_labels", forced_run, PRE_BATCH),
                ("forced_labels_3", lambda dd: forced_run(dd, PRE_SMALL), PRE_SMALL),
                ("route_hard", lambda dd: dd.route_hard(x), PRE_BATCH),
                ("route_device_binned", lambda dd: dd.route_device_binned(x), PRE_BATCH)):
            ms[name] = {tag: route_ms(lambda: run(dd), n) for tag, dd in (("eager", e),
                                                                          ("graphs", d))}
        readings[kind] = dict(max_abs_err=errs, hits_misses=hm, ms_per_image=ms)
        log(f"[precompiled {kind}] graphs vs eager max abs err {errs} (bound {dtype_atol}); "
            f"hits/misses {hm}")
        for name, v in ms.items():
            log(f"[precompiled {kind}] {name} ({PRE_SMALL if name.endswith('_3') else PRE_BATCH}"
                f" images; forced labels one third a class): eager {v['eager'][0]:.3f} ms/image "
                f"(min {v['eager'][1]:.3f}), graphs {v['graphs'][0]:.3f} (min "
                f"{v['graphs'][1]:.3f}); {smi}")
    log(f"[precompiled] the two dehazers' attach (warm-ups and captures of "
        f"{sum(len(p._programs) for d in graphs.values() for p in d._dispatches.values())} "
        f"graphs): {attach_s:.2f} s, {pool_gb:.2f} GB peak")

    # A bundle of another device: refused with the warning, served eagerly.
    other = os.path.join(exp, "precompiled_other")
    shutil.copytree(default_dir, other)
    m = read_manifest(other)
    m["meta"]["device_name"] = "NVIDIA A100-SXM4-80GB"
    with open(os.path.join(other, MANIFEST), "w") as f:
        json.dump(m, f)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        refused = AdaptiveDehazer.from_experiment(exp, precompiled=other, device=dev)
    said = [str(w.message) for w in caught if "device_name" in str(w.message)]
    got, lab = refused.route_hard(x)
    want, want_lab = eager["default"].route_hard(x)
    check(said and refused._bundle_table is None and not refused._dispatches
          and np.array_equal(lab, want_lab) and np.array_equal(got, want),
          f"precompiled: a bundle of another device was not refused as it should be: {said}")
    log(f"[precompiled] a bundle naming another device: refused ({said[0]}); route_hard served "
        f"eagerly, equal to the eager dehazer's")
    del eager, graphs, refused
    torch.cuda.empty_cache()
    return dict(path), readings


def main():
    smi = phase_device()
    dev = torch.device("cuda")
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {seconds[name]:.1f} s")
        return out

    nvcc_s = timed("build", phase_build)
    gen = torch.Generator().manual_seed(SEED)
    kernels, conv_layers = timed("kernels", phase_kernels, dev, gen)
    router = make_router(load_config(), gen)
    rng = np.random.default_rng(SEED)
    x = rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    labels = np.arange(BATCH) % 3
    with tempfile.TemporaryDirectory() as tmp:
        default, outs, default_ms, dispatch, d = timed("slice", phase_slice, router, dev, x,
                                                       labels, gen)
        engines, engine_errs, engine_ms = timed("engines", phase_engines, d, dev, x, labels,
                                                outs[1], smi)
        del d
        torch.cuda.empty_cache()
        # Its own generator, as the conv-layer table's.
        (tail_cache, res_cache), tables, tuned_dispatch = timed(
            "tune", tune_then_force, router, load_config(), dev, tmp, "bf16",
            (TAIL_FORCED, RES_FORCED), torch.Generator().manual_seed(SEED + 3))
        tail, tail_ms = timed("tail slice", phase_forced_slice, router, dev, x, labels, outs,
                              tail_cache, TAIL_FORCED, "tail slice", TAIL_PATH_KERNELS)
        res, res_ms = timed("res slice", phase_forced_slice, router, dev, x, labels, outs,
                            res_cache, RES_FORCED, "res slice", RES_PATH_KERNELS)
        probes = timed("probe tool", phase_probe_tool, dev)
        fp32_caches = timed("slice vs plain", phase_vs_plain, router, dev, rng, tmp)
        del router
        torch.cuda.empty_cache()
        k2_train = timed("K2 gradient", phase_gate_grad, dev,
                         torch.Generator().manual_seed(SEED + 4))
        grad_fns = timed("K5 and K2' gradients", phase_grad_functions, dev,
                         torch.Generator().manual_seed(SEED + 6))
        step_errs = timed("fp32 steps vs CPU", phase_train_step_vs_cpu, dev)
        training, train_readings = timed("training", phase_training, dev, smi, tmp)
        corpus = os.path.join(tmp, "corpus")
        classifier, cls_readings, cls_dir = timed(
            "classifier training", phase_classifier_training, dev, smi, tmp, corpus)
        joint, joint_readings = timed(
            "joint training", phase_joint_training, dev, smi, tmp, corpus, cls_dir,
            os.path.join(tmp, "checkpoints"))
        detection, det_readings = timed("detection", phase_detection, dev, smi, tmp,
                                        os.path.join(tmp, "joint"))
        cli_path, cli_readings, exp = timed("cli", phase_cli, dev, smi, tmp)
        lowres_path, lowres_kernels, lowres_readings = timed(
            "lowres", phase_lowres, dev, smi, exp, (tail_cache, res_cache), fp32_caches)
        alt_path, alt_k2, alt_readings = timed("alternate", phase_alternate, dev, smi, x, labels)
        pre_path, pre_readings = timed("precompiled", phase_precompiled, dev, smi, exp, nvcc_s)
    for name in ("route_hard", "forced_labels", "soft"):
        log(f"[slices] {name}: default dispatch {default_ms[name]:.3f} ms/image, "
            f"tail-chain dispatch {tail_ms[name]:.3f} ms/image, res-chain dispatch "
            f"{res_ms[name]:.3f} ms/image")
    log(f"[phase] all: {sum(seconds.values()):.1f} s")

    paths = {"default": default, "engines": engines, "tail_chain": tail, "res_chain": res,
             "probe_tool": probes, "training": training, "classifier_training": classifier,
             "joint_training": joint, "detection": detection, "cli": cli_path,
             "lowres": lowres_path, "alternate": alt_path, "precompiled": pre_path}
    kernels["cbam_gate"].update(training_forward_ms_per_step=k2_train["forward_ms"],
                                training_backward_ms_per_step=k2_train["backward_ms"])
    for name, rec in grad_fns.items():
        kernels[name].update(function=rec)
    for name, rec in lowres_kernels.items():
        kernels[name].update(lowres=rec)
    kernels["cbam_gate"].update(alternate=alt_k2)
    line = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": sum(path[name] for path in paths.values()),
         "launches_by_path": {tag: path[name] for tag, path in paths.items()},
         **kernels[name]}
        for name, (route, source, replaces) in KERNELS.items()],
        "conv_layers": conv_layers, "autotune_ms_per_16_images": tables,
        "dispatch_ms": {"default": dispatch, "tuned": tuned_dispatch},
        "slice_ms_per_image": {"default": default_ms, "tail_chain": tail_ms,
                               "res_chain": res_ms},
        "routes_ms_per_image": engine_ms, "engines_max_abs_err": engine_errs,
        "training": {"branches": train_readings, "k2": k2_train,
                     "fp32_step_card_vs_cpu": step_errs, "classifier": cls_readings,
                     "joint": joint_readings},
        "detection": det_readings, "cli": cli_readings, "lowres": lowres_readings,
        "alternate": alt_readings, "precompiled": pre_readings,
        "phase_seconds": seconds}
    check(all(k["launches"] > 0 for k in line["kernels"]),
          f"a kernel was launched no time on any path: {line['kernels']}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
