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
   tables (no candidate may fail; the low `canonical` must launch no K1)
   with each winner's `dispatch_ms` (its intercept at 2 and 16 rows, each
   the least of 3 runs, which the tuner measures and the chunk planner is
   fed; where there, at least 1e-3 ms and below the winner's time). The
   cost of one more bucket is read again on the tuned winners over every
   bucket size and printed beside the tuner's intercept, the constant
   AdaptiveDehazer.DISPATCH_MS that stands in for a report without one,
   the planner's overhead rows under each, and DISPATCH_AGAIN more
   measurements of `dispatch_ms` on the same winner (its spread). The two
   forced paths below share this one tuning run.
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
   hold the kernel library) and `export_precompiled` of the tuned dehazer,
   the winners of the experiment's cache (phase 5's) set for this phase to
   PRECOMPILED_FORCED (chain / tail_chain / res_e2b_tail_chain), so that
   its kernels do not hang on a timing; the tuned winners are put back
   after the phase. Cold start in a fresh
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
19. Int8 serving (ops/quant.py; `[int8 ...]` lines). First Q1 and Q2
   alone (launches not counted on any path) at each of the 20 ConvBlock
   shapes that the default branches' int8 copies run at 16 x 256^2 (read
   off forward hooks), bf16, with the Q2 body each takes (tile or gather):
   Q1's int8 values and scales bit for bit; Q2's dequant without BN, with
   and without a bias, bit for bit; Q2 with an eval BN (+ ReLU, as the
   layer has it) in its epilogue within one ulp of its plain version (the
   plain dequant, F.batch_norm, ReLU; the share of elements one ulp off
   and whether all are equal printed); then the same in fp32 on each
   shape's first 2 images. Each timed, Q2 with its epilogue as the path
   runs it, beside its plain version, its bound (Q2's operations over
   1,979 TOPS of int8, or its bytes), the cuDNN bf16 conv of the same
   layer and torch._int_mm on its im2col matrix (the port never calls
   either); the sums over one bucket of each branch are the kernels'
   line. Then,
   counters at 0, `AdaptiveDehazer` with
   `cuda.serving_quant: int8` on seeded full-width weights: route_hard,
   forced labels 0/1/2, route_device_binned and route_switch must launch
   Q1 and Q2 once per Int8Conv2d of every bucket (chunk, image) that ran,
   each layer on its body, and
   K2 six times a high one, and K1, K2', K3, K4, K5 and K6 never; outputs
   finite in [0, 1], the routes' labels route_hard's. PSNR of int8 against
   the unquantized bf16 output per branch (forced labels) above 35 dB; each
   route's warm ms/image beside the bf16 dehazer's, in turns.
   `export_precompiled` must refuse, phase 15's experiment served in int8
   must refuse phase 18's default bundle with a warning, the soft call must
   equal the unquantized one exactly. Last, the fp32 int8 slice (3 images,
   one a class, 128^2) on the card against the CPU, at INT8_DRAWS.
20. parallel/ (`[parallel]` lines) on one card, counters at 0 before each
   path: the card holds one H100, so this shows that the paths are right,
   not that they scale. (a) A gloo group of two processes (this script
   with `--parallel-rank`), both on cuda:0 (NCCL refuses two ranks on one
   device): `shard_train_step` around the soft joint step (make_train_step,
   augmentation and dropout on) of the seeded default router, fp32 with
   TF32 off, on 16 images at 256^2, 8 a rank. (b) A world of one over NCCL:
   the same step through the mesh's NCCL group, and all_hosts_mean_tree.
   Each is held against the single-process step on the same 16 images
   with the same seed: the loss within STEP_LOSS_RTOL, every gradient
   before the optimizer within STEP_GRAD_RTOL of the router's largest, the
   BN running statistics within DP_STATS_RTOL. (c) ExpertParallelRouter on
   [cuda:0] at the default widths, bf16, 16 images, against the soft
   router on the same serving copy, and (d) TwoStagePipeline.run over 4
   batches of 16 against `__call__` on each, at PARALLEL_BF16_ATOL; (c)
   launches K1, K2 six times and K5 once, (d) that four times. Prints the
   warm ms/step and ms/image beside the card's name and power limit.
21. parallel/spatial.py and parallel/sharding.py (`[spatial]` and `[tp]`
   lines) on one card: each part in a gloo group of ranks on cuda:0 (this
   script with `--sharded-rank`), held against the one-process unsharded
   call on the same card and inputs. (a) `route_hard` of the seeded default
   router (its head set so that the 4 images at 512^2 go to low, medium,
   high, low) through `make_spatial_infer` over {"spatial": 2}, bf16 and
   fp32: the labels equal on every rank, the joined shards within
   SHARD_ATOL, each rank's K1 and K2 launches the unsharded call's. (b) The
   medium and high branches' serving copies, bf16 and fp32, 16 images at
   256^2, under `channel_sharding` over {"model": 2}: within SHARD_ATOL, K2
   at 192 local channels in the three 4c AttentionBlocks. (c) The high
   branch at c=16, fp32, 4 images at 128^2, over {"spatial": 2, "model":
   2} (4 ranks): within SLICE_ATOL. (d) `shard_train_step` around a seeded
   low-branch MSE step (fp32, 4 images at 256^2) over {"spatial": 2}
   against the single-process step, at phase 20's bounds. Prints each
   error, launch count and warm ms/image beside the card's name and power
   limit; one card holds every rank, so nothing here shows scaling.
22. The joint steps and the tuned kernels on shards (`[joint sharded]`,
   `[dryrun]` and `[tuned spatial]` lines) on one card, each part's ranks
   in gloo groups on cuda:0, held against the one-process call on the same
   card. (a) The soft joint step (augmentation off, dropout on) of the
   seeded default router, 16 images at 256^2, through `shard_train_step`
   over {"spatial": 2} (this script with `--joint-rank joint`), fp32 with
   TF32 off and bf16 autocast, against the unsharded step (JOINT_BOUNDS:
   fp32 at phase 20's bounds), then its eval step's PSNR and SSIM
   (EVAL_ATOL); K2 and K5 launch on each rank as often as unsharded. (b)
   `python -m adam_dehaze_tpu_torch.parallel.dryrun --devices 8`: data 2 x
   spatial 2 x model 2 on 8 ranks, every section OK on every rank, K2's
   and K5's launches in each rank's step. (c) `route_hard` of the seeded
   default router (its head set so that 4 images at 512^2 go to low,
   medium, high, low) under the tuned dispatch TUNED_FORCED, from a cache
   keyed by the whole image's shape, through `make_spatial_infer` over
   {"spatial": 2} (`--joint-rank tuned`), bf16 and fp32, and K6 alone on
   the high e2b segment on the same shards: within TUNED_ATOL, the labels
   equal, K1, K2, K2', K3, K4 and K6 launched on each rank as often as
   unsharded. (a) runs alone, then (b) beside (c). Prints each error,
   launch count and warm ms/image beside the card's name and power limit;
   one card holds every rank, so nothing here shows scaling.
23. Int8 serving and `cuda.remat` on the spatial and model axes, and a
   converted reference checkpoint (`[int8 shards]`, `[int8 spatial]`,
   `[int8 tp]`, `[remat spatial]` and `[reference checkpoint]` lines), each
   sharded part's ranks in a gloo group on cuda:0 (this script with
   `--int8-shard-rank`), fp32 with TF32 off and bf16, held against the
   one-process unsharded call on the same card. First Q1's two passes
   (`image_absmax`, `quantize_images_at`, for an image split over a
   spatial group) at the shapes of phase 19's int8 bucket on one of 2 H
   shards, per-image ranges spread over 2^-10 to 2^10, bit for bit against
   their plain versions, timed beside them by CUDA events and under the
   profiler (device time), the abs-max beside `torch.linalg.vector_norm`.
   (a) The default router's int8 dehazer on forced labels 0, 1, 2, 0 at
   512^2 through `make_spatial_infer` over {"spatial": 2}, against the
   unsharded int8 by the CPU tests' int8 rule (INT8_SHARD_TOL,
   INT8_MATCH_SHARE); each rank launches Q2 and each of Q1's passes once an
   int8 ConvBlock (8, 21 and 23 a low, medium and high bucket), the one
   launch Q1 never, K2 6 times; one Int8Conv2d of each body (tile 3x3/1 and
   4x4/2, gather 7x7 on RGB) at 512^2: Q1's split and Q2 on the taller
   shard bit for bit the unsharded layer's rows. (b) The high branch's
   int8 copy (c = 96), INT8_TP_ROWS images at 256^2, under
   `channel_sharding` over {"model": 2} by the same rule, launching as
   unsharded; its 4c 3x3 layer on each rank's output slice (the tile body,
   chunk 96) bit for bit. (c) The soft joint step of the default router
   (REMAT_ROWS images at 256^2, fp32) under `cuda.remat: true` over
   {"spatial": 2} against the same sharded step without remat, at phase
   22 (a)'s fp32 bounds; K2 launches twice as often (forward and
   recompute), K5 no less often. (d) A seeded five-state joint `.pth` in
   the reference's layout at the default widths through
   `tools/convert_reference_checkpoint.py`, `_load_joint` and
   `route_hard` (3 images at 128^2, one a class): fp32 on the card against
   the CPU at SLICE_ATOL, bf16 launching K1 and K2. One card holds every
   rank, so nothing here shows scaling.
24. Resizes and adaptive pools on an H shard (`[resize spatial]` lines):
   the ranks in a gloo group on cuda:0 (this script with `--resize-rank`),
   fp32 with TF32 off and bf16, held against the one-process unsharded call
   on the same card. (a) COrunInspiredModel (c = 64: max-pools, align-corners
   upsamples) and DualBranchAttentionModel (c = 96, K2 twice a call), 2
   images at 512^2 over {"spatial": 2}; (c) the default medium and high
   branches at 512 x 490, whose decoders resize W alone: fp32 within
   RESIZE_ATOL, bf16 within phase 21's bound or the unsharded bf16 call's
   own distance from fp32, K2 as often as unsharded. (b) `route_hard` with
   the half-resolution dial on every branch (4 images at 512^2, one a
   branch and low twice) under the default dispatch and the tuned one
   (TUNED_FORCED, phase 22's caches): the labels equal, the output within
   LIFT_K times the guided lift's own float32 error against float64 at
   these images, K1, K2, K2', K3, K4 and K6 a rank as often as unsharded.
   (d) The dial's shrink and lift, corun's upsample and the decoders' W-only
   resizes alone on random maps: fp32 within RESIZE_OP_ATOL, bf16 one bf16
   step, the W-only ones bit for bit. Prints each error, launch count and
   warm ms/image beside the card's name and power limit; one card holds
   every rank, so nothing here shows scaling.
25. The day-one tools (`[tools]` lines), counters at 0 before each tool's
   run. (a) `python -m adam_dehaze_tpu_torch.tools.validate_real_weights
   --selftest` for classifier, branch (high), joint and fcos, four
   processes at once (each runs the converter and then a fresh process that
   restores on the card, fp32, TF32 off): each prints `ok: true` with every
   fp32 diff within FP32_ATOL (fcos: finite levels) and its restore on the
   card; the branch's restore launches K2, the joint's K1, K2 and K5 (its
   tiny evaluation through the soft router). (b) Meanwhile, on phase 15's
   experiment: `rerun_hard_routing_eval` (on the tuned dispatch, K1 where
   the classifier routes a test image low and K2 where it routes one high;
   the labels are printed) and `rerun_detection_eval` (K1, K2, K5) patch
   their keys of comprehensive_results.json and leave the others, the
   detection rerun writes detection_results.json, and `collect_round_results`
   (K1, K2, K5)
   reads the patched rows and writes the routing weights (each true class's
   mean weights summing to 1) and the classifier's accuracy. (c) Then alone
   on the card: `measure_train_throughput` at batch THROUGHPUT_BATCH, 256^2,
   THROUGHPUT_STEPS steps, soft under each `cuda.remat` (K2 and K5), hard
   (K2), and soft without remat again: its JSON line with the card's name
   and power limit. Prints each
   tool's JSON line and seconds.
26. The port's benchmark (`[bench]` lines): `python3 main_torch.py --mode
   bench --full` in a subprocess, on phase 15's experiment
   (BENCH_EXPERIMENT: its test split and trained classifier for the
   trained rows, its resolution policy from phase 16) and phase 5's tuned
   cache with its winners set to BENCH_FORCED (BENCH_AUTOTUNE_CACHE), so
   that every row runs and K3, K4, K2' and K6 serve. It must exit 0; its
   last line names the primary metric with a positive value, mode binned or
   device_binned (never the soft fallback), every row of the full tier
   (BENCH_ROWS), the tuned dispatch and the card's name and power limit; no
   row may be skipped for an exception (a skip for the budget, the tier or
   an absent artifact is a skip; none is expected here). Its `[bench
   launches]` line: K1 and K2 in the balanced primary row, K3, K4, K2' and
   K6 there and in the device-binned row, Q1 and Q2 in the int8 row. Then in
   this process the bench's primary engine in bf16 on the bench's own x and
   balanced labels (the same seeded draw, the same cache), held per image
   against the fp32 modules of each image's branch at BF16_ATOL (TF32 off).
   Prints the line, the launches by row and the phase's seconds.
27. Prints each phase's seconds, the kernels' JSON line (`launches_by_path`
   with "training", "classifier_training", "joint_training", "detection",
   "cli", "lowres", "alternate", "precompiled", "int8", "parallel",
   "spatial", "tp", "joint_sharded", "dryrun", "tuned_spatial",
   "int8_spatial", "int8_tp", "remat_spatial", "reference_checkpoint",
   "resize_alternates", "resize_dial_default", "resize_dial_tuned",
   "resize_decoders", "tools_validate", "tools_rerun_hard_routing",
   "tools_rerun_detection", "tools_collect", "tools_throughput_soft",
   "tools_throughput_hard" and "bench" (every row of the bench's run);
   Q1's two passes as "int8_absmax" and "int8_quantize_at"; K5's
   and K2''s Function readings under "function"; each lowres kernel's
   readings at 128^2 under "lowres", K2's at the alternate branches'
   shapes under "alternate"; the CLI's, the dial's, the alternates',
   precompiled serving's, parallel/'s and phases 22's, 23's and 24's
   readings under "cli", "lowres", "alternate", "precompiled", "parallel",
   "sharded", "joint_sharded", "int8_and_remat_on_shards",
   "resize_on_shards", "tools" and "bench") and, last,
   {"ok": true, "device": ...}.
"""
import collections
import contextlib
import copy
import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
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
    COrunInspiredModel,
    DualBranchAttentionModel,
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
    segment_blocks,
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
from adam_dehaze_tpu_torch.ops.kernels.quant import (
    eval_bn_stats,
    int8_conv,
    int8_conv_fused_reference,
    int8_conv_packed_reference,
    pack_int8_weights,
    quantize_images,
    quantize_images_reference,
)
from adam_dehaze_tpu_torch.ops.quant import Int8Conv2d, quantize_weight_per_channel
from adam_dehaze_tpu_torch.ops.serving_apply import cast_for_serving
from adam_dehaze_tpu_torch.parallel import multihost
from adam_dehaze_tpu_torch.parallel.data_parallel import shard_eval_step, shard_train_step
from adam_dehaze_tpu_torch.parallel.expert_parallel import ExpertParallelRouter
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh, replicate
from adam_dehaze_tpu_torch.parallel.pipeline import TwoStagePipeline
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.serving_autotune import candidate_builders, dispatch_ms
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
    # The int8 path's kernels replace AQT's int8 conv (XLA, not Pallas).
    "int8_quantize": ("cuda", "adam_dehaze_tpu_torch/csrc/int8_conv.cu",
                      "adam_dehaze_tpu/ops/quant.py:34"),
    "int8_conv": ("cuda", "adam_dehaze_tpu_torch/csrc/int8_conv.cu",
                  "adam_dehaze_tpu/ops/quant.py:34"),
    # Q1's two passes apart, for an image split over a spatial group.
    "int8_absmax": ("cuda", "adam_dehaze_tpu_torch/csrc/int8_conv.cu",
                    "adam_dehaze_tpu/ops/quant.py:34"),
    "int8_quantize_at": ("cuda", "adam_dehaze_tpu_torch/csrc/int8_conv.cu",
                         "adam_dehaze_tpu/ops/quant.py:34"),
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


# How many times phase 5 measures each winner's `dispatch_ms` again, for
# its spread on one card.
DISPATCH_AGAIN = 5


def planner_rows(fixed, ms16):
    """The chunk planner's overhead of a branch, in rows: its dispatch cost
    over the winner's ms per row (AdaptiveDehazer._chunk_costs)."""
    return fixed / (max(ms16 - fixed, 1e-6) / 16.0)


def dispatch_cost_ms(d, dev, gen, tag):
    """What one more bucket costs the engine: the part of a branch call
    that does not grow with its rows. Every branch apply of dehazer `d` is
    timed warm at every bucket size (host clock around a synchronize, the
    least of 5 runs); the intercept of the least-squares line through (rows,
    ms) is that branch's fixed cost, printed beside what the chunk planner
    is fed for it under autotune (the tuner's `dispatch_ms`, else the
    constant), the planner's overhead rows under each, and DISPATCH_AGAIN
    more runs of the tuner's own `dispatch_ms` on the same apply. Returns
    {level: intercept}."""
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
        line = (f"[dispatch {tag}] {level}: ms at {list(eng.buckets)} rows "
                f"{[round(v, 3) for v in ms]}: {slope:.4f} ms/row, fixed {fixed[level]:.4f} ms "
                f"({fixed[level] / slope:.2f} rows; bf16, {SIZE}^2)")
        report = d.autotune_report.get(level)
        if report:
            ms16 = report["table"][report["best"]]
            measured = report.get("dispatch_ms")
            constant = AdaptiveDehazer.DISPATCH_MS[level]
            fed = (f"the tuner's dispatch_ms = {measured}" if measured is not None else
                   f"AdaptiveDehazer.DISPATCH_MS = {constant} (the tuner's line did not rise)")
            again = [dispatch_ms(apply, d.router.models[level], (16, SIZE, SIZE, 3), ms16)
                     for _ in range(DISPATCH_AGAIN)]
            line += (f"; under autotune the chunk planner is fed {fed}: "
                     f"{planner_rows(measured or constant, ms16):.2f} overhead rows (the "
                     f"constant {constant}: {planner_rows(constant, ms16):.2f}); dispatch_ms "
                     f"measured {DISPATCH_AGAIN} times more: "
                     f"{[None if v is None else round(v, 4) for v in again]}")
        log(line)
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


def force_winners(cache, forced):
    """A copy of autotune cache `cache` whose winners are `forced` (level ->
    candidate); an entry whose winner changes loses the old winner's
    `dispatch_ms`, so the planner takes the constant for it."""
    cache = copy.deepcopy(cache)
    for key, entry in cache.items():
        best = forced[CLASS_OF[key.split(":")[3]]]
        check(best in entry["table"], f"{key}: {best} was not offered")
        if best != entry["best"]:
            entry.pop("dispatch_ms", None)
        entry["best"] = best
    return cache


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
            f"{json.dumps(report['table'])}, dispatch_ms {report.get('dispatch_ms')} (the "
            f"winner's intercept at 2 and 16 rows; DISPATCH_MS "
            f"{AdaptiveDehazer.DISPATCH_MS[level]})")
        check(report["cached"] is False, f"{level}: a fresh cache gave a hit")
        # dispatch_ms, where the tuner's line rose: within (1e-3, the winner's time].
        check(report.get("dispatch_ms") is None
              or 1e-3 <= report["dispatch_ms"] < report["table"][report["best"]],
              f"{level}: the tuner's dispatch_ms is out of its range: {report}")
        check(all(v is not None for v in report["table"].values()),
              f"{level}: a candidate failed: {report['table']}")
        offered = {name for lvl, name in BUCKET_LAUNCHES if lvl == level}
        check(set(report["table"]) == offered,
              f"{level}: candidates {sorted(report['table'])}, expected {sorted(offered)}")
        tables[level] = dict(best=report["best"], dispatch_ms=report.get("dispatch_ms"),
                             **report["table"])
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
        paths.append(os.path.join(tmp, f"autotune_{tag}_forced{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(force_winners(cache, forced), f)
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
# K3, K4, K2' and K6 under the tuned one, which is forced to
# PRECOMPILED_FORCED so that a slow timing cannot drop one of them.
PRECOMPILED_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "medium_tail_chain",
                            "high_tail_chain", "spatial_gate", "res_attn_chain")
PRECOMPILED_FORCED = {"low": "chain", "medium": "tail_chain", "high": "res_e2b_tail_chain"}
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
    """18. Precompiled serving (see the docstring), the winners of the
    experiment's autotune cache set to PRECOMPILED_FORCED for the phase and
    put back after it. Returns the path's launch counts and readings."""
    cache = os.path.join(exp, "serving_autotune.json")
    tuned = cache + ".tuned"
    os.replace(cache, tuned)
    with open(tuned) as f:
        forced = force_winners(json.load(f), PRECOMPILED_FORCED)
    with open(cache, "w") as f:
        json.dump(forced, f)
    try:
        return _precompiled(dev, smi, exp, nvcc_s)
    finally:
        os.replace(tuned, cache)


def _precompiled(dev, smi, exp, nvcc_s):
    """Phase 18's body: export through the CLI and the API, cold start with
    and without the bundle in fresh processes, graphs against eager at 48
    images under both dispatches, a bundle of another device refused."""
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
    tuned_dispatch = {k: r["best"] for k, r in eager["tuned"].autotune_report.items()}
    log(f"[precompiled] export: CLI {export_s:.1f} s, {len(manifest['programs'])} programs + "
        f"{manifest.get('library')}; tuned {len(read_manifest(tuned_dir)['programs'])} programs; "
        f"tuned dispatch {tuned_dispatch}")
    check(tuned_dispatch == PRECOMPILED_FORCED,
          f"precompiled: the tuned dehazer serves {tuned_dispatch}, not {PRECOMPILED_FORCED}")
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


# Int8 serving (ops/quant.py, phase 19). The peak dense int8 tensor-core
# rate of one H100 SXM at its full power limit.
PEAK_INT8_OPS = 1979e12
# The kernels of the int8 path, and those it must never launch: K1 (the low
# branch runs its modules under int8), K3, K4, K2' and K6 (autotune is off).
INT8_PATH_KERNELS = ("int8_quantize", "int8_conv", "cbam_gate")
INT8_IDLE_KERNELS = ("lightweight_chain", "medium_tail_chain", "high_tail_chain",
                     "spatial_gate", "res_attn_chain", "blend3")
INT8_ROUTES = ("route_hard", "forced_labels", "route_device_binned", "route_switch")
# tests/test_quant.py's bar for int8 against the unquantized output.
INT8_PSNR_DB = 35.0
# The fp32 int8 slice, card vs CPU (3 images, one a class, at 128^2). Both
# sides run the same int8 sums, exact; but the layers outside them (the
# heads, the ConvTransposes, the attention MLPs, BN) are cuDNN's and
# cuBLAS's float32 sums in another order (the unquantized fp32 slice reads
# up to 1e-3 apart, SLICE_ATOL), and such a difference moves some values
# across a rounding boundary of the next quantizer: one int8 level
# (max|x| / 127.5) at that input. The layers after it see inputs a level
# apart and flip more, so over some 40 int8 layers the two outputs become
# two draws of the quantization noise around the fp32 output, and two
# independent draws differ by about sqrt(2) times the noise. The bound:
# the card-vs-CPU error's mean within INT8_DRAWS times the mean of the
# noise (int8 against fp32, both on the CPU) and its max within twice the
# noise's max. That is looser than the per-layer bound (bit for bit, one
# ulp) by the whole quantization noise; a wrong scale, layout or tap moves
# the output by many times the noise.
INT8_CPU_SIZE = SIZE // 2
INT8_DRAWS = 1.5


def ulp_steps(got, want):
    """Per element, the distance between two float32 or bfloat16 tensors in
    units in the last place of their type (the bit patterns mapped to
    integers in the order of the values, so that -0 and +0 coincide)."""
    as_int, low = ((torch.int16, -(1 << 15)) if got.dtype == torch.bfloat16
                   else (torch.int32, -(1 << 31)))

    def ordered(t):
        i = t.view(as_int).long()
        return torch.where(i < 0, low - i, i)
    return (ordered(got) - ordered(want)).abs()


def ulps(got, want):
    """The largest of `ulp_steps`."""
    return int(ulp_steps(got, want).max())


def int8_layers(d, dev):
    """The Int8Conv2d calls of one bucket of each int8 branch of dehazer d
    at (BATCH, SIZE, SIZE, 3): {(geometry, NHWC input shape): calls}, which
    of those layers have a ReLU after their BN, and the Int8Conv2d count of
    each branch by body."""
    layers, relus, per_branch = collections.Counter(), {}, {}
    x = torch.rand(BATCH, SIZE, SIZE, 3, device=dev)

    def seen(mod, inp, out):
        key = (mod.geometry, tuple(inp[0].permute(0, 2, 3, 1).shape))
        layers.update({key: 1})
        relus[key] = relus.get(key, False) or mod.relu
    for lvl in INTENSITY_ORDER:
        model = d._hard.models[lvl]
        convs = [m for m in model.modules() if isinstance(m, Int8Conv2d)]
        per_branch[lvl] = collections.Counter(m.geometry.body for m in convs)
        hooks = [m.register_forward_hook(seen) for m in convs]
        with torch.inference_mode():
            model(x)
        for h in hooks:
            h.remove()
    return layers, relus, per_branch


def int_mm_operands(x, qw, geo):
    """torch._int_mm's operands for one layer: the (M, K) im2col matrix of
    Q1's output and the (K, N) weights in its K order (a column-major
    view), N padded to 64 on the gather body as its packing is."""
    q = quantize_images_reference(x, geo.cin_pad)[0]
    a = im2col_int8(q, geo)
    if geo.body == "gather":
        return a, pack_int8_weights(qw, geo).t()
    ohwi = torch.nn.functional.pad(qw, (0, 0, 0, 0, 0, geo.cin_pad - geo.cin)).permute(0, 2, 3, 1)
    return a, ohwi.reshape(geo.cout, -1).t()


def im2col_int8(q, geo):
    """The (M, k_pad) int8 im2col matrix of Q1's output, K ordered as the
    packed weights (ky, kx, ci): what torch._int_mm multiplies."""
    n, h, w, c = q.shape
    p = geo.padding
    qp = torch.nn.functional.pad(q, (0, 0, p, p, p, p))
    ho, wo = geo.out_size(h, w)
    s = qp.stride()
    cols = qp.as_strided((n, ho, wo, geo.kh, geo.kw, c),
                         (s[0], s[1] * geo.stride, s[2] * geo.stride, s[1], s[2], s[3]))
    a = cols.reshape(n * ho * wo, geo.kh * geo.kw * c)
    return torch.nn.functional.pad(a, (0, geo.k_pad - a.shape[1])).contiguous()


def random_eval_bn(cout, gen, dev):
    """An eval BatchNorm2d with seeded statistics and affine parameters."""
    bn = torch.nn.BatchNorm2d(cout).eval().requires_grad_(False)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(cout, generator=gen))
        bn.bias.copy_(torch.randn(cout, generator=gen) * 0.5)
        bn.running_mean.copy_(torch.randn(cout, generator=gen) * 0.2)
        bn.running_var.copy_(torch.rand(cout, generator=gen) + 0.1)
    return bn.to(dev)


def check_int8_layer(dev, gen, geo, shape, relu, dtype, timed):
    """Q1 and Q2 at one ConvBlock shape against their plain versions: Q1's
    int8 values and scales bit for bit; Q2's dequant (no BN, with and
    without a bias) bit for bit; Q2 with an eval BN (+ ReLU where the layer
    has one) within one ulp of its plain version (`int8_conv_fused_reference`:
    the plain dequant, F.batch_norm, ReLU), the share of elements one ulp
    off recorded. With `timed`: each timed (Q2 with its epilogue) beside its
    plain version, its bound, the cuDNN conv in bf16 and torch._int_mm on
    the im2col matrix."""
    x = torch.rand(shape, generator=gen) if shape[-1] == 3 else torch.relu(
        torch.randn(shape, generator=gen))
    x = x.to(dtype).to(dev)
    fan_in = geo.kh * geo.kw * geo.cin
    w = (torch.randn((geo.cout, geo.cin, geo.kh, geo.kw), generator=gen)
         * fan_in ** -0.5).to(dtype).to(dev)
    bias = (torch.randn(geo.cout, generator=gen) * 0.1).to(dtype).float().to(dev)
    bn = random_eval_bn(geo.cout, gen, dev)
    stats = eval_bn_stats(bn)
    qw, sw = quantize_weight_per_channel(w)
    packed, sw = pack_int8_weights(qw, geo), sw.float()
    with torch.inference_mode():
        q, sx = quantize_images(x, geo.cin_pad)
        q0, sx0 = quantize_images_reference(x, geo.cin_pad)
        q1_equal = bool(torch.equal(q, q0) and torch.equal(sx, sx0))
        q1_err = max(max_err(q, q0), max_err(sx, sx0))
        dequant_equal = True
        for b in (bias, None):      # y0 ends as the plain dequant without a bias
            y = int8_conv(q, sx, packed, sw, b, geo, dtype)
            y0 = int8_conv_packed_reference(q, sx, packed, sw, b, geo, dtype)
            dequant_equal = dequant_equal and bool(torch.equal(y, y0))
        # A ConvBlock with BN has no conv bias.
        fused = int8_conv(q, sx, packed, sw, None, geo, dtype, bn, stats, relu)
        plain = int8_conv_fused_reference(q, sx, packed, sw, None, geo, dtype, bn, relu)
        steps = ulp_steps(fused, plain)
        rec = dict(shape=list(shape), cin=geo.cin, cout=geo.cout, kernel=geo.kh,
                   stride=geo.stride, body=geo.body, n_chunk=geo.n_chunk, relu=relu,
                   q1_bitwise=q1_equal, q1_max_abs_err=q1_err, q2_dequant_bitwise=dequant_equal,
                   q2_fused_bitwise=bool(torch.equal(fused, plain)),
                   q2_fused_max_ulp=int(steps.max()),
                   q2_fused_share_one_ulp=float((steps == 1).float().mean()),
                   q2_max_abs_err=max_err(fused, plain))
        del y, steps, plain
    what = f"{shape} {geo.cin}->{geo.cout} {geo.kh}x{geo.kw}/{geo.stride} {geo.body} {dtype}"
    check(q1_equal, f"int8: Q1 differs from its plain version at {what}")
    check(dequant_equal, f"int8: Q2's dequant differs from its plain version at {what}")
    check(rec["q2_fused_max_ulp"] <= 1,
          f"int8: Q2's BN epilogue is {rec['q2_fused_max_ulp']} ulp from its plain version "
          f"at {what}")
    if not timed:
        return rec
    n, h, wd, _ = shape
    ho, wo = geo.out_size(h, wd)
    m = n * ho * wo
    xn = x.permute(0, 3, 1, 2)
    with torch.inference_mode():
        a, bt = int_mm_operands(x, qw, geo)
        rec.update(
            q1_ms=cuda_ms(lambda: quantize_images(x, geo.cin_pad)),
            q1_plain_ms=cuda_ms(lambda: quantize_images_reference(x, geo.cin_pad), 3, 1),
            q2_ms=cuda_ms(lambda: int8_conv(q, sx, packed, sw, None, geo, dtype, bn, stats,
                                            relu)),
            q2_plain_ms=cuda_ms(lambda: int8_conv_fused_reference(
                q, sx, packed, sw, None, geo, dtype, bn, relu), 2, 1),
            cudnn_bf16_ms=cuda_ms(lambda: torch.nn.functional.conv2d(
                xn, w, stride=geo.stride, padding=geo.padding)),
            int_mm_ms=cuda_ms(lambda: torch._int_mm(a, bt)))
    rec["q1_bound"] = bound(4 * x.numel(), nbytes(x, sx) + n * h * wd * geo.cin_pad,
                            PEAK_F32_FLOPS)
    rec["q2_bound"] = bound(conv_flops(m, geo.kh * geo.kw, geo.cin, geo.cout),
                            n * h * wd * geo.cin + nbytes(qw, sx, sw) + nbytes(fused),
                            PEAK_INT8_OPS)
    rec["q2_tops"] = rec["q2_bound"]["flops"] / (rec["q2_ms"] * 1e-3) / 1e12
    log(f"[int8 layer] {tuple(shape)} {geo.cin}->{geo.cout} {geo.kh}x{geo.kw}/{geo.stride} "
        f"{geo.body} N={geo.n_chunk}{' relu' if relu else ''}: "
        f"Q1 {rec['q1_ms']:.3f} ms (plain {rec['q1_plain_ms']:.3f}, bound "
        f"{rec['q1_bound']['bound_ms']:.3f} by {rec['q1_bound']['bound_by']}); Q2 "
        f"{rec['q2_ms']:.3f} ms, {rec['q2_tops']:.0f} TOPS (plain {rec['q2_plain_ms']:.3f}, "
        f"bound {rec['q2_bound']['bound_ms']:.3f} by {rec['q2_bound']['bound_by']}); "
        f"cuDNN bf16 {rec['cudnn_bf16_ms']:.3f} ms, _int_mm {rec['int_mm_ms']:.3f} ms; "
        f"Q1 bitwise, dequant bitwise; BN epilogue at most {rec['q2_fused_max_ulp']} ulp from "
        f"its plain version, one ulp off on {100 * rec['q2_fused_share_one_ulp']:.4f} % of "
        f"elements, bitwise {rec['q2_fused_bitwise']}")
    del a, bt, q, q0, y0, fused
    return rec


def int8_kernel_totals(rows, layers):
    """The per-layer readings summed over one bucket of each branch (each
    shape times its calls), as the kernels' JSON line takes them."""
    q1, q2 = collections.Counter(), collections.Counter()
    b1, b2 = collections.Counter(), collections.Counter()
    for row, calls in zip(rows, layers.values()):
        for key in ("ms", "plain_ms"):
            q1[key] += calls * row[f"q1_{key}"]
            q2[key] += calls * row[f"q2_{key}"]
        q2[f"{row['body']}_ms"] += calls * row["q2_ms"]
        for key in ("cudnn_bf16_ms", "int_mm_ms"):
            q2[key] += calls * row[key]
        for tot, b in ((b1, row["q1_bound"]), (b2, row["q2_bound"])):
            for key in ("bound_ms", "bytes", "flops"):
                tot[key] += calls * b[key]
    per = f"one {BATCH}-image bucket of each int8 branch ({sum(layers.values())} convs)"

    def rec(t, b, tag, peak):
        return dict(t, bound_ms=b["bound_ms"], bytes=b["bytes"], flops=b["flops"],
                    bound_by="bytes" if b["bytes"] / PEAK_BYTES_S >= b["flops"] / peak
                    else "operations",
                    max_abs_err=max(r[f"{tag}_max_abs_err"] for r in rows), library_ms=None,
                    per=per, shapes=len(rows))
    for body in ("tile", "gather"):
        q2.setdefault(f"{body}_ms", 0.0)
    return rec(q1, b1, "q1", PEAK_F32_FLOPS), rec(q2, b2, "q2", PEAK_INT8_OPS)


def psnr_db(a, b):
    mse = ((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean(axis=(1, 2, 3))
    return 10.0 * np.log10(1.0 / np.maximum(mse, 1e-20))


def phase_int8(dev, smi, x, labels, exp):
    """19. Int8 serving (see the docstring): Q1 and Q2 at every ConvBlock
    shape of the default branches, the int8 slice through the normal entry
    points with the counters at 0, the refusals and the soft call, the fp32
    int8 slice card vs CPU. Returns the path's launch counts, Q1's and Q2's
    records for the kernels' line and the phase's readings."""
    gen = torch.Generator().manual_seed(SEED + 9)
    cfg = load_config()
    cfg8 = load_config(overrides={"cuda": {"serving_quant": "int8"}})
    router = make_router(cfg, gen)
    d16 = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev)
    d8 = AdaptiveDehazer(copy.deepcopy(router), None, cfg8, device=dev)
    layers, relus, bodies = int8_layers(d8, dev)
    n_convs = {lvl: sum(c.values()) for lvl, c in bodies.items()}
    log(f"[int8] Int8Conv2d per branch {n_convs}, by body "
        f"{ {lvl: dict(c) for lvl, c in bodies.items()} }; {len(layers)} distinct ConvBlock "
        f"shapes, {sum(layers.values())} calls a bucket of each branch")
    rows = [check_int8_layer(dev, gen, geo, shape, relus[(geo, shape)], torch.bfloat16, True)
            for geo, shape in layers]
    # fp32 once: each shape's first 2 images (the kernels treat images alike).
    fp32 = [check_int8_layer(dev, gen, geo, (2,) + shape[1:], relus[(geo, shape)],
                             torch.float32, False) for geo, shape in layers]
    for r in fp32:
        log(f"[int8 fp32] {tuple(r['shape'])} {r['cin']}->{r['cout']} {r['kernel']}x"
            f"{r['kernel']}/{r['stride']} {r['body']}: Q1 bitwise, dequant bitwise; BN epilogue "
            f"at most {r['q2_fused_max_ulp']} ulp from its plain version, one ulp off on "
            f"{100 * r['q2_fused_share_one_ulp']:.4f} % of elements, bitwise "
            f"{r['q2_fused_bitwise']}")
    q1_rec, q2_rec = int8_kernel_totals(rows, layers)
    q2_rec.update(
        bodies={f"{r['cin']}->{r['cout']} {r['kernel']}x{r['kernel']}/{r['stride']} at "
                f"{r['shape'][1]}^2": r["body"] for r in rows},
        fused_max_ulp_bf16=max(r["q2_fused_max_ulp"] for r in rows),
        fused_share_one_ulp_bf16=max(r["q2_fused_share_one_ulp"] for r in rows),
        fused_max_ulp_fp32=max(r["q2_fused_max_ulp"] for r in fp32),
        fused_share_one_ulp_fp32=max(r["q2_fused_share_one_ulp"] for r in fp32),
        fused_bitwise=all(r["q2_fused_bitwise"] for r in rows + fp32))
    log(f"[int8 Q1] per {q1_rec['per']}: {q1_rec['ms']:.3f} ms, plain {q1_rec['plain_ms']:.3f} "
        f"ms, bound {q1_rec['bound_ms']:.3f} ms ({q1_rec['bound_by']})")
    log(f"[int8 Q2] per {q2_rec['per']}: {q2_rec['ms']:.3f} ms, plain {q2_rec['plain_ms']:.3f} "
        f"ms, bound {q2_rec['bound_ms']:.3f} ms ({q2_rec['bound_by']}); cuDNN bf16 "
        f"{q2_rec['cudnn_bf16_ms']:.3f} ms, _int_mm {q2_rec['int_mm_ms']:.3f} ms; tile body "
        f"{q2_rec['tile_ms']:.3f} ms, gather body {q2_rec['gather_ms']:.3f} ms; BN epilogue "
        f"against its plain version: bf16 at most {q2_rec['fused_max_ulp_bf16']} ulp (one ulp "
        f"off on at most {100 * q2_rec['fused_share_one_ulp_bf16']:.4f} % of a layer's "
        f"elements), fp32 at most {q2_rec['fused_max_ulp_fp32']} ulp (at most "
        f"{100 * q2_rec['fused_share_one_ulp_fp32']:.4f} %), all bitwise "
        f"{q2_rec['fused_bitwise']}")
    torch.cuda.empty_cache()

    # The int8 slice through the entry points, counters at 0.
    xd = torch.from_numpy(x).to(dev)
    reset_launch_counts()
    hard, hard_lab = d8.route_hard(x)
    torch.cuda.synchronize()
    hard_d = counts()
    before = counts()
    with torch.inference_mode():
        forced = d8.engine(xd, intensity=labels)[0].cpu().numpy()
    forced_d = delta(before)
    before = counts()
    dev_out, dev_lab = d8.route_device_binned(x)
    dev_d = delta(before)
    before = counts()
    sw_out, sw_lab = d8.route_switch(x)
    sw_d = delta(before)
    path = counts()
    path_bodies = dict(int8_conv.body_launches)
    n8 = [n_convs[lvl] for lvl in INTENSITY_ORDER]

    def expect(per_class):
        q = sum(b * n for b, n in zip(per_class, n8))
        return nonzero({"int8_quantize": q, "int8_conv": q, "cbam_gate": 6 * per_class[2]})

    def expect_bodies(per_class):
        return {body: sum(b * bodies[lvl][body] for b, lvl in zip(per_class, INTENSITY_ORDER))
                for body in int8_conv.body_launches}

    classes = {"route_hard": buckets_per_class(d8.engine, hard_lab),
               "forced labels": buckets_per_class(d8.engine, labels),
               "route_device_binned": chunks(dev_lab, 16),
               "route_switch": np.bincount(sw_lab, minlength=3).tolist()}
    for what, got in (("route_hard", hard_d), ("forced labels", forced_d),
                      ("route_device_binned", dev_d), ("route_switch", sw_d)):
        check(nonzero(got) == expect(classes[what]),
              f"int8 {what}: launches {nonzero(got)}, expected {expect(classes[what])}")
    want_bodies = collections.Counter()
    for per_class in classes.values():
        want_bodies.update(expect_bodies(per_class))
    check(path_bodies == dict(want_bodies),
          f"int8: Q2's launches by body {path_bodies}, expected {dict(want_bodies)}")
    for y, what in ((hard, "route_hard"), (forced, "forced labels"),
                    (dev_out, "route_device_binned"), (sw_out, "route_switch")):
        check_images(y, BATCH, f"int8 {what}")
    check(np.array_equal(dev_lab, hard_lab) and np.array_equal(sw_lab, hard_lab),
          "int8: the routes' labels differ from route_hard's")
    check(all(path[k] > 0 for k in INT8_PATH_KERNELS)
          and all(path[k] == 0 for k in INT8_IDLE_KERNELS),
          f"int8: launches on the path {nonzero(path)}")
    log(f"[int8 slice] route_hard intensities {np.bincount(hard_lab, minlength=3).tolist()}; "
        f"launches: route_hard {nonzero(hard_d)}, forced labels {nonzero(forced_d)}, "
        f"device-binned {nonzero(dev_d)}, switch {nonzero(sw_d)}; Q2 by body over the four "
        f"routes {path_bodies} (one per Int8Conv2d call on its layer's body)")

    # int8 against the unquantized bf16 output, per branch (forced labels).
    with torch.inference_mode():
        ref = d16.engine(xd, intensity=labels)[0].cpu().numpy()
    psnr = {lvl: psnr_db(forced[labels == c], ref[labels == c])
            for c, lvl in enumerate(INTENSITY_ORDER)}
    for lvl, p in psnr.items():
        log(f"[int8 psnr] {lvl}: int8 vs unquantized bf16, min {p.min():.2f} dB, mean "
            f"{p.mean():.2f} dB over {len(p)} images (bar {INT8_PSNR_DB} dB)")
    check(all(p.min() > INT8_PSNR_DB for p in psnr.values()),
          "int8: a branch's output is within 35 dB of the unquantized one")

    # Each route's ms/image, int8 beside bf16, in turns.
    def runs(d):
        def forced_run():
            with torch.inference_mode():
                d.engine(torch.from_numpy(x).to(dev), intensity=labels)[0].cpu()
        return {"route_hard": lambda: d.route_hard(x), "forced_labels": forced_run,
                "route_device_binned": lambda: d.route_device_binned(x),
                "route_switch": lambda: d.route_switch(x)}
    ms = {"int8": {}, "bf16": {}}
    for route in INT8_ROUTES:
        for tag, d in (("bf16", d16), ("int8", d8)):
            ms[tag][route] = route_ms(runs(d)[route], BATCH)[0]
        log(f"[int8 routes] {route}: int8 {ms['int8'][route]:.3f} ms/image, bf16 "
            f"{ms['bf16'][route]:.3f} ms/image ({BATCH} images at {SIZE}^2; {smi})")

    # The refusals and the soft call.
    try:
        d8.export_precompiled(os.path.join(exp, "int8_bundle"))
        refused = False
    except ValueError:
        refused = True
    check(refused, "int8: export_precompiled did not refuse")
    cfg_exp = load_config(os.path.join(exp, "config.yaml"))
    cfg_exp["cuda"]["serving_quant"] = "int8"
    int8_cfg = os.path.join(exp, "config_int8.yaml")
    with open(int8_cfg, "w") as f:
        json.dump({k: v for k, v in cfg_exp.items() if not k.startswith("_")}, f)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bundled = AdaptiveDehazer.from_experiment(exp, config_path=int8_cfg,
                                                  precompiled="auto", device=dev)
    said = [str(w.message) for w in caught if "quant" in str(w.message)]
    check(said and bundled._bundle_table is None and bundled.quant == "int8",
          f"int8: the default bundle was not refused: {said}")
    check(np.array_equal(d8(x), d16(x)), "int8: the soft call is not the unquantized one")
    log(f"[int8] export_precompiled refused; a default bundle refused ({said[0]}); the soft "
        "call equals the unquantized soft call")
    del bundled, d16, d8
    torch.cuda.empty_cache()

    # The fp32 int8 slice, card vs CPU, 3 images (one a class) at 128^2.
    xs = np.ascontiguousarray(x[:3, ::2, ::2])
    lab = np.arange(3)
    outs = {}
    for tag, device, quant in (("card", dev, "int8"), ("cpu", "cpu", "int8"),
                               ("cpu_f32", "cpu", None)):
        c = load_config(overrides={"cuda": {"compute_dtype": "float32", "serving_quant": quant}})
        d = AdaptiveDehazer(copy.deepcopy(router), None, c, device=device)
        with torch.inference_mode():
            outs[tag] = d.engine(torch.from_numpy(xs).to(device), intensity=lab)[0].cpu()
        del d
    err = (outs["card"] - outs["cpu"]).abs()
    noise = (outs["cpu"] - outs["cpu_f32"]).abs()
    log(f"[int8 fp32 card vs CPU] {INT8_CPU_SIZE}^2: max {float(err.max()):.3e}, mean "
        f"{float(err.mean()):.3e}; the int8 noise (int8 vs fp32 on the CPU) max "
        f"{float(noise.max()):.3e}, mean {float(noise.mean()):.3e}")
    check(float(err.mean()) <= INT8_DRAWS * float(noise.mean())
          and float(err.max()) <= 2 * float(noise.max()),
          "int8: the fp32 slice on the card disagrees with the CPU")
    readings = dict(layers=rows, layers_fp32=fp32, int8_convs_per_branch=n_convs,
                    int8_convs_by_body={lvl: dict(c) for lvl, c in bodies.items()},
                    q2_launches_by_body=path_bodies, ms_per_image=ms,
                    psnr_db={k: dict(min=float(p.min()), mean=float(p.mean()))
                             for k, p in psnr.items()},
                    fp32_card_vs_cpu=dict(max=float(err.max()), mean=float(err.mean()),
                                          noise_max=float(noise.max()),
                                          noise_mean=float(noise.mean())))
    log(f"[int8] {smi}")
    q2_rec["launches_by_body"] = path_bodies
    return dict(path), {"int8_quantize": q1_rec, "int8_conv": q2_rec}, readings


# The parallel phase (parallel/): the data-parallel joint step on 2 ranks
# of one card and on a world of one over NCCL, each held against the
# single-process step on the same 16 images with the same seed (fp32, TF32
# off); the expert-parallel router and the two-stage pipeline on [cuda:0].
# One card holds both ranks of (a), so nothing here shows scaling.
DP_ROWS = 16
DP_TIMEOUT_S = 300
# Data-parallel step against the single-process step, fp32 (TF32 off): the
# same operations with the batch's sums split in two and added (the
# convolutions' weight gradients, the synchronized BN's statistics, the
# all_reduce), so they differ by fp32 reordering only. The bounds are the
# fp32 card checks' of phase 10: the loss within STEP_LOSS_RTOL relative,
# every gradient within STEP_GRAD_RTOL of the router's largest gradient;
# the BN running statistics within DP_STATS_RTOL of the BN's scale: the
# largest sqrt(running_var) for running_mean, the largest running_var for
# itself. fp32 sums of 16 x 256^2 values a channel taken in another order
# err by a few eps of the values' magnitude, the spread, not of their mean,
# which can cancel to near 0 (a CPU rehearsal at 4 x 32^2 read up to
# 5.8e-5 of a running_mean's own largest magnitude, and up to 5.1e-6 of
# the BN's scale on any statistic).
DP_STATS_RTOL = 1e-4
# ExpertParallelRouter and TwoStagePipeline against the soft router, bf16:
# the same modules and kernels on the same inputs on one device, so they
# read 0; the bound allows one bf16 rounding step of a [0, 1] value.
PARALLEL_BF16_ATOL = 2.0 ** -8
PARALLEL_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "blend3")


def dp_config():
    """The joint step's config: the default widths in fp32, nothing to
    graft."""
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    cfg["classifier"]["checkpoint_dir"] = cfg["dehazing"]["checkpoint_dir"] = "absent"
    return cfg


def dp_batch(dev):
    rng = np.random.default_rng(SEED + 20)
    return {"hazy": torch.from_numpy(rng.random((DP_ROWS, SIZE, SIZE, 3), dtype=np.float32))
            .to(dev),
            "clear": torch.from_numpy(rng.random((DP_ROWS, SIZE, SIZE, 3), dtype=np.float32))
            .to(dev),
            "intensity": torch.arange(DP_ROWS, device=dev) % 3}


def dp_joint_step(dev, mesh=None):
    """One soft joint step (augmentation and dropout on) of the seeded
    default router on the 16 images, through shard_train_step when a mesh
    is given; then 3 more, the last 2 timed. Returns the first step's
    metrics, gradients and BN statistics (on the CPU), its launches and the
    warm ms/step."""
    cfg = dp_config()
    router, state = tj.build_router_state(cfg, dev)
    joint_loss = get_joint_loss(cfg)
    nets = tj._loss_params(joint_loss, dev)
    batch = dp_batch(dev)
    step = tj.make_train_step(joint_loss, nets, augmentation=True)
    if mesh is not None:
        replicate(mesh, state)
        step = shard_train_step(step, mesh, batch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    reset_launch_counts()
    metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = counts()
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad.detach().cpu() for n, p in router.named_parameters()
                     if p.grad is not None},
           "stats": {k: v.detach().cpu() for k, v in router.state_dict().items()
                     if "running" in k}}
    out["warm_ms"] = warm_ms(lambda: step(state, batch, gen), runs=2)[1]
    return out, launches


def parallel_rank(rank, port, out_dir):
    """One rank of phase 20 (a): `python3 chip_smoke.py --parallel-rank
    RANK PORT OUT_DIR`."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # Both ranks drive the one card. NCCL refuses two ranks on one device,
    # so this group is gloo over CUDA tensors, started here rather than by
    # multihost.initialize (which takes NCCL for a CUDA device): a choice
    # made for one card, not a fallback.
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=2, rank=rank)
    try:
        out, launches = dp_joint_step(dev, make_mesh(None, [dev, dev]))
        out["launches"] = launches
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(tmp):
    """Phase 20 (a): both ranks in their own processes; what they saved."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(rank), str(port), tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    try:
        logs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"parallel rank {rank} failed:\n{text}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True) for r in (0, 1)]


def dp_errors(got, want, what, smi, tag="parallel",
              bounds=(STEP_LOSS_RTOL, STEP_GRAD_RTOL, DP_STATS_RTOL)):
    """A data-parallel step against the single-process one (see
    DP_STATS_RTOL; `bounds` the loss's, the gradients' and the BN
    statistics'): checked, logged, returned."""
    loss_rtol, grad_rtol, stats_rtol = bounds
    loss = abs(got["metrics"]["total"] - want["metrics"]["total"]) / abs(want["metrics"]["total"])
    g_max = max(float(g.abs().max()) for g in want["grads"].values())
    check(set(got["grads"]) == set(want["grads"]), f"{what}: other tensors have a gradient")
    grad = {n: max_err(got["grads"][n], g) for n, g in want["grads"].items()}
    own = {n: grad[n] / float(g.abs().max()) for n, g in want["grads"].items()
           if float(g.abs().max()) > ZERO_GRAD * g_max}
    stats = {k: max_err(got["stats"][k], v) / float(
        want["stats"][k.replace("running_mean", "running_var")].sqrt().max()
        if k.endswith("running_mean") else v.max()) for k, v in want["stats"].items()}
    worst = {"grad": max(grad, key=grad.get), "own": max(own, key=own.get),
             "stats": max(stats, key=stats.get)}
    errs = dict(loss_rel=loss, grad_of_max=grad[worst["grad"]] / g_max,
                grad_own_max=own[worst["own"]], stats_rel=stats[worst["stats"]],
                metrics={k: (got["metrics"][k], want["metrics"][k]) for k in want["metrics"]})
    log(f"[{tag}] {what} vs the single-process step: loss {got['metrics']['total']:.7f} vs "
        f"{want['metrics']['total']:.7f} (rel err {loss:.2e}, bound {loss_rtol}); "
        f"{len(grad)} gradients, largest error {errs['grad_of_max']:.2e} of the router's "
        f"max|g| ({worst['grad']}; bound {grad_rtol}), in its own units at most "
        f"{errs['grad_own_max']:.2e} ({worst['own']}; a reading); {len(stats)} BN "
        f"statistics, at most {errs['stats_rel']:.2e} of their BN's scale ({worst['stats']}; "
        f"bound {stats_rtol}); {smi}")
    check(loss <= loss_rtol, f"{what}: the loss differs from the single-process step's")
    check(errs["grad_of_max"] <= grad_rtol,
          f"{what}: the gradient of {worst['grad']} differs from the single-process step's")
    check(errs["stats_rel"] <= stats_rtol,
          f"{what}: the BN statistic {worst['stats']} differs from the single-process step's")
    return errs


def phase_parallel(dev, smi, tmp, x):
    """20. parallel/ on one card (see the docstring). Returns the path's
    launch counts and the phase's readings."""
    path = collections.Counter()
    readings = {}
    torch.cuda.empty_cache()
    # (a) 2 ranks of one gloo group, both on cuda:0, each 8 of the 16 rows.
    dp_dir = os.path.join(tmp, "parallel")
    os.makedirs(dp_dir)
    ranks = spawn_ranks(dp_dir)
    for out in ranks:
        path.update(out["launches"])
    # The yardstick: the single-process step (its launches are not the path's).
    single, single_launches = dp_joint_step(dev)
    errs = {f"rank{r}": dp_errors(out, single, f"(a) 2 ranks on one card, rank {r}", smi)
            for r, out in enumerate(ranks)}
    # (b) a world of one over NCCL.
    dist = torch.distributed
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh()
        check(dist.get_backend(mesh.group("data")) == "nccl", "(b): the mesh's group is not NCCL")
        one, one_launches = dp_joint_step(dev, mesh)
        mean = multihost.all_hosts_mean_tree(one["metrics"])
        check(mean == one["metrics"], f"(b): all_hosts_mean_tree of one process {mean}")
    finally:
        dist.destroy_process_group()
    path.update(one_launches)
    errs["world_of_one"] = dp_errors(one, single, "(b) a world of one over NCCL", smi)
    readings["data_parallel"] = dict(
        errors=errs, launches_per_rank=[nonzero(r["launches"]) for r in ranks],
        world_of_one_launches=nonzero(one_launches), single_launches=nonzero(single_launches),
        ms_per_step={"two_ranks_one_card": [r["warm_ms"] for r in ranks],
                     "world_of_one": one["warm_ms"], "single_process": single["warm_ms"]})
    log(f"[parallel] joint step, {DP_ROWS} images at {SIZE}^2, fp32, augmentation and dropout "
        f"on: 2 ranks on one card (gloo) warm {ranks[0]['warm_ms']} / {ranks[1]['warm_ms']} "
        f"ms/step, a world of one (NCCL) {one['warm_ms']} ms/step, single process "
        f"{single['warm_ms']} ms/step; launches a rank {[nonzero(r['launches']) for r in ranks]}, "
        f"world of one {nonzero(one_launches)}; {smi} (readings: both ranks share the card)")
    del ranks, single, one
    torch.cuda.empty_cache()

    # (c) and (d): the default widths in bf16 on [cuda:0].
    cfg = load_config()
    d = AdaptiveDehazer(make_router(cfg, torch.Generator().manual_seed(SEED + 22)), None, cfg,
                        device=dev)
    serving = d._serving
    levels = INTENSITY_ORDER
    xd = torch.from_numpy(x).to(dev)
    ep = ExpertParallelRouter({lvl: serving.models[lvl] for lvl in levels}, serving.classifier,
                              serving.temperature, devices=[dev])
    with torch.inference_mode():
        want = serving(xd)[0]
        reset_launch_counts()
        got = ep(xd)[0]
        torch.cuda.synchronize()
    ep_launches = counts()
    path.update(ep_launches)
    ep_err = max_err(got, want)
    check(ep_err <= PARALLEL_BF16_ATOL, f"(c) ExpertParallelRouter vs the soft router: {ep_err}")
    check(nonzero(ep_launches) == nonzero({"lightweight_chain": K1_LAUNCHES[torch.bfloat16],
                                           "cbam_gate": 6, "blend3": 1}),
          f"(c) ExpertParallelRouter launched {ep_launches}")
    with torch.inference_mode():
        ep_ms, ep_runs = warm_ms(lambda: ep(xd))
        soft_ms, soft_runs = warm_ms(lambda: serving(xd))
    pipe = TwoStagePipeline(serving.classifier, [serving.models[lvl] for lvl in levels],
                            serving.temperature, devices=[dev])
    xs = [torch.from_numpy(np.random.default_rng(SEED + 23 + i).random(
        (BATCH, SIZE, SIZE, 3), dtype=np.float32)).to(dev) for i in range(4)]
    reset_launch_counts()
    outs = list(pipe.run(xs))
    torch.cuda.synchronize()
    pipe_launches = counts()
    path.update(pipe_launches)
    check(len(outs) == 4, f"(d) the pipeline yielded {len(outs)} batches")
    pipe_err = max(max_err(y, pipe(b)) for y, b in zip(outs, xs))
    check(pipe_err <= PARALLEL_BF16_ATOL, f"(d) TwoStagePipeline.run vs __call__: {pipe_err}")
    check(nonzero(pipe_launches) == nonzero({"lightweight_chain": 4 * K1_LAUNCHES[torch.bfloat16],
                                             "cbam_gate": 24, "blend3": 4}),
          f"(d) TwoStagePipeline.run launched {pipe_launches}")
    pipe_ms, pipe_runs = warm_ms(lambda: list(pipe.run(xs)))
    readings.update(
        expert_parallel=dict(max_abs_err=ep_err, launches=nonzero(ep_launches),
                             ms_per_image=ep_ms / BATCH, ms_runs=ep_runs,
                             soft_router_ms_per_image=soft_ms / BATCH, soft_ms_runs=soft_runs),
        pipeline=dict(max_abs_err=pipe_err, launches=nonzero(pipe_launches),
                      ms_per_image=pipe_ms / (4 * BATCH), ms_runs=pipe_runs))
    log(f"[parallel] (c) ExpertParallelRouter on [cuda:0], default widths, bf16, {BATCH} images: "
        f"max abs err vs the soft router {ep_err:.3e} (bound {PARALLEL_BF16_ATOL:.3e}); launches "
        f"{nonzero(ep_launches)}; warm {ep_ms / BATCH:.3f} ms/image (the soft router "
        f"{soft_ms / BATCH:.3f}); {smi}")
    log(f"[parallel] (d) TwoStagePipeline.run over 4 batches of {BATCH}: max abs err vs "
        f"__call__ {pipe_err:.3e} (bound {PARALLEL_BF16_ATOL:.3e}); launches "
        f"{nonzero(pipe_launches)}; warm {pipe_ms / (4 * BATCH):.3f} ms/image (one card: both "
        f"stages share it, no overlap); {smi}")
    for name in PARALLEL_PATH_KERNELS:
        check(path[name] > 0, f"the parallel path launched no {name}")
    del d, serving, ep, pipe
    torch.cuda.empty_cache()
    return dict(path), readings


# The sharded phase (parallel/spatial.py, parallel/sharding.py), each part
# in a gloo group of ranks on cuda:0 (this script with `--sharded-rank`),
# held against the one-process unsharded call on the same card. One card
# holds every rank, so nothing here shows scaling.
SHARD_SIZE = 512
SHARD_LABELS = (0, 1, 2, 0)
TP_ROWS = 16
COMPOSE_WIDTH = 16
COMPOSE_SIZE = 128
SHARD_STEP_ROWS = 4
SHARD_TIMEOUT_S = 240
# fp32 sharded against unsharded: the port's card bound (SLICE_ATOL); bf16:
# one bf16 rounding step of a [0, 1] value (PARALLEL_BF16_ATOL).
SHARD_ATOL = {torch.float32: SLICE_ATOL, torch.bfloat16: PARALLEL_BF16_ATOL}
SHARDED_PATH_KERNELS = ("lightweight_chain", "cbam_gate")


def balance_head_(classifier, x, labels):
    """Set the classifier's last linear so that image i's logits are 10 at
    labels[i] and -5 elsewhere: the least-norm weights that map the head's
    hidden features of `x` onto those logits (seeded weights route every
    image to one class)."""
    _, fc0, relu, _, fc1 = classifier.classifier
    classifier.eval()
    with torch.no_grad():
        h = relu(fc0(classifier.backbone(x.permute(0, 3, 1, 2).float()))).double()
        t = torch.full((len(labels), 3), -5.0, dtype=torch.float64, device=h.device)
        t[torch.arange(len(labels)), torch.tensor(labels)] = 10.0
        fc1.weight.copy_((t.T @ torch.linalg.solve(h @ h.T, h)).float())
        fc1.bias.zero_()


def shard_inputs():
    rng = np.random.default_rng(SEED + 24)
    return {"route_x": torch.from_numpy(rng.random((len(SHARD_LABELS), SHARD_SIZE, SHARD_SIZE, 3),
                                                   dtype=np.float32)),
            "tp_x": torch.from_numpy(rng.random((TP_ROWS, SIZE, SIZE, 3), dtype=np.float32)),
            "compose_x": torch.from_numpy(rng.random((4, COMPOSE_SIZE, COMPOSE_SIZE, 3),
                                                     dtype=np.float32)),
            "step_x": torch.from_numpy(rng.random((SHARD_STEP_ROWS, SIZE, SIZE, 3),
                                                  dtype=np.float32)),
            "step_y": torch.from_numpy(rng.random((SHARD_STEP_ROWS, SIZE, SIZE, 3),
                                                  dtype=np.float32))}


def shard_models(state):
    """The phase's modules from the saved state: the default router, the
    small high branch of (c) and the low branch of (d)."""
    router = make_router(load_config(), torch.Generator().manual_seed(SEED + 25))
    router.load_state_dict(state["router"])
    small = HighIntensityDehazeModel(COMPOSE_WIDTH)
    small.load_state_dict(state["small_high"])
    low = LightweightDehazeModel(32, 3)
    low.load_state_dict(state["low"])
    return router, small.eval(), low


def shard_step(low, batch, dev, step):
    """One SGD step (lr 0.1) of the low branch's MSE in train mode, fp32:
    the loss, the gradients the optimizer took and the BN statistics after
    it, on the CPU."""
    model = copy.deepcopy(low).to(dev).train()
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))

    def mse(state, batch, generator=None):
        loss = ((state.module(batch["x"]) - batch["y"]) ** 2).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return {"total": loss.detach()}

    metrics = (step or (lambda f: f))(mse)(state, batch)
    return {"metrics": {"total": float(metrics["total"])},
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "stats": {k: v.detach().cpu() for k, v in model.state_dict().items()
                      if "running" in k}}


def tp_forward(model, x, dev, dtype, mesh=None, runs=3):
    """A medium or high branch's serving copy in `dtype` on x; under
    channel_sharding when a mesh is given. (output, its launches, the
    widths K2 ran at, warm ms/image over `runs` timed calls)."""
    from adam_dehaze_tpu_torch.ops.kernels import cbam
    from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
    copy_ = cast_for_serving(model, dtype)
    widths = []
    launch = cbam.launch_cbam_gate

    def recorded(x_, *args):
        widths.append(int(x_.shape[3]))
        launch(x_, *args)

    def run():
        with torch.inference_mode(), (channel_sharding(mesh) if mesh is not None
                                      else contextlib.nullcontext()):
            return copy_(x)

    cbam.launch_cbam_gate = recorded
    try:
        reset_launch_counts()
        y = run()
        torch.cuda.synchronize()
        launches = counts()
    finally:
        cbam.launch_cbam_gate = launch
    ms = warm_ms(run, runs)[0] / x.shape[0]
    return y.cpu(), launches, widths, ms


def route_call(d, x, mesh=None, lowres=None):
    """route_hard of x (with the half-resolution dial on the branches in
    `lowres`), through make_spatial_infer on this rank's rows when a mesh is
    given: (output, labels, launches, warm ms/image)."""
    from adam_dehaze_tpu_torch.parallel.spatial import make_spatial_infer, shard_image_batch

    def route(images):
        return d.route_hard(images, lowres=lowres)

    fn, arg = ((route, x) if mesh is None else
               (make_spatial_infer(route, mesh), shard_image_batch(mesh, x)))
    reset_launch_counts()
    out, labels = fn(arg)
    torch.cuda.synchronize()
    launches = counts()
    ms = warm_ms(lambda: fn(arg))[0] / x.shape[0]
    return torch.from_numpy(out), labels.tolist(), launches, ms


def sharded_rank(part, rank, world, port, out_dir, dev=None):
    """One rank of phase 21: `python3 chip_smoke.py --sharded-rank PART
    RANK WORLD PORT OUT_DIR`. PART "pair" runs (a), (b) and (d) on 2 ranks,
    "quad" runs (c) on 4; `dev` is cuda:0 (another only to rehearse)."""
    from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
    from adam_dehaze_tpu_torch.parallel.spatial import make_spatial_infer, shard_image_batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Every rank drives the one card: gloo over CUDA tensors (NCCL refuses
    # two ranks on one device), a choice made for one card.
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    try:
        state = torch.load(os.path.join(out_dir, "state.pt"), weights_only=True)
        inputs = state["inputs"]
        router, small, low = shard_models(state)
        out = {}
        if part == "pair":
            mesh = make_mesh({"data": 1, "spatial": 2}, [dev] * 2)
            x = inputs["route_x"].to(dev)
            for name, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
                cfg = load_config(overrides={"cuda": {"compute_dtype": dtype}})
                d = AdaptiveDehazer(router, None, cfg, device=dev)
                out[f"route_{name}"] = route_call(d, x, mesh)
                del d
            model_mesh = make_mesh({"data": 1, "model": 2}, [dev] * 2)
            for lvl in ("medium", "high"):
                for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
                    out[f"tp_{lvl}_{name}"] = tp_forward(router.models[lvl],
                                                         inputs["tp_x"].to(dev), dev, dtype,
                                                         model_mesh, runs=1)
            batch = {"x": inputs["step_x"].to(dev), "y": inputs["step_y"].to(dev)}
            out["step"] = shard_step(low, batch, dev, lambda f: shard_train_step(f, mesh, batch))
        else:
            mesh = make_mesh({"data": 1, "spatial": 2, "model": 2}, [dev] * 4)
            small = small.to(dev)
            x = shard_image_batch(mesh, inputs["compose_x"].to(dev))
            reset_launch_counts()
            with torch.inference_mode(), channel_sharding(mesh):
                y = make_spatial_infer(small, mesh)(x)
            torch.cuda.synchronize()
            out["compose"] = (y.cpu(), counts())
        torch.save(out, os.path.join(out_dir, f"{part}{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn_sharded(parts, out_dir):
    """The ranks of each part ({part: world size}) in their own processes,
    the parts side by side; what the ranks saved, by part."""
    procs = {}
    for part, world in parts.items():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs[part] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank", part, str(rank),
             str(world), str(port), out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        logs = {part: [p.communicate(timeout=SHARD_TIMEOUT_S)[0] for p in ps]
                for part, ps in procs.items()}
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.wait()
    for part, ps in procs.items():
        for rank, (p, text) in enumerate(zip(ps, logs[part])):
            check(p.returncode == 0, f"sharded rank {rank} ({part}) failed:\n{text}")
    return {part: [torch.load(os.path.join(out_dir, f"{part}{r}.pt"), weights_only=False)
                   for r in range(world)] for part, world in parts.items()}


def phase_sharded(dev, smi, tmp):
    """21. parallel/spatial.py and parallel/sharding.py on one card (see the
    docstring). Returns the spatial and tp paths' launch counts and the
    phase's readings."""
    torch.cuda.empty_cache()
    out_dir = os.path.join(tmp, "sharded")
    os.makedirs(out_dir)
    inputs = shard_inputs()
    gen = torch.Generator().manual_seed(SEED + 25)
    router = make_router(load_config(), gen).to(dev)
    balance_head_(router.classifier, inputs["route_x"].to(dev), SHARD_LABELS)
    small = perturb_bn_(init_params_(HighIntensityDehazeModel(COMPOSE_WIDTH), gen), gen).eval()
    low = perturb_bn_(init_params_(LightweightDehazeModel(32, 3), gen), gen)
    torch.save({"router": {k: v.cpu() for k, v in router.state_dict().items()},
                "small_high": small.state_dict(), "low": low.state_dict(), "inputs": inputs},
               os.path.join(out_dir, "state.pt"))
    readings, spatial_path, tp_path = {}, collections.Counter(), collections.Counter()

    # The one-process references, first, alone on the card.
    ref = {}
    x = inputs["route_x"].to(dev)
    for name, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
        cfg = load_config(overrides={"cuda": {"compute_dtype": dtype}})
        d = AdaptiveDehazer(router, None, cfg, device=dev)
        ref[f"route_{name}"] = route_call(d, x)
        del d
    for lvl in ("medium", "high"):
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            ref[f"tp_{lvl}_{name}"] = tp_forward(router.models[lvl], inputs["tp_x"].to(dev), dev,
                                                 dtype)
    batch = {"x": inputs["step_x"].to(dev), "y": inputs["step_y"].to(dev)}
    ref_step = shard_step(low, batch, dev, None)
    with torch.inference_mode():
        ref_compose = small.to(dev)(inputs["compose_x"].to(dev)).cpu()
    del router
    torch.cuda.empty_cache()

    # (c) is short: its 4 ranks are done before (a) starts its timed calls.
    ranks = spawn_sharded({"pair": 2, "quad": 4}, out_dir)
    pair, quad = ranks["pair"], ranks["quad"]

    # (a) route_hard over {"spatial": 2} at 512^2.
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        want, labels, launches, ms = ref[f"route_{name}"]
        check(labels == list(SHARD_LABELS), f"(a) the unsharded route's labels {labels}")
        got = torch.cat([r[f"route_{name}"][0] for r in pair], 1)
        err = max_err(got, want)
        rank_launches = [nonzero(r[f"route_{name}"][2]) for r in pair]
        for r in pair:
            spatial_path.update(r[f"route_{name}"][2])
            check(r[f"route_{name}"][1] == labels,
                  f"(a) {name}: a rank routed {r[f'route_{name}'][1]}, unsharded {labels}")
        sharded_ms = [r[f"route_{name}"][3] for r in pair]
        readings[f"spatial_route_{name}"] = dict(
            max_abs_err=err, bound=SHARD_ATOL[dtype], launches_per_rank=rank_launches,
            unsharded_launches=nonzero(launches), ms_per_image_per_rank=sharded_ms,
            unsharded_ms_per_image=ms)
        log(f"[spatial] (a) route_hard, default router, {name}, {len(SHARD_LABELS)} images at "
            f"{SHARD_SIZE}^2 over spatial=2 (2 gloo ranks on cuda:0): labels {labels} on every "
            f"rank; max abs err vs unsharded {err:.3e} (bound {SHARD_ATOL[dtype]:.3e}); launches "
            f"a rank {rank_launches}, unsharded {nonzero(launches)}; warm ms/image a rank "
            f"{sharded_ms[0]:.3f} / {sharded_ms[1]:.3f}, unsharded {ms:.3f}; {smi} (a reading: "
            "both ranks share the card)")
        check(err <= SHARD_ATOL[dtype], f"(a) {name}: sharded route_hard differs by {err}")
        for got_launches in rank_launches:
            check({k: got_launches.get(k, 0) for k in SHARDED_PATH_KERNELS}
                  == {k: launches.get(k, 0) for k in SHARDED_PATH_KERNELS},
                  f"(a) {name}: a rank launched {got_launches}, unsharded {nonzero(launches)}")

    # (b) the medium and high branches over {"model": 2}.
    for lvl in ("medium", "high"):
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            want, launches, widths, ms = ref[f"tp_{lvl}_{name}"]
            errs = [max_err(r[f"tp_{lvl}_{name}"][0], want) for r in pair]
            rank_widths = [r[f"tp_{lvl}_{name}"][2] for r in pair]
            sharded_ms = [r[f"tp_{lvl}_{name}"][3] for r in pair]
            for r in pair:
                tp_path.update(r[f"tp_{lvl}_{name}"][1])
            readings[f"tp_{lvl}_{name}"] = dict(
                max_abs_err=max(errs), bound=SHARD_ATOL[dtype], k2_widths_per_rank=rank_widths,
                unsharded_k2_widths=widths, ms_per_image_per_rank=sharded_ms,
                unsharded_ms_per_image=ms)
            log(f"[tp] (b) {lvl} branch, {name}, {TP_ROWS} images at {SIZE}^2 under "
                f"channel_sharding, model=2: max abs err vs unsharded {max(errs):.3e} (bound "
                f"{SHARD_ATOL[dtype]:.3e}); K2 widths a rank {rank_widths[0]}, unsharded "
                f"{widths}; warm ms/image a rank {sharded_ms[0]:.3f} / {sharded_ms[1]:.3f}, "
                f"unsharded {ms:.3f}; {smi} (a reading)")
            check(max(errs) <= SHARD_ATOL[dtype], f"(b) {lvl} {name}: differs by {max(errs)}")
            if lvl == "high":
                c4 = 4 * load_config()["dehazing"]["high"]["channels"]
                for got in rank_widths:
                    check(widths.count(c4) == 3
                          and got == [w // 2 if w == c4 else w for w in widths],
                          f"(b) high {name}: K2 ran at widths {got}, unsharded {widths}")

    # (c) both axes, {"spatial": 2, "model": 2}, 4 ranks.
    got = torch.cat([quad[r]["compose"][0] for r in (0, 2)], 1)
    err = max(max_err(got, ref_compose),
              max_err(torch.cat([quad[r]["compose"][0] for r in (1, 3)], 1), ref_compose))
    for r in quad:
        tp_path.update(r["compose"][1])
    compose_launches = [nonzero(r["compose"][1]) for r in quad]
    readings["spatial_and_tp"] = dict(max_abs_err=err, bound=SLICE_ATOL,
                                      launches_per_rank=compose_launches)
    log(f"[tp] (c) high branch c={COMPOSE_WIDTH}, fp32, 4 images at {COMPOSE_SIZE}^2 over "
        f"spatial=2 x model=2 (4 gloo ranks on cuda:0): max abs err vs unsharded {err:.3e} "
        f"(bound {SLICE_ATOL:.3e}); launches a rank {compose_launches}; {smi}")
    check(err <= SLICE_ATOL, f"(c) spatial x model differs by {err}")
    check(all(c.get("cbam_gate") == 6 for c in compose_launches),
          f"(c) K2 launches a rank {compose_launches}")

    # (d) the low branch's train step over {"spatial": 2}.
    errs = {f"rank{r}": dp_errors(out["step"], ref_step,
                                  f"(d) low-branch MSE step, {SHARD_STEP_ROWS} images at "
                                  f"{SIZE}^2, fp32, spatial=2, rank {r}", smi, tag="spatial")
            for r, out in enumerate(pair)}
    readings["spatial_step"] = errs
    for name in SHARDED_PATH_KERNELS:
        check(spatial_path[name] > 0, f"the spatial path launched no {name}")
    check(tp_path["cbam_gate"] > 0, "the tp path launched no cbam_gate")
    torch.cuda.empty_cache()
    return dict(spatial_path), dict(tp_path), readings


# The joint phase on shards (training/train_joint.py over parallel/): (a)
# the soft joint step at full width over {"spatial": 2}, (b) the port's
# dryrun_multichip(8), (c) the tuned route over {"spatial": 2}; every part's
# ranks in gloo groups on cuda:0 (this script with `--joint-rank`, the
# dryrun's own launcher), held against the one-process call on the same
# card. One card holds every rank, so nothing here shows scaling.
JOINT_ROWS = 16
TUNED_SIZE = 512
TUNED_LABELS = (0, 1, 2, 0)
# The tuned dispatch of (c): every tuned kernel on the path, K3 (medium
# tail_chain), K6, K4 and K2' (high res_e2b_tail_chain), K1 (low chain).
TUNED_FORCED = {"low": "chain", "medium": "tail_chain", "high": "res_e2b_tail_chain"}
TUNED_PATH_KERNELS = ("lightweight_chain", "cbam_gate", "spatial_gate", "medium_tail_chain",
                      "high_tail_chain", "res_attn_chain")
JOINT_SHARDED_PATH_KERNELS = ("cbam_gate", "blend3")
# (c) sharded against unsharded: fp32 as the tuned kernels' plain versions
# on shards meet on the CPU (the same sums a pixel) with room for the
# channel reductions' other order; bf16 two bf16 steps of a [0, 1] value:
# the shards' canonical layers (cuDNN picks its algorithms by shape) and
# K4's and K6's channel sums in another order each move a bf16 rounding (an
# H100 80GB HBM3 at 700 W read 4.216e-3, 1.08 steps, on this route).
TUNED_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# (a): fp32 at phase 20's bounds (loss, gradients of the largest, BN
# statistics of their scale). bf16 autocast sums in other orders on a
# shard (cuDNN picks its algorithms by shape), so each bf16 result may move
# by a bf16 rounding: the loss within 1e-3, the gradients within GRAD_TOL's
# bf16 3e-2 of the largest, the BN statistics within one bf16 step (2^-8)
# of their scale.
JOINT_BOUNDS = {"float32": (STEP_LOSS_RTOL, STEP_GRAD_RTOL, DP_STATS_RTOL),
                "bfloat16": (1e-3, GRAD_TOL[torch.bfloat16], 2.0 ** -8)}
# (a)'s eval step: PSNR in dB and SSIM of the sharded step against the
# unsharded one.
EVAL_ATOL = {"float32": {"psnr": 1e-3, "ssim": 1e-4},
             "bfloat16": {"psnr": 1e-2, "ssim": 1e-3}}
DRYRUN_DEVICES = 8
DRYRUN_TIMEOUT_S = 300


def joint_sharded_step(dev, dtype_name, mesh=None):
    """The soft joint step (augmentation off, dropout on) of the seeded
    default router on JOINT_ROWS images at SIZE^2 in `dtype_name`, then its
    eval step on the same batch; through shard_train_step / shard_eval_step
    when a mesh is given. Returns the step's metrics, gradients and BN
    statistics (on the CPU), its launches and the eval step's psnr and ssim."""
    cfg = load_config(overrides={"cuda": {"compute_dtype": dtype_name}})
    cfg["classifier"]["checkpoint_dir"] = cfg["dehazing"]["checkpoint_dir"] = "absent"
    dtype = getattr(torch, dtype_name)
    router, state = tj.build_router_state(cfg, dev)
    joint_loss = get_joint_loss(cfg)
    nets = tj._loss_params(joint_loss, dev)
    batch = dp_batch(dev)
    step = tj.make_train_step(joint_loss, nets, augmentation=False, dtype=dtype)
    eval_step = tj.make_eval_step(joint_loss, nets, dtype)
    if mesh is not None:
        replicate(mesh, state)
        step = shard_train_step(step, mesh, batch)
        eval_step = shard_eval_step(eval_step, mesh, batch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    reset_launch_counts()
    metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = counts()
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad.detach().cpu() for n, p in router.named_parameters()
                     if p.grad is not None},
           "stats": {k: v.detach().cpu() for k, v in router.state_dict().items()
                     if "running" in k}}
    evaluated = eval_step(state, batch)
    out["eval"] = {k: float(evaluated[k]) for k in ("psnr", "ssim")}
    return out, launches


def k6_on_shards(high, dev, mesh, dtype):
    """K6 on the high branch's e2b segment at (c)'s shape (2 images of
    TUNED_SIZE/4 rows, 4c channels, non-negative like the real
    activations): this rank's rows through spatial_sharding against the
    whole image, in units of max|whole| (K6's output is not clipped)."""
    from adam_dehaze_tpu_torch.parallel.spatial import spatial_sharding
    weights = fold_res_attn_chain(segment_blocks(high, "e2b"), dtype)
    side = TUNED_SIZE // 4
    x = torch.relu(torch.randn(2, side, side, weights.channels,
                               generator=torch.Generator().manual_seed(SEED + 29))).to(dev)
    rows = mesh.axis("spatial")
    part = slice(rows.index * side // rows.size, (rows.index + 1) * side // rows.size)
    with torch.inference_mode():
        whole = res_attn_chain(x, weights)
        with spatial_sharding(mesh):
            got = res_attn_chain(x[:, part].contiguous(), weights)
    return max_err(got.float(), whole[:, part].float()) / float(whole.float().abs().max())


def tuned_cache(router, dev, dtype, path):
    """A serving autotune cache at (16, TUNED_SIZE, TUNED_SIZE, 3) whose
    winners are TUNED_FORCED, each timed there once (its table's only
    entry): what the ranks of (c) serve from, the unsharded image's key."""
    from adam_dehaze_tpu_torch import serving_autotune as sa
    shape = (16, TUNED_SIZE, TUNED_SIZE, 3)
    cache = {}
    for level in INTENSITY_ORDER:
        model = router.models[level]
        name = TUNED_FORCED[level]
        builders = sa.candidate_builders(model, dtype, shape)
        check(name in builders, f"(c) {level}: {name} is not offered at {shape}")
        best, table, _ = sa.autotune(model, dtype, shape, iters=2, warm=1,
                                     candidates={name: builders[name]})
        cache[sa._cache_key(model, dtype, shape)] = {"best": best, "table": table}
    with open(path, "w") as f:
        json.dump(cache, f)


def tuned_dehazer(router, dev, dtype_name, cache_path):
    cfg = load_config(overrides={"cuda": {"compute_dtype": dtype_name}})
    cfg["dataset"]["img_size"] = TUNED_SIZE
    d = AdaptiveDehazer(router, None, cfg, device=dev, autotune=True, autotune_cache=cache_path)
    check({lvl: r["best"] for lvl, r in d.autotune_report.items()} == TUNED_FORCED
          and all(r["cached"] for r in d.autotune_report.values()),
          f"(c) the dehazer did not serve the tuned cache: {d.autotune_report}")
    return d


def joint_rank(part, rank, world, port, out_dir, dev=None):
    """One rank of phase 22: `python3 chip_smoke.py --joint-rank PART RANK
    WORLD PORT OUT_DIR`. PART "joint" runs (a), "tuned" (c), each on 2 ranks
    over {"spatial": 2}; `dev` is cuda:0 (another only to rehearse)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Every rank drives the one card: gloo over CUDA tensors (NCCL refuses
    # two ranks on one device), a choice made for one card.
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    try:
        mesh = make_mesh({"data": 1, "spatial": 2}, [dev] * 2)
        out = {}
        if part == "joint":
            for name in ("float32", "bfloat16"):
                out[name] = joint_sharded_step(dev, name, mesh)
        else:
            state = torch.load(os.path.join(out_dir, "tuned_state.pt"), weights_only=True)
            router = make_router(load_config(), torch.Generator().manual_seed(SEED + 27))
            router.load_state_dict(state["router"])
            router.to(dev).eval()
            x = state["x"].to(dev)
            for name in ("bfloat16", "float32"):
                d = tuned_dehazer(router, dev, name, os.path.join(out_dir, f"tuned_{name}.json"))
                out[name] = route_call(d, x, mesh)
                del d
                out[f"k6_{name}"] = k6_on_shards(router.models["high"], dev, mesh,
                                                 getattr(torch, name))
        torch.save(out, os.path.join(out_dir, f"{part}{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _run_all(procs, timeout):
    """Wait for every process of {name: [Popen]}; their outputs by name."""
    try:
        return {name: [p.communicate(timeout=timeout)[0] for p in ps]
                for name, ps in procs.items()}
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.wait()


def _joint_ranks(part, out_dir):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--joint-rank", part, str(rank), "2",
         str(port), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]


def spawn_joint(out_dir):
    """(a)'s 2 ranks alone (the full-width train step takes some 20 GB a
    rank), then (c)'s 2 ranks beside the dryrun's 8: what the ranks of (a)
    and (c) saved, by part, and the dryrun's output."""
    procs = {"joint": _joint_ranks("joint", out_dir)}
    logs = _run_all(procs, DRYRUN_TIMEOUT_S)
    procs2 = {"tuned": _joint_ranks("tuned", out_dir), "dryrun": [subprocess.Popen(
        [sys.executable, "-m", "adam_dehaze_tpu_torch.parallel.dryrun", "--devices",
         str(DRYRUN_DEVICES)], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]}
    logs.update(_run_all(procs2, DRYRUN_TIMEOUT_S))
    procs.update(procs2)
    failed = [f"{name} process {i} failed:\n{text[-6000:]}"
              for name, ps in procs.items()
              for i, (p, text) in enumerate(zip(ps, logs[name])) if p.returncode != 0]
    check(not failed, "\n".join(failed))
    return ({part: [torch.load(os.path.join(out_dir, f"{part}{r}.pt"), weights_only=False)
                    for r in range(2)] for part in ("joint", "tuned")}, logs["dryrun"][0])


def dryrun_launches(log):
    """Each rank's launches in the dryrun's step, from its OK lines."""
    import ast
    import re
    return {int(rank): ast.literal_eval(launches) for rank, launches in re.findall(
        r"dryrun_multichip OK on mesh .*?, rank (\d+): .*?launches in the step (\{[^}]*\})",
        log)}


def phase_joint_sharded(dev, smi, tmp):
    """22. The joint steps, the dryrun and the tuned kernels on shards (see
    the docstring). Returns the paths' launch counts and the readings."""
    torch.cuda.empty_cache()
    out_dir = os.path.join(tmp, "joint_sharded")
    os.makedirs(out_dir)
    readings = {}
    joint_path, tuned_path, dryrun_path = (collections.Counter() for _ in range(3))
    # The one-process references first, alone on the card.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = {name: joint_sharded_step(dev, name) for name in ("float32", "bfloat16")}
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(SEED + 27)
    router = make_router(load_config(), gen)
    x = torch.from_numpy(np.random.default_rng(SEED + 28).random(
        (len(TUNED_LABELS), TUNED_SIZE, TUNED_SIZE, 3), dtype=np.float32))
    router.to(dev)
    balance_head_(router.classifier, x.to(dev), TUNED_LABELS)
    torch.save({"router": {k: v.cpu() for k, v in router.state_dict().items()}, "x": x},
               os.path.join(out_dir, "tuned_state.pt"))
    router.eval()
    tuned_ref = {}
    for name in ("bfloat16", "float32"):
        path = os.path.join(out_dir, f"tuned_{name}.json")
        tuned_cache(router, dev, getattr(torch, name), path)
        d = tuned_dehazer(router, dev, name, path)
        tuned_ref[name] = route_call(d, x.to(dev))
        del d
    del router
    # The dehazers hold their serving copies in reference cycles: collect
    # them before the ranks take the card.
    gc.collect()
    torch.cuda.empty_cache()

    ranks, dryrun_log = spawn_joint(out_dir)

    # (a) the soft joint step at full width over {"spatial": 2}.
    for name in ("float32", "bfloat16"):
        want, want_launches = ref[name]
        errs = {}
        for r, (got, launches) in enumerate(out[name] for out in ranks["joint"]):
            joint_path.update(launches)
            errs[f"rank{r}"] = dp_errors(
                got, want, f"(a) soft joint step, {JOINT_ROWS} images at {SIZE}^2, {name}, "
                f"spatial=2, rank {r}", smi, tag="joint sharded", bounds=JOINT_BOUNDS[name])
            check({k: launches.get(k, 0) for k in JOINT_SHARDED_PATH_KERNELS}
                  == {k: want_launches.get(k, 0) for k in JOINT_SHARDED_PATH_KERNELS},
                  f"(a) {name} rank {r}: launches {nonzero(launches)}, unsharded "
                  f"{nonzero(want_launches)}")
            for k, bound in EVAL_ATOL[name].items():
                err = abs(got["eval"][k] - want["eval"][k])
                errs[f"rank{r}"][f"eval_{k}_err"] = err
                check(err <= bound, f"(a) {name} rank {r}: eval {k} {got['eval'][k]} vs "
                      f"{want['eval'][k]}")
        readings[f"joint_{name}"] = dict(
            errors=errs, launches_per_rank=[nonzero(out[name][1]) for out in ranks["joint"]],
            unsharded_launches=nonzero(want_launches),
            eval={"sharded": [out[name][0]["eval"] for out in ranks["joint"]],
                  "unsharded": want["eval"]})
        log(f"[joint sharded] (a) {name}: K2 and K5 launches a rank "
            f"{[nonzero(out[name][1]) for out in ranks['joint']]}, unsharded "
            f"{nonzero(want_launches)}; eval psnr/ssim a rank "
            f"{[out[name][0]['eval'] for out in ranks['joint']]}, unsharded {want['eval']}; "
            f"{smi}")

    # (b) dryrun_multichip(8): data 2 x spatial 2 x model 2 on 8 ranks.
    oks = [line for line in dryrun_log.splitlines() if line.startswith("dryrun_multichip")
           and " OK" in line]
    per_rank = dryrun_launches(dryrun_log)
    check(len(oks) == 4 * DRYRUN_DEVICES and len(per_rank) == DRYRUN_DEVICES,
          f"(b) dryrun_multichip({DRYRUN_DEVICES}): {len(oks)} OK lines\n{dryrun_log}")
    for launches in per_rank.values():
        dryrun_path.update(launches)
        check(launches.get("cbam_gate", 0) > 0 and launches.get("blend3", 0) > 0,
              f"(b) a rank's step launched {launches}")
    readings["dryrun"] = dict(ok_lines=len(oks), launches_per_rank=per_rank)
    for line in oks:
        log(f"[dryrun] {line}")

    # (c) route_hard under the tuned dispatch over {"spatial": 2} at 512^2,
    # every reading logged before any check fails.
    failed = []
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        want, labels, launches, ms = tuned_ref[name]
        check(labels == list(TUNED_LABELS), f"(c) the unsharded route's labels {labels}")
        got = torch.cat([r[name][0] for r in ranks["tuned"]], 1)
        err = max_err(got, want)
        rank_launches = [nonzero(r[name][2]) for r in ranks["tuned"]]
        for r in ranks["tuned"]:
            tuned_path.update(r[name][2])
            check(r[name][1] == labels, f"(c) {name}: a rank routed {r[name][1]}, unsharded "
                  f"{labels}")
        sharded_ms = [r[name][3] for r in ranks["tuned"]]
        readings[f"tuned_{name}"] = dict(
            max_abs_err=err, bound=TUNED_ATOL[dtype], launches_per_rank=rank_launches,
            unsharded_launches=nonzero(launches), ms_per_image_per_rank=sharded_ms,
            unsharded_ms_per_image=ms)
        log(f"[tuned spatial] (c) route_hard, dispatch {TUNED_FORCED}, {name}, "
            f"{len(TUNED_LABELS)} images at {TUNED_SIZE}^2 over spatial=2 (2 gloo ranks on "
            f"cuda:0): labels {labels}; max abs err vs unsharded {err:.3e} (bound "
            f"{TUNED_ATOL[dtype]:.3e}); launches a rank {rank_launches}, unsharded "
            f"{nonzero(launches)}; warm ms/image a rank {sharded_ms[0]:.3f} / "
            f"{sharded_ms[1]:.3f}, unsharded {ms:.3f}; {smi} (a reading: both ranks share the "
            "card)")
        failed += [f"(c) {name}: the sharded tuned route differs by {err}"] * (
            err > TUNED_ATOL[dtype])
        k6_errs = [r[f"k6_{name}"] for r in ranks["tuned"]]
        readings[f"tuned_{name}"]["k6_e2b_err_of_max"] = k6_errs
        log(f"[tuned spatial] (c) K6 on the high e2b segment, 2 x {TUNED_SIZE // 4}^2 x "
            f"{4 * load_config()['dehazing']['high']['channels']}, {name}, a rank's rows "
            f"against the whole image: {max(k6_errs):.3e} of max|whole| (bound "
            f"{TUNED_ATOL[dtype]:.3e}); {smi}")
        failed += [f"(c) {name}: K6 on shards differs by {k6_errs}"] * (
            max(k6_errs) > TUNED_ATOL[dtype])
        failed += [f"(c) {name}: a rank launched {got}, unsharded {nonzero(launches)}"
                   for got in rank_launches
                   if {k: got.get(k, 0) for k in TUNED_PATH_KERNELS}
                   != {k: launches.get(k, 0) for k in TUNED_PATH_KERNELS}]
    check(not failed, "; ".join(failed))
    for k in TUNED_PATH_KERNELS:
        check(tuned_path[k] > 0, f"the tuned spatial path launched no {k}")
    for k in JOINT_SHARDED_PATH_KERNELS:
        check(joint_path[k] > 0 and dryrun_path[k] > 0, f"phase 22 launched no {k}")
    torch.cuda.empty_cache()
    return dict(joint_path), dict(dryrun_path), dict(tuned_path), readings


# Phase 23: int8 serving and cuda.remat on the spatial and model axes, and a
# converted reference checkpoint. Each sharded part's ranks in a gloo group
# on cuda:0 (this script with `--int8-shard-rank`), held against the
# one-process unsharded call on the same card. One card holds every rank,
# so nothing here shows scaling.
INT8_SHARD_SIZE = 512
INT8_SHARD_LABELS = (0, 1, 2, 0)
INT8_TP_ROWS = 8
REMAT_ROWS = 4
INT8_SHARD_TIMEOUT_S = 300
# Int8 on shards against the unsharded int8 on the card, end to end. An
# element off the unsharded value by a float rounding upstream of a
# quantizer (the shards' convolutions, the channel-split MLP and K2's
# reduced maps, the row-parallel transposed conv sum in other orders) moves
# an int8 level now and then, and the layers after it spread that over a
# patch. Every element within INT8_FLIP_TOL, the CPU tests' bound
# (tests/test_torch_quant.py: _assert_int8_close; in bf16 one bf16 step of
# a [0, 1] value more), and the mean error within INT8_DRAWS times the mean
# of the int8 noise (the unsharded int8 output against the unquantized
# one), as phase 19 holds the card against the CPU. The CPU tests' other
# rule, INT8_MATCH_SHARE of the elements within INT8_MATCH_ATOL, is a
# reading here: at the default widths the flips reach most of the high
# branch's output (68.4 % of its fp32 elements within 1e-5 on 2 channel
# shards in this phase's first run, NVIDIA H100 80GB HBM3 at 700.00 W),
# where the CPU tests' narrow branches keep them local.
INT8_FLIP_TOL = 1e-2
INT8_MATCH_SHARE = 0.75
INT8_MATCH_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
INT8_SHARD_TOL = {torch.float32: INT8_FLIP_TOL, torch.bfloat16: INT8_FLIP_TOL + 2.0 ** -8}
# Q2's launches for one bucket of each class (phase 19's counts).
INT8_BUCKET_Q2 = {"low": 8, "medium": 21, "high": 23}
# One Int8Conv2d of each body on 2 H shards, at the high branch's shapes at
# 512^2 (2 images): name -> (cin, cout, kernel, stride, padding, H).
INT8_SHARD_LAYERS = {"tile_3x3": (96, 96, 3, 1, 1, INT8_SHARD_SIZE),
                     "tile_4x4_s2": (96, 192, 4, 2, 1, INT8_SHARD_SIZE),
                     "gather_rgb_7x7": (3, 96, 7, 1, 3, INT8_SHARD_SIZE)}
# The 4c layer of the high branch on 2 channel shards (2 images at 64^2).
INT8_TP_LAYER = (384, 384, 3, 1, 1, SIZE // 4)
REFERENCE_SIZE = 128
REFERENCE_LABELS = (0, 1, 2)
INT8_SHARD_PATHS = ("int8_spatial", "int8_tp", "remat_spatial", "reference_checkpoint")


def int8_close(got, want, unquantized, dtype):
    """Int8 on shards `got` against the unsharded int8 `want` (see
    INT8_SHARD_TOL): {max abs error, mean abs error, the int8 noise's mean
    (`want` against the unquantized output), the share of elements within
    INT8_MATCH_ATOL (a reading), ok: max and mean within their bounds}."""
    err = (got.float() - want.float()).abs()
    noise = float((want.float() - unquantized.float()).abs().mean())
    rec = dict(max=float(err.max()), mean=float(err.mean()), noise_mean=noise,
               share_within=float((err <= INT8_MATCH_ATOL[dtype]).float().mean()))
    rec["ok"] = rec["max"] <= INT8_SHARD_TOL[dtype] and rec["mean"] <= INT8_DRAWS * noise
    return rec


def int8_close_text(rec, dtype):
    return (f"max abs err {rec['max']:.3e} (bound {INT8_SHARD_TOL[dtype]:.3e}), mean "
            f"{rec['mean']:.3e} (bound {INT8_DRAWS} x the int8 noise's mean {rec['noise_mean']:.3e}), "
            f"{100 * rec['share_within']:.2f} % within {INT8_MATCH_ATOL[dtype]:.1e} (a reading; "
            f"the CPU tests ask {100 * INT8_MATCH_SHARE:.0f} %)")


def int8_shard_layer(spec, dev, seed):
    """An Int8Conv2d of `spec` (eval BN with seeded statistics, ReLU) and its
    input (2 images, NCHW in channels_last), seeded alike on every rank."""
    from adam_dehaze_tpu_torch.ops.quant import Int8Conv2d
    cin, cout, k, stride, pad, h = spec
    gen = torch.Generator().manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, k, stride, pad, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * (k * k * cin) ** -0.5)
    layer = Int8Conv2d(conv.to(dev), random_eval_bn(cout, gen, dev), relu=True)
    x = torch.randn(2, cin, h, h, generator=gen)
    return layer, (x if cin == 3 else torch.relu(x)).to(dev).contiguous(
        memory_format=torch.channels_last)


def int8_layer_on_rows(name, mesh, dev):
    """A layer of INT8_SHARD_LAYERS: Q1's split on this rank's rows (its
    abs-max, the max over the group, the quantizing) against the one launch
    on the whole image, and the layer on the rows (Q2 on the taller shard,
    cropped) against the layer's rows of the whole image: bit for bit?"""
    from adam_dehaze_tpu_torch.ops.kernels.quant import image_absmax, quantize_images_at
    from adam_dehaze_tpu_torch.parallel.collectives import AllReduceMax
    from adam_dehaze_tpu_torch.parallel.spatial import spatial_sharding
    layer, x = int8_shard_layer(INT8_SHARD_LAYERS[name], dev, SEED + 40 + len(name))
    rows = mesh.axis("spatial")
    h = x.shape[2] // rows.size
    part = slice(rows.index * h, (rows.index + 1) * h)
    xh = x.permute(0, 2, 3, 1)
    xr = xh[:, part].contiguous()
    cin_pad = layer.geometry.cin_pad
    with torch.inference_mode():
        q, scale = quantize_images(xh, cin_pad)
        amax = AllReduceMax.apply(image_absmax(xr), rows)
        qr, scale_r = quantize_images_at(xr, amax, cin_pad)
        whole = layer(x)
        with spatial_sharding(mesh):
            got = layer(xr.permute(0, 3, 1, 2))
    torch.cuda.synchronize()
    return {"q1_bitwise": bool(torch.equal(qr, q[:, part]) and torch.equal(scale_r, scale)),
            "q2_bitwise": bool(torch.equal(got, whole[:, :, part.start // layer.geometry.stride:
                                                      part.stop // layer.geometry.stride])),
            "q2_max_abs_err": max_err(got.float(), whole[:, :, part.start // layer.geometry.stride:
                                                          part.stop // layer.geometry.stride]
                                      .float()),
            "body": layer.geometry.body}


def int8_layer_on_channels(mesh, dev):
    """INT8_TP_LAYER on this rank's input channels under channel_sharding
    against the whole layer's output channels of this rank: bit for bit?
    And the body its slice takes."""
    from adam_dehaze_tpu_torch.parallel.collectives import channel_slice
    from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
    layer, x = int8_shard_layer(INT8_TP_LAYER, dev, SEED + 45)
    axis = mesh.axis("model")
    with torch.inference_mode():
        whole = layer(x)
        with channel_sharding(mesh):
            got = layer(x[:, channel_slice(x.shape[1], axis)].contiguous(
                memory_format=torch.channels_last))
    want = whole[:, channel_slice(whole.shape[1], axis)]
    part = layer._operands(axis).geometry
    return {"q2_bitwise": bool(torch.equal(got, want)), "q2_max_abs_err": max_err(got, want),
            "slice_body": part.body, "slice_n_chunk": part.n_chunk, "slice_cout": part.cout}


def int8_route_call(d, x, labels, mesh=None):
    """The int8 dehazer's engine on forced labels (what route_hard runs
    after its classifier), through make_spatial_infer on this rank's rows
    when a mesh is given: (output on the CPU, launches, warm ms/image)."""
    from adam_dehaze_tpu_torch.parallel.spatial import make_spatial_infer, shard_image_batch
    serve = lambda t: d.engine(t, intensity=labels)[0]  # noqa: E731
    fn, arg = ((serve, x) if mesh is None else
               (make_spatial_infer(serve, mesh), shard_image_batch(mesh, x)))
    with torch.inference_mode():
        reset_launch_counts()
        out = fn(arg)
        torch.cuda.synchronize()
        launches = counts()
        ms = warm_ms(lambda: fn(arg), 2)[0] / x.shape[0]
    return out.float().cpu(), launches, ms


def int8_tp_call(model, x, dtype, mesh=None, quant=True):
    """The high branch's int8 serving apply (its unquantized one where not
    `quant`) on x, under channel_sharding when a mesh is given: (output on
    the CPU, launches)."""
    from adam_dehaze_tpu_torch.ops.quant import quantize_apply
    from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
    apply = quantize_apply(model, dtype) if quant else cast_for_serving(model, dtype)
    with torch.inference_mode(), (channel_sharding(mesh) if mesh is not None
                                  else contextlib.nullcontext()):
        reset_launch_counts()
        y = apply(x)
        torch.cuda.synchronize()
        launches = counts()
    return y.float().cpu(), launches


def remat_joint_step(dev, remat, mesh):
    """The soft joint step (augmentation off, dropout on) of the seeded
    default router on REMAT_ROWS images at SIZE^2, fp32, its forward under
    `cuda.remat: remat`, through shard_train_step: the metrics, gradients
    and BN statistics (on the CPU) and its launches."""
    cfg = dp_config()
    cfg["cuda"]["remat"] = remat
    router, state = tj.build_router_state(cfg, dev)
    joint_loss = get_joint_loss(cfg)
    nets = tj._loss_params(joint_loss, dev)
    batch = {k: v[:REMAT_ROWS] for k, v in dp_batch(dev).items()}
    replicate(mesh, state)
    step = shard_train_step(tj.make_train_step(joint_loss, nets, augmentation=False,
                                               remat=remat), mesh, batch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 46)
    reset_launch_counts()
    metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = counts()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.detach().cpu() for n, p in router.named_parameters()
                      if p.grad is not None},
            "stats": {k: v.detach().cpu() for k, v in router.state_dict().items()
                      if "running" in k}}, launches


def int8_shard_rank(part, rank, world, port, out_dir, dev=None):
    """One rank of phase 23: `python3 chip_smoke.py --int8-shard-rank PART
    RANK WORLD PORT OUT_DIR`. PART "rows" runs (a) and (c) over {"spatial":
    2}, "channels" (b) over {"model": 2}; `dev` is cuda:0 (another only to
    rehearse)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Every rank drives the one card: gloo over CUDA tensors (NCCL refuses
    # two ranks on one device), a choice made for one card.
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    try:
        state = torch.load(os.path.join(out_dir, "state.pt"), weights_only=True)
        router = make_router(load_config(), torch.Generator().manual_seed(SEED + 41))
        router.load_state_dict(state["router"])
        router.to(dev).eval()
        out = {}
        if part == "rows":
            mesh = make_mesh({"data": 1, "spatial": 2}, [dev] * 2)
            x = state["x"].to(dev)
            for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
                cfg = load_config(overrides={"cuda": {"compute_dtype": dtype,
                                                      "serving_quant": "int8"}})
                d = AdaptiveDehazer(router, None, cfg, device=dev)
                out[f"route_{name}"] = int8_route_call(d, x, np.asarray(INT8_SHARD_LABELS),
                                                       mesh)
                del d
            out["layers"] = {name: int8_layer_on_rows(name, mesh, dev)
                             for name in INT8_SHARD_LAYERS}
            del router
            gc.collect()
            torch.cuda.empty_cache()
            out["remat"] = {str(mode): remat_joint_step(dev, mode, mesh) for mode in (False, True)}
        else:
            mesh = make_mesh({"data": 1, "model": 2}, [dev] * 2)
            x = state["tp_x"].to(dev)
            for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                out[f"tp_{name}"] = int8_tp_call(router.models["high"], x, dtype, mesh)
            out["layer"] = int8_layer_on_channels(mesh, dev)
        torch.save(out, os.path.join(out_dir, f"{part}{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn_int8_shards(out_dir):
    """Phase 23's parts, their 2 ranks each, side by side: what the ranks
    saved, by part."""
    procs = {}
    for part in ("rows", "channels"):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs[part] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--int8-shard-rank", part, str(rank),
             "2", str(port), out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = _run_all(procs, INT8_SHARD_TIMEOUT_S)
    failed = [f"{part} rank {r} failed:\n{text[-6000:]}" for part, ps in procs.items()
              for r, (p, text) in enumerate(zip(ps, logs[part])) if p.returncode != 0]
    check(not failed, "\n".join(failed))
    return {part: [torch.load(os.path.join(out_dir, f"{part}{r}.pt"), weights_only=False)
                   for r in range(2)] for part in procs}


# Q1's two passes as the previous design ran them in this phase (groups of 64
# images walked by a grid sized from one image; NVIDIA H100 80GB HBM3 at
# 700.00 W, CUDA events, one bucket of each int8 branch): printed beside this
# run's readings.
Q1_SPLIT_GROUP_WALK_MS = {"int8_absmax": 1.775, "int8_quantize_at": 2.128}


def spread_images(shape, gen):
    """Images (N, H, W, C) whose ranges spread over 2^-10 to 2^10 in a seeded
    order (RGB inputs in [0, 1) scaled, the rest ReLU'd normals): a block
    that reads another image's values or scale changes a scale or an int8
    value, where images of one range round to the same bf16 maximum."""
    n = shape[0]
    x = torch.rand(shape, generator=gen) if shape[-1] == 3 else torch.relu(
        torch.randn(shape, generator=gen))
    exps = torch.linspace(-10.0, 10.0, n)[torch.randperm(n, generator=gen)] if n > 1 else \
        torch.zeros(1)
    return x * torch.exp2(exps + torch.rand(n, generator=gen)).view(n, 1, 1, 1)


def device_ms(fn, iters=10, events=1, tries=3):
    """Device time of fn() in ms per call under torch.profiler: every kernel
    and memset it puts on the card, summed, over `iters` calls after a warm
    one. A trace that holds fewer than `events` device entries a call (the
    profiler has been seen to return none for a window) is taken again, at
    most `tries` times in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.count for e in rows) >= events * iters:
            return sum(e.self_device_time_total for e in rows) / 1e3 / iters
    raise AssertionError(f"the profiler saw {sum(e.count for e in rows)} device entries in "
                         f"{iters} calls, {tries} times")


def q1_split_inputs(d8, dev):
    """Q1's two passes' inputs at the shapes of one bucket of each int8 branch
    (BATCH images at SIZE^2, phase 19's layers) on one of 2 H shards, bf16,
    with `spread_images` ranges: [(geometry, calls, x, amax)], amax the plain
    abs-max of x."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import image_absmax_reference
    layers, _, _ = int8_layers(d8, dev)
    gen = torch.Generator().manual_seed(SEED + 42)
    out = []
    for (geo, shape), calls in layers.items():
        n, h, w, c = shape
        xs = spread_images((n, h // 2, w, c), gen).to(torch.bfloat16).to(dev)
        out.append((geo, calls, xs, image_absmax_reference(xs)))
    return out


def q1_split_kernels(d8, dev):
    """Q1's two passes (`image_absmax`, `quantize_images_at`) at the shapes of
    `q1_split_inputs`: each against its plain version (bit for bit), timed
    beside it by CUDA events, its device time under the profiler over the
    bucket's calls, its bound and, for the abs-max, one PyTorch call of the
    same function (`torch.linalg.vector_norm`, ord inf) timed both ways."""
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        image_absmax,
        image_absmax_reference,
        quantize_images_at,
        quantize_images_at_reference,
    )
    inputs = q1_split_inputs(d8, dev)
    recs = {"int8_absmax": collections.Counter(), "int8_quantize_at": collections.Counter()}
    errs = {"int8_absmax": 0.0, "int8_quantize_at": 0.0}
    bitwise = True
    for geo, calls, xs, amax0 in inputs:
        with torch.inference_mode():
            amax = image_absmax(xs)
            q, s = quantize_images_at(xs, amax, geo.cin_pad)
            q0, s0 = quantize_images_at_reference(xs, amax, geo.cin_pad)
            bitwise = bitwise and bool(torch.equal(amax, amax0) and torch.equal(q, q0)
                                       and torch.equal(s, s0))
            errs["int8_absmax"] = max(errs["int8_absmax"], max_err(amax, amax0))
            errs["int8_quantize_at"] = max(errs["int8_quantize_at"], max_err(q, q0),
                                           max_err(s, s0))
            timings = {
                "int8_absmax": (cuda_ms(lambda: image_absmax(xs), 10, 2),
                                cuda_ms(lambda: image_absmax_reference(xs), 3, 1),
                                cuda_ms(lambda: torch.linalg.vector_norm(
                                    xs, float("inf"), dim=(1, 2, 3)), 10, 2),
                                bound(xs.numel(), nbytes(xs, amax), PEAK_F32_FLOPS)),
                "int8_quantize_at": (cuda_ms(lambda: quantize_images_at(xs, amax, geo.cin_pad),
                                             10, 2),
                                     cuda_ms(lambda: quantize_images_at_reference(
                                         xs, amax, geo.cin_pad), 3, 1),
                                     None,
                                     bound(4 * xs.numel(), nbytes(xs, amax, q, s),
                                           PEAK_F32_FLOPS))}
        for name, (ms, plain, lib, b) in timings.items():
            rec = recs[name]
            rec["ms"] += calls * ms
            rec["plain_ms"] += calls * plain
            if lib is not None:
                rec["library_ms"] += calls * lib
            for key in ("bound_ms", "bytes", "flops"):
                rec[key] += calls * b[key]
    check(bitwise, "(a) Q1's two passes differ from their plain versions")

    # Device time of the bucket's calls, each shape as often as the bucket calls it.
    def bucket(fn):
        return lambda: [fn(geo, xs, amax) for geo, calls, xs, amax in inputs
                        for _ in range(calls)]
    launches = sum(calls for _, calls, _, _ in inputs)
    with torch.inference_mode():
        recs["int8_absmax"]["device_ms"] = device_ms(bucket(lambda g, x, a: image_absmax(x)), 3,
                                                     launches)
        recs["int8_absmax"]["library_device_ms"] = device_ms(bucket(
            lambda g, x, a: torch.linalg.vector_norm(x, float("inf"), dim=(1, 2, 3))), 3, launches)
        recs["int8_quantize_at"]["device_ms"] = device_ms(bucket(
            lambda g, x, a: quantize_images_at(x, a, g.cin_pad)), 3, launches)
    per = (f"one {BATCH}-image bucket of each int8 branch at {SIZE}^2 on one of 2 H shards "
           f"({launches} convs, bf16, per-image ranges 2^-10 to 2^10)")
    out = {}
    for name, rec in recs.items():
        out[name] = dict(rec, max_abs_err=errs[name], per=per,
                         library_ms=rec.get("library_ms"),
                         bound_by="bytes" if rec["bytes"] / PEAK_BYTES_S
                         >= rec["flops"] / PEAK_F32_FLOPS else "operations")
        lib = ("" if name != "int8_absmax" else
               f"; vector_norm(ord=inf) {rec['library_ms']:.3f} ms, device "
               f"{rec['library_device_ms']:.3f} ms")
        log(f"[int8 shards] {name} per {per}: {rec['ms']:.3f} ms by CUDA events (the group-walk "
            f"design {Q1_SPLIT_GROUP_WALK_MS[name]:.3f}), device {rec['device_ms']:.3f} ms under "
            f"the profiler, bound {rec['bound_ms']:.3f} ms ({out[name]['bound_by']}, "
            f"{rec['bytes'] / 1e9:.2f} GB), {rec['ms'] / rec['bound_ms']:.2f}x it; plain "
            f"{rec['plain_ms']:.3f} ms{lib}; bitwise against its plain version")
    return out


def phase_reference_checkpoint(dev, smi, tmp):
    """(d) A seeded five-state joint checkpoint in the reference's layout at
    the default widths, converted by the port's tool, served through
    `_load_joint` and `route_hard`: fp32 on the card against the CPU at
    SLICE_ATOL; bf16 on the card launches K1 and K2. Returns the bf16
    path's launches and the readings."""
    import yaml

    from adam_dehaze_tpu_torch.config import update_checkpoint_paths
    from adam_dehaze_tpu_torch.tools import convert_reference_checkpoint
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    router = make_router(cfg, torch.Generator().manual_seed(SEED + 43))
    x = np.random.default_rng(SEED + 44).random(
        (len(REFERENCE_LABELS), REFERENCE_SIZE, REFERENCE_SIZE, 3), dtype=np.float32)
    balance_head_(router.classifier, torch.from_numpy(x), REFERENCE_LABELS)
    sd = router.state_dict()

    def under(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    pth = os.path.join(tmp, "reference_joint.pth")
    torch.save({"router_state_dict": sd, "classifier_state_dict": under("classifier."),
                **{f"{lvl}_model_state_dict": under(f"models.{lvl}.") for lvl in INTENSITY_ORDER},
                "optimizer_state_dict": {"state": {}, "param_groups": []}, "epoch": 0}, pth)
    exp = os.path.join(tmp, "reference_experiment")
    os.makedirs(exp)
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    ecfg = update_checkpoint_paths(cfg, exp)
    convert_reference_checkpoint.main(
        ["--kind", "joint", "--pth", pth, "--config", os.path.join(exp, "config.yaml"),
         "--out", os.path.join(ecfg["joint_training"]["checkpoint_dir"], "best_model")])
    outs = {}
    for tag, device in (("card", dev), ("cpu", "cpu")):
        served = det_eval._load_joint(ecfg, device)
        check(all(torch.equal(v.cpu(), sd[k]) for k, v in served.state_dict().items()),
              f"(d) the converted joint checkpoint on {tag} is not the reference's")
        outs[tag] = AdaptiveDehazer(served, None, ecfg, device=device).route_hard(x)
        del served
    err = float(np.abs(outs["card"][0] - outs["cpu"][0]).max())
    labels = [outs[t][1].tolist() for t in ("card", "cpu")]
    check(labels == [list(REFERENCE_LABELS)] * 2, f"(d) route_hard labels {labels}")
    check(err <= SLICE_ATOL, f"(d) the converted checkpoint's fp32 route differs by {err}")
    cfg16 = load_config(overrides={"cuda": {"compute_dtype": "bfloat16"}})
    ecfg16 = update_checkpoint_paths(cfg16, exp)
    d16 = AdaptiveDehazer(det_eval._load_joint(ecfg16, dev), None, ecfg16, device=dev)
    reset_launch_counts()
    y16, lab16 = d16.route_hard(x)
    torch.cuda.synchronize()
    path = counts()
    err16 = float(np.abs(y16 - outs["cpu"][0]).max())
    log(f"[reference checkpoint] (d) a seeded five-state joint .pth at the default widths, "
        f"converted (tools/convert_reference_checkpoint.py) and served by _load_joint -> "
        f"route_hard, {len(REFERENCE_LABELS)} images at {REFERENCE_SIZE}^2: labels {labels[0]}; "
        f"fp32 card vs CPU max abs err {err:.3e} (bound {SLICE_ATOL:.0e}); bf16 on the card, "
        f"labels {lab16.tolist()}, launches {nonzero(path)}, against the fp32 CPU route "
        f"{err16:.3e} (a reading); {smi}")
    check(path.get("lightweight_chain", 0) > 0 and path.get("cbam_gate", 0) > 0,
          f"(d) bf16 route_hard launched {nonzero(path)}")
    del d16
    torch.cuda.empty_cache()
    return path, dict(fp32_card_vs_cpu=err, bf16_card_vs_fp32_cpu=err16, labels=labels[0])


def phase_int8_shards(dev, smi, tmp):
    """23. Int8 serving and cuda.remat on the spatial and model axes, and a
    converted reference checkpoint (see the docstring). Returns the paths'
    launch counts, the records of Q1's two passes and the readings."""
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(tmp, "int8_shards")
    os.makedirs(out_dir)
    paths = {p: collections.Counter() for p in INT8_SHARD_PATHS}
    readings = {}
    gen = torch.Generator().manual_seed(SEED + 41)
    router = make_router(load_config(), gen)
    rng = np.random.default_rng(SEED + 47)
    x = torch.from_numpy(rng.random((len(INT8_SHARD_LABELS), INT8_SHARD_SIZE, INT8_SHARD_SIZE, 3),
                                    dtype=np.float32))
    tp_x = torch.from_numpy(rng.random((INT8_TP_ROWS, SIZE, SIZE, 3), dtype=np.float32))
    torch.save({"router": router.state_dict(), "x": x, "tp_x": tp_x},
               os.path.join(out_dir, "state.pt"))
    router.to(dev).eval()

    # The one-process references first, alone on the card; Q1's two passes
    # timed at the main path's shard shapes.
    ref, unquantized = {}, {}
    for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        for quant in ("int8", None):
            cfg = load_config(overrides={"cuda": {"compute_dtype": dtype,
                                                  "serving_quant": quant}})
            d = AdaptiveDehazer(router, None, cfg, device=dev)
            out = int8_route_call(d, x.to(dev), np.asarray(INT8_SHARD_LABELS))
            if quant:
                ref[f"route_{name}"] = out
            else:
                unquantized[f"route_{name}"] = out[0]
            if quant and name == "bf16":
                q1_recs = q1_split_kernels(d, dev)
            del d
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ref[f"tp_{name}"] = int8_tp_call(router.models["high"], tp_x.to(dev), dtype)
        unquantized[f"tp_{name}"] = int8_tp_call(router.models["high"], tp_x.to(dev), dtype,
                                                 quant=False)[0]
    del router
    gc.collect()
    torch.cuda.empty_cache()

    ranks = spawn_int8_shards(out_dir)
    rows, cols = ranks["rows"], ranks["channels"]
    failed = []

    # (a) int8 route on 2 H shards, forced labels.
    want_q2 = sum(INT8_BUCKET_Q2[INTENSITY_ORDER[c]] for c in set(INT8_SHARD_LABELS))
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        want, want_launches, ms = ref[f"route_{name}"]
        got = torch.cat([r[f"route_{name}"][0] for r in rows], 1)
        close = int8_close(got, want, unquantized[f"route_{name}"], dtype)
        rank_launches = [nonzero(r[f"route_{name}"][1]) for r in rows]
        for r in rows:
            paths["int8_spatial"].update(r[f"route_{name}"][1])
        readings[f"int8_spatial_{name}"] = dict(
            close, launches_per_rank=rank_launches, unsharded_launches=nonzero(want_launches),
            ms_per_image_per_rank=[r[f"route_{name}"][2] for r in rows], unsharded_ms_per_image=ms)
        log(f"[int8 spatial] (a) int8 engine on labels {list(INT8_SHARD_LABELS)}, "
            f"{len(INT8_SHARD_LABELS)} images at {INT8_SHARD_SIZE}^2, {name}, over spatial=2 (2 "
            f"gloo ranks on cuda:0) vs unsharded: {int8_close_text(close, dtype)}; launches a "
            f"rank {rank_launches}, unsharded {nonzero(want_launches)}; warm ms/image a rank "
            f"{readings[f'int8_spatial_{name}']['ms_per_image_per_rank']}, unsharded {ms:.3f}; "
            f"{smi} (a reading: both ranks share the card)")
        failed += [f"(a) {name}: int8 on H shards off the unsharded int8 ({close})"] * (
            not close["ok"])
        for got_l in (r[f"route_{name}"][1] for r in rows):
            expect = {"int8_conv": want_q2, "int8_absmax": want_q2, "int8_quantize_at": want_q2,
                      "int8_quantize": 0, "cbam_gate": 6}
            seen = {k: got_l.get(k, 0) for k in expect}
            failed += [f"(a) {name}: a rank launched {seen}, expected {expect}"] * (seen != expect)
        check(want_launches.get("int8_conv", 0) == want_q2
              and want_launches.get("int8_quantize", 0) == want_q2,
              f"(a) {name}: the unsharded route launched {nonzero(want_launches)}")
    layer_recs = {name: [r["layers"][name] for r in rows] for name in INT8_SHARD_LAYERS}
    readings["int8_spatial_layers"] = layer_recs
    for name, recs in layer_recs.items():
        log(f"[int8 spatial] (a) {name} {INT8_SHARD_LAYERS[name][:5]} at 2 x "
            f"{INT8_SHARD_LAYERS[name][5]}^2, {recs[0]['body']} body: Q1's split bitwise "
            f"{[r['q1_bitwise'] for r in recs]}, Q2 on the taller shard bitwise "
            f"{[r['q2_bitwise'] for r in recs]} (max abs err "
            f"{max(r['q2_max_abs_err'] for r in recs):.3e}); {smi}")
        failed += [f"(a) {name}: not bit for bit: {recs}"] * (
            not all(r["q1_bitwise"] and r["q2_bitwise"] for r in recs))

    # (b) the high branch's int8 on 2 channel shards.
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        want, want_launches = ref[f"tp_{name}"]
        errs = []
        for r in cols:
            paths["int8_tp"].update(r[f"tp_{name}"][1])
            errs.append(int8_close(r[f"tp_{name}"][0], want, unquantized[f"tp_{name}"], dtype))
        rank_launches = [nonzero(r[f"tp_{name}"][1]) for r in cols]
        readings[f"int8_tp_{name}"] = dict(errors=errs, launches_per_rank=rank_launches,
                                           unsharded_launches=nonzero(want_launches))
        for rank, close in enumerate(errs):
            log(f"[int8 tp] (b) high branch c={load_config()['dehazing']['high']['channels']} "
                f"int8, {name}, {INT8_TP_ROWS} images at {SIZE}^2 under channel_sharding, "
                f"model=2, rank {rank} vs unsharded: {int8_close_text(close, dtype)}; launches "
                f"{rank_launches[rank]}, unsharded {nonzero(want_launches)}; {smi}")
        failed += [f"(b) {name}: int8 on channel shards off the unsharded int8 {errs}"] * (
            not all(e["ok"] for e in errs))
        for got_l in rank_launches:
            seen = {k: got_l.get(k, 0) for k in ("int8_conv", "int8_quantize", "cbam_gate")}
            expect = {k: want_launches.get(k, 0) for k in seen}
            failed += [f"(b) {name}: a rank launched {seen}, unsharded {expect}"] * (
                seen != expect)
    tp_layer = [r["layer"] for r in cols]
    readings["int8_tp_layer"] = tp_layer
    log(f"[int8 tp] (b) {INT8_TP_LAYER[:5]} at 2 x {INT8_TP_LAYER[5]}^2 on 2 channel shards: "
        f"each rank's slice {[(r['slice_cout'], r['slice_body'], r['slice_n_chunk']) for r in tp_layer]}"
        f" (cout, body, chunk), bitwise {[r['q2_bitwise'] for r in tp_layer]}; {smi}")
    failed += [f"(b) the 4c layer on channel shards: {tp_layer}"] * (
        not all(r["q2_bitwise"] and r["slice_body"] == "tile" for r in tp_layer))

    # (c) the soft joint step under cuda.remat on 2 H shards.
    for r, out in enumerate(rows):
        (plain, plain_l), (remat, remat_l) = out["remat"]["False"], out["remat"]["True"]
        paths["remat_spatial"].update(remat_l)
        errs = dp_errors(remat, plain, f"(c) soft joint step under cuda.remat true, "
                         f"{REMAT_ROWS} images at {SIZE}^2, fp32, spatial=2, rank {r}, against "
                         "the same sharded step without remat", smi, tag="remat spatial",
                         bounds=JOINT_BOUNDS["float32"])
        readings[f"remat_spatial_rank{r}"] = dict(errors=errs, launches=nonzero(remat_l),
                                                  launches_without=nonzero(plain_l))
        log(f"[remat spatial] (c) rank {r}: K2 launches {remat_l.get('cbam_gate', 0)} under remat, "
            f"{plain_l.get('cbam_gate', 0)} without; K5 {remat_l.get('blend3', 0)} and "
            f"{plain_l.get('blend3', 0)}; {smi}")
        failed += [f"(c) rank {r}: K2 {remat_l.get('cbam_gate')} under remat, "
                   f"{plain_l.get('cbam_gate')} without"] * (
            remat_l.get("cbam_gate", 0) != 2 * plain_l.get("cbam_gate", 0)
            or plain_l.get("cbam_gate", 0) == 0)
        failed += [f"(c) rank {r}: K5 {remat_l.get('blend3')} under remat, "
                   f"{plain_l.get('blend3')} without"] * (
            remat_l.get("blend3", 0) < plain_l.get("blend3", 0) or plain_l.get("blend3", 0) == 0)
    check(not failed, "; ".join(failed))

    # (d) the converted reference checkpoint.
    ref_path, ref_readings = phase_reference_checkpoint(dev, smi, tmp)
    paths["reference_checkpoint"].update(ref_path)
    readings["reference_checkpoint"] = ref_readings
    for name in ("int8_absmax", "int8_quantize_at", "int8_conv"):
        check(paths["int8_spatial"][name] > 0, f"the int8 spatial path launched no {name}")
    check(paths["int8_tp"]["int8_conv"] > 0, "the int8 tp path launched no int8_conv")
    torch.cuda.empty_cache()
    return {k: dict(v) for k, v in paths.items()}, q1_recs, readings


# Phase 24: resizes and adaptive pools on an H shard (parallel/sharded_ops.py):
# the branches and the dial whose paths resize, each part's ranks in a gloo
# group on cuda:0 (this script with `--resize-rank`), held against the
# one-process unsharded call on the same card. One card holds every rank, so
# nothing here shows scaling.
RESIZE_SIZE = 512
RESIZE_WIDTH = 490
RESIZE_ROWS = 2
RESIZE_LABELS = (0, 1, 2, 0)
RESIZE_TIMEOUT_S = 240
RESIZE_DTYPES = (("fp32", torch.float32), ("bf16", torch.bfloat16))
# Sharded against unsharded: fp32 where only the resizes' sums move (their
# weights are the unsharded op's, contracted in another order); bf16 at
# phase 21's bound, or within the unsharded bf16 call's own distance from the
# fp32 call where that is larger: a bf16 rounding that the shards' other
# summation orders flip (cuDNN's algorithms by shape, the H pass's fp32
# contraction) grows through a deep full-resolution net as bf16's own
# roundings do (corun read 5 bf16 steps: PERF.md).
RESIZE_ATOL = {torch.float32: 1e-5, torch.bfloat16: SHARD_ATOL[torch.bfloat16]}
# (d): one resize on shards against the unsharded op: fp32 RESIZE_OP_ATOL;
# bf16 one bf16 step of the largest value (the H pass rounds once, after its
# fp32 contraction, as the unsharded op rounds once).
RESIZE_OP_ATOL = 1e-6
# The dial's guided lift divides differences of box means of float32
# integral images, and a taller shard sums their rows in another order: the
# dial's route is held within LIFT_K times the lift's own float32 error on
# these images against float64 (phase 16's rule), and at RESIZE_ATOL at least.
DIAL_LEVELS = ("low", "medium", "high")
DIAL_PATH_KERNELS = {"default": SHARDED_PATH_KERNELS, "tuned": TUNED_PATH_KERNELS}
# K2's launches in one call of each branch of (a) and (c): one an
# AttentionBlock.
RESIZE_K2 = {"corun": 0, "dual_branch": 2, "medium": 0, "high": 6}


def resize_models(state, dev):
    """The phase's modules from the saved state on `dev`: the corun and
    dual_branch alternates at the default widths and the default router."""
    cfg = load_config()
    alts = {"corun": COrunInspiredModel(cfg["dehazing"]["medium"]["channels"],
                                        cfg["dehazing"]["medium"]["blocks"]),
            "dual_branch": DualBranchAttentionModel(cfg["dehazing"]["high"]["channels"],
                                                    cfg["dehazing"]["high"]["blocks"])}
    for name, model in alts.items():
        model.load_state_dict(state[name])
        model.to(dev).eval()
    router = make_router(cfg, torch.Generator().manual_seed(SEED + 51))
    router.load_state_dict(state["router"])
    return alts, router.to(dev).eval()


def resize_forward(model, x, dtype, mesh=None):
    """A branch's serving copy in `dtype` on x, through make_spatial_infer on
    this rank's rows when a mesh is given: (output, its launches, warm
    ms/image)."""
    from adam_dehaze_tpu_torch.parallel.spatial import make_spatial_infer, shard_image_batch
    copy_ = cast_for_serving(model, dtype)
    fn, arg = ((copy_, x) if mesh is None else
               (make_spatial_infer(copy_, mesh), shard_image_batch(mesh, x)))

    def run():
        with torch.inference_mode():
            return fn(arg)

    reset_launch_counts()
    y = run()
    torch.cuda.synchronize()
    launches = counts()
    ms = warm_ms(run, 1)[0] / x.shape[0]
    return y.float().cpu(), launches, ms


def resize_dehazer(router, dev, dtype_name, dispatch, out_dir):
    cfg = load_config(overrides={"cuda": {"compute_dtype": dtype_name}})
    if dispatch == "default":
        return AdaptiveDehazer(router, None, cfg, device=dev)
    return tuned_dehazer(router, dev, dtype_name, os.path.join(out_dir, f"tuned_{dtype_name}.json"))


def dial_resizes(dev, mesh):
    """The dial's two resizes (the antialiased shrink 512^2 -> 256^2, the
    lift 256^2 -> 512^2), corun's align-corners upsample (256^2 -> 512^2)
    and the W-only resizes of the decoders (bilinear with antialias and with
    align-corners, 512 x 512 -> 512 x 490) on random maps, fp32 and bf16, on
    this rank's rows and on the whole map: name -> (max abs err of the rows,
    max|whole|, bit for bit)."""
    from adam_dehaze_tpu_torch.nn.blocks import resize_bilinear, resize_bilinear_align_corners
    from adam_dehaze_tpu_torch.parallel.spatial import spatial_sharding
    rows = mesh.axis("spatial")
    gen = torch.Generator().manual_seed(SEED + 53)
    x = torch.rand(RESIZE_ROWS, 3, RESIZE_SIZE, RESIZE_SIZE, generator=gen).to(dev)
    lo = torch.rand(RESIZE_ROWS, 3, RESIZE_SIZE // 2, RESIZE_SIZE // 2, generator=gen).to(dev)
    half, w = RESIZE_SIZE // 2, RESIZE_WIDTH
    cases = {"shrink": (resize_bilinear, x, (half, half)),
             "lift": (resize_bilinear, lo, (RESIZE_SIZE, RESIZE_SIZE)),
             "align_corners_upsample": (resize_bilinear_align_corners, lo,
                                        (RESIZE_SIZE, RESIZE_SIZE)),
             "w_only_antialiased": (resize_bilinear, x, (RESIZE_SIZE, w)),
             "w_only_align_corners": (resize_bilinear_align_corners, x, (RESIZE_SIZE, w))}
    out = {}
    with torch.inference_mode():
        for tag, dtype in RESIZE_DTYPES:
            for name, (fn, t, size) in cases.items():
                t = t.to(dtype)
                whole = fn(t, size)
                n = t.shape[2] // rows.size
                with spatial_sharding(mesh):
                    part = fn(t[:, :, rows.index * n:(rows.index + 1) * n].contiguous(),
                              (size[0] // rows.size, size[1]))
                want = whole.narrow(2, rows.index * part.shape[2], part.shape[2])
                out[f"{name}_{tag}"] = (max_err(part, want), float(whole.float().abs().max()),
                                        bool(torch.equal(part, want)))
    torch.cuda.synchronize()
    return out


def resize_rank(rank, world, port, out_dir, dev=None):
    """One rank of phase 24: `python3 chip_smoke.py --resize-rank RANK WORLD
    PORT OUT_DIR`, over {"spatial": 2}; `dev` is cuda:0 (another only to
    rehearse)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Every rank drives the one card: gloo over CUDA tensors (NCCL refuses
    # two ranks on one device), a choice made for one card.
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    try:
        state = torch.load(os.path.join(out_dir, "state.pt"), weights_only=True)
        alts, router = resize_models(state, dev)
        mesh = make_mesh({"data": 1, "spatial": 2}, [dev] * 2)
        out = resize_calls(state, alts, router, dev, out_dir, mesh)
        out["resizes"] = dial_resizes(dev, mesh)
        torch.save(out, os.path.join(out_dir, f"resize{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def resize_calls(state, alts, router, dev, out_dir, mesh=None):
    """(a), (b) and (c) on the whole images, or through make_spatial_infer on
    this rank's rows when a mesh is given."""
    x, x490 = state["x"].to(dev), state["x490"].to(dev)
    out = {}
    for name, dtype in RESIZE_DTYPES:
        for alt, model in alts.items():
            out[f"{alt}_{name}"] = resize_forward(model, x, dtype, mesh)
        for lvl in ("medium", "high"):
            out[f"{lvl}_{RESIZE_WIDTH}_{name}"] = resize_forward(router.models[lvl], x490, dtype,
                                                                  mesh)
    for dispatch in ("default", "tuned"):
        for name, dtype in RESIZE_DTYPES:
            d = resize_dehazer(router, dev, str(dtype).replace("torch.", ""), dispatch, out_dir)
            out[f"dial_{dispatch}_{name}"] = route_call(d, state["route_x"].to(dev), mesh,
                                                        lowres=DIAL_LEVELS)
            del d
    gc.collect()
    return out


def spawn_resize(out_dir):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = {"resize": [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--resize-rank", str(rank), "2", str(port),
         out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]}
    logs = _run_all(procs, RESIZE_TIMEOUT_S)
    failed = [f"resize rank {r} failed:\n{text[-6000:]}"
              for r, (p, text) in enumerate(zip(procs["resize"], logs["resize"]))
              if p.returncode != 0]
    check(not failed, "\n".join(failed))
    return [torch.load(os.path.join(out_dir, f"resize{r}.pt"), weights_only=False)
            for r in range(2)]


def dial_lift_error(router, dev, x, labels):
    """The guided lift's own float32 error at (b)'s shapes: the fp32 default
    dehazer's branches at half resolution on x's shrink (labels forced),
    lifted in float32 and in float64 on the card."""
    from adam_dehaze_tpu_torch.ops import resolution
    d = AdaptiveDehazer(router, None, load_config(overrides={"cuda": {"compute_dtype":
                                                                      "float32"}}), device=dev)
    half = RESIZE_SIZE // 2
    x_lo = resolution._resize_nhwc(x, (half, half))
    with torch.inference_mode():
        y_lo = d.engine.dispatch(x_lo, np.asarray(labels))

    def lift(xx, xx_lo, yy_lo):
        corr = resolution.guided_upsample(resolution._gray(xx), resolution._gray(xx_lo),
                                          yy_lo - xx_lo)
        return torch.clamp(xx + corr, 0.0, 1.0)

    with torch.inference_mode():
        err = max_err(lift(x, x_lo, y_lo.float()), lift(x.double(), x_lo.double(), y_lo.double()))
    del d
    return err


def phase_resize(dev, smi, tmp):
    """24. Resizes and adaptive pools on an H shard (see the docstring).
    Returns the paths' launch counts and the phase's readings."""
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(tmp, "resize")
    os.makedirs(out_dir)
    cfg = load_config()
    gen = torch.Generator().manual_seed(SEED + 51)
    router = make_router(cfg, gen)
    corun = perturb_bn_(init_params_(COrunInspiredModel(cfg["dehazing"]["medium"]["channels"],
                                                        cfg["dehazing"]["medium"]["blocks"]),
                                     gen), gen)
    dual = perturb_bn_(init_params_(DualBranchAttentionModel(cfg["dehazing"]["high"]["channels"],
                                                             cfg["dehazing"]["high"]["blocks"]),
                                    gen), gen)
    rng = np.random.default_rng(SEED + 52)
    x = torch.from_numpy(rng.random((RESIZE_ROWS, RESIZE_SIZE, RESIZE_SIZE, 3), dtype=np.float32))
    x490 = torch.from_numpy(rng.random((RESIZE_ROWS, RESIZE_SIZE, RESIZE_WIDTH, 3),
                                       dtype=np.float32))
    route_x = torch.from_numpy(rng.random((len(RESIZE_LABELS), RESIZE_SIZE, RESIZE_SIZE, 3),
                                          dtype=np.float32))
    router.to(dev)
    balance_head_(router.classifier, route_x.to(dev), RESIZE_LABELS)
    state = {"router": {k: v.cpu() for k, v in router.state_dict().items()},
             "corun": corun.state_dict(), "dual_branch": dual.state_dict(), "x": x,
             "x490": x490, "route_x": route_x}
    torch.save(state, os.path.join(out_dir, "state.pt"))
    alts, router = resize_models(state, dev)
    # The tuned caches of phase 22 where it ran (their keys hold no weights),
    # else each winner timed once here.
    for name in ("bfloat16", "float32"):
        path = os.path.join(out_dir, f"tuned_{name}.json")
        done = os.path.join(tmp, "joint_sharded", f"tuned_{name}.json")
        if os.path.exists(done):
            shutil.copy(done, path)
        else:
            tuned_cache(router, dev, getattr(torch, name), path)
    # The one-process references first, alone on the card.
    ref = resize_calls(state, alts, router, dev, out_dir)
    lift_err = dial_lift_error(router, dev, route_x.to(dev), RESIZE_LABELS)
    del alts, router
    gc.collect()
    torch.cuda.empty_cache()

    ranks = spawn_resize(out_dir)
    paths = {p: collections.Counter() for p in ("resize_alternates", "resize_dial_default",
                                                   "resize_dial_tuned", "resize_decoders")}
    readings, failed = {"lift_fp32_err": lift_err}, []

    # (a) corun and dual_branch at 512^2, (c) the medium and high branches at
    # 512 x 490, each on 2 H shards.
    for name, dtype in RESIZE_DTYPES:
        for branch, key, what, path in (
                [(alt, f"{alt}_{name}", f"(a) {alt}", "resize_alternates")
                 for alt in ("corun", "dual_branch")]
                + [(lvl, f"{lvl}_{RESIZE_WIDTH}_{name}", f"(c) {lvl} branch", "resize_decoders")
                   for lvl in ("medium", "high")]):
            want, want_launches, ms = ref[key]
            # The unsharded bf16 call's own distance from the fp32 call.
            own = (max_err(want, ref[key.replace(name, "fp32")][0])
                   if dtype == torch.bfloat16 else 0.0)
            bound = max(RESIZE_ATOL[dtype], own)
            got = torch.cat([r[key][0] for r in ranks], 1)
            err = max_err(got, want)
            rank_launches = [nonzero(r[key][1]) for r in ranks]
            for r in ranks:
                paths[path].update(r[key][1])
            readings[key] = dict(max_abs_err=err, bound=bound, unsharded_bf16_vs_fp32=own,
                                 launches_per_rank=rank_launches,
                                 unsharded_launches=nonzero(want_launches),
                                 ms_per_image_per_rank=[r[key][2] for r in ranks],
                                 unsharded_ms_per_image=ms)
            log(f"[resize spatial] {what}, {name}, {RESIZE_ROWS} images at "
                f"{RESIZE_SIZE}x{tuple(got.shape)[2]} over spatial=2 (2 gloo ranks on cuda:0): "
                f"max abs err vs unsharded {err:.3e} (bound {bound:.3e}; unsharded bf16 vs "
                f"fp32 {own:.3e}); K2 "
                f"launches a rank {[r.get('cbam_gate', 0) for r in rank_launches]}, unsharded "
                f"{want_launches.get('cbam_gate', 0)}; warm ms/image a rank "
                f"{[round(r[key][2], 3) for r in ranks]}, unsharded {ms:.3f}; {smi} (a reading: "
                "both ranks share the card)")
            failed += [f"{what} {name}: sharded differs by {err}"] * (err > bound)
            failed += [f"{what} {name}: K2 launches a rank {rank_launches}, expected "
                       f"{RESIZE_K2[branch]}"] * (
                any(r.get("cbam_gate", 0) != RESIZE_K2[branch] for r in rank_launches))

    # (b) route_hard with the dial on every branch, default and tuned dispatch.
    for dispatch in ("default", "tuned"):
        for name, dtype in RESIZE_DTYPES:
            key = f"dial_{dispatch}_{name}"
            want, labels, want_launches, ms = ref[key]
            bound = max(RESIZE_ATOL[dtype], LIFT_K * lift_err)
            check(labels == list(RESIZE_LABELS), f"(b) the unsharded route's labels {labels}")
            got = torch.cat([r[key][0] for r in ranks], 1)
            err = max_err(got, want)
            rank_launches = [nonzero(r[key][2]) for r in ranks]
            for r in ranks:
                paths[f"resize_dial_{dispatch}"].update(r[key][2])
                failed += [f"(b) {key}: a rank routed {r[key][1]}, unsharded {labels}"] * (
                    r[key][1] != labels)
            readings[key] = dict(max_abs_err=err, bound=bound, launches_per_rank=rank_launches,
                                 unsharded_launches=nonzero(want_launches),
                                 ms_per_image_per_rank=[r[key][3] for r in ranks],
                                 unsharded_ms_per_image=ms)
            log(f"[resize spatial] (b) route_hard, lowres={list(DIAL_LEVELS)}, {dispatch} "
                f"dispatch, {name}, {len(RESIZE_LABELS)} images at {RESIZE_SIZE}^2 over "
                f"spatial=2: labels {labels} on every rank; max abs err vs unsharded {err:.3e} "
                f"(bound {bound:.3e}: {LIFT_K:g}x the lift's own fp32 error {lift_err:.3e}, or "
                f"{RESIZE_ATOL[dtype]:.0e}); launches a rank {rank_launches}, unsharded "
                f"{nonzero(want_launches)}; warm ms/image a rank "
                f"{[round(r[key][3], 3) for r in ranks]}, unsharded {ms:.3f}; {smi}")
            failed += [f"(b) {key}: sharded differs by {err}"] * (err > bound)
            kernels = DIAL_PATH_KERNELS[dispatch]
            failed += [f"(b) {key}: a rank launched {got_l}, unsharded {nonzero(want_launches)}"
                       for got_l in rank_launches
                       if {k: got_l.get(k, 0) for k in kernels}
                       != {k: want_launches.get(k, 0) for k in kernels}]

    # (d) the dial's resizes, corun's upsample and the decoders' W-only
    # resizes alone.
    for name in ranks[0]["resizes"]:
        errs = [r["resizes"][name][0] for r in ranks]
        top = max(r["resizes"][name][1] for r in ranks)
        bitwise = [r["resizes"][name][2] for r in ranks]
        w_only = name.startswith("w_only")
        # bf16: one bf16 step (ulp) of the largest value.
        bound = (0.0 if w_only else RESIZE_OP_ATOL if name.endswith("fp32")
                 else 2.0 ** (math.floor(math.log2(top)) - 7))
        readings[f"resize_{name}"] = dict(max_abs_err=max(errs), bound=bound, bitwise=bitwise)
        log(f"[resize spatial] (d) {name}, {RESIZE_ROWS} x 3 maps on 2 H shards: max abs err vs "
            f"unsharded {max(errs):.3e} (bound {bound:.3e}{', bit for bit' if w_only else ''}); "
            f"bit for bit {bitwise}; {smi}")
        failed += [f"(d) {name}: {errs} {bitwise}"] * (
            (w_only and not all(bitwise)) or max(errs) > bound)
    check(not failed, "; ".join(failed))
    for dispatch in ("default", "tuned"):
        for k in DIAL_PATH_KERNELS[dispatch]:
            check(paths[f"resize_dial_{dispatch}"][k] > 0,
                  f"the {dispatch} dial on shards launched no {k}")
    for p in ("resize_alternates", "resize_decoders"):
        check(paths[p]["cbam_gate"] > 0, f"{p} launched no cbam_gate")
    torch.cuda.empty_cache()
    return {k: dict(v) for k, v in paths.items()}, readings


# Phase 25: the day-one tools on the card. Which kernels each tool's path
# must launch: K1 and K2 where a tool serves or evaluates, K5 where the soft
# router runs; K2 (and K5 in soft mode) in the throughput tool's steps. The
# hard-routing rerun serves each test image on its classifier's branch
# only, so it must launch K1 where the classifier routes an image low and K2
# where it routes one high (HARD_ROUTED_KERNELS).
TOOL_PATH_KERNELS = {
    "tools_validate": ("lightweight_chain", "cbam_gate", "blend3"),
    "tools_rerun_detection": ("lightweight_chain", "cbam_gate", "blend3"),
    "tools_collect": ("lightweight_chain", "cbam_gate", "blend3"),
    "tools_throughput_soft": ("cbam_gate", "blend3"),
    "tools_throughput_hard": ("cbam_gate",),
}
# The validation tool's kinds, each with its arguments; the branch at the
# high level, whose AttentionBlocks run K2.
HARD_ROUTED_KERNELS = {0: "lightweight_chain", 2: "cbam_gate"}
VALIDATE_KINDS = {"classifier": [], "branch": ["--level", "high"], "joint": [], "fcos": []}
VALIDATE_TIMEOUT_S = 600
# The throughput tool at its own default batch, the default widths and
# 256^2, over 10 timed steps (its default is 20): the soft step under each
# cuda.remat, the hard round without, and the first run again last: its
# two readings bound the drift within the call that a remat's cost is read
# against.
THROUGHPUT_BATCH = 16
THROUGHPUT_STEPS = 10
THROUGHPUT_RUNS = (("soft", "none"), ("soft", "full"), ("soft", "fullres"), ("hard", "none"),
                   ("soft", "none"))


def phase_tools(dev, smi, tmp, exp):
    """25. The day-one tools (see the docstring). Returns the launches of
    each tool's path and the readings."""
    from adam_dehaze_tpu_torch.tools import (
        collect_round_results,
        measure_train_throughput,
        rerun_detection_eval,
        rerun_hard_routing_eval,
    )
    paths, readings, failed = {}, {}, []

    def tool_run(fn, argv):
        """(fn(argv), its seconds, the launches it made)."""
        reset_launch_counts()
        t = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, counts()

    # (a) the four kinds at once, each in its own process (it starts the
    # converter and a fresh process for the restore), while (b) runs here.
    procs = {kind: [subprocess.Popen(
        [sys.executable, "-m", "adam_dehaze_tpu_torch.tools.validate_real_weights", "--kind",
         kind, "--selftest", "--workdir", os.path.join(tmp, "validate", kind), "--device",
         dev.type, *extra], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
        for kind, extra in VALIDATE_KINDS.items()}
    t0 = time.perf_counter()
    try:
        # (b) the reruns and the collector on phase 15's experiment.
        results = os.path.join(exp, "results", "metrics", "comprehensive_results.json")
        with open(results) as f:
            before = json.load(f)
        served = AdaptiveDehazer.from_experiment(exp, device=dev)
        routed = np.bincount(np.concatenate([
            served.classify(batch["hazy"][batch["mask"]])
            for batch in get_dataloader(served.config, "test")]), minlength=3)
        del served
        hard, hard_s, paths["tools_rerun_hard_routing"] = tool_run(
            rerun_hard_routing_eval.main, ["--experiment_dir", exp, "--device", dev.type])
        det, det_s, paths["tools_rerun_detection"] = tool_run(
            rerun_detection_eval.main, ["--experiment_dir", exp, "--device", dev.type])
        with open(results) as f:
            after = json.load(f)
        check(after["hard_routing"] == json.loads(json.dumps(hard)),
              "tools: rerun_hard_routing_eval did not patch its rows")
        check(set(after["detection"]) == {"hazy", "dehazed", "improvement_percent"}
              and after["detection"]["dehazed"] == json.loads(json.dumps(
                  det["dehazed"]["overall"])),
              f"tools: rerun_detection_eval patched {after.get('detection')}")
        check({k: v for k, v in after.items() if k not in ("hard_routing", "detection")}
              == {k: v for k, v in before.items() if k not in ("hard_routing", "detection")},
              "tools: the reruns changed other rows of comprehensive_results.json")
        check(os.path.exists(os.path.join(exp, "results", "metrics", "detection_results.json")),
              "tools: rerun_detection_eval wrote no detection_results.json")
        full = os.path.join(tmp, "full_system.json")
        collected, collect_s, paths["tools_collect"] = tool_run(
            collect_round_results.main,
            ["--experiment_dir", exp, "--out", full, "--device", dev.type])
        dist = collected["routing_weight_distribution"]
        check(isinstance(dist, dict) and all(abs(sum(dist[f"true_{lvl}"]) - 1) <= 1e-3
                                             for lvl in INTENSITY_ORDER),
              f"tools: collect_round_results' routing weights {dist}")
        check(collected["summary"]["hard_routing"] == after["hard_routing"]
              and "router_classifier_test_acc" in collected,
              "tools: collect_round_results did not read the patched results")
        readings.update(
            rerun_hard_routing=dict(seconds=hard_s, routed=routed.tolist(),
                                    routing_acc=hard["routing_acc"],
                                    spilled_frac=hard["spilled_frac"],
                                    fidelity_psnr=hard["fidelity"].get("psnr")),
            rerun_detection=dict(seconds=det_s, improvement_percent=after["detection"][
                "improvement_percent"], mAP={side: det[side]["overall"].get("mAP")
                                             for side in ("hazy", "dehazed")}),
            collect=dict(seconds=collect_s, routing_weight_distribution=dist,
                         router_classifier_test_acc=collected["router_classifier_test_acc"]))
        log(f"[tools] rerun_hard_routing_eval {hard_s:.1f} s (the classifier routes the test "
            f"split {routed.tolist()} low / medium / high): routing_acc "
            f"{hard['routing_acc']:.4f}, spilled {hard['spilled_frac']:.4f}, fidelity PSNR "
            f"{hard['fidelity'].get('psnr', float('nan')):.3f}; rerun_detection_eval "
            f"{det_s:.1f} s: mAP {readings['rerun_detection']['mAP']}; collect_round_results "
            f"{collect_s:.1f} s: weights {json.dumps(dist)}, classifier acc "
            f"{collected['router_classifier_test_acc']}; launches "
            f"{ {t: nonzero(launched) for t, launched in paths.items()} }; {smi}")
        logs = _run_all(procs, VALIDATE_TIMEOUT_S)
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.wait()
    validate_s = time.perf_counter() - t0
    paths["tools_validate"] = collections.Counter()
    readings["validate"] = {}
    for kind, (text,) in logs.items():
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        line = json.loads(lines[-1]) if lines else {"ok": False, "error": text[-3000:]}
        log(f"[tools] validate_real_weights --kind {kind} --selftest: {json.dumps(line)}")
        readings["validate"][kind] = line
        if not line.get("ok") or procs[kind][0].returncode != 0:
            failed.append(f"validate {kind}: {line}")
            continue
        diffs = line["forward_max_abs_diff"]
        if kind != "fcos" and not (diffs and max(diffs.values()) <= FP32_ATOL):
            failed.append(f"validate {kind}: fp32 diffs {diffs}")
        if line["device"] != torch.cuda.get_device_name(dev):
            failed.append(f"validate {kind}: restored on {line['device']}")
        paths["tools_validate"].update(line["launches"])
    if readings["validate"]["branch"].get("launches", {}).get("cbam_gate", 0) == 0:
        failed.append("validate branch (high): no K2 launch")
    log(f"[tools] validate_real_weights, four kinds in four processes: {validate_s:.1f} s "
        f"(overlapping the reruns); restores launched {dict(paths['tools_validate'])}; {smi}")

    # (c) the throughput tool, alone on the card.
    readings["throughput"] = {}
    for mode, remat in THROUGHPUT_RUNS:
        line, _, launched = tool_run(
            measure_train_throughput.main,
            ["--batch", str(THROUGHPUT_BATCH), "--steps", str(THROUGHPUT_STEPS), "--mode", mode,
             "--remat", remat, "--device", dev.type])
        paths.setdefault(f"tools_throughput_{mode}", collections.Counter()).update(launched)
        sec = line["sec_per_step" if mode == "soft" else "sec_per_round"]
        key = f"{mode}_{remat}"
        readings["throughput"][key + "_again" if key in readings["throughput"] else key] = line
        log(f"[tools] measure_train_throughput --mode {mode} --remat {remat} --batch "
            f"{THROUGHPUT_BATCH} --steps {THROUGHPUT_STEPS}: {json.dumps(line)} "
            f"({sec * 1e3:.2f} ms a {'step' if mode == 'soft' else 'round of 3 steps'}; TF32 "
            f"off, as this script sets it); {smi}")
        if not (line["value"] > 0 and line["nvidia_smi"]):
            failed.append(f"throughput {mode} {remat}: {line}")
    check(not failed, "; ".join(failed))
    hard_kernels = tuple(k for c, k in HARD_ROUTED_KERNELS.items() if routed[c])
    for tag, kernels in {**TOOL_PATH_KERNELS, "tools_rerun_hard_routing": hard_kernels}.items():
        for k in kernels:
            check(paths[tag].get(k, 0) > 0, f"tools: {tag} launched no {k}: {nonzero(paths[tag])}")
    return {k: dict(v) for k, v in paths.items()}, readings


# The bench's dispatch: phase 5's tuned cache with these winners, so that
# the tuned rows run K3 (medium), K4, K2' and K6 (high) whatever won.
BENCH_FORCED = {"low": "chain", "medium": "tail_chain", "high": "res_e2b_tail_chain"}
BENCH_TIMEOUT_S = 600
# Every row of the full tier on an experiment with a resolution policy:
# each key must be in the line (`host_binned_ms_per_image` only when the
# device-binned engine took the value).
BENCH_ROWS = (
    "device_binned_ms_per_image", "single_image_p50_ms", "single_image_streamed_ms",
    "single_image_guarded_p50_ms", "single_image_guarded_streamed_ms",
    "with_detection_ms_per_image", "detection_overhead_ms_per_image",
    "predicted_routing_trained_ms_per_image", "trained_routing_acc",
    "predicted_trained_minus_oracle_ms", "spill_routing_trained_ms_per_image",
    "spill_up_routing_trained_ms_per_image", "device_spill_trained_ms_per_image",
    "queued_routing_trained_ms_per_image", "queued_routing_trained_ms_median",
    "queued_routing_trained_ms_samples", "stream_ms_per_image", "stream_imgs_per_sec_per_chip",
    "device_binned_stream_ms_per_image", "device_binned_stream_imgs_per_sec",
    "device_binned_stream_depth", "skewed_all_high_ms_per_image", "lowres_medhigh_ms_per_image",
    "resolution_policy", "guarded_lowres_ms_per_image", "guarded_lowres_gflops_per_image",
    "guarded_lowres_mfu_pct", "predicted_routing_ms_per_image", "flops_source",
    "measured_gflops_per_image", "mfu_pct", "assumed_peak_tflops", "int8_ms_per_image",
    "int8_lowering", "best_serving_ms_per_image", "imgs_per_sec_per_chip", "vs_baseline",
    "bench_wall_s", "autotuned_dispatch", "device")
# Launches each row must show: K1 and K2 in the balanced primary row; the
# tuned dispatch's K3, K4, K2' and K6 in both engines' rows; Q1 and Q2 in
# the int8 row.
BENCH_ROW_KERNELS = {
    "binned": ("lightweight_chain", "cbam_gate", "medium_tail_chain", "high_tail_chain",
               "spatial_gate", "res_attn_chain"),
    "device_binned": ("lightweight_chain", "cbam_gate", "medium_tail_chain",
                      "high_tail_chain", "spatial_gate", "res_attn_chain"),
    "int8": ("int8_quantize", "int8_conv"),
}
# A skip message of the bench that is not a fault: the budget or the tier.
BENCH_BENIGN_SKIPS = ("(RuntimeError: budget)", "(RuntimeError: full tier only)")


def phase_bench(dev, smi, tmp, exp):
    """26. The port's benchmark (see the docstring). Returns the launches of
    its rows, summed, and the readings."""
    from adam_dehaze_tpu_torch import bench
    torch.cuda.empty_cache()      # the bench's process needs the card's memory
    with open(os.path.join(tmp, "autotune_bf16.json")) as f:
        forced = force_winners(json.load(f), BENCH_FORCED)
    cache = os.path.join(tmp, "bench_autotune.json")
    with open(cache, "w") as f:
        json.dump(forced, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_EXPERIMENT=exp, BENCH_AUTOTUNE_CACHE=cache)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "main_torch.py", "--mode", "bench", "--full"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    run_s = time.perf_counter() - t0
    with open(os.path.join(tmp, "bench.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"bench: exit {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    tagged = [ln for ln in proc.stderr.splitlines() if ln.startswith("[bench launches] ")]
    check(len(tagged) == 1, f"bench: {len(tagged)} launch lines")
    rows = json.loads(tagged[0][len("[bench launches] "):])
    log(f"[bench] python3 main_torch.py --mode bench --full: {run_s:.1f} s; {json.dumps(line)}")
    log(f"[bench] launches by row: {json.dumps(rows)}")
    faults = [ln for ln in proc.stderr.splitlines()
              if ("skipped (" in ln or "failed (" in ln or "binned engine failed" in ln)
              and not ln.endswith(BENCH_BENIGN_SKIPS)]
    check(not faults, f"bench: rows skipped for an exception: {faults}")
    check(line.get("metric") == "adaptive_dehaze_ms_per_image_256" and line["value"] > 0
          and line["mode"] in ("binned", "device_binned"),
          f"bench: metric {line.get('metric')}, value {line.get('value')}, mode "
          f"{line.get('mode')}")
    missing = [k for k in BENCH_ROWS if k not in line]
    check(not missing, f"bench: rows missing from the line: {missing}")
    check(line["autotuned_dispatch"] == BENCH_FORCED and line["device"] == smi,
          f"bench: dispatch {line['autotuned_dispatch']}, device {line['device']!r}")
    for row, kernels in BENCH_ROW_KERNELS.items():
        for k in kernels:
            check(rows.get(row, {}).get(k, 0) > 0, f"bench: the {row} row launched no {k}: "
                  f"{rows.get(row)}")
    path = collections.Counter()
    for launched in rows.values():
        path.update(launched)

    # The primary engine in bf16 against the fp32 modules, per image.
    cfg = load_config()
    bucket = bench.BATCH // 3
    classifier, branches, x = bench.seeded(cfg, dev, bench.BATCH, bench.SIZE)
    calls = bench.build_callables(classifier, branches, torch.bfloat16, bucket, bench.SIZE,
                                  cache)
    check(calls.dispatch_used == BENCH_FORCED, f"bench: in process {calls.dispatch_used}")
    labels = np.repeat(np.arange(3), bucket)
    with torch.inference_mode():      # TF32 is off since phase 1
        got = calls.engine(x, intensity=labels)[0].float()
        want = torch.cat([branches[INTENSITY_ORDER[c]](x[i:i + 1]).float()
                          for i, c in enumerate(labels)])
    per_image = (got - want).abs().flatten(1).amax(dim=1).cpu().numpy()
    err = float(per_image.max())
    log(f"[bench] the primary engine in bf16 (tuned: {json.dumps(calls.dispatch_used)}) "
        f"against the fp32 modules on the bench's {bench.BATCH} images: max abs err {err:.3e} "
        f"(by class {[float(per_image[labels == c].max()) for c in range(3)]}; bound "
        f"{BF16_ATOL}); {smi}")
    check(err <= BF16_ATOL, "bench: the bf16 primary engine disagrees with the fp32 modules")
    del calls, classifier, branches, x
    torch.cuda.empty_cache()
    return dict(path), {"line": line, "launches_by_row": rows, "seconds": run_s,
                        "bf16_vs_fp32_max_abs_err": err}


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
        int8_path, int8_kernels, int8_readings = timed("int8", phase_int8, dev, smi, x, labels,
                                                       exp)
        parallel_path, parallel_readings = timed("parallel", phase_parallel, dev, smi, tmp, x)
        spatial_path, tp_path, sharded_readings = timed("sharded", phase_sharded, dev, smi, tmp)
        joint_sharded_path, dryrun_path, tuned_path, joint_sharded_readings = timed(
            "joint sharded", phase_joint_sharded, dev, smi, tmp)
        int8_shard_paths, q1_split_recs, int8_shard_readings = timed(
            "int8 and remat on shards", phase_int8_shards, dev, smi, tmp)
        resize_paths, resize_readings = timed("resize on shards", phase_resize, dev, smi, tmp)
        tool_paths, tool_readings = timed("tools", phase_tools, dev, smi, tmp, exp)
        bench_path, bench_readings = timed("bench", phase_bench, dev, smi, tmp, exp)
    for name in ("route_hard", "forced_labels", "soft"):
        log(f"[slices] {name}: default dispatch {default_ms[name]:.3f} ms/image, "
            f"tail-chain dispatch {tail_ms[name]:.3f} ms/image, res-chain dispatch "
            f"{res_ms[name]:.3f} ms/image")
    log(f"[phase] all: {sum(seconds.values()):.1f} s")

    paths = {"default": default, "engines": engines, "tail_chain": tail, "res_chain": res,
             "probe_tool": probes, "training": training, "classifier_training": classifier,
             "joint_training": joint, "detection": detection, "cli": cli_path,
             "lowres": lowres_path, "alternate": alt_path, "precompiled": pre_path,
             "int8": int8_path, "parallel": parallel_path, "spatial": spatial_path,
             "tp": tp_path, "joint_sharded": joint_sharded_path, "dryrun": dryrun_path,
             "tuned_spatial": tuned_path, **int8_shard_paths, **resize_paths, **tool_paths,
             "bench": bench_path}
    kernels["cbam_gate"].update(training_forward_ms_per_step=k2_train["forward_ms"],
                                training_backward_ms_per_step=k2_train["backward_ms"])
    for name, rec in grad_fns.items():
        kernels[name].update(function=rec)
    for name, rec in lowres_kernels.items():
        kernels[name].update(lowres=rec)
    kernels["cbam_gate"].update(alternate=alt_k2)
    kernels.update(int8_kernels)
    kernels.update(q1_split_recs)
    line = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": sum(path.get(name, 0) for path in paths.values()),
         "launches_by_path": {tag: path.get(name, 0) for tag, path in paths.items()},
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
        "alternate": alt_readings, "precompiled": pre_readings, "int8": int8_readings,
        "parallel": parallel_readings, "sharded": sharded_readings,
        "joint_sharded": joint_sharded_readings, "int8_and_remat_on_shards": int8_shard_readings,
        "resize_on_shards": resize_readings, "tools": tool_readings, "bench": bench_readings,
        "phase_seconds": seconds}
    check(all(k["launches"] > 0 for k in line["kernels"]),
          f"a kernel was launched no time on any path: {line['kernels']}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
    elif sys.argv[1:2] == ["--joint-rank"]:
        joint_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
    elif sys.argv[1:2] == ["--resize-rank"]:
        resize_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1:2] == ["--int8-shard-rank"]:
        int8_shard_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                        sys.argv[6])
    else:
        main()
