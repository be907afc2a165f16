#!/usr/bin/env python3
"""Mutation check of the chain kernels' bf16 bounds, on one GPU.

    python3 chip_mutation_check.py

The bf16 kernels K3 (its head group included) and K4 are held against
their bf16 plain versions at TAIL_BF16_ATOL, K6 at RES_BF16_RTOL, K1's fused
body at K1_BF16_ATOL with alpha 1, K2's statistics pass against `padded_stats` at MAPS_ATOL,
and the int8 conv Q2 against its plain version on the same int8 operands at Q2_RTOL, one bf16
step of the largest output (chip_smoke.py, tests/test_torch_cuda.py): its tile body without BN,
with a ResidualBlock conv2's BN and no ReLU, and at a 4x4 stride-2 layer with BN and ReLU (the
parity planes). This script shows that
the bounds see a broken kernel: for each mutation it copies csrc/ to a temporary directory, breaks
the copy by a text substitution, builds it, and measures the broken kernels
against the same plain versions, beside the unchanged kernels and beside
the loose bound (bf16 kernel against the fp32 plain version at 3e-2). The
sources in the repository are never touched. It fails if a mutation that
reaches a kernel is not caught by that kernel's tight bound, or if the
unchanged kernels are; a mutation listed in BLIND_SPOTS is only reported,
with what the bounds read.

Sizes: medium c=64 and high c=96 at 4 x 256^2 for the tails; for K6 the
high branch's 64^2 x 384 segment [res, res, attn, res, attn] at batch 4,
errors in units of the plain result's largest magnitude; K1 c=32 with 3
blocks at 4 x 256^2 (tight: alpha 1 against the bf16 plain version; loose:
the folded alpha against the fp32 plain version); the statistics pass at
4 x 64^2 x 384 in bf16 with a channel gate; Q2 at the high branch's 384-wide
3x3 layer, 4 x 64^2, bf16, without BN ("Q2") and with an eval BN and no ReLU
("Q2 bn"), and at its 192 -> 384 4x4 stride-2 layer, 4 x 128^2, with BN and
ReLU ("Q2 4x4"), errors in units of the plain result's largest magnitude;
seeded weights with perturbed BN, inputs drawn non-negative like the real
activations.

K2 on an H shard (parallel/spatial.py) fills its maps' halo rows between its two launches, in
Python (ops/kernels/cbam.py:channel_spatial_gate_sharded); K3, K4 and K6 on an H shard take their
halos, reduce their channel partials over the group and fill their maps' halo rows between their
launches (ops/kernels/tail_chain.py, res_chain.py). PY_MUTATIONS breaks one such line at a time in
a copy of the package, and two gloo ranks on the card, run from the copy, measure it beside the
same ranks on the unchanged package: HALO_RANK computes K2 on their half of the rows of 4 x 64^2 x
384 in bf16 against the gate kernel on the whole image, at HALO_RTOL; TUNED_RANK runs the medium
branch's tail_chain apply (K3) and the high branch's res_e2b_tail_chain apply (K6, K4 and K2') at
the default widths, fp32, on 2 x 256^2 through make_spatial_infer against the same apply on the
whole image, and K6 alone on the high e2b segment (2 x 64^2 x 384, in units of max|whole|), at
TUNED_ATOL (chip_smoke.py phase 22 (c)'s fp32 bound, which holds the same two readings). Int8
serving on an H shard and on split channels (ops/quant.py:Int8Conv2d) reduces Q1's abs-max over the
group, takes its int8 halo and slices Q2's packed weights in Python, and the remat recompute
re-enters the sharding contexts (training/remat.py): INT8_RANK runs one Int8Conv2d of each body
(tile 3x3/1 and 4x4/2, gather 7x7 on RGB, 2 x 128^2) on two H shards and the high branch's 4c 3x3
layer on two channel shards against the layer on the whole input, bit for bit as chip_smoke.py
phase 23 (a) and (b) hold them; REMAT_RANK takes a shard_train_step of the high branch at c=16 (2 x
64^2, fp32, an MSE) on two H shards with its forward checkpointed, its backward on the card's
autograd thread, against the same step without the checkpoint, at REMAT_RTOL of the largest
gradient (phase 23 (c)'s fp32 bound). Resizes on an H shard (parallel/sharded_ops.py:_interpolate)
take their H pass from the unsharded op's matrix over a band of source rows: RESIZE_RANK runs the corun
branch (c=64, align-corners upsamples, 2 x 256^2, fp32) through make_spatial_infer and the dial's
antialiased shrink and its lift alone on two H shards against the whole image, at RESIZE_ATOL (chip_smoke.py
phase 24's fp32 bound). `python3 chip_mutation_check.py python [CASE ...]` runs these alone (the
cases named, or all).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from adam_dehaze_tpu_torch.models.branches import (
    HighIntensityDehazeModel,
    LightweightDehazeModel,
    MediumIntensityDehazeModel,
)
from adam_dehaze_tpu_torch.nn.blocks import (
    AttentionBlock,
    ResidualBlock,
    init_params_,
)
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.kernels.cbam import gated_maps, padded_stats
from adam_dehaze_tpu_torch.ops.kernels.quant import (
    ConvGeometry,
    eval_bn_stats,
    int8_conv,
    int8_conv_fused_reference,
    pack_int8_weights,
    quantize_images,
)
from adam_dehaze_tpu_torch.ops.quant import quantize_weight_per_channel
from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
    fold_lightweight,
    lightweight_chain,
    lightweight_chain_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.res_chain import (
    fold_res_attn_chain,
    res_attn_chain,
    res_attn_chain_reference,
)
from adam_dehaze_tpu_torch.ops.kernels.tail_chain import (
    fold_high_tail,
    fold_medium_tail,
    high_tail_chain,
    high_tail_chain_reference,
    medium_tail_chain,
    medium_tail_chain_reference,
)

SEED = 0
BATCH, SIZE = 4, 256
TAIL_BF16_ATOL = 1e-2     # the tight bound of K3 and K4: bf16 kernel vs bf16 plain
RES_BF16_RTOL = 2e-2      # the tight bound of K6, in units of max|plain|
BF16_ATOL = 3e-2          # the loose bound: bf16 kernel vs fp32 plain
K1_BF16_ATOL = 4e-3       # the tight bound of K1: bf16 kernel vs bf16 plain at alpha 1
MAPS_ATOL = 1e-5          # K2's statistics pass vs padded_stats
Q2_RTOL = 2.0 ** -7       # Q2 vs its plain version: one bf16 step, in units of max|plain|
TIGHT = {"K1": K1_BF16_ATOL, "K3": TAIL_BF16_ATOL, "K4": TAIL_BF16_ATOL,
         "K6": RES_BF16_RTOL, "K2 maps": MAPS_ATOL, "Q2": Q2_RTOL, "Q2 bn": Q2_RTOL,
         "Q2 4x4": Q2_RTOL}
RELATIVE = ("K6", "Q2", "Q2 bn", "Q2 4x4")
K6_KINDS = ("res", "res", "attn", "res", "attn")

# name -> (file, text to find, replacement). Every occurrence is replaced.
# The fused-group body serves K1's groups and K3's head group: a mutation of
# its shared lines reaches both; those for the head group alone name its
# middle layer by its template arguments (64 -> 32: N 32, four k16 steps,
# which no layer of K1 has) or its epilogue (kTanhOut). The three-slot ring
# of the conv body serves K3's 64-wide 3x3 trunk layers.
MUTATIONS = {
    "last tap dropped (the fused-group body)": (
        "lightweight_chain.cu", "    for (int tap = 0; tap < TAPS; ++tap) {",
        "    for (int tap = 0; tap < (TAPS == 9 ? 8 : 1); ++tap) {"),
    "skip add dropped (K1's residual groups)": (
        "lightweight_chain.cu",
        "          const float v0 = fmaxf(acc[4 * j + 2 * h] + sh[j].x + sk.x, 0.f);\n"
        "          const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + sh[j].y + sk.y, 0.f);\n",
        "          const float v0 = fmaxf(acc[4 * j + 2 * h] + sh[j].x + 0.f * sk.x, 0.f);\n"
        "          const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + sh[j].y + 0.f * sk.y, 0.f);\n"),
    "ring positions outside the image not stored as 0 (the fused-group body)": (
        "lightweight_chain.cu",
        "          if (!r.inside[h]) v0 = v1 = 0.f;   // the next conv pads with zeros outside "
        "the image\n", ""),
    "a group's last layer reads its middle layer's weights (the fused-group body)": (
        "lightweight_chain.cu", " io.b_base = w_addr + kW0 + kLayerBytes;",
        " io.b_base = w_addr + kW0;"),
    "head2's last tap dropped (K3's head group)": (
        "lightweight_chain.cu", "    for (int tap = 0; tap < TAPS; ++tap) {",
        "    for (int tap = 0; tap < (N == 32 && KSTEPS == 4 ? TAPS - 1 : TAPS); ++tap) {"),
    "ring positions outside the image not stored as 0 (K3's head group)": (
        "lightweight_chain.cu",
        "          if (!r.inside[h]) v0 = v1 = 0.f;   // the next conv pads with zeros outside "
        "the image\n",
        "          if (!r.inside[h] && !(N == 32 && KSTEPS == 4)) v0 = v1 = 0.f;\n"),
    "tanh dropped (K3's head group)": (
        "lightweight_chain.cu", "              const float res = tanhf(v);",
        "              const float res = v;"),
    "the image read one pixel off (K3's head group)": (
        "lightweight_chain.cu",
        "          r.image[h][k] = r.ok[h] && 2 * l + k < 3 ? g.x[r.pix[h] * 3 + 2 * l + k] : 0.f;",
        "          r.image[h][k] = r.ok[h] && 2 * l + k < 3\n"
        "              ? g.x[(r.pix[h] - (EPI == kTanhOut && r.pix[h] > 0)) * 3 + 2 * l + k] : 0.f;"),
    "max map not reduced across the sub-group (K2's statistics pass)": (
        "cbam_gate.cu", "      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));\n", ""),
    "last tap dropped (wgmma body)": (
        "conv_tile.cu", "    for (int tap = 0; tap < kTaps; ++tap) {",
        "    for (int tap = 0; tap < kTaps - 1; ++tap) {"),
    "sub-pixel phase (1, 1) dropped": (
        "conv_tile.cu", "  const int phase = KS == 3 ? 0 : bx % 4;",
        "  const int phase = KS == 3 ? 0 : (bx % 4 == 3 ? 2 : bx % 4);"),
    "f0 half of the first head conv dropped": (
        "conv_tile.cu", "  const int n_stages = n0 + a.c[1] / kWgKc;",
        "  const int n_stages = n0;"),
    "residual (skip) add dropped (wgmma body)": (
        "conv_tile.cu", "          v0 += r.x;\n          v1 += r.y;\n", ""),
    "last 16-channel stage of a walk dropped": (
        "conv_tile.cu", "  for (int it = 0; it < n_stages; ++it) {",
        "  for (int it = 0; it < n_stages - (n_stages > 1); ++it) {"),
    "last 32 channels of a wide first input dropped": (
        "conv_tile.cu", "  const int n0 = a.c[0] / kWgKc;",
        "  const int n0 = a.c[0] / kWgKc - (a.c[0] > 64 ? 2 : 0);"),
    "a ring slot read before its tile has landed (cp.async wait removed)": (
        "conv_tile.cu",
        "    cp_async_wait<kWgStages - 3>();   // stage `it` has landed (this thread's part)\n",
        ""),
    "the three-slot ring's cp.async wait removed (K3's 64-wide trunk layers)": (
        "conv_tile.cu",
        "    cp_async_wait<kWgStages - 3>();   // stage `it` has landed (this thread's part)\n",
        "    if (kWgStages != 3) cp_async_wait<kWgStages - 3>();\n"),
    "guidance fixed at 1": (
        "conv_tile.cu", "      gd = 1.f / (1.f + expf(-d));", "      gd = 1.f;"),
    "channel gate dropped (K4's gated pass)": (
        "tail_chain.cu", "        v[k] *= s_g[c + k];", ""),
    "channel gate dropped (K2's statistics pass)": (
        "cbam_gate.cu",
        "          const float z = kChannelGate ? vals[k] * s_g[v * 8 + k] : vals[k];",
        "          const float z = vals[k];"),
    "channel gate dropped (K2's pass)": (
        "cbam_gate.cu", "      for (int k = 0; k < 8; ++k) vals[k] *= gk[k] * gate;",
        "      for (int k = 0; k < 8; ++k) vals[k] *= gate;"),
    "spatial gate dropped": (
        "cbam_gate.cu", "    s_gate[p] = 1.f / (1.f + __expf(-acc));", "    s_gate[p] = 1.f;"),
    "activation rounded before the spatial gate (K2's pass)": (
        "cbam_gate.cu", "      for (int k = 0; k < 8; ++k) vals[k] *= gk[k] * gate;",
        "      for (int k = 0; k < 8; ++k)\n"
        "        vals[k] = adam::to_float(adam::from_float<T>(vals[k] * gk[k])) * gate;"),
    "each pair of output channels dequantised by the even one's scale (Q2's epilogue)": (
        "int8_conv.cu", "    ch[k].sw = e.sw[co];", "    ch[k].sw = e.sw[co & ~1];"),
    "a 3x3 tap read one pixel off (Q2's A descriptor offset)": (
        "int8_conv.cu",
        "  static __device__ __forceinline__ int tap_offset(int i) { return (i / 3) * tw + i % 3; }",
        "  static __device__ __forceinline__ int tap_offset(int i) {\n"
        "    return (i / 3) * tw + (i % 3 == 2 ? 1 : i % 3);\n  }"),
    "the other column-parity plane (Q2's 4x4 stride-2 taps)": (
        "int8_conv.cu", "    return ((i & 3) & 1) * plane + (i >> 2) * tw + ((i & 3) >> 1);",
        "    return (1 - ((i & 3) & 1)) * plane + (i >> 2) * tw + ((i & 3) >> 1);"),
    "BN shift dropped (Q2's epilogue)": (
        "int8_conv.cu", "      ch[k].b = e.bn[e.cout + co];", "      ch[k].b = 0.f;"),
    "ReLU after every BN, a ResidualBlock's conv2 included (Q2's epilogue)": (
        "int8_conv.cu", "  return relu && !(y > 0.f) ? 0.f : y;", "  return !(y > 0.f) ? 0.f : y;"),
}
# Mutations a tight bound is not expected to see: they are measured and
# reported, and fail the run only if they move nothing at all.
BLIND_SPOTS = ("activation rounded before the spatial gate (K2's pass)",)

# name -> (file under adam_dehaze_tpu_torch/, text to find, replacement): lines of the port's
# Python that the two-rank K2 halo case reads.
PY_MUTATIONS = {
    "the maps' halo rows not filled (K2 on an H shard)": (
        "halo", "ops/kernels/cbam.py",
        "        maps = fill_map_halo(maps, rows)\n    if grad:", "        pass\n    if grad:"),
    "a halo row short before K3's convolutions": (
        "tuned", "ops/kernels/tail_chain.py", "MEDIUM_TAIL_RADIUS = 3\n",
        "MEDIUM_TAIL_RADIUS = 2\n"),
    "a halo row short before K4's trunk front": (
        "tuned", "ops/kernels/tail_chain.py", "HIGH_FRONT_RADIUS = 2\n",
        "HIGH_FRONT_RADIUS = 1\n"),
    "a halo row short before K4's heads and guidance": (
        "tuned", "ops/kernels/tail_chain.py", "HIGH_HEAD_RADIUS = 3\n", "HIGH_HEAD_RADIUS = 2\n"),
    "a halo row short before a run of K6's res blocks": (
        "tuned", "ops/kernels/res_chain.py", "spatial.taller(b, 1, 2 * count)",
        "spatial.taller(b, 1, 2 * count - 1)"),
    "K4's attention partials left unreduced": (
        "tuned", "ops/kernels/tail_chain.py",
        "        partial = reduce_partials(partial, rows)\n        pixels *= rows.size\n",
        "        pixels *= rows.size\n"),
    "K2''s map halo left unfilled inside K4": (
        "tuned", "ops/kernels/tail_chain.py",
        "        maps = fill_map_halo(maps, rows)\n    launch_spatial_gate",
        "        pass\n    launch_spatial_gate"),
    "K6's attention partials left unreduced": (
        "tuned", "ops/kernels/res_chain.py",
        "            partial = reduce_partials(partial, rows)\n", "            pass\n"),
    "K2's map halo left unfilled inside K6": (
        "tuned", "ops/kernels/res_chain.py",
        "            maps = fill_map_halo(maps, rows)\n", "            pass\n"),
    "Q1's partial abs-max left unreduced over the group (int8 on an H shard)": (
        "int8", "ops/quant.py", "amax = AllReduceMax.apply(image_absmax(xh), rows)",
        "amax = image_absmax(xh)"),
    "a halo row short before a Q2 on an H shard": (
        "int8", "ops/quant.py", "bottom = max(g.kh - g.stride - g.padding, 0)",
        "bottom = max(g.kh - g.stride - g.padding - 1, 0)"),
    "the 4x4 stride-2 halo at an odd offset (one row above)": (
        "int8", "ops/quant.py", "top = -(-g.padding // g.stride) * g.stride",
        "top = g.padding"),
    "a rank's Q2 given another rank's output-channel slice of the packed weights": (
        "int8", "ops/quant.py",
        "self._slices[key] = self._slice(channel_slice(self.geometry.cout, channels))",
        "self._slices[key] = self._slice(channel_slice(\n                self.geometry.cout, "
        "channels._replace(index=channels.size - 1 - channels.index)))"),
    "the remat recompute run outside the sharding contexts": (
        "remat", "training/remat.py",
        '            with saved["sharding"]():\n                yield\n', "            yield\n"),
    "a resize's band of source rows one row short (an H shard)": (
        "resize", "parallel/sharded_ops.py", "lo, hi = int(cols.min()), int(cols.max()) + 1",
        "lo, hi = int(cols.min()), int(cols.max())"),
    "a resize's H pass by F.interpolate on the halo'd shard, in the shard's coordinates": (
        "resize", "parallel/sharded_ops.py", "y = torch.matmul(part, band)",
        "y = F.interpolate(band, size=(out_h, band.shape[3]), **same)"),
}
# K2 on two H shards against the kernel on the whole image: they compute the same
# maps and gates per pixel, so one bf16 step of the largest output at most.
HALO_RTOL = 2.0 ** -8
# One rank of the halo case: python3 -c HALO_RANK REPO RANK PORT, from the root of
# the package to measure; prints its error in units of max|whole|.
HALO_RANK = """
import json, sys
from pathlib import Path
import torch
import torch.distributed as dist
from adam_dehaze_tpu_torch.ops.kernels import _build
repo, rank, port = Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
_build.CSRC, _build.BUILD_ROOT = repo / "adam_dehaze_tpu_torch" / "csrc", repo / "build" / "kernels"
from adam_dehaze_tpu_torch.ops.kernels.cbam import channel_spatial_gate, channel_spatial_gate_sharded
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
mesh = make_mesh({"spatial": 2}, [dev, dev])
gen = torch.Generator().manual_seed(0)
x = torch.relu(torch.randn(4, 64, 64, 384, generator=gen)).bfloat16().to(dev)
g = torch.rand(4, 384, generator=gen).to(dev)
w = (torch.randn(7, 7, 2, 1, generator=gen) * 0.1).to(dev)
rows = slice(32 * rank, 32 * rank + 32)
with torch.inference_mode():
    whole = channel_spatial_gate(x, g, w)
    part = channel_spatial_gate_sharded(x[:, rows].contiguous(), g, w, mesh.axis("spatial"), None)
torch.cuda.synchronize()
dist.destroy_process_group()
err = float((part.float() - whole[:, rows].float()).abs().max())
print(json.dumps(err / max(1.0, float(whole.float().abs().max()))))
"""


# The tuned applies on two H shards against the whole image, fp32: chip_smoke.py
# phase 22 (c)'s bound.
TUNED_ATOL = 1e-5
# One rank of the tuned case: python3 -c TUNED_RANK REPO RANK PORT, from the root of
# the package to measure; prints its largest absolute error.
TUNED_RANK = """
import json, sys
from pathlib import Path
import torch
import torch.distributed as dist
from adam_dehaze_tpu_torch.ops.kernels import _build
repo, rank, port = Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
_build.CSRC, _build.BUILD_ROOT = repo / "adam_dehaze_tpu_torch" / "csrc", repo / "build" / "kernels"
from adam_dehaze_tpu_torch.models.branches import HighIntensityDehazeModel, MediumIntensityDehazeModel
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.serving_apply import make_high_chain_apply, make_medium_tail_apply
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
from adam_dehaze_tpu_torch.parallel.spatial import make_spatial_infer, shard_image_batch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
mesh = make_mesh({"spatial": 2}, [dev, dev])
gen = torch.Generator().manual_seed(0)
medium, high = (init_params_(cls(c), gen).eval() for cls, c in
                ((MediumIntensityDehazeModel, 64), (HighIntensityDehazeModel, 96)))
with torch.no_grad():
    for m in list(medium.modules()) + list(high.modules()):
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2, generator=gen)
            m.running_var.uniform_(0.8, 1.3, generator=gen)
x = torch.rand(2, 256, 256, 3, generator=gen).to(dev)
err = 0.0
for apply in (make_medium_tail_apply(medium.to(dev), torch.float32),
              make_high_chain_apply(high.to(dev), torch.float32, res_chain=("e2b",),
                                    tail_chain=True)):
    with torch.inference_mode():
        whole = apply(x)
        part = make_spatial_infer(apply, mesh)(shard_image_batch(mesh, x))
    err = max(err, float((part - whole[:, 128 * rank:128 * rank + 128]).abs().max()))
# K6 alone on the high branch's e2b segment, in units of max|whole|.
from adam_dehaze_tpu_torch.ops.kernels.res_chain import fold_res_attn_chain, res_attn_chain, segment_blocks
from adam_dehaze_tpu_torch.parallel.spatial import spatial_sharding
weights = fold_res_attn_chain(segment_blocks(high, "e2b"), torch.float32)
seg = torch.relu(torch.randn(2, 64, 64, 384, generator=gen)).to(dev)
with torch.inference_mode():
    whole = res_attn_chain(seg, weights)
    with spatial_sharding(mesh):
        part = res_attn_chain(seg[:, 32 * rank:32 * rank + 32].contiguous(), weights)
err = max(err, float((part - whole[:, 32 * rank:32 * rank + 32]).abs().max())
          / float(whole.abs().max()))
torch.cuda.synchronize()
dist.destroy_process_group()
print(json.dumps(err))
"""
# Int8 layers on two H shards and on two channel shards against the layer on
# the whole input: bit for bit (chip_smoke.py phase 23 (a) and (b)).
INT8_ATOL = 0.0
# One rank of the int8 case: python3 -c INT8_RANK REPO RANK PORT, from the root of
# the package to measure; prints its largest absolute error.
INT8_RANK = """
import json, sys
from pathlib import Path
import torch
import torch.distributed as dist
from adam_dehaze_tpu_torch.ops.kernels import _build
repo, rank, port = Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
_build.CSRC, _build.BUILD_ROOT = repo / "adam_dehaze_tpu_torch" / "csrc", repo / "build" / "kernels"
from adam_dehaze_tpu_torch.ops.quant import Int8Conv2d
from adam_dehaze_tpu_torch.parallel.collectives import channel_slice
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
from adam_dehaze_tpu_torch.parallel.spatial import spatial_sharding
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
rows_mesh = make_mesh({"spatial": 2}, [dev, dev])
cols_mesh = make_mesh({"model": 2}, [dev, dev])
gen = torch.Generator().manual_seed(0)


def layer(cin, cout, k, s, p, h):
    conv = torch.nn.Conv2d(cin, cout, k, s, p, bias=False)
    bn = torch.nn.BatchNorm2d(cout).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * (k * k * cin) ** -0.5)
        bn.running_mean.uniform_(-0.2, 0.2, generator=gen)
        bn.running_var.uniform_(0.8, 1.3, generator=gen)
    x = torch.randn(2, cin, h, h, generator=gen)
    x = (x if cin == 3 else torch.relu(x)).to(dev).contiguous(memory_format=torch.channels_last)
    return Int8Conv2d(conv.to(dev), bn.to(dev), relu=True), x


err = 0.0
with torch.inference_mode():
    for spec in ((96, 96, 3, 1, 1, 128), (96, 192, 4, 2, 1, 128), (3, 96, 7, 1, 3, 128)):
        m, x = layer(*spec)
        whole = m(x)
        h, s = x.shape[2] // 2, spec[3]
        with spatial_sharding(rows_mesh):
            part = m(x[:, :, h * rank:h * rank + h])
        err = max(err, float((part - whole[:, :, h * rank // s:(h * rank + h) // s]).abs().max()))
    m, x = layer(384, 384, 3, 1, 1, 32)
    whole = m(x)
    cols = channel_slice(384, cols_mesh.axis("model"))
    with channel_sharding(cols_mesh):
        part = m(x[:, cols].contiguous(memory_format=torch.channels_last))
    err = max(err, float((part - whole[:, cols]).abs().max()))
torch.cuda.synchronize()
dist.destroy_process_group()
print(json.dumps(err))
"""
# A checkpointed step on two H shards against the same step without the checkpoint:
# chip_smoke.py phase 23 (c)'s fp32 gradient bound, of the largest gradient.
REMAT_RTOL = 1e-3
# One rank of the remat case: python3 -c REMAT_RANK REPO RANK PORT, from the root of
# the package to measure; prints its largest gradient error in units of max|g|.
REMAT_RANK = """
import json, sys
from pathlib import Path
import torch
import torch.distributed as dist
from adam_dehaze_tpu_torch.ops.kernels import _build
repo, rank, port = Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
_build.CSRC, _build.BUILD_ROOT = repo / "adam_dehaze_tpu_torch" / "csrc", repo / "build" / "kernels"
from adam_dehaze_tpu_torch.models.branches import HighIntensityDehazeModel
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.parallel.data_parallel import shard_train_step
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
from adam_dehaze_tpu_torch.training.remat import checkpoint_call
from adam_dehaze_tpu_torch.training.state import TrainState
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
mesh = make_mesh({"data": 1, "spatial": 2}, [dev, dev])
gen = torch.Generator().manual_seed(0)
batch = {"x": torch.rand(2, 64, 64, 3, generator=gen).to(dev),
         "y": torch.rand(2, 64, 64, 3, generator=gen).to(dev)}
grads = {}
for remat in (False, True):
    model = init_params_(HighIntensityDehazeModel(16), torch.Generator().manual_seed(1))
    model = model.to(dev).train()

    def step(state, batch, generator=None, remat=remat):
        m = state.module
        pred = checkpoint_call(m, batch["x"], module=m) if remat else m(batch["x"])
        loss = ((pred - batch["y"]) ** 2).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return {"loss": loss.detach()}

    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    shard_train_step(step, mesh, batch)(state, batch)
    grads[remat] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
torch.cuda.synchronize()
dist.destroy_process_group()
g_max = max(float(g.abs().max()) for g in grads[False].values())
print(json.dumps(max(float((grads[True][n] - g).abs().max()) for n, g in grads[False].items())
                 / g_max))
"""
# Resizes on two H shards against the whole image, fp32: chip_smoke.py phase 24's
# fp32 bound.
RESIZE_ATOL = 1e-5
# One rank of the resize case: python3 -c RESIZE_RANK REPO RANK PORT, from the root of
# the package to measure; prints its largest absolute error.
RESIZE_RANK = """
import json, sys
from pathlib import Path
import torch
import torch.distributed as dist
from adam_dehaze_tpu_torch.ops.kernels import _build
repo, rank, port = Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
_build.CSRC, _build.BUILD_ROOT = repo / "adam_dehaze_tpu_torch" / "csrc", repo / "build" / "kernels"
from adam_dehaze_tpu_torch.models.branches import COrunInspiredModel
from adam_dehaze_tpu_torch.nn.blocks import init_params_, resize_bilinear
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
from adam_dehaze_tpu_torch.parallel.spatial import make_spatial_infer, shard_image_batch, spatial_sharding
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
mesh = make_mesh({"spatial": 2}, [dev, dev])
gen = torch.Generator().manual_seed(0)
corun = init_params_(COrunInspiredModel(64, 6), gen).to(dev).eval()
x = torch.rand(2, 256, 256, 3, generator=gen).to(dev)
maps = torch.rand(2, 3, 256, 256, generator=gen).to(dev)
with torch.inference_mode():
    whole = corun(x)
    part = make_spatial_infer(corun, mesh)(shard_image_batch(mesh, x))
    err = float((part - whole[:, 128 * rank:128 * rank + 128]).abs().max())
    # The dial's antialiased shrink and its lift.
    for size in ((128, 128), (512, 512)):
        whole = resize_bilinear(maps, size)
        n = size[0] // 2
        with spatial_sharding(mesh):
            part = resize_bilinear(maps[:, :, 128 * rank:128 * rank + 128].contiguous(),
                                   (n, size[1]))
        err = max(err, float((part - whole[:, :, n * rank:n * rank + n]).abs().max()))
torch.cuda.synchronize()
dist.destroy_process_group()
print(json.dumps(err))
"""
CASES = {"halo": (HALO_RANK, HALO_RTOL), "tuned": (TUNED_RANK, TUNED_ATOL),
         "int8": (INT8_RANK, INT8_ATOL), "remat": (REMAT_RANK, REMAT_RTOL),
         "resize": (RESIZE_RANK, RESIZE_ATOL)}
CASE_READINGS = {
    "halo": f"K2 on two H shards of {BATCH} x 64^2 x 384, bf16, in units of max|whole|",
    "tuned": "the tuned applies on two H shards of 2 x 256^2, fp32, max abs err, and K6 alone "
             "on 2 x 64^2 x 384 in units of max|whole|",
    "int8": "Int8Conv2d of each body on two H shards of 2 x 128^2 and the 4c layer on two "
            "channel shards, fp32, max abs err against the whole input",
    "remat": "a checkpointed high-branch step (c=16, 2 x 64^2, fp32) on two H shards against "
             "the step without the checkpoint, gradients in units of max|g|",
    "resize": "the corun branch (c=64, 2 x 256^2, fp32) and the dial's shrink and lift (2 x 3 x "
              "256^2 maps) on two H shards, max abs err against the whole image"}


def perturb_bn_(module, gen):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return module


def make_cases(dev, gen):
    """(label, kernel, arguments, bf16 plain result, arguments of the loose
    check or None for the same run, fp32 plain result)."""
    cases = []
    for label, cls, c, fold_fn, tail, reference in (
            ("K3", MediumIntensityDehazeModel, 64, fold_medium_tail, medium_tail_chain,
             medium_tail_chain_reference),
            ("K4", HighIntensityDehazeModel, 96, fold_high_tail, high_tail_chain,
             high_tail_chain_reference)):
        model = perturb_bn_(init_params_(cls(c), gen), gen).eval().to(dev)
        d1 = torch.relu(torch.randn(BATCH, SIZE // 2, SIZE // 2, 4 * c, generator=gen)).to(dev)
        f0 = torch.relu(torch.randn(BATCH, SIZE, SIZE, c, generator=gen)).to(dev)
        x = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen).to(dev)
        wbf = fold_fn(model, torch.bfloat16)
        with torch.inference_mode():
            want32 = reference(d1, f0, x, fold_fn(model, torch.float32))
            wantbf = reference(d1.bfloat16(), f0.bfloat16(), x, wbf)
        cases.append((label, tail, (d1.bfloat16(), f0.bfloat16(), x, wbf), wantbf, None, want32))
    blocks = torch.nn.Sequential(*[ResidualBlock(384) if k == "res" else AttentionBlock(384)
                                   for k in K6_KINDS])
    blocks = perturb_bn_(init_params_(blocks, gen), gen).eval().to(dev)
    x = torch.relu(torch.randn(BATCH, 64, 64, 384, generator=gen)).to(dev)
    wbf = fold_res_attn_chain(blocks, torch.bfloat16)
    with torch.inference_mode():
        want32 = res_attn_chain_reference(x, fold_res_attn_chain(blocks, torch.float32))
        wantbf = res_attn_chain_reference(x.bfloat16(), wbf)
    cases.append(("K6", res_attn_chain, (x.bfloat16(), wbf), wantbf, None, want32))
    xb = x.bfloat16()
    g = torch.rand(BATCH, 384, generator=gen).to(dev)
    with torch.inference_mode():
        want = torch.stack(padded_stats(xb, g))
    cases.append(("K2 maps", lambda *a: torch.stack(gated_maps(*a)), (xb, g), want, None, want))
    # Q2 on the int8 operands of Q1 (run once, before any mutation): the
    # 384-wide 3x3 layer without BN and with a ResidualBlock conv2's BN (no
    # ReLU), then the 192 -> 384 4x4 stride-2 layer with BN and ReLU.
    geo = ConvGeometry.of(384, 384, 3, 3, 1, 1)
    w = (torch.randn(384, 384, 3, 3, generator=gen) / 58.8).bfloat16().to(dev)
    qw, sw = quantize_weight_per_channel(w)
    with torch.inference_mode():
        q, sx = quantize_images(xb, geo.cin_pad)
    ops = (q, sx, pack_int8_weights(qw, geo), sw.float(), None, geo)
    bn = perturb_bn_(torch.nn.BatchNorm2d(384), gen).eval()
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.5 * torch.randn(384, generator=gen))
        bn.bias.copy_(0.5 * torch.randn(384, generator=gen))
    bn = bn.requires_grad_(False).to(dev)
    with torch.inference_mode():
        cases.append(("Q2", lambda *a: int8_conv(*a, torch.bfloat16), ops,
                      int8_conv_fused_reference(*ops, torch.bfloat16), None,
                      int8_conv_fused_reference(*ops, torch.float32)))
        cases.append(("Q2 bn",
                      lambda *a: int8_conv(*a, torch.bfloat16, bn, eval_bn_stats(bn), False),
                      ops, int8_conv_fused_reference(*ops, torch.bfloat16, bn, False), None,
                      int8_conv_fused_reference(*ops, torch.float32, bn, False)))
    geo4 = ConvGeometry.of(192, 384, 4, 4, 2, 1)
    w4 = (torch.randn(384, 192, 4, 4, generator=gen) / 55.4).bfloat16().to(dev)
    qw4, sw4 = quantize_weight_per_channel(w4)
    x4 = torch.relu(torch.randn(BATCH, SIZE // 2, SIZE // 2, 192, generator=gen)).bfloat16().to(dev)
    with torch.inference_mode():
        q4, sx4 = quantize_images(x4, geo4.cin_pad)
    ops4 = (q4, sx4, pack_int8_weights(qw4, geo4), sw4.float(), None, geo4)
    with torch.inference_mode():
        cases.append(("Q2 4x4",
                      lambda *a: int8_conv(*a, torch.bfloat16, bn, eval_bn_stats(bn), True),
                      ops4, int8_conv_fused_reference(*ops4, torch.bfloat16, bn, True), None,
                      int8_conv_fused_reference(*ops4, torch.float32, bn, True)))
    # K1 draws last, so that the other kernels' cases stay what they were.
    low = perturb_bn_(init_params_(LightweightDehazeModel(32, 3), gen), gen).eval().to(dev)
    x = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen).to(dev)
    chain = fold_lightweight(low, torch.bfloat16)
    tight = chain._replace(alpha=1.0)
    with torch.inference_mode():
        cases.append(("K1", lightweight_chain, (x, tight),
                      lightweight_chain_reference(x, tight), (x, chain),
                      lightweight_chain_reference(x, fold_lightweight(low, torch.float32))))
    return cases


def measure(cases):
    """{label: (err vs bf16 plain, err vs fp32 plain)} with the library that
    `_build.library()` now gives; K6's in units of the plain result's
    largest magnitude. A non-finite output counts as inf."""
    out = {}
    for label, kernel, args, wantbf, loose_args, want32 in cases:
        with torch.inference_mode():
            got = kernel(*args)
            got_loose = got if loose_args is None else kernel(*loose_args)
        torch.cuda.synchronize()
        errs = []
        for got, want in ((got, wantbf), (got_loose, want32)):
            e = float((got.float() - want.float()).abs().max())
            if label in RELATIVE:
                e /= max(1.0, float(want.float().abs().max()))
            errs.append(e if e == e else float("inf"))
        out[label] = tuple(errs)
    return out


def use_sources(csrc: Path):
    _build.CSRC = csrc
    _build.library.cache_clear()


def case_error(case: str, package_root: Path, mutated: bool = False) -> float:
    """The error of a two-rank case (the larger of its ranks') with the
    package under `package_root`. A rank that fails fails the run on the
    unchanged package; under a mutation it is caught (inf), its last line
    printed."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable, "-c", CASES[case][0], str(repo), str(rank),
                               str(port)],
                              cwd=package_root, env={**os.environ, "PYTHONPATH": ""},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            if mutated:
                print(f"    a rank failed: {log.strip().splitlines()[-1][:300]}", flush=True)
                return float("inf")
            raise SystemExit(f"the {case} case failed:\n{log}")
    return max(json.loads(log.strip().splitlines()[-1]) for log in logs)


def python_mutations(failed, cases=None):
    """Each of PY_MUTATIONS of `cases` (by default every case) in a copy of
    the package, measured by its case beside the unchanged package."""
    repo = Path(__file__).resolve().parent
    cases = cases or list(CASES)
    for case, (_, bound) in ((c, CASES[c]) for c in cases):
        unchanged = case_error(case, repo)
        print(f"{case} case unchanged: {unchanged:.3e} (bound {bound:.3e}); "
              f"{CASE_READINGS[case]}", flush=True)
        if unchanged > bound:
            failed.append(f"the unchanged {case} case exceeds its bound: {unchanged}")
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (case, fname, old, new)) in enumerate(PY_MUTATIONS.items()):
            if case not in cases:
                continue
            root = Path(tmp) / f"p{i}"
            shutil.copytree(repo / "adam_dehaze_tpu_torch", root / "adam_dehaze_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            path = root / "adam_dehaze_tpu_torch" / fname
            text = path.read_text()
            if text.count(old) != 1:
                raise AssertionError(f"mutation {name!r}: its text is not once in {fname}")
            path.write_text(text.replace(old, new))
            err = case_error(case, root, mutated=True)
            print(f"  {name} ({case}): {err:.3e}", flush=True)
            if err <= CASES[case][1]:
                failed.append(f"{name}: not caught ({err})")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_mutation_check: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    if sys.argv[1:2] == ["python"]:
        _build.library()
        py_failed = []
        python_mutations(py_failed, sys.argv[2:])
        if py_failed:
            raise SystemExit("mutation check failed: " + "; ".join(py_failed))
        print("every Python mutation is caught by its case's bound", flush=True)
        return
    dev = torch.device("cuda")
    cases = make_cases(dev, torch.Generator().manual_seed(SEED))
    original = _build.CSRC
    rows = [("unchanged", measure(cases))]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (fname, old, new)) in enumerate(MUTATIONS.items()):
            csrc = Path(tmp) / f"m{i}"
            shutil.copytree(original, csrc)
            text = (csrc / fname).read_text()
            if old not in text:
                raise AssertionError(f"mutation {name!r}: its text is not in {fname}")
            (csrc / fname).write_text(text.replace(old, new))
            use_sources(csrc)
            rows.append((name, measure(cases)))
    use_sources(original)
    py_failed = []
    python_mutations(py_failed)

    labels = [case[0] for case in cases]
    print(f"bf16 kernels (K1 c=32 at {BATCH} x {SIZE}^2, alpha 1, bound {K1_BF16_ATOL}; K3 c=64 "
          f"and K4 c=96 at {BATCH} x {SIZE}^2, bounds {TAIL_BF16_ATOL}; K6 {list(K6_KINDS)} at "
          f"{BATCH} x 64^2 x 384, in units of max|plain|, bound {RES_BF16_RTOL}; K2's statistics "
          f"pass at {BATCH} x 64^2 x 384 against padded_stats, bound {MAPS_ATOL}): max abs err "
          f"against the bf16 plain version | against the fp32 plain version (bound {BF16_ATOL}; "
          f"K1 with its folded alpha); Q2 at {BATCH} x 64^2 x 384, 3x3, without BN and with BN "
          f"(no ReLU), and at {BATCH} x {SIZE // 2}^2 x 192 -> 384, 4x4 stride 2, BN + ReLU, in "
          f"units of max|plain|, bound {Q2_RTOL:.3e}")
    unchanged = rows[0][1]
    failed = []
    for name, errs in rows:
        print(f"  {name}: " + "; ".join(
            f"{label} {errs[label][0]:.3e} | {errs[label][1]:.3e}" for label in labels),
            flush=True)
        if name == "unchanged":
            over = [label for label in labels if errs[label][0] > TIGHT[label]]
            if over:
                failed.append(f"the unchanged kernels exceed the bound: {over}")
            continue
        # A mutation reaches the kernels whose reading it moves.
        reached = [label for label in labels if errs[label] != unchanged[label]]
        missed = [label for label in reached if errs[label][0] <= TIGHT[label]]
        if not reached:
            failed.append(f"{name}: moved no kernel's result")
        elif name in BLIND_SPOTS:
            print(f"    (a known blind spot: reaches {reached}, not seen by the tight bound "
                  f"of {missed})", flush=True)
        elif missed:
            failed.append(f"{name}: not caught for {missed} ({errs})")
    failed += py_failed
    if failed:
        raise SystemExit("mutation check failed: " + "; ".join(failed))
    print("every mutation outside BLIND_SPOTS is caught by the tight bound of every kernel "
          "it reaches", flush=True)


if __name__ == "__main__":
    main()
