#!/usr/bin/env python3
"""Mutation check of the chain kernels' bf16 bounds, on one GPU.

    python3 chip_mutation_check.py

The bf16 kernels K3 and K4 are held against their bf16 plain versions at
TAIL_BF16_ATOL, K6 at RES_BF16_RTOL, K1's fused body at K1_BF16_ATOL with
alpha 1, and K2's statistics pass against `padded_stats` at MAPS_ATOL
(chip_smoke.py, tests/test_torch_cuda.py). This script shows that the bounds see a broken
kernel: for each mutation it copies csrc/ to a temporary directory, breaks
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
4 x 64^2 x 384 in bf16 with a channel gate; seeded weights with perturbed
BN, inputs drawn non-negative like the real activations.
"""
import shutil
import subprocess
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
TIGHT = {"K1": K1_BF16_ATOL, "K3": TAIL_BF16_ATOL, "K4": TAIL_BF16_ATOL,
         "K6": RES_BF16_RTOL, "K2 maps": MAPS_ATOL}
K6_KINDS = ("res", "res", "attn", "res", "attn")

# name -> (file, text to find, replacement). Every occurrence is replaced.
MUTATIONS = {
    "last tap dropped (K1's fused body)": (
        "lightweight_chain.cu", "    for (int tap = 0; tap < TAPS; ++tap) {",
        "    for (int tap = 0; tap < (TAPS == 9 ? 8 : 1); ++tap) {"),
    "skip add dropped (K1's fused body)": (
        "lightweight_chain.cu",
        "          const float v0 = fmaxf(acc[4 * j + 2 * h] + sh[j].x + sk.x, 0.f);\n"
        "          const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + sh[j].y + sk.y, 0.f);\n",
        "          const float v0 = fmaxf(acc[4 * j + 2 * h] + sh[j].x + 0.f * sk.x, 0.f);\n"
        "          const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + sh[j].y + 0.f * sk.y, 0.f);\n"),
    "ring positions outside the image not stored as 0 (K1's fused body)": (
        "lightweight_chain.cu",
        "          if (!r.inside[h]) v0 = v1 = 0.f;   // the next conv pads with zeros outside "
        "the image\n", ""),
    "a group's last layer reads its middle layer's weights (K1's fused body)": (
        "lightweight_chain.cu", " io.b_base = w_addr + kW0 + kLayerBytes;",
        " io.b_base = w_addr + kW0;"),
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
}
# Mutations a tight bound is not expected to see: they are measured and
# reported, and fail the run only if they move nothing at all.
BLIND_SPOTS = ("activation rounded before the spatial gate (K2's pass)",)


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
            if label == "K6":
                e /= max(1.0, float(want.float().abs().max()))
            errs.append(e if e == e else float("inf"))
        out[label] = tuple(errs)
    return out


def use_sources(csrc: Path):
    _build.CSRC = csrc
    _build.library.cache_clear()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_mutation_check: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
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

    labels = [case[0] for case in cases]
    print(f"bf16 kernels (K1 c=32 at {BATCH} x {SIZE}^2, alpha 1, bound {K1_BF16_ATOL}; K3 c=64 "
          f"and K4 c=96 at {BATCH} x {SIZE}^2, bounds {TAIL_BF16_ATOL}; K6 {list(K6_KINDS)} at "
          f"{BATCH} x 64^2 x 384, in units of max|plain|, bound {RES_BF16_RTOL}; K2's statistics "
          f"pass at {BATCH} x 64^2 x 384 against padded_stats, bound {MAPS_ATOL}): max abs err "
          f"against the bf16 plain version | against the fp32 plain version (bound {BF16_ATOL}; "
          f"K1 with its folded alpha)")
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
    if failed:
        raise SystemExit("mutation check failed: " + "; ".join(failed))
    print("every mutation outside BLIND_SPOTS is caught by the tight bound of every kernel "
          "it reaches", flush=True)


if __name__ == "__main__":
    main()
