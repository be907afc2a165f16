#!/usr/bin/env python3
"""Mutation check of the tail chains' bf16 bound, on one GPU.

    python3 chip_mutation_check.py

The bf16 kernels K3 and K4 are held against their bf16 plain versions at
TAIL_BF16_ATOL (chip_smoke.py, tests/test_torch_cuda.py). This script shows
that the bound sees a broken kernel: for each mutation it copies csrc/ to a
temporary directory, breaks the copy by a text substitution, builds it, and
measures the broken kernels against the same plain versions, beside the
unchanged kernels and beside the loose bound (bf16 kernel against the fp32
plain version at 3e-2). The sources in the repository are never touched. It fails if a mutation is not caught by
the tight bound, or if the unchanged kernels are.

Sizes: medium c=64 and high c=96 at 4 x 256^2, seeded weights with
perturbed BN, inputs drawn non-negative like the real decoder state.
"""
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from adam_dehaze_tpu_torch.models.branches import (
    HighIntensityDehazeModel,
    MediumIntensityDehazeModel,
)
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.kernels import _build
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
TAIL_BF16_ATOL = 1e-2     # the tight bound: bf16 kernel vs bf16 plain
BF16_ATOL = 3e-2          # the loose bound: bf16 kernel vs fp32 plain

# name -> (file, text to find, replacement). Every occurrence is replaced.
MUTATIONS = {
    "last tap dropped (tensor-core body)": (
        "tail_chain.cu",
        "          const __nv_bfloat16* arow = s_in + ((row + ky) * g.tw + kx) * kMmaStride;",
        "          if (ky == a.ksize - 1 && kx == a.ksize - 1) continue;\n"
        "          const __nv_bfloat16* arow = s_in + ((row + ky) * g.tw + kx) * kMmaStride;"),
    "sub-pixel phase (1, 1) dropped": (
        "tail_chain.cu",
        "  g.nco = min(kCoChunk, a.Cout - g.co0);",
        "  g.nco = min(kCoChunk, a.Cout - g.co0);\n"
        "  if (k == 2 && g.phase == 3) g.phase = 2;"),
    "f0 half of the first head conv dropped": (
        "tail_chain.cu", "for (int s = 0; s < 2; ++s) {", "for (int s = 0; s < 1; ++s) {"),
    "residual add dropped (tensor-core body)": (
        "tail_chain.cu",
        "    if (residual != nullptr) v += __bfloat162float(residual[o]);", ""),
    "last 16-channel K-step of a chunk dropped": (
        "tail_chain.cu", "for (int k16 = 0; k16 < kc; k16 += 16) {",
        "for (int k16 = 0; k16 < kc - 16 + (kc == 16 ? 16 : 0); k16 += 16) {"),
    "guidance fixed at 1": (
        "tail_chain.cu", "      gd = 1.f / (1.f + expf(-d));", "      gd = 1.f;"),
    "channel gate dropped": (
        "tail_chain.cu", "        v[k] *= s_g[c + k];", ""),
    "spatial gate dropped": (
        "cbam_gate.cu", "      for (int k = 0; k < 8; ++k) vals[k] *= gate;",
        "      for (int k = 0; k < 8; ++k) vals[k] *= 1.f;"),
}


def perturb_bn_(module, gen):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return module


def make_cases(dev, gen):
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
        cases.append((label, tail, (d1.bfloat16(), f0.bfloat16(), x, wbf), wantbf, want32))
    return cases


def measure(cases):
    """{label: (err vs bf16 plain, err vs fp32 plain)} with the library that
    `_build.library()` now gives. A non-finite output counts as inf."""
    out = {}
    for label, tail, args, wantbf, want32 in cases:
        with torch.inference_mode():
            got = tail(*args)
        torch.cuda.synchronize()
        errs = []
        for want in (wantbf, want32):
            e = float((got - want).abs().max())
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

    print(f"bf16 kernels at {BATCH} x {SIZE}^2 (K3 c=64, K4 c=96): max abs err against "
          f"the bf16 plain version (bound {TAIL_BF16_ATOL}) | against the fp32 plain "
          f"version (bound {BF16_ATOL})")
    failed = []
    for name, errs in rows:
        cells = []
        for label in ("K3", "K4"):
            tight, loose = errs[label]
            cells.append(f"{label} {tight:.3e} | {loose:.3e}")
        print(f"  {name}: " + "; ".join(cells), flush=True)
        tights = [errs[label][0] for label in ("K3", "K4")]
        if name == "unchanged":
            if max(tights) > TAIL_BF16_ATOL:
                failed.append(f"the unchanged kernels exceed the bound: {tights}")
        elif max(tights) <= TAIL_BF16_ATOL:
            failed.append(f"{name}: not caught ({tights})")
    if failed:
        raise SystemExit("mutation check failed: " + "; ".join(failed))
    print("every mutation is caught by the tight bound", flush=True)


if __name__ == "__main__":
    main()
