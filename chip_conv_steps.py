#!/usr/bin/env python3
"""What each part of the wgmma conv body gives, on one GPU.

    python3 chip_conv_steps.py

The bf16 body of csrc/conv_tile.cu is wgmma on large tiles fed by an
asynchronous ring. This script times four conv layers of the main path
(bf16, batch 16, CUDA events over warm launches) with the body as it is and
with one part taken away at a time, in the manner of chip_mutation_check.py:
csrc/ is copied to a temporary directory, the copy is changed by a text
substitution and built, and the sources in the repository are never
touched. Every variant must still agree with `conv_tile_reference`.

- "no ring": a stage is copied when it is needed and waited for at once, and
  its products are drained before the next copy: loads and tensor cores never
  run together inside a block.
- "products drained every stage": the ring stays, but `wgmma.wait_group 0`
  ends every stage, so the tensor cores idle across the barrier.
- "at most 64 output channels a block": the smaller tile (the input tile is
  staged once per 64 output channels, not per 128 or 96).

Two more variants compute wrong results on purpose and are only timed: they
say which side of the ring a layer waits for.

- "products only": no copy after the first two slots, so the time is what
  the barriers, the products and the epilogue take.
- "copies only": every copy and barrier, no product.
"""
import shutil
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.kernels import conv_tile as conv_tile_module
from adam_dehaze_tpu_torch.ops.kernels.conv_tile import (
    conv_tile,
    conv_tile_reference,
    pack_conv_weights,
)

LAYERS = ("K6 64^2 384->384", "K6 128^2 128->128", "K4 256^2 96->96", "K4 up 128^2 384->96")

# name -> [(text to find in conv_tile.cu, replacement), ...]
VARIANTS = {
    "as it is": [],
    "no ring": [
        ("    if (j < n_stages) load(j);\n", ""),
        ("    cp_async_wait<kWgStages - 3>();   // stage `it` has landed (this thread's part)\n"
         "    mbar_wait(mbar0 + (it % kWgStages) * 8, (it / kWgStages) & 1);   // ... and its weights\n"
         "    fence_proxy_async();\n"
         "    __syncthreads();                  // ... everyone's; and slot it-2 is drained\n"
         "    if (it + kWgStages - 2 < n_stages) load(it + kWgStages - 2);\n"
         "    cp_async_commit();\n",
         "    load(it);\n    cp_async_commit();\n    cp_async_wait<0>();\n"
         "    mbar_wait(mbar0 + (it % kWgStages) * 8, (it / kWgStages) & 1);\n"
         "    fence_proxy_async();\n    __syncthreads();\n"),
        ("    wgmma_wait<1>();                  // the stage before this one is drained\n",
         "    wgmma_wait<0>();\n"),
    ],
    "products drained every stage": [
        ("    wgmma_wait<1>();                  // the stage before this one is drained\n",
         "    wgmma_wait<0>();\n"),
    ],
    "at most 64 output channels a block": [
        ("for (int n : {128, 96, 64, 48, 32, 16})", "for (int n : {64, 48, 32, 16})"),
    ],
    "products only": [
        ("    if (it + kWgStages - 2 < n_stages) load(it + kWgStages - 2);\n", ""),
        ("    mbar_wait(mbar0 + (it % kWgStages) * 8, (it / kWgStages) & 1);   // ... and its weights\n",
         ""),
    ],
    "copies only": [
        ("        wgmma_bf16<N>(acc[m], da0[m] + atap, db, tap == 0 ? it > 0 : 1);",
         "        if (n_stages < 0) wgmma_bf16<N>(acc[m], da0[m] + atap, db, 1);"),
    ],
}
# The packed weights follow the output-channel chunk: a variant that changes
# the library's chunks changes the Python mirror with it.
CHUNKS = {"at most 64 output channels a block": (64, 48, 32, 16)}
# Variants whose results are wrong by construction: timed, not compared.
TIMED_ONLY = ("products only", "copies only")


def make_layer(name, dev, gen):
    side, c0, _, cout, ksize = cs.CONV_LAYERS[name]
    taps = (3, 3) if ksize == 3 else (4, 4)
    x = torch.relu(torch.randn(cs.BATCH, side, side, c0, generator=gen)).to(dev).bfloat16()
    w = (torch.randn(*taps, c0, cout, generator=gen) * (9 * c0) ** -0.5).to(dev).bfloat16()
    shift = (torch.randn(cout, generator=gen) * 0.1).to(dev)
    with torch.inference_mode():
        want = conv_tile_reference(x, w, shift, ksize=ksize)
    flops = cs.conv_flops(cs.BATCH * side * side, ksize * ksize * (4 if ksize == 2 else 1),
                          c0, cout)
    return dict(x=x, w=w, shift=shift, ksize=ksize), want, flops


def main():
    cs.phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    layers = {name: make_layer(name, dev, gen) for name in LAYERS}
    original, chunks = _build.CSRC, conv_tile_module.WGMMA_COUT_CHUNKS
    with tempfile.TemporaryDirectory() as tmp:
        for i, (variant, edits) in enumerate(VARIANTS.items()):
            csrc = Path(tmp) / f"v{i}"
            shutil.copytree(original, csrc)
            text = (csrc / "conv_tile.cu").read_text()
            for old, new in edits:
                cs.check(old in text, f"variant {variant!r}: its text is not in conv_tile.cu")
                text = text.replace(old, new)
            (csrc / "conv_tile.cu").write_text(text)
            _build.CSRC = csrc
            _build.library.cache_clear()
            conv_tile_module.WGMMA_COUT_CHUNKS = CHUNKS.get(variant, chunks)
            for name, (args, want, flops) in layers.items():
                out = torch.empty_like(want)
                packed = pack_conv_weights(args["w"], args["ksize"])
                with torch.inference_mode():
                    err = cs.scaled_err(conv_tile(out=out, packed=packed, **args), want)
                    ms = cs.cuda_ms(lambda: conv_tile(out=out, packed=packed, **args))
                cs.log(f"[steps] {variant}: {name}: {ms:.3f} ms "
                       f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), err {err:.3e}")
                cs.check(variant in TIMED_ONLY or err <= cs.CONV_BF16_RTOL,
                         f"{variant}: {name} disagrees with plain")
    _build.CSRC, conv_tile_module.WGMMA_COUT_CHUNKS = original, chunks
    _build.library.cache_clear()


if __name__ == "__main__":
    main()
