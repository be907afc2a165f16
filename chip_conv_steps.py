#!/usr/bin/env python3
"""What each part of the wgmma conv body, and of K1's fused groups, gives, on
one GPU.

    python3 chip_conv_steps.py [conv] [k1]

With no argument both sections run.

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

The K1 section times the low branch (c = 32, 3 blocks, bf16, batch 16 at
256^2) as it is, each fused group alone, and beside it: the seven c -> c
layers as seven launches of `conv_tile` (the per-layer yardstick: what K1
would take on the shared conv body without fusion, its first and last layer
not counted); other tiles and warpgroup counts; and two diagnostics that compute wrong results on
purpose: "no products" (staging, barriers and epilogues only) and "no
staging" (products and epilogues on whatever the buffers hold).
"""
import shutil
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from adam_dehaze_tpu_torch.ops.kernels import _build
from adam_dehaze_tpu_torch.ops.kernels import conv_tile as conv_tile_module
from adam_dehaze_tpu_torch.ops.kernels import lightweight_chain as k1
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


# K1 variants: name -> (edits of lightweight_chain.cu, tile sides the Python
# mirror offers with them).
_K1_TILES = "constexpr int kFuTiles[] = {32, 28, 24, 20, 16, 12, 8};"
_K1_WARPGROUPS = "constexpr int kFuWarpgroups = 4;"
_K1_NO_PRODUCTS = (
    "        wgmma_bf16<N>(acc, da, db, (tap | ks) != 0);   // the first product clears acc",
    "        if (io.rows < 0) wgmma_bf16<N>(acc, da, db, 1);")
K1_VARIANTS = {
    "as it is": ([], k1.FUSED_TILES),
    "two warpgroups a block": ([(_K1_WARPGROUPS, "constexpr int kFuWarpgroups = 2;")],
                               k1.FUSED_TILES),
    "three warpgroups a block": ([(_K1_WARPGROUPS, "constexpr int kFuWarpgroups = 3;")],
                                 k1.FUSED_TILES),
    "eight warpgroups a block": ([(_K1_WARPGROUPS, "constexpr int kFuWarpgroups = 8;")],
                                 k1.FUSED_TILES),
    "tile 28": ([(_K1_TILES, "constexpr int kFuTiles[] = {28};")], (28,)),
    "tile 24": ([(_K1_TILES, "constexpr int kFuTiles[] = {24};")], (24,)),
    "tile 16, two blocks of two warpgroups an SM": (
        [(_K1_TILES, "constexpr int kFuTiles[] = {16};"),
         (_K1_WARPGROUPS, "constexpr int kFuWarpgroups = 2;")], (16,)),
    "no products": ([_K1_NO_PRODUCTS], k1.FUSED_TILES),
    "no products, no staging": ([
        _K1_NO_PRODUCTS,
        ("        cp_async16(b1 + v * pl4 + p * 16, src, ok ? 16 : 0);\n", ""),
    ], k1.FUSED_TILES),
    "no products, no skip read": ([
        _K1_NO_PRODUCTS,
        ("          r.skip_w[h][j] = r.ok[h] ? *reinterpret_cast<const uint32_t*>(",
         "          r.skip_w[h][j] = g.T < 0 ? *reinterpret_cast<const uint32_t*>("),
    ], k1.FUSED_TILES),
    "no products, no activation written": ([
        _K1_NO_PRODUCTS,
        ("          if (r.ok[h])\n            *reinterpret_cast<uint4*>(g.out + base",
         "          if (r.ok[h] && g.T < 0)\n            *reinterpret_cast<uint4*>(g.out + base"),
    ], k1.FUSED_TILES),
    "no staging": ([
        ("        cp_async16(b1 + v * pl4 + p * 16, src, ok ? 16 : 0);\n", ""),
        ("          *reinterpret_cast<uint4*>(buf2 + o * pl4 + q * 16) =\n"
         "              *reinterpret_cast<const uint4*>(vals);\n", ""),
    ], k1.FUSED_TILES),
}
K1_TIMED_ONLY = tuple(v for v in K1_VARIANTS if v.startswith("no "))


def k1_group_ms(x, chain):
    """Each fused group alone: ms per launch, in launch order."""
    plan = k1.chain_plan(chain.channels, chain.n_blocks, chain.dtype)
    n, h, w, _ = x.shape
    a = torch.empty((n, h, w, chain.channels), dtype=chain.dtype, device=x.device)
    b = torch.empty_like(a)
    out = torch.empty_like(x)
    lib, stream = _build.library(), _build.stream_ptr(x.device)
    times = []
    for i, (kind, (wp, shifts)) in enumerate(zip(plan.groups, chain.groups)):
        dst = out if i == plan.launches - 1 else b

        def launch():
            _build.check(lib.lightweight_group(
                k1.GROUP_KINDS.index(kind), x.data_ptr(), a.data_ptr(), wp.data_ptr(),
                shifts.data_ptr(), dst.data_ptr(), chain.alpha, n, h, w, chain.channels,
                stream), "lightweight_group")
        times.append(cs.cuda_ms(launch))
    return times


def k1_section(dev, gen):
    low = cs.perturb_bn_(cs.init_params_(cs.LightweightDehazeModel(32, 3), gen), gen).eval()
    chain = cs.fold_lightweight(low.to(dev), torch.bfloat16)._replace(alpha=1.0)
    x = torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=gen).to(dev)
    with torch.inference_mode():
        want = cs.lightweight_chain_reference(x, chain)
        # The yardstick: the seven c -> c layers, one conv_tile launch each.
        h = torch.relu(torch.randn(cs.BATCH, cs.SIZE, cs.SIZE, 32, generator=gen))
        h = h.to(dev).bfloat16()
        mids = [(w, t, pack_conv_weights(w, 3)) for w, t in chain.layers[1:-1]]
        outs = [torch.empty_like(h), torch.empty_like(h)]

        def per_layer():
            src = h
            for i, (w, t, packed) in enumerate(mids):
                src = conv_tile(src, w, t, out=outs[i % 2], packed=packed)
        ms = cs.cuda_ms(per_layer)
    cs.log(f"[k1 steps] per-layer yardstick: the {len(mids)} c -> c layers through conv_tile "
           f"{ms:.3f} ms ({ms / len(mids):.3f} ms a layer; first and last layer not counted)")
    original = _build.CSRC
    tiles = k1.FUSED_TILES
    with tempfile.TemporaryDirectory() as tmp:
        for i, (variant, (edits, v_tiles)) in enumerate(K1_VARIANTS.items()):
            if edits:
                csrc = Path(tmp) / f"k{i}"
                shutil.copytree(original, csrc)
                text = (csrc / "lightweight_chain.cu").read_text()
                for old, new in edits:
                    cs.check(old in text, f"variant {variant!r}: its text is not in "
                                          "lightweight_chain.cu")
                    text = text.replace(old, new)
                (csrc / "lightweight_chain.cu").write_text(text)
                _build.CSRC = csrc
            else:
                _build.CSRC = original
            _build.library.cache_clear()
            k1.FUSED_TILES = v_tiles
            plan = k1.chain_plan(32, 3, torch.bfloat16)
            with torch.inference_mode():
                err = cs.max_err(cs.lightweight_chain(x, chain), want)
                ms = cs.cuda_ms(lambda: cs.lightweight_chain(x, chain))
                groups = k1_group_ms(x, chain)
            cs.log(f"[k1 steps] {variant}: tile {plan.tile[0]}: {ms:.3f} ms, "
                   f"groups {[round(g, 3) for g in groups]} ms, err vs bf16 plain at alpha 1 "
                   f"{err:.3e}")
            cs.check(variant in K1_TIMED_ONLY or err <= cs.K1_BF16_ATOL,
                     f"{variant}: K1 disagrees with plain")
    _build.CSRC = original
    k1.FUSED_TILES = tiles
    _build.library.cache_clear()


def main():
    sections = sys.argv[1:] or ["conv", "k1"]
    cs.phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    if "k1" in sections:
        k1_section(dev, gen)
    if "conv" in sections:
        conv_section(dev, gen)


def conv_section(dev, gen):
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
