#!/usr/bin/env python3
"""What each part of the wgmma conv body, of K1's fused groups, of K3's
head group and trunk plan, and of the int8 conv Q2 gives, on one GPU.

    python3 chip_conv_steps.py [conv] [k1] [k3] [q2]

With no argument every section runs.

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

The K3 section times the medium tail (c = 64, bf16, batch 16 at 256^2):
K3 whole and its head group alone beside the two launches the group
replaced (head2 on the conv body, the last layer on the FMA body), the group
without its products or its staging (wrong results, timed only); then the
64-wide trunk layers, with K4's two layers that fall under the same plan,
and K3 whole under the plan as it is (two blocks an SM: three slots for the
3x3 64-wide layers) and under four slots at every width (one block of the
3x3 64-wide layers an SM, the plan before the three-slot ring). Each plan
prints the blocks an SM the occupancy API gives each layer's kernel.

The Q2 section times the int8 tile body (csrc/int8_conv.cu, bf16, eval BN
and ReLU in its epilogue, batch 16) at the main path's wide layers: as it is
(two blocks an SM, chunks of at most 96 output channels), with every chunk
built ("128", and 96 at 4x4 stride 2: one block an SM) to time each chunk
that divides a layer's width, and without its epilogue (its sums never
leave shared memory: wrong results, timed only); and the high branch's
16 -> 16 conv at 256^2 on each body (the tile body pads its 16 input
channels to 32; its shape takes the tile body).
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
    side, c0, c1, cout, ksize = cs.CONV_LAYERS[name]
    taps = (3, 3) if ksize == 3 else (4, 4)

    def draw(c):
        x = torch.relu(torch.randn(cs.BATCH, side, side, c, generator=gen)).to(dev).bfloat16()
        w = torch.randn(*taps, c, cout, generator=gen) * (9 * (c0 + c1)) ** -0.5
        return x, w.to(dev).bfloat16()
    x, w = draw(c0)
    shift = (torch.randn(cout, generator=gen) * 0.1).to(dev)
    args = dict(x=x, w=w, shift=shift, ksize=ksize)
    if c1:
        args["x2"], args["w2"] = draw(c1)
    with torch.inference_mode():
        want = conv_tile_reference(**args)
    flops = cs.conv_flops(cs.BATCH * side * side, ksize * ksize * (4 if ksize == 2 else 1),
                          c0 + c1, cout)
    return args, want, flops


def packs(args):
    """The packed weights of a layer, as the folds hand them to conv_tile."""
    out = dict(packed=pack_conv_weights(args["w"], args["ksize"]))
    if "w2" in args:
        out["packed2"] = pack_conv_weights(args["w2"], args["ksize"])
    return out


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


# K3: the trunk layers under each plan, and the head group's variants.
K3_LAYERS = ("K3 up 128^2 256->64", "K3 256^2 64->64", "K3 256^2 [64+64]->64",
             "K3 256^2 64->32", "K4 256^2 96->48", "K4 256^2 16->16")
_TWO_BLOCKS = "constexpr bool wg_two_blocks(int n, int ks) { return n <= 64; }"
_ONE_BLOCK = "constexpr bool wg_two_blocks(int n, int ks) { return false; }"
K3_PLANS = {
    "as it is: two blocks an SM (three slots at 64 wide, 3x3)": [],
    "four slots at every width (one block an SM at 64 wide, 3x3)": [(_TWO_BLOCKS, _ONE_BLOCK)],
}
K3_GROUP_VARIANTS = {
    "as it is": [],
    "no products": [_K1_NO_PRODUCTS],
    "no staging": [("        cp_async16(b1 + v * pl4 + p * 16, src, ok ? 16 : 0);\n", "")],
}


def built_from(edits, tmp, tag):
    """Load the library built from csrc/ with `edits` ({file: [(old, new)]})."""
    csrc = Path(tmp) / tag
    shutil.copytree(_ORIGINAL, csrc)
    for fname, pairs in edits.items():
        text = (csrc / fname).read_text()
        for old, new in pairs:
            cs.check(old in text, f"{tag}: its text is not in {fname}")
            text = text.replace(old, new)
        (csrc / fname).write_text(text)
    _build.CSRC = csrc
    _build.library.cache_clear()


def k3_section(dev, gen):
    from adam_dehaze_tpu_torch.ops.kernels import tail_chain as tc
    model = cs.perturb_bn_(cs.init_params_(cs.MediumIntensityDehazeModel(64), gen), gen)
    wbf = cs.fold_medium_tail(model.eval().to(dev), torch.bfloat16)
    n, side, c = cs.BATCH, cs.SIZE, 64
    d1 = torch.relu(torch.randn(n, side // 2, side // 2, 4 * c, generator=gen)).to(dev).bfloat16()
    f0 = torch.relu(torch.randn(n, side, side, c, generator=gen)).to(dev).bfloat16()
    h1 = torch.relu(torch.randn(n, side, side, c, generator=gen)).to(dev).bfloat16()
    x = torch.rand(n, side, side, 3, generator=gen).to(dev)
    out = torch.empty(n, side, side, 3, device=dev)
    with torch.inference_mode():
        want = cs.medium_tail_chain_reference(d1, f0, x, wbf)
    layers = {name: make_layer(name, dev, gen) for name in K3_LAYERS}

    def head_group():
        tc._Launcher(tc.medium_tail_chain, dev, True).head_group(h1, wbf.head_group, x, out)

    def head_layers():
        run = tc._Launcher(tc.medium_tail_chain, dev, True)
        h2 = torch.empty(n, side, side, c // 2, dtype=torch.bfloat16, device=dev)
        run.conv(h1, wbf.head2[0], wbf.head2[1], h2, packed=wbf.packed.head2)
        run.final(h2, wbf.out, x.bfloat16(), out)

    with tempfile.TemporaryDirectory() as tmp:
        for i, (variant, edits) in enumerate(K3_GROUP_VARIANTS.items()):
            built_from({"lightweight_chain.cu": edits}, tmp, f"g{i}")
            with torch.inference_mode():
                err = cs.max_err(cs.medium_tail_chain(d1, f0, x, wbf), want)
                ms = cs.cuda_ms(lambda: cs.medium_tail_chain(d1, f0, x, wbf))
                group_ms = cs.cuda_ms(head_group)
                extra = (f"; the two launches it replaced (head2 on the conv body, the last "
                         f"layer on the FMA body) {cs.cuda_ms(head_layers):.3f} ms"
                         if not edits else "")
            cs.log(f"[k3 steps] head group {variant}: K3 {ms:.3f} ms, err vs bf16 plain "
                   f"{err:.3e}; the group alone {group_ms:.3f} ms{extra}")
            cs.check(edits or err <= cs.TAIL_BF16_ATOL, f"{variant}: K3 disagrees with plain")
        for i, (variant, edits) in enumerate(K3_PLANS.items()):
            built_from({"conv_tile.cu": edits}, tmp, f"p{i}")
            lib = _build.library()
            for name, (args, want_l, flops) in layers.items():
                o = torch.empty_like(want_l)
                packed = packs(args)
                with torch.inference_mode():
                    err = cs.scaled_err(conv_tile(out=o, **packed, **args), want_l)
                    ms = cs.cuda_ms(lambda: conv_tile(out=o, **packed, **args))
                resident = lib.conv_tile_blocks_per_sm(args["w"].shape[-1], args["ksize"])
                cs.log(f"[k3 steps] {variant}: {name}: {ms:.3f} ms "
                       f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), {resident} blocks an SM by "
                       f"the occupancy API, err {err:.3e}")
                cs.check(err <= cs.CONV_BF16_RTOL, f"{variant}: {name} disagrees with plain")
            with torch.inference_mode():
                err = cs.max_err(cs.medium_tail_chain(d1, f0, x, wbf), want)
                ms = cs.cuda_ms(lambda: cs.medium_tail_chain(d1, f0, x, wbf))
            cs.log(f"[k3 steps] {variant}: K3 {ms:.3f} ms, err vs bf16 plain {err:.3e}")
            cs.check(err <= cs.TAIL_BF16_ATOL, f"{variant}: K3 disagrees with plain")
    _build.CSRC = _ORIGINAL
    _build.library.cache_clear()


_ORIGINAL = _build.CSRC


# Q2: (cin, cout, kernel, stride, input side) of the main path's wide layers.
Q2_LAYERS = ((128, 128, 3, 1, 128), (256, 256, 3, 1, 64), (384, 384, 3, 1, 64),
             (192, 192, 3, 1, 128), (96, 96, 3, 1, 256), (64, 64, 3, 1, 256),
             (64, 128, 4, 2, 256), (192, 384, 4, 2, 128))
Q2_ALL_CHUNKS = [
    ("  return (n == 96 && ks == 3) || n == 64 || n == 48 || n == 32 || n == 16;",
     "  return n == 128 || n == 96 || n == 64 || n == 48 || n == 32 || n == 16;"),
    ("    case 96: return launch_tile<96, 3, T>(a, e, batch, s);",
     "    case 128: return launch_tile_n<128, T>(a, e, ks, batch, s);\n"
     "    case 96: return launch_tile_n<96, T>(a, e, ks, batch, s);"),
]
# The thin layer timed on both bodies: (cin, cout, kernel, stride, input side).
Q2_THIN = (16, 16, 3, 1, 256)
Q2_NO_EPILOGUE = [
    ("  // Epilogue: the sums through shared memory (the ring is drained), then",
     "  if (e.cout > 0) return;\n"
     "  // Epilogue: the sums through shared memory (the ring is drained), then")]


def q2_section(dev, gen):
    from adam_dehaze_tpu_torch.ops.kernels import quant as qk
    layers = []
    for cin, cout, k, stride, side in Q2_LAYERS:
        x = torch.relu(torch.randn(cs.BATCH, side, side, cin, generator=gen)).bfloat16().to(dev)
        w = (torch.randn(cout, cin, k, k, generator=gen) * (k * k * cin) ** -0.5)
        qw, sw = cs.quantize_weight_per_channel(w.bfloat16().to(dev))
        bn = cs.random_eval_bn(cout, gen, dev)
        geo = qk.ConvGeometry.of(cin, cout, k, k, stride, 1)
        with torch.inference_mode():
            q, sx = qk.quantize_images(x, geo.cin_pad)
        ops = dict(q=q, sx=sx, qw=qw, sw=sw.float(), bn=bn, stats=qk.eval_bn_stats(bn))
        layers.append((f"{cin}->{cout} {k}x{k}/{stride} at {side}^2", geo, ops))

    def gather_geometry(geo):
        """The gather body's geometry of a conv whose shape takes the tile
        body, padded as ConvGeometry.of pads the gather body's layers."""
        cin_pad = -(-geo.cin // 16) * 16
        return geo._replace(cin_pad=cin_pad, cout_pad=-(-geo.cout // qk.TILE_N) * qk.TILE_N,
                            k_pad=-(-geo.kh * geo.kw * cin_pad // qk.K_STEP) * qk.K_STEP,
                            body="gather", n_chunk=qk.TILE_N)

    def thin_layer():
        cin, cout, k, stride, side = Q2_THIN
        x = torch.relu(torch.randn(cs.BATCH, side, side, cin, generator=gen)).bfloat16().to(dev)
        w = (torch.randn(cout, cin, k, k, generator=gen) * (k * k * cin) ** -0.5)
        qw, sw = cs.quantize_weight_per_channel(w.bfloat16().to(dev))
        bn = cs.random_eval_bn(cout, gen, dev)
        tile = qk.ConvGeometry.of(cin, cout, k, k, stride, 1)
        for geo in (tile, gather_geometry(tile)):
            with torch.inference_mode():
                q, sx = qk.quantize_images(x, geo.cin_pad)
                o = dict(q=q, sx=sx, qw=qw, sw=sw.float(), bn=bn, stats=qk.eval_bn_stats(bn))
                ms = cs.cuda_ms(run(geo, o))
                err = cs.max_err(run(geo, o)(), qk.int8_conv_fused_reference(
                    q, sx, qk.pack_int8_weights(qw, geo), o["sw"], None, geo, torch.bfloat16,
                    bn, True))
            cs.check(err == 0.0, f"q2 {geo.body} body at {cin}->{cout}: differs from its plain "
                     "version")
            cs.log(f"[q2 steps] {cin}->{cout} {k}x{k}/{stride} at {side}^2 on the {geo.body} "
                   f"body: {ms:.3f} ms, bit for bit")

    def run(geo, o):
        packed = qk.pack_int8_weights(o["qw"], geo)
        return lambda: qk.int8_conv(o["q"], o["sx"], packed, o["sw"], None, geo,
                                    torch.bfloat16, o["bn"], o["stats"], True)

    with tempfile.TemporaryDirectory() as tmp:
        for i, (variant, edits, chunks) in enumerate((
                ("as it is", [], None),
                ("every chunk built", Q2_ALL_CHUNKS, (128, 96, 64)),
                ("no epilogue (timed only)", Q2_NO_EPILOGUE, None))):
            built_from({"int8_conv.cu": edits}, tmp, f"q2_{i}")
            if not edits:
                thin_layer()
            for name, geo, o in layers:
                for n in chunks or (geo.n_chunk,):
                    if geo.cout % n:
                        continue
                    g = geo._replace(n_chunk=n)
                    with torch.inference_mode():
                        ms = cs.cuda_ms(run(g, o))
                        err = (cs.max_err(run(g, o)(), qk.int8_conv_fused_reference(
                            o["q"], o["sx"], qk.pack_int8_weights(o["qw"], g), o["sw"], None, g,
                            torch.bfloat16, o["bn"], True)) if "timed only" not in variant
                            else float("nan"))
                    flops = cs.conv_flops(cs.BATCH * g.out_size(o["q"].shape[1],
                                                                o["q"].shape[2])[0] ** 2,
                                          g.kh * g.kw, g.cin, g.cout)
                    cs.log(f"[q2 steps] {variant}: {name}, N={n}: {ms:.3f} ms "
                           f"({flops / (ms * 1e-3) / 1e12:.0f} TOPS), err vs plain {err:.3e}")
    _build.CSRC = _ORIGINAL
    _build.library.cache_clear()


def main():
    sections = sys.argv[1:] or ["conv", "k1", "k3", "q2"]
    cs.phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    if "k1" in sections:
        k1_section(dev, gen)
    if "conv" in sections:
        conv_section(dev, gen)
    if "k3" in sections:
        k3_section(dev, gen)
    if "q2" in sections:
        q2_section(dev, gen)


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
                packed = packs(args)
                with torch.inference_mode():
                    err = cs.scaled_err(conv_tile(out=out, **packed, **args), want)
                    ms = cs.cuda_ms(lambda: conv_tile(out=out, **packed, **args))
                cs.log(f"[steps] {variant}: {name}: {ms:.3f} ms "
                       f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), err {err:.3e}")
                cs.check(variant in TIMED_ONLY or err <= cs.CONV_BF16_RTOL,
                         f"{variant}: {name} disagrees with plain")
    _build.CSRC, conv_tile_module.WGMMA_COUT_CHUNKS = original, chunks
    _build.library.cache_clear()


if __name__ == "__main__":
    main()
