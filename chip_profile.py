#!/usr/bin/env python3
"""Where the device time goes, on one GPU: torch.profiler over warm calls.

    python3 chip_profile.py [kernels] [routes] [train] [gate] [grads] [joint] [detect]
                            [shards] [q1] [probes] [--earlier-probes FILE]
                            (kernels, routes and train by default)

Profiles, each over 3 warm calls at the sizes of chip_smoke.py (16 images at
256^2, bf16, the same seeded weights and inputs). `kernels`:

- the low-branch chain K1 alone, so that each fused group shows, and the
  canonical high branch alone, so that K2's two passes show beside cuDNN;
- the soft blend K5 alone at (16, 256, 256, 3) in fp32 and in bf16: its
  device time, which CUDA events around back-to-back launches through
  Triton's launcher do not read apart from the host's;
- the tail chains K3 and K4 alone, so that each stage's kernel shows (K3's
  head group as `lightweight_group_kernel<64, 3>`, its trunk layers as
  `conv_tile_wgmma_kernel<N, taps, slots>`);
- the segment chain K6 alone at the high branch's 64^2 x 384 segment and at
  the medium branch's 128^2 x 128 one;
- route_hard and soft routing under the default dispatch, under the forced
  chain / tail_chain / tail_chain dispatch and under the forced chain /
  chain_hybrid / res_e2b_tail_chain dispatch.

`routes`: under the default dispatch, route_hard and route_device_binned on
the 16 images, and route_hard_stream, route_hard_queued and
route_device_binned_stream over 8 batches of them (a call is the 8
batches; each result dropped as it comes, and route_hard_stream again with
all 8 kept), each with the largest host-side entries (CUDA runtime calls
included) beside the device ones.

`train`: one bf16 train step of the high branch at the default width (the
trainer's `make_train_step`: forward and loss under autocast, backward, Adam)
on 16 seeded images at 256^2, profiled, then its parts timed alone with
CUDA events: the branch's forward, its forward and backward under a plain
mean loss, the loss nets' (VGG16, LPIPS) forward and backward on a fixed
output, the Adam step, K2's forward and backward at the six AttentionBlock
shapes, and a batch's host-to-device copies (hazy, clear, dehazed) from
pageable and from pinned memory.

`joint`: one bf16 soft joint step at the default widths (the joint
trainer's `make_train_step`: the frozen classifier's train-mode forward,
the three branches, K5, the JointLoss under autocast, backward, Adam) on 16
seeded images at 256^2, profiled, then its parts timed alone with CUDA
events: the classifier's forward; each branch's forward and its forward
and backward under a plain mean loss; K5's forward (the Function) and its
analytic backward; the JointLoss's forward and backward on a fixed output;
the Adam step. Then the classifier trainer's step (resnet18, refog off,
augmentation on) on the same batch, profiled and timed.

`detect`: the default detector (fcos_resnet18_fpn, 91 classes, seeded) in
bf16: its forward and top-k on 16 seeded images at 256^2, profiled, and
timed with CUDA events beside the same forward with the module and the
input in channels_last memory format (a reading for a later change: the
port's detector runs NCHW); then one train step at the trainer's batch of 8
(`make_detection_train_step`: forward under autocast, the FCOS loss,
backward, Adam), profiled, and its parts timed alone: the forward, the
forward and backward under a plain mean loss, the FCOS loss's target
assignment and backward on fixed level outputs, and the Adam step.

`gate` (no profiler): K2's wrapper `channel_spatial_gate` in inference
mode at the six AttentionBlock shapes, bf16, timed as chip_smoke.py's phase
3 times it (CUDA events, 20 calls after 3), GATE_REPEATS times over, with
the spread of the sum per high-branch call; and its host time per call at
a tiny shape (1, 8, 8, 8), where the launch path and not the card sets the
pace. It runs on any tree whose chip_smoke.py has K2_SHAPES and cuda_ms, so
that two trees can be compared in one call.

`grads` (no profiler): the fp32 train step of chip_smoke.py's phase 10 for
each default branch, on the CPU in fp32 and float64, again in float64 with
every input pixel moved by one fp32 rounding (how far the step amplifies a
change of its inputs), and on the card GRAD_RUNS times under each of
cuDNN's default algorithms, `torch.backends.cudnn.deterministic` and cuDNN
turned off: one line per parameter with its errors against float64 in
units of its own largest magnitude, and for a Conv2d weight its
conditioning (the largest sum|x|*|dy| over its entries, in units of the
gradient's largest magnitude, from the float64 step); and each Conv2d alone
on the card, with cuDNN and without, on the float64 step's own tensors: the
layers whose forward, input gradient or weight gradient is furthest from
float64.

`shards`: the default high branch's serving copy (c = 96) on 2 images at
512 x 490 (its decoder resizes W alone), fp32 with TF32 off and bf16,
unsharded and on each of 2 H shards (two gloo ranks on cuda:0, this script
with `--shard-rank`, chip_smoke.py's phase 24 (c)): each block's and each
encoder and decoder layer's time on a rank beside the unsharded call's
(host clock, synchronized), and what is left between them (the resizes,
concats and the output's own ops).

`q1`: Q1's two passes on an H shard (`image_absmax`, `quantize_images_at`)
at chip_smoke.py phase 23's inputs (the 52 Int8Conv2d calls of one 16-image
bucket of each int8 branch at 256^2 on one of 2 H shards, bf16, per-image
ranges spread over 2^-10 to 2^10), and `torch.linalg.vector_norm(ord=inf)`
on the same inputs: for each distinct layer shape, each call's device time
under the profiler, its CUDA-events time over back-to-back calls, the
wrapper's host time (the host clock around Q1_HOST_CALLS calls that it only
enqueues) and the bound; then the bucket's totals (each shape times its
calls) and the layers where each pass stays furthest from its bound, on the
card and on the host. It needs only the wrappers' names, so it runs on an
older tree too, with this script and chip_smoke.py copied in.

`probes`: the ten operation probes (`tools/probe_ops.py`) on their tool's
inputs (x 1088 x 384 bf16): each pattern's device time per call under the
profiler, its CUDA-events time over back-to-back calls, the wrapper's host
time and its bound (bytes moved once over 3.35 TB/s); then the ten summed,
and the launch floor: an empty kernel's device, events and host time a
launch. `--earlier-probes FILE` also builds FILE, an earlier
`csrc/probe_ops.cu` whose `probe_op` takes no workspace (`git show
REV:adam_dehaze_tpu_torch/csrc/probe_ops.cu` into a git-ignored directory),
by nvcc beside this tree's `common.cuh`, holds each of its patterns against
the plain expression and reads it the same ways in the same windows: a
change to `csrc/probe_ops.cu` is read against its parent's design so, in one
call on one card. Every window must hold each design's `iters` entries,
one a call, or it is taken again.

For the profiled sections it prints the device-busy time per call (kernels
and memcpys, summed once each), the host wall time per call, and the
largest device entries by name. It fails without a CUDA card, and if the
profiler saw no device time.
"""
import copy
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

CALLS = 3
TOP = 12
GATE_REPEATS = 10
GATE_HOST_CALLS = 2000
GRAD_RUNS = 3
SECTIONS = ("kernels", "routes", "train", "gate", "grads", "joint", "detect", "shards", "q1",
            "probes")
Q1_HOST_CALLS = 50
SHARD_SHAPE = (2, 512, 490, 3)
# The high branch's blocks timed by `shards`, besides each layer of its
# encoder and decoder stages.
SHARD_BLOCKS = ("detail_branch", "init_conv", "bottleneck", "output_conv")


def profiled(tag, fn, host_top=0):
    """Run fn CALLS times under the profiler; print the busy time per call
    and the top device entries (and the `host_top` largest host entries by
    self time)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()   # the profiler's own start and stop left out
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / CALLS
    rows = [(e.key, e.self_device_time_total / 1e3 / CALLS, e.count // CALLS)
            for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, ms, _ in rows)
    cs.check(busy > 0, f"{tag}: the profiler saw no device time")
    cs.log(f"[profile {tag}] device busy {busy:.3f} ms per call, host wall (profiler on) "
           f"{wall:.3f} ms per call; {len(rows)} kinds of device entries")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:TOP]:
        cs.log(f"[profile {tag}]   {ms:8.3f} ms  x{count:<4d} {name[:110]}")
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / CALLS, e.count // CALLS)
                   for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda r: -r[1])
    for name, ms, count in host[:host_top]:
        cs.log(f"[profile {tag}]   host {ms:8.3f} ms  x{count:<4d} {name[:100]}")


def profile_routes(router, dev):
    """The serving routes under the default dispatch (see the docstring)."""
    cfg = load_config()
    d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev)
    x = np.random.default_rng(cs.SEED).random((cs.BATCH, cs.SIZE, cs.SIZE, 3),
                                              dtype=np.float32)
    stream = [x] * 8
    cs.log(f"[profile routes] route_hard intensities "
           f"{np.bincount(d.route_hard(x)[1], minlength=3).tolist()}")
    for tag, fn in (
            ("route_hard", lambda: d.route_hard(x)),
            ("route_device_binned", lambda: d.route_device_binned(x)),
            ("route_hard_stream, 8 batches", lambda: cs.drain(d.route_hard_stream(stream))),
            ("route_hard_stream, 8 batches, results kept",
             lambda: list(d.route_hard_stream(stream))),
            ("route_hard_queued, 8 batches", lambda: cs.drain(d.route_hard_queued(stream))),
            ("route_device_binned_stream, 8 batches",
             lambda: cs.drain(d.route_device_binned_stream(stream)))):
        profiled(tag, fn, host_top=8)
    del d
    torch.cuda.empty_cache()


def shard_profiles(dev, mesh=None):
    """The high branch of phase 24 (c), fp32 and bf16, on the whole batch or
    through make_spatial_infer on this rank's rows: each top-level block's
    ms (host clock around a synchronize on each side, the median of
    CALLS warm calls). No profiler: two processes tracing one card with
    CUPTI at once stalled."""
    from adam_dehaze_tpu_torch.ops.serving_apply import cast_for_serving
    from adam_dehaze_tpu_torch.parallel.spatial import make_spatial_infer, shard_image_batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    high = cs.make_router(load_config(), torch.Generator().manual_seed(cs.SEED)).models["high"]
    high = high.to(dev).eval()
    x = torch.rand(SHARD_SHAPE, generator=torch.Generator().manual_seed(cs.SEED)).to(dev)
    where = "unsharded" if mesh is None else f"rank {mesh.axis('spatial').index} of 2"
    for dtype in (torch.float32, torch.bfloat16):
        copy_ = cast_for_serving(high, dtype)
        fn, arg = ((copy_, x) if mesh is None else
                   (make_spatial_infer(copy_, mesh), shard_image_batch(mesh, x)))
        times, starts = {}, {}

        def pre(module, args, name=None):
            torch.cuda.synchronize()
            starts[name] = time.perf_counter()

        def post(module, args, out, name=None):
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - starts[name]) * 1e3)

        blocks = [(name, m) for name, m in copy_.named_modules()
                  if name in SHARD_BLOCKS or (name.count(".") == 2 and name[:9] in
                                              ("encoder.0", "encoder.1", "decoder.0",
                                               "decoder.1"))]
        hooks = [h for name, child in blocks
                 for h in (child.register_forward_pre_hook(lambda m, a, n=name: pre(m, a, n)),
                           child.register_forward_hook(lambda m, a, o, n=name: post(m, a, o, n)))]
        with torch.inference_mode():
            fn(arg)
            times.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn(arg)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / CALLS
        for h in hooks:
            h.remove()
        rest = wall - sum(np.median(ms) * len(ms) / CALLS for ms in times.values())
        parts = ", ".join(f"{name} {np.median(ms) * len(ms) / CALLS:.2f}"
                          for name, ms in times.items()) + f"; between the blocks {rest:.2f}"
        cs.log(f"[shards high {str(dtype)[6:]} {SHARD_SHAPE[1]}x{SHARD_SHAPE[2]} {where}] "
               f"{wall:.2f} ms a call of {SHARD_SHAPE[0]} images (synchronized at every "
               f"block); ms a call by block: {parts}")


def shard_rank(rank, port):
    """One of the two ranks of `shards`: gloo on cuda:0."""
    from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=2, rank=rank)
    try:
        shard_profiles(dev, make_mesh({"data": 1, "spatial": 2}, [dev] * 2))
    finally:
        torch.distributed.destroy_process_group()


def profile_shards(dev):
    """`shards` (see the docstring): unsharded here, then the two ranks."""
    shard_profiles(dev)
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--shard-rank",
                               str(rank), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    logs = cs._run_all({"shards": procs}, cs.RESIZE_TIMEOUT_S)["shards"]
    for p, text in zip(procs, logs):
        print(text, flush=True)
        cs.check(p.returncode == 0, "a shard rank failed")


def main():
    args = sys.argv[1:]
    earlier = None
    if "--earlier-probes" in args:
        at = args.index("--earlier-probes")
        earlier = args[at + 1]
        del args[at:at + 2]
    sections = args or ["kernels", "routes", "train"]
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"chip_profile: unknown sections {sorted(unknown)}")
    cs.phase_device()
    dev = torch.device("cuda")
    cs.phase_build()
    if "kernels" in sections:
        profile_kernels(dev)
    if "routes" in sections:
        profile_routes(cs.make_router(load_config(), torch.Generator().manual_seed(cs.SEED)),
                       dev)
    if "train" in sections:
        profile_train(dev)
    if "gate" in sections:
        time_gate(dev)
    if "grads" in sections:
        fp32_step_readings(dev)
    if "joint" in sections:
        profile_joint(dev)
    if "detect" in sections:
        profile_detect(dev)
    if "shards" in sections:
        profile_shards(dev)
    if "q1" in sections:
        profile_q1(dev)
    if "probes" in sections:
        profile_probes(dev, earlier)


def host_ms(fn, calls=Q1_HOST_CALLS):
    """The host's ms per call of fn(), enqueued back to back (a warm call and
    a synchronize first; the card drains after the clock stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def q1_pass_of(kernel: str) -> str:
    """The pass of `q1` that a device entry belongs to, by its name: the
    abs-max kernels (and a memset before one, where a tree has it), the
    quantizing kernels, else vector_norm's reduction."""
    if "absmax" in kernel or "Memset" in kernel:
        return "Q1a"
    return "Q1b" if "quantize" in kernel else "vector_norm"


def q1_device_us(fns, iters=10, tries=3, pass_of=q1_pass_of, launches=None):
    """{pass: device µs a call} of the passes `fns` ({pass: fn}), each run
    `iters` times under ONE profiler window (a process that opened some
    fifty windows has seen one come back empty), its device entries split by
    `pass_of`. A window in which a pass has no entry is taken again, and so
    is one in which a pass's entries are not `iters` x `launches` (kernels
    a call, where given): a process's later windows have been seen to lose
    some of them."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn in fns.values():
                for _ in range(iters):
                    fn()
            torch.cuda.synchronize()
        us, seen = dict.fromkeys(fns, 0.0), dict.fromkeys(fns, 0)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                us[pass_of(e.key)] += e.self_device_time_total / iters
                seen[pass_of(e.key)] += e.count
        if all(us.values()) and (launches is None
                                 or all(n == iters * launches for n in seen.values())):
            return us
    raise AssertionError(f"the profiler saw {seen} device entries of the passes in {iters} "
                         f"calls each: {us}")


def profile_q1(dev):
    """`q1` (see the docstring)."""
    from adam_dehaze_tpu_torch.ops.kernels import _build
    from adam_dehaze_tpu_torch.ops.kernels import quant
    cfg8 = load_config(overrides={"cuda": {"serving_quant": "int8"}})
    router = cs.make_router(load_config(), torch.Generator().manual_seed(cs.SEED))
    d8 = AdaptiveDehazer(router, None, cfg8, device=dev)
    inputs = cs.q1_split_inputs(d8, dev)
    del d8, router
    torch.cuda.empty_cache()
    passes = {"Q1a": lambda g, x, a: quant.image_absmax(x),
              "Q1b": lambda g, x, a: quant.quantize_images_at(x, a, g.cin_pad),
              "vector_norm": lambda g, x, a: torch.linalg.vector_norm(x, float("inf"),
                                                                     dim=(1, 2, 3))}
    rows = []
    with torch.inference_mode():
        for geo, calls, xs, amax in inputs:
            row = dict(shape=tuple(xs.shape), cin_pad=geo.cin_pad, calls=calls)
            fns = {name: (lambda fn=fn: fn(geo, xs, amax)) for name, fn in passes.items()}
            device = q1_device_us(fns)
            for name, call in fns.items():
                # Bytes moved once: x and amax read; Q1b also writes q and the scales.
                q_bytes = xs.numel() // xs.shape[3] * geo.cin_pad + 4 * xs.shape[0]
                moved = cs.nbytes(xs, amax) + (q_bytes if name == "Q1b" else 0)
                row[name] = dict(device=device[name], events=cs.cuda_ms(call, 20, 3) * 1e3,
                                 host=host_ms(call) * 1e3, bound=moved / cs.PEAK_BYTES_S * 1e6)
            rows.append(row)
            cs.log(f"[q1 layer] {row['shape']} cin_pad {row['cin_pad']} x{calls}: " + "; ".join(
                f"{name} bound {r['bound']:.1f} us, device {r['device']:.1f} us "
                f"({r['device'] / r['bound']:.2f}x), events {r['events']:.1f} us, host "
                f"{r['host']:.1f} us" for name, r in ((n, row[n]) for n in passes)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for name in passes:
        tot = {k: sum(r["calls"] * r[name][k] for r in rows) / 1e3
               for k in ("device", "events", "host", "bound")}
        cs.log(f"[q1 bucket] {name}: {sum(r['calls'] for r in rows)} calls, bound "
               f"{tot['bound']:.3f} ms, device {tot['device']:.3f} ms "
               f"({tot['device'] / tot['bound']:.2f}x), CUDA events {tot['events']:.3f} ms "
               f"({tot['events'] / tot['bound']:.2f}x), host {tot['host']:.3f} ms; {smi}")
        if name == "vector_norm":
            continue
        card = sorted(rows, key=lambda r: -r["calls"] * (r[name]["device"] - r[name]["bound"]))
        host = sorted(rows, key=lambda r: -r["calls"] * (r[name]["events"] - r[name]["device"]))
        cs.log(f"[q1 furthest] {name} on the card (calls x (device - bound)): " + ", ".join(
            f"{r['shape']} {r['calls'] * (r[name]['device'] - r[name]['bound']):.1f} us"
            for r in card[:3]) + "; by the host (calls x (events - device)): " + ", ".join(
            f"{r['shape']} {r['calls'] * (r[name]['events'] - r[name]['device']):.1f} us"
            for r in host[:3]))
    # The host path of a call, on a tensor too small for the card to matter.
    x = torch.zeros((16, 2, 2, 8), dtype=torch.bfloat16, device=dev)
    amax = torch.ones(16, device=dev)
    steps = {"image_absmax": lambda: quant.image_absmax(x),
             "quantize_images_at": lambda: quant.quantize_images_at(x, amax, 8),
             "vector_norm": lambda: torch.linalg.vector_norm(x, float("inf"), dim=(1, 2, 3)),
             "its torch.empty": lambda: torch.empty((16,), dtype=torch.float32, device=dev),
             "its stream handle": lambda: _build.stream_ptr(x.device)}
    if hasattr(quant, "_absmax_partial"):
        lib, out = _build.library(), torch.empty(16, device=dev)
        stream = _build.stream_ptr(x.device)
        partial = quant._absmax_partial(x.device, stream, 16)
        steps["its C entry (ctypes, launch)"] = lambda: lib.int8_absmax(
            x.data_ptr(), partial, out.data_ptr(), 16, 4, 8, 1, stream)
    with torch.inference_mode():
        cs.log("[q1 host] us a call, enqueued back to back at (16, 2, 2, 8) bf16: " + ", ".join(
            f"{name} {host_ms(fn, 20 * Q1_HOST_CALLS) * 1e3:.2f}" for name, fn in steps.items()))


def probe_design_of(kernel: str) -> str:
    """Whose a device entry of `probes` is, by its kernel's name: the empty
    kernel's, this tree's probes' (`probe_kernel<Ep>`, `probe_select_kernel`)
    or the earlier design's (`probe_a` to `probe_i`)."""
    if "probe_empty" in kernel:
        return "empty"
    return "now" if "probe_kernel" in kernel or "probe_select" in kernel else "earlier"


def earlier_probe_library(source):
    """The probes of an earlier `csrc/probe_ops.cu` (`probe_op(which, x, w,
    wrep, out, flat, stream)`), built alone by nvcc with this tree's flags
    and headers, loaded by ctypes."""
    import ctypes
    from adam_dehaze_tpu_torch.ops.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "libprobe_earlier.so")
        t0 = time.perf_counter()
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                        "-o", lib_path, os.path.abspath(source)], check=True,
                       capture_output=True, text=True)
        cs.log(f"[probes] built the earlier design {source} in {time.perf_counter() - t0:.1f} s")
        lib = ctypes.CDLL(lib_path)
    lib.probe_op.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                                       ctypes.c_void_p]
    lib.probe_op.restype = ctypes.c_int
    return lib


def profile_probes(dev, earlier=None):
    """`probes` (see the docstring)."""
    from adam_dehaze_tpu_torch.ops.kernels import _build
    from adam_dehaze_tpu_torch.tools import probe_ops
    x, w, wrep = probe_ops.probe_inputs(dev, cs.SEED)
    lib = earlier_probe_library(earlier) if earlier else None
    stream = _build.stream_ptr(x.device)
    rows = {}
    for name, (index, _, cols) in probe_ops.PROBES.items():
        out = torch.empty((probe_ops.ROWS, cols), device=dev)
        fns = {"now": lambda name=name, out=out: probe_ops.probe_op(name, x, w, wrep, out)}
        if lib is not None:
            def old(index=index, out=out):
                cs.check(lib.probe_op(index, x.data_ptr(), w.data_ptr(), wrep.data_ptr(),
                                      out.data_ptr(), x.shape[0], stream) == 0,
                         f"the earlier design's {name} failed to launch")
            fns["earlier"] = old
        want = probe_ops.probe_reference(name, x, w, wrep)
        for design, fn in fns.items():
            out.fill_(float("nan"))
            fn()
            err = cs.scaled_err(out, want)
            cs.check(err <= probe_ops.PROBE_RTOL, f"{design} {name} disagrees: {err:.3e}")
        device = q1_device_us(fns, pass_of=probe_design_of, launches=1)
        moved = cs.probe_work(name, x, w, wrep, out)[0]
        rows[name] = {design: dict(device=device[design], events=cs.cuda_ms(fn, 20, 3) * 1e3,
                                   host=host_ms(fn) * 1e3) for design, fn in fns.items()}
        rows[name]["bound"] = moved / cs.PEAK_BYTES_S * 1e6
        cs.log(f"[probe] {name}: bound {rows[name]['bound']:.2f} us; " + "; ".join(
            f"{design} device {r['device']:.2f} us, events {r['events']:.2f} us, host "
            f"{r['host']:.2f} us" for design, r in rows[name].items() if design != "bound"))
    empty = {"empty": lambda: probe_ops.empty_launch(dev)}
    floor = dict(device=q1_device_us(empty, pass_of=probe_design_of, launches=1)["empty"],
                 events=cs.cuda_ms(empty["empty"], 20, 3) * 1e3,
                 host=host_ms(empty["empty"]) * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for design in ("now", "earlier") if lib is not None else ("now",):
        tot = {k: sum(r[design][k] for r in rows.values()) / 1e3
               for k in ("device", "events", "host")}
        cs.log(f"[probes {design}] the ten: device {tot['device']:.4f} ms under the profiler, "
               f"CUDA events {tot['events']:.4f} ms, host {tot['host']:.4f} ms; bound "
               f"{sum(r['bound'] for r in rows.values()) / 1e3:.4f} ms; {smi}")
    cs.log(f"[probes floor] an empty kernel a launch: device {floor['device']:.2f} us, events "
           f"{floor['events']:.2f} us, host {floor['host']:.2f} us; ten: device "
           f"{10 * floor['device'] / 1e3:.4f} ms, events {10 * floor['events'] / 1e3:.4f} ms")


def time_gate(dev):
    """K2's wrapper at the high branch's shapes, and its host path (see the
    docstring)."""
    from adam_dehaze_tpu_torch.ops.kernels.cbam import channel_spatial_gate

    gen = torch.Generator().manual_seed(cs.SEED)
    inputs = []
    for shape, calls in cs.K2_SHAPES.items():
        x = torch.rand(shape, generator=gen).to(dev).bfloat16()
        g = torch.sigmoid(torch.randn(shape[0], shape[3], generator=gen)).to(dev)
        w = (torch.randn(7, 7, 2, 1, generator=gen) * 0.1).to(dev).bfloat16().float()
        inputs.append((calls, x, g, w))
    tiny = (torch.rand(1, 8, 8, 8, generator=gen).to(dev).bfloat16(),
            torch.rand(1, 8, generator=gen).to(dev),
            torch.zeros(7, 7, 2, 1, device=dev))
    with torch.inference_mode():
        per_call = []
        for _ in range(GATE_REPEATS):
            per_call.append(sum(calls * cs.cuda_ms(lambda: channel_spatial_gate(x, g, w))
                                for calls, x, g, w in inputs))
        host_us = []
        for _ in range(GATE_REPEATS):
            channel_spatial_gate(*tiny)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GATE_HOST_CALLS):
                channel_spatial_gate(*tiny)
            torch.cuda.synchronize()
            host_us.append((time.perf_counter() - t0) * 1e6 / GATE_HOST_CALLS)
    for tag, vals, unit in (("wrapper per high-branch call (6 blocks)", per_call, "ms"),
                            ("host time per call at (1, 8, 8, 8)", host_us, "us")):
        ranked = sorted(vals)
        cs.log(f"[gate] K2 {tag}, {GATE_REPEATS} repeats: min {ranked[0]:.3f}, median "
               f"{ranked[len(vals) // 2]:.3f}, max {ranked[-1]:.3f} {unit} (in order: "
               f"{', '.join(f'{v:.3f}' for v in vals)})")


def fp32_step_readings(dev):
    """Every parameter's fp32 gradient error against float64, CPU and card,
    and each Conv2d alone on the card (see the docstring)."""
    from adam_dehaze_tpu_torch.losses.dehazing import get_dehazing_loss

    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    batch = cs.fp32_step_batch()
    loss = get_dehazing_loss(cfg)
    for level in cs.INTENSITY_ORDER:
        io = {}
        _, g64, m64 = cs.fp32_step(level, cfg, loss, batch, "cpu", torch.float64, capture=io)
        _, g_cpu, _ = cs.fp32_step(level, cfg, loss, batch, "cpu", torch.float32)
        cpu, _ = cs.per_tensor_errs(g_cpu, g64)
        # The step's own sensitivity: float64 throughout, each input pixel
        # moved by one part in 2^24 (an fp32 rounding), up or down at random.
        signs = torch.Generator().manual_seed(cs.SEED)
        moved = {k: v.double() * (1 + 2.0 ** -24 * (torch.randint(
            0, 2, v.shape, generator=signs) * 2 - 1)) for k, v in batch.items()}
        nudged, _ = cs.per_tensor_errs(
            cs.fp32_step(level, cfg, loss, moved, "cpu", torch.float64)[1], g64)
        convs = {n: (m64.get_submodule(n), x, dy) for n, (x, dy) in io.items()}
        cond = {}
        for n, (m, x, dy) in convs.items():
            terms = torch.nn.grad.conv2d_weight(x.abs(), m.weight.shape, dy.abs(), m.stride,
                                                m.padding, m.dilation, m.groups)
            cond[f"{n}.weight"] = float(terms.max()) / float(g64[f"{n}.weight"].abs().max())
        # (cudnn.enabled, cudnn.deterministic) per mode, set directly: the
        # cudnn.flags context resets every flag it is not given.
        modes = {"cuDNN default": (True, False), "cuDNN deterministic": (True, True),
                 "cuDNN off": (False, False)}
        runs = {}
        for mode, (on, det) in modes.items():
            torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = on, det
            runs[mode] = [cs.per_tensor_errs(cs.fp32_step(
                level, cfg, loss, batch, dev, torch.float32)[1], g64)[0]
                for _ in range(GRAD_RUNS)]
            if mode != "cuDNN deterministic":
                conv_alone(level, mode, convs, dev)
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = True, False
        cs.log(f"[grads] {level}: per tensor, error against float64 in units of its own "
               f"max|g|: CPU | float64 with the inputs moved by 2^-24 | card, {GRAD_RUNS} "
               f"runs each under {' | '.join(modes)} | conditioning")
        for n in cpu:
            cards = " | ".join(" ".join(f"{r[n]:.3e}" for r in rs) for rs in runs.values())
            c = f"{cond[n]:.3e}" if n in cond else "-"
            cs.log(f"[grads] {level} {n}: {cpu[n]:.3e} | {nudged[n]:.3e} | {cards} | {c}")
        most = max(nudged, key=nudged.get)
        cs.log(f"[grads] {level}, float64 with the inputs moved by 2^-24: largest change on "
               f"{most}: {nudged[most]:.3e} (CPU fp32 {cpu[most]:.3e} there)")
        for mode, rs in runs.items():
            worst = max(cpu, key=lambda n: max(r[n] for r in rs) / max(cpu[n], 1e-12))
            most = max(cpu, key=lambda n: max(r[n] for r in rs))
            cs.log(f"[grads] {level}, {mode}: largest card/CPU ratio on {worst}: card "
                   f"{max(r[worst] for r in rs):.3e}, CPU {cpu[worst]:.3e}; largest card "
                   f"error on {most}: {max(r[most] for r in rs):.3e} (CPU {cpu[most]:.3e})")


def conv_alone(level, mode, convs, dev):
    """Each Conv2d of the float64 step alone on the card in fp32, on that
    step's own input, weight and output gradient: its forward, input
    gradient and weight gradient against float64, in units of each result's
    largest magnitude; the three layers with the largest error of each."""
    errs = {}
    for n, (m, x, dy) in convs.items():
        args = (m.stride, m.padding, m.dilation, m.groups)
        w = m.weight.detach()
        ops = [lambda x, w, dy: torch.nn.functional.conv2d(x, w, None, *args),
               lambda x, w, dy: torch.nn.grad.conv2d_input(x.shape, w, dy, *args),
               lambda x, w, dy: torch.nn.grad.conv2d_weight(x, w.shape, dy, *args)]
        card = [t.to(dev, torch.float32) for t in (x, w, dy)]
        errs[n] = [cs.max_err(op(*card).cpu(), want) / float(want.abs().max())
                   for op, want in ((op, op(x, w, dy)) for op in ops)]
    for i, op in enumerate(("forward", "input gradient", "weight gradient")):
        top = sorted(errs, key=lambda n: -errs[n][i])[:3]
        cs.log(f"[grads] {level}, {mode}, each Conv2d alone, {op}: "
               + ", ".join(f"{n} {errs[n][i]:.2e}" for n in top))


def profile_train(dev):
    """A high-branch bf16 train step and its parts (see the docstring)."""
    from adam_dehaze_tpu_torch.losses.dehazing import get_dehazing_loss
    from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
    from adam_dehaze_tpu_torch.training.train_dehazing import init_branch, make_train_step

    cfg = load_config()
    model = init_branch("high", cfg, dev).train()
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4))
    loss = get_dehazing_loss(cfg)
    nets = loss.init(torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(cs.SEED)
    host = {k: torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=gen)
            for k in ("hazy", "clear", "dehazed")}
    batch = {k: v.to(dev) for k, v in host.items()}
    aug = torch.Generator(dev).manual_seed(1)
    step = make_train_step(loss, nets, dtype=torch.bfloat16)
    profiled("train step, high, bf16", lambda: step(state, batch, aug))
    parts = {"whole step (augment, forward, loss, backward, Adam)":
             lambda: step(state, batch, aug)}

    def autocast():
        return torch.autocast("cuda", dtype=torch.bfloat16)

    def branch_fwd():
        with torch.no_grad(), autocast():
            model(batch["hazy"])

    def branch_fwd_bwd():
        with autocast():
            out = model(batch["hazy"])
        out.mean().backward()

    with torch.no_grad(), autocast():
        fixed = model(batch["hazy"])

    def loss_fwd_bwd():
        out = fixed.detach().requires_grad_(True)
        with autocast():
            total, _ = loss(nets, out, batch["clear"], hazy=batch["hazy"])
        total.backward()

    parts.update({"branch forward": branch_fwd, "branch forward + backward": branch_fwd_bwd,
                  "loss nets forward + backward": loss_fwd_bwd,
                  "Adam step": lambda: state.optimizer.step()})
    for name, fn in parts.items():
        cs.log(f"[train parts] {name}: {cs.cuda_ms(fn, iters=10, warmup=2):.3f} ms")
    del fixed
    torch.cuda.empty_cache()
    k2 = cs.phase_gate_grad(dev, torch.Generator().manual_seed(cs.SEED + 4))
    cs.log(f"[train parts] K2 forward {k2['forward_ms']:.3f} ms, backward "
           f"{k2['backward_ms']:.3f} ms per step (six AttentionBlocks)")
    pinned = {k: v.pin_memory() for k, v in host.items()}
    for tag, src, non_blocking in (("pageable", host, False), ("pinned", pinned, True)):
        ms = cs.cuda_ms(lambda: [v.to(dev, non_blocking=non_blocking) for v in src.values()],
                        iters=10, warmup=2)
        mb = sum(v.numel() * 4 for v in src.values()) / 1e6
        cs.log(f"[train parts] batch upload from {tag} memory: {ms:.3f} ms for {mb:.1f} MB "
               f"({mb / ms:.1f} GB/s)")


def profile_joint(dev):
    """A bf16 soft joint step and its parts (see the docstring)."""
    from adam_dehaze_tpu_torch.losses.dehazing import get_joint_loss
    from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER
    from adam_dehaze_tpu_torch.ops.kernels.blend import blend3
    from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
    from adam_dehaze_tpu_torch.training.train_joint import build_router_state, make_train_step

    cfg = load_config()
    cfg["classifier"]["checkpoint_dir"] = cfg["dehazing"]["checkpoint_dir"] = "absent"
    router, state = build_router_state(cfg, dev)
    router.train()
    loss = get_joint_loss(cfg)
    nets = loss.init(torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(cs.SEED)
    batch = {k: torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=gen).to(dev)
             for k in ("hazy", "clear", "dehazed")}
    batch["intensity"] = (torch.arange(cs.BATCH) % 3).to(dev)
    aug = torch.Generator(dev).manual_seed(1)
    step = make_train_step(loss, nets, dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    profiled("soft joint step, bf16", lambda: step(state, batch, aug))
    cs.log(f"[joint parts] peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    x = batch["hazy"]

    def autocast():
        return torch.autocast("cuda", dtype=torch.bfloat16)

    def classifier_fwd():
        with torch.no_grad(), autocast():
            router.classifier(x, aug)

    parts = {"whole step (augment, forward, loss, backward, Adam)":
             lambda: step(state, batch, aug),
             "classifier forward (train mode, frozen)": classifier_fwd}
    for level in INTENSITY_ORDER:
        model = router.models[level]

        def fwd(model=model):
            with torch.no_grad(), autocast():
                model(x)

        def fwd_bwd(model=model):
            with autocast():
                out = model(x)
            out.mean().backward()

        parts[f"{level} forward"] = fwd
        parts[f"{level} forward + backward"] = fwd_bwd
    with torch.no_grad(), autocast():
        ys = [router.models[level](x) for level in INTENSITY_ORDER]
        logits = router.classifier(x)[0]
        weights = torch.softmax(logits / router.temperature, dim=1)
    ys = [y.detach().requires_grad_(True) for y in ys]
    blended = blend3(weights, *ys)
    g = torch.randn_like(blended)
    parts["K5 forward (Function)"] = lambda: blend3(weights, *ys)
    parts["K5 backward (analytic)"] = lambda: torch.autograd.grad(blended, ys, g,
                                                                  retain_graph=True)
    fixed = blended.detach()

    def loss_fwd_bwd():
        out = fixed.clone().requires_grad_(True)
        with autocast():
            total, _ = loss(nets, out, batch["clear"], logits, batch["intensity"],
                            hazy=batch["hazy"])
        total.backward()

    parts["JointLoss forward + backward"] = loss_fwd_bwd
    parts["Adam step"] = lambda: state.optimizer.step()
    for name, fn in parts.items():
        cs.log(f"[joint parts] {name}: {cs.cuda_ms(fn, iters=10, warmup=2):.3f} ms")
    cs.log(f"[joint parts] {cs.BATCH} images at {cs.SIZE}^2, bf16 autocast, default widths")
    del state, router, parts, ys, blended, fixed
    torch.cuda.empty_cache()

    # The classifier trainer's step on the same batch (its data on the card).
    from adam_dehaze_tpu_torch.training import train_classifier as tc
    model = tc.init_classifier(cfg, dev).train()
    cstate = TrainState(model, make_optimizer(model.parameters(), 1e-4, 1e-4))
    cstep = tc.make_train_step(dtype=torch.bfloat16)
    profiled("classifier train step, bf16", lambda: cstep(cstate, batch, aug))
    cs.log(f"[joint parts] classifier train step: "
           f"{cs.cuda_ms(lambda: cstep(cstate, batch, aug), iters=10, warmup=2):.3f} ms")


def profile_detect(dev):
    """The detector's forward and train step (see the docstring)."""
    from adam_dehaze_tpu_torch.models.detection import DetectionModel, imagenet_normalize
    from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
    from adam_dehaze_tpu_torch.training.train_detection import (
        fcos_loss,
        make_detection_train_step,
    )

    det = DetectionModel(dtype=torch.bfloat16, device=dev)
    det.init(cs.SEED)
    gen = torch.Generator().manual_seed(cs.SEED)
    x = imagenet_normalize(torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=gen).to(dev))
    profiled("detector forward + top-k, bf16", lambda: det.candidates(x))
    ms = cs.cuda_ms(lambda: det.candidates(x), iters=10, warmup=2)
    last = copy.deepcopy(det)
    last.module = last.module.to(memory_format=torch.channels_last)
    x_last = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x_last = x_last.permute(0, 2, 3, 1)     # NHWC view of channels_last storage
    ms_last = cs.cuda_ms(lambda: last.candidates(x_last), iters=10, warmup=2)
    cs.log(f"[detect parts] forward + top-k, {cs.BATCH} images at {cs.SIZE}^2, bf16: "
           f"{ms:.3f} ms ({ms / cs.BATCH:.3f} ms/image); module and input in channels_last "
           f"{ms_last:.3f} ms ({ms_last / cs.BATCH:.3f} ms/image)")
    del last

    n = cs.BATCH // 2
    model = det.module.train()
    state = TrainState(model, make_optimizer(model.parameters(), 1e-5, 1e-4))
    boxes = torch.rand(n, 64, 4, generator=gen) * 128
    boxes[..., 2:] += boxes[..., :2] + 8
    batch = {"hazy": x[:n], "boxes": boxes.to(dev),
             "labels": torch.randint(1, 3, (n, 64), generator=gen).to(dev),
             "n_boxes": torch.randint(4, 12, (n,), generator=gen).to(dev)}
    step = make_detection_train_step(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    profiled("detector train step, bf16", lambda: step(state, batch))

    def autocast():
        return torch.autocast("cuda", dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad(), autocast():
            model(batch["hazy"])

    def fwd_bwd():
        with autocast():
            outs = model(batch["hazy"])
        sum(o["logits"].mean() + o["offsets"].mean() + o["centerness"].mean()
            for o in outs).backward()

    with torch.no_grad(), autocast():
        fixed = model(batch["hazy"])

    def loss_fwd_bwd():
        outs = [{**o, **{k: o[k].detach().requires_grad_(True)
                         for k in ("logits", "offsets", "centerness")}} for o in fixed]
        fcos_loss(outs, batch["boxes"], batch["labels"], batch["n_boxes"],
                  model.num_classes)["total"].backward()

    parts = {"whole step (forward, loss, backward, Adam)": lambda: step(state, batch),
             "forward": fwd, "forward + backward (mean of the outputs)": fwd_bwd,
             "FCOS loss: assignment, forward + backward": loss_fwd_bwd,
             "Adam step": lambda: state.optimizer.step()}
    for name, fn in parts.items():
        cs.log(f"[detect parts] {name}: {cs.cuda_ms(fn, iters=10, warmup=2):.3f} ms")
    cs.log(f"[detect parts] train step batch {n} at {cs.SIZE}^2, bf16 autocast; peak memory "
           f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def profile_kernels(dev):
    gen = torch.Generator().manual_seed(cs.SEED)

    # Their own generator: the draws below, and with them the router's
    # weights and where it routes the batch, stay as they were.
    own = torch.Generator().manual_seed(cs.SEED + 2)
    low = cs.perturb_bn_(cs.init_params_(cs.LightweightDehazeModel(32, 3), own), own).eval()
    chain = cs.fold_lightweight(low.to(dev), torch.bfloat16)
    x = torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=own).to(dev)
    high = cs.cast_for_serving(
        cs.perturb_bn_(cs.init_params_(cs.HighIntensityDehazeModel(96), own), own),
        torch.bfloat16).to(dev)
    with torch.inference_mode():
        profiled("K1 lightweight_chain", lambda: cs.lightweight_chain(x, chain))
        profiled("canonical high branch", lambda: high(x))
    del x, high
    ys = [torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=own).to(dev) for _ in range(3)]
    wts = torch.softmax(torch.randn(cs.BATCH, 3, generator=own), dim=1).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        imgs = [y.to(dtype) for y in ys]
        with torch.inference_mode():
            profiled(f"K5 blend3 {str(dtype)[6:]}", lambda: cs.blend3(wts, *imgs))
    del ys, imgs

    for name, cls, c, fold_fn, tail in (
            ("K3 medium_tail_chain", cs.MediumIntensityDehazeModel, 64,
             cs.fold_medium_tail, cs.medium_tail_chain),
            ("K4 high_tail_chain", cs.HighIntensityDehazeModel, 96,
             cs.fold_high_tail, cs.high_tail_chain)):
        model = cs.perturb_bn_(cs.init_params_(cls(c), gen), gen).eval().to(dev)
        d1 = torch.relu(torch.randn(cs.BATCH, cs.SIZE // 2, cs.SIZE // 2, 4 * c,
                                    generator=gen)).to(dev).bfloat16()
        f0 = torch.relu(torch.randn(cs.BATCH, cs.SIZE, cs.SIZE, c,
                                    generator=gen)).to(dev).bfloat16()
        x = torch.rand(cs.BATCH, cs.SIZE, cs.SIZE, 3, generator=gen).to(dev)
        weights = fold_fn(model, torch.bfloat16)
        with torch.inference_mode():
            profiled(name, lambda: tail(d1, f0, x, weights))
        del d1, f0, x

    for name in ("high e2b", "medium e1"):
        c, down, kinds = cs.RES_SEGMENTS[name]
        blocks = torch.nn.Sequential(*[cs.ResidualBlock(c) if k == "res"
                                       else cs.AttentionBlock(c) for k in kinds])
        blocks = cs.perturb_bn_(cs.init_params_(blocks, gen), gen).eval().to(dev)
        side = cs.SIZE // down
        x = torch.relu(torch.randn(cs.BATCH, side, side, c, generator=gen)).to(dev).bfloat16()
        weights = cs.fold_res_attn_chain(blocks, torch.bfloat16)
        with torch.inference_mode():
            profiled(f"K6 res_attn_chain, {name}", lambda: cs.res_attn_chain(x, weights))
        del x

    router = cs.make_router(load_config(), gen)
    x = np.random.default_rng(cs.SEED).random((cs.BATCH, cs.SIZE, cs.SIZE, 3),
                                              dtype=np.float32)
    cfg = load_config()
    with tempfile.TemporaryDirectory() as tmp:
        (tail_cache, res_cache), _, _ = cs.tune_then_force(
            router, cfg, dev, tmp, "bf16", (cs.TAIL_FORCED, cs.RES_FORCED))
        for tag, kwargs in (("default", {}),
                            ("tail_chain", dict(autotune=True, autotune_cache=tail_cache)),
                            ("res_chain", dict(autotune=True, autotune_cache=res_cache))):
            d = AdaptiveDehazer(copy.deepcopy(router), None, cfg, device=dev, **kwargs)
            _, intensity = d.route_hard(x)
            cs.log(f"[profile {tag}] route_hard intensities "
                   f"{np.bincount(intensity, minlength=3).tolist()}")
            profiled(f"{tag} route_hard", lambda: d.route_hard(x))
            profiled(f"{tag} soft", lambda: d(x))
            del d
            torch.cuda.empty_cache()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(int(sys.argv[2]), sys.argv[3])
    else:
        main()
