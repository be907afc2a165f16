"""Build and load the port's CUDA kernels.

Every `*.cu` file under `adam_dehaze_tpu_torch/csrc/` is compiled by `nvcc`
for Hopper (`sm_90a`), one `nvcc` per source and all started together, and
the objects are linked into ONE shared library with a plain C interface,
loaded with `ctypes`. The library goes to `build/kernels/<hash>/` at the
repository root (listed in .gitignore), keyed by a hash of the sources, the
headers they share (`*.cuh`) and the flags, so a rebuilt source never loads
a stale binary and an unchanged one builds once per checkout. A plain C interface keeps the build to a few
seconds: no PyTorch header is compiled.

Each C entry point takes its pointers and the CUDA stream as `void*`, enqueues
its kernel on that stream (PyTorch's current stream) and returns
`cudaGetLastError()`; `check()` raises on anything but 0. A failed build
raises with the compiler's own message. Nothing here falls back to plain
PyTorch.

A precompiled serving bundle (serving_export.py) carries a copy of the
library; `use_prebuilt` points `library()` at it when its source hash is
this checkout's, and then no `nvcc` runs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]          # adam_dehaze_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
LIB_NAME = "libadam_dehaze_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures of every entry point: (argtypes); restype is int, a
# cudaError_t unless noted.
_SIGNATURES = {
    # x, g, mean_p, max_p, w, out, B, H, W, C, is_bf16, stream
    "cbam_gate": (P, P, P, P, P, P, I, I, I, I, I, P),
    # x, w, shift, residual, out, N, H, W, Cin, Cout, relu, is_bf16, stream
    "conv3x3_bn_act": (P, P, P, P, P, I, I, I, I, I, I, I, P),
    # h, w, shift, x_in, out, alpha, N, H, W, Cin, Cout, is_bf16, stream
    "conv3x3_sigmoid_blend": (P, P, P, P, P, F, I, I, I, I, I, I, P),
    # Cin; returns the FMA body's shared-memory bytes per block, or -1
    "conv3x3_smem_bytes": (I,),
    # C; returns the fused bf16 body's tile side, or 0
    "lightweight_fused_tile": (I,),
    # C, kind, T; returns shared-memory bytes per block
    "lightweight_group_smem_bytes": (I, I, I),
    # kind, x, in, w, shift, out, alpha, N, H, W, C, stream
    "lightweight_group": (I, P, P, P, P, P, F, I, I, I, I, P),
    # x, mean_p, max_p, w, out, B, H, W, C, is_bf16, stream
    "spatial_gate": (P, P, P, P, P, I, I, I, I, I, P),
    # in0, w0, packed0, c0, in1, w1, packed1, c1, shift, residual, out, N, H, W,
    # Cout, ksize, relu, is_bf16, stream
    "conv_tile": (P, P, P, I, P, P, P, I, P, P, P, I, I, I, I, I, I, I, P),
    # c0, c1, Cout, ksize, is_bf16; returns shared-memory bytes per block
    "conv_tile_smem_bytes": (I, I, I, I, I),
    # Cout, ksize; returns the wgmma body's blocks an SM, or -cudaError_t
    "conv_tile_blocks_per_sm": (I, I),
    # C; returns K3's head group's tile side, or 0
    "tail_head_tile": (I,),
    # x, h1, w, shift, out, N, H, W, C, stream
    "tail_head_group": (P, P, P, P, P, I, I, I, I, P),
    # h, w, cin, bias, image, guidance, gc, guidance_w, guidance_b, out_f32, N, H, W,
    # is_bf16, stream
    "tail_conv_final": (P, P, I, P, P, P, I, P, F, P, I, I, I, I, P),
    # x, partial, N, P, C, slabs, is_bf16, stream
    "tail_channel_stats": (P, P, I, I, I, I, I, P),
    # partial, w0, w1, gate, N, slabs, P, C, hidden, stream
    "tail_channel_gate": (P, P, P, P, I, I, I, I, I, P),
    # x, gate, z, mean_p, max_p, N, H, W, C, is_bf16, stream
    "tail_gated_stats": (P, P, P, P, P, I, I, I, I, I, P),
    # x, g (or null), mean_p, max_p, B, H, W, C, is_bf16, stream
    "cbam_gated_maps": (P, P, P, P, I, I, I, I, I, P),
    # which, x, w, wrep, out, work, flat, stream
    "probe_op": (I, P, P, P, P, P, I, P),
    # returns the bytes of probe_op's workspace
    "probe_workspace_bytes": (),
    # stream: one launch of an empty kernel
    "probe_empty": (P,),
    # x, scratch, q, scale, N, HW, C, cin_pad, is_bf16, stream
    "int8_quantize": (P, P, P, P, I, I, I, I, I, P),
    # x, partial, amax, N, HW, C, is_bf16, stream
    "int8_absmax": (P, P, P, I, I, I, I, P),
    # x, amax, q, scale, N, HW, C, cin_pad, is_bf16, stream
    "int8_quantize_at": (P, P, P, P, I, I, I, I, I, P),
    # q, w, sx, sw, bias, bn, relu, out, N, H, W, cin_pad, Ho, Wo, cout, cout_pad, k_pad,
    # kh, kw, stride, pad, body, n_chunk, is_bf16, stream
    "int8_conv": (P, P, P, P, P, P, I, P, I, I, I, I, I, I, I, I, I, I, I, I, I, I, I, I, P),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of adam_dehaze_tpu_torch "
                       "need the CUDA toolkit to build")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile the library if this source hash has not been built yet.

    Returns (library path, build seconds, compiler log). The build seconds
    are 0.0 when an earlier build of the same sources was found."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    # One nvcc per source, all started together; then one link.
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = out_dir / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = None
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, out)
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    if failed is None:
        cmd = [nvcc, "-shared", "-arch=sm_90a", "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (proc.returncode, cmd, log[-1])
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed is not None:
        code, cmd, out = failed
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}")
    text = "".join(log)
    log_path.write_text(text)
    os.replace(tmp, lib)
    return lib, seconds, text


# A built library of these sources to load in place of a build.
_prebuilt = None


def use_prebuilt(path, source_hash: str) -> None:
    """Have `library()` load the library at `path` (a bundle's copy) in
    place of a build. Raises ValueError unless `source_hash` is this
    checkout's: a library of other sources is never loaded. No effect once
    the library is loaded: it was built from the same sources."""
    global _prebuilt
    if source_hash != _source_hash():
        raise ValueError(f"kernel library {path} was built from sources {source_hash}, "
                         f"this checkout's are {_source_hash()}")
    _prebuilt = Path(path)


def library_path() -> Path:
    """The library `library()` loads: the prebuilt one of `use_prebuilt`,
    else this checkout's build (built here if there is none yet)."""
    return _prebuilt if _prebuilt is not None else build()[0]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, one per process (`library_path`)."""
    path = library_path()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = library().cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err} ({text})")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on `device`, read
    without building a Stream object (a few µs a launch otherwise)."""
    import torch
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


# (kernel name, device index, stream) -> a zeroed uint8 scratch that its
# kernel leaves zero at the end of a launch (a last block's partials and
# ticket counters). One a stream, so that launches on two streams never
# share one; dropping an entry (a kernel killed midway) gives a fresh one.
_SCRATCH = {}


def stream_scratch(name: str, device, stream: int, nbytes: int) -> int:
    """The address of kernel `name`'s zeroed scratch of at least `nbytes`
    on `stream`: allocated at its first launch there, again only when a
    launch needs more, never cleared between launches."""
    import torch
    key = (name, device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.zeros((nbytes,), dtype=torch.uint8, device=device)
        _SCRATCH[key] = buf
    return buf.data_ptr()


def require(cond: bool, name: str, what: str) -> None:
    """Raise ValueError for an input a kernel does not take."""
    if not cond:
        raise ValueError(f"{name}: {what}")


def require_cuda_inputs(name: str, *tensors) -> None:
    """Every tensor on one CUDA device, none needing a gradient. K1, K3,
    K4 and K6 are forward-only: they take BN-folded eval weights, and their
    JAX counterparts have no VJP either. K2, K2' and K5 are differentiable
    through their autograd Functions, which check their inputs here inside
    the Function's forward, where no gradient is recorded."""
    import torch
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:     # messages built only on a refusal: wrappers check every launch
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA or CPU tensors, got {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is a forward-only kernel (no autograd Function); "
                           "call it under torch.no_grad() or torch.inference_mode()")
