"""Precompiled serving bundles of the port: export the serving programs of
an AdaptiveDehazer, and serve them later as CUDA graphs.

Counterpart of adam_dehaze_tpu/serving_export.py, with its names:

    d = AdaptiveDehazer.from_experiment("experiments/x")
    d.export_precompiled("experiments/x/precompiled")

    d2 = AdaptiveDehazer.from_experiment("experiments/x", precompiled="auto")
    out, cls = d2.route_hard(images)      # the bucket steps replay graphs

What a bundle is here. The JAX package serializes XLA executables compiled
ahead of time. Eager PyTorch has no program to compile but its kernel
library (`ops/kernels/_build.py`: nvcc), and a CUDA graph cannot be
written to disk. So a bundle is its manifest, MANIFEST.json, and, when it
was exported on the card, a copy of the kernel library:

- the manifest names each program by the engine attribute it stands for
  (`classify`, `logits`, `step{c}`, `branch{c}`, `device{chunk}_{spill}`)
  and the signature of its unbound inputs (shapes and dtypes);
- a program binds one module (`n_bound=1`: the serving classifier or
  branch). Its `bound_sig` hashes that module's tensors (names, shapes,
  dtypes, devices), so a bundle never attaches to other weights' layout.
  Weights are not in the bundle: the experiment's checkpoint holds them;
- when the library's source hash is this checkout's, the loader loads the
  bundle's copy (`_build.use_prebuilt`) and runs no nvcc.

A loaded program, on the card, is a `torch.cuda.CUDAGraph` captured at
attach (`GraphProgram`): warmed up on a side stream first (lazy folds,
cuDNN's first choice and the kernels' shared-memory attributes happen
outside the capture), captured at static inputs into one memory pool that
all the bundle's graphs share, and replayed by copying the caller's tensors
in and the static outputs out into fresh tensors. The graph reads the bound
module's tensors where they lie: nothing may reallocate a parameter after
attach. On the CPU a loaded program is the eager callable itself, so the
dispatch logic runs there too.

As in the JAX package: a bundle is pinned to its runtime (the platform,
device name and compute capability, the torch and CUDA versions, the
kernels' source hash); `bundle_compatible` names the first field that
differs, and the dehazer then warns and serves through its eager modules,
which launch the same kernels. Input signatures outside the exported set
run the eager program (`PrecompiledDispatch`: `hits`, `misses`).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from adam_dehaze_tpu_torch.models.routing import DeviceBinnedInfer, bucket_step
from adam_dehaze_tpu_torch.ops.kernels import _build, add_launches, captured_launches

BUNDLE_VERSION = 1
MANIFEST = "MANIFEST.json"
# Tells the port's manifests from the JAX package's.
FORMAT = "adam_dehaze_tpu_torch"
# The fields a bundle must share with its runtime, in the order checked.
PINNED = ("format", "bundle_version", "platform", "device_name", "compute_capability",
          "torch_version", "cuda_version", "source_hash")


def _device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _env_meta(device=None) -> Dict[str, object]:
    """What a bundle is pinned to, for programs on `device` (the card when
    there is one, by default)."""
    device = _device(device)
    cuda = device.type == "cuda"
    cap = torch.cuda.get_device_capability(device) if cuda else None
    return {"format": FORMAT, "bundle_version": BUNDLE_VERSION,
            "platform": "cuda" if cuda else "cpu",
            "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
            "compute_capability": f"{cap[0]}.{cap[1]}" if cap else None,
            "torch_version": torch.__version__, "cuda_version": torch.version.cuda,
            "source_hash": _build._source_hash()}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sig_of_args(args) -> str:
    """Filename-safe signature of the unbound arguments: each tensor's dtype
    and shape (a non-tensor by its repr)."""
    parts = [f"{_dtype_name(a.dtype)}{'x'.join(str(int(s)) for s in a.shape)}"
             if isinstance(a, torch.Tensor) else repr(a) for a in args]
    sig = "-".join(parts)
    if len(sig) > 96:
        return "h" + hashlib.sha1(sig.encode()).hexdigest()[:20]
    return sig


def _bound_tensors(obj, prefix: str = ""):
    """(name, tensor) of every tensor a bound object holds: a module's
    parameters and buffers, and the tensors in its other attributes (the
    kernels' folded weights are NamedTuples of tensors), recursively."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, nn.Module):
        yield from ((prefix + k, t) for k, t in obj.named_parameters(recurse=False))
        yield from ((prefix + k, t) for k, t in obj.named_buffers(recurse=False))
        for k, child in obj.named_children():
            yield from _bound_tensors(child, f"{prefix}{k}.")
        for k, v in vars(obj).items():
            if not k.startswith("_"):
                yield from _bound_tensors(v, f"{prefix}{k}.")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _bound_tensors(v, f"{prefix}{i}.")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _bound_tensors(v, f"{prefix}{k}.")


def _bound_sig(bind) -> str:
    """Hash of the bound objects' tensors: names, shapes, dtypes, devices."""
    h = hashlib.sha1()
    for i, obj in enumerate(bind):
        for name, t in _bound_tensors(obj, f"{i}."):
            h.update(f"{name}:{tuple(t.shape)}:{_dtype_name(t.dtype)}:{t.device};".encode())
    return h.hexdigest()[:20]


def export_program(args: Tuple, name: str, bundle_dir: str, n_bound: int = 0) -> str:
    """Record the program `name` at `args` in the bundle's manifest: the
    first `n_bound` args are the bound modules (their `bound_sig`), the rest
    the inputs the dispatch keys on (their signature, and their shapes and
    dtypes, at which attach captures the graph). Programs on the card also
    copy the kernel library into the bundle, once per source hash. Returns
    the program's key in the manifest; overwrites an export of the same
    (name, signature)."""
    os.makedirs(bundle_dir, exist_ok=True)
    unbound = args[n_bound:]
    device = next(a.device for a in unbound if isinstance(a, torch.Tensor))
    meta = _env_meta(device)
    sig = _sig_of_args(unbound)
    fname = f"{name}__{sig}"
    manifest = read_manifest(bundle_dir) or {}
    if meta["platform"] == "cuda":
        lib = os.path.join(bundle_dir, _build.LIB_NAME)
        if (not os.path.exists(lib)
                or manifest.get("meta", {}).get("source_hash") != meta["source_hash"]):
            shutil.copyfile(_build.library_path(), lib)
        manifest["library"] = _build.LIB_NAME
    manifest["meta"] = meta
    manifest.setdefault("programs", {})[fname] = {
        "name": name, "sig": sig, "n_bound": n_bound,
        "bound_sig": _bound_sig(args[:n_bound]) if n_bound else "",
        "args": [[list(a.shape), _dtype_name(a.dtype)] for a in unbound]}
    _write_manifest(bundle_dir, manifest)
    return fname


def _write_manifest(bundle_dir: str, manifest: Dict) -> None:
    path = os.path.join(bundle_dir, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def set_manifest_extra(bundle_dir: str, **extra) -> None:
    """Record caller metadata (the serving quant mode, autotune) in the
    manifest."""
    os.makedirs(bundle_dir, exist_ok=True)
    manifest = read_manifest(bundle_dir) or {"meta": _env_meta(), "programs": {}}
    manifest.setdefault("extra", {}).update(extra)
    _write_manifest(bundle_dir, manifest)


def read_manifest(bundle_dir: str) -> Optional[Dict]:
    path = os.path.join(bundle_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def bundle_compatible(bundle_dir: str, device=None) -> Tuple[bool, str]:
    """Does the bundle match this runtime for programs on `device`? (ok,
    reason); the reason names the first pinned field that differs."""
    manifest = read_manifest(bundle_dir)
    if manifest is None:
        return False, f"no {MANIFEST} under {bundle_dir}"
    meta, here = manifest.get("meta", {}), _env_meta(device)
    for k in PINNED:
        if meta.get(k) != here[k]:
            return False, f"{k}: bundle={meta.get(k)!r} runtime={here[k]!r}"
    return True, "ok"


class ProgramSpec(NamedTuple):
    """One exported program: its bind contract and the shapes and dtypes
    of its unbound inputs."""
    n_bound: int
    bound_sig: str
    args: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]


def load_bundle_programs(bundle_dir: str, device=None) -> Dict[str, Dict[str, ProgramSpec]]:
    """The programs of a bundle compatible with this runtime on `device`:
    {name: {sig: ProgramSpec}}; raises ValueError for an incompatible one.
    Points the kernel library at the bundle's copy where it has one (a
    bundle exported on the card)."""
    ok, reason = bundle_compatible(bundle_dir, device)
    if not ok:
        raise ValueError(f"incompatible precompiled bundle: {reason}")
    manifest = read_manifest(bundle_dir)
    lib = os.path.join(bundle_dir, manifest.get("library") or _build.LIB_NAME)
    if manifest.get("library") and os.path.exists(lib):
        _build.use_prebuilt(lib, manifest["meta"]["source_hash"])
    table: Dict[str, Dict[str, ProgramSpec]] = {}
    for rec in manifest.get("programs", {}).values():
        args = tuple((tuple(shape), getattr(torch, dtype)) for shape, dtype in rec["args"])
        table.setdefault(rec["name"], {})[rec["sig"]] = ProgramSpec(
            rec.get("n_bound", 0), rec.get("bound_sig", ""), args)
    return table


def _map_tensors(fn: Callable, out):
    if isinstance(out, torch.Tensor):
        return fn(out)
    return type(out)(_map_tensors(fn, o) for o in out)


class GraphPool:
    """What the graphs of one bundle share on `device`: one memory pool,
    and static inputs, one per (shape, dtype) (the k-th input of a graph
    with that spec takes the k-th such tensor). Every replay copies its
    arguments in first, so graphs replayed one after another on one stream
    may share them: the bucket steps of one batch size hold one copy of the
    batch, not one each."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle()
        self._inputs: Dict[tuple, torch.Tensor] = {}

    def inputs(self, specs):
        taken: Dict[tuple, int] = {}
        out = []
        for shape, dtype in specs:
            k = taken[(shape, dtype)] = taken.get((shape, dtype), -1) + 1
            key = (shape, dtype, k)
            if key not in self._inputs:
                self._inputs[key] = torch.zeros(shape, dtype=dtype, device=self.device)
            out.append(self._inputs[key])
        return out


class GraphProgram:
    """fn captured into a CUDA graph at the static inputs of the given
    (shape, dtype) specs, in `pool` (a GraphPool). A call copies its
    arguments into the static inputs, replays the graph on the current
    stream, adds the captured kernels' launches to their counters and
    returns clones of the static outputs (so a later replay never overwrites
    a result still in use)."""

    WARMUP = 2

    @torch.inference_mode()
    def __init__(self, fn: Callable, specs, pool: GraphPool):
        self._inputs = pool.inputs(specs)
        side = torch.cuda.Stream(pool.device)
        side.wait_stream(torch.cuda.current_stream(pool.device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                fn(*self._inputs)
        torch.cuda.current_stream(pool.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with captured_launches() as self._launches:
            with torch.cuda.graph(self._graph, pool=pool.handle):
                self._outputs = fn(*self._inputs)

    @torch.inference_mode()
    def __call__(self, *args):
        for static, a in zip(self._inputs, args, strict=True):
            static.copy_(a)
        self._graph.replay()
        add_launches(self._launches)
        return _map_tensors(torch.clone, self._outputs)


def _device_of(bind) -> torch.device:
    for obj in bind:
        for _, t in _bound_tensors(obj):
            return t.device
    return torch.device("cpu")


class PrecompiledDispatch:
    """Shape-dispatching callable over a program's loaded forms, with the
    eager program as the fallback.

    A call whose unbound signature was exported runs the loaded program (a
    graph replay on the card); any other runs `fallback`. `hits` and
    `misses` count them. A program whose `bound_sig` differs from `bind`'s
    is dropped with a warning. On the card each program is captured here
    from `fallback` (`GraphProgram`, in `pool`, a GraphPool made here when
    none is given); on the CPU it is `fallback` itself. A capture that fails is skipped with a warning, as
    the JAX loader skips a file it cannot load."""
    precompiled = True

    def __init__(self, fallback: Callable, programs: Dict[str, ProgramSpec],
                 bind: Tuple = (), device=None, pool=None):
        self._fallback = fallback
        device = torch.device(device) if device is not None else _device_of(bind)
        bind_sig = _bound_sig(bind) if bind else ""
        self._programs: Dict[str, Callable] = {}
        for sig, spec in programs.items():
            if spec.n_bound and (len(bind) != spec.n_bound or spec.bound_sig != bind_sig):
                warnings.warn(
                    f"precompiled program {sig}: bound-module signature mismatch (bundle "
                    f"{spec.bound_sig!r} vs runtime {bind_sig!r}): serving it eagerly")
                continue
            if device.type != "cuda":
                self._programs[sig] = fallback
                continue
            pool = pool or GraphPool(device)
            try:
                self._programs[sig] = GraphProgram(fallback, spec.args, pool)
            except RuntimeError as e:
                warnings.warn(f"skipping precompiled program {sig}: the capture failed: "
                              f"{type(e).__name__}: {e}")
        self.hits = 0
        self.misses = 0

    def __call__(self, *args):
        fn = self._programs.get(_sig_of_args(args))
        if fn is not None:
            self.hits += 1
            return fn(*args)
        self.misses += 1
        return self._fallback(*args)


def attach_engine(engine, table: Dict[str, Dict[str, ProgramSpec]],
                  binds: Optional[Dict[str, Tuple]] = None, device=None, pool=None,
                  shared: Optional[Dict[str, PrecompiledDispatch]] = None) -> int:
    """Swap an engine's programs for bundle-backed dispatchers.

    A BinnedAdaptiveEngine gets `classify`, `logits`, `step{c}` and
    `branch{c}`; a DeviceBinnedInfer `device{chunk}_{spill}` (its binning)
    and `branch{c}` (each chunk's branch call). binds: {program name: the
    bound modules}. `shared` holds the dispatchers already made, by program
    name, for engines that call the same branch modules (the `branch{c}`
    graphs serve run_queued and the device-binned chunks alike); new ones
    are added to it. Returns the number of programs attached."""
    binds = binds or {}
    shared = {} if shared is None else shared
    attached = 0

    def dispatch(name, fallback):
        nonlocal attached
        if name not in shared:
            shared[name] = PrecompiledDispatch(fallback, table[name], bind=binds.get(name, ()),
                                               device=device, pool=pool)
            attached += len(shared[name]._programs)
        return shared[name]

    if isinstance(engine, DeviceBinnedInfer):
        name = f"device{engine.chunk}_{int(engine.spill)}"
        if table.get(name):
            engine.bin_program = dispatch(name, engine.bin_arrays)
    else:
        for name, attr in (("classify", "_classify"), ("logits", "_logits")):
            if table.get(name):
                setattr(engine, attr, dispatch(name, getattr(engine, attr)))
        for cls, branch in enumerate(list(engine.branch_applies)):
            if table.get(f"step{cls}"):
                # The step over the eager branch: captured before the branch
                # itself is swapped below.
                engine._bucket_steps[cls] = dispatch(f"step{cls}", bucket_step(branch))
    for cls, branch in enumerate(list(engine.branch_applies)):
        if table.get(f"branch{cls}"):
            engine.branch_applies[cls] = dispatch(f"branch{cls}", branch)
    return attached
