"""Operation probes: ten mini-kernels, each beside a plain PyTorch expression
of the same function.

    python -m adam_dehaze_tpu_torch.tools.probe_ops

Counterpart of tools/probe_mosaic_ops.py, which bisected a compiler crash of
the TPU's high tail chain by compiling one mini-kernel per operation
pattern. The port's tail and res chains met no such crash on the H100; the
probes stay as the smallest programs that exercise what the attention
passes of K4 and K6 are made of (a reduction over all rows of an image, a
1-row matrix product, per-group selects, a partial store into scratch), on
the original's shapes: x (1088, 384) bf16, w (384, 128) and wrep (128, 384)
f32, f32 results. `run_probes` prints `PASS name` or `FAIL name` per
pattern, as the original does, and returns the failures.

`probe_op(name, x, w, wrep)` runs one pattern: a CPU tensor takes the plain
expression, a CUDA tensor launches the kernel (csrc/probe_ops.cu) or raises.
Nine patterns reduce x's columns on a grid of row bands whose last block
runs the pattern's epilogue; their partials and the ticket that names the
last block live in a workspace allocated once per stream (`_workspace`).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import torch

from adam_dehaze_tpu_torch.ops.kernels import _build

FLAT = 1088   # rows: stands in for a flattened image
C4 = 384
C = 96
ROWS = 8
# Kernel against plain expression: both sum 1088 or 384 f32 terms, in
# another order; the error stays under this share of the result's largest
# magnitude.
PROBE_RTOL = 1e-4


def _rows(v: torch.Tensor) -> torch.Tensor:
    return v.expand(ROWS, -1).contiguous()


def _col_sum(x):
    return x.float().sum(dim=0, keepdim=True)


def _col_max(x):
    return x.float().amax(dim=0, keepdim=True)


def _ref_a(x, w, wrep):
    return _rows(_col_sum(x) + _col_max(x))


def _ref_b(x, w, wrep):
    return _rows(_col_sum(x) @ w)


def _ref_c(x, w, wrep):
    m96 = _col_max(x).reshape(4, C).amax(dim=0, keepdim=True)
    return _rows(torch.nn.functional.pad(m96, (0, 128 - C)))


def _ref_d(x, w, wrep):
    return _rows(_col_max(x)[:, :C].repeat(1, 4))


def _ref_e(x, w, wrep):
    return _rows(_col_max(x)[:, :128] @ wrep)


def _ref_f(x, w, wrep):
    return x.float()[:ROWS] * _col_sum(x)


def _ref_g(x, w, wrep):
    return x.float()[:ROWS, :4].repeat_interleave(C, dim=1)


def _ref_h(x, w, wrep):
    m96 = _col_max(x).reshape(4, C).amax(dim=0, keepdim=True).clamp_min(0.0)
    return _rows(torch.nn.functional.pad(m96, (0, 128 - C)))


def _ref_i(x, w, wrep):
    return _rows(_col_sum(x)[:, :128])


# name -> (index in the C library, plain expression, columns of the result).
PROBES: Dict[str, Tuple[int, Callable, int]] = {
    "A_row_reduce_384": (0, _ref_a, C4),
    "B_dot_1row_K384": (1, _ref_b, 128),
    "B8_dot_8row_K384": (2, _ref_b, 128),
    "C_lane_slice_96": (3, _ref_c, 128),
    "D_lane_concat_96x4": (4, _ref_d, C4),
    "E_dot_1row_N384": (5, _ref_e, C4),
    "F_bcast_mul_384": (6, _ref_f, C4),
    "G_lane1_slice_select": (7, _ref_g, C4),
    "H_iota_selection_matmul": (8, _ref_h, 128),
    "I_scratch_partial_lanes": (9, _ref_i, 128),
}


def probe_reference(name: str, x, w, wrep) -> torch.Tensor:
    """The plain PyTorch expression of pattern `name`: (8, columns) f32."""
    return PROBES[name][1](x, w, wrep)


def probe_op(name: str, x: torch.Tensor, w: torch.Tensor, wrep: torch.Tensor,
             out: torch.Tensor = None) -> torch.Tensor:
    """Pattern `name` on x (rows, 384) bf16, w (384, 128) f32 and wrep
    (128, 384) f32 -> (8, columns) f32, written into `out` where given. A
    CPU tensor takes the plain expression; a CUDA tensor launches the
    pattern's kernel or raises."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}: one of {sorted(PROBES)}")
    index, _, cols = PROBES[name]
    if x.device.type == "cpu":
        got = probe_reference(name, x, w, wrep)
        return got if out is None else out.copy_(got)
    if out is None:
        out = torch.empty((ROWS, cols), dtype=torch.float32, device=x.device)
    # Messages are built only on a refusal: the checks run every launch.
    _build.require_cuda_inputs("probe_op", x, w, wrep, out)
    if not (x.dim() == 2 and x.shape[1] == C4 and x.shape[0] >= ROWS
            and x.dtype == torch.bfloat16 and x.is_contiguous() and x.data_ptr() % 16 == 0):
        raise ValueError(f"probe_op: x must be contiguous 16-byte aligned (rows >= {ROWS}, "
                         f"{C4}) bfloat16, got {tuple(x.shape)} {x.dtype}")
    for t, shape in ((w, (C4, 128)), (wrep, (128, C4)), (out, (ROWS, cols))):
        if not (t.shape == shape and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError(f"probe_op: weights and out must be contiguous float32 {shape}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    stream = _build.stream_ptr(x.device)
    err = _build.library().probe_op(index, x.data_ptr(), w.data_ptr(), wrep.data_ptr(),
                                    out.data_ptr(), _workspace(x.device, stream), x.shape[0],
                                    stream)
    if err:
        _build.check(err, f"probe_op[{name}]")
    probe_op.launches += 1
    return out


probe_op.launches = 0

@functools.lru_cache(maxsize=1)
def _workspace_bytes() -> int:
    return _build.library().probe_workspace_bytes()


def _workspace(device: torch.device, stream: int) -> int:
    """The address of `probe_op`'s zeroed workspace on `stream` (its bands'
    partials and the ticket counter, zero between launches;
    `_build.stream_scratch`)."""
    return _build.stream_scratch("probe_op", device, stream, _workspace_bytes())


def empty_launch(device) -> None:
    """One launch of an empty kernel on `device`'s current stream: the
    card's launch floor, to read beside the probes' times (not counted)."""
    _build.check(_build.library().probe_empty(_build.stream_ptr(torch.device(device))),
                 "probe_empty")


def probe_inputs(device, seed: int = 0):
    """The probes' seeded inputs on `device`: x, w, wrep."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(FLAT, C4, generator=gen).bfloat16()
    w = torch.randn(C4, 128, generator=gen)
    wrep = torch.randn(128, C4, generator=gen)
    return x.to(device), w.to(device), wrep.to(device)


def run_probes(device="cuda", seed: int = 0, log=print) -> List[str]:
    """Every pattern on `device` against its plain expression on the same
    tensors; prints one line per pattern and returns the names that failed
    (a pattern that raises counts as failed)."""
    x, w, wrep = probe_inputs(device, seed)
    failed = []
    for name in PROBES:
        try:
            got = probe_op(name, x, w, wrep)
            want = probe_reference(name, x, w, wrep)
            err = float((got - want).abs().max())
            scale = max(float(want.abs().max()), 1.0)
            ok = tuple(got.shape) == tuple(want.shape) and err <= PROBE_RTOL * scale
            detail = f"sum={float(got.sum()):.4f} max abs err {err:.3e} of {scale:.1f}"
        except Exception as e:  # noqa: BLE001  a probe reports, the caller decides
            ok, detail = False, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        log(f"{'PASS' if ok else 'FAIL'} {name}  {detail}")
        if not ok:
            failed.append(name)
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_ops: torch.cuda.is_available() is false; the probes "
                         "run only on a CUDA card")
    return 1 if run_probes("cuda") else 0


if __name__ == "__main__":
    raise SystemExit(main())
