"""The port's operation probes (adam_dehaze_tpu_torch/tools/probe_ops.py)
against the JAX tool's own Pallas kernels (tools/probe_mosaic_ops.py), on
the CPU.

The tool's `main()` runs once per module, as it stands, with two things
patched for the run: `pl.pallas_call` takes `interpret=True`, so that its
ten kernels run on the CPU, and `jax.jit` records each Pallas call's inputs
and result. The recorded x (1088, 384) bf16, w (384, 128) and wrep (128,
384) f32 then go through `probe_ops.probe_op` on the CPU (the plain
expressions), in PROBES order, and each pattern is held against the
kernel's result at PROBE_RTOL of the result's largest magnitude (at least
1): both sides sum 1088 or 384 f32 terms, in another order.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from adam_dehaze_tpu_torch.tools import probe_ops
from torch_port_util import one_torch_thread  # noqa: F401  (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOOL = Path(__file__).resolve().parents[1] / "tools" / "probe_mosaic_ops.py"


@pytest.fixture(scope="module")
def pallas_runs():
    """[(inputs, result)] of the tool's ten Pallas calls, in its order, as
    numpy arrays."""
    spec = importlib.util.spec_from_file_location("probe_mosaic_ops", TOOL)
    tool = importlib.util.module_from_spec(spec)
    kernels, runs = set(), []
    pallas_call, jit = pl.pallas_call, jax.jit

    def interpreted(*args, **kwargs):
        fn = pallas_call(*args, interpret=True, **kwargs)
        kernels.add(fn)
        return fn

    def recording_jit(fn, *args, **kwargs):
        compiled = jit(fn, *args, **kwargs)
        if fn not in kernels:
            return compiled

        @functools.wraps(compiled)
        def call(*inputs):
            out = compiled(*inputs)
            runs.append(([np.array(a) for a in inputs], np.array(out)))
            return out
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpreted)
        mp.setattr(jax, "jit", recording_jit)
        mp.syspath_prepend(str(TOOL.parents[1]))
        spec.loader.exec_module(tool)
        tool.main()
    return runs


def test_the_tool_ran_ten_kernels(pallas_runs):
    assert len(pallas_runs) == len(probe_ops.PROBES) == 10
    for inputs, out in pallas_runs:
        assert inputs[0].shape == (probe_ops.FLAT, probe_ops.C4)
        assert out.dtype == np.float32 and np.isfinite(out).all()


@pytest.mark.parametrize("index,name", list(enumerate(probe_ops.PROBES)))
def test_probe_matches_the_pallas_kernel(pallas_runs, index, name):
    x = torch.from_numpy(pallas_runs[0][0][0].astype(np.float32)).bfloat16()
    w = torch.from_numpy(pallas_runs[1][0][1])                  # B's right side
    wrep = torch.from_numpy(pallas_runs[5][0][1])               # E's right side
    assert tuple(w.shape) == (probe_ops.C4, 128) and tuple(wrep.shape) == (128, probe_ops.C4)
    inputs, want = pallas_runs[index]
    assert np.array_equal(inputs[0].astype(np.float32), x.float().numpy())
    before = probe_ops.probe_op.launches
    got = probe_ops.probe_op(name, x, w, wrep)
    assert probe_ops.probe_op.launches == before                # the CPU launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=probe_ops.PROBE_RTOL * max(1.0, float(np.abs(want).max())))
