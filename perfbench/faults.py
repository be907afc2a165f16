"""Faults planted in the program's timed path, for the checks that the
comparison catches them: `perfbench/tests/` and `calibrate.py --fault`.

Each is a context manager that patches the program (never the benchmark)
and puts it back on exit:

- serving: `unchanged` (the engine returns its input), `half` (only the
  first half of each batch is served, the rest left zero), `altered` (one
  image's output moved by 0.25 where it is produced);
- training: `unchanged` (Adam's step does nothing), `half` (each step sees
  the first half of its batch, the mean over the rest). A train step
  produces no answer of its own to alter: its product is the state.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def serve(kind: str):
    from adam_dehaze_tpu_torch.models.routing import BinnedAdaptiveEngine
    dispatch = BinnedAdaptiveEngine.dispatch

    def broken(self, x, intensity):
        if kind == "unchanged":
            return x.float().clone()
        if kind == "half":
            n = x.shape[0] // 2
            out = x.new_zeros(x.shape, dtype=x.float().dtype)
            out[:n] = dispatch(self, x[:n], intensity[:n])
            return out
        out = dispatch(self, x, intensity)
        out[0] += 0.25
        return out
    return _patched(BinnedAdaptiveEngine, "dispatch", broken)


def train(kind: str):
    from adam_dehaze_tpu_torch.training import train_joint
    make = train_joint.make_train_step

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(state, batch, generator=None):
            if kind == "unchanged":
                with _patched(state.optimizer, "step", lambda *a, **k: None):
                    return step(state, batch, generator)
            n = batch["hazy"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, generator)
        return broken
    return _patched(train_joint, "make_train_step", make_broken)


PLANTS = {"serve_closed_loop": serve, "train_step": train}
KINDS = {"serve_closed_loop": ("unchanged", "half", "altered"),
         "train_step": ("unchanged", "half")}
