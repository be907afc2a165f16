"""Steady-state joint-training throughput on the card.

    python -m adam_dehaze_tpu_torch.tools.measure_train_throughput \\
        [--batch 16] [--size 256] [--steps 20] [--mode soft|hard] \\
        [--remat none|full|fullres] [--device cpu | --cpu]

The counterpart of tools/measure_train_throughput.py, with its flags. It
builds the joint step as training/train_joint.py does: the default config's
router seeded, its classifier frozen, Adam over the rest, the JointLoss's
seeded loss nets, augmentation on, under autocast in bf16 on the card (fp32
on the CPU). `--mode soft` times `make_train_step` (the router's soft
forward, all three branches and the K5 blend); `--mode hard` one round of
`make_hard_branch_step` on each branch (one pure-class batch a branch).
`--remat` is `cuda.remat` (training/remat.py:MODES): none is False, full is
True (the whole forward checkpointed), fullres the branches' full-resolution
blocks checkpointed by their factories.

Three warm steps (or rounds), then `--steps` timed back to back on the
host clock, the clock stopped after the card has drained the last one. One
more step is counted by FlopCounterMode (convolutions and matmuls, forward
and backward; not the optimizer's elementwise work, which XLA's cost
analysis in the JAX tool counts). Prints one JSON line with the JAX tool's
keys, `device` the card's name, and `nvidia_smi` the card's name and power
limit as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
gives them (null on the CPU). The MFU is against the card's published bf16
peak (utils/profiling.py:device_flops_estimate), null on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER

REMAT = {"none": False, "full": True, "fullres": "fullres"}


def nvidia_smi(device: torch.device):
    """`name, power.limit` of the card as nvidia-smi reports them; None on
    the CPU."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def _drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counted_flops(run) -> float:
    """FLOPs of one call of `run()`, backward included."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return float(counter.get_total_flops())


def _timed(run, steps: int, device: torch.device) -> float:
    """Seconds a call of `run()`: three warm calls, then `steps` back to
    back, the clock stopped once the card has drained them."""
    for _ in range(3):
        run()
    _drain(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    _drain(device)
    return (time.perf_counter() - t0) / steps


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--mode", default="soft", choices=("soft", "hard"),
                   help="soft: the joint step through all three branches; hard: the hard "
                        "fine-tune phase's per-branch steps, one batch a branch a round")
    p.add_argument("--remat", default="none", choices=tuple(REMAT),
                   help="cuda.remat: none | full (checkpoint the whole forward) | fullres "
                        "(checkpoint the full-resolution blocks)")
    args = p.parse_args(argv)

    from adam_dehaze_tpu_torch.config import compute_dtype, load_config
    from adam_dehaze_tpu_torch.losses.dehazing import get_joint_loss
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.routing import create_router
    from adam_dehaze_tpu_torch.nn.blocks import init_params_
    from adam_dehaze_tpu_torch.training.remat import remat_mode
    from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
    from adam_dehaze_tpu_torch.training.train_joint import (
        _loss_params,
        make_hard_branch_step,
        make_train_step,
    )
    from adam_dehaze_tpu_torch.utils.profiling import device_flops_estimate

    device = torch.device("cpu" if args.cpu else args.device)
    on_card = device.type == "cuda"
    config = load_config()
    config["cuda"]["compute_dtype"] = "bfloat16" if on_card else "float32"
    config["cuda"]["remat"] = REMAT[args.remat]     # fullres: built into the branches
    config["dataset"].update(img_size=args.size, batch_size=args.batch)
    dtype = compute_dtype(config)
    lr = config["joint_training"]["learning_rate"]

    router = create_router(create_branch_models(config), create_classifier(config), config)
    init_params_(router, torch.Generator().manual_seed(0))
    router.classifier.requires_grad_(False)
    router.to(device).train()
    joint_loss = get_joint_loss(config)
    loss_params = _loss_params(joint_loss, device)
    n, s = args.batch, args.size
    host = torch.Generator().manual_seed(1)
    batch = {name: torch.rand(n, s, s, 3, generator=host).to(device)
             for name in ("hazy", "clear", "dehazed")}
    batch["intensity"] = torch.zeros(n, dtype=torch.long, device=device)
    gen = torch.Generator(device).manual_seed(10)
    last = {}

    if args.mode == "hard":
        step = make_hard_branch_step(joint_loss, loss_params, True, dtype)
        states = {lvl: TrainState(router.models[lvl],
                                  make_optimizer(router.models[lvl].parameters(), lr))
                  for lvl in INTENSITY_ORDER}

        def run():
            for lvl in INTENSITY_ORDER:
                last.update(step(states[lvl], batch, gen))
    else:
        step = make_train_step(joint_loss, loss_params, True, remat=remat_mode(config),
                               dtype=dtype)
        state = TrainState(router, make_optimizer(
            [q for q in router.parameters() if q.requires_grad], lr))

        def run():
            last.update(step(state, batch, gen))

    dt = _timed(run, args.steps, device)
    if not math.isfinite(float(last["total"])):
        raise RuntimeError(f"measure_train_throughput: the {args.mode} step's loss is "
                           f"{float(last['total'])}")
    flops = _counted_flops(run)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    if args.mode == "hard":
        line = {"metric": "joint_train_hard_imgs_per_sec_per_chip",
                "value": round(3 * n / dt, 1), "sec_per_round": round(dt, 4),
                "batch": n, "size": s, "device": kind,
                "gflops_per_image": round(flops / (3 * n) / 1e9, 1),
                "tflops_per_sec": round(flops / dt / 1e12, 1)}
    else:
        peak = device_flops_estimate(device) if on_card else None
        line = {"metric": "joint_train_imgs_per_sec_per_chip",
                "value": round(n / dt, 1), "sec_per_step": round(dt, 4),
                "batch": n, "size": s, "remat": args.remat, "device": kind,
                "train_gflops_per_step": round(flops / 1e9, 1),
                "train_mfu_pct": round(flops / dt / peak * 100, 1) if peak else None,
                "assumed_peak_tflops": peak / 1e12 if peak else None}
    line["nvidia_smi"] = nvidia_smi(device)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
