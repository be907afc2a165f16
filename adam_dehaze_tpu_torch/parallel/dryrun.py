"""One sharded joint-training step of the port over a data x spatial x
model mesh of processes, then serving, expert parallelism and a checkpoint
under that mesh.

Counterpart of `dryrun_multichip` in the JAX package's __graft_entry__.py,
which jits the whole joint step over a virtual device mesh. Here each
process is one rank of the port's process group (parallel/multihost.py),
and `dryrun_multichip(n_devices, shape)` runs in every rank:

- the mesh: `shape` (data, spatial, model), or JAX's rule: 8 devices ->
  2 x 2 x 2, 4 -> 2 x 2 x 1, 2 -> 1 x 2 x 1, otherwise all data;
- the dryrun's config: a mobilenet_v2 classifier, branch widths 4 / 4 / 8
  with 1 block, fp32; images of 32 x spatial rows and columns (the JAX
  dryrun's 32^2 without a spatial axis): the port splits H into equal
  shards, and the classifier's 32-fold downsampling needs 32 rows a shard;
- one joint train step (augmentation on) through `shard_train_step`, the
  branches' 4c stages split over `model` (the step enters
  `channel_sharding`), with the launches of kernels K2 and K5 (their
  autograd Functions) on the card printed per rank;
- sharded binned inference, a shard of the batch a rank, gathered and held
  against the device-binned engine on the whole batch;
- the expert-parallel router against the soft router;
- a save and load of the state after the step, bit for bit.

    python -m adam_dehaze_tpu_torch.parallel.dryrun --devices N [--shape D S M]
        [--device cuda|cpu]

starts the N ranks on this host and waits for them: on the CPU a gloo
group; on the card NCCL when there is a card a rank, else a gloo group over
CUDA tensors with the ranks sharing the cards (NCCL refuses two ranks on
one device). Every rank prints a line per section; the command fails if a
rank fails.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.losses.dehazing import get_joint_loss
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    create_router,
    make_device_binned_infer,
    make_sharded_binned_infer,
)
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.kernels import launch_counters, reset_launch_counts
from adam_dehaze_tpu_torch.ops.serving_apply import (
    make_classifier_serving_apply,
    make_serving_apply,
)
from adam_dehaze_tpu_torch.parallel import multihost
from adam_dehaze_tpu_torch.parallel.collectives import all_gather
from adam_dehaze_tpu_torch.parallel.data_parallel import shard_train_step
from adam_dehaze_tpu_torch.parallel.expert_parallel import ExpertParallelRouter
from adam_dehaze_tpu_torch.parallel.mesh import AXES, Axis, make_mesh
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training.common import state_to_tree
from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
from adam_dehaze_tpu_torch.training.train_joint import make_train_step

# Rows an image takes per unit of the spatial axis (see the docstring).
SIZE_PER_SHARD = 32
# Sharded binned inference and the expert-parallel router against the
# one-program calls: the JAX dryrun's bounds.
SERVING_ATOL = 2e-5
EXPERT_ATOL = 5e-5
RANK_TIMEOUT_S = 600


def mesh_shape(n_devices: int) -> Tuple[int, int, int]:
    """(data, spatial, model) as the JAX dryrun splits `n_devices`."""
    if n_devices % 8 == 0:
        spatial, model = 2, 2
    elif n_devices % 2 == 0:
        spatial, model = 2, 1
    else:
        spatial, model = 1, 1
    return n_devices // (spatial * model), spatial, model


def dryrun_config():
    """The JAX dryrun's config: mobilenet_v2, branch widths 4 / 4 / 8 with
    1 block, fp32, nothing to graft."""
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    cfg["classifier"]["model"] = "mobilenet_v2"
    for level, channels in (("low", 4), ("medium", 4), ("high", 8)):
        cfg["dehazing"][level].update(channels=channels, blocks=1)
    return cfg


def _images(rng: np.random.Generator, n: int, size: int, device) -> torch.Tensor:
    return torch.from_numpy(rng.random((n, size, size, 3), dtype=np.float32)).to(device)


def _say(line: str) -> None:
    """One line to standard output in one write, so that the ranks' lines
    on a shared pipe do not interleave."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (line + "\n").encode())


def _launches() -> Dict[str, int]:
    counters = launch_counters()
    return {"cbam_gate": counters["cbam_gate"].launches,
            "blend3": counters["blend3"].launches}


def _shared_dir() -> str:
    """A fresh directory that every rank names alike (rank 0 makes it)."""
    path = [tempfile.mkdtemp(prefix="dryrun_") if multihost.process_index() == 0 else None]
    if multihost.process_count() > 1:
        dist.broadcast_object_list(path, src=0)
    return path[0]


def dryrun_multichip(n_devices: int, shape: Optional[Sequence[int]] = None,
                     device="cuda") -> Dict:
    """Run the dryrun as this process's rank of a group of `n_devices`
    processes (already joined: parallel/multihost.py:initialize; no group
    for one), on `device`. Prints a line per section and raises if a check
    fails; returns the step's metrics, its kernel launches, the errors of
    the serving and expert-parallel checks and the mesh's shape."""
    device = torch.device(device)
    if multihost.process_count() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                         f"{multihost.process_count()} processes")
    data, spatial, model = tuple(shape) if shape is not None else mesh_shape(n_devices)
    sizes = {"data": data, "spatial": spatial, "model": model}
    mesh = make_mesh(sizes, [device] * n_devices)
    rank = multihost.process_index()
    cfg = dryrun_config()
    size = SIZE_PER_SHARD * spatial

    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    init_params_(router, torch.Generator().manual_seed(0))
    router.classifier.requires_grad_(False)
    router.to(device)
    state = TrainState(router, make_optimizer([p for p in router.parameters() if p.requires_grad],
                                              cfg["joint_training"]["learning_rate"]))
    joint_loss = get_joint_loss(cfg)
    nets = joint_loss.init(torch.Generator().manual_seed(1), device)
    rng = np.random.default_rng(2)
    batch_size = 2 * data
    batch = {"hazy": _images(rng, batch_size, size, device),
             "clear": _images(rng, batch_size, size, device),
             "dehazed": _images(rng, batch_size, size, device),
             "intensity": torch.zeros(batch_size, dtype=torch.long, device=device)}
    step = shard_train_step(make_train_step(joint_loss, nets, augmentation=True), mesh, batch)
    reset_launch_counts()
    metrics = step(state, batch, torch.Generator(device).manual_seed(5))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = _launches()
    loss = float(metrics["total"])
    if not np.isfinite(loss):
        raise RuntimeError(f"the sharded joint step's loss is {loss}")
    _say(f"dryrun_multichip OK on mesh {sizes}, rank {rank}: loss={loss:.4f}; "
         f"launches in the step {launches}")

    # Serving under the mesh: a shard of the batch a rank, gathered, equals
    # the device-binned engine on the whole batch.
    router.eval()
    classifier = make_classifier_serving_apply(router.classifier, torch.float32)
    branches = [make_serving_apply(router.models[lvl], torch.float32) for lvl in INTENSITY_ORDER]
    xs = _images(np.random.default_rng(6), 4 * n_devices, size, device)
    mine = xs[4 * rank:4 * rank + 4]
    world = Axis("world", None, rank, n_devices)
    with torch.inference_mode():
        out, intensity, _ = make_sharded_binned_infer(classifier, branches, [device],
                                                      chunk=4)(mine)
        if n_devices > 1:
            out, intensity = (torch.cat(all_gather(t, world)) for t in (out, intensity))
        want, want_intensity, _ = make_device_binned_infer(classifier, branches, chunk=4)(xs)
    serving_err = float((out - want).abs().max())
    if not torch.equal(intensity, want_intensity) or serving_err > SERVING_ATOL:
        raise RuntimeError(f"sharded binned inference differs from the local engine: labels "
                           f"{intensity.tolist()} vs {want_intensity.tolist()}, max abs "
                           f"{serving_err:.3e}")
    _say(f"dryrun_multichip serving OK, rank {rank}: sharded binned infer matches the "
         f"local engine on batch {xs.shape[0]} (max |diff| {serving_err:.2e})")

    # Expert parallelism: the branches on their own device groups.
    ep = ExpertParallelRouter({lvl: router.models[lvl] for lvl in INTENSITY_ORDER}, classifier,
                              router.temperature, devices=[device])
    with torch.inference_mode():
        ep_out, _ = ep(xs)
        soft_out, _ = router(xs)
    expert_err = float((ep_out - soft_out).abs().max())
    if expert_err > EXPERT_ATOL:
        raise RuntimeError(f"the expert-parallel router differs from the soft router by "
                           f"{expert_err:.3e}")
    _say(f"dryrun_multichip expert-parallel OK, rank {rank}: 3 device groups match the soft "
         f"router (max |diff| {expert_err:.2e})")

    # The state after the step, saved once and read back by every rank.
    tree = state_to_tree(state)
    path = ckpt.save_checkpoint(_shared_dir(), "mesh_state", tree, {"loss": loss})
    restored, meta = ckpt.load_checkpoint(path)
    _assert_same_tree(tree, restored)
    if meta.get("loss") is None:
        raise RuntimeError("the checkpoint's metrics lost the loss")
    _say(f"dryrun_multichip checkpoint OK, rank {rank}: save and load under the mesh "
         "round-trip the train state bit for bit")
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "launches": launches,
            "serving_err": serving_err, "expert_err": expert_err,
            "mesh": tuple(sizes[a] for a in AXES)}


def _assert_same_tree(want, got, path="") -> None:
    if isinstance(want, dict):
        if set(want) != set(got):
            raise RuntimeError(f"checkpoint keys at {path or 'the root'} differ")
        for k in want:
            _assert_same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, (a, b) in enumerate(zip(want, got, strict=True)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        if not torch.equal(want.cpu(), got.cpu()):
            raise RuntimeError(f"checkpoint tensor {path} differs")
    elif want != got:
        raise RuntimeError(f"checkpoint value {path}: {want!r} != {got!r}")


def _join(rank: int, n: int, port: str, device: torch.device) -> torch.device:
    """Join the group as `rank`; the device this rank drives."""
    if device.type == "cpu":
        multihost.initialize(f"localhost:{port}", n, rank, device="cpu")
        return device
    cards = torch.cuda.device_count()
    if cards >= n:
        own = torch.device("cuda", rank)
        multihost.initialize(f"localhost:{port}", n, rank, device=own)
        return own
    # Fewer cards than ranks: gloo over CUDA tensors, the ranks sharing the
    # cards, as NCCL takes one rank a device.
    own = torch.device("cuda", rank % cards)
    torch.cuda.set_device(own)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=n,
                            rank=rank)
    return own


def launch(n_devices: int, shape: Optional[Sequence[int]] = None, device: str = "cuda",
           timeout: float = RANK_TIMEOUT_S) -> int:
    """Start the `n_devices` ranks of the dryrun on this host and wait for
    them; their output goes to this process's. Returns the first failing
    rank's exit code, 0 when every rank passed."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dryrun runs on the card: no CUDA device here (pass "
                           "--device cpu for the CPU)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = [sys.executable, "-m", "adam_dehaze_tpu_torch.parallel.dryrun", "--devices",
            str(n_devices), "--device", device, "--port", str(port)]
    if shape is not None:
        args += ["--shape", *map(str, shape)]
    procs = [subprocess.Popen(args + ["--rank", str(rank)]) for rank in range(n_devices)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((p.returncode for p in procs if p.returncode), 0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, required=True, help="ranks (processes)")
    parser.add_argument("--shape", type=int, nargs=3, metavar=("DATA", "SPATIAL", "MODEL"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rank", type=int, help="run as this rank (set by the launcher)")
    parser.add_argument("--port", help="the group's localhost port (set by the launcher)")
    args = parser.parse_args(argv)
    if args.rank is None:
        return launch(args.devices, args.shape, args.device)
    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = _join(args.rank, args.devices, args.port, torch.device(args.device))
    try:
        dryrun_multichip(args.devices, args.shape, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
