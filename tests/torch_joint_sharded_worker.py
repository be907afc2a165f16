"""One rank of the four-process gloo group of tests/test_torch_joint_sharded.py.

    python tests/torch_joint_sharded_worker.py RANK PORT INPUTS OUT_DIR

Imports the port only (no JAX). On a data 1 x spatial 2 x model 2 mesh of
the four ranks it takes, in float64, the joint trainer's three steps
(`make_train_step` with augmentation on, `make_hard_branch_step` on the high
branch, `make_eval_step`) through `shard_train_step` / `shard_eval_step`;
in float32 and in float64 one joint step (augmentation and dropout off,
SGD) from the weights the test also hands the JAX package; the train step
again under `cuda.remat` true and "fullres"; the medium and high branches'
int8 serving applies (c = 8, 64^2, fp32) on the whole batch and on both
axes at once; then `dryrun_multichip(4, (1, 2, 2))`. Ranks 0, 1 and 2 then
each take one of the three steps unsharded, in this process alone, on the
same inputs. Everything goes to OUT_DIR/rank{RANK}.pt.
"""
import functools
import os
import sys

import torch

import numpy as np

from adam_dehaze_tpu_torch.losses.dehazing import get_joint_loss
from adam_dehaze_tpu_torch.models.branches import (
    HighIntensityDehazeModel,
    MediumIntensityDehazeModel,
    create_branch_models,
)
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.nn.blocks import Dropout, init_params_
from adam_dehaze_tpu_torch.ops.quant import quantize_apply
from adam_dehaze_tpu_torch.parallel import multihost
from adam_dehaze_tpu_torch.parallel.data_parallel import shard_eval_step, shard_train_step
from adam_dehaze_tpu_torch.parallel.dryrun import dryrun_config, dryrun_multichip
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
from adam_dehaze_tpu_torch.parallel.spatial import make_spatial_infer, shard_image_batch
from adam_dehaze_tpu_torch.training import train_joint as tj
from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer

MESH = {"data": 1, "spatial": 2, "model": 2}
STEPS = ("train", "hard", "eval")
# The SGD step of the JAX comparison: params - LR * gradient.
LR = 1.0


def router_f64(cfg=None):
    """The seeded dryrun router (of `cfg`, by default the dryrun's config)
    in float64, its classifier frozen."""
    cfg = cfg or dryrun_config()
    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    init_params_(router, torch.Generator().manual_seed(0))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for m in router.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(1.0, 1.3, generator=gen)
    router.classifier.requires_grad_(False)
    return router.double()


def run_step(kind, batch, mesh=None, remat=False):
    """One step of `kind` from the seeded state, its forward under
    `cuda.remat: remat`: (metrics, state dict of what it trained after
    it)."""
    cfg = dryrun_config()
    cfg["cuda"]["remat"] = remat
    router = router_f64(cfg)
    joint_loss = get_joint_loss(cfg)
    nets = {k: v.double() for k, v in joint_loss.init(torch.Generator().manual_seed(2)).items()}
    module = router.models["high"] if kind == "hard" else router
    state = TrainState(module, make_optimizer([p for p in module.parameters() if p.requires_grad],
                                              1e-3))
    if kind == "eval":
        step = tj.make_eval_step(joint_loss, nets)
        wrap = shard_eval_step
    else:
        step = (functools.partial(tj.make_train_step, remat=remat) if kind == "train"
                else tj.make_hard_branch_step)(joint_loss, nets, augmentation=True)
        wrap = shard_train_step
    if mesh is not None:
        step = wrap(step, mesh, batch)
    args = () if kind == "eval" else (torch.Generator().manual_seed(3),)
    metrics = step(state, batch, *args)
    return ({k: v.detach().clone() for k, v in metrics.items()},
            {k: v.detach().clone() for k, v in module.state_dict().items()})


def jax_step(inputs, mesh=None, dtype=torch.float32):
    """The joint step held against the JAX package's: the test's router
    weights and loss nets, dropout off, SGD at LR, augmentation off, in
    `dtype`; through shard_train_step when a mesh is given."""
    cfg = dryrun_config()
    router = create_router(create_branch_models(cfg), create_classifier(cfg), cfg)
    router.load_state_dict(inputs["router"])
    router.to(dtype)
    for m in router.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    router.classifier.requires_grad_(False)
    joint_loss = get_joint_loss(cfg)
    nets = joint_loss.init(torch.Generator().manual_seed(0))
    for name, net in nets.items():
        net.load_state_dict(inputs["nets"][name])
        net.to(dtype)
    state = TrainState(router, torch.optim.SGD(
        [p for p in router.parameters() if p.requires_grad], lr=LR))
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in inputs["jax_batch"].items()}
    step = tj.make_train_step(joint_loss, nets, augmentation=False)
    if mesh is not None:
        step = shard_train_step(step, mesh, batch)
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.detach().clone() for k, v in router.state_dict().items()}}


def int8_on_both_axes(mesh):
    """The medium and high branches' int8 serving applies (seeded, c = 8,
    fp32) on 2 images at 64^2: unsharded, and through make_spatial_infer
    under channel_sharding (this rank's rows, its split channels)."""
    x = torch.from_numpy(np.random.default_rng(40).random((2, 64, 64, 3), dtype=np.float32))
    out = {}
    for i, cls in enumerate((MediumIntensityDehazeModel, HighIntensityDehazeModel)):
        gen = torch.Generator().manual_seed(41 + i)
        model = init_params_(cls(8), gen)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                    m.running_var.uniform_(0.8, 1.3, generator=gen)
        apply = quantize_apply(model.eval(), torch.float32)
        with torch.inference_mode():
            whole = apply(x)
            with channel_sharding(mesh):
                sharded = make_spatial_infer(apply, mesh)(shard_image_batch(mesh, x))
        out[cls.__name__] = {"whole": whole, "sharded": sharded}
    return out


def main():
    rank, port, inputs_path, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                        sys.argv[4])
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=True)
    multihost.initialize(f"localhost:{port}", 4, rank, device="cpu")
    mesh = make_mesh(MESH, ["cpu"] * 4)
    batch = inputs["batch"]
    out = {"sharded": {kind: run_step(kind, batch, mesh) for kind in STEPS},
           "jax_step": {"float32": jax_step(inputs, mesh),
                        "float64": jax_step(inputs, mesh, torch.float64)},
           "remat": {str(mode): run_step("train", batch, mesh, remat=mode)
                     for mode in (True, "fullres")},
           "int8": int8_on_both_axes(mesh),
           "dryrun": dryrun_multichip(4, tuple(MESH.values()), "cpu")}
    torch.distributed.destroy_process_group()
    if rank < len(STEPS):
        out["global"] = {STEPS[rank]: run_step(STEPS[rank], batch)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
