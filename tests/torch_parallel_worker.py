"""One rank of the two-process gloo group of tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK PORT INPUTS OUT_DIR

Imports the port only (no JAX): the test computes the JAX references in
its own process and compares them with what each rank writes to
OUT_DIR/rank{RANK}.pt. Every case that needs the group runs in this one
spawn.
"""
import contextlib
import os
import sys

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.data.dataset import get_dataloader
from adam_dehaze_tpu_torch.losses.dehazing import get_joint_loss
from adam_dehaze_tpu_torch.models.branches import LightweightDehazeModel
from adam_dehaze_tpu_torch.parallel import data_parallel, multihost
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh, replicate
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training import train_joint as tj
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables
from adam_dehaze_tpu_torch.training.state import TrainState

# The joint step's global batch: 2 ranks x 2 images at 32^2.
JOINT_ROWS = 4


class TinyConv(torch.nn.Module):
    """tests/test_parallel.py's two-conv model (NHWC in and out)."""

    def __init__(self):
        super().__init__()
        self.c0 = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.c1 = torch.nn.Conv2d(8, 3, 3, padding=1)

    def forward(self, x):
        y = self.c1(torch.relu(self.c0(x.permute(0, 3, 1, 2))))
        return y.permute(0, 2, 3, 1)


def mse_step(state, batch, generator=None):
    """One SGD step on the mean squared error."""
    loss = ((state.module(batch["x"]) - batch["y"]) ** 2).mean()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    return {"loss": loss.detach()}


def sgd_state(module, lr=0.1):
    return TrainState(module, torch.optim.SGD(module.parameters(), lr=lr))


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def module_arrays(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def conv_step(inputs, mesh):
    model = TinyConv()
    with torch.no_grad():
        for name, t in inputs["conv_params"].items():
            model.get_parameter(name).copy_(t)
    batch = {"x": inputs["conv_x"], "y": inputs["conv_y"]}
    step = data_parallel.shard_train_step(mse_step, mesh, batch)
    metrics = step(sgd_state(model), batch)
    return {"params": module_arrays(model), "loss": metrics["loss"]}


def low_step(inputs, mesh):
    """The low branch (c = 4, 1 block) in train mode, float64, one SGD
    step on 2 x 2 images."""
    model = load_flax_variables(LightweightDehazeModel(4, 1), numpy_tree(inputs["low_vars"]))
    model = model.double().train()
    batch = {"x": inputs["low_x"], "y": inputs["low_y"]}
    step = data_parallel.shard_train_step(mse_step, mesh, batch)
    step(sgd_state(model), batch)
    return module_arrays(model)


def joint_config():
    """tests/torch_port_util.py:joint_configs's port side, augmentation on."""
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for level, (c, b) in {"low": (4, 1), "medium": (4, 2), "high": (8, 2)}.items():
        cfg["dehazing"][level].update(channels=c, blocks=b)
    cfg["dataset"].update(img_size=32, batch_size=2, num_workers=2, augmentation=True)
    cfg["classifier"]["checkpoint_dir"] = cfg["dehazing"]["checkpoint_dir"] = "absent"
    return cfg


def joint_batch():
    rng = np.random.default_rng(5)
    return {"hazy": torch.from_numpy(rng.random((JOINT_ROWS, 32, 32, 3))),
            "clear": torch.from_numpy(rng.random((JOINT_ROWS, 32, 32, 3))),
            "intensity": torch.tensor([0, 1, 2, 0])}


def joint_steps(mesh, rank):
    """The soft joint step with augmentation and dropout on, in float64:
    the data-parallel step on 2 ranks, and on rank 0 the single-process
    step on the global batch with the same generator seed. Before them,
    the joint eval step both ways on the fresh router."""
    cfg = joint_config()
    joint_loss = get_joint_loss(cfg)
    nets = {k: v.double() for k, v in
            tj._loss_params(joint_loss, torch.device("cpu")).items()}
    batch = joint_batch()
    out = {}
    for tag in ("dp", "single") if rank == 0 else ("dp",):
        router, state = tj.build_router_state(cfg, "cpu")
        router.double()
        eval_step = tj.make_eval_step(joint_loss, nets)
        train_step = tj.make_train_step(joint_loss, nets, augmentation=True)
        if tag == "dp":
            replicate(mesh, state)
            eval_step = data_parallel.shard_eval_step(eval_step, mesh, batch)
            train_step = data_parallel.shard_train_step(train_step, mesh, batch)
        out[f"{tag}_eval"] = {k: v for k, v in eval_step(state, batch).items()}
        router.train()
        metrics = train_step(state, batch, torch.Generator().manual_seed(7))
        out[tag] = {"metrics": metrics,
                    "grads": {n: p.grad.clone() for n, p in router.named_parameters()
                              if p.grad is not None},
                    "stats": {k: v.clone() for k, v in router.state_dict().items()
                              if "running" in k or "num_batches" in k}}
    return out


class _NoLogger:
    def __init__(self, *args, **kwargs):
        pass

    def scalars(self, *args, **kwargs):
        pass

    def close(self):
        pass


def best_checkpoint_decision(inputs, rank, out_dir):
    """The joint trainer over 2 epochs with each process's validation made
    to differ: rank 0 reads PSNR 10 then 12, rank 1 10 then 9 (the steps
    are no-ops). Deciding on its own PSNR, rank 1 would skip the second
    save and rank 0 would wait in its barrier for ever; decided on process
    0's, both save twice. Returns the saves (name, epoch) and the best
    checkpoint's metrics."""
    cfg = joint_config()
    cfg["dataset"].update(train_path=inputs["corpus"], val_path=inputs["corpus"], img_size=16,
                          augmentation=False)
    ckpt_dir = os.path.join(out_dir, "joint_best")
    cfg["joint_training"].update(epochs=2, checkpoint_dir=ckpt_dir, hard_finetune_frac=0.0)
    psnrs = iter([10.0, 12.0] if rank == 0 else [10.0, 9.0])
    saves = []
    real_save = ckpt.save_checkpoint

    def save(ckpt_dir, name, state, metrics=None):
        saves.append((name, int(metrics["epoch"])))
        return real_save(ckpt_dir, name, state, metrics)

    patches = {"_validate": lambda *a: {"loss": 1.0, "psnr": next(psnrs), "ssim": 0.5},
               "make_train_step": lambda *a, **k: (lambda state, batch, gen: {
                   "total": torch.zeros(())}),
               "MetricsLogger": _NoLogger}
    saved = {name: getattr(tj, name) for name in patches}
    for name, fn in patches.items():
        setattr(tj, name, fn)
    ckpt.save_checkpoint = save
    try:
        tj.train_joint_model(cfg, device="cpu", loss_params={})
    finally:
        for name, fn in saved.items():
            setattr(tj, name, fn)
        ckpt.save_checkpoint = real_save
    return {"saves": saves,
            "best": ckpt.load_checkpoint(os.path.join(ckpt_dir, "best_model.pth"))[1]}


def main():
    rank, port, inputs_path, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                        sys.argv[4])
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=True)
    info = multihost.initialize(f"localhost:{port}", 2, rank, device="cpu")
    out = {"info": info, "slice": multihost.host_data_slice(8),
           "mean": multihost.all_hosts_mean(inputs["means"][rank]),
           "tree": multihost.all_hosts_mean_tree(
               {"a": inputs["means"][rank], "b": [2 * inputs["means"][rank], (rank,)]})}

    cfg = load_config()
    cfg["dataset"].update(train_path=inputs["corpus"], img_size=16, batch_size=2,
                          num_workers=1)
    cfg["seed"] = 0
    loader = get_dataloader(cfg, "train")
    out["loader"] = {"indices": loader.dataset.indices, "seed": loader.seed,
                     "names": [n for b in loader for n in b["name"]]}
    out["whole"] = len(get_dataloader(cfg, "train", shard_per_host=False).dataset)

    mesh = make_mesh({"data": 0}, ["cpu", "cpu"])
    out["mesh"] = {"shape": mesh.shape, "data": mesh.coordinate("data"),
                   "ranks": torch.distributed.get_process_group_ranks(mesh.group("data"))}
    seeded = torch.nn.Linear(3, 2)
    with torch.no_grad():
        seeded.weight.fill_(rank + 1.0)
    out["replicated"] = replicate(mesh, seeded).weight.detach().clone()

    out["conv"] = conv_step(inputs, mesh)
    out["low"] = low_step(inputs, mesh)
    # The control: the same step with each process's own BN statistics.
    with contextlib.ExitStack() as stack:
        data_parallel._synchronized_batch_norms, saved = (
            lambda module, group: contextlib.nullcontext(),
            data_parallel._synchronized_batch_norms)
        stack.callback(setattr, data_parallel, "_synchronized_batch_norms", saved)
        out["low_per_process_bn"] = low_step(inputs, mesh)
    out["joint"] = joint_steps(mesh, rank)

    ckpt_dir = os.path.join(out_dir, "ckpt")
    path = ckpt.save_checkpoint(ckpt_dir, "both", {"rank": torch.tensor(rank)}, {"m": rank})
    out["ckpt"] = {"path": path, "files": sorted(os.listdir(ckpt_dir)),
                   "read": ckpt.load_checkpoint(path)}
    out["best_decision"] = best_checkpoint_decision(inputs, rank, out_dir)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
