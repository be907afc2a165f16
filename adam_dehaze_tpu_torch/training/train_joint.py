"""Joint (classifier -> router -> branches) training of the port.

Counterpart of adam_dehaze_tpu/training/train_joint.py: the router of the
config over the classifier and the three branches, grafted from their
trainers' `best_model.pth` where those exist, trained with the JointLoss at
`joint_training.learning_rate`; the plateau scheduler on the validation
loss, a best-by-PSNR checkpoint of the whole router and one every 5 epochs;
`resume` continues from the latest.

- The frozen classifier. As in the JAX package (and the reference it
  follows), the classifier's parameters are not optimised, yet the
  classifier runs in train mode: its BN statistics update and its dropouts
  draw from the step's generator. The JAX step masks the classifier's
  gradients to 0, which leaves its parameters exactly where they were;
  here they are left out of the optimiser and need no gradient, so no
  backward runs through the classifier. Nothing else is upstream of its
  logits, so every other gradient is the same.
- Soft routing blends the branches through kernel K5 (`blend3`, its
  autograd Function in the train step); the high branch's AttentionBlocks
  run kernel K2; hard routing picks by the argmax of the detached logits,
  and the branches an image did not pick get a zero gradient, not none.
- `cuda.remat` (training/remat.py): true checkpoints the router forward,
  fullres the branches' full-resolution blocks.
- The hard fine-tune tail (`joint_training.hard_finetune_frac`, default 0):
  the last epochs train each branch on its own intensity's stream with the
  dehazing part of the JointLoss and a fresh Adam at the current joint
  learning rate. The per-branch states hold the router's own branch
  modules, so their updates are the router's.
- Mixed precision is autocast in `cuda.compute_dtype` around the forward
  and the loss, with f32 parameters and BN statistics. Validation is not
  averaged across processes, as in the JAX package's joint trainer.
- The three steps run as they are through parallel/data_parallel.py's
  `shard_train_step` and `shard_eval_step` on a mesh with `data`,
  `spatial` (H split) and `model` (the branches' 4c stages split) axes, as
  the JAX package's jitted steps run over theirs: the augmentation's flip
  and gray mean, the loss nets and the metrics take the shards
  (data/augment.py, losses/, ops/image.py). `cuda.remat` is refused there:
  a checkpointed forward recomputes in the backward, outside the sharding
  contexts on the card's autograd thread.

Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, Tuple

import torch

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.data.augment import augment_triplet
from adam_dehaze_tpu_torch.data.dataset import get_dataloader
from adam_dehaze_tpu_torch.losses.dehazing import get_joint_loss
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER, create_router
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.image import psnr, ssim_gray
from adam_dehaze_tpu_torch.parallel import sharding, spatial
from adam_dehaze_tpu_torch.parallel.multihost import process_zero_value
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training.common import (
    autocast,
    device_batch,
    device_prefetch,
    masked_mean,
    state_to_tree,
    tree_to_state,
)
from adam_dehaze_tpu_torch.training.logging import MetricsLogger
from adam_dehaze_tpu_torch.training.remat import apply_remat, remat_mode
from adam_dehaze_tpu_torch.training.state import (
    ReduceLROnPlateau,
    TrainState,
    get_learning_rate,
    make_optimizer,
)
from adam_dehaze_tpu_torch.training.train_dehazing import get_intensity_loader


def build_router_state(config, device, generator=None) -> Tuple[torch.nn.Module, TrainState]:
    """The router of the config, seeded (flax's default init from
    `generator`, by default one seeded with `seed` + 100), its classifier
    and branches grafted from `{classifier.checkpoint_dir}/best_model.pth`
    and `{dehazing.checkpoint_dir}/{level}/best_model.pth` where those
    exist (a warning for each that does not), the classifier frozen; and
    its TrainState with Adam over the parameters that are not the
    classifier's."""
    if generator is None:
        generator = torch.Generator().manual_seed(config["seed"] + 100)
    router = create_router(create_branch_models(config), create_classifier(config), config)
    init_params_(router, generator)

    def graft(module, ckpt_dir: str, what: str):
        best = ckpt.best_model_path(ckpt_dir)
        if not os.path.exists(best):
            print(f"Warning: no pretrained checkpoint at {best}")
            return
        module.load_state_dict(ckpt.load_checkpoint(best)[0]["model"])
        print(f"Loaded pretrained {what} from {best}")

    graft(router.classifier, config["classifier"]["checkpoint_dir"], "classifier")
    for level in INTENSITY_ORDER:
        graft(router.models[level],
              os.path.join(config["dehazing"]["checkpoint_dir"], level), f"models_{level}")
    router.classifier.requires_grad_(False)
    router.to(device)
    params = [p for p in router.parameters() if p.requires_grad]
    return router, TrainState(router, make_optimizer(params, config["joint_training"]["learning_rate"]))


def _step_metrics(comps, dehazed, clear):
    out = {k: v.detach() for k, v in comps.items() if k != "dehazing_components"}
    out["psnr"] = psnr(dehazed.detach(), clear).mean()
    return out


def _refuse_remat_on_a_mesh(remat) -> None:
    """A checkpointed forward recomputes in the backward, which the card's
    autograd engine runs on a thread of its own, outside the sharding
    contexts: refused on a spatial or model mesh."""
    if remat:
        what = f"the joint step with cuda.remat {remat!r}"
        spatial.refuse(what)
        sharding.refuse(what)


def make_train_step(joint_loss, loss_params, augmentation: bool = True, remat=False,
                    dtype: torch.dtype = torch.float32):
    """step(state, batch, generator) -> {dehazing, classification,
    detection, total, psnr} (detached): augment, the router's train-mode
    forward (checkpointed under remat True/"full") and the JointLoss under
    autocast, backward, one Adam step. `generator` (on the batch's device)
    feeds the augmentation and the dropouts."""
    def step(state: TrainState, batch, generator=None):
        _refuse_remat_on_a_mesh(remat)
        if augmentation:
            batch = augment_triplet(generator, batch)
        router = state.module
        fwd = apply_remat(functools.partial(router, generator=generator), remat, router,
                          generator)
        with autocast(batch["hazy"].device, dtype):
            dehazed, info = fwd(batch["hazy"])
            logits = info.get("logits")
            total, comps = joint_loss(loss_params, dehazed, batch["clear"], logits,
                                      batch["intensity"] if logits is not None else None,
                                      hazy=batch["hazy"])
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return _step_metrics(comps, dehazed, batch["clear"])

    return step


def make_hard_branch_step(joint_loss, loss_params, augmentation: bool = True,
                          dtype: torch.dtype = torch.float32):
    """The hard fine-tune phase's step of one branch (`state.module`) on its
    own intensity's stream: the dehazing part of the JointLoss (no logits,
    so no CE term); otherwise as `make_train_step`."""
    def step(state: TrainState, batch, generator=None):
        if augmentation:
            batch = augment_triplet(generator, batch)
        with autocast(batch["hazy"].device, dtype):
            dehazed = state.module(batch["hazy"])
            total, comps = joint_loss(loss_params, dehazed, batch["clear"], None, None,
                                      hazy=batch["hazy"])
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return _step_metrics(comps, dehazed, batch["clear"])

    return step


def make_eval_step(joint_loss, loss_params, dtype: torch.dtype = torch.float32):
    """step(state, batch) -> {loss, psnr, ssim, n[, cls_acc], dehazed}
    over the batch's valid rows, the router in eval mode."""
    @torch.no_grad()
    def step(state: TrainState, batch):
        state.module.eval()
        dev = batch["hazy"].device
        with autocast(dev, dtype):
            dehazed, info = state.module(batch["hazy"])
            logits = info.get("logits")
            total, _ = joint_loss(loss_params, dehazed, batch["clear"], logits,
                                  batch["intensity"] if logits is not None else None,
                                  hazy=batch["hazy"])
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(dehazed.shape[0], dtype=torch.bool, device=dev)
        out = {"loss": total.float(),
               "psnr": masked_mean(psnr(dehazed, batch["clear"]), mask),
               "ssim": masked_mean(ssim_gray(dehazed, batch["clear"]), mask),
               "n": mask.sum(), "dehazed": dehazed}
        if logits is not None:
            correct = (logits.argmax(-1) == batch["intensity"].long()).float()
            out["cls_acc"] = masked_mean(correct, mask)
        return out

    return step


def _loss_params(joint_loss, device):
    return joint_loss.init(torch.Generator().manual_seed(0), device)


def train_joint_model(config, resume: bool = False, device="cuda", loss_params=None):
    """Joint training; returns (router, state) with the best-by-PSNR
    weights loaded."""
    device = torch.device(device)
    dtype = compute_dtype(config)
    jt = config["joint_training"]
    router, state = build_router_state(config, device)
    joint_loss = get_joint_loss(config)
    if loss_params is None:
        loss_params = _loss_params(joint_loss, device)

    ckpt_dir = jt["checkpoint_dir"]
    logger = MetricsLogger(os.path.join(config.get("_logs_dir", "logs"), "joint"))
    scheduler = ReduceLROnPlateau(factor=0.5, patience=5)

    start_epoch, best_val_psnr = 0, 0.0
    if resume:
        latest = ckpt.find_latest_checkpoint(ckpt_dir)
        if latest:
            tree, metrics = ckpt.load_checkpoint(latest)
            tree_to_state(state, tree)
            start_epoch = int(metrics.get("epoch", 0))
            best_val_psnr = metrics.get("best_val_psnr", 0.0)
            print(f"Resumed joint from {latest} at epoch {start_epoch}")

    augmentation = config["dataset"].get("augmentation", True)
    train_loader = get_dataloader(config, "train")
    val_loader = get_dataloader(config, "val")
    train_step = make_train_step(joint_loss, loss_params, augmentation,
                                 remat=remat_mode(config), dtype=dtype)
    eval_step = make_eval_step(joint_loss, loss_params, dtype)
    # The augmentation and dropout draws, on the batches' device.
    gen = torch.Generator(device).manual_seed(config["seed"] + 100)

    epochs = jt["epochs"]
    # The last `hard_finetune_frac` of the epochs fine-tune each branch on
    # its own intensity's stream (1x the branch FLOPs, not the soft 3x).
    hard_frac = float(jt.get("hard_finetune_frac", 0.0))
    hard_start = epochs - int(round(hard_frac * epochs)) if hard_frac else epochs
    hard = None     # built at the phase switch: level -> (state, step, loader)

    def enter_hard_phase():
        lr = get_learning_rate(state.optimizer)
        step = make_hard_branch_step(joint_loss, loss_params, augmentation, dtype)
        return {level: (TrainState(router.models[level],
                                   make_optimizer(router.models[level].parameters(), lr)),
                        step, get_intensity_loader(config, "train", level))
                for level in INTENSITY_ORDER}

    for epoch in range(start_epoch, epochs):
        router.train()
        totals = []
        if epoch >= hard_start:
            if hard is None:
                hard = enter_hard_phase()
                print(f"[joint] epoch {epoch + 1}: entering the hard fine-tune phase "
                      "(per-intensity streams, 1x branch FLOPs)")
            t0, n_images = time.perf_counter(), 0
            for level in INTENSITY_ORDER:
                bstate, step, loader = hard[level]
                for batch in device_prefetch(loader, device):
                    totals.append(step(bstate, batch, gen)["total"])
                    n_images += batch["hazy"].shape[0]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"[joint]   hard-phase epoch throughput: "
                  f"{n_images / max(time.perf_counter() - t0, 1e-9):.1f} imgs/s")
        else:
            for batch in device_prefetch(train_loader, device):
                totals.append(train_step(state, batch, gen)["total"])
        train_loss = float(torch.stack(totals).mean()) if totals else float("nan")

        val = _validate(eval_step, state, val_loader, device)
        scheduler.step(val["loss"], state.optimizer)
        logger.scalars(epoch, {"train/loss": train_loss, "val/loss": val["loss"],
                               "val/psnr": val["psnr"], "val/ssim": val["ssim"],
                               "val/cls_acc": val.get("cls_acc", 0.0),
                               "lr": get_learning_rate(state.optimizer)})
        print(f"[joint] Epoch {epoch + 1}/{epochs}: loss={train_loss:.4f} "
              f"val_psnr={val['psnr']:.2f} val_ssim={val['ssim']:.4f}")

        # Process 0's validation decides for every process: the save is collective.
        decided = process_zero_value(val["psnr"])
        if decided > best_val_psnr:
            best_val_psnr = decided
            ckpt.save_checkpoint(ckpt_dir, "best_model", state_to_tree(state),
                                 {"epoch": epoch + 1, "val_psnr": val["psnr"],
                                  "val_ssim": val["ssim"], "best_val_psnr": best_val_psnr})
        if (epoch + 1) % 5 == 0:
            ckpt.save_checkpoint(ckpt_dir, f"checkpoint_epoch_{epoch + 1}",
                                 state_to_tree(state),
                                 {"epoch": epoch + 1, "best_val_psnr": best_val_psnr})

    best = ckpt.best_model_path(ckpt_dir)
    if os.path.exists(best):
        tree_to_state(state, ckpt.load_checkpoint(best)[0])
    logger.close()
    return router, state


def _validate(eval_step, state: TrainState, loader, device) -> Dict[str, float]:
    """Means over a loader's valid rows of every metric the eval step
    returns (the images aside)."""
    tot: Dict[str, float] = {}
    n_total = 0
    for batch in loader:
        m = eval_step(state, device_batch(batch, device))
        n = int(m.pop("n"))
        m.pop("dehazed")
        for k, v in m.items():
            tot[k] = tot.get(k, 0.0) + float(v) * n
        n_total += n
    return {k: v / max(n_total, 1) for k, v in tot.items()}


def evaluate_joint_model(router, state: TrainState, config) -> Dict[str, float]:
    """Test-split joint metrics, on the device the weights are on."""
    device = next(state.module.parameters()).device
    joint_loss = get_joint_loss(config)
    eval_step = make_eval_step(joint_loss, _loss_params(joint_loss, device),
                               compute_dtype(config))
    out = _validate(eval_step, state, get_dataloader(config, "test"), device)
    print(f"[joint] test: psnr={out['psnr']:.2f} ssim={out['ssim']:.4f} "
          f"cls_acc={out.get('cls_acc', float('nan')):.4f}")
    return out
