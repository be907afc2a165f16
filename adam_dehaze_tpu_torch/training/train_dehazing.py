"""Per-branch dehazing training of the port.

Counterpart of adam_dehaze_tpu/training/train_dehazing.py: one branch per
intensity (low, then medium, then high), each with Adam, the DehazingLoss,
the plateau scheduler on the validation loss, best-by-PSNR checkpoints and
an epoch checkpoint every 5 epochs; `resume` continues from the latest.

- Each branch trains on its own intensity's stream (`FilteredDataset`).
- Mixed precision is `torch.autocast(dtype=cuda.compute_dtype)` around the
  branch and the loss, parameters and BN statistics in f32: the counterpart
  of flax's `dtype=compute_dtype` with f32 params.
- On a CUDA device the high branch's six AttentionBlocks run kernel K2
  forward in every train and eval step (`channel_spatial_gate` is an
  autograd Function), and the low branch's eval forward (validation) is
  kernel K1 at the weights' dtype.
- Validation is single-process (the JAX package's cross-host mean is the
  identity there). Rematerialisation (`tpu.remat`) has no counterpart yet.

Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import os
from typing import Dict

import torch

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.data.augment import augment_triplet
from adam_dehaze_tpu_torch.data.dataset import (
    INTENSITY_MAP,
    DataLoader,
    HazyImageDataset,
)
from adam_dehaze_tpu_torch.losses.dehazing import get_dehazing_loss
from adam_dehaze_tpu_torch.models.branches import (
    create_high_intensity_model,
    create_low_intensity_model,
    create_medium_intensity_model,
)
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.image import psnr, ssim_gray
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training.common import (
    device_batch,
    device_prefetch,
    masked_mean,
    state_to_tree,
    tree_to_state,
)
from adam_dehaze_tpu_torch.training.logging import MetricsLogger
from adam_dehaze_tpu_torch.training.state import (
    ReduceLROnPlateau,
    TrainState,
    get_learning_rate,
    make_optimizer,
)

_FACTORIES = {
    "low": create_low_intensity_model,
    "medium": create_medium_intensity_model,
    "high": create_high_intensity_model,
}


class FilteredDataset:
    """View of HazyImageDataset restricted to one intensity class."""

    def __init__(self, base: HazyImageDataset, intensity: str):
        self.base = base
        label = INTENSITY_MAP[intensity]
        self.indices = [i for i, s in enumerate(base.samples)
                        if s["intensity"] == label]

    def __len__(self):
        return len(self.indices)

    def load(self, idx: int):
        return self.base.load(self.indices[idx])


def get_intensity_loader(config, split: str, intensity: str) -> DataLoader:
    key = {"train": "train_path", "val": "val_path"}.get(split, "test_path")
    base = HazyImageDataset(config["dataset"][key], split,
                            config["dataset"]["img_size"])
    ds = FilteredDataset(base, intensity)
    if len(ds) == 0:
        raise ValueError(
            f"No '{intensity}' samples for split '{split}' under "
            f"{os.path.join(config['dataset'][key], split)} — an empty "
            "stream would train to NaN (see get_dataloader for the layout)")
    return DataLoader(ds, batch_size=config["dataset"]["batch_size"],
                      shuffle=(split == "train"),
                      num_workers=config["dataset"]["num_workers"],
                      seed=config["seed"])


def _autocast(device: torch.device, dtype: torch.dtype):
    return torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32)


def make_train_step(loss, loss_params, augmentation: bool = True,
                    dtype: torch.dtype = torch.float32):
    """step(state, batch, generator) -> loss components (detached tensors):
    augment, forward and loss under autocast, backward, one Adam step. The
    gradients stay on the parameters after the step."""
    def step(state: TrainState, batch, generator=None):
        if augmentation:
            batch = augment_triplet(generator, batch)
        dev = batch["hazy"].device
        with _autocast(dev, dtype):
            out = state.module(batch["hazy"])
            total, comps = loss(loss_params, out, batch["clear"], hazy=batch["hazy"])
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in comps.items()}

    return step


def make_eval_step(loss, loss_params, dtype: torch.dtype = torch.float32):
    """step(state, batch) -> {loss, psnr, ssim, n, dehazed} on the batch's
    valid rows, the module in eval mode."""
    @torch.no_grad()
    def step(state: TrainState, batch):
        state.module.eval()
        dev = batch["hazy"].device
        with _autocast(dev, dtype):
            out = state.module(batch["hazy"])
            total, _ = loss(loss_params, out, batch["clear"], hazy=batch["hazy"])
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(out.shape[0], dtype=torch.bool, device=dev)
        return {
            "loss": total.float(),
            "psnr": masked_mean(psnr(out, batch["clear"]), mask),
            "ssim": masked_mean(ssim_gray(out, batch["clear"]), mask),
            "n": mask.sum(),
            "dehazed": out,
        }

    return step


def init_branch(intensity: str, config, device) -> torch.nn.Module:
    """A freshly initialised branch on `device`: flax's default init, drawn
    from a generator seeded with `seed` + the intensity label."""
    gen = torch.Generator().manual_seed(config["seed"] + INTENSITY_MAP[intensity])
    return init_params_(_FACTORIES[intensity](config), gen).to(device)


def _loss_params(loss, device):
    return loss.init(torch.Generator().manual_seed(0), device)


def train_dehazing_model(intensity: str, config, resume: bool = False,
                         loss_params=None, device="cuda"):
    """Train one branch; returns (model, state) with the best-by-PSNR
    weights loaded."""
    device = torch.device(device)
    dtype = compute_dtype(config)
    model = init_branch(intensity, config, device)
    state = TrainState(model, make_optimizer(
        model.parameters(), config["dehazing"][intensity]["learning_rate"]))
    loss = get_dehazing_loss(config)
    if loss_params is None:
        loss_params = _loss_params(loss, device)

    ckpt_dir = os.path.join(config["dehazing"]["checkpoint_dir"], intensity)
    logger = MetricsLogger(os.path.join(config.get("_logs_dir", "logs"),
                                        "dehazing", intensity))
    scheduler = ReduceLROnPlateau(factor=0.5, patience=5)

    start_epoch, best_val_psnr = 0, 0.0
    if resume:
        latest = ckpt.find_latest_checkpoint(ckpt_dir)
        if latest:
            tree, metrics = ckpt.load_checkpoint(latest)
            tree_to_state(state, tree)
            start_epoch = int(metrics.get("epoch", 0))
            best_val_psnr = metrics.get("best_val_psnr", 0.0)
            print(f"Resumed {intensity} from {latest} at epoch {start_epoch}")

    train_loader = get_intensity_loader(config, "train", intensity)
    val_loader = get_intensity_loader(config, "val", intensity)
    train_step = make_train_step(loss, loss_params,
                                 config["dataset"].get("augmentation", True), dtype)
    eval_step = make_eval_step(loss, loss_params, dtype)
    # The augmentation's draws, on the batches' device.
    gen = torch.Generator(device).manual_seed(config["seed"] + INTENSITY_MAP[intensity])

    epochs = config["dehazing"].get("epochs", 30)
    for epoch in range(start_epoch, epochs):
        model.train()
        train_losses = []
        for batch in device_prefetch(train_loader, device):
            comps = train_step(state, batch, gen)
            train_losses.append(comps["total"])
        train_loss = (float(torch.stack(train_losses).float().mean())
                      if train_losses else float("nan"))

        val = _validate(eval_step, state, val_loader, device)
        scheduler.step(val["loss"], state.optimizer)
        logger.scalars(epoch, {
            "train/loss": train_loss, "val/loss": val["loss"],
            "val/psnr": val["psnr"], "val/ssim": val["ssim"],
            "lr": get_learning_rate(state.optimizer)})
        if epoch % 5 == 0 and val.get("images") is not None:
            logger.images(epoch, f"{intensity}/dehazed", val["images"])
        print(f"[{intensity}] Epoch {epoch + 1}/{epochs}: "
              f"loss={train_loss:.4f} val_psnr={val['psnr']:.2f} "
              f"val_ssim={val['ssim']:.4f}")

        if val["psnr"] > best_val_psnr:
            best_val_psnr = val["psnr"]
            ckpt.save_checkpoint(ckpt_dir, "best_model", state_to_tree(state),
                                 {"epoch": epoch + 1, "val_psnr": val["psnr"],
                                  "val_ssim": val["ssim"],
                                  "best_val_psnr": best_val_psnr})
        if (epoch + 1) % 5 == 0:
            ckpt.save_checkpoint(ckpt_dir, f"checkpoint_epoch_{epoch + 1}",
                                 state_to_tree(state),
                                 {"epoch": epoch + 1,
                                  "best_val_psnr": best_val_psnr})

    best = ckpt.best_model_path(ckpt_dir)
    if os.path.exists(best):
        tree_to_state(state, ckpt.load_checkpoint(best)[0])
    logger.close()
    return model, state


def _validate(eval_step, state: TrainState, loader, device) -> Dict[str, float]:
    tot = {"loss": 0.0, "psnr": 0.0, "ssim": 0.0}
    n_total, images = 0, None
    for batch in loader:
        m = eval_step(state, device_batch(batch, device))
        n = int(m["n"])
        for k in tot:
            tot[k] += float(m[k]) * n
        n_total += n
        if images is None:
            images = m["dehazed"][:4].float().cpu().numpy()
    out = {k: v / max(n_total, 1) for k, v in tot.items()}
    out["images"] = images
    return out


def train_all_dehazing_models(config, resume: bool = False, device="cuda"):
    """low -> medium -> high, sharing one set of frozen loss nets."""
    loss_params = _loss_params(get_dehazing_loss(config), torch.device(device))
    out = {}
    for intensity in ("low", "medium", "high"):
        print(f"\n=== Training {intensity} intensity model ===")
        out[intensity] = train_dehazing_model(intensity, config, resume,
                                              loss_params, device)
    return out


def evaluate_dehazing_model(model, state: TrainState, intensity: str,
                            config) -> Dict[str, float]:
    """Test-split metrics of one branch, on the device its weights are on."""
    device = next(state.module.parameters()).device
    loss = get_dehazing_loss(config)
    loader = get_intensity_loader(config, "test", intensity)
    eval_step = make_eval_step(loss, _loss_params(loss, device), compute_dtype(config))
    val = _validate(eval_step, state, loader, device)
    print(f"[{intensity}] test: psnr={val['psnr']:.2f} ssim={val['ssim']:.4f}")
    return {k: v for k, v in val.items() if k != "images"}
