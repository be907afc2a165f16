"""Detector training of the port (FCOS losses and trainer).

Counterpart of adam_dehaze_tpu/training/train_detection.py: anchor-free
target assignment with center sampling, sigmoid focal classification loss,
GIoU regression weighted by the centerness target, BCE centerness, on the
train split's clear frames (augmented); Adam with the `detection` section's
learning rate and weight decay, a warmup epoch at 0.3x and then cosine to
5 %; the best checkpoint by validation loss (`best_model.pth` with its
`.metrics.json`), reloaded at the end.

`_assign_level` is batched over images as tensor ops (the JAX package
vmaps it). Level outputs are NHWC as FCOSDetector returns them; with more
levels than assignment ranges (the torchvision geometry's five) the loss
covers the first three, as in the JAX package. The forward runs under
autocast in `cuda.compute_dtype` with f32 parameters and BN statistics;
the head's outputs and the loss are f32.

Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.data.detection import get_detection_dataloader
from adam_dehaze_tpu_torch.models.detection import DetectionModel, create_detection_model
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training.common import (
    autocast,
    device_batch,
    device_prefetch,
    state_to_tree,
    tree_to_state,
)
from adam_dehaze_tpu_torch.training.logging import MetricsLogger
from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer, set_learning_rate

# Per-level max-offset ranges (stride 8, 16, 32); with the P2 level (stride
# 4) they shift down one octave so that boxes under 32 px assign to P2.
_LEVEL_RANGES = ((0.0, 64.0), (64.0, 128.0), (128.0, 1e8))
_LEVEL_RANGES_P2 = ((0.0, 32.0), (32.0, 64.0), (64.0, 128.0), (128.0, 1e8))


def level_ranges(n_levels: int):
    """The assignment ranges of a pyramid of `n_levels` (4 with p2)."""
    return _LEVEL_RANGES_P2 if n_levels == 4 else _LEVEL_RANGES


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss; targets are {0, 1} one-hot maps."""
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def _assign_level(boxes: torch.Tensor, labels: torch.Tensor, n_boxes: torch.Tensor, h: int,
                  w: int, stride: int, level_range, num_classes: int,
                  center_radius: float = 1.5):
    """FCOS target assignment of one pyramid level, for a batch.

    boxes (B, M, 4) xyxy padded, labels (B, M), n_boxes (B,). Returns
    (cls_target (B, H, W, C), box_target (B, H, W, 4), ctr_target (B, H, W),
    pos_mask (B, H, W)). A location is positive for the smallest valid box
    that contains it, whose largest offset falls in the level's range, and
    whose centre lies within center_radius * stride of it."""
    dev = boxes.device
    ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) * stride
    xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")           # (H, W)
    cy, cx = cy[None, :, :, None], cx[None, :, :, None]       # (1, H, W, 1)

    m = boxes.shape[1]
    valid = torch.arange(m, device=dev)[None] < n_boxes[:, None].long()   # (B, M)
    x1, y1, x2, y2 = (boxes[..., i][:, None, None, :] for i in range(4))  # (B, 1, 1, M)
    ltrb = torch.stack([cx - x1, cy - y1, x2 - cx, y2 - cy], dim=-1)     # (B, H, W, M, 4)
    inside = ltrb.amin(dim=-1) > 0
    max_off = ltrb.amax(dim=-1)
    in_range = (max_off >= level_range[0]) & (max_off <= level_range[1])
    rad = center_radius * stride
    near_center = ((cx - 0.5 * (x1 + x2)).abs() <= rad) & ((cy - 0.5 * (y1 + y2)).abs() <= rad)
    candidate = inside & near_center & in_range & valid[:, None, None, :]

    area = (x2 - x1) * (y2 - y1)
    cand_area = torch.where(candidate, area, torch.full_like(area, 1e18))
    best = cand_area.argmin(dim=-1)                                    # (B, H, W)
    pos = candidate.any(dim=-1)

    b = boxes.shape[0]
    best_ltrb = torch.gather(ltrb, 3, best[..., None, None].expand(-1, -1, -1, 1, 4))[..., 0, :]
    best_label = torch.gather(labels.long(), 1, best.reshape(b, -1)).reshape(best.shape)
    hot = torch.where(pos, best_label, torch.zeros_like(best_label))
    # jax.nn.one_hot: a label outside [0, C) gives a zero row.
    cls_target = (hot[..., None] == torch.arange(num_classes, device=dev)).float()
    cls_target = cls_target * pos[..., None]

    l_, t_, r_, b_ = best_ltrb.unbind(-1)
    lr_min, lr_max = torch.minimum(l_, r_), torch.maximum(l_, r_)
    tb_min, tb_max = torch.minimum(t_, b_), torch.maximum(t_, b_)
    ctr = torch.sqrt(((lr_min / lr_max.clamp_min(1e-6)) * (tb_min / tb_max.clamp_min(1e-6)))
                     .clamp(0, 1))
    return cls_target, best_ltrb, torch.where(pos, ctr, torch.zeros_like(ctr)), pos


def _overlap(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor):
    """(intersection, union) of center-offset boxes sharing an anchor."""
    pl_, pt, pr, pb = pred_ltrb.unbind(-1)
    tl, tt, tr, tb = target_ltrb.unbind(-1)
    p_area = (pl_ + pr) * (pt + pb)
    t_area = (tl + tr) * (tt + tb)
    iw = torch.minimum(pl_, tl) + torch.minimum(pr, tr)
    ih = torch.minimum(pt, tt) + torch.minimum(pb, tb)
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    return inter, p_area + t_area - inter


def _iou_loss(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor) -> torch.Tensor:
    """-log IoU of center-offset boxes (both >= 0)."""
    inter, union = _overlap(pred_ltrb, target_ltrb)
    iou = inter / union.clamp_min(1e-6)
    return -torch.log(iou.clamp(1e-6, 1.0))


def _giou_loss(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor) -> torch.Tensor:
    """1 - GIoU of center-offset boxes sharing an anchor point: IoU less
    the empty fraction of the smallest enclosing box, which keeps a
    gradient where prediction and target barely overlap."""
    inter, union = _overlap(pred_ltrb, target_ltrb)
    iou = inter / union.clamp_min(1e-6)
    ew = torch.maximum(pred_ltrb[..., 0], target_ltrb[..., 0]) + \
        torch.maximum(pred_ltrb[..., 2], target_ltrb[..., 2])
    eh = torch.maximum(pred_ltrb[..., 1], target_ltrb[..., 1]) + \
        torch.maximum(pred_ltrb[..., 3], target_ltrb[..., 3])
    enclose = (ew * eh).clamp_min(1e-6)
    return 1.0 - (iou - (enclose - union) / enclose)


def fcos_loss(level_outputs: Sequence[Dict], boxes: torch.Tensor, labels: torch.Tensor,
              n_boxes: torch.Tensor, num_classes: int) -> Dict[str, torch.Tensor]:
    """The FCOS loss of a batch over the pyramid levels.

    Classification and centerness are normalised by the positive count;
    the GIoU term is weighted by the centerness target and normalised by
    its sum. Returns {cls, box, ctr, total, n_pos}."""
    total_cls = total_box = total_ctr = total_pos = total_ctr_w = 0.0
    for lvl, rng in zip(level_outputs, level_ranges(len(level_outputs))):
        logits, offsets = lvl["logits"], lvl["offsets"]
        ctr_logits = lvl["centerness"][..., 0]
        _, h, w, c = logits.shape
        cls_t, box_t, ctr_t, pos = _assign_level(boxes, labels, n_boxes, h, w, lvl["stride"],
                                                 rng, c)
        posf = pos.float()
        total_cls = total_cls + sigmoid_focal_loss(logits, cls_t).sum()
        total_box = total_box + (_giou_loss(offsets, box_t) * ctr_t * posf).sum()
        total_ctr = total_ctr + (F.binary_cross_entropy_with_logits(
            ctr_logits, ctr_t, reduction="none") * posf).sum()
        total_pos = total_pos + posf.sum()
        total_ctr_w = total_ctr_w + (ctr_t * posf).sum()
    n_pos = total_pos.clamp_min(1.0)
    cls = total_cls / n_pos
    box = total_box / total_ctr_w.clamp_min(1e-6)
    ctr = total_ctr / n_pos
    return {"cls": cls, "box": box, "ctr": ctr, "total": cls + box + ctr, "n_pos": total_pos}


def _batch_loss(model, batch, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    with autocast(batch["hazy"].device, dtype):
        outs = model(batch["hazy"])
    return fcos_loss(outs, batch["boxes"], batch["labels"], batch["n_boxes"], model.num_classes)


def make_detection_train_step(dtype: torch.dtype = torch.float32):
    """step(state, batch) -> the loss components (detached): the detector
    in train mode (BN statistics update), the FCOS loss, backward, one Adam
    step."""
    def step(state: TrainState, batch):
        state.module.train()
        losses = _batch_loss(state.module, batch, dtype)
        state.optimizer.zero_grad(set_to_none=True)
        losses["total"].backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_detection_eval_step(dtype: torch.dtype = torch.float32):
    """step(state, batch) -> the total loss, the detector in eval mode."""
    @torch.no_grad()
    def step(state: TrainState, batch):
        state.module.eval()
        return _batch_loss(state.module, batch, dtype)["total"]

    return step


def epoch_learning_rate(base_lr: float, epoch: int, epochs: int) -> float:
    """A warmup epoch at 0.3x, then cosine from 1x down to 5 %."""
    if epoch == 0:
        return base_lr * 0.3
    t = (epoch - 1) / max(epochs - 1, 1)
    return base_lr * (0.05 + 0.95 * 0.5 * (1 + math.cos(math.pi * t)))


def train_detection(config, epochs: int = None, resume: bool = False, img_size: int = 512,
                    device="cuda") -> tuple:
    """Train the detector on the train split's clear frames (haze is then
    out of distribution, which is what the hazy-vs-dehazed mAP comparison
    measures); returns (DetectionModel, TrainState) with the best epoch's
    weights. `epochs` defaults to 1; the learning-rate schedule runs when
    there are more. The arguments are the JAX trainer's, in its order, with
    `device` last. The JAX trainer accepts `resume` and ignores it; here
    resume=True continues from the detection checkpoint directory's latest
    checkpoint (`find_latest_checkpoint`), at the epoch it was saved after,
    as the port's other trainers do."""
    device = torch.device(device)
    dtype = compute_dtype(config)
    det: DetectionModel = create_detection_model(config, device)
    det.init(torch.Generator().manual_seed(config["seed"] + 7), image_size=img_size)
    dc = config["detection"]
    state = TrainState(det.module, make_optimizer(det.module.parameters(), dc["learning_rate"],
                                                  dc.get("weight_decay", 0.0)))
    loader = get_detection_dataloader(config, split="train", img_size=img_size,
                                      image_source="clear", augment=True, shuffle=True)
    val_loader = get_detection_dataloader(config, split="val", img_size=img_size,
                                          image_source="clear")
    step = make_detection_train_step(dtype)
    val_step = make_detection_eval_step(dtype)
    logger = MetricsLogger(os.path.join(config.get("_logs_dir", "logs"), "detection"))
    ckpt_dir = dc["checkpoint_dir"]
    epochs = epochs if epochs is not None else 1
    best_val = float("nan")
    start_epoch = 0
    if resume:
        latest = ckpt.find_latest_checkpoint(ckpt_dir)
        if latest:
            tree, metrics = ckpt.load_checkpoint(latest)
            tree_to_state(state, tree)
            start_epoch = int(metrics.get("epoch", 0))
            best_val = float(metrics.get("val_loss", float("nan")))
            print(f"Resumed from {latest} at epoch {start_epoch}")
    base_lr = float(dc["learning_rate"])
    for epoch in range(start_epoch, epochs):
        if epochs > 1:
            set_learning_rate(state.optimizer, epoch_learning_rate(base_lr, epoch, epochs))
        loader.dataset.epoch = epoch      # reseeds the augmentation
        tots: List[torch.Tensor] = [step(state, batch)["total"]
                                    for batch in device_prefetch(loader, device)]
        avg = float(torch.stack(tots).mean()) if tots else float("nan")
        vals = [float(val_step(state, device_batch(b, device))) for b in val_loader]
        val_loss = float(np.mean(vals)) if vals else float("nan")
        logger.scalars(epoch, {"train/loss": avg, "val/loss": val_loss})
        print(f"[detection] Epoch {epoch + 1}/{epochs}: loss={avg:.4f} val_loss={val_loss:.4f}")
        if not np.isfinite(best_val) or (np.isfinite(val_loss) and val_loss < best_val):
            best_val = val_loss
            ckpt.save_checkpoint(ckpt_dir, "best_model", state_to_tree(state),
                                 {"epoch": epoch + 1, "loss": avg, "val_loss": val_loss})
    best = ckpt.best_model_path(ckpt_dir)
    if os.path.exists(best):
        tree_to_state(state, ckpt.load_checkpoint(best)[0])
    state.module.eval()
    logger.close()
    return det, state
