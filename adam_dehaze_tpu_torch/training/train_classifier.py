"""Fog-intensity classifier training of the port.

Counterpart of adam_dehaze_tpu/training/train_classifier.py: Adam (lr and
weight decay from `classifier`, 1e-4 each by default), cross-entropy,
the plateau scheduler (0.5, patience 5) on the validation loss, a
best-by-validation-accuracy checkpoint and one every 5 epochs; `resume`
continues from the latest.

- The train step: optional re-fogging (`classifier.refog`, off by
  default: `data/synthetic.py:refog_batch`), augmentation with
  `classifier.jitter` (default 0.1), the head's dropouts drawing from the
  step's `torch.Generator`, all under autocast in `cuda.compute_dtype` with
  f32 parameters and BN statistics.
- `classifier.pretrained`: a path to a port `.pth` (a whole classifier, or
  a backbone under `backbone.*` or torchvision's own resnet keys) loads it;
  `true` asks for torchvision's ImageNet weights, which the repository does
  not hold: a warned no-op, as in the JAX package.
- `evaluate_classifier` builds the confusion matrix and the per-class
  report with numpy (the JAX package asks sklearn, which the card's
  machine lacks), in sklearn's `classification_report(output_dict=True,
  zero_division=0)` layout.

Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.data.augment import augment_triplet
from adam_dehaze_tpu_torch.data.dataset import get_dataloader
from adam_dehaze_tpu_torch.data.synthetic import refog_batch
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.parallel.multihost import all_hosts_mean_tree
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
from adam_dehaze_tpu_torch.training.state import (
    ReduceLROnPlateau,
    TrainState,
    get_learning_rate,
    make_optimizer,
)

CLASS_NAMES = ("low", "medium", "high")


def _load_pretrained(model, path: str) -> None:
    """Fill the classifier from a port `.pth`: a whole classifier (it has
    head keys `classifier.*`), or a backbone alone."""
    state, _ = ckpt.load_checkpoint(path)
    state = state.get("model", state)
    if any(k.startswith("classifier.") for k in state):
        model.load_state_dict(state)
        print(f"Loaded full pretrained classifier from {path}")
        return
    model.backbone.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()
                                    if not k.startswith("fc.")})
    print(f"Loaded pretrained backbone from {path}")


def init_classifier(config, device) -> torch.nn.Module:
    """The classifier, seeded from `seed` (flax's default init), with
    `classifier.pretrained` applied, on `device`."""
    model = init_params_(create_classifier(config),
                         torch.Generator().manual_seed(config["seed"]))
    pre = config["classifier"].get("pretrained")
    if isinstance(pre, str) and pre:
        _load_pretrained(model, pre)
    elif pre is True:
        print("classifier.pretrained=true ignored: torchvision ImageNet weights are "
              "not available; pass the path of a classifier .pth instead")
    return model.to(device)


def make_train_step(augmentation: bool = True, jitter: float = 0.1,
                    refog: dict | None = None, dtype: torch.dtype = torch.float32):
    """step(state, batch, generator) -> {"loss", "acc"} (detached): refog,
    augment, forward in train mode and cross-entropy under autocast,
    backward, one Adam step. `generator` (on the batch's device) feeds the
    refog, the augmentation and the dropouts, in that order."""
    def step(state: TrainState, batch, generator=None):
        if refog and refog.get("prob", 0.0) > 0 and "clear" in batch:
            batch = refog_batch(generator, batch, prob=float(refog.get("prob", 0.5)),
                                boundary_frac=float(refog.get("boundary_frac", 0.5)),
                                margin=float(refog.get("margin", 0.08)))
        if augmentation:
            batch = augment_triplet(generator, batch, brightness=jitter, contrast=jitter)
        labels = batch["intensity"].long()
        with autocast(batch["hazy"].device, dtype):
            logits, _ = state.module(batch["hazy"], generator)
            loss = F.cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return step


def make_eval_step(dtype: torch.dtype = torch.float32):
    """step(state, batch) -> {loss, acc, n, pred} over the batch's valid
    rows, the module in eval mode."""
    @torch.no_grad()
    def step(state: TrainState, batch):
        state.module.eval()
        dev = batch["hazy"].device
        with autocast(dev, dtype):
            logits, _ = state.module(batch["hazy"])
        labels = batch["intensity"].long()
        per = F.cross_entropy(logits.float(), labels, reduction="none")
        pred = logits.argmax(-1)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape[0], dtype=torch.bool, device=dev)
        return {"loss": masked_mean(per, mask),
                "acc": masked_mean((pred == labels).float(), mask),
                "n": mask.sum(), "pred": pred}

    return step


def train_classifier(config, resume: bool = False, device="cuda"):
    """Train the classifier; returns (model, state) with the best-by-val-
    accuracy weights loaded."""
    device = torch.device(device)
    dtype = compute_dtype(config)
    cc = config["classifier"]
    model = init_classifier(config, device)
    state = TrainState(model, make_optimizer(model.parameters(), cc["learning_rate"],
                                             cc["weight_decay"]))
    ckpt_dir = cc["checkpoint_dir"]
    logger = MetricsLogger(os.path.join(config.get("_logs_dir", "logs"), "classifier"))
    scheduler = ReduceLROnPlateau(factor=0.5, patience=5)

    start_epoch, best_val_acc = 0, 0.0
    if resume:
        latest = ckpt.find_latest_checkpoint(ckpt_dir)
        if latest:
            tree, metrics = ckpt.load_checkpoint(latest)
            tree_to_state(state, tree)
            start_epoch = int(metrics.get("epoch", 0))
            best_val_acc = metrics.get("best_val_acc", 0.0)
            print(f"Resumed from {latest} at epoch {start_epoch}")

    train_loader = get_dataloader(config, "train")
    val_loader = get_dataloader(config, "val")
    train_step = make_train_step(config["dataset"].get("augmentation", True),
                                 jitter=cc.get("jitter", 0.1), refog=cc.get("refog"),
                                 dtype=dtype)
    eval_step = make_eval_step(dtype)
    # The refog, augmentation and dropout draws, on the batches' device.
    gen = torch.Generator(device).manual_seed(config["seed"])

    epochs = cc["epochs"]
    for epoch in range(start_epoch, epochs):
        model.train()
        losses, accs = [], []
        for batch in device_prefetch(train_loader, device):
            m = train_step(state, batch, gen)
            losses.append(m["loss"])
            accs.append(m["acc"])
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        train_acc = float(torch.stack(accs).mean()) if accs else float("nan")

        val = evaluate_classifier_pass(eval_step, state, val_loader, device)
        scheduler.step(val["loss"], state.optimizer)
        logger.scalars(epoch, {"train/loss": train_loss, "train/acc": train_acc,
                               "val/loss": val["loss"], "val/acc": val["acc"],
                               "lr": get_learning_rate(state.optimizer)})
        print(f"Epoch {epoch + 1}/{epochs}: train_loss={train_loss:.4f} "
              f"train_acc={train_acc:.4f} val_loss={val['loss']:.4f} "
              f"val_acc={val['acc']:.4f}")

        if val["acc"] > best_val_acc:
            best_val_acc = val["acc"]
            ckpt.save_checkpoint(ckpt_dir, "best_model", state_to_tree(state),
                                 {"epoch": epoch + 1, "val_acc": val["acc"],
                                  "val_loss": val["loss"], "best_val_acc": best_val_acc})
        if (epoch + 1) % 5 == 0:
            ckpt.save_checkpoint(ckpt_dir, f"checkpoint_epoch_{epoch + 1}",
                                 state_to_tree(state),
                                 {"epoch": epoch + 1, "val_acc": val["acc"],
                                  "best_val_acc": best_val_acc})

    best = ckpt.best_model_path(ckpt_dir)
    if os.path.exists(best):
        tree_to_state(state, ckpt.load_checkpoint(best)[0])
    logger.close()
    return model, state


def evaluate_classifier_pass(eval_step, state: TrainState, loader, device) -> Dict[str, float]:
    """Mean loss and accuracy over a loader's valid rows, averaged across
    processes under a process group (the identity in one process)."""
    tot_loss, tot_acc, tot_n = 0.0, 0.0, 0
    for batch in loader:
        m = eval_step(state, device_batch(batch, device))
        n = int(m["n"])
        tot_loss += float(m["loss"]) * n
        tot_acc += float(m["acc"]) * n
        tot_n += n
    return all_hosts_mean_tree({"loss": tot_loss / max(tot_n, 1),
                                "acc": tot_acc / max(tot_n, 1)})


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, n_classes: int = 3) -> np.ndarray:
    """counts[true, predicted], as sklearn's confusion_matrix with
    labels=range(n_classes)."""
    counts = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(counts, (np.asarray(labels, np.int64), np.asarray(preds, np.int64)), 1)
    return counts


def classification_report(cm: np.ndarray, names=CLASS_NAMES) -> Dict:
    """Per-class precision, recall, f1-score and support, accuracy, and the
    macro and weighted averages from a confusion matrix, in sklearn's
    output_dict layout with zero_division=0."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)

    def ratio(num, den):
        return np.divide(num, den, out=np.zeros_like(num), where=den > 0)

    precision, recall = ratio(tp, predicted), ratio(tp, support)
    f1 = ratio(2 * tp, predicted + support)
    report = {name: {"precision": float(precision[i]), "recall": float(recall[i]),
                     "f1-score": float(f1[i]), "support": int(support[i])}
              for i, name in enumerate(names)}
    total = int(support.sum())
    report["accuracy"] = float(tp.sum() / total) if total else 0.0
    metrics = {"precision": precision, "recall": recall, "f1-score": f1}
    report["macro avg"] = {k: float(v.mean()) for k, v in metrics.items()}
    report["weighted avg"] = {k: float((v * support).sum() / total) if total else 0.0
                              for k, v in metrics.items()}
    report["macro avg"]["support"] = report["weighted avg"]["support"] = total
    return report


def evaluate_classifier(model, state: TrainState, config) -> Dict:
    """Test-split accuracy and loss with the confusion matrix and the
    per-class report, on the device the weights are on."""
    device = next(state.module.parameters()).device
    loader = get_dataloader(config, "test")
    eval_step = make_eval_step(compute_dtype(config))
    preds, labels = [], []
    tot_loss, tot_acc, tot_n = 0.0, 0.0, 0
    for batch in loader:
        m = eval_step(state, device_batch(batch, device))
        n = int(m["n"])
        tot_loss += float(m["loss"]) * n
        tot_acc += float(m["acc"]) * n
        tot_n += n
        mask = batch["mask"]
        preds.append(m["pred"].cpu().numpy()[mask])
        labels.append(batch["intensity"][mask])
    preds = np.concatenate(preds) if preds else np.zeros(0, np.int64)
    labels = np.concatenate(labels) if labels else np.zeros(0, np.int64)
    cm = confusion_matrix(labels, preds)
    result = {"accuracy": tot_acc / max(tot_n, 1), "loss": tot_loss / max(tot_n, 1),
              "confusion_matrix": cm.tolist(), "report": classification_report(cm)}
    print(f"Test accuracy: {result['accuracy']:.4f}")
    return result
