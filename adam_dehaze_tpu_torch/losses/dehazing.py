"""The dehazing and joint losses of the port.

Counterparts of DehazingLoss and JointLoss in
adam_dehaze_tpu/losses/dehazing.py:

    total = lambda_l1 * L1 + lambda_content * VGG-MSE + lambda_perceptual * LPIPS

with the optional density-weighted L1 (per-pixel weights 1 + lambda_density
* fog density of the hazy input, no gradient through the weights): a ratio
of sums over the batch, summed over the processes of a data-parallel step
(parallel/data_parallel.py:batch_sum), so that it is the global batch's.
On a shard the other terms are the process's share of the global mean
(parallel/data_parallel.py) and LPIPS runs on the image gathered whole
(losses/lpips.py). The
feature nets are frozen modules made by `init` (seeded, `requires_grad`
off, eval mode) and passed to `__call__`, as the JAX loss takes its frozen
parameters; the VGG trunk runs once per call over the concatenated pair.
Without `loss.vgg_weights` / `loss.lpips_weights` the nets are random
surrogates, as in the JAX package.

JointLoss adds the classifier's cross-entropy and a detection term:

    total = lambda_dehazing * dehazing + lambda_classification * CE
            + lambda_detection * detection
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.data.synthetic import fog_density_map
from adam_dehaze_tpu_torch.losses.lpips import LPIPS, lpips_from_unit_range
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.nn.vgg import VGG16Features
from adam_dehaze_tpu_torch.parallel.data_parallel import batch_sum

CONTENT_TAPS = ("relu2_2", "relu3_3", "relu4_3")


def _load_frozen(module: torch.nn.Module, path: str) -> None:
    """Fill a loss net from a `.pth` written by `save_checkpoint` or
    holding a plain state_dict (a torchvision VGG16's own keys fill
    VGG16Features); every parameter of the net must be present."""
    from adam_dehaze_tpu_torch.training.checkpoint import load_checkpoint
    state, _ = load_checkpoint(path)
    state = state.get("state_dict", state)
    own = module.state_dict()
    missing = [k for k in own if k not in state]
    if missing:
        raise ValueError(f"{path} lacks {missing[:5]} of {type(module).__name__}")
    module.load_state_dict({k: state[k] for k in own})


class DehazingLoss:
    """Combined reconstruction loss. `init` makes the frozen feature nets,
    which `__call__` takes as `loss_params`."""

    def __init__(self, lambda_l1: float = 1.0, lambda_content: float = 0.1,
                 lambda_perceptual: float = 0.1, density_weighted: bool = False,
                 lambda_density: float = 0.1, vgg_weights: Optional[str] = None,
                 lpips_weights: Optional[str] = None):
        self.lambda_l1 = lambda_l1
        self.lambda_content = lambda_content
        self.lambda_perceptual = lambda_perceptual
        self.density_weighted = density_weighted
        self.lambda_density = lambda_density
        self.vgg_weights = vgg_weights
        self.lpips_weights = lpips_weights

    def init(self, generator: torch.Generator, device="cpu") -> Dict[str, torch.nn.Module]:
        """The frozen feature nets {"content": VGG16Features, "lpips":
        LPIPS}, seeded from `generator` (flax's default init: lecun-normal
        kernels, zero biases, LPIPS heads 1/C), or loaded from the
        configured weight files."""
        nets = {"content": VGG16Features(taps=CONTENT_TAPS), "lpips": LPIPS()}
        for net in nets.values():
            init_params_(net, generator)
        if self.vgg_weights:
            _load_frozen(nets["content"], self.vgg_weights)
        if self.lpips_weights:
            _load_frozen(nets["lpips"], self.lpips_weights)
        for net in nets.values():
            net.requires_grad_(False).eval().to(device)
        return nets

    def content(self, loss_params, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        n = pred.shape[0]
        f = loss_params["content"](torch.cat([pred, target], dim=0))
        losses = [((f[t][:n] - f[t][n:]) ** 2).mean() for t in CONTENT_TAPS]
        return sum(losses) / len(losses)

    def __call__(self, loss_params, pred: torch.Tensor, target: torch.Tensor,
                 hazy: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        err = (pred - target).abs()
        if self.density_weighted and hazy is not None:
            with torch.no_grad():
                density = fog_density_map(hazy.float())
            w = 1.0 + self.lambda_density * density[..., None]
            l1 = batch_sum((w * err).sum()) / batch_sum((w * torch.ones_like(err)).sum())
        else:
            l1 = err.mean()
        content = self.content(loss_params, pred, target)
        perceptual = lpips_from_unit_range(loss_params["lpips"], pred, target).mean()
        total = (self.lambda_l1 * l1 + self.lambda_content * content
                 + self.lambda_perceptual * perceptual)
        return total, {"l1": l1, "content": content, "perceptual": perceptual,
                       "total": total}


def get_dehazing_loss(config) -> DehazingLoss:
    """The `loss` section of the config as a DehazingLoss. The compute dtype
    is not the loss's: the trainer's autocast region covers it."""
    loss_cfg = config.get("loss", {})
    return DehazingLoss(
        lambda_l1=loss_cfg.get("lambda_l1", 1.0),
        lambda_content=loss_cfg.get("lambda_content", 0.1),
        lambda_perceptual=loss_cfg.get("lambda_perceptual", 0.1),
        density_weighted=loss_cfg.get("density_weighted", False),
        lambda_density=loss_cfg.get("lambda_density", 0.1),
        vgg_weights=loss_cfg.get("vgg_weights") or None,
        lpips_weights=loss_cfg.get("lpips_weights") or None,
    )


class JointLoss:
    """Dehazing + classification (+ detection passthrough) loss. `init`
    makes the dehazing loss's frozen nets, which `__call__` takes as
    `loss_params`."""

    def __init__(self, lambda_dehazing: float = 1.0,
                 lambda_classification: float = 0.2,
                 lambda_detection: float = 0.5,
                 dehazing_loss: Optional[DehazingLoss] = None):
        self.lambda_dehazing = lambda_dehazing
        self.lambda_classification = lambda_classification
        self.lambda_detection = lambda_detection
        self.dehazing_loss = dehazing_loss or DehazingLoss()

    def init(self, generator: torch.Generator, device="cpu") -> Dict[str, torch.nn.Module]:
        return self.dehazing_loss.init(generator, device)

    def __call__(self, loss_params, pred: torch.Tensor, target_clear: torch.Tensor,
                 pred_intensity: Optional[torch.Tensor] = None,
                 target_intensity: Optional[torch.Tensor] = None,
                 detection_loss: Optional[torch.Tensor] = None,
                 hazy: Optional[torch.Tensor] = None):
        """(total, {dehazing, classification, detection, total,
        dehazing_components}); the CE term only when both the logits and
        the labels are given, 0 otherwise."""
        dh, dh_components = self.dehazing_loss(loss_params, pred, target_clear, hazy=hazy)
        zero = torch.zeros((), dtype=torch.float32, device=pred.device)
        if pred_intensity is not None and target_intensity is not None:
            cls = F.cross_entropy(pred_intensity.float(), target_intensity.long())
        else:
            cls = zero
        det = detection_loss if detection_loss is not None else zero
        total = (self.lambda_dehazing * dh + self.lambda_classification * cls
                 + self.lambda_detection * det)
        return total, {"dehazing": dh, "classification": cls, "detection": det,
                       "total": total, "dehazing_components": dh_components}


def get_joint_loss(config) -> JointLoss:
    """The `joint_training` lambdas over the config's DehazingLoss."""
    jt = config["joint_training"]
    return JointLoss(lambda_dehazing=jt["lambda_dehazing"],
                     lambda_classification=jt["lambda_classification"],
                     lambda_detection=jt["lambda_detection"],
                     dehazing_loss=get_dehazing_loss(config))
