"""Plain PyTorch reference of ADAM-Dehaze's router: the fog classifier and
the three branches a configuration names.

It follows the published description of the upstream ADAM-Dehaze models
(talha-alam/ADAM-Dehaze, `models/`), layer for layer, with the state-dict
key names of the upstream checkpoints, so that one state dict made by the
benchmark loads into this reference and into the program under test alike.
It imports nothing of the program and runs no hand-written kernel: every
operation is a stock torch operation computed in the dtype of its input
(float32 for the comparison), NCHW inside, NHWC float images in [0, 1] in
and out.

Each branch type is a file of its own, `branches/<model_type>.py` with its
class as `MODEL`, and each classifier backbone `backbones/<name>.py` with
its class as `BACKBONE`; the router finds them by the configuration's
names, so a new branch type or backbone is a new file.
"""
from __future__ import annotations

import importlib
from pathlib import Path

import torch
from torch import nn

from perfbench.reference.layers import Linear, nchw

INTENSITY_ORDER = ("low", "medium", "high")
HERE = Path(__file__).resolve().parent


def _by_name(kind: str, name: str, attr: str):
    if not (HERE / kind / f"{name}.py").is_file():
        raise KeyError(f"the reference has no {kind}/{name}.py")
    return getattr(importlib.import_module(f"perfbench.reference.{kind}.{name}"), attr)


def branch(model_type: str) -> type:
    """The reference class of a branch type: `branches/<model_type>.py`."""
    return _by_name("branches", model_type, "MODEL")


def backbone(name: str) -> type:
    """The reference class of a classifier backbone: `backbones/<name>.py`."""
    return _by_name("backbones", name, "BACKBONE")


class Dropout(nn.Module):
    """Dropout whose mask is drawn by bernoulli_ from the generator passed
    with each call (identity in eval mode)."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=generator)
        return x * keep / (1.0 - self.p)


class FogIntensityClassifier(nn.Module):
    """Backbone, then Dropout(.3) -> Linear(256) -> ReLU -> Dropout(.2) ->
    Linear(classes). forward(x NHWC) -> (logits, features)."""

    def __init__(self, model="resnet18", num_classes=3):
        super().__init__()
        self.backbone = backbone(model)()
        self.classifier = nn.Sequential(
            Dropout(0.3), Linear(self.backbone.feature_dim, 256), nn.ReLU(), Dropout(0.2),
            Linear(256, num_classes))

    def forward(self, x, generator=None):
        drop0, fc0, relu, drop1, fc1 = self.classifier
        features = self.backbone(nchw(x))
        return fc1(drop1(relu(fc0(drop0(features, generator))), generator)), features


class Router(nn.Module):
    """The classifier and the three branches under the upstream's keys
    (`classifier.*`, `models.{low,medium,high}.*`)."""

    def __init__(self, config: dict):
        super().__init__()
        self.classifier = FogIntensityClassifier(config["classifier"]["model"],
                                                 config["classifier"]["num_classes"])
        self.models = nn.ModuleDict({
            lvl: branch(config["dehazing"][lvl]["model_type"])(
                config["dehazing"][lvl]["channels"], config["dehazing"][lvl]["blocks"])
            for lvl in INTENSITY_ORDER})
