"""Fog-intensity classifier.

Counterpart of adam_dehaze_tpu/models/classifier.py for the resnet
backbones (the MobileNet and EfficientNet backbones come later). Key names
follow the reference: `backbone.*` (torchvision) and the head
`classifier.{1,4}`. forward(x NHWC, generator) -> (logits f32, features
f32). In train mode the head's two dropouts draw their masks from the
`torch.Generator` the train step passes in, as the JAX step passes a
dropout key; in eval mode they are the identity.
"""
from __future__ import annotations

from torch import nn

from adam_dehaze_tpu_torch.nn.blocks import Dropout
from adam_dehaze_tpu_torch.nn.resnet import resnet18, resnet34, resnet50

_BACKBONES = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}


class FogIntensityClassifier(nn.Module):
    """3-way fog-intensity classifier; forward -> (logits, features)."""

    def __init__(self, model_name: str = "resnet18", num_classes: int = 3):
        super().__init__()
        if model_name not in _BACKBONES:
            raise ValueError(f"Unsupported model: {model_name}")
        self.model_name = model_name
        self.backbone = _BACKBONES[model_name]()
        # Dropout(.3) -> Linear(256) -> ReLU -> Dropout(.2) -> Linear(C).
        self.classifier = nn.Sequential(
            Dropout(0.3), nn.Linear(self.backbone.feature_dim, 256),
            nn.ReLU(), Dropout(0.2), nn.Linear(256, num_classes))

    @property
    def feature_dim(self) -> int:
        return self.backbone.feature_dim

    def forward(self, x, generator=None):
        dt = self.backbone.conv1.weight.dtype
        features = self.backbone(x.to(dt).permute(0, 3, 1, 2))
        drop0, fc0, relu, drop1, fc1 = self.classifier
        h = drop1(relu(fc0(drop0(features.to(dt), generator))), generator)
        return fc1(h).float(), features


def create_classifier(config) -> FogIntensityClassifier:
    """The classifier of `config`, float32 (a serving copy takes the
    compute dtype: ops/serving_apply.py)."""
    return FogIntensityClassifier(config["classifier"]["model"],
                                  config["classifier"]["num_classes"])
