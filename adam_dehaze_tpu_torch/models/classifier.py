"""Fog-intensity classifier and dense feature extractor.

Counterpart of adam_dehaze_tpu/models/classifier.py, every backbone of it:
resnet18/34/50 (nn/resnet.py), mobilenet_v2 and mobilenet_v3_{small,large}
(nn/mobilenet.py), efficientnet_b0..b3 (nn/efficientnet.py). Key names
follow the reference: `backbone.*` (torchvision's, or timm's for
EfficientNet) and the head `classifier.{1,4}`. forward(x NHWC, generator)
-> (logits f32, features f32). In train mode the head's two dropouts draw
their masks from the `torch.Generator` the train step passes in, as the JAX
step passes a dropout key; in eval mode they are the identity.
"""
from __future__ import annotations

from torch import nn

from adam_dehaze_tpu_torch.nn.blocks import Dropout
from adam_dehaze_tpu_torch.nn.efficientnet import EfficientNet
from adam_dehaze_tpu_torch.nn.mobilenet import MobileNetV2, MobileNetV3
from adam_dehaze_tpu_torch.nn.resnet import resnet18, resnet34, resnet50

_RESNETS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}
_BACKBONES = {
    **_RESNETS,
    "mobilenet_v2": MobileNetV2,
    "mobilenet_v3_small": lambda: MobileNetV3("small"),
    "mobilenet_v3_large": lambda: MobileNetV3("large"),
    **{f"efficientnet_b{i}": (lambda v: lambda: EfficientNet(v))(f"b{i}") for i in range(4)},
}


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
        # The compute dtype: the head's, which a serving copy casts with the
        # backbone's convolutions (ops/serving_apply.py).
        drop0, fc0, relu, drop1, fc1 = self.classifier
        dt = fc0.weight.dtype
        features = self.backbone(x.to(dt).permute(0, 3, 1, 2))
        h = drop1(relu(fc0(drop0(features.to(dt), generator))), generator)
        return fc1(h).float(), features


class DenseFeatureExtractor(nn.Module):
    """The last stage's map of a ResNet backbone, no pooling and no head:
    forward(x NHWC) -> (B, H/32, W/32, C) NHWC float32. The reference
    defines it and no pipeline uses it; here for the API's sake."""

    def __init__(self, model_name: str = "resnet18"):
        super().__init__()
        if model_name not in _RESNETS:
            raise ValueError(f"Unsupported model for feature extraction: {model_name}")
        self.model_name = model_name
        self.backbone = _RESNETS[model_name]()

    def forward(self, x):
        x = x.to(self.backbone.conv1.weight.dtype).permute(0, 3, 1, 2)
        _, stages = self.backbone(x, return_stages=True)
        return stages[-1].permute(0, 2, 3, 1).float()


def create_classifier(config) -> FogIntensityClassifier:
    """The classifier of `config`, float32 (a serving copy takes the
    compute dtype: ops/serving_apply.py)."""
    return FogIntensityClassifier(config["classifier"]["model"],
                                  config["classifier"]["num_classes"])
