"""Object detection stage and the integrated dehaze->detect system.

Counterpart of adam_dehaze_tpu/models/detection.py: an anchor-free
single-stage detector (FCOS-style) on a ResNet backbone and a feature
pyramid, with the same two geometries:

- native: P3-P5 (optionally P2), a 2-conv tower per branch, softplus
  offsets;
- `torchvision_compat` (model names `tv_*`): 256 channels, P3-P7 with the
  `p6`/`p7` convs, 4-conv towers with GroupNorm(32), raw offsets.

One head module serves every level (flax shares `FCOSHead_0` the same way);
offsets are multiplied by the level's stride. Module names follow the
flax tree (`backbone` = ResNet_0, `fpn.lateral{i}`, `fpn.smooth{i}`,
`head.cls{i}`, ...), so `training/checkpoint.py:load_flax_variables` maps
one onto the other.

Level outputs are NHWC, as the JAX package's: {logits (B, H, W, C),
offsets (B, H, W, 4) in pixels, centerness (B, H, W, 1), stride}, f32.
Sigmoid scoring and the per-level top-k run on the device
(`_device_topk`), so only (B, k) candidates per level cross to the host, in
one copy per call; decoding and NMS are numpy on the host, as in the JAX
package. The top-k is a stable descending sort over the level's locations:
among equal scores the lower index comes first, as `lax.top_k` orders them
(`torch.topk` promises no order for ties).

Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adam_dehaze_tpu_torch.config import compute_dtype
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.nn.resnet import resnet18, resnet34, resnet50
from adam_dehaze_tpu_torch.training.common import autocast

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_BACKBONES = {
    "fcos_resnet18_fpn": resnet18,
    "fcos_resnet34_fpn": resnet34,
    "fcos_resnet50_fpn": resnet50,
    # The reference configuration's names map onto this detector.
    "faster_rcnn_resnet50_fpn": resnet50,
    "faster_rcnn_mobilenet_v3_large_fpn": resnet18,
    # torchvision's fcos_resnet50_fpn geometry (torchvision_compat).
    "tv_fcos_resnet50_fpn": resnet50,
}

# flax's nn.GroupNorm epsilon (torch's default is 1e-5).
_GN_EPS = 1e-6


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """NHWC images in [0, 1] -> ImageNet-normalised float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() - mean) / std


class FPN(nn.Module):
    """Top-down feature pyramid over backbone stages (C3..C5, or C2..C5)
    -> P3..P5; with `extra_levels`, P6/P7 by stride-2 3x3 convs on P5 and
    relu(P6) (torchvision's LastLevelP6P7 with use_P5=True).

    The top-down upsampling is nearest with half-pixel centres
    (`jax.image.resize(..., "nearest")`, torch's "nearest-exact"): the two
    conventions differ where an input side is not a multiple of 32."""

    def __init__(self, in_channels: Sequence[int], channels: int = 128,
                 extra_levels: bool = False):
        super().__init__()
        self.n_levels = len(in_channels)
        self.extra_levels = extra_levels
        for i, cin in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(cin, channels, 1))
            setattr(self, f"smooth{i}", nn.Conv2d(channels, channels, 3, padding=1))
        if extra_levels:
            self.p6 = nn.Conv2d(channels, channels, 3, 2, 1)
            self.p7 = nn.Conv2d(channels, channels, 3, 2, 1)

    def forward(self, stages: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral{i}")(s) for i, s in enumerate(stages)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = F.interpolate(outs[0], size=lat.shape[-2:], mode="nearest-exact")
            outs.insert(0, lat + up)
        smoothed = [getattr(self, f"smooth{i}")(o) for i, o in enumerate(outs)]
        if self.extra_levels:
            p6 = self.p6(smoothed[-1])
            smoothed += [p6, self.p7(torch.relu(p6))]
        return smoothed


class FCOSHead(nn.Module):
    """Shared head: class logits, box offsets (l, t, r, b), centerness.

    `tower_convs=4, group_norm=True, softplus=False` is torchvision's FCOS
    tower (4x conv3x3 + GroupNorm(32) + ReLU, raw offsets); the native
    default is 2 plain conv + ReLU and softplus offsets. Returns NCHW
    float32 maps."""

    def __init__(self, num_classes: int, channels: int = 128, tower_convs: int = 2,
                 group_norm: bool = False, softplus: bool = True):
        super().__init__()
        self.tower_convs = tower_convs
        self.group_norm = group_norm
        self.softplus = softplus
        for i in range(tower_convs):
            for branch in ("cls", "reg"):
                setattr(self, f"{branch}{i}", nn.Conv2d(channels, channels, 3, padding=1))
                if group_norm:
                    setattr(self, f"{branch}_gn{i}", nn.GroupNorm(32, channels, eps=_GN_EPS))
        self.cls_out = nn.Conv2d(channels, num_classes, 3, padding=1)
        self.reg_out = nn.Conv2d(channels, 4, 3, padding=1)
        self.ctr_out = nn.Conv2d(channels, 1, 3, padding=1)

    def forward(self, feat: torch.Tensor):
        cls, reg = feat, feat
        for i in range(self.tower_convs):
            cls = getattr(self, f"cls{i}")(cls)
            reg = getattr(self, f"reg{i}")(reg)
            if self.group_norm:
                cls = getattr(self, f"cls_gn{i}")(cls)
                reg = getattr(self, f"reg_gn{i}")(reg)
            cls, reg = torch.relu(cls), torch.relu(reg)
        logits = self.cls_out(cls)
        raw = self.reg_out(reg)
        offsets = F.softplus(raw) if self.softplus else raw
        return logits.float(), offsets.float(), self.ctr_out(reg).float()


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class FCOSDetector(nn.Module):
    """Backbone + FPN + shared FCOS head over the pyramid levels.

    forward(x NHWC) -> one dict per level (see the module docstring).
    `torchvision_compat` switches to torchvision's fcos_resnet50_fpn
    geometry; `p2` extends the native pyramid down to stride 4 (from the
    backbone's C2) and is ignored in that geometry. Train and eval mode
    (the backbone's BN) follow `module.train()` / `module.eval()`."""

    def __init__(self, num_classes: int = 91, backbone_name: str = "fcos_resnet18_fpn",
                 channels: int = 128, torchvision_compat: bool = False, p2: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = _BACKBONES[backbone_name]()
        tv = torchvision_compat
        self.lo = 0 if (p2 and not tv) else 1
        expansion = self.backbone.feature_dim // 512
        widths = [w * expansion for w in (64, 128, 256, 512)]
        self.fpn = FPN(widths[self.lo:], channels, extra_levels=tv)
        self.head = FCOSHead(num_classes, channels, tower_convs=4 if tv else 2,
                             group_norm=tv, softplus=not tv)
        self.strides = ((8, 16, 32, 64, 128) if tv
                        else ((4, 8, 16, 32) if self.lo == 0 else (8, 16, 32)))

    def forward(self, x: torch.Tensor) -> List[Dict]:
        x = x.to(self.backbone.conv1.weight.dtype).permute(0, 3, 1, 2)
        _, stages = self.backbone(x, return_stages=True)
        outs = []
        for feat, stride in zip(self.fpn(stages[self.lo:]), self.strides):
            logits, offsets, ctr = self.head(feat)
            outs.append({"logits": _nhwc(logits), "offsets": _nhwc(offsets) * stride,
                         "centerness": _nhwc(ctr), "stride": stride})
        return outs


@torch.no_grad()
def init_detector_(module: FCOSDetector, generator: torch.Generator) -> FCOSDetector:
    """Seeded init in place (flax's defaults, `nn/blocks.py:init_params_`),
    with the class logits' bias at -4, as the JAX head's `cls_out`."""
    init_params_(module, generator)
    module.head.cls_out.bias.fill_(-4.0)
    return module


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def decode_detections(level_outputs, score_threshold: float = 0.05,
                      nms_iou: float = 0.5, max_dets: int = 100,
                      image_size: Optional[Tuple[int, int]] = None
                      ) -> List[Dict[str, np.ndarray]]:
    """Host-side decode of dense predictions -> per-image detection dicts.

    Class index 0 is background (torchvision COCO convention, 91 classes).
    Level maps may be tensors or numpy arrays (NHWC)."""
    def host(a):
        return np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, np.float32)

    batch = host(level_outputs[0]["logits"]).shape[0]
    all_boxes = [[] for _ in range(batch)]
    all_scores = [[] for _ in range(batch)]
    all_labels = [[] for _ in range(batch)]
    for lvl in level_outputs:
        logits = host(lvl["logits"])
        offsets = host(lvl["offsets"])
        ctr = host(lvl["centerness"])
        stride = int(lvl["stride"])
        b, h, w, c = logits.shape
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        cx = (xs + 0.5) * stride
        cy = (ys + 0.5) * stride
        probs = _sigmoid(logits) * _sigmoid(ctr)
        probs[..., 0] = 0.0  # background
        for n in range(b):
            keep = probs[n].max(-1) > score_threshold
            if not keep.any():
                continue
            yy, xx = np.nonzero(keep)
            p = probs[n, yy, xx]
            labels = p.argmax(-1)
            scores = p.max(-1)
            off = offsets[n, yy, xx]
            boxes = np.stack([cx[yy, xx] - off[:, 0], cy[yy, xx] - off[:, 1],
                              cx[yy, xx] + off[:, 2], cy[yy, xx] + off[:, 3]], axis=1)
            if image_size is not None:
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, image_size[1])
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, image_size[0])
            all_boxes[n].append(boxes)
            all_scores[n].append(scores)
            all_labels[n].append(labels)

    results = []
    for n in range(batch):
        if all_boxes[n]:
            boxes = np.concatenate(all_boxes[n])
            scores = np.concatenate(all_scores[n])
            labels = np.concatenate(all_labels[n])
            keep = nms(boxes, scores, labels, nms_iou)[:max_dets]
            results.append({"boxes": boxes[keep], "scores": scores[keep],
                            "labels": labels[keep]})
        else:
            results.append({"boxes": np.zeros((0, 4), np.float32),
                            "scores": np.zeros((0,), np.float32),
                            "labels": np.zeros((0,), np.int64)})
    return results


def nms(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
        iou_threshold: float = 0.5) -> np.ndarray:
    """Class-aware greedy NMS; returns kept indices sorted by score."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        same = (labels == labels[i]) & ~suppressed
        idx = np.nonzero(same)[0]
        ix = np.maximum(0, np.minimum(boxes[idx, 2], boxes[i, 2]) -
                        np.maximum(boxes[idx, 0], boxes[i, 0]))
        iy = np.maximum(0, np.minimum(boxes[idx, 3], boxes[i, 3]) -
                        np.maximum(boxes[idx, 1], boxes[i, 1]))
        inter = ix * iy
        iou = inter / np.maximum(areas[idx] + areas[i] - inter, 1e-12)
        suppressed[idx[iou > iou_threshold]] = True
        suppressed[i] = True
    return np.array(keep, np.int64)


def _device_topk(level_outputs, k: int) -> List[Dict[str, torch.Tensor]]:
    """On-device candidate selection: per level, sigmoid scoring fused with
    a top-k over locations (lower index first among equal scores), so only
    (B, k) candidates cross to the host instead of the dense maps. Per
    level: {scores, labels, boxes xyxy, index (the flat location, y * W +
    x)}."""
    results = []
    for lvl in level_outputs:
        logits, offsets, ctr = lvl["logits"], lvl["offsets"], lvl["centerness"]
        stride = lvl["stride"]
        b, h, w, c = logits.shape
        probs = torch.sigmoid(logits) * torch.sigmoid(ctr)
        probs[..., 0] = 0.0  # background
        flat = probs.reshape(b, h * w, c)
        scores = flat.amax(dim=-1)
        labels = flat.argmax(dim=-1)
        kk = min(k, h * w)
        top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :kk], top_idx[:, :kk]
        cx = ((top_idx % w).float() + 0.5) * stride
        cy = (torch.div(top_idx, w, rounding_mode="floor").float() + 0.5) * stride
        off = torch.gather(offsets.reshape(b, h * w, 4), 1,
                           top_idx[..., None].expand(-1, -1, 4))
        boxes = torch.stack([cx - off[..., 0], cy - off[..., 1],
                             cx + off[..., 2], cy + off[..., 3]], dim=-1)
        results.append({"scores": top_scores, "labels": torch.gather(labels, 1, top_idx),
                        "boxes": boxes, "index": top_idx})
    return results


def candidates_agree(got, want, box_atol, score_atol):
    """Two runs' top-k candidates (`_device_topk` outputs) against each
    other: the sorted scores within score_atol; every location that both
    keep with the same label, its box within box_atol and its score within
    score_atol; a location kept by one run only scored within score_atol of
    the other run's last kept score. So the two may order locations
    differently only where their scores tie within score_atol: fp32 sums in
    another order move a score by ~1e-8, and neighbouring scores of a
    seeded detector lie that close now and then. Returns (agree, the
    number of positions whose location differs)."""
    moved = 0
    for g, w in zip(got, want):
        gi, wi = g["index"].cpu().numpy(), w["index"].cpu().numpy()
        gs, ws = g["scores"].cpu().numpy(), w["scores"].cpu().numpy()
        gl, wl = g["labels"].cpu().numpy(), w["labels"].cpu().numpy()
        gb, wb = g["boxes"].cpu().numpy(), w["boxes"].cpu().numpy()
        if not np.allclose(gs, ws, rtol=0, atol=score_atol):
            return False, moved
        for n in range(len(gi)):
            where = {int(i): q for q, i in enumerate(wi[n])}
            for p, i in enumerate(gi[n]):
                q = where.get(int(i))
                if q is None:
                    if abs(gs[n, p] - ws[n, -1]) > score_atol:
                        return False, moved
                elif (gl[n, p] != wl[n, q] or abs(gs[n, p] - ws[n, q]) > score_atol
                      or np.abs(gb[n, p] - wb[n, q]).max() > box_atol):
                    return False, moved
            moved += int((gi[n] != wi[n]).sum())
    return True, moved


def detections_agree(got, want, box_atol, score_atol):
    """Per image the same number of detections, each paired one to one with
    a detection of the other run of the same label, its box within
    box_atol and its score within score_atol (in any order: NMS sorts by
    score, and near-equal scores may trade places)."""
    for a, b in zip(got, want):
        if len(a["labels"]) != len(b["labels"]):
            return False
        free = list(range(len(b["labels"])))
        for label, box, score in zip(a["labels"], a["boxes"], a["scores"]):
            j = next((j for j in free if b["labels"][j] == label
                      and np.abs(b["boxes"][j] - box).max() <= box_atol
                      and abs(b["scores"][j] - score) <= score_atol), None)
            if j is None:
                return False
            free.remove(j)
    return True


class DetectionModel:
    """Inference wrapper: the dense forward and the on-device top-k, one
    host read of every level's candidates per call, then host NMS over
    that small set (the JAX package's DetectionModel).

    `pretrained`: the path of a port `.pth` holding the detector (a
    `train_detection` checkpoint, or a plain state_dict)."""

    def __init__(self, num_classes: int = 91, model_name: str = "fcos_resnet18_fpn",
                 score_threshold: float = 0.05, topk: int = 300,
                 dtype: torch.dtype = torch.float32, pretrained: Optional[str] = None,
                 p2: bool = False, device="cuda"):
        if model_name not in _BACKBONES:
            raise ValueError(f"Unsupported detection model: {model_name}")
        tv = model_name.startswith("tv_")
        self.module = FCOSDetector(num_classes=num_classes, backbone_name=model_name,
                                   channels=256 if tv else 128, torchvision_compat=tv,
                                   p2=p2 and not tv)
        self.model_name = model_name
        self.num_classes = num_classes
        self.score_threshold = score_threshold
        self.topk = topk
        self.dtype = dtype
        self.pretrained = pretrained
        self.device = torch.device(device)

    def init(self, seed: Union[int, torch.Generator] = 0, image_size: int = 512) -> FCOSDetector:
        """Seeded weights (or `pretrained`), on the model's device, in eval
        mode. `image_size` is the JAX signature's: torch needs no example
        input to build the weights."""
        gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        init_detector_(self.module, gen)
        if self.pretrained:
            from adam_dehaze_tpu_torch.training.checkpoint import load_checkpoint
            state, _ = load_checkpoint(self.pretrained)
            self.module.load_state_dict(state.get("model", state))
            print(f"Loaded pretrained detector from {self.pretrained}")
        self.module.to(self.device).eval()
        return self.module

    @torch.no_grad()
    def candidates(self, images: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """The per-level top-k candidates of ImageNet-normalised NHWC
        images, on the device (eval mode, autocast in the model's dtype)."""
        self.module.eval()
        with autocast(images.device, self.dtype):
            levels = self.module(images)
        return _device_topk(levels, self.topk)

    def host_candidates(self, images) -> np.ndarray:
        """Every level's candidates as one (N, K, 6) float32 array
        [x1, y1, x2, y2, score, label], levels in order: one host read."""
        x = torch.as_tensor(images, device=self.device)
        levels = self.candidates(x)
        packed = torch.cat([torch.cat([lv["boxes"], lv["scores"][..., None],
                                       lv["labels"][..., None].float()], dim=-1)
                            for lv in levels], dim=1)
        return packed.cpu().numpy()

    def __call__(self, images) -> List[Dict[str, np.ndarray]]:
        """images: (N, H, W, 3), ImageNet-normalised (a tensor, or numpy).
        Returns torchvision-style per-image dicts."""
        packed = self.host_candidates(images)
        h, w = images.shape[1:3]
        return [postprocess(packed[n], self.score_threshold, (h, w))
                for n in range(packed.shape[0])]


def postprocess(candidates: np.ndarray, score_threshold: float,
                image_size: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """One image's (K, 6) candidates -> {boxes, scores, labels}: scores above
    the threshold, boxes clipped to the image, class-aware NMS, at most
    100."""
    h, w = image_size
    boxes = candidates[:, :4]
    scores = candidates[:, 4]
    labels = candidates[:, 5].astype(np.int64)
    keep = scores > score_threshold
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    kept = nms(boxes, scores, labels)[:100]
    return {"boxes": boxes[kept].astype(np.float32),
            "scores": scores[kept].astype(np.float32),
            "labels": labels[kept].astype(np.int64)}


class IntegratedDetectionSystem:
    """Dehazing router ∘ frozen detector with ImageNet renormalisation
    between the stages."""

    def __init__(self, dehaze_fn: Callable, detection_model: DetectionModel):
        """dehaze_fn: hazy (N, H, W, 3) in [0, 1] -> (dehazed, info)."""
        self.dehaze_fn = dehaze_fn
        self.detection_model = detection_model

    def __call__(self, images: torch.Tensor):
        dehazed, _info = self.dehaze_fn(images)
        detections = self.detection_model(imagenet_normalize(dehazed))
        return detections, dehazed


def create_detection_model(config, device="cuda") -> DetectionModel:
    """The detector of the config's `detection` section, computing in
    `cuda.compute_dtype`. `detection.pretrained` must be the path of a port
    `.pth`: `true` (torchvision's COCO weights) has nothing to load here."""
    det = config["detection"]
    pretrained = det.get("pretrained")
    return DetectionModel(
        num_classes=det.get("num_classes", 91),
        model_name=det["model"],
        score_threshold=det.get("score_threshold", 0.05),
        dtype=compute_dtype(config),
        pretrained=pretrained if isinstance(pretrained, str) else None,
        p2=bool(det.get("p2", False)),
        device=device,
    )


def create_integrated_system(dehaze_fn, detection_model) -> IntegratedDetectionSystem:
    return IntegratedDetectionSystem(dehaze_fn, detection_model)
